"""Fine-tuning: the full UNet (denoising objective), the VAE
(reconstruction + KL), LoRA adapters and LCM consistency distillation.

Counterpart of ``stable_diffusion_videos_tpu/training/``, exporting the same
names."""

from .lcm_distill import LCMDistillConfig, LCMDistiller
from .lora import LoRATrainer, init_lora_params, merge_lora
from .structured_data import identify_patterns, make_structured_dataset
from .trainer import TrainConfig, UNetTrainer
from .vae_trainer import VAETrainer

__all__ = ["TrainConfig", "UNetTrainer", "VAETrainer", "LoRATrainer",
           "LCMDistillConfig", "LCMDistiller",
           "init_lora_params", "merge_lora", "make_structured_dataset",
           "identify_patterns"]
