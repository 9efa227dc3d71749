"""Scheduler core — host-precomputed tables, steps as pure functions of the
loop index.

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/base.py``.
``make_tables(config, num_inference_steps)`` runs once on the host in
float64 numpy (the warm-up samplers pndm, lms and unipc also take
``start_index``: the tables of a schedule entered mid-way, for img2img); ``step(tables, state, i, model_output, sample, noise)`` is a
pure function of the loop index ``i``, called from a Python loop (the JAX
package's ``lax.scan``).  Per-step coefficients are read on the host as
Python floats, so a step launches no device-to-host copy.

The stochastic samplers take their transition-noise field as the step's
``noise`` argument (the JAX package splits a PRNG key in the state): the
engine draws it on the device from a ``torch.Generator``
(``transition_noise``), and a test can pass the JAX package's own fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

ONE_F32 = np.float32(1.0)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static sampler configuration (mirrors the SD v1.x scheduler config)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    #: "leading" (the SD checkpoints), "linspace" or "trailing"
    timestep_spacing: str = "leading"
    #: ddim and lcm clip the x0 prediction to [-1, 1]
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    # PNDM
    skip_prk_steps: bool = True
    # DPM-Solver++ 2M (data prediction, second order: the only variant the
    # port has, so it takes no order or algorithm setting); UniPC
    lower_order_final: bool = True
    # LMS
    lms_order: int = 4
    #: resample the sigma-space samplers' sigmas onto the Karras et al.
    #: 2022 rho-7 schedule (fractional timesteps follow them)
    use_karras_sigmas: bool = False
    #: rescale the betas so the terminal SNR is zero (Lin et al. 2024);
    #: pairs with ``timestep_spacing="trailing"``
    rescale_betas_zero_snr: bool = False


def betas_for_schedule(cfg: SchedulerConfig) -> np.ndarray:
    """Training beta schedule -> float64 numpy."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                           dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(n, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / n) / alpha_bar(ts / n),
                          0.999)
    raise ValueError(f"unknown beta_schedule {cfg.beta_schedule!r}")


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and scale sqrt(alpha_bar) so the last training step has SNR
    0 and the first keeps its own; the terminal value is clamped to 2**-24
    so that sigma = sqrt((1 - a) / a) stays finite."""
    sqrt_acp = np.sqrt(alphas_cumprod)
    a0, a_t = sqrt_acp[0], sqrt_acp[-1]
    acp = ((sqrt_acp - a_t) * (a0 / (a0 - a_t))) ** 2
    acp[-1] = max(acp[-1], 2.0 ** -24)
    return acp


def alphas_cumprod_for(cfg: SchedulerConfig) -> np.ndarray:
    acp = np.cumprod(1.0 - betas_for_schedule(cfg))
    if cfg.rescale_betas_zero_snr:
        acp = rescale_zero_terminal_snr(acp)
    return acp


def check_num_steps(cfg: SchedulerConfig, num_inference_steps: int):
    if not 1 <= num_inference_steps <= cfg.num_train_timesteps:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} must be in "
            f"[1, num_train_timesteps={cfg.num_train_timesteps}]")


def spaced_timesteps(cfg: SchedulerConfig,
                     num_inference_steps: int) -> np.ndarray:
    """Descending int64 training timesteps under ``timestep_spacing``."""
    check_num_steps(cfg, num_inference_steps)
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round() \
            .astype(np.int64)
        return ts[::-1].copy() + cfg.steps_offset
    if cfg.timestep_spacing == "linspace":
        return np.linspace(0, n - 1, num_inference_steps)[::-1].round() \
            .astype(np.int64).copy()
    if cfg.timestep_spacing == "trailing":
        ratio = n / num_inference_steps
        return np.round(np.arange(n, 0, -ratio)).astype(np.int64) - 1
    raise ValueError(f"unknown timestep_spacing {cfg.timestep_spacing!r}")


def pred_original_sample(eps: torch.Tensor, sample: torch.Tensor,
                         alpha_prod_t: np.float32,
                         prediction_type: str) -> torch.Tensor:
    """x0 prediction from the model output under its parameterisation;
    the scalar terms in float32 on the host, as the JAX package's device
    computes them."""
    if prediction_type == "epsilon":
        return ((sample - float(np.sqrt(ONE_F32 - alpha_prod_t)) * eps)
                / float(np.sqrt(alpha_prod_t)))
    if prediction_type == "v_prediction":
        return (float(np.sqrt(alpha_prod_t)) * sample
                - float(np.sqrt(ONE_F32 - alpha_prod_t)) * eps)
    if prediction_type == "sample":
        return eps
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def transition_noise(generator: torch.Generator, sample: torch.Tensor,
                     frozen: bool = False) -> torch.Tensor:
    """One step's transition-noise field, drawn on ``sample``'s device
    from ``generator``: independent per batch row, or with ``frozen`` one
    ``(1, C, h, w)`` field that broadcasts over the batch (pad rows
    included), so a row's frames do not depend on how the walk groups
    frames into dispatches."""
    shape = (1,) + tuple(sample.shape[1:]) if frozen else sample.shape
    return torch.randn(shape, generator=generator, device=sample.device,
                       dtype=torch.float32)


class Scheduler:
    """Interface shared by the samplers.  Subclasses are stateless
    namespaces; all data lives in (tables, state)."""

    name: str = "base"
    #: whether the step adds transition noise (ddim: only with eta > 0,
    #: see ``draws_noise``)
    stochastic: bool = False

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int):
        raise NotImplementedError

    def draws_noise(self, tables) -> bool:
        """Whether a run on these tables needs transition-noise fields."""
        return self.stochastic

    def init_state(self, tables, latents):
        return {}

    def init_noise_sigma(self, tables) -> float:
        return float(tables["init_noise_sigma"])

    def scale_model_input(self, tables, state, i, sample):
        return sample

    def timestep(self, tables, i) -> float | int:
        """The training timestep fed to the UNet at loop index ``i``: an
        int, or a float where the table holds fractional ones (the sigma
        samplers under Karras sigmas)."""
        return tables["timesteps"][i].item()

    def num_loop_steps(self, tables) -> int:
        return len(tables["timesteps"])

    def step(self, tables, state, i, model_output, sample,
             noise: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def add_noise(self, tables, original: torch.Tensor, noise: torch.Tensor,
                  timestep: int) -> torch.Tensor:
        """``original`` noised to training timestep ``timestep``:
        sqrt(ᾱ)·x + sqrt(1 - ᾱ)·noise, the scalars in float32."""
        acp = tables["alphas_cumprod"][int(timestep)]
        return (float(np.sqrt(acp)) * original
                + float(np.sqrt(ONE_F32 - acp)) * noise)


_REGISTRY: dict[str, Any] = {}


def register(cls):
    _REGISTRY[cls.name] = cls()
    return cls


def get_scheduler(name: str) -> Scheduler:
    """Look up a sampler by name ('ddim', 'pndm', 'lms', 'euler',
    'euler_ancestral', 'dpm', 'unipc', 'lcm')."""
    from . import ddim, dpm, euler, lcm, lms, pndm, unipc  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
