"""The gradio UI: two tabs (Images, Videos) over one pipeline.

Counterpart of ``stable_diffusion_videos_tpu/app.py``.  gradio is optional
and imported when the interface is built, with an error that says so when
it is missing; the callbacks ``fn_images`` and ``fn_videos`` run the
port's pipeline.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

from .core.schedulers import SCHEDULER_NAMES

logger = logging.getLogger("sdv_torch")


def _require_gradio():
    try:
        import gradio as gr
        return gr
    except ImportError as e:
        raise ImportError(
            "gradio is required for the UI: pip install gradio (the "
            "pipeline works without it)") from e


class Interface:
    """Batch images and walk videos, one tab each, over one pipeline."""

    def __init__(self, pipeline):
        gr = _require_gradio()
        self.pipeline = pipeline
        default_sched = pipeline.engine.scheduler_name
        self.interface_images = gr.Interface(
            self.fn_images,
            inputs=[
                gr.Textbox("blueberry spaghetti", label="Prompt"),
                gr.Textbox("", label="Negative prompt"),
                gr.Textbox("", label="Seed (blank = random)"),
                gr.Dropdown(list(SCHEDULER_NAMES), value=default_sched,
                            label="Scheduler"),
                gr.Slider(1, 24, 1, step=1, label="Batch size"),
                gr.Slider(1, 16, 1, step=1, label="# Batches"),
                gr.Slider(10, 100, 50, step=10, label="# Inference Steps"),
                gr.Slider(5.0, 15.0, 7.5, step=0.5, label="Guidance Scale"),
                gr.Checkbox(False, label="Upsample"),
                gr.Textbox("./images", label="Output directory"),
            ],
            outputs=gr.Gallery(),
        )
        self.interface_videos = gr.Interface(
            self.fn_videos,
            inputs=[
                gr.Textbox("blueberry spaghetti\nstrawberry spaghetti",
                           lines=2, label="Prompts (one per line)"),
                gr.Textbox("42\n1337", lines=2, label="Seeds (one per line)"),
                gr.Textbox("", label="Negative prompt"),
                gr.Dropdown(list(SCHEDULER_NAMES), value=default_sched,
                            label="Scheduler"),
                gr.Slider(3, 1000, 5, step=1, label="# Interpolation Steps"),
                gr.Slider(3, 60, 5, step=1, label="Output Video FPS"),
                gr.Slider(1, 24, 1, step=1, label="Batch size"),
                gr.Slider(10, 100, 50, step=10, label="# Inference Steps"),
                gr.Slider(5.0, 15.0, 7.5, step=0.5, label="Guidance Scale"),
                gr.Checkbox(False, label="Upsample"),
                gr.Textbox("./dreams", label="Output directory"),
            ],
            outputs=gr.Video(),
        )
        self.interface = gr.TabbedInterface(
            [self.interface_images, self.interface_videos],
            ["Images!", "Videos!"])

    def fn_images(self, prompt, negative_prompt, seed, scheduler,
                  batch_size, num_batches, num_inference_steps,
                  guidance_scale, upsample, output_dir):
        from .pipeline.image_generation import generate_images
        self.pipeline.set_scheduler(scheduler)
        seeds = None
        if str(seed).strip():
            # one base seed from the box: consecutive seeds an image; the
            # box is free text, so a non-integer is a gr.Error
            try:
                base = int(str(seed).strip())
            except ValueError:
                import gradio as gr
                raise gr.Error(
                    f"Seed must be a whole number (got {str(seed).strip()!r});"
                    " leave the box empty for random seeds.")
            seeds = list(range(base, base + int(batch_size) * int(num_batches)))
        paths = generate_images(
            self.pipeline, prompt, batch_size=int(batch_size),
            num_batches=int(num_batches), seeds=seeds,
            negative_prompt=negative_prompt.strip() or None,
            num_inference_steps=int(num_inference_steps),
            guidance_scale=guidance_scale, upsample=upsample,
            output_dir=output_dir, name=time.strftime("%Y%m%d-%H%M%S"))
        return [(p, Path(p).stem) for p in paths]

    def fn_videos(self, prompts, seeds, negative_prompt, scheduler,
                  num_interpolation_steps, fps, batch_size,
                  num_inference_steps, guidance_scale, upsample, output_dir):
        prompts = [p.strip() for p in prompts.split("\n") if p.strip()]
        try:
            seeds = [int(s.strip()) for s in seeds.split("\n") if s.strip()]
        except ValueError as e:
            import gradio as gr
            raise gr.Error(f"Seeds must be whole numbers, one per line: {e}")
        self.pipeline.set_scheduler(scheduler)
        return self.pipeline.walk(
            prompts=prompts, seeds=seeds,
            negative_prompt=negative_prompt.strip() or None,
            num_interpolation_steps=int(num_interpolation_steps),
            fps=int(fps), batch_size=int(batch_size),
            num_inference_steps=int(num_inference_steps),
            guidance_scale=guidance_scale, upsample=upsample,
            output_dir=output_dir)

    def launch(self, *args, **kwargs):
        self.interface.launch(*args, **kwargs)
