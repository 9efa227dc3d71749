"""Batch image generation: one prompt, many seeds.

Counterpart of ``stable_diffusion_videos_tpu/pipeline/image_generation.py``
(``generate_images``, ``generate_input_batches``) on the port's pipeline:
``batch_size · num_batches`` images, one seed each, written as
``{seed}{ext}`` beside ``prompt_config.json``, each batch one dispatch,
post-processed (safety, and Real-ESRGAN with ``upsample``) on the device.
ControlNet maps and prompt weighting are taken as the walk takes them.
Uploading to the hub (``push_to_hub``) waits for the port's hub module.
"""

from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import Optional

import torch

from .walk import load_control_image


def generate_images(pipeline, prompt: str, batch_size: Optional[int] = 1,
                    num_batches: int = 1, seeds=None,
                    num_inference_steps: int = 50,
                    guidance_scale: float = 7.5, eta: float = 0.0,
                    output_dir: str = "./images", name: Optional[str] = None,
                    image_file_ext: str = ".jpg", upsample: bool = False,
                    height: Optional[int] = None, width: Optional[int] = None,
                    negative_prompt: Optional[str] = None,
                    push_to_hub: bool = False, repo_id: Optional[str] = None,
                    private: bool = False, create_pr: bool = False,
                    upsample_weights: Optional[str] = None,
                    control_image=None, controlnet_scale: float = 1.0):
    """Generate ``batch_size · num_batches`` images of ``prompt``, one seed
    each (random seeds when ``seeds`` is None), into ``output_dir/name``;
    -> the image paths.  The upsampler's weights are provisioned, and
    ``push_to_hub`` refused, before the directory is made."""
    if push_to_hub:
        raise NotImplementedError(
            "generate_images(push_to_hub=True) waits for the hub module, "
            "which the PyTorch package does not have yet")
    height = height or pipeline.models.default_size
    width = width or pipeline.models.default_size
    batch_size = batch_size or pipeline.models.default_batch_size
    n_total = batch_size * num_batches
    if seeds is None:
        seeds = random.sample(range(2 ** 32 - 1), n_total)
    if len(seeds) != n_total:
        raise ValueError("len(seeds) must equal batch_size * num_batches")
    if upsample:
        pipeline._ensure_upsampler(upsample_weights)
    ctrl_kw = {}
    if control_image is not None:
        if pipeline.engine.controlnet is None:
            raise ValueError("control_image= requires a pipeline built with "
                             "controlnet=")
        ctrl_kw = dict(control=load_control_image(control_image, height,
                                                  width),
                       control_scale=controlnet_scale)
    name = name or time.strftime("%Y%m%d-%H%M%S")
    save_path = Path(output_dir) / name
    save_path.mkdir(exist_ok=False, parents=True)
    (save_path / "prompt_config.json").write_text(json.dumps(dict(
        prompt=prompt, batch_size=batch_size, num_batches=num_batches,
        seeds=seeds, num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, eta=eta, upsample=upsample,
        height=height, width=width, negative_prompt=negative_prompt,
        scheduler=pipeline.engine.scheduler_name, tiled=False,
        device=str(pipeline.device),
        framework="stable_diffusion_videos_tpu_torch",
    ), indent=2, sort_keys=True))

    neg = negative_prompt or ""
    n = pipeline._num_chunks(prompt, neg)
    embed, uncond = pipeline._embed(prompt, n), pipeline._embed(neg, n)
    latent_shape = pipeline._latent_shape(height, width)
    paths = []
    for b in range(num_batches):
        batch_seeds = seeds[b * batch_size:(b + 1) * batch_size]
        noise = torch.cat([pipeline.init_noise(s, latent_shape)
                           for s in batch_seeds])
        xl_kw = {}
        if pipeline.models.is_xl:
            pooled = pipeline._pooled(prompt)
            xl_kw = dict(pooled=pooled.expand(
                (len(batch_seeds),) + tuple(pooled.shape[1:])),
                uncond_pooled=pipeline._pooled(neg))
        imgs, valid = pipeline.engine.denoise_frames_async(
            embed.expand((len(batch_seeds),) + tuple(embed.shape[1:])),
            uncond, noise, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, eta=eta, output_dtype="uint8",
            **xl_kw, **ctrl_kw)
        for seed, pil in zip(batch_seeds, pipeline._postprocess(
                imgs[:valid], upsample)):
            path = save_path / f"{seed}{image_file_ext}"
            pil.save(path)
            paths.append(str(path))
    return paths


def generate_input_batches(pipeline, prompts, seeds, batch_size: int,
                           height: int, width: int):
    """Yield (batch index, embeddings (b, 77, D), noise (b, h, w, 4)) on
    the device, ``batch_size`` prompt/seed pairs a batch."""
    if len(prompts) != len(seeds):
        raise ValueError("Number of prompts and seeds must be equal.")
    latent_shape = pipeline._latent_shape(height, width)
    embeds, noises, batch_idx = [], [], 0
    for i, (prompt, seed) in enumerate(zip(prompts, seeds)):
        embeds.append(pipeline.engine.embed_text(prompt)[0])
        noises.append(pipeline.init_noise(seed, latent_shape)[0])
        if len(embeds) == batch_size or i + 1 == len(prompts):
            yield batch_idx, torch.stack(embeds), torch.stack(noises)
            batch_idx += 1
            embeds, noises = [], []
