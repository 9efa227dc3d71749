"""StableDiffusionWalkPipeline — latent-space-walk videos, PyTorch.

Counterpart of ``stable_diffusion_videos_tpu/pipeline/walk.py`` on its
default path: ``walk()`` with the same arguments and output layout (clip
subdirectories, ``frameNNNNNN.png``, ``prompt_config.json``, per-clip and
final videos), frame-granular ``resume``, lerp for embeddings and slerp for
noise, ``negative_prompt``, audio-timed frames (``audio/analysis.py``),
streamed video assembly (``media/video.py``), and a drain that saves batch N after batch
N+1 has been enqueued on the device.

The walk serves SD 1.x, SD 2.x and SDXL-base bundles: for SDXL the pooled
text embedding walks the same lerp trajectory as the sequence embedding,
and the negative prompt's pooled embedding is the uncond one.

The few-step levers are ported: DeepCache step caching, limited-interval
CFG and the ``fast`` preset that combines them, every sampler of the JAX
package, and frozen transition noise.  Each dispatch of a stochastic
sampler draws its noise from a ``torch.Generator`` seeded from both clip
seeds and the batch index, or under ``frozen_noise`` from one video-level
seed.

The edit paths: ``img2img``, ``inpaint`` (the mask taken to latent size by
nearest-exact sampling, pixel ``f·i + f/2``, as the JAX package's
``jax.image.resize(..., "nearest")``) and ``vid2vid`` (batched img2img
over a video's frames with one shared re-noising field, or per-frame fields
keyed by the absolute frame index under ``frozen_noise``, and an optional
causal EMA of the source latents).  Options of the JAX pipeline this port
does not have yet (upsampling, the safety checker, FreeU, ToMe, prompt
weighting, ControlNet, IP-Adapter) raise when they are asked for.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from ..audio.analysis import get_timesteps_arr, load_audio
from ..core.interp import lerp, slerp
from ..core.rng import noise_for_seed
from ..media.png import write_png
from ..media.video import (FrameWriter, iter_frames, probe_video,
                           read_video_frames)
from ..media.video import make_video as assemble
from ..models.bundle import SDModels
from ..runtime.engine import Engine, refuse_unported

logger = logging.getLogger("sdv_torch")

_PIPELINE_UNPORTED = ("embed_interp", "noise_interp", "safety",
                      "prompt_weighting", "controlnet", "freeu",
                      "ip_adapter", "tome", "mesh")
_FRAMES_UNPORTED = ("upsample", "upsample_weights", "control_image",
                    "ip_image")
_WALK_UNPORTED = ("upsample", "upsample_weights", "control_image",
                  "ip_image", "params", "jit")
_IMG2IMG_UNPORTED = ("control_image", "controlnet_scale", "ip_image",
                     "ip_scale")
_VID2VID_UNPORTED = ("control_video", "controlnet_scale",
                     "control_from_source", "canny_thresholds", "ip_image",
                     "ip_scale")


def dispatch_seed(seed_a: int, seed_b: int, batch_idx: int) -> int:
    """A 64-bit generator seed mixed from both clip seeds and the batch
    index."""
    mask = 2 ** 64 - 1
    return int(np.random.SeedSequence(
        [int(seed_a) & mask, int(seed_b) & mask, int(batch_idx)])
        .generate_state(1, np.uint64)[0])


def frame_noise_seed(seed: int, frame_index: int) -> int:
    """vid2vid's per-frame re-noising seed under ``frozen_noise``: a
    function of the video's seed and the frame's absolute index only, so
    a frame's noise does not depend on how frames split into batches."""
    return dispatch_seed(int(seed) * 9973 + 1, frame_index, 0)


def image_array(image) -> np.ndarray:
    """PIL image or (H, W, 3) / (B, H, W, 3) array (uint8, or floats in
    [0, 1]) -> float32 (B, H, W, 3) in [0, 1]."""
    from PIL import Image
    if isinstance(image, Image.Image):
        arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
    else:
        raw = np.asarray(image)
        arr = raw.astype(np.float32)
        if raw.dtype == np.uint8 or arr.max() > 1.5:
            arr = arr / 255.0
    return arr[None] if arr.ndim == 3 else arr


def latent_mask(mask, lh: int, lw: int) -> torch.Tensor:
    """A pixel mask (PIL L/RGB, or (H, W) uint8 or [0, 1]) -> (lh, lw)
    float32 at latent size, by nearest-exact sampling (pixel
    floor((i + 0.5)·H/lh), as ``jax.image.resize(..., "nearest")``)."""
    from PIL import Image
    if isinstance(mask, Image.Image):
        m = np.asarray(mask.convert("L"), np.float32) / 255.0
    else:
        m = np.asarray(mask, np.float32)
        if m.max() > 1.5:
            m = m / 255.0
    return torch.nn.functional.interpolate(
        torch.from_numpy(np.ascontiguousarray(m))[None, None],
        size=(lh, lw), mode="nearest-exact")[0, 0]


def to_pil(frames: np.ndarray) -> list:
    """uint8 (B, H, W, 3) -> PIL images."""
    from PIL import Image
    return [Image.fromarray(f) for f in frames]


class StableDiffusionWalkPipeline:
    def __init__(self, models: SDModels, device: torch.device,
                 scheduler: str = "pndm", batch_bucket: Optional[int] = None,
                 fast: bool = False, step_cache: Optional[int] = None,
                 step_cache_split: int = 1,
                 step_cache_policy: str = "uniform",
                 guidance_rescale: float = 0.0, guidance_interval=None,
                 frozen_noise: bool = False, **unported):
        refuse_unported("StableDiffusionWalkPipeline", _PIPELINE_UNPORTED,
                        unported)
        if fast:
            # the JAX package's presets, explicit kwargs win: SD 1.x/2.x
            # step_cache=3 x guidance_interval (0.1, 0.85); SDXL
            # step_cache=2 alone
            if step_cache is None:
                step_cache = 2 if models.is_xl else 3
            if guidance_interval is None and not models.is_xl:
                guidance_interval = (0.1, 0.85)
        self.fast = bool(fast)
        self.models = models
        self.device = torch.device(device)
        self.engine = Engine(models, self.device, scheduler=scheduler,
                             batch_bucket=batch_bucket,
                             step_cache=step_cache,
                             step_cache_split=step_cache_split,
                             step_cache_policy=step_cache_policy,
                             guidance_rescale=guidance_rescale,
                             guidance_interval=guidance_interval,
                             frozen_noise=frozen_noise)

    @classmethod
    def tiny(cls, device: torch.device, seed: int = 0,
             **kw) -> "StableDiffusionWalkPipeline":
        """Random tiny-model pipeline: every code path, no weights."""
        return cls(SDModels.tiny(seed), device, **kw)

    @classmethod
    def tiny_xl(cls, device: torch.device, seed: int = 0,
                **kw) -> "StableDiffusionWalkPipeline":
        """Random tiny SDXL-shaped pipeline: two text towers and text_time
        conditioning, no weights."""
        return cls(SDModels.tiny_xl(seed), device, **kw)

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def embed_text(self, text) -> torch.Tensor:
        """Prompt -> (1, 77, D) embedding on the device."""
        return self.engine.embed_text(text)

    def init_noise(self, seed: int, noise_shape) -> torch.Tensor:
        """Seeded latent noise of the NHWC ``noise_shape``, on the device
        (the torch-CPU stream of the JAX package's default)."""
        b, h, w, c = noise_shape
        return noise_for_seed(seed, (b, c, h, w),
                              self.device).permute(0, 2, 3, 1)

    def _latent_shape(self, height: int, width: int):
        f = self.models.vae_scale_factor
        c = self.models.unet_config.in_channels
        return (1, height // f, width // f, c)

    def generate_inputs(self, prompt_a: str, prompt_b: str, seed_a, seed_b,
                        noise_shape, T, batch_size: int):
        """Interpolated (embeds, noise, pooled) batches for one clip: the
        whole trajectory is built at once, then cut into dispatch batches.
        ``pooled`` is None but for SDXL, whose pooled embedding walks the
        same lerp trajectory."""
        embeds_a = self.engine.embed_text(prompt_a)
        embeds_b = self.engine.embed_text(prompt_b)
        noise_a = self.init_noise(seed_a, noise_shape)
        noise_b = self.init_noise(seed_b, noise_shape)
        T = np.asarray(T, np.float32)
        embeds = lerp(T, embeds_a[0], embeds_b[0])
        noise = slerp(T, noise_a[0], noise_b[0])
        pooled = None
        if self.models.is_xl:
            pooled = lerp(T, self.engine.embed_text_pooled(prompt_a)[0],
                          self.engine.embed_text_pooled(prompt_b)[0])
        for i in range(0, len(T), batch_size):
            yield (embeds[i:i + batch_size], noise[i:i + batch_size],
                   None if pooled is None else pooled[i:i + batch_size])

    # ------------------------------------------------------------------
    # frame generation
    # ------------------------------------------------------------------
    def make_clip_frames(self, prompt_a: str, prompt_b: str, seed_a: int,
                         seed_b: int, num_interpolation_steps: int = 5,
                         save_path: Union[str, Path] = "outputs/images",
                         num_inference_steps: int = 50,
                         guidance_scale: float = 7.5, eta: float = 0.0,
                         height: Optional[int] = None,
                         width: Optional[int] = None, batch_size: int = 1,
                         image_file_ext: str = ".png", T=None, skip: int = 0,
                         negative_prompt: Optional[str] = None,
                         step: Optional[tuple] = None, frame_sink=None,
                         noise_key: Optional[int] = None, **unported):
        """Generate and save the frames of one prompt-pair clip.

        ``noise_key``: the seed of every dispatch's transition-noise
        generator (``walk()`` passes one video-level seed under
        ``frozen_noise``, so the frozen field is constant across batch and
        clip boundaries).  Without it each dispatch's seed mixes both clip
        seeds and the batch index (the batch index is 0 under
        ``frozen_noise``), so clips that share ``seed_a`` draw decoupled
        noise."""
        refuse_unported("make_clip_frames", _FRAMES_UNPORTED, unported)
        if image_file_ext != ".png":
            raise ValueError("the PyTorch package writes .png frames only")
        height = height or self.models.default_size
        width = width or self.models.default_size
        save_path = Path(save_path)
        save_path.mkdir(parents=True, exist_ok=True)
        T = np.asarray(T if T is not None
                       else np.linspace(0.0, 1.0, num_interpolation_steps))
        if T.shape[0] != num_interpolation_steps:
            raise ValueError(
                f"len(T) ({T.shape[0]}) != num_interpolation_steps "
                f"({num_interpolation_steps})")
        T = T[skip:]
        uncond = self.engine.embed_text(negative_prompt or "")
        uncond_pooled = (self.engine.embed_text_pooled(negative_prompt or "")
                         if self.models.is_xl else None)
        batches = self.generate_inputs(prompt_a, prompt_b, seed_a, seed_b,
                                       self._latent_shape(height, width), T,
                                       batch_size)
        save_futures = []

        def drain(pool, pending):
            imgs_dev, valid, start = pending
            frames = imgs_dev[:valid].cpu().numpy()
            for j, frame in enumerate(frames):
                # PNG encoding on worker threads; the sink is fed in order
                save_futures.append(pool.submit(
                    write_png, save_path / f"frame{start + j:06d}.png", frame))
                if frame_sink is not None:
                    frame_sink.add_frame(frame)

        frame_index = skip
        pending = None  # (frames on the device, valid, first frame index)
        with ThreadPoolExecutor(max_workers=4,
                                thread_name_prefix="frame-save") as pool:
            for batch_idx, (embeds, noise, pooled) in enumerate(batches):
                logger.info("%s[%d] generating frames %d-%d / %d",
                            f"[{step[0]}/{step[1]}]" if step else "",
                            batch_idx, frame_index,
                            frame_index + len(noise) - 1, skip + len(T))
                noise_seed = (noise_key if noise_key is not None
                              else dispatch_seed(seed_a, seed_b, 0
                                                 if self.engine.frozen_noise
                                                 else batch_idx))
                imgs, valid = self.engine.denoise_frames_async(
                    embeds, uncond, noise,
                    num_inference_steps=num_inference_steps,
                    guidance_scale=guidance_scale, eta=eta,
                    generator=torch.Generator(self.device).manual_seed(
                        noise_seed),
                    output_dtype="uint8", pooled=pooled,
                    uncond_pooled=uncond_pooled)
                # overlap: save the previous batch while this one computes
                if pending is not None:
                    drain(pool, pending)
                pending = (imgs, valid, frame_index)
                frame_index += valid
            if pending is not None:
                drain(pool, pending)
            for f in save_futures:
                f.result()  # surface any save error

    # ------------------------------------------------------------------
    # the edit paths
    # ------------------------------------------------------------------
    def _cond_uncond(self, prompt: str, negative_prompt, batch: int) -> dict:
        """The engine's text arguments for ``batch`` rows of one prompt:
        cond, uncond and, for SDXL, the pooled pair."""
        neg = negative_prompt or ""
        cond = self.engine.embed_text(prompt)
        out = dict(cond=cond.expand((batch,) + tuple(cond.shape[1:])),
                   uncond=self.engine.embed_text(neg))
        if self.models.is_xl:
            pooled = self.engine.embed_text_pooled(prompt)
            out.update(pooled=pooled.expand(
                (batch,) + tuple(pooled.shape[1:])),
                uncond_pooled=self.engine.embed_text_pooled(neg))
        return out

    def img2img(self, image, prompt: str, strength: float = 0.75,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                eta: float = 0.0, negative_prompt: Optional[str] = None,
                seed: int = 0, output_type: str = "pil", **unported):
        """Image-to-image: encode ``image`` (PIL, or (H, W, 3) / (B, H, W,
        3) uint8 or [0, 1]), re-noise it to ``strength`` of the schedule
        and denoise toward ``prompt``.  -> PIL images, or with another
        ``output_type`` float32 (B, H, W, 3) frames in [0, 1]."""
        refuse_unported("img2img", _IMG2IMG_UNPORTED, unported)
        arr = image_array(image)
        latents = self.engine.encode_image(arr * 2.0 - 1.0)
        images = self.engine.img2img(
            init_latents=latents, strength=strength,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, eta=eta,
            generator=torch.Generator(self.device).manual_seed(int(seed)),
            output_dtype="uint8" if output_type == "pil" else "float32",
            **self._cond_uncond(prompt, negative_prompt, len(arr)))
        return to_pil(images) if output_type == "pil" else images

    def inpaint(self, image, mask, prompt: str,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                negative_prompt: Optional[str] = None, seed: int = 0,
                output_type: str = "pil"):
        """Masked regeneration: ``mask`` 1 (white) is regenerated from
        ``prompt``, 0 (black) keeps ``image``; any sampler (see
        ``Engine.inpaint``).  -> PIL images, or float32 frames."""
        arr = image_array(image)
        latents = self.engine.encode_image(arr * 2.0 - 1.0)
        B, lh, lw, _ = latents.shape
        m = latent_mask(mask, lh, lw)[None, :, :, None].expand(B, lh, lw, 1)
        images = self.engine.inpaint(
            init_latents=latents, mask=m,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale,
            generator=torch.Generator(self.device).manual_seed(int(seed)),
            output_dtype="uint8" if output_type == "pil" else "float32",
            **self._cond_uncond(prompt, negative_prompt, B))
        return to_pil(images) if output_type == "pil" else images

    def vid2vid(self, video, prompt: str, *, strength: float = 0.5,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                negative_prompt: Optional[str] = None, seed: int = 0,
                height: Optional[int] = None, width: Optional[int] = None,
                fps: Optional[float] = None,
                batch_size: Optional[int] = None, frame_skip: int = 1,
                max_frames: Optional[int] = None,
                output_filepath: str = "vid2vid.mp4",
                audio_filepath: Optional[str] = None,
                shared_noise: bool = True, latent_ema: float = 0.0,
                output_type: str = "video", **unported):
        """Video-to-video restyling: batched img2img over the frames of
        ``video`` (a video file, read by ``read_video_frames``; a directory
        of PNG frames; a (T, H, W, 3) array; or any iterable of frames),
        each frame re-noised to ``strength`` and denoised toward
        ``prompt``.

        Frames are resized to ``height`` x ``width``, by default the
        source's sides snapped down to a multiple of 8·f.  ``frame_skip``
        keeps every k-th frame and ``max_frames`` stops after that many.
        ``shared_noise``: one re-noising field for the whole video (the
        field does not flicker frame to frame); without it, under the
        engine's ``frozen_noise``, a field a frame keyed by its absolute
        index (``frame_noise_seed``), else draws from each dispatch's
        generator.  The dispatch generator's seed is ``seed·9973``, plus
        the first frame's index unless under ``frozen_noise`` (one
        transition field for the whole video).  ``latent_ema`` in [0, 1):
        a causal EMA of the source latents across frames and batches
        (z̃_i = (1 - a)·z_i + a·z̃_{i-1}) before re-noising.
        ``output_type``: "video" (writes ``output_filepath``, with
        ``audio_filepath`` muxed, and returns its path) or "frames" (PIL
        images).  An abort closes and deletes the half-written video."""
        refuse_unported("vid2vid", _VID2VID_UNPORTED, unported)
        if not 0.0 <= latent_ema < 1.0:
            raise ValueError("latent_ema must be in [0, 1)")
        batch_size = batch_size or self.models.default_batch_size
        grain = self.models.vae_scale_factor * 8

        def snap(n):
            return max(grain, (int(n) // grain) * grain)

        src_fps = None
        if isinstance(video, (str, Path)) and Path(video).is_file():
            info = probe_video(video)
            src_fps = info.get("fps") or None
            height = height or snap(info["height"])
            width = width or snap(info["width"])
            frames = read_video_frames(video, size=(height, width),
                                       frame_skip=frame_skip,
                                       max_frames=max_frames)
        else:
            base = (iter_frames(video)
                    if isinstance(video, (str, Path, np.ndarray))
                    else iter(video))

            def prepared():
                n = 0
                for i, fr in enumerate(base):
                    if i % frame_skip:
                        continue
                    yield fr
                    n += 1
                    if max_frames is not None and n >= max_frames:
                        return
            frames = prepared()
        fps = fps or src_fps or 30.0
        audio, sr = None, 22050
        if audio_filepath:
            audio, sr = load_audio(audio_filepath, sr=sr)

        args, noise, writer, ema = None, None, None, None
        out_frames: list = []
        frame_idx = 0
        c = self.models.unet_config.in_channels

        def flush(batch):
            nonlocal args, noise, writer, frame_idx, ema
            B = len(batch)
            arr = np.stack(batch).astype(np.float32) / 255.0
            if args is None or args["cond"].shape[0] != B:
                args = self._cond_uncond(prompt, negative_prompt, B)
            latents = self.engine.encode_image(arr * 2.0 - 1.0)
            if latent_ema > 0.0:
                for j in range(B):
                    ema = latents[j] if ema is None else (
                        (1.0 - latent_ema) * latents[j] + latent_ema * ema)
                    latents[j] = ema
            _, lh, lw, _ = latents.shape
            if shared_noise and noise is None:
                noise = self.init_noise(seed, (1, lh, lw, c))
            batch_noise = noise
            if batch_noise is None and self.engine.frozen_noise:
                batch_noise = torch.cat([
                    self.init_noise(frame_noise_seed(seed, frame_idx + j),
                                    (1, lh, lw, c)) for j in range(B)])
            key = int(seed) * 9973 + (0 if self.engine.frozen_noise
                                      else frame_idx)
            images = self.engine.img2img(
                init_latents=latents, strength=strength,
                num_inference_steps=num_inference_steps,
                guidance_scale=guidance_scale,
                generator=torch.Generator(self.device).manual_seed(key),
                noise=batch_noise, output_dtype="uint8", **args)
            for img in images:
                if output_type == "frames":
                    out_frames.append(img)
                    continue
                if writer is None:
                    writer = FrameWriter(output_filepath, fps=float(fps),
                                         audio=audio, audio_sr=sr)
                writer.add_frame(img)
            frame_idx += B

        batch: list = []
        try:
            for fr in frames:
                fr = np.asarray(fr.convert("RGB") if hasattr(fr, "convert")
                                else fr)
                if fr.dtype != np.uint8:
                    fr = ((np.clip(fr, 0.0, 1.0) * 255).round()
                          .astype(np.uint8) if fr.max() <= 1.5
                          else fr.astype(np.uint8))
                fr = fr[..., :3]
                if height is None or width is None:
                    height = height or snap(fr.shape[0])
                    width = width or snap(fr.shape[1])
                if fr.shape[:2] != (height, width):
                    from PIL import Image
                    fr = np.asarray(Image.fromarray(
                        np.ascontiguousarray(fr)).resize(
                            (width, height), Image.BILINEAR))
                batch.append(fr)
                if len(batch) == batch_size:
                    flush(batch)
                    batch = []
            if batch:
                flush(batch)
        except BaseException:
            # an abort leaves no half-written container behind
            if writer is not None:
                with contextlib.suppress(Exception):
                    writer.close()
                Path(writer.output_filepath).unlink(missing_ok=True)
            raise
        if frame_idx == 0:
            raise ValueError("video source yielded no frames")
        if output_type == "frames":
            return to_pil(np.stack(out_frames))
        return writer.close()

    # ------------------------------------------------------------------
    # the product: walk()
    # ------------------------------------------------------------------
    def walk(self, prompts: Optional[List[str]] = None,
             seeds: Optional[List[int]] = None,
             num_interpolation_steps: Union[int, List[int]] = 5,
             output_dir: str = "./dreams", name: Optional[str] = None,
             image_file_ext: str = ".png", fps: int = 30,
             num_inference_steps: int = 50, guidance_scale: float = 7.5,
             eta: float = 0.0, height: Optional[int] = None,
             width: Optional[int] = None, batch_size: Optional[int] = None,
             resume: bool = False, audio_filepath: Optional[str] = None,
             audio_start_sec: Optional[float] = None, margin: float = 1.0,
             smooth: float = 0.0, negative_prompt: Optional[str] = None,
             make_video: bool = True, **unported) -> str:
        """Generate a video walking through prompt/seed pairs.  Returns the
        final video path, or the run directory when ``make_video=False``."""
        refuse_unported("walk", _WALK_UNPORTED, unported)
        height = height or self.models.default_size
        width = width or self.models.default_size
        if batch_size is None:
            # the JAX package's default: 16 under ``fast`` (but SDXL's),
            # whose cond-only segments run one UNet row a frame; else the
            # family's (1 for SDXL at 1024²)
            batch_size = (16 if self.fast and not self.models.is_xl
                          else self.models.default_batch_size)
        name = name or time.strftime("%Y%m%d-%H%M%S")
        save_path_root = Path(output_dir) / name

        # validate before touching the filesystem
        if not resume:
            if prompts is None or seeds is None:
                raise ValueError("prompts and seeds are required")
            if len(prompts) != len(seeds):
                raise ValueError("#prompts must equal #seeds")
            if len(prompts) < 2:
                raise ValueError("need at least 2 prompts to walk between")
        save_path_root.mkdir(parents=True, exist_ok=True)

        config_path = save_path_root / "prompt_config.json"
        if resume:
            if not config_path.exists():
                raise FileNotFoundError(
                    f"resume=True but {config_path} does not exist; provide "
                    "the `name` of a previous run")
            data = json.loads(config_path.read_text())
            if data.get("upsample") or data.get("control_image"):
                raise NotImplementedError(
                    "this run used upsampling or ControlNet, which the "
                    "PyTorch package does not have yet")
            prompts, seeds = data["prompts"], data["seeds"]
            num_interpolation_steps = data["num_interpolation_steps"]
            fps = data["fps"]
            num_inference_steps = data["num_inference_steps"]
            guidance_scale, eta = data["guidance_scale"], data["eta"]
            height, width = data["height"], data["width"]
            audio_filepath = data["audio_filepath"]
            audio_start_sec = data["audio_start_sec"]
            margin = data.get("margin", 1.0)
            smooth = data.get("smooth", 0.0)
            negative_prompt = data.get("negative_prompt")
            logger.info("resuming %s", save_path_root)

        if isinstance(num_interpolation_steps, int):
            num_interpolation_steps = [num_interpolation_steps] * (
                len(prompts) - 1)
        if len(num_interpolation_steps) != len(prompts) - 1:
            raise ValueError("len(num_interpolation_steps) must be "
                             "len(prompts) - 1")

        if not resume:
            config_path.write_text(json.dumps(dict(
                prompts=prompts, seeds=seeds,
                num_interpolation_steps=num_interpolation_steps, fps=fps,
                num_inference_steps=num_inference_steps,
                guidance_scale=guidance_scale, eta=eta, upsample=False,
                upsample_weights=None, height=height, width=width,
                audio_filepath=audio_filepath,
                audio_start_sec=audio_start_sec, margin=margin,
                smooth=smooth, negative_prompt=negative_prompt,
                control_image=None, controlnet_scale=1.0,
                scheduler=self.engine.scheduler_name, tiled=False,
                framework="stable_diffusion_videos_tpu_torch",
            ), indent=4, sort_keys=True))

        audio_start_sec = audio_start_sec or 0.0
        # frozen_noise: one transition-noise seed for the whole video, from
        # the first seed, so no batch or clip boundary resets the field
        walk_noise_key = int(seeds[0]) if self.engine.frozen_noise else None
        clip_pairs = list(zip(prompts, prompts[1:], seeds, seeds[1:],
                              num_interpolation_steps))
        for i, (prompt_a, prompt_b, seed_a, seed_b, num_step) in enumerate(
                clip_pairs):
            clip_name = f"{name}_{i:06d}"
            clip_dir = save_path_root / clip_name
            clip_video = clip_dir / f"{clip_name}.mp4"

            skip = 0
            if resume:
                # the assembler may write .mp4 (ffmpeg/cv2) or .avi (the
                # native muxer): a clip with either container is complete
                vids = [p for p in clip_dir.glob(f"{clip_name}.*")
                        if p.suffix in (".mp4", ".avi")] \
                    if clip_dir.exists() else []
                if vids:
                    logger.info("skipping completed clip %s", clip_name)
                    continue
                existing = sorted(clip_dir.glob("frame*.png")) \
                    if clip_dir.exists() else []
                if existing:
                    skip = int(existing[-1].stem.lstrip("frame")) + 1
                    logger.info("resuming clip %s from frame %d", clip_name,
                                skip)

            audio_offset = audio_start_sec + sum(
                num_interpolation_steps[:i]) / fps
            audio_duration = num_step / fps

            if skip < num_step:
                T = None
                if audio_filepath:
                    T = get_timesteps_arr(audio_filepath, offset=audio_offset,
                                          duration=audio_duration, fps=fps,
                                          margin=margin, smooth=smooth)
                # frames stream into the clip encoder as they are made (the
                # PNGs are still written, for resume); a partial resume
                # replays the existing frames into the sink first
                frame_sink = None
                if make_video:
                    audio_slice, audio_sr = None, 22050
                    if audio_filepath:
                        audio_slice, audio_sr = load_audio(
                            audio_filepath, offset=audio_offset,
                            duration=audio_duration)
                    frame_sink = FrameWriter(str(clip_video), fps=fps,
                                             audio=audio_slice,
                                             audio_sr=audio_sr)
                    if skip > 0:
                        for f in iter_frames(clip_dir, "frame*.png"):
                            frame_sink.add_frame(f)
                try:
                    self.make_clip_frames(
                        prompt_a, prompt_b, seed_a, seed_b,
                        num_interpolation_steps=num_step, save_path=clip_dir,
                        num_inference_steps=num_inference_steps,
                        guidance_scale=guidance_scale, eta=eta, height=height,
                        width=width, batch_size=batch_size,
                        image_file_ext=image_file_ext, T=T, skip=skip,
                        negative_prompt=negative_prompt,
                        step=(i, len(clip_pairs)), frame_sink=frame_sink,
                        noise_key=walk_noise_key)
                    if frame_sink is not None:
                        frame_sink.close()
                except BaseException:
                    # a half-written container would read as a finished clip
                    if frame_sink is not None:
                        with contextlib.suppress(Exception):
                            frame_sink.close()
                        Path(frame_sink.output_filepath).unlink(
                            missing_ok=True)
                    raise
            elif make_video:
                assemble(clip_dir, audio_filepath=audio_filepath, fps=fps,
                           output_filepath=str(clip_video),
                           audio_offset=audio_offset,
                           audio_duration=audio_duration,
                           glob_pattern="*.png")

        if make_video:
            return assemble(
                save_path_root, audio_filepath=audio_filepath, fps=fps,
                output_filepath=str(save_path_root / f"{name}.mp4"),
                audio_offset=audio_start_sec,
                audio_duration=sum(num_interpolation_steps) / fps,
                glob_pattern="**/frame*.png")
        return str(save_path_root)
