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
causal EMA of the source latents).

The conditioning add-ons: ``controlnet=`` (a model directory or file, a
bundle, or a list for multi-ControlNet) with a ``control_image`` that pins
every frame of a clip or a per-frame sequence, vid2vid's ``control_video``
or ``control_from_source`` ("canny" edges or the frame itself);
``ip_adapter=`` (a checkpoint, or (checkpoint, image-encoder directory))
with ``ip_image``; ``prompt_weighting=True`` (emphasis syntax and prompts of
several 77-token windows; cond, uncond and both clip endpoints share one
window count, and SDXL's pooled embedding comes from the prompt without its
syntax).  LoRA and textual-inversion files merge into an ``SDModels`` before
the pipeline is built (``models/lora_file.py``,
``models/textual_inversion.py``).

Post-processing and the opt-in levers: ``safety=`` (the bundle's NSFW
checker, on by default when it has one), ``upsample=`` (Real-ESRGAN,
``pipeline/upsampling.py``, weights from ``upsample_weights=``,
``SDV_REALESRGAN`` or an assigned ``pipeline.upsampler``), ``freeu=`` and
``tome=`` (``SDModels.with_freeu``/``with_tome``), ``embed_interp`` and
``noise_interp``; ``generate``/``__call__`` is one txt2img dispatch.  Frames
are quantised, checked, blacked out where flagged and upsampled on the
device, after the next batch is enqueued, then copied to the host.  The
JAX pipeline's ``mesh`` stays refused (one card).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from ..audio.analysis import get_timesteps_arr, load_audio
from ..core.interp import lerp, slerp
from ..core.prompt_weighting import chunks_needed, strip_prompt_weights
from ..core.rng import noise_for_seed
from ..media.png import write_png
from ..media.video import (FrameWriter, iter_frames, probe_video,
                           read_video_frames)
from ..media.video import make_video as assemble
from ..models.bundle import SDModels
from ..models.controlnet import load_controlnet
from ..models.ip_adapter import load_ip_adapter
from ..runtime.engine import Engine, quantise, refuse_unported
from .upsampling import RealESRGANModel

logger = logging.getLogger("sdv_torch")

_PIPELINE_UNPORTED = ("mesh",)
_INTERP = {"lerp": lerp, "slerp": slerp}
_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


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


def load_control_image(image, height: int, width: int) -> np.ndarray:
    """A path, PIL image or array -> (1, height, width, 3) float32 in [0,
    1], a ControlNet map (canny, depth and pose maps are plain images); a
    path or PIL image is resized (bilinear), an array must have the size."""
    from PIL import Image
    if isinstance(image, (str, Path)):
        image = Image.open(image)
    if isinstance(image, Image.Image):
        image = np.asarray(image.convert("RGB").resize(
            (width, height), Image.BILINEAR))
    image = np.asarray(image, np.float32)
    if image.max() > 1.5:  # uint8 range
        image = image / 255.0
    if image.ndim == 3:
        image = image[None]
    if image.shape[1:3] != (height, width):
        raise ValueError(f"control image is {image.shape[1:3]}, expected "
                         f"({height}, {width}): pass a path or PIL image to "
                         "resize it")
    return image


def load_control_source(source, height: int, width: int) -> np.ndarray:
    """A ControlNet source -> (N, height, width, 3) float32: one map (N =
    1, ``load_control_image``'s inputs) that pins every frame, or a
    per-frame sequence, a directory of images (sorted by name) or an (N, H,
    W, 3) array."""
    if isinstance(source, (str, Path)) and Path(source).is_dir():
        files = sorted(p for p in Path(source).iterdir()
                       if p.suffix.lower() in _IMAGE_SUFFIXES)
        if not files:
            raise ValueError(f"control directory {source} has no images")
        return np.concatenate([load_control_image(f, height, width)
                               for f in files])
    if getattr(source, "ndim", 0) == 4 and source.shape[0] > 1:
        return np.concatenate([load_control_image(a, height, width)
                               for a in np.asarray(source)])
    return load_control_image(source, height, width)


def canny_map(frame: np.ndarray, thresholds=(100, 200)) -> np.ndarray:
    """A uint8 (H, W, 3) frame -> its cv2 Canny edges as an (H, W, 3)
    float32 map in [0, 1]."""
    import cv2
    lo, hi = thresholds
    edges = cv2.Canny(frame, int(lo), int(hi))
    return np.repeat(edges[..., None], 3, axis=2).astype(np.float32) / 255.0


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
                 frozen_noise: bool = False, prompt_weighting: bool = False,
                 controlnet=None, ip_adapter=None,
                 safety: Optional[bool] = None, freeu=None, tome=None,
                 embed_interp: str = "lerp", noise_interp: str = "slerp",
                 **unported):
        """``controlnet``: a diffusers ControlNetModel directory or weights
        file, a ``ControlNetBundle``, or a list of them (multi-ControlNet).
        ``ip_adapter``: an IP-Adapter checkpoint, ``(checkpoint,
        image-encoder directory)`` or an ``IPAdapter``.
        ``prompt_weighting``: read prompts in the emphasis syntax and let
        them run past 77 tokens (off by default, so that parentheses in a
        prompt stay literal).
        ``safety``: black out the frames the bundle's safety checker flags;
        None is on when the bundle has a checker (with a warning when it
        has none).  ``freeu``: True (the family's published factors) or
        (b1, b2, s1, s2).  ``tome``: a ratio, or (ratio, max_level).
        ``embed_interp``/``noise_interp``: "lerp" or "slerp", the
        trajectories of the text embeddings and of the initial noise."""
        refuse_unported("StableDiffusionWalkPipeline", _PIPELINE_UNPORTED,
                        unported)
        for name, value in (("embed_interp", embed_interp),
                            ("noise_interp", noise_interp)):
            if value not in _INTERP:
                raise ValueError(f"{name} must be one of {sorted(_INTERP)}, "
                                 f"got {value!r}")
        if freeu:
            models = models.with_freeu(freeu)
        if tome:
            if isinstance(tome, (int, float)):
                tome = (float(tome), 0)
            models = models.with_tome(*tome)
        if fast:
            # the JAX package's presets, explicit kwargs win: SD 1.x/2.x
            # step_cache=3 x guidance_interval (0.1, 0.85); SDXL
            # step_cache=2 alone; a ControlNet keeps the interval alone,
            # since step caching cannot take its residuals
            if step_cache is None and controlnet is None:
                step_cache = 2 if models.is_xl else 3
            if guidance_interval is None and not models.is_xl:
                guidance_interval = (0.1, 0.85)
        self.fast = bool(fast)
        self.device = torch.device(device)
        if controlnet is not None:
            nets = (controlnet if isinstance(controlnet, (list, tuple))
                    else [controlnet])
            nets = [load_controlnet(c, models.dtype)
                    if isinstance(c, (str, Path)) else c for c in nets]
            controlnet = nets if isinstance(controlnet, (list, tuple)) \
                else nets[0]
        if isinstance(ip_adapter, (str, Path)):
            ip_adapter = load_ip_adapter(ip_adapter, models)
        elif isinstance(ip_adapter, tuple):
            ip_adapter = load_ip_adapter(ip_adapter[0], models,
                                         image_encoder=ip_adapter[1])
        self.prompt_weighting = bool(prompt_weighting)
        self.engine = Engine(models, self.device, scheduler=scheduler,
                             batch_bucket=batch_bucket,
                             step_cache=step_cache,
                             step_cache_split=step_cache_split,
                             step_cache_policy=step_cache_policy,
                             guidance_rescale=guidance_rescale,
                             guidance_interval=guidance_interval,
                             frozen_noise=frozen_noise,
                             controlnet=controlnet, ip_adapter=ip_adapter)
        #: the engine's bundle (with an IP-Adapter, its UNet carries the
        #: adapter's projections)
        self.models = self.engine.models
        self.embed_interp, self.noise_interp = embed_interp, noise_interp
        if safety is None:
            safety = self.models.safety_checker() is not None
            if not safety:
                logger.warning(
                    "This bundle has no safety checker: NSFW filtering is "
                    "off.  Attach one (SDModels.with_safety_checker) or pass "
                    "safety=False to silence this warning; see the Stable "
                    "Diffusion license's conditions of use.")
        self.safety = bool(safety)
        #: the Real-ESRGAN upsampler (``_ensure_upsampler``), or None
        self.upsampler: Optional[RealESRGANModel] = None
        #: (weights path, model) of the upsampler this pipeline loaded
        self._loaded_upsampler: Optional[tuple] = None

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

    def _embed(self, prompt: str, num_chunks: Optional[int] = None):
        """One prompt's context: weighted at ``num_chunks`` windows under
        ``prompt_weighting``, else plain."""
        if self.prompt_weighting:
            return self.engine.embed_text_weighted(prompt, num_chunks)
        return self.engine.embed_text(prompt)

    def _num_chunks(self, *prompts) -> Optional[int]:
        """The window count that every prompt of one dispatch shares under
        ``prompt_weighting`` (cond and uncond concatenate into one CFG
        batch), else None."""
        if not self.prompt_weighting:
            return None
        return max(chunks_needed(self.models.tokenizer, p or "")
                   for p in prompts)

    def _pooled(self, prompt: str) -> torch.Tensor:
        """SDXL's pooled embedding, of the prompt without its emphasis
        syntax under ``prompt_weighting`` (the pooled vector has no token
        axis to weight)."""
        if self.prompt_weighting:
            prompt = strip_prompt_weights(prompt)
        return self.engine.embed_text_pooled(prompt)

    def _ip_kwargs(self, ip_image, ip_scale: float = 1.0) -> dict:
        """One image prompt -> the engine's ``ip_tokens``/``ip_scale``,
        computed once a call and reused by every dispatch."""
        if ip_image is None:
            return {}
        if self.engine.ip is None:
            raise ValueError("ip_image= requires a pipeline built with "
                             "ip_adapter= (see models/ip_adapter.py)")
        return dict(ip_tokens=self.engine.ip.image_tokens(ip_image),
                    ip_scale=float(ip_scale))

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
                        noise_shape, T, batch_size: int,
                        num_chunks: Optional[int] = None):
        """Interpolated (embeds, noise, pooled) batches for one clip: the
        whole trajectory is built at once (``embed_interp``, default lerp;
        ``noise_interp``, default slerp), then cut into dispatch batches.
        ``pooled`` is None but for SDXL, whose pooled embedding walks the
        embeddings' trajectory.  Under ``prompt_weighting`` the endpoints
        are weighted contexts of ``num_chunks`` windows."""
        embeds_a = self._embed(prompt_a, num_chunks)
        embeds_b = self._embed(prompt_b, num_chunks)
        noise_a = self.init_noise(seed_a, noise_shape)
        noise_b = self.init_noise(seed_b, noise_shape)
        T = np.asarray(T, np.float32)
        interp_e = _INTERP[self.embed_interp]
        embeds = interp_e(T, embeds_a[0], embeds_b[0])
        noise = _INTERP[self.noise_interp](T, noise_a[0], noise_b[0])
        pooled = None
        if self.models.is_xl:
            pooled = interp_e(T, self._pooled(prompt_a)[0],
                              self._pooled(prompt_b)[0])
        for i in range(0, len(T), batch_size):
            yield (embeds[i:i + batch_size], noise[i:i + batch_size],
                   None if pooled is None else pooled[i:i + batch_size])

    # ------------------------------------------------------------------
    # post-processing
    # ------------------------------------------------------------------
    def _postprocess_frames(self, images, upsample: bool) -> tuple:
        """(B, H, W, 3) frames, uint8 or float in [0, 1], on the device or
        the host -> (uint8 frames on the host, the safety flags or None).
        On the device: quantised, checked by the safety checker on
        uint8/255 (with ``safety``), flagged frames blacked out, then, when
        ``upsample``, upsampled by ``self.upsampler`` and quantised again;
        the copy to the host is the only wait.  ``walk``, ``make_clip_frames``
        and ``generate_images`` upsample when their ``upsample`` asks; the
        edit paths and ``generate``, which take no such argument, upsample
        when ``self.upsampler`` is set, as the JAX package's do."""
        x = torch.as_tensor(images).to(self.device)
        if x.dtype != torch.uint8:
            x = quantise(x.float().clamp(0.0, 1.0))
        flags = None
        if self.safety:
            flags = self.engine.check_safety(x.float() / 255.0)
            x = x.masked_fill(flags[:, None, None, None], 0)
        if upsample:
            x = quantise(self.upsampler(x.float() / 255.0))
        frames = x.cpu().numpy()
        if flags is not None:
            flags = flags.cpu().numpy()
            if flags.any():
                logger.warning("safety checker flagged %d frame(s); blacked "
                               "out", int(flags.sum()))
        return frames, flags

    def _postprocess(self, images, upsample: bool) -> list:
        """``_postprocess_frames``'s frames as PIL images."""
        return to_pil(self._postprocess_frames(images, upsample)[0])

    def _ensure_upsampler(self, weights: Optional[str] = None) -> None:
        """Provision the Real-ESRGAN upsampler before any frame is made.
        Its weights come from, in this order: ``weights`` (the
        ``upsample_weights=`` argument), the ``SDV_REALESRGAN`` variable,
        then an upsampler already assigned to ``pipeline.upsampler``.  A
        path that does not exist, or no source at all, raises
        ``FileNotFoundError``, and an assigned upsampler on another device
        ``ValueError``; a path this pipeline already loaded is not read
        again.  A path builds an untiled upsampler; for a tiled one assign
        ``RealESRGANModel.from_pretrained(path, device, tile=...)`` and
        give neither the argument nor the variable."""
        weights = weights or os.environ.get("SDV_REALESRGAN")
        if weights is None:
            if self.upsampler is not None:
                if self.upsampler.device != self.models.unet.conv_in \
                        .weight.device:
                    raise ValueError(
                        f"pipeline.upsampler runs on {self.upsampler.device}"
                        f", the pipeline on {self.device}: build it with "
                        "the pipeline's device")
                return
            raise FileNotFoundError(
                "upsample=True needs RealESRGAN weights (e.g. "
                "RealESRGAN_x4plus.pth): pass upsample_weights=, set "
                "SDV_REALESRGAN, or assign pipeline.upsampler; nothing is "
                "downloaded")
        if not Path(weights).exists():
            raise FileNotFoundError(
                f"upsample weights not found: {weights!r} (from "
                "upsample_weights= or SDV_REALESRGAN)")
        if self._loaded_upsampler is not None and (
                self._loaded_upsampler[0] == str(weights)
                and self._loaded_upsampler[1] is self.upsampler):
            return
        self.upsampler = RealESRGANModel.from_pretrained(weights,
                                                         self.device)
        self._loaded_upsampler = (str(weights), self.upsampler)

    def _upsampler_source(self) -> Optional[str]:
        """The weights path of the current upsampler, if this pipeline
        loaded it."""
        loaded = self._loaded_upsampler
        return loaded[0] if loaded and loaded[1] is self.upsampler else None

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
                         noise_key: Optional[int] = None,
                         control_image=None, controlnet_scale=1.0,
                         ip_image=None, ip_scale: float = 1.0,
                         upsample: bool = False,
                         upsample_weights: Optional[str] = None):
        """Generate and save the frames of one prompt-pair clip, safety
        checked under ``safety`` and upsampled with ``upsample``
        (``_ensure_upsampler`` reads ``upsample_weights``).

        ``noise_key``: the seed of every dispatch's transition-noise
        generator (``walk()`` passes one video-level seed under
        ``frozen_noise``, so the frozen field is constant across batch and
        clip boundaries).  Without it each dispatch's seed mixes both clip
        seeds and the batch index (the batch index is 0 under
        ``frozen_noise``), so clips that share ``seed_a`` draw decoupled
        noise.

        ``control_image`` (a pipeline with ``controlnet=``): a map (path,
        PIL image or array) that pins every frame of the clip, a directory
        or (N, H, W, 3) array of ``num_interpolation_steps`` per-frame maps,
        or a list of either for several nets, at ``controlnet_scale``.
        ``ip_image`` (a pipeline with ``ip_adapter=``): the image prompt of
        every frame, at ``ip_scale``."""
        if image_file_ext != ".png":
            raise ValueError("the PyTorch package writes .png frames only")
        if upsample:
            self._ensure_upsampler(upsample_weights)
        height = height or self.models.default_size
        width = width or self.models.default_size
        control = None
        if control_image is not None:
            if self.engine.controlnet is None:
                raise ValueError("control_image= requires a pipeline built "
                                 "with controlnet=")
            srcs = (list(control_image)
                    if isinstance(control_image, (list, tuple))
                    else [control_image])
            control = [load_control_source(c, height, width) for c in srcs]
            for c in control:
                if c.shape[0] not in (1, num_interpolation_steps):
                    raise ValueError(
                        f"control sequence has {c.shape[0]} frames; the "
                        f"clip has {num_interpolation_steps}")
        save_path = Path(save_path)
        save_path.mkdir(parents=True, exist_ok=True)
        T = np.asarray(T if T is not None
                       else np.linspace(0.0, 1.0, num_interpolation_steps))
        if T.shape[0] != num_interpolation_steps:
            raise ValueError(
                f"len(T) ({T.shape[0]}) != num_interpolation_steps "
                f"({num_interpolation_steps})")
        T = T[skip:]
        neg = negative_prompt or ""
        num_chunks = self._num_chunks(prompt_a, prompt_b, neg)
        uncond = self._embed(neg, num_chunks)
        uncond_pooled = self._pooled(neg) if self.models.is_xl else None
        ip_kw = self._ip_kwargs(ip_image, ip_scale)
        batches = self.generate_inputs(prompt_a, prompt_b, seed_a, seed_b,
                                       self._latent_shape(height, width), T,
                                       batch_size, num_chunks)
        save_futures = []

        def drain(pool, pending):
            # enqueued after the next batch: the card runs that batch's
            # denoise, then this one's post-processing
            imgs_dev, valid, start = pending
            frames, _ = self._postprocess_frames(imgs_dev[:valid], upsample)
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
                    uncond_pooled=uncond_pooled,
                    control=None if control is None else [
                        # a sequence follows the absolute frame index, one
                        # map broadcasts over the batch
                        c if c.shape[0] == 1
                        else c[frame_index:frame_index + len(noise)]
                        for c in control],
                    control_scale=controlnet_scale, **ip_kw)
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
        cond, uncond (weighted, at one window count, under
        ``prompt_weighting``) and, for SDXL, the pooled pair."""
        neg = negative_prompt or ""
        n = self._num_chunks(prompt, neg)
        cond = self._embed(prompt, n)
        out = dict(cond=cond.expand((batch,) + tuple(cond.shape[1:])),
                   uncond=self._embed(neg, n))
        if self.models.is_xl:
            pooled = self._pooled(prompt)
            out.update(pooled=pooled.expand(
                (batch,) + tuple(pooled.shape[1:])),
                uncond_pooled=self._pooled(neg))
        return out

    def img2img(self, image, prompt: str, strength: float = 0.75,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                eta: float = 0.0, negative_prompt: Optional[str] = None,
                seed: int = 0, output_type: str = "pil", control_image=None,
                controlnet_scale=1.0, ip_image=None, ip_scale: float = 1.0):
        """Image-to-image: encode ``image`` (PIL, or (H, W, 3) / (B, H, W,
        3) uint8 or [0, 1]), re-noise it to ``strength`` of the schedule
        and denoise toward ``prompt``, under ``control_image`` (one map at
        the image's size) and ``ip_image`` as ``make_clip_frames`` takes
        them.  -> PIL images, or with another ``output_type`` float32 (B,
        H, W, 3) frames in [0, 1]."""
        arr = image_array(image)
        latents = self.engine.encode_image(arr * 2.0 - 1.0)
        ctrl_kw = {}
        if control_image is not None:
            f = self.models.vae_scale_factor
            ctrl_kw = dict(control=load_control_image(
                control_image, latents.shape[1] * f, latents.shape[2] * f),
                control_scale=controlnet_scale)
        images = self.engine.img2img(
            init_latents=latents, strength=strength,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, eta=eta,
            generator=torch.Generator(self.device).manual_seed(int(seed)),
            output_dtype="uint8" if output_type == "pil" else "float32",
            **self._cond_uncond(prompt, negative_prompt, len(arr)),
            **ctrl_kw, **self._ip_kwargs(ip_image, ip_scale))
        return (self._postprocess(images, self.upsampler is not None)
                if output_type == "pil" else images)

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
        return (self._postprocess(images, self.upsampler is not None)
                if output_type == "pil" else images)

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
                output_type: str = "video", control_video=None,
                controlnet_scale=1.0,
                control_from_source: Optional[str] = None,
                canny_thresholds=(100, 200), ip_image=None,
                ip_scale: float = 1.0):
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
        images).  An abort closes and deletes the half-written video.

        ControlNet (a pipeline with ``controlnet=``): ``control_video`` (a
        video file, a directory of maps, one image or an (N, H, W, 3)
        array; one map pins every frame, else map i conditions frame i,
        the last map held past the sequence's end; an array video source
        needs ``height`` and ``width``), or ``control_from_source``, each
        source frame's map made on the fly: "canny" (cv2 edges at
        ``canny_thresholds``) or "identity" (the frame itself); weighted by
        ``controlnet_scale``.  ``ip_image``/``ip_scale``: the image prompt
        of every frame."""
        if not 0.0 <= latent_ema < 1.0:
            raise ValueError("latent_ema must be in [0, 1)")
        if (control_video is not None or control_from_source is not None) \
                and self.engine.controlnet is None:
            raise ValueError("control_video/control_from_source require a "
                             "pipeline built with controlnet=")
        if control_from_source is not None:
            if control_video is not None:
                raise ValueError("control_video and control_from_source "
                                 "are mutually exclusive")
            if control_from_source not in ("canny", "identity"):
                raise ValueError(f"control_from_source must be 'canny' or "
                                 f"'identity', got {control_from_source!r}")
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
        ctrl_maps = None
        if control_video is not None:
            if (isinstance(control_video, (str, Path))
                    and Path(control_video).is_file()):
                # a video file is decoded once the frame size is known
                ctrl_maps = control_video
            elif height is None or width is None:
                raise ValueError("pass height and width when control_video "
                                 "is used with an array or list video "
                                 "source")
            else:
                ctrl_maps = load_control_source(control_video, height, width)
        audio, sr = None, 22050
        if audio_filepath:
            audio, sr = load_audio(audio_filepath, sr=sr)
        ip_kw = self._ip_kwargs(ip_image, ip_scale)

        args, noise, writer, ema = None, None, None, None
        out_frames: list = []
        frame_idx = 0
        c = self.models.unet_config.in_channels

        def flush(batch):
            nonlocal args, noise, writer, frame_idx, ema, ctrl_maps
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
            ctrl_kw = {}
            if control_from_source is not None:
                ctrl_kw = dict(control=np.stack([
                    canny_map(fr, canny_thresholds)
                    if control_from_source == "canny"
                    else fr.astype(np.float32) / 255.0 for fr in batch]),
                    control_scale=controlnet_scale)
            elif ctrl_maps is not None:
                if not isinstance(ctrl_maps, np.ndarray):
                    # the control video, at the output's size and cadence
                    ctrl_maps = np.stack([
                        m.astype(np.float32) / 255.0 for m in
                        read_video_frames(ctrl_maps, size=(height, width),
                                          frame_skip=frame_skip,
                                          max_frames=max_frames)])
                idx = np.minimum(np.arange(frame_idx, frame_idx + B),
                                 len(ctrl_maps) - 1)
                ctrl_kw = dict(control=ctrl_maps[idx],
                               control_scale=controlnet_scale)
            images = self.engine.img2img(
                init_latents=latents, strength=strength,
                num_inference_steps=num_inference_steps,
                guidance_scale=guidance_scale,
                generator=torch.Generator(self.device).manual_seed(key),
                noise=batch_noise, output_dtype="uint8", **args, **ctrl_kw,
                **ip_kw)
            for img in self._postprocess_frames(
                    images, self.upsampler is not None)[0]:
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
             make_video: bool = True, control_image=None,
             controlnet_scale=1.0, ip_image=None, ip_scale: float = 1.0,
             upsample: bool = False, upsample_weights: Optional[str] = None,
             params=None, jit: Optional[bool] = None) -> str:
        """Generate a video walking through prompt/seed pairs.  Returns the
        final video path, or the run directory when ``make_video=False``.
        ``control_image``/``controlnet_scale`` and ``ip_image``/``ip_scale``
        condition every clip as ``make_clip_frames`` describes; a control
        image given as a path (or list of paths) is recorded in
        ``prompt_config.json``, so a resume picks it up.  ``upsample``:
        Real-ESRGAN on every frame, its weights provisioned before the run
        directory is made (``_ensure_upsampler``) and recorded for a
        resume.  ``params``/``jit`` (the JAX pipeline's) are ignored."""
        if params is not None or jit is not None:
            logger.info("walk(params=..., jit=...) are managed by the engine "
                        "in this framework; arguments ignored")
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
        # fail before the run directory exists
        if upsample:
            self._ensure_upsampler(upsample_weights)
        if control_image is not None and self.engine.controlnet is None:
            raise ValueError("control_image= requires a pipeline built with "
                             "controlnet=")
        save_path_root.mkdir(parents=True, exist_ok=True)

        config_path = save_path_root / "prompt_config.json"
        if resume:
            if not config_path.exists():
                raise FileNotFoundError(
                    f"resume=True but {config_path} does not exist; provide "
                    "the `name` of a previous run")
            data = json.loads(config_path.read_text())
            upsample = data["upsample"]
            if upsample:
                self._ensure_upsampler(upsample_weights
                                       or data.get("upsample_weights"))
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
            if control_image is None and data.get("control_image"):
                control_image = data["control_image"]
            controlnet_scale = data.get("controlnet_scale", controlnet_scale)
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
                guidance_scale=guidance_scale, eta=eta, upsample=upsample,
                upsample_weights=(self._upsampler_source() if upsample
                                  else None),
                height=height, width=width,
                audio_filepath=audio_filepath,
                audio_start_sec=audio_start_sec, margin=margin,
                smooth=smooth, negative_prompt=negative_prompt,
                # only paths can be resumed from (arrays are not JSON)
                control_image=(
                    str(control_image)
                    if isinstance(control_image, (str, Path))
                    else [str(c) for c in control_image]
                    if (isinstance(control_image, (list, tuple))
                        and all(isinstance(c, (str, Path))
                                for c in control_image))
                    else None),
                controlnet_scale=controlnet_scale,
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
                        noise_key=walk_noise_key,
                        control_image=control_image,
                        controlnet_scale=controlnet_scale,
                        ip_image=ip_image, ip_scale=ip_scale,
                        upsample=upsample,
                        upsample_weights=self._upsampler_source())
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

    # ------------------------------------------------------------------
    # one txt2img dispatch
    # ------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """``generate``."""
        return self.generate(*args, **kwargs)

    def generate(self, prompt: Optional[Union[str, List[str]]] = None,
                 height: Optional[int] = None, width: Optional[int] = None,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 eta: float = 0.0, latents=None, text_embeddings=None,
                 negative_prompt: Optional[str] = None,
                 seed: Optional[int] = None, output_type: str = "pil",
                 return_dict: bool = False, pooled_embeddings=None):
        """txt2img of ``prompt`` (one or a list) or of precomputed
        ``text_embeddings`` (B, 77, D), from ``latents`` (B, h, w, 4) or
        noise of seeds ``seed``, ``seed + 1``, ...; an SDXL bundle also
        takes ``pooled_embeddings`` beside precomputed embeddings.  ->
        post-processed PIL images; float32 (B, H, W, 3) frames for another
        ``output_type``; with ``return_dict`` {"images": PIL images,
        "nsfw_content_detected": one bool a frame}, the flags those that
        blacked the frames out (computed once, on the quantised
        frames)."""
        height = height or self.models.default_size
        width = width or self.models.default_size
        if text_embeddings is None:
            if prompt is None:
                raise ValueError("provide `prompt` or `text_embeddings`")
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            text_embeddings = self.engine.embed_text(prompts)
            if self.models.is_xl and pooled_embeddings is None:
                pooled_embeddings = self.engine.embed_text_pooled(prompts)
        if self.models.is_xl and pooled_embeddings is None:
            raise ValueError("SDXL bundle: precomputed text_embeddings also "
                             "need pooled_embeddings")
        batch = text_embeddings.shape[0]
        if latents is None:
            shape = self._latent_shape(height, width)
            latents = torch.cat([self.init_noise((seed or 0) + i, shape)
                                 for i in range(batch)])
        neg = negative_prompt or ""
        xl_kw = (dict(pooled=pooled_embeddings,
                      uncond_pooled=self.engine.embed_text_pooled(neg))
                 if self.models.is_xl else {})
        imgs, valid = self.engine.denoise_frames_async(
            text_embeddings, self.engine.embed_text(neg), latents,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, eta=eta, **xl_kw)
        images = imgs[:valid]
        if return_dict:
            frames, flags = self._postprocess_frames(
                images, self.upsampler is not None)
            if flags is None:
                flags = np.zeros(len(frames), bool)
            return {"images": to_pil(frames),
                    "nsfw_content_detected": flags.tolist()}
        if output_type == "pil":
            return self._postprocess(images, self.upsampler is not None)
        return images.cpu().numpy()
