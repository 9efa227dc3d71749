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
seed.  Options of the JAX pipeline this port does not have yet
(upsampling, the safety checker, FreeU, ToMe, prompt weighting, ControlNet,
IP-Adapter, the edit paths) raise when they are asked for.
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
from ..media.video import FrameWriter, iter_frames
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


def dispatch_seed(seed_a: int, seed_b: int, batch_idx: int) -> int:
    """A 64-bit generator seed mixed from both clip seeds and the batch
    index."""
    mask = 2 ** 64 - 1
    return int(np.random.SeedSequence(
        [int(seed_a) & mask, int(seed_b) & mask, int(batch_idx)])
        .generate_state(1, np.uint64)[0])


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
