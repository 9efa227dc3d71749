"""One-shot checkpoint validation: ``python -m
stable_diffusion_videos_tpu_torch validate CKPT``.

Counterpart of ``stable_diffusion_videos_tpu/utils/validate.py``, with the
same six stages and one JSON report:

1. **load**: a native bundle directory (``SDModels.load``), a
   diffusers-layout directory or a single ``.ckpt``/``.safetensors`` file;
   the family and the parameter counts;
2. **smoke**: one fixed-seed txt2img frame, finiteness and pixel
   statistics;
3. **vae_roundtrip**: encode and decode a synthetic image, its PSNR
   (trained VAEs land above about 20 dB, random weights do not: reported,
   not gated);
4. **walk_parity**: the parity gate's walk against a reference frame dump
   (``utils/parity_gate.py``);
5. **step_cache_curve**: one seed's frames under ``step_cache=k`` for each
   ``k``, the ``fast`` preset and its "ends" variant against the exact
   program's (``quality_vs_exact``, with LPIPS when weights are given);
6. **upsample**: Real-ESRGAN on the smoke frame.

A stage without its optional input (reference frames, upsampler weights) is
``skipped`` with the reason.  An ``Exception`` in a stage is recorded as its
``error`` and the run goes on; ``KeyboardInterrupt`` and ``SystemExit``
propagate.  Any ``error`` or ``fail`` makes ``pass`` false.  Everything runs
on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("sdv_torch")


class _Stage:
    """Records a stage's status, seconds and error; swallows the stage's
    ``Exception``, never ``KeyboardInterrupt`` or ``SystemExit``."""

    def __init__(self, report: dict, name: str):
        self.report, self.name = report, name

    def __enter__(self) -> dict:
        self.t0 = time.perf_counter()
        self.entry = self.report["stages"][self.name] = {"status": "ok"}
        return self.entry

    def __exit__(self, et, ev, tb) -> bool:
        self.entry["seconds"] = round(time.perf_counter() - self.t0, 2)
        if et is not None and issubclass(et, Exception):
            self.entry["status"] = "error"
            self.entry["error"] = f"{et.__name__}: {str(ev)[:300]}"
            logger.exception("validate stage %r failed", self.name)
            return True
        return False


def _skip(report: dict, name: str, why: str):
    report["stages"][name] = {"status": "skipped", "reason": why}


def _save_png(path: Path, frame: np.ndarray) -> None:
    from ..media.png import write_png
    write_png(path, np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8))


def run_validation(checkpoint: str, output_dir: str = "./validate_out",
                   reference_frames: Optional[str] = None,
                   lpips_weights: Optional[str] = None,
                   upsample_weights: Optional[str] = None,
                   scheduler: str = "pndm",
                   num_inference_steps: int = 50,
                   height: Optional[int] = None,
                   width: Optional[int] = None,
                   step_cache_ks=(2, 3),
                   tokenizer_dir: Optional[str] = None,
                   device="cuda") -> dict:
    """Run every stage on ``checkpoint``; -> the report, also written to
    ``<output_dir>/validation_report.json``."""
    import torch

    from ..pipeline.walk import StableDiffusionWalkPipeline

    device = torch.device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    report: dict = {"checkpoint": str(checkpoint), "stages": {},
                    "config": {"scheduler": scheduler,
                               "num_inference_steps": num_inference_steps,
                               "device": str(device)}}

    # ---- 1. load ------------------------------------------------------
    pipe = None
    with _Stage(report, "load") as st:
        ckpt = Path(checkpoint)
        if ckpt.is_dir() and (ckpt / "bundle.json").exists():
            from ..models.bundle import SDModels
            pipe = StableDiffusionWalkPipeline(
                SDModels.load(ckpt, device=device), device,
                scheduler=scheduler)
            st["layout"] = "native bundle"
        else:
            pipe = StableDiffusionWalkPipeline.from_pretrained(
                str(checkpoint), device=device, scheduler=scheduler,
                tokenizer_dir=tokenizer_dir)
            st["layout"] = ("single-file" if ckpt.is_file()
                            else "diffusers directory")
        st["family"] = "sdxl" if pipe.models.is_xl else "sd"
        st["param_counts"] = pipe.models.param_count()
        st["default_size"] = pipe.models.default_size
    if pipe is None:
        report["pass"] = False
        _write(report, out)
        return report
    height = height or pipe.models.default_size
    width = width or pipe.models.default_size
    report["config"].update(height=height, width=width)

    # ---- 2. smoke generation -----------------------------------------
    smoke = None
    with _Stage(report, "smoke") as st:
        smoke = pipe(prompt="a photograph of an astronaut riding a horse",
                     seed=42, num_inference_steps=num_inference_steps,
                     height=height, width=width, output_type="np")[0]
        st["shape"] = list(smoke.shape)
        st["finite"] = bool(np.isfinite(smoke).all())
        st["pixel_stats"] = {"min": round(float(smoke.min()), 4),
                             "max": round(float(smoke.max()), 4),
                             "mean": round(float(smoke.mean()), 4),
                             "std": round(float(smoke.std()), 4)}
        if not st["finite"]:
            st["status"] = "fail"
        _save_png(out / "smoke_frame.png", smoke)

    # ---- 3. VAE round trip -------------------------------------------
    with _Stage(report, "vae_roundtrip") as st:
        from .metrics import psnr
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        img = np.stack([np.sin(yy / 17) * 0.5 + 0.5,
                        np.cos(xx / 23) * 0.5 + 0.5,
                        ((yy + xx) % 97) / 97.0], axis=-1)[None]
        lat = pipe.engine.encode_image(img * 2.0 - 1.0)
        dec = pipe.engine.decode_latents(lat)
        st["psnr_db"] = round(psnr(dec[0], img[0], data_range=1.0), 2)
        # trained SD VAEs reconstruct smooth synthetic content well;
        # random weights do not: informational
        st["looks_trained"] = bool(st["psnr_db"] > 18.0)

    # ---- 4. walk parity gate -----------------------------------------
    if reference_frames:
        with _Stage(report, "walk_parity") as st:
            from .parity_gate import run_parity_gate
            res = run_parity_gate(pipe, reference_frames,
                                  str(out / "parity"),
                                  lpips_weights=lpips_weights,
                                  height=height, width=width)
            st.update(res)
            if not res.get("pass"):
                st["status"] = "fail"
    else:
        _skip(report, "walk_parity",
              "no --reference-frames dump supplied (record the gate's walk "
              "with the reference package; see utils/parity_gate.py)")

    # ---- 5. step-cache quality curve ---------------------------------
    with _Stage(report, "step_cache_curve") as st:
        from ..runtime.engine import Engine
        from .metrics import quality_vs_exact
        text = pipe._cond_uncond(
            "a watercolor painting of a fox in a forest", None, 1)
        noise = pipe.init_noise(1337, pipe._latent_shape(height, width))
        kw = dict(num_inference_steps=num_inference_steps,
                  guidance_scale=7.5, **text)
        exact = pipe.engine.denoise_frames(noise=noise, **kw)
        st["curve"] = {}
        variants = [(f"k{k}", dict(step_cache=k)) for k in step_cache_ks]
        # the fast preset's composite, and its non-uniform variant
        variants += [("fast_preset", dict(step_cache=3,
                                          guidance_interval=(0.1, 0.85))),
                     ("fast_ends", dict(step_cache=3,
                                        step_cache_policy="ends",
                                        guidance_interval=(0.1, 0.85)))]
        for label, ekw in variants:
            eng = Engine(pipe.models, device,
                         scheduler=pipe.engine.scheduler_name, **ekw)
            frames = eng.denoise_frames(noise=noise, **kw)
            st["curve"][label] = quality_vs_exact(
                frames, exact, lpips_weights=lpips_weights,
                lpips_device=device)
        # every config at one PSNR: the curve measured plumbing, not quality
        psnrs = [c["psnr_mean"] for c in st["curve"].values()]
        if len(psnrs) >= 2:
            st["psnr_spread_db"] = round(max(psnrs) - min(psnrs), 2)
            st["saturated"] = bool(st["psnr_spread_db"] < 3.0)

    # ---- 6. Real-ESRGAN upsample -------------------------------------
    if upsample_weights:
        with _Stage(report, "upsample") as st:
            from ..pipeline.upsampling import RealESRGANModel
            ups = RealESRGANModel.from_pretrained(upsample_weights, device)
            src = (smoke[None] if smoke is not None
                   else np.zeros((1, height, width, 3), np.float32))
            up = ups(np.asarray(src, np.float32))
            st["scale"] = int(up.shape[1] // src.shape[1])
            st["out_shape"] = list(up.shape)
            st["finite"] = bool(np.isfinite(up).all())
            if not st["finite"]:
                st["status"] = "fail"
            _save_png(out / "smoke_frame_x4.png", up[0])
    else:
        _skip(report, "upsample", "no --upsample-weights supplied "
              "(RealESRGAN_x4plus.pth; reader: models/weights.py "
              "load_realesrgan)")

    # ---- verdict ------------------------------------------------------
    statuses = [s.get("status") for s in report["stages"].values()]
    report["pass"] = "fail" not in statuses and "error" not in statuses
    report["summary"] = {k: v.get("status")
                         for k, v in report["stages"].items()}
    _write(report, out)
    return report


def _write(report: dict, out: Path) -> None:
    path = out / "validation_report.json"
    path.write_text(json.dumps(report, indent=2, default=str))
    logger.info("validation report -> %s", path)
