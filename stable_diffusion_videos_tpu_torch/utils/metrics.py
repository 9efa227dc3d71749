"""Frame-quality metrics: PSNR and SSIM (numpy), LPIPS (``utils/lpips.py``).

Counterpart of ``stable_diffusion_videos_tpu/utils/metrics.py``, the same
functions on the same arrays.  ``compare_frame_dirs`` scores two directories
of frames by file name; ``quality_vs_exact`` gates an approximate program's
frames against the exact program's on the same seeds; ``temporal_flicker``
reads the consecutive-frame differences of a clip.  LPIPS enters only when
weights are given (argument or ``SDV_LPIPS_WEIGHTS``); it runs on
``lpips_device``, the card unless the caller asks for the CPU.

One difference from the JAX package: an integer frame is on the 0-255
scale because of its dtype, so ``temporal_flicker`` (and LPIPS) divide
integer input by 255 whatever its values.  The JAX functions decide from
the values (``a.max() > 1.5``), which reads a near-black uint8 frame (every
value at most 1) as already in [0, 1].  Float input keeps that rule,
applied once to the whole stack.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0,
         win: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean structural similarity: a uniform ``win`` window, averaged over
    the channels, the border of ``win // 2`` cut."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mx = uniform_filter(x, win)
        my = uniform_filter(y, win)
        vx = uniform_filter(x * x, win) - mx * mx
        vy = uniform_filter(y * y, win) - my * my
        cxy = uniform_filter(x * y, win) - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
            (mx ** 2 + my ** 2 + c1) * (vx + vy + c2))
        pad = win // 2
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def _lpips_model(lpips_weights, lpips_net: str, lpips_device):
    """The LPIPS module of ``lpips_weights`` (else ``SDV_LPIPS_WEIGHTS``) on
    ``lpips_device``, or None when neither names a file (nothing of torch is
    imported then)."""
    lpips_weights = lpips_weights or os.environ.get("SDV_LPIPS_WEIGHTS")
    if not lpips_weights:
        return None
    from .lpips import load_lpips_weights
    return load_lpips_weights(lpips_weights, net=lpips_net,
                              device=lpips_device)


def compare_frame_dirs(dir_a, dir_b, glob: str = "**/frame*.png",
                       lpips_weights: str | None = None,
                       lpips_net: str = "alex",
                       lpips_device="cuda") -> dict:
    """Frames matched by file name -> each metric's mean and min (LPIPS's
    mean and max), the worst frame by SSIM, and up to 5 names missing on
    each side."""
    from PIL import Image
    model = _lpips_model(lpips_weights, lpips_net, lpips_device)
    a_frames = {p.name: p for p in Path(dir_a).glob(glob)}
    b_frames = {p.name: p for p in Path(dir_b).glob(glob)}
    common = sorted(a_frames.keys() & b_frames.keys())
    if not common:
        raise ValueError("no common frame filenames between the two dirs")
    psnrs, ssims, lpipss = [], [], []
    for name in common:
        ia = np.asarray(Image.open(a_frames[name]).convert("RGB"))
        ib = np.asarray(Image.open(b_frames[name]).convert("RGB"))
        if ia.shape != ib.shape:
            raise ValueError(f"{name}: shape {ia.shape} vs {ib.shape}")
        psnrs.append(psnr(ia, ib))
        ssims.append(ssim(ia, ib))
        if model is not None:
            from .lpips import lpips_distance
            lpipss.append(float(lpips_distance(ia, ib, model)[0]))
    worst = int(np.argmin(ssims))
    out = {
        "frames": len(common),
        "psnr_mean": round(float(np.mean(psnrs)), 3),
        "psnr_min": round(float(np.min(psnrs)), 3),
        "ssim_mean": round(float(np.mean(ssims)), 5),
        "ssim_min": round(float(np.min(ssims)), 5),
        "worst_frame": common[worst],
        "missing_in_a": sorted(b_frames.keys() - a_frames.keys())[:5],
        "missing_in_b": sorted(a_frames.keys() - b_frames.keys())[:5],
    }
    if lpipss:
        out["lpips_mean"] = round(float(np.mean(lpipss)), 5)
        out["lpips_max"] = round(float(np.max(lpipss)), 5)
        out["lpips_net"] = lpips_net
    return out


def quality_vs_exact(frames: np.ndarray, exact: np.ndarray,
                     lpips_weights: str | None = None,
                     lpips_net: str = "alex", lpips_device="cuda") -> dict:
    """The quality gate of an approximation: per-frame SSIM and PSNR and
    the relative error of ``frames`` against the ``exact`` batch (float
    [0, 1], (B, H, W, 3)), and LPIPS when weights are given."""
    frames = np.asarray(frames, np.float32)
    exact = np.asarray(exact, np.float32)
    rel = float(np.linalg.norm(frames - exact)
                / max(np.linalg.norm(exact), 1e-12))
    ssims = [ssim(frames[i], exact[i], data_range=1.0)
             for i in range(frames.shape[0])]
    psnrs = [psnr(frames[i], exact[i], data_range=1.0)
             for i in range(frames.shape[0])]
    out = {
        "rel_err": round(rel, 5),
        "ssim_mean": round(float(np.mean(ssims)), 5),
        "ssim_min": round(float(np.min(ssims)), 5),
        "psnr_mean": round(float(np.mean(psnrs)), 2),
        "psnr_min": round(float(np.min(psnrs)), 2),
    }
    model = _lpips_model(lpips_weights, lpips_net, lpips_device)
    if model is not None:
        from .lpips import lpips_distance
        d = lpips_distance(frames, exact, model)
        out["lpips_mean"] = round(float(np.mean(d)), 5)
        out["lpips_max"] = round(float(np.max(d)), 5)
        out["lpips_net"] = lpips_net
    return out


def psnr_spread_by_reference(configs: dict) -> dict:
    """The saturation check of a table of ``quality_vs_exact`` entries:
    max - min ``psnr_mean`` within each group of entries that share a
    reference, named by the entry's ``_vs_<ref>`` suffix ("exact" without
    one); PSNRs against different references are not comparable.  ->
    ``{"spreads_db": {ref: dB}, "psnr_spread_db": the largest,
    "saturated": every group of 2 or more under 3 dB}``."""
    groups: dict[str, list[float]] = {}
    for name, g in configs.items():
        if "psnr_mean" not in g:
            continue
        ref = name.rsplit("_vs_", 1)[1] if "_vs_" in name else "exact"
        groups.setdefault(ref, []).append(float(g["psnr_mean"]))
    spreads = {ref: round(max(ps) - min(ps), 2)
               for ref, ps in groups.items() if len(ps) >= 2}
    return {
        "spreads_db": spreads,
        "psnr_spread_db": max(spreads.values()) if spreads else 0.0,
        "saturated": bool(spreads) and all(s < 3.0
                                           for s in spreads.values()),
    }


def unit_scale(frames) -> np.ndarray:
    """Frames (an array or a list of arrays or PIL images) -> one float32
    stack in [0, 1]: integer input divided by 255, float input divided by
    255 when its largest value passes 1.5."""
    stack = np.stack([np.asarray(f) for f in frames])
    integer = np.issubdtype(stack.dtype, np.integer)
    stack = stack.astype(np.float32)
    if integer or stack.max() > 1.5:
        stack = stack / 255.0
    return stack


def temporal_flicker(frames, data_range: float = 1.0,
                     lpips_weights: str | None = None,
                     lpips_net: str = "alex", lpips_device="cuda") -> dict:
    """Consecutive-frame statistics of a clip ((T, H, W, 3), or a list of
    arrays or PIL images): ``flicker_ssim``, the mean of 1 - SSIM between
    neighbours (0 on a steady clip), its max, ``flicker_mad``, the mean
    absolute difference in [0, 1] units, and with LPIPS weights the mean
    and max neighbour LPIPS.  On a static input video any nonzero value is
    the pipeline's flicker."""
    frames = unit_scale(frames)
    if frames.shape[0] < 2:
        raise ValueError("temporal_flicker needs >= 2 frames")
    d_ssim = [1.0 - ssim(frames[i], frames[i + 1], data_range=data_range)
              for i in range(frames.shape[0] - 1)]
    mad = [float(np.mean(np.abs(frames[i + 1] - frames[i])))
           for i in range(frames.shape[0] - 1)]
    out = {
        "flicker_ssim": round(float(np.mean(d_ssim)), 6),
        "flicker_ssim_max": round(float(np.max(d_ssim)), 6),
        "flicker_mad": round(float(np.mean(mad)), 6),
        "n_frames": int(frames.shape[0]),
    }
    model = _lpips_model(lpips_weights, lpips_net, lpips_device)
    if model is not None:
        from .lpips import lpips_distance
        d = lpips_distance(frames[:-1], frames[1:], model)
        out["flicker_lpips_mean"] = round(float(np.mean(d)), 5)
        out["flicker_lpips_max"] = round(float(np.max(d)), 5)
    return out
