"""Synthetic structured image set for training quality-gate weights.

Counterpart of ``stable_diffusion_videos_tpu/training/structured_data.py``,
copied so that the PyTorch package stands alone: the same eight
procedurally generated patterns (periodic, low-frequency, radial, diagonal;
distinct colours), each with its text prompt, equal array for array.  The
committed checkpoints (``tests/goldens/structured_bundle``,
``structured_lcm_bundle``) were trained on this set.

Deterministic: no RNG anywhere, so a checkpoint's provenance is exactly
reproducible from this file.
"""

from __future__ import annotations

import numpy as np

#: (prompt, pattern function) pairs; each function returns float32 (H, W,
#: 3) in [-1, 1]
_PATTERNS = None


def _build_patterns():
    def norm(img):
        return (img * 2.0 - 1.0).astype(np.float32)

    def checker(h, w, cell, c0, c1):
        yy, xx = np.mgrid[0:h, 0:w]
        m = ((yy // cell + xx // cell) % 2).astype(np.float32)[..., None]
        return norm(m * np.asarray(c1) + (1 - m) * np.asarray(c0))

    def gradient(h, w, axis, c0, c1):
        t = np.linspace(0.0, 1.0, h if axis == 0 else w, dtype=np.float32)
        t = t[:, None, None] if axis == 0 else t[None, :, None]
        t = np.broadcast_to(t, (h, w, 1))
        return norm(t * np.asarray(c1) + (1 - t) * np.asarray(c0))

    def circle(h, w, c_in, c_out):
        yy, xx = np.mgrid[0:h, 0:w]
        r = np.sqrt((yy - h / 2 + 0.5) ** 2 + (xx - w / 2 + 0.5) ** 2)
        m = (r <= h * 0.3).astype(np.float32)[..., None]
        return norm(m * np.asarray(c_in) + (1 - m) * np.asarray(c_out))

    def stripes(h, w, period, diag, c0, c1):
        yy, xx = np.mgrid[0:h, 0:w]
        phase = (yy + xx) if diag else xx
        m = ((phase // period) % 2).astype(np.float32)[..., None]
        return norm(m * np.asarray(c1) + (1 - m) * np.asarray(c0))

    def border(h, w, t, c_in, c_edge):
        img = np.ones((h, w, 3), np.float32) * np.asarray(c_in)
        img[:t], img[-t:], img[:, :t], img[:, -t:] = [np.asarray(c_edge)] * 4
        return norm(img)

    R, G, B = (1, 0.2, 0.2), (0.2, 1, 0.2), (0.2, 0.2, 1)
    Y, K, W = (1, 1, 0.2), (0.05, 0.05, 0.05), (0.95, 0.95, 0.95)
    return [
        ("a red and black checkerboard",
         lambda h, w: checker(h, w, max(h // 8, 1), K, R)),
        ("a coarse blue and white checkerboard",
         lambda h, w: checker(h, w, max(h // 4, 1), W, B)),
        ("a horizontal green gradient",
         lambda h, w: gradient(h, w, 1, K, G)),
        ("a vertical yellow gradient",
         lambda h, w: gradient(h, w, 0, K, Y)),
        ("a blue circle on white",
         lambda h, w: circle(h, w, B, W)),
        ("vertical red stripes",
         lambda h, w: stripes(h, w, max(h // 8, 1), False, K, R)),
        ("diagonal green stripes",
         lambda h, w: stripes(h, w, max(h // 8, 1), True, K, G)),
        ("a yellow square with a blue border",
         lambda h, w: border(h, w, max(h // 8, 1), Y, B)),
    ]


def identify_patterns(samples: np.ndarray, images: np.ndarray) -> np.ndarray:
    """For each sample, the index of the dataset image it correlates best
    with (zero-mean cosine over pixels): the project's quality gate for
    trained and distilled checkpoints, a generator "knows" a pattern when
    its sample identifies as that pattern."""
    s = samples.reshape(len(samples), -1)
    t = images.reshape(len(images), -1)
    s = s - s.mean(1, keepdims=True)
    t = t - t.mean(1, keepdims=True)
    corr = (s @ t.T) / (np.linalg.norm(s, axis=1)[:, None]
                        * np.linalg.norm(t, axis=1)[None] + 1e-9)
    return corr.argmax(1)


def make_structured_dataset(size: int = 32):
    """-> (images float32 (8, size, size, 3) in [-1, 1], prompts list[str])."""
    global _PATTERNS
    if _PATTERNS is None:
        _PATTERNS = _build_patterns()
    prompts = [p for p, _ in _PATTERNS]
    images = np.stack([f(size, size) for _, f in _PATTERNS])
    return images, prompts
