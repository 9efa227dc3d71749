"""The PyTorch package's frame metrics against the JAX package's
(``utils/metrics.py``), on the same numpy arrays.

PSNR and SSIM agree to 1e-12; the functions that return rounded dicts
(``compare_frame_dirs`` on PNGs written here, ``quality_vs_exact``,
``psnr_spread_by_reference``, ``temporal_flicker``) agree key for key, the
LPIPS entries (random AlexNet weights from a numpy seed, written as
``.npz``) within 2e-5.  One case differs on purpose: integer frames are on
the 0-255 scale because of their dtype, so a near-black uint8 clip (every
value at most 1) reads its true flicker of 1/255 in the port, where the JAX
function, deciding from the values, reads 0.992157.
"""

import numpy as np
import pytest
from PIL import Image

from stable_diffusion_videos_tpu_torch.utils import metrics as P
from stable_diffusion_videos_tpu_torch.utils.lpips import LPIPS

from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def frames():
    """Two float [0, 1] batches of 4 frames at 32², the second a noisy
    copy of the first."""
    rng = np.random.default_rng(0)
    a = rng.random((4, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1)
    return a, b.astype(np.float32)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """Random AlexNet LPIPS weights (non-negative heads), as ``.npz``."""
    rng = np.random.default_rng(1)
    sd = {k: (np.abs(rng.standard_normal(tuple(v.shape))) if "lin" in k
              else 0.05 * rng.standard_normal(tuple(v.shape)))
          .astype(np.float32) for k, v in LPIPS("alex").state_dict().items()}
    path = tmp_path_factory.mktemp("lpips") / "alex.npz"
    np.savez(path, **sd)
    return str(path)


@pytest.mark.parametrize("shape,data_range", [
    ((32, 32, 3), 1.0), ((24, 40, 3), 255.0), ((32, 32), 1.0)],
    ids=["rgb", "rgb_255", "gray"])
def test_psnr_and_ssim_match_jax(shape, data_range):
    from stable_diffusion_videos_tpu.utils import metrics as J
    rng = np.random.default_rng(2)
    a = rng.random(shape) * data_range
    b = np.clip(a + 0.03 * data_range * rng.standard_normal(shape), 0,
                data_range)
    for fn in ("psnr", "ssim"):
        want = getattr(J, fn)(a, b, data_range=data_range)
        got = getattr(P, fn)(a, b, data_range=data_range)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), fn
    assert P.psnr(a, a) == float("inf")
    assert P.ssim(a, a, data_range=data_range) == pytest.approx(1.0)


def write_frames(root, batch: np.ndarray, names):
    root.mkdir(parents=True)
    for name, f in zip(names, batch):
        Image.fromarray((f * 255).round().astype(np.uint8)).save(root / name)


@pytest.mark.parametrize("with_lpips", [False, True],
                         ids=["no_lpips", "lpips"])
def test_compare_frame_dirs_matches_jax(tmp_path, frames, lpips_npz,
                                        with_lpips):
    from stable_diffusion_videos_tpu.utils import metrics as J
    a, b = frames
    names = [f"frame{i:06d}.png" for i in range(4)]
    write_frames(tmp_path / "a" / "clip", a, names)
    write_frames(tmp_path / "b", b[:3], names[:3])
    kw = dict(lpips_weights=lpips_npz if with_lpips else None)
    want = J.compare_frame_dirs(tmp_path / "a", tmp_path / "b", **kw)
    got = P.compare_frame_dirs(tmp_path / "a", tmp_path / "b",
                               lpips_device="cpu", **kw)
    assert got.keys() == want.keys()
    assert ("lpips_mean" in got) == with_lpips
    assert got["missing_in_b"] == ["frame000003.png"]
    for k in got:
        if k.startswith("lpips_") and k != "lpips_net":
            assert got[k] == pytest.approx(want[k], abs=2e-5), k
        else:
            assert got[k] == want[k], k
    with pytest.raises(ValueError, match="no common"):
        P.compare_frame_dirs(tmp_path / "a", tmp_path / "a", glob="*.jpg")


def test_quality_vs_exact_and_spread_match_jax(frames, lpips_npz,
                                               monkeypatch):
    from stable_diffusion_videos_tpu.utils import metrics as J
    a, b = frames
    want = J.quality_vs_exact(b, a)
    got = P.quality_vs_exact(b, a, lpips_device="cpu")
    assert got == want
    # weights from the environment, as in the JAX package
    monkeypatch.setenv("SDV_LPIPS_WEIGHTS", lpips_npz)
    want_l = J.quality_vs_exact(b, a)
    got_l = P.quality_vs_exact(b, a, lpips_device="cpu")
    assert got_l.keys() == want_l.keys() and "lpips_mean" in got_l
    for k in ("lpips_mean", "lpips_max"):
        assert got_l[k] == pytest.approx(want_l[k], abs=2e-5)
    table = {"k2": got, "k3": dict(got, psnr_mean=got["psnr_mean"] - 5),
             "k2_vs_k3": dict(got, psnr_mean=40.0),
             "k4_vs_k3": dict(got, psnr_mean=41.5), "bare": {}}
    assert P.psnr_spread_by_reference(table) == \
        J.psnr_spread_by_reference(table)
    assert P.psnr_spread_by_reference({}) == J.psnr_spread_by_reference({})


@pytest.mark.parametrize("kind", ["float", "uint8", "list_of_pil"])
def test_temporal_flicker_matches_jax(frames, lpips_npz, kind):
    from stable_diffusion_videos_tpu.utils import metrics as J
    clip = np.concatenate(frames)[:5]
    if kind != "float":
        clip = (clip * 255).round().astype(np.uint8)
    if kind == "list_of_pil":
        clip = [Image.fromarray(f) for f in clip]
    want = J.temporal_flicker(clip, lpips_weights=lpips_npz)
    got = P.temporal_flicker(clip, lpips_weights=lpips_npz,
                             lpips_device="cpu")
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=2e-5 if "lpips" in k
                                       else 0), k
    with pytest.raises(ValueError, match=">= 2 frames"):
        P.temporal_flicker(clip[:1])


def test_near_black_uint8_flicker_differs_from_jax():
    """All 1s then all 2s (uint8): the frames differ by 1/255.  The JAX
    function reads the first frame, whose largest value is 1, as already in
    [0, 1], and the second as 0-255: 0.992157."""
    from stable_diffusion_videos_tpu.utils import metrics as J
    clip = np.stack([np.full((16, 16, 3), v, np.uint8) for v in (1, 2)])
    got = P.temporal_flicker(clip)
    assert got["flicker_mad"] == round(1 / 255, 6) == 0.003922
    assert J.temporal_flicker(clip)["flicker_mad"] == 0.992157
    # float input keeps the JAX rule, taken over the whole stack at once
    as_float = clip.astype(np.float32)
    assert P.temporal_flicker(as_float)["flicker_mad"] == 0.003922
    assert P.unit_scale(as_float / 255).max() == pytest.approx(2 / 255)
