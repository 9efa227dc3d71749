"""The PyTorch package's LPIPS against the JAX package's (``utils/lpips.py``).

One set of random weights (numpy seed; the ``lin`` heads non-negative, as
trained heads are) goes to the JAX converter and to the port's state-dict
load; both nets must give the same distances at 64² within rtol 2e-4 and
atol 2e-5 (the JAX package's own test tolerance).  The three namings of the
heads and the lpips package's backbone names load alike, ``.npz`` and
``.pth`` alike.  A near-black uint8 pair (all 0s against all 1s) is read on
the 0-255 scale because of its dtype; the JAX function reads it as [0, 1].
"""

import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.utils.lpips import (
    LPIPS, convert_lpips_torch, load_lpips_weights, lpips_distance)

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-5)
CPU = torch.device("cpu")


def random_weights(net: str, seed: int = 0) -> dict:
    """torchvision ``features.N.*`` names and ``lin{j}.model.1.weight``
    heads, numpy fp32."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in LPIPS(net).state_dict().items():
        w = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if k.startswith("lin"):
            out[k.replace(".weight", ".model.1.weight")] = np.abs(w)
        else:
            out[k] = w * 0.05
    return out


def port_model(state: dict, net: str) -> LPIPS:
    m = LPIPS(net)
    m.load_state_dict({k: v.float() for k, v in
                       convert_lpips_torch(state, net).items()})
    return m.eval()


def pair(side: int = 64, n: int = 2, seed: int = 3):
    rng = np.random.default_rng(seed)
    a = rng.random((n, side, side, 3)).astype(np.float32)
    return a, np.clip(a + 0.1 * rng.standard_normal(a.shape), 0,
                      1).astype(np.float32)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(net):
    import jax.numpy as jnp

    from stable_diffusion_videos_tpu.utils import lpips as J
    state = random_weights(net)
    a, b = pair()
    params = J.convert_lpips_torch(state, net=net)
    want = np.asarray(J.LPIPS(net=net).apply(
        params, jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1)))
    model = port_model(state, net)
    with torch.no_grad():
        got = model(torch.from_numpy(a * 2 - 1).permute(0, 3, 1, 2),
                    torch.from_numpy(b * 2 - 1).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper's scaling, on [0, 1] floats and on uint8 frames
    np.testing.assert_allclose(lpips_distance(a, b, model),
                               J.lpips_distance(a, b, params, net=net), **TOL)
    a8, b8 = ((x * 255).round().astype(np.uint8) for x in (a, b))
    np.testing.assert_allclose(lpips_distance(a8, b8, model),
                               J.lpips_distance(a8, b8, params, net=net),
                               **TOL)
    assert want.min() > 0


def test_key_namings_load_alike():
    """torchvision + ``lin{j}.model.1.weight``, the lpips package's
    ``net.sliceK.N`` + ``lins.{j}.model.1.weight``, and ``lin{j}.weight``
    give one model."""
    state = random_weights("alex")
    a, b = pair(side=48)
    want = lpips_distance(a, b, port_model(state, "alex"))
    lpips_pkg, bare = {}, {}
    for k, v in state.items():
        if k.startswith("features."):
            lpips_pkg[f"net.slice1.{k.split('.', 1)[1]}"] = v
            bare[k] = v
        else:
            j = k[len("lin")]
            lpips_pkg[f"lins.{j}.model.1.weight"] = v
            bare[f"lin{j}.weight"] = v.reshape(-1)
    for variant in (lpips_pkg, bare):
        np.testing.assert_array_equal(
            lpips_distance(a, b, port_model(variant, "alex")), want)
    with pytest.raises(KeyError, match="lin4"):
        convert_lpips_torch({k: v for k, v in state.items()
                             if not k.startswith("lin4")}, "alex")
    with pytest.raises(ValueError, match="unknown LPIPS backbone"):
        LPIPS("squeeze")


def test_npz_and_pth_files_load_alike(tmp_path):
    state = random_weights("alex", seed=5)
    np.savez(tmp_path / "w.npz", **state)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               tmp_path / "w.pth")
    a, b = pair(side=48)
    got = [lpips_distance(a, b, load_lpips_weights(str(tmp_path / f),
                                                   device=CPU))
           for f in ("w.npz", "w.pth")]
    np.testing.assert_array_equal(got[0], got[1])
    model = load_lpips_weights(str(tmp_path / "w.npz"), device="cpu")
    assert not model.training and not any(p.requires_grad
                                           for p in model.parameters())


def test_distance_properties():
    model = port_model(random_weights("alex", seed=7), "alex")
    a, b = pair(side=48, n=3)
    same = lpips_distance(a, a, model)
    assert same.shape == (3,) and np.all(same == 0)
    d_ab, d_ba = lpips_distance(a, b, model), lpips_distance(b, a, model)
    np.testing.assert_allclose(d_ab, d_ba, rtol=1e-6)
    assert np.all(d_ab > 0)
    far = lpips_distance(a, 1 - a, model)
    assert np.all(far > d_ab)
    one = lpips_distance(a[0], b[0], model)  # (H, W, 3): a batch of one
    np.testing.assert_allclose(one, d_ab[:1], rtol=1e-5)
    got_t = lpips_distance(torch.from_numpy(a), torch.from_numpy(b), model)
    np.testing.assert_array_equal(got_t, d_ab)


def test_near_black_uint8_pair_differs_from_jax():
    """All 0s against all 1s, uint8: the port reads 0 against 1/255; the
    JAX function, seeing no value above 1.5, reads 0 against 1.0."""
    from stable_diffusion_videos_tpu.utils import lpips as J
    state = random_weights("alex", seed=9)
    model = port_model(state, "alex")
    params = J.convert_lpips_torch(state, net="alex")
    rng = np.random.default_rng(4)
    dark = rng.integers(0, 2, (1, 48, 48, 3)).astype(np.uint8)
    black = np.zeros_like(dark)
    got = lpips_distance(black, dark, model)
    want_true = lpips_distance(black.astype(np.float32),
                               dark.astype(np.float32) / 255, model)
    np.testing.assert_array_equal(got, want_true)
    jax_read = J.lpips_distance(black, dark, params, net="alex")
    np.testing.assert_allclose(
        jax_read, lpips_distance(black.astype(np.float32),
                                 dark.astype(np.float32), model), **TOL)
    assert jax_read[0] > 10 * got[0]
