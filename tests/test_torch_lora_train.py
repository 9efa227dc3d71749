"""The PyTorch package's LoRA trainer and its ``.npz`` file against the JAX
package's.

Both train rank-4 adapters on the same tiny bundle
(``test_torch_sampler_engines.tiny_bundles``), the port's adapters set to the
JAX trainer's initial draws; t and the noise are re-derived from each JAX
step key.  Then a file goes each way: the JAX trainer's ``.npz`` merged by
the port's ``apply_lora``, and the port's merged by the JAX package's.
Tolerances, fp32: losses 1e-5 relative; adapters after three AdamW steps
as ``test_torch_training.assert_adam_close`` says; UNet outputs of a merged
bundle 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.lora_file import (
    apply_lora, parse_lora_arg)
from stable_diffusion_videos_tpu_torch.training import (LoRATrainer,
                                                        init_lora_params,
                                                        merge_lora)
from stable_diffusion_videos_tpu_torch.training.lora import lora_targets

from test_torch_sampler_engines import tiny_bundles
from test_torch_training import (CPU, LOSS_TOL, assert_adam_close,
                                 jax_t_and_noise, one_device_mesh, train_data)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

OUT_TOL = dict(atol=1e-4, rtol=1e-4)
RANK, LR = 4, 1e-3


@pytest.fixture(scope="module")
def trained():
    """(bundles, JAX trainer, port trainer) after three steps of each on
    the same draws, the port's adapters started at the JAX trainer's."""
    from stable_diffusion_videos_tpu.training import LoRATrainer as JTrainer
    jm, pm = tiny_bundles()
    jt = JTrainer(jm, rank=RANK, alpha=2.0, mesh=one_device_mesh(),
                  learning_rate=LR)
    pt = LoRATrainer(pm, rank=RANK, alpha=2.0, learning_rate=LR, device=CPU)
    with torch.no_grad():
        for path, ab in pt.lora.items():
            for k, t in ab.items():
                t.copy_(torch.from_numpy(np.asarray(jt.lora[path][k])))
    lat, ctx = train_data()
    losses = []
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        losses.append((pt.train_step(lat, ctx,
                                     *jax_t_and_noise(key, lat.shape)),
                       jt.step(lat, ctx, key=key)))
    return (jm, pm), jt, pt, losses


def unet_out(models, jax_params=None):
    """The tiny UNet's output on fixed inputs: the port's (NCHW in, NHWC
    out) or, with ``jax_params``, the JAX package's."""
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 32), dtype=np.float32)
    t = np.array([10.0, 700.0], np.float32)
    if jax_params is not None:
        return np.asarray(models.unet().apply(jax_params, jnp.asarray(lat),
                                              jnp.asarray(t),
                                              jnp.asarray(ctx)))
    with torch.no_grad():
        out = models.unet(torch.from_numpy(lat).permute(0, 3, 1, 2),
                          torch.from_numpy(t), torch.from_numpy(ctx))
    return out.permute(0, 2, 3, 1).numpy()


def test_targets_are_the_jax_trainers(trained):
    (jm, pm), jt, _, _ = trained
    from stable_diffusion_videos_tpu.training import \
        init_lora_params as jax_init
    want = jax_init(jm.params["unet"], rank=RANK)
    got = init_lora_params(pm.unet, rank=RANK)
    assert got.keys() == want.keys() == lora_targets(pm.unet).keys()
    for path, ab in got.items():
        assert tuple(ab["a"].shape) == want[path]["a"].shape
        assert tuple(ab["b"].shape) == want[path]["b"].shape
        assert not ab["b"].any()
    a = torch.cat([ab["a"].flatten() for ab in got.values()])
    assert abs(a.std().item() * np.sqrt(RANK) - 1.0) < 0.05


def test_three_steps_match_jax(trained):
    _, jt, pt, losses = trained
    for got, want in losses:
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    for path, ab in pt.lora.items():
        for k in ("a", "b"):
            assert_adam_close(ab[k].detach().numpy(), jt.lora[path][k], LR,
                              3, f"{path}::{k}")


def test_base_stays_bit_unchanged(trained):
    (_, pm), _, pt, _ = trained
    fresh = tiny_bundles()[1]
    for (k, v), w in zip(pm.unet.state_dict().items(),
                         fresh.unet.state_dict().values()):
        assert torch.equal(v, w), k
    assert pt.base is pm.unet
    assert not any(p.requires_grad for p in pm.unet.parameters())


def test_jax_trained_file_merges_in_the_port(trained, tmp_path):
    (jm, pm), jt, _, _ = trained
    from stable_diffusion_videos_tpu.training import merge_lora as jax_merge
    jt.save_lora(tmp_path / "jax_lora.npz")
    merged = apply_lora(pm, tmp_path / "jax_lora.npz", scale=0.5)
    want = unet_out(jm, jax_merge(jm.params["unet"], jt.lora,
                                  0.5 * jt.scale))
    np.testing.assert_allclose(unet_out(merged), want, **OUT_TOL)
    assert not np.allclose(unet_out(pm), want, **OUT_TOL)


def test_port_trained_file_merges_in_jax(trained, tmp_path):
    (jm, pm), _, pt, _ = trained
    from stable_diffusion_videos_tpu.models.lora_file import \
        apply_lora as jax_apply
    pt.save_lora(tmp_path / "port_lora.npz")
    z = np.load(tmp_path / "port_lora.npz")
    assert (int(z["__rank__"]), float(z["__alpha__"])) == (RANK, 2.0)
    want = unet_out(jm, jax_apply(jm, tmp_path / "port_lora.npz").params[
        "unet"])
    np.testing.assert_allclose(unet_out(pt.export_params()), want, **OUT_TOL)
    np.testing.assert_allclose(
        unet_out(apply_lora(pm, tmp_path / "port_lora.npz")), want,
        **OUT_TOL)


def test_load_and_merge_round_trip(trained, tmp_path):
    (_, pm), _, pt, _ = trained
    pt.save_lora(tmp_path / "x.npz")
    lora, rank, alpha = LoRATrainer.load_lora(tmp_path / "x")  # no suffix
    assert (rank, alpha) == (RANK, 2.0) and lora.keys() == pt.lora.keys()
    unet = merge_lora(pm.unet, lora, alpha / rank)
    touched = {f"{n}.weight" for n in lora_targets(pm.unet).values()}
    for (k, v), w in zip(unet.state_dict().items(),
                         pm.unet.state_dict().values()):
        assert (v is w or v.data_ptr() == w.data_ptr()) == (k not in touched)
    assert parse_lora_arg(str(tmp_path / "x.npz") + ":0.5") == (
        str(tmp_path / "x.npz"), 0.5)
