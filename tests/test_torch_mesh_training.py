"""The port's trainers on a (data, model) mesh against the JAX package's on
its 2-device data mesh.

Two gloo processes on the CPU (``tests/torch_mesh_child.py``, scenario
``trainers``, spawned once by this module's fixture with a timeout) train
the tiny bundle (``test_torch_sampler_engines.tiny_bundles``, saved and
loaded) on a (data 2) mesh; the JAX trainers run on
``make_mesh(jax.devices()[:2])`` meanwhile.  Each JAX step draws t and the
noise (the LCM distiller its indices, the VAE trainer its posterior noise)
for the wrap-padded global batch from its key; the test re-derives them and
hands them to the port's ``train_step``.  Cases: a batch of 3 over data 2
(wrap-padded to 4), a clip norm far below the gradient's, LoRA (whose
uneven batch raises in both packages), the VAE trainer and the LCM
distiller on a padded batch; the ranks' weights bit-equal; a (data 1,
model 2) mesh and a one-rank mesh bit-equal to no mesh; a checkpoint
written by rank 0 and restored on both ranks.  Tolerances are
``tests/test_torch_training.py``'s: losses 1e-5 relative; weights after
three steps within a twentieth of lr a step (the LCM distiller's target a
quarter; its student and its later losses are held as wide as the JAX
distiller reads against itself on two meshes, see its test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.weights import from_jax_params
from stable_diffusion_videos_tpu_torch.parallel import (flat_buckets,
                                                        make_mesh, single,
                                                        wrap_pad)
from stable_diffusion_videos_tpu_torch.parallel.mesh import Mesh
from stable_diffusion_videos_tpu_torch.training import (
    LCMDistillConfig, LCMDistiller, LoRATrainer, TrainConfig, UNetTrainer,
    VAETrainer)
from stable_diffusion_videos_tpu_torch.training.trainer import denoising_loss

from test_torch_lcm_distill import jax_idx_and_noise
from test_torch_multihost import finish, free_port, spawn
from test_torch_sampler_engines import tiny_bundles
from test_torch_training import (CPU, LOSS_TOL, assert_adam_close,
                                 assert_unet_close, jax_t_and_noise,
                                 noise_level_grads, train_data)
from test_torch_vae_train import jax_noise
from torch_mesh_child import STEPS, UNET_CASES
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

LR = 1e-3
# the LCM losses after the first step (see its test)
LCM_LATER_LOSS_RTOL = 2e-4
PADDED = 4  # every case's global batch, padded over data 2


def jax_data_mesh():
    from stable_diffusion_videos_tpu.parallel.mesh import make_mesh as jmesh
    return jmesh(jax.devices()[:2])


def as_tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainers' results, both ranks' results, the draws and the
    noise-level parameter sets (``test_torch_training.noise_level_grads``)
    of each case."""
    from stable_diffusion_videos_tpu import training as J
    jm, pm = tiny_bundles()
    work = tmp_path_factory.mktemp("mesh_training")
    pm.save(work / "bundle")
    lat, ctx = train_data(b=PADDED, seed=3)
    images = np.random.default_rng(4).uniform(
        -1, 1, (3, 16, 16, 3)).astype(np.float32)
    uctx = np.random.default_rng(9).standard_normal((1, 7, 32),
                                                    dtype=np.float32)
    padded = (PADDED, 8, 8, 4)
    n_ts = LCMDistiller(pm, device=CPU)._ts.shape[0]
    inp = dict(lat=lat, ctx=ctx, images=images, uctx=uctx)
    for case, (_, _, k0) in UNET_CASES.items():
        for i in range(STEPS):
            inp[f"unet_{case}_t{i}"], inp[f"unet_{case}_noise{i}"] = \
                jax_t_and_noise(jax.random.PRNGKey(k0 + i), padded)
    for i in range(STEPS):
        inp[f"lora_t{i}"], inp[f"lora_noise{i}"] = jax_t_and_noise(
            jax.random.PRNGKey(70 + i), padded)
        inp[f"vae_noise{i}"] = jax_noise(jax.random.PRNGKey(80 + i),
                                         wrap_pad(images, 2))
        inp[f"lcm_idx{i}"], inp[f"lcm_noise{i}"] = jax_idx_and_noise(
            jax.random.PRNGKey(90 + i), padded, n_ts)
    mesh = jax_data_mesh()
    jlora = J.LoRATrainer(jm, rank=4, alpha=2.0, mesh=mesh, learning_rate=LR)
    inp.update({f"lora_init::{p}::{k}": np.array(ab[k])
                for p, ab in jlora.lora.items() for k in ("a", "b")})
    np.savez(work / "inputs.npz", **inp)
    procs = spawn("trainers", free_port(), (0, 1), work)

    want = {}
    for case, (cfg, b, k0) in UNET_CASES.items():
        jt = J.UNetTrainer(jm, mesh=mesh, config=J.TrainConfig(**cfg))
        want[f"unet_{case}_loss"] = [
            jt.step(lat[:b], ctx[:b], key=jax.random.PRNGKey(k0 + i))
            for i in range(STEPS)]
        want[f"unet_{case}"] = jt.export_params(ema=False)["unet"]
        if jt.ema_params is not None:
            want[f"unet_{case}_ema"] = jt.export_params()["unet"]
    want["lora_loss"] = [jlora.step(lat, ctx, key=jax.random.PRNGKey(70 + i))
                         for i in range(STEPS)]
    want["lora"] = {f"{p}::{k}": np.asarray(ab[k])
                    for p, ab in jlora.lora.items() for k in ("a", "b")}
    jvae = J.VAETrainer(jm, mesh=mesh, learning_rate=LR, kl_weight=0.1,
                        max_grad_norm=0.5)
    want["vae_loss"] = [jvae.step(images, key=jax.random.PRNGKey(80 + i))
                        for i in range(STEPS)]
    want["vae"] = jvae.export_params()
    jlcm = J.LCMDistiller(jm, mesh=mesh,
                          config=J.LCMDistillConfig(learning_rate=LR))
    want["lcm_loss"] = [jlcm.step(lat[:3], ctx[:3], uctx,
                                  key=jax.random.PRNGKey(90 + i))
                        for i in range(STEPS)]
    want["lcm_student"] = jlcm.export_params(ema=False)["unet"]
    want["lcm_target"] = jlcm.export_params()["unet"]

    # the parameters whose first gradient is rounding noise, read on one
    # rank over the padded batch
    noisy = {}
    for case, (cfg, b, _) in UNET_CASES.items():
        probe = UNetTrainer(pm, device=CPU, config=TrainConfig(**cfg))
        lat_p, ctx_p = as_tensors(wrap_pad(lat[:b], 2), wrap_pad(ctx[:b], 2))
        t0, n0 = as_tensors(inp[f"unet_{case}_t0"], inp[f"unet_{case}_noise0"])
        noisy[case] = noise_level_grads(probe.unet, denoising_loss(
            probe.unet, probe._acp, lat_p, ctx_p, t0.long(), n0,
            probe.config.objective, probe.config.snr_gamma))
    probe = VAETrainer(pm, learning_rate=LR, kl_weight=0.1, device=CPU)
    noisy["vae"] = noise_level_grads(probe.weights.master, probe.loss(
        *as_tensors(wrap_pad(images, 2), inp["vae_noise0"]))[0])
    probe = LCMDistiller(pm, config=LCMDistillConfig(learning_rate=LR),
                         device=CPU)
    x0, c, u = as_tensors(wrap_pad(lat[:3], 2), wrap_pad(ctx[:3], 2),
                          np.broadcast_to(uctx, (PADDED, 7, 32)).copy())
    idx, n0 = as_tensors(inp["lcm_idx0"], inp["lcm_noise0"])
    noisy["lcm"] = noise_level_grads(probe.student.master, probe.loss(
        x0, c, u, idx, n0), threshold=1e-12)

    finish(procs, timeout=240)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in (0, 1)]
    return want, ranks, pm, noisy


def state(rank: dict, prefix: str) -> dict:
    return {k[len(prefix) + 2:]: v for k, v in rank.items()
            if k.startswith(prefix + "::")}


class Held:
    """A stand-in module whose ``state_dict`` is one rank's saved arrays."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def state_dict(self):
        return {k: torch.from_numpy(v) for k, v in self.arrays.items()}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_trainer_matches_jax_on_a_data_mesh(runs, case):
    want, ranks, pm, noisy = runs
    cfg = UNET_CASES[case][0]
    bound = dict(lr=cfg["learning_rate"], steps=STEPS,
                 noise_level=noisy[case])
    for r in ranks:
        np.testing.assert_allclose(r[f"unet_{case}_loss"],
                                   want[f"unet_{case}_loss"], **LOSS_TOL)
        for kind in ("", "_ema"):
            if f"unet_{case}{kind}" in want:
                assert_unet_close(Held(state(r, f"unet_{case}{kind}")),
                                  want[f"unet_{case}{kind}"],
                                  pm.unet_config, **bound)
    if case == "clipped":
        assert "unet_clipped_ema" not in want


def test_lora_trainer_matches_jax_on_a_data_mesh(runs):
    want, ranks, _, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["lora_loss"], want["lora_loss"],
                                   **LOSS_TOL)
        got = state(r, "lora")
        assert got.keys() == want["lora"].keys()
        for k, w in want["lora"].items():
            assert_adam_close(got[k], w, LR, STEPS, k)


def test_vae_trainer_matches_jax_on_a_padded_batch(runs):
    want, ranks, pm, noisy = runs
    ref = from_jax_params(want["vae"], pm.vae_config)
    for r in ranks:
        np.testing.assert_allclose(r["vae_loss"], want["vae_loss"],
                                   **LOSS_TOL)
        got = state(r, "vae")
        assert got.keys() == ref.keys()
        for k, w in ref.items():
            assert_adam_close(got[k], w, LR, STEPS, k,
                              rounding_only=k in noisy["vae"])


def test_lcm_distiller_matches_jax_on_a_padded_batch(runs):
    """The first loss at 1e-5 and the EMA target (the network that is
    exported and sampled from) within a quarter of lr a step.  The first
    gradients sit near Adam's eps (``test_torch_lcm_distill.py``), so an
    element whose first gradient is within its sums' rounding of 0 takes a
    step of either sign: the JAX distiller on a 1-device mesh and on this
    2-device one reads students 1.1e-3 apart after 2 and 3 steps (1.1 lr),
    targets 1.6e-4 apart, and losses 2.7e-5 and 3.5e-5 apart at steps 2
    and 3.  So the student is held to lr a step (the most Adam's steps can
    move it) and the later losses to ``LCM_LATER_LOSS_RTOL``."""
    want, ranks, pm, noisy = runs
    for r in ranks:
        np.testing.assert_allclose(r["lcm_loss"][0], want["lcm_loss"][0],
                                   **LOSS_TOL)
        np.testing.assert_allclose(r["lcm_loss"][1:], want["lcm_loss"][1:],
                                   rtol=LCM_LATER_LOSS_RTOL)
        assert_unet_close(Held(state(r, "lcm_target")), want["lcm_target"],
                          pm.unet_config, lr=LR, steps=STEPS,
                          noise_level=noisy["lcm"], share=0.25)
        assert_unet_close(Held(state(r, "lcm_student")), want["lcm_student"],
                          pm.unet_config, lr=LR, steps=STEPS, share=1.0)


def test_ranks_hold_bit_equal_replicas(runs):
    _, (r0, r1), _, _ = runs
    assert r0.keys() == r1.keys()
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_model_axis_is_bit_equal_to_one_rank(runs):
    for r in runs[1]:
        assert bool(r["model2_equal"])


def test_checkpoint_round_trip_on_the_mesh(runs):
    for r in runs[1]:
        assert bool(r["ckpt_equal"])


def test_one_rank_mesh_is_bit_equal_to_no_mesh():
    _, pm = tiny_bundles()
    lat, ctx = train_data(b=3, seed=5)
    cfg = TrainConfig(learning_rate=LR, ema_decay=0.5, max_grad_norm=0.05)
    runs = [UNetTrainer(pm, mesh=m, config=cfg)
            for m in (single(CPU), make_mesh(devices=[CPU]))] + [
        UNetTrainer(pm, device=CPU, config=cfg)]
    losses = [[tr.step(lat, ctx) for _ in range(2)] for tr in runs]
    assert losses[0] == losses[1] == losses[2]
    for a, b, c in zip(*(list(tr.unet.parameters()) + tr.ema_params
                         for tr in runs)):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_lora_uneven_batch_raises_in_both_packages():
    """JAX's LoRA step places the batch on the mesh as it is: 3 rows do not
    split over 2 devices.  The port refuses before any collective (this
    mesh has no process group)."""
    from stable_diffusion_videos_tpu.training import LoRATrainer as JLoRA
    jm, pm = tiny_bundles()
    lat, ctx = train_data(b=3)
    with pytest.raises(ValueError):
        JLoRA(jm, rank=2, mesh=jax_data_mesh()).step(lat, ctx)
    port = LoRATrainer(pm, rank=2, mesh=Mesh(2, 1, 0, CPU, None, {}))
    with pytest.raises(ValueError, match="does not split"):
        port.step(lat, ctx)
    t, noise = jax_t_and_noise(jax.random.PRNGKey(0), lat.shape)
    with pytest.raises(ValueError, match="does not split"):
        port.train_step(lat, ctx, t, noise)
    assert port.step_count == 0


@pytest.mark.parametrize("b,dp", [(3, 2), (5, 4), (4, 2), (1, 3)])
def test_wrap_pad_takes_the_jax_trainers_rows(b, dp):
    x = np.arange(b * 2, dtype=np.float32).reshape(b, 2)
    want = np.asarray(jnp.asarray(x)[jnp.arange(-(-b // dp) * dp) % b])
    np.testing.assert_array_equal(wrap_pad(x, dp), want)
    np.testing.assert_array_equal(wrap_pad(torch.from_numpy(x), dp).numpy(),
                                  want)


@pytest.mark.parametrize("nbytes", [4, 24, 40, 1 << 20])
def test_flat_buckets_cover_the_tensors_in_order(nbytes):
    ts = [torch.arange(n, dtype=torch.float32) + 100 * i
          for i, n in enumerate((7, 1, 0, 13, 4))]
    buckets = list(flat_buckets(ts, nbytes))
    assert all(sum(p.numel() for p in b) * 4 <= max(nbytes, 4)
               for b in buckets)
    got = torch.cat([p for b in buckets for p in b])
    assert torch.equal(got, torch.cat(ts))
    # views: writing through a bucket's pieces writes the tensors
    for b in buckets:
        for p in b:
            p.mul_(2)
    assert torch.equal(torch.cat(ts), 2 * got)


def test_one_rank_reduction_and_device_checks():
    mesh = single(CPU)
    g = [torch.arange(5.0), torch.ones(3)]
    mesh.all_reduce_mean_(g)
    assert torch.equal(g[0], torch.arange(5.0)) and torch.equal(g[1],
                                                                torch.ones(3))
    _, pm = tiny_bundles()
    with pytest.raises(ValueError, match="device"):
        UNetTrainer(pm, mesh=mesh, device="meta")
    with pytest.raises(TypeError):
        VAETrainer(pm, mesh="data")
