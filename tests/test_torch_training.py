"""The PyTorch package's UNet trainer against the JAX package's.

Both packages train the same tiny bundle (the JAX tree's numpy draws carried
into the port by ``from_jax_params``, ``test_torch_sampler_engines.
tiny_bundles``); the JAX trainer runs on a one-device mesh, so no batch
padding enters.  JAX's ``UNetTrainer.step(key)`` draws t and the noise from
``jax.random.split(key)``; the test re-derives them and feeds the port's
``train_step``.  Tolerances, fp32: the loss 1e-5 relative; gradients atol
1e-5, rtol 1e-4 (sums over the batch and pixels in another order); weights
after three AdamW steps within a twentieth of lr a step
(``assert_adam_close``).  The optimizer
chains are held against optax on identical gradients at 1e-6.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.weights import from_jax_params
from stable_diffusion_videos_tpu_torch.training import (TrainConfig,
                                                        UNetTrainer)
from stable_diffusion_videos_tpu_torch.training.trainer import (
    clip_by_global_norm_, denoising_loss, linear_warmup)

from test_torch_sampler_engines import tiny_bundles
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


def one_device_mesh():
    from stable_diffusion_videos_tpu.parallel.mesh import make_mesh
    return make_mesh(jax.devices()[:1])


def train_data(b=2, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 8, 8, 4), dtype=np.float32) * 0.5
    ctx = rng.standard_normal((b, 7, 32), dtype=np.float32)
    return lat, ctx


def jax_t_and_noise(key, shape, num_train_timesteps=1000):
    """The JAX trainer's draws from its step key."""
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (shape[0],), 0, num_train_timesteps)
    return (np.array(t), np.array(jax.random.normal(kn, shape,
                                                    jnp.float32)))


def assert_adam_close(got, want, lr: float, steps: int, name: str,
                      rounding_only: bool = False, share: float = 0.05):
    """Weights after ``steps`` Adam steps at ``lr``, the port's against the
    JAX package's: every element within ``share`` (a twentieth) of ``lr
    · steps``, the most Adam's steps can move it (a step of the wrong
    sign would be off by up to twice that). Adam divides each gradient
    component by its own running scale, so where a component is near 0
    the 1e-4 relative difference of two orders of summation becomes a
    visible share of a step, which a tolerance relative to the weight
    would read as a fault. A tensor whose whole gradient is rounding
    noise (``noise_level_grads``) moves by rounding alone, up to lr a
    step, and is held to that."""
    got = np.asarray(got, np.float32).reshape(np.shape(want))
    diff = np.abs(got - np.asarray(want, np.float32)).max()
    bound = lr * steps * (1.0 if rounding_only else share)
    assert diff <= bound, (name, float(diff), bound)


def assert_unet_close(port_unet, jax_tree, config, lr, steps,
                      noise_level=(), share: float = 0.05):
    """The port's weights against the JAX tree's (``assert_adam_close``)."""
    want = from_jax_params(jax_tree, config)
    got = port_unet.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert_adam_close(got[k].float().numpy(), w, lr, steps, k,
                          rounding_only=k in noise_level, share=share)


def noise_level_grads(module, loss, threshold: float = 1e-7) -> set:
    """The parameters whose gradient is rounding noise (below
    ``threshold``; the denoising loss's largest are near 0.1): in the tiny
    UNet a bias, or a time projection, that feeds a GroupNorm of one channel
    a group, which removes it, so its true gradient is 0.  Adam divides a
    gradient by its own scale, so such a weight moves by up to lr a step in
    a direction set by the rounding, in either package: the two are held to
    that bound alone."""
    loss.backward()
    return {n for n, p in module.named_parameters()
            if p.grad.abs().max().item() < threshold}


def jax_loss_fn(jm, objective, snr_gamma):
    """The JAX trainer's ``loss_fn`` (``training/trainer.py``), as its
    step differentiates it."""
    from stable_diffusion_videos_tpu.core.schedulers.base import \
        alphas_cumprod_for
    unet = jm.unet()
    acp = jnp.asarray(alphas_cumprod_for(jm.scheduler_config), jnp.float32)

    def loss_fn(params, latents, context, t, noise):
        a = acp[t][:, None, None, None]
        noisy = jnp.sqrt(a) * latents + jnp.sqrt(1.0 - a) * noise
        pred = unet.apply(params, noisy, t.astype(jnp.float32), context)
        target = (jnp.sqrt(a) * noise - jnp.sqrt(1.0 - a) * latents
                  if objective == "v_prediction" else noise)
        err = (pred.astype(jnp.float32) - target) ** 2
        if snr_gamma > 0.0:
            snr = a[:, 0, 0, 0] / (1.0 - a[:, 0, 0, 0])
            w = (jnp.minimum(snr, snr_gamma) / (snr + 1.0)
                 if objective == "v_prediction"
                 else jnp.minimum(snr, snr_gamma) / snr)
            return jnp.mean(w[:, None, None, None] * err)
        return jnp.mean(err)
    return loss_fn


@pytest.mark.parametrize("objective,snr_gamma", [("epsilon", 0.0),
                                                 ("v_prediction", 5.0)])
def test_loss_and_gradients_match_jax(bundles, objective, snr_gamma):
    jm, pm = bundles
    lat, ctx = train_data()
    t, noise = jax_t_and_noise(jax.random.PRNGKey(3), lat.shape)
    loss, grads = jax.value_and_grad(jax_loss_fn(jm, objective, snr_gamma))(
        jm.params["unet"], *map(jnp.asarray, (lat, ctx, t, noise)))
    trainer = UNetTrainer(pm, device=CPU, config=TrainConfig(
        objective=objective, snr_gamma=snr_gamma))
    unet = trainer.unet
    got = denoising_loss(unet, trainer._acp, torch.from_numpy(lat),
                         torch.from_numpy(ctx), torch.from_numpy(t).long(),
                         torch.from_numpy(noise), objective, snr_gamma)
    np.testing.assert_allclose(got.item(), float(loss), **LOSS_TOL)
    got.backward()
    want = from_jax_params(grads, pm.unet_config)
    for name, p in unet.named_parameters():
        np.testing.assert_allclose(
            p.grad.reshape(want[name].shape).numpy(), np.asarray(want[name]),
            **GRAD_TOL, err_msg=name)


CASES = {
    "eps_snr_ema_warmup": dict(learning_rate=1e-3, snr_gamma=5.0,
                               ema_decay=0.9, warmup_steps=2),
    # a clip norm far below the gradient's, so every step clips
    "v_remat_clipped": dict(learning_rate=1e-3, objective="v_prediction",
                            remat=True, weight_decay=0.1,
                            max_grad_norm=0.05),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax_trainer(bundles, case):
    from stable_diffusion_videos_tpu.training import TrainConfig as JConfig
    from stable_diffusion_videos_tpu.training import UNetTrainer as JTrainer
    jm, pm = bundles
    lat, ctx = train_data()
    cfg = TrainConfig(**CASES[case])
    jt = JTrainer(jm, mesh=one_device_mesh(), config=JConfig(**CASES[case]))
    pt = UNetTrainer(pm, device=CPU, config=cfg)
    probe = UNetTrainer(pm, device=CPU, config=cfg)
    t, noise = jax_t_and_noise(jax.random.PRNGKey(10), lat.shape)
    noisy = noise_level_grads(probe.unet, denoising_loss(
        probe.unet, probe._acp, torch.from_numpy(lat), torch.from_numpy(ctx),
        torch.from_numpy(t).long(), torch.from_numpy(noise), cfg.objective,
        cfg.snr_gamma))
    bound = dict(lr=cfg.learning_rate, steps=3, noise_level=noisy)
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        want = jt.step(lat, ctx, key=key)
        got = pt.train_step(lat, ctx, *jax_t_and_noise(key, lat.shape))
        np.testing.assert_allclose(got, want, **LOSS_TOL,
                                   err_msg=f"loss of step {i}")
    assert_unet_close(pt.export_params(ema=False).unet,
                      jt.export_params(ema=False)["unet"], pm.unet_config,
                      **bound)
    if pt.ema_params is not None:
        assert_unet_close(pt.export_params().unet, jt.export_params()["unet"],
                          pm.unet_config, **bound)


def test_checkpoint_round_trip_resumes_exactly(bundles, tmp_path):
    _, pm = bundles
    lat, ctx = train_data(seed=1)
    cfg = TrainConfig(learning_rate=1e-3, ema_decay=0.5, warmup_steps=3)
    run = UNetTrainer(pm, device=CPU, config=cfg)
    for _ in range(2):
        run.step(lat, ctx)
    run.save_checkpoint(tmp_path / "ckpt.pt")
    run.step(lat, ctx)
    resumed = UNetTrainer(pm, device=CPU, config=cfg).restore_checkpoint(
        tmp_path / "ckpt.pt")
    assert resumed.step_count == 2
    resumed.step(lat, ctx)
    for a, b in zip(run.unet.parameters(), resumed.unet.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(run.ema_params, resumed.ema_params):
        assert torch.equal(a, b)
    for a, b in zip(run.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_bf16_bundle_trains_fp32_masters_through_a_working_copy(bundles):
    _, pm = bundles
    bf16 = dataclasses.replace(
        pm, unet=UNetTrainer(pm, device=CPU).weights.export().to(
            torch.bfloat16))
    before = {k: v.clone() for k, v in bf16.unet.state_dict().items()}
    trainer = UNetTrainer(bf16, device=CPU,
                          config=TrainConfig(learning_rate=1e-3))
    work, master = trainer.weights.work, trainer.weights.master
    assert next(work.parameters()).dtype == torch.bfloat16
    assert next(master.parameters()).dtype == torch.float32
    lat, ctx = train_data()
    assert np.isfinite(trainer.step(lat, ctx))
    for w, m in zip(work.parameters(), master.parameters()):
        assert torch.equal(w, m.to(torch.bfloat16)) and w.grad is None
    moved = sum(not torch.equal(m.to(torch.bfloat16), before[k])
                for k, m in master.state_dict().items())
    assert moved > 0
    out = trainer.export_params()
    assert out.unet.dtype == torch.bfloat16 and out.vae is bf16.vae
    for k, v in bf16.unet.state_dict().items():
        assert torch.equal(v, before[k])


def test_finetune_encodes_embeds_and_steps(bundles):
    _, pm = bundles
    imgs = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    losses = UNetTrainer(pm, device=CPU).finetune(imgs, ["a", "b"],
                                                   num_steps=2, log_every=0)
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_unknown_objective_is_refused(bundles):
    with pytest.raises(ValueError, match="objective"):
        UNetTrainer(bundles[1], device=CPU,
                    config=TrainConfig(objective="sample"))


def _updates(seed, scale):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) * scale
            for s in ((3, 5), (7,), (2, 2, 3))]


@pytest.mark.parametrize("max_norm,warmup,decay", [
    (1.0, 0, 1e-2), (0.05, 2, 0.1), (100.0, 3, 0.0)],
    ids=["default", "clipped_warmup", "unclipped_no_decay"])
def test_unet_update_chain_matches_optax(max_norm, warmup, decay):
    lr = 1e-2
    schedule = optax.linear_schedule(0.0, lr, warmup) if warmup else lr
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(schedule, weight_decay=decay))
    params = _updates(0, 1.0)
    state = tx.init([jnp.asarray(p) for p in params])
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()).requires_grad_(True)
               for p in params]
    opt = torch.optim.AdamW(tparams, lr=lr, eps=1e-8, weight_decay=decay)
    for step in range(4):
        grads = _updates(10 + step, 0.3)
        upd, state = tx.update([jnp.asarray(g) for g in grads], state,
                               jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        clip_by_global_norm_([p.grad for p in tparams], max_norm)
        opt.param_groups[0]["lr"] = linear_warmup(lr, warmup, step)
        opt.step()
    for p, j in zip(tparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=1e-6, rtol=1e-6)


def test_vae_and_lora_update_chains_match_optax():
    """The VAE trainer's clip + Adam, and the LoRA trainer's AdamW at
    optax's default decay of 1e-4."""
    for name, tx, make in (
            ("vae", optax.chain(optax.clip_by_global_norm(0.2),
                                optax.adam(1e-2)),
             lambda ps: torch.optim.Adam(ps, lr=1e-2, eps=1e-8)),
            ("lora", optax.adamw(1e-2),
             lambda ps: torch.optim.AdamW(ps, lr=1e-2, eps=1e-8,
                                          weight_decay=1e-4))):
        params = _updates(1, 1.0)
        jparams = [jnp.asarray(p) for p in params]
        state = tx.init(jparams)
        tparams = [torch.from_numpy(p.copy()).requires_grad_(True)
                   for p in params]
        opt = make(tparams)
        for step in range(3):
            grads = _updates(20 + step, 0.3)
            upd, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
            jparams = optax.apply_updates(jparams, upd)
            for p, g in zip(tparams, grads):
                p.grad = torch.from_numpy(g)
            if name == "vae":
                clip_by_global_norm_([p.grad for p in tparams], 0.2)
            opt.step()
        for p, j in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       atol=1e-6, rtol=1e-6, err_msg=name)


def test_training_package_exports_the_jax_names():
    import stable_diffusion_videos_tpu.training as jt
    import stable_diffusion_videos_tpu_torch.training as pt
    assert sorted(pt.__all__) == sorted(jt.__all__)
    assert all(hasattr(pt, n) for n in pt.__all__)


@pytest.mark.parametrize("size", [8, 32])
def test_structured_data_equals_jax(size):
    from stable_diffusion_videos_tpu.training import structured_data as js
    from stable_diffusion_videos_tpu_torch.training import \
        structured_data as ps
    want_imgs, want_prompts = js.make_structured_dataset(size)
    imgs, prompts = ps.make_structured_dataset(size)
    assert prompts == want_prompts
    np.testing.assert_array_equal(imgs, want_imgs)
    samples = imgs[::-1] + np.random.default_rng(size).standard_normal(
        imgs.shape).astype(np.float32) * 0.3
    np.testing.assert_array_equal(ps.identify_patterns(samples, imgs),
                                  js.identify_patterns(samples, want_imgs))
