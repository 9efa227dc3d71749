"""The plain reference against the port's tiny bundles on the CPU, its
samplers against the port's, and the count of work against
``torch.utils.flop_counter`` run on the reference."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, port, reference, weights
from portbench.reference import models as rm
from portbench.reference import pipeline as rp

from .cells import DATA, REPO


def tiny(name):
    cfg = json.loads((DATA / f"{name}.json").read_text())
    shapes = rm.build(cfg)
    drawn = weights.draw(shapes, 2 ** 31 + 5, 0.1, torch.float32, "cpu")
    return cfg, port.bundle(cfg, drawn, "cpu"), reference.build(cfg, drawn,
                                                                 "cpu")


@pytest.mark.parametrize("name", ["tiny", "tiny_xl"])
def test_reference_agrees_with_the_port(name):
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    cfg, bundle, mods = tiny(name)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=g)
    t = torch.tensor([981.0, 21.0])
    ctx = torch.randn(2, 77, cfg["unet"]["cross_attention_dim"], generator=g)
    kw = {}
    if name == "tiny_xl":
        kw = dict(text_embeds=torch.randn(2, 16, generator=g),
                  time_ids=torch.tensor([[16.0, 16, 0, 0, 16, 16]] * 2))
    with torch.no_grad():
        np.testing.assert_allclose(bundle.unet(x, t, ctx, **kw),
                                   mods["unet"](x, t, ctx, **kw),
                                   atol=1e-5, rtol=1e-5)
        z = torch.randn(2, 4, 8, 8, generator=g)
        np.testing.assert_allclose(
            bundle.vae.decode(z / cfg["vae"]["scaling_factor"]),
            mods["vae"].decode(z), atol=1e-5, rtol=1e-5)
        prompts = ["a red fox in the snow at dusk", ""]
        h, p = Engine(bundle, torch.device("cpu"))._embed(prompts)
        hr, pr = rp.encode_prompts(mods, cfg, prompts, "cpu")
        np.testing.assert_allclose(h, hr, atol=1e-5, rtol=1e-5)
        if p is not None:
            np.testing.assert_allclose(p, pr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sampler,steps", [("pndm", 7), ("euler", 6),
                                           ("lcm", 4)])
def test_samplers_agree_with_the_port(sampler, steps):
    from stable_diffusion_videos_tpu_torch.core.schedulers import (
        SchedulerConfig, get_scheduler)
    sched = json.loads((REPO / "portbench" / "configs" / "sd15.json")
                       .read_text())["scheduler"]
    mine = rp.SAMPLERS[sampler](sched, steps)
    theirs = get_scheduler(sampler)
    tables = theirs.make_tables(SchedulerConfig(), steps)
    assert [float(t) for t in mine.timesteps] == \
        [float(t) for t in tables["timesteps"]]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 8, 8, generator=g)
    xa, xb = x * mine.init_sigma, x * theirs.init_noise_sigma(tables)
    state = theirs.init_state(tables, xb)
    for i in range(len(mine.timesteps)):
        eps = torch.randn(2, 4, 8, 8, generator=g)
        noise = torch.randn(1, 4, 8, 8, generator=g)
        np.testing.assert_allclose(mine.scale(xa, i),
                                   theirs.scale_model_input(tables, state, i,
                                                            xb),
                                   rtol=1e-5, atol=1e-5)
        xa = mine.step(eps, i, xa, noise)
        state, xb = theirs.step(tables, state, i, eps, xb, noise)
        np.testing.assert_allclose(xa, xb, rtol=1e-5, atol=1e-4)


def test_interpolation_and_quantisation():
    from stable_diffusion_videos_tpu_torch.core import interp
    g = torch.Generator().manual_seed(2)
    a, b = torch.randn(1, 4, 8, 8, generator=g), torch.randn(1, 4, 8, 8,
                                                              generator=g)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(rp.slerp(t, a, b), interp.slerp(t, a, b),
                                   atol=1e-6)
        np.testing.assert_allclose(rp.lerp(t, a, b), interp.lerp(t, a, b),
                                   atol=1e-6)
    np.testing.assert_allclose(rp.slerp(0.4, a, a * 2), interp.slerp(
        0.4, a, a * 2), atol=1e-6)
    from stable_diffusion_videos_tpu_torch.runtime.engine import quantise
    img = torch.rand(2, 5, 5, 3, generator=g)
    assert torch.equal(rp.quantise(img), quantise(img))


@pytest.mark.parametrize("name", ["tiny", "tiny_xl"])
def test_flops_against_the_flop_counter(name):
    cfg, _, mods = tiny(name)
    x = torch.randn(3, 4, 8, 8)
    ctx = torch.randn(3, 77, cfg["unet"]["cross_attention_dim"])
    kw = {}
    if name == "tiny_xl":
        kw = dict(text_embeds=torch.randn(3, 16), time_ids=torch.zeros(3, 6))
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            mods["unet"](x, torch.tensor([1.0, 2.0, 3.0]), ctx, **kw)
        assert fc.get_total_flops() == flops.unet(cfg["unet"], 3, 8, 8).flops
        with FlopCounterMode(display=False) as fc:
            mods["vae"].decode(torch.randn(2, 4, 6, 8))
        assert fc.get_total_flops() == flops.vae_decode(cfg["vae"], 2, 6,
                                                        8).flops
        with FlopCounterMode(display=False) as fc:
            rp.encode_prompts(mods, cfg, ["a b", "c d e"], "cpu")
        assert fc.get_total_flops() == flops.text(cfg, 2).flops


def test_attention_and_groupnorm_calls_of_a_unet():
    cfg = json.loads((REPO / "portbench" / "configs" / "sd15.json")
                     .read_text())
    w = flops.unet(cfg["unet"], 16, 64, 64)
    # the port's counters for one SD 1.5 UNet call at 16 rows: 16
    # transformer blocks, each a self- and a cross-attention; 61 GroupNorms
    assert len(w.attention) == 32 and len(w.groupnorm) == 61
    assert (16, 8, 4096, 4096, 40) in w.attention
    assert (16, 8, 64, 77, 160) in w.attention
    assert flops.attention_bound([(16, 8, 4096, 4096, 40)]) == \
        4 * 16 * 8 * 4096 * 4096 * 40 / flops.PEAK_FLOPS
    d = flops.vae_decode(cfg["vae"], 8, 64, 64)
    assert d.attention == [(8, 1, 4096, 4096, 512)]
    assert len(d.groupnorm) == 30
