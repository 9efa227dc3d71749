"""The PyTorch package's DeepCache UNet split against the JAX package's.

JAX params, every leaf redrawn from a numpy seed, are carried into the port
by ``from_jax_params``: the tiny UNet at split 1, and the 3-level config of
tests/test_step_cache.py at splits 1 and 2.  The full pass with
``cache_split`` gives the plain call's ``eps`` bit for bit and JAX's deep
feature (its shape, and its values within 1e-4 of their largest); a
shallow pass fed a stale deep feature matches JAX's shallow pass (fp32,
atol=rtol=1e-4).  The ``cuda`` case holds the shallow
pass fed a fresh deep feature to the full pass on the card, in bf16.
"""

import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict, random_state_dict)

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
THREE_LEVELS = dict(sample_size=8, block_out_channels=(32, 64, 64),
                    layers_per_block=2, cross_attention_dim=32,
                    attention_head_dim=2, attn_levels=(True, True, False))
CASES = [("tiny", 1), ("three_levels", 1), ("three_levels", 2)]


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())


@pytest.fixture(scope="module")
def unets():
    """name -> (JAX module, JAX params, port module), on the same weights.
    JAX is imported here: the card's machine has no flax, and this file's
    ``cuda`` case runs there."""
    import jax
    import jax.numpy as jnp

    from stable_diffusion_videos_tpu.models.unet import \
        UNet2DCondition as JUNet
    from stable_diffusion_videos_tpu.models.unet import UNetConfig as JConfig
    out = {}
    for i, (name, jcfg, pcfg) in enumerate((
            ("tiny", JConfig.tiny(), UNetConfig.tiny()),
            ("three_levels", JConfig(**THREE_LEVELS),
             UNetConfig(**THREE_LEVELS)))):
        jm = JUNet(jcfg)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                         jnp.zeros((1,)), jnp.zeros((1, 7, 32)))
        rng = np.random.default_rng(10 + i)
        params = jax.tree.map(lambda a: rng.standard_normal(
            a.shape, dtype=np.float32) * 0.2, params)
        port = load_state_dict(UNet2DCondition(pcfg),
                               from_jax_params(params, pcfg))
        out[name] = (jm, params, port)
    return out


def inputs(seed):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 32), dtype=np.float32)
    return lat, np.array([5.0, 700.0], np.float32), ctx


@pytest.mark.parametrize("name,split", CASES)
def test_full_pass_with_split_is_the_plain_call(unets, name, split):
    jm, params, port = unets[name]
    lat, t, ctx = inputs(1)
    _, jdeep = jm.apply(params, lat, t, ctx, cache_split=split)
    args = (nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        plain = port(*args)
        eps, deep = port(*args, cache_split=split)
    assert torch.equal(eps, plain)
    assert tuple(deep.permute(0, 2, 3, 1).shape) == jdeep.shape
    # the trunk's output runs to hundreds on these weights: its error is
    # held to 1e-4 of its largest value
    want = np.asarray(jdeep)
    err = np.abs(deep.permute(0, 2, 3, 1).numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("name,split", CASES)
def test_shallow_pass_with_stale_deep_matches_jax(unets, name, split):
    jm, params, port = unets[name]
    lat, t, ctx = inputs(2)
    _, jdeep = jm.apply(params, lat, t, ctx, cache_split=split)
    t2 = t + 20.0
    want, jdeep2 = jm.apply(params, lat, t2, ctx, cache_split=split,
                            deep_feature=jdeep)
    with torch.no_grad():
        got, deep2 = port(nchw(lat), torch.from_numpy(t2),
                          torch.from_numpy(ctx), cache_split=split,
                          deep_feature=nchw(jdeep))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)
    # the shallow pass returns the deep feature it was given
    np.testing.assert_array_equal(deep2.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jdeep2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2])
def test_shallow_pass_with_fresh_deep_is_the_full_pass_on_the_card(cuda,
                                                                   split):
    """At half SD 1.x's widths (4 levels, 8 heads, D=20/40/80) and a 32²
    latent, bf16, on the kernels: the shallow pass fed the deep feature of
    the same step gives the full pass's eps bit for bit: it reruns the
    same kernels on the same inputs."""
    cfg = UNetConfig(sample_size=32, block_out_channels=(160, 320, 640, 640),
                     cross_attention_dim=384)
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    unet = load_state_dict(unet, random_state_dict(unet, 5, 0.02),
                           torch.bfloat16).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    lat = torch.randn(4, 4, 32, 32, device=cuda, generator=g)
    ctx = torch.randn(4, 77, 384, device=cuda, generator=g)
    t = torch.full((4,), 601.0, device=cuda)
    with torch.no_grad():
        plain = unet(lat, t, ctx)
        eps, deep = unet(lat, t, ctx, cache_split=split)
        shallow, _ = unet(lat, t, ctx, cache_split=split, deep_feature=deep)
    assert torch.equal(eps, plain)
    assert deep.shape == (4, cfg.block_out_channels[split],
                          32 >> (split - 1), 32 >> (split - 1))
    assert torch.equal(shallow, eps)
