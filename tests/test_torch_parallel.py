"""The port's multi-card layer (``parallel/``) against the JAX package's.

* the mesh: one rank without a process group, its shapes and errors
  (``tests/test_parallel.py``'s), the padding helpers;
* tensor parallelism: the rules split the same leaves of the tiny UNet as
  JAX ``param_pspecs`` (port names mapped through ``to_jax_params``' table,
  the dimensions through the layouts), ``tp_param_fraction`` and
  ``param_bytes_per_device`` equal the JAX values, and the divisibility
  guard behaves the same (with the port's two guards beyond it);
* the sharded forms in one process, ``model`` ranks as threads
  (``ThreadMesh``): the halo convolution on width slabs equals the whole
  convolution (1e-6), the split-statistics GroupNorm's plain passes merged
  over slabs equal flax's ``nn.GroupNorm`` on the whole (1e-5), and the
  tiny UNet split by tensor parallelism or by width equals the whole one;
* the engines over two gloo processes (``tests/torch_mesh_child.py``)
  against the JAX engine on its virtual 8-device mesh: data parallel at the
  port's 1e-4, tensor parallel (data 1, model 2) at atol 2e-4 rtol 1e-3
  and spatial at atol 3e-4 rtol 2e-3 (``tests/test_parallel.py``'s
  tolerances), the safety flags of 5 frames, a walk written by rank 0
  alone, and each TP rank's parameter bytes beside the accounting;
* ``debug``: the port's ``debug_latents`` against the JAX engine's step by
  step (1e-4), and debug frames against fused ones under limited-interval
  CFG (``tests/test_guidance_interval.py``'s counterpart).
"""

import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.layers import (
    CrossAttention, ResnetBlock2D)
from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.models.weights import _rows
from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
    groupnorm_apply_reference, groupnorm_partials_reference)
from stable_diffusion_videos_tpu_torch.parallel import (make_mesh,
                                                        pad_along_axis,
                                                        pad_to_multiple)
from stable_diffusion_videos_tpu_torch.parallel.spatial import (
    HaloConv2d, shard_unet_spatially)
from stable_diffusion_videos_tpu_torch.parallel.tp import (
    param_bytes_per_device, param_specs, shard_module, tp_param_fraction)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_multihost import finish, free_port, spawn
from test_torch_safety import planted, port_checker  # noqa: F401 (fixture)
from test_torch_sampler_engines import jax_tiny_models, tiny_bundles
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
ENGINE_TOL = dict(atol=1e-4, rtol=1e-4)
TP_TOL = dict(atol=2e-4, rtol=1e-3)
SPATIAL_TOL = dict(atol=3e-4, rtol=2e-3)


class ThreadMesh:
    """``model`` ranks of a (1, m) grid as threads of this process: the
    collectives of ``parallel.mesh.Mesh`` over shared slots and a
    barrier."""

    def __init__(self, m: int, rank: int, shared):
        self.shape = {"data": 1, "model": m}
        self.rank, self._shared = rank, shared

    def __deepcopy__(self, memo):
        return self  # as ``Mesh``: a module copied with it runs on it

    def index(self, axis):
        return self.rank if axis == "model" else 0

    def rows(self, n, axis="data"):
        k = self.shape[axis]
        i = self.index(axis)
        return slice(i * n // k, (i + 1) * n // k)

    def _exchange(self, t):
        slots, barrier = self._shared
        slots[self.rank] = t
        barrier.wait()
        parts = list(slots)
        barrier.wait()
        return parts

    def all_gather(self, t, axis, dim=0):
        return torch.cat(self._exchange(t), dim)

    def all_reduce(self, t, axis):
        parts = self._exchange(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


def run_ranks(m: int, fn) -> list:
    """``fn(mesh)`` on m thread ranks; -> each rank's result, in order."""
    shared = ([None] * m, threading.Barrier(m, timeout=60))
    out, errors = [None] * m, []

    def body(r):
        try:
            with torch.no_grad():
                out[r] = fn(ThreadMesh(m, r, shared))
        except BaseException as e:  # reported below, the barrier broken
            errors.append(e)
            shared[1].abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_make_mesh_shapes():
    from stable_diffusion_videos_tpu.parallel.mesh import \
        pad_along_axis as jpad
    mesh = make_mesh(devices=[CPU])
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.index("data") == 0 and mesh.rows(6) == slice(0, 6)
    x = torch.arange(6.0)
    assert mesh.all_gather(x, "data") is x
    with pytest.raises(ValueError):
        make_mesh(model=2, devices=[CPU])   # 2 != 1 rank
    with pytest.raises(ValueError):
        make_mesh(data=3, model=2, devices=[CPU])
    assert [pad_to_multiple(n, 8) for n in (5, 8, 9)] == [8, 8, 16]
    a = np.arange(12.0).reshape(3, 4)
    for axis in (0, 1):
        want = np.asarray(jpad(a, 2, axis))
        np.testing.assert_array_equal(pad_along_axis(a, 2, axis), want)
        np.testing.assert_array_equal(
            pad_along_axis(torch.from_numpy(a), 2, axis).numpy(), want)


# ---------------------------------------------------------------------------
# tensor-parallel rules against the JAX package's
# ---------------------------------------------------------------------------
def jax_unet_specs(model: int = 2):
    """{port name: torch dim or None} of the JAX rules on the tiny UNet's
    tree, read through the port's name table."""
    from jax.sharding import PartitionSpec as P

    from stable_diffusion_videos_tpu.parallel.tp import param_pspecs
    jm = jax_tiny_models()
    specs = param_pspecs(jm.params["unet"],
                         axis_sizes={"model": model, "data": 1})
    out = {}
    for path, key, kind in _rows(UNetConfig.tiny(), False):
        node = specs["params"]
        try:
            for k in path:
                node = node[k]
        except KeyError:
            continue
        assert isinstance(node, P)
        axes = [i for i, ax in enumerate(node) if ax == "model"]
        if not axes:
            out[key] = None
            continue
        (ax,) = axes
        # dense (in, out): out is torch dim 0; conv HWIO: O -> 0, I -> 1
        out[key] = ({"dense": {1: 0, 0: 1}, "conv": {3: 0, 2: 1}}
                    [kind][ax])
    return jm, out


def test_tp_rules_shard_the_jax_leaves():
    _, want = jax_unet_specs()
    got = param_specs(UNet2DCondition(UNetConfig.tiny()), 2)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if v is not None} == \
        {k: v for k, v in want.items() if v is not None}
    assert sum(v is not None for v in got.values()) > 50


def test_tp_accounting_matches_jax():
    from stable_diffusion_videos_tpu.parallel.mesh import \
        make_mesh as jax_mesh
    from stable_diffusion_videos_tpu.parallel.tp import (
        param_bytes_per_device as jbytes, tp_param_fraction as jfrac)
    jm, _ = jax_unet_specs()
    unet = UNet2DCondition(UNetConfig.tiny())
    want = jbytes(jm.params["unet"], jax_mesh(model=2))
    assert param_bytes_per_device(unet, 2) == pytest.approx(want)
    assert tp_param_fraction(unet, 2) == pytest.approx(
        jfrac(jm.params["unet"]), abs=1e-12)
    assert tp_param_fraction(unet, 2) > 0.9


class Guarded(torch.nn.Module):
    def __init__(self, heads=2, head_dim=3, groups=2):
        super().__init__()
        self.attn1 = CrossAttention(16, 16, heads, head_dim)
        self.res = ResnetBlock2D(8, 6, groups=groups)


@pytest.mark.parametrize("model,module,want", [
    (4, dict(), (None, None)), (2, dict(), (0, 0)),
    (2, dict(heads=3, head_dim=2), (None, 0)),
    (2, dict(groups=3), (0, None))],
    ids=["indivisible", "divisible", "odd_heads", "odd_groups"])
def test_tp_divisibility_guard(model, module, want):
    """JAX's guard (a dimension the axis does not divide stays whole) on
    the same shapes, and the port's head and group guards beyond it, each
    keeping its own unit whole."""
    from jax.sharding import PartitionSpec as P

    from stable_diffusion_videos_tpu.parallel.tp import param_pspecs
    specs = param_specs(Guarded(**module), model)
    assert (specs["attn1.to_q.weight"], specs["res.conv1.weight"]) == want
    if not module:
        jparams = {"attn1": {"to_q": {"kernel": jnp.zeros((16, 6))}},
                   "res": {"conv1": {"kernel": jnp.zeros((3, 3, 8, 6))}}}
        js = param_pspecs(jparams, axis_sizes={"model": model, "data": 1})
        split = want[0] is not None
        assert (js["attn1"]["to_q"]["kernel"] != P()) == split
        assert (js["res"]["conv1"]["kernel"] != P()) == split


# ---------------------------------------------------------------------------
# the sharded forms, ranks as threads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("stride,circular", [(1, False), (2, False),
                                             (1, True), (2, True)],
                         ids=["s1", "s2", "s1_circular", "s2_circular"])
def test_halo_conv_matches_whole(m, stride, circular):
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(6, 5, 3, stride=stride, padding=1,
                           padding_mode="circular" if circular else "zeros")
    x = torch.randn(2, 6, 8, 16)
    with torch.no_grad():
        want = conv(x)

    def rank(mesh):
        c = copy.deepcopy(conv)
        c.__class__ = HaloConv2d
        c.sp_mesh = mesh
        return c(x[..., mesh.rows(16, "model")])

    got = torch.cat(run_ranks(m, rank), -1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("silu", [False, True])
def test_split_groupnorm_matches_flax(m, silu):
    import flax.linen as nn
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 6, 16), dtype=np.float32) * 3 + 1
    scale = rng.standard_normal(64, dtype=np.float32)
    bias = rng.standard_normal(64, dtype=np.float32)
    gn = nn.GroupNorm(num_groups=32, epsilon=1e-6)
    want = gn.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = np.asarray(jax.nn.silu(want) if silu else want).transpose(
        0, 3, 1, 2)
    xt = torch.from_numpy(x)
    slabs = [xt[..., r * 16 // m:(r + 1) * 16 // m] for r in range(m)]
    parts = torch.stack([groupnorm_partials_reference(s, 32)
                         for s in slabs])
    got = torch.cat([groupnorm_apply_reference(
        s, torch.from_numpy(scale), torch.from_numpy(bias), parts, 32, 1e-6,
        silu) for s in slabs], -1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def unet_inputs():
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.standard_normal((2, 4, 8, 8),
                                                 dtype=np.float32)),
            torch.tensor([500.0, 20.0]),
            torch.from_numpy(rng.standard_normal((2, 7, 32),
                                                 dtype=np.float32)))


@pytest.mark.parametrize("how", ["tp", "spatial", "spatial_circular"])
def test_split_unet_matches_whole(how):
    """The tiny UNet on two thread ranks, its weights split (TP: every
    unit, norm2 at 16 groups) or its width (spatial) equals the whole
    UNet."""
    _, pm = tiny_bundles()
    unet = pm.unet
    if how == "spatial_circular":
        from stable_diffusion_videos_tpu_torch.models.layers import \
            make_circular
        unet = make_circular(copy.deepcopy(unet))
    x, t, ctx = unet_inputs()
    with torch.no_grad():
        want = unet(x, t, ctx)

    def rank(mesh):
        u = copy.deepcopy(unet)
        if how == "tp":
            shard_module(u, mesh)
            assert u.down_blocks[0].resnets[0].norm2.num_groups == 16
            return u(x, t, ctx)
        shard_unet_spatially(u, mesh)
        return u(x[..., mesh.rows(8, "model")], t, ctx)

    outs = run_ranks(2, rank)
    got = outs[0] if how == "tp" else torch.cat(outs, -1)
    if how == "tp":
        torch.testing.assert_close(outs[1], outs[0], atol=0, rtol=0)
    tol = TP_TOL if how == "tp" else SPATIAL_TOL
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


@pytest.mark.parametrize("width", [6, 10])
def test_spatial_widths_that_do_not_divide_raise(width):
    """The tiny UNet's two levels over two model ranks need a latent width
    divisible by 4 (an even slab at its downsample); the refusal comes
    before any collective (this mesh has no process group)."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.parallel.mesh import Mesh
    eng = Engine(SDModels.tiny(), CPU, mesh=Mesh(1, 2, 0, CPU, None, {}),
                 spatial_shard=True, scheduler="ddim")
    with pytest.raises(ValueError, match="divisible by 4"):
        eng.denoise_frames(np.zeros((1, 7, 32), np.float32),
                           np.zeros((1, 7, 32), np.float32),
                           np.zeros((1, 8, width, 4), np.float32),
                           num_inference_steps=2)


# ---------------------------------------------------------------------------
# the engines over two gloo processes, against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh_runs(planted, tmp_path_factory):  # noqa: F811 (fixture)
    """(JAX results, rank 0's and rank 1's results, the workdir, the port
    bundle) of the engines scenario on the tiny bundles with the planted
    safety checker."""
    from stable_diffusion_videos_tpu.models import safety as J
    from stable_diffusion_videos_tpu.parallel.mesh import \
        make_mesh as jax_mesh
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    tree, imgs = planted
    jm, pm = tiny_bundles()
    jm = dataclasses.replace(jm, safety_config=J.SafetyConfig.tiny(),
                             params={**jm.params, "safety_checker": tree})
    pm = pm.with_safety_checker(port_checker(tree))
    work = tmp_path_factory.mktemp("mesh")
    pm.save(work / "bundle")
    rng = np.random.default_rng(3)
    inp = dict(cond=rng.standard_normal((3, 7, 32), dtype=np.float32),
               uncond=rng.standard_normal((1, 7, 32), dtype=np.float32),
               noise=rng.standard_normal((3, 8, 8, 4), dtype=np.float32),
               frames=np.concatenate([imgs, imgs[2:3]]))
    np.savez(work / "inputs.npz", **inp)
    procs = spawn("engines", free_port(), (0, 1), work)
    run = dict(num_inference_steps=2, guidance_scale=3.0)
    args = [jnp.asarray(inp[k]) for k in ("cond", "uncond", "noise")]
    jax_out = {
        "dp": JEngine(jm, scheduler="ddim").denoise_frames(*args, **run),
        "tp": JEngine(jm, mesh=jax_mesh(model=2),
                      scheduler="ddim").denoise_frames(*args, **run),
        "spatial": JEngine(jm, mesh=jax_mesh(model=2), scheduler="ddim",
                           spatial_shard=True).denoise_frames(*args, **run),
        "flags": JEngine(jm).check_safety(inp["frames"]),
    }
    finish(procs, timeout=240)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in (0, 1)]
    return ({k: np.asarray(v) for k, v in jax_out.items()}, ranks, work, pm)


@pytest.mark.parametrize("layout,tol", [("dp", ENGINE_TOL),
                                        ("tp", TP_TOL),
                                        ("spatial", SPATIAL_TOL)])
def test_sharded_dispatch_matches_jax(mesh_runs, layout, tol):
    want, ranks, _, _ = mesh_runs
    for r in ranks:
        assert r[layout].shape == (3, 16, 16, 3)
        np.testing.assert_allclose(r[layout], want[layout], **tol)
    np.testing.assert_array_equal(ranks[0][layout], ranks[1][layout])


def test_sharded_safety_and_decode(mesh_runs):
    """check_safety of 5 frames over data 2 (padded to 6, stripped back)
    gives the JAX engine's flags; decode_latents over data 2 equals one
    rank's."""
    want, ranks, _, pm = mesh_runs
    inp = np.load(mesh_runs[2] / "inputs.npz")
    one = Engine(pm, CPU).decode_latents(inp["noise"][:3])
    for r in ranks:
        np.testing.assert_array_equal(r["flags"], want["flags"])
        np.testing.assert_array_equal(r["flags"],
                                      [True, True, False, False, False])
        np.testing.assert_allclose(r["decoded"], one, **ENGINE_TOL)


def test_tp_rank_holds_its_share(mesh_runs):
    for r in mesh_runs[1]:
        held, want = r["tp_bytes"]
        assert abs(held - want) <= 0.02 * want, (held, want)


def test_walk_over_data_ranks_written_by_rank0(mesh_runs):
    """Rank 0 alone writes; the frames equal a one-rank walk's within
    1/255 (the CPU's convolutions may round a batch of 1 and one of 2
    apart)."""
    from PIL import Image

    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    _, ranks, work, pm = mesh_runs
    assert [bool(r["walk_writer"]) for r in ranks] == [True, False]
    assert str(ranks[0]["walk_path"]) == str(ranks[1]["walk_path"])
    pngs = sorted((work / "walk" / "w").glob("**/frame*.png"))
    assert len(pngs) == 3
    one = StableDiffusionWalkPipeline(pm, CPU, scheduler="ddim", safety=False)
    one.walk(prompts=["a fox", "a lighthouse"], seeds=[1, 2],
             num_interpolation_steps=3, num_inference_steps=2, batch_size=2,
             output_dir=str(work / "one"), name="w", make_video=False)
    ref = sorted((work / "one" / "w").glob("**/frame*.png"))
    for a, b in zip(pngs, ref):
        d = np.abs(np.asarray(Image.open(a), np.int16)
                   - np.asarray(Image.open(b), np.int16))
        assert d.max() <= 1


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------
def test_debug_latents_match_jax():
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = tiny_bundles()
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((2, 7, 32), dtype=np.float32)
    uncond = rng.standard_normal((1, 7, 32), dtype=np.float32)
    noise = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    run = dict(num_inference_steps=4, guidance_scale=5.0)
    je = JEngine(jm, scheduler="pndm", batch_bucket=8, debug=True)
    want = je.denoise_frames(jnp.asarray(cond), jnp.asarray(uncond),
                             jnp.asarray(noise), **run)
    pe = Engine(pm, CPU, scheduler="pndm", debug=True, step_cache=2)
    got = pe.denoise_frames(cond, uncond, noise, **run)
    assert len(pe.debug_latents) == len(je.debug_latents) == 5
    for p, j in zip(pe.debug_latents, je.debug_latents):
        np.testing.assert_allclose(p.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(j)[:2], **ENGINE_TOL)
    np.testing.assert_allclose(got, np.asarray(want), **ENGINE_TOL)


def test_interval_debug_path_matches_fused():
    _, pm = tiny_bundles()
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((2, 7, 32), dtype=np.float32)
    uncond = rng.standard_normal((1, 7, 32), dtype=np.float32)
    noise = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    kw = dict(num_inference_steps=6, guidance_scale=7.5)
    fused = Engine(pm, CPU, scheduler="ddim",
                   guidance_interval=(0.25, 0.75)).denoise_frames(
        cond, uncond, noise, **kw)
    dbg = Engine(pm, CPU, scheduler="ddim", guidance_interval=(0.25, 0.75),
                 debug=True)
    np.testing.assert_allclose(dbg.denoise_frames(cond, uncond, noise, **kw),
                               fused, atol=1e-4)
    assert len(dbg.debug_latents) == 6


# ---------------------------------------------------------------------------
# phase mesh's launch keys, on the meta device
# ---------------------------------------------------------------------------
def record_keys(monkeypatch) -> set:
    """The models' kernel ops replaced by recorders of the keys their
    wrappers count launches by (thread-safe); -> the set they fill with
    (kernel, key)."""
    from stable_diffusion_videos_tpu_torch.models import layers
    keys, lock = set(), threading.Lock()

    def attention(q, k, v, scale=None):
        with lock:
            keys.add(("flash_attention", (q.shape[0], q.shape[1],
                                          k.shape[1], q.shape[2],
                                          q.shape[3], q.dtype)))
        return torch.empty_like(q)

    def groupnorm(x, scale, bias, num_groups=32, eps=1e-5, silu=True):
        with lock:
            keys.add(("fused_groupnorm_silu", (tuple(x.shape), float(eps),
                                               bool(silu), x.dtype,
                                               scale.dtype, num_groups)))
        return torch.empty_like(x)

    def split(x, scale, bias, gather, num_groups=32, eps=1e-5, silu=True):
        parts = gather(torch.empty(x.shape[0], num_groups, 3,
                                   device=x.device))
        with lock:
            keys.add(("groupnorm_partials", (tuple(x.shape), x.dtype,
                                             num_groups)))
            keys.add(("groupnorm_apply", (tuple(x.shape), bool(silu),
                                          x.dtype, scale.dtype, num_groups,
                                          parts.shape[0])))
        return torch.empty_like(x)

    monkeypatch.setattr(layers, "attention", attention)
    monkeypatch.setattr(layers, "fused_groupnorm_silu", groupnorm)
    monkeypatch.setattr(layers, "split_groupnorm_silu", split)
    return keys


def assert_checked(keys: set) -> set:
    """Every key is one ``chip_smoke.py``'s phase 3 checks; -> the
    kernels."""
    from test_torch_encode import chip_smoke
    checked = chip_smoke().checked_keys(torch)
    assert keys and sorted((n, k) for n, k in keys
                           if k not in checked[n]) == []
    return {n for n, _ in keys}


@pytest.mark.parametrize("layout", ["tp", "spatial"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_mesh_phase_keys_are_checked(monkeypatch, layout, dtype):
    """The SD 1.x UNet at 512², CFG batch 16, and (tensor parallel) the KL
    decoder at batch 8, split over two thread ranks on the meta device,
    launch only keys that ``chip_smoke.py``'s phase 3 checks, in the
    wrappers' ``by_shape`` form."""
    from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                              VAEConfig)
    keys = record_keys(monkeypatch)
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd_v1()).to(dtype)
        vae = AutoencoderKL(VAEConfig.sd_v1()).to(dtype)
        x = torch.empty(16, 4, 64, 64)
        t = torch.empty(16)
        ctx = torch.empty(16, 77, 768)
        z = torch.empty(8, 4, 64, 64)

    def rank(mesh):
        u = copy.deepcopy(unet)
        if layout == "tp":
            shard_module(u, mesh)
            d = copy.deepcopy(vae)
            shard_module(d, mesh)
            d.decode(z)
            return u(x, t, ctx)
        shard_unet_spatially(u, mesh)
        return u(x[..., mesh.rows(64, "model")], t, ctx)

    run_ranks(2, rank)
    kernels = assert_checked(keys)
    assert kernels == ({"flash_attention", "fused_groupnorm_silu"}
                       if layout == "tp" else
                       {"flash_attention", "groupnorm_partials",
                        "groupnorm_apply"})


@pytest.mark.parametrize("layout", ["tp", "spatial"])
def test_mesh_phase_split_keys_are_checked(monkeypatch, layout):
    """The halves of phase mesh's 8-frame bf16 dispatch split on the model
    axis: the SD 1.x UNet at 512², CFG batch 8, and the KL decoder at batch
    4 (sharded under TP, whole on every rank under spatial sharding), over
    two thread ranks on the meta device, launch only keys that phase 3
    checks."""
    from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                              VAEConfig)
    keys = record_keys(monkeypatch)
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd_v1()).to(torch.bfloat16)
        vae = AutoencoderKL(VAEConfig.sd_v1()).to(torch.bfloat16)
        x, t = torch.empty(8, 4, 64, 64), torch.empty(8)
        ctx, z = torch.empty(8, 77, 768), torch.empty(4, 4, 64, 64)

    def rank(mesh):
        u, d = copy.deepcopy(unet), copy.deepcopy(vae)
        if layout == "tp":
            shard_module(u, mesh)
            shard_module(d, mesh)
            d.decode(z)
            return u(x, t, ctx)
        d.decode(z)
        shard_unet_spatially(u, mesh)
        return u(x[..., mesh.rows(64, "model")], t, ctx)

    run_ranks(2, rank)
    assert_checked(keys)


def test_mesh_phase_sdxl_split_keys_are_checked(monkeypatch):
    """SDXL-base's UNet at 1024² (128² latents), CFG batch 2, spatially
    sharded over two thread ranks on the meta device, normalises through
    the split kernels alone (N·G = 64 runs, fewer than the card's SMs), at
    keys ``chip_smoke.py``'s phase 3 checks."""
    keys = record_keys(monkeypatch)
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd_xl()).to(torch.bfloat16)
        x, t = torch.empty(2, 4, 128, 128), torch.empty(2)
        ctx = torch.empty(2, 77, 2048)
        pooled, ids = torch.empty(2, 1280), torch.empty(2, 6)

    def rank(mesh):
        u = copy.deepcopy(unet)
        shard_unet_spatially(u, mesh)
        return u(x[..., mesh.rows(128, "model")], t, ctx,
                 text_embeds=pooled, time_ids=ids)

    run_ranks(2, rank)
    split = {(n, k) for n, k in keys if n.startswith("groupnorm_")}
    assert {n for n, _ in split} == {"groupnorm_partials", "groupnorm_apply"}
    # each a rank's half of the width: (2, C, H, H / 2)
    assert all(k[0][0] == 2 and k[0][2] == 2 * k[0][3] for _, k in split)
    assert_checked(split)
    assert "fused_groupnorm_silu" not in {n for n, _ in keys}


@pytest.mark.parametrize("layout", ["tp", "spatial"])
@pytest.mark.parametrize("addon", ["controlnet", "ip_adapter", "tome",
                                   "freeu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_mesh_phase_addon_keys_are_checked(monkeypatch, layout, addon,
                                           dtype):
    """Phase mesh's add-on dispatches on the meta device over two thread
    ranks, as the engine lays them out: the SD 1.x UNet at 512², CFG batch
    16, with SD 1.x's published ControlNet (whole under TP, its trunk
    sharded spatially on the rank's latent and pixel columns), IP-Adapter
    projections on every cross-attention with 4 image tokens (TP: the
    rank's heads), ToMe 0.5 at level 0 (spatial: the gathered level) or
    FreeU; every launch key is one phase 3 checks."""
    from stable_diffusion_videos_tpu_torch.models.controlnet import (
        ControlNet)
    from stable_diffusion_videos_tpu_torch.models.ip_adapter import \
        attn2_scopes
    from stable_diffusion_videos_tpu_torch.parallel.tp import \
        shard_ip_projections
    keys = record_keys(monkeypatch)
    cfg = UNetConfig.sd_v1()
    with torch.device("meta"):
        unet = UNet2DCondition(cfg).to(dtype)
        net = ControlNet(cfg).to(dtype) if addon == "controlnet" else None
        x, t = torch.empty(16, 4, 64, 64), torch.empty(16)
        ctx, tokens = torch.empty(16, 77, 768), torch.empty(16, 4, 768)
        cmap = torch.empty(16, 3, 512, 512)
    if addon == "tome":
        unet.set_tome((0.5, 0))
    elif addon == "freeu":
        unet.freeu = (1.5, 1.6, 0.9, 0.2)

    def rank(mesh):
        u = copy.deepcopy(unet)
        spatial = layout == "spatial"
        shard = shard_unet_spatially if spatial else shard_module
        shard(u, mesh)
        kw, xin = {}, x
        if spatial:
            xin = x[..., mesh.rows(64, "model")]
        if addon == "ip_adapter":
            for name, level in attn2_scopes(cfg):
                attn = u.get_submodule(name)
                inner = cfg.block_out_channels[level]
                for attr in ("to_k_ip", "to_v_ip"):
                    setattr(attn, attr, torch.nn.Linear(
                        768, inner, bias=False, device="meta", dtype=dtype))
            if not spatial:
                shard_ip_projections(u, mesh)
            kw = dict(ip_context=tokens, ip_scale=1.0)
        elif addon == "controlnet":
            n = copy.deepcopy(net)
            c = cmap
            if spatial:
                shard_unet_spatially(n, mesh)
                c = cmap[..., mesh.rows(512, "model")]
            down, mid = n(xin, t, ctx, c)
            kw = dict(ctrl_down=down, ctrl_mid=mid)
        return u(xin, t, ctx, **kw)

    run_ranks(2, rank)
    assert_checked(keys)
