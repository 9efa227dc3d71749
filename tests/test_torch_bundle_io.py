"""The native bundle format in the PyTorch package (``models/io.py``,
``models/flax_msgpack.py``, ``weights.to_jax_params``) against the JAX
package's (``models/io.py``, flax's serialization).

* The codec writes the bytes ``flax.serialization.to_bytes`` writes, for
  fp32, bf16, int and float64 arrays, a numpy scalar, python scalars and a
  chunked leaf; each side reads the other's.
* ``SDModels.load`` of the committed ``tests/goldens/structured_bundle``
  equals the ``from_jax_params`` route tensor for tensor, and its frames are
  bit-equal to that route's.
* A bundle the port saves loads in the JAX package with equal trees, and a
  bundle the JAX package saves loads in the port equal, for the tiny bundle
  with a safety checker and TAESD, the tiny SDXL bundle with textual
  inversion triggers, a tiled one and a bf16 one; ``to_jax_params``' trees
  have the paths and shapes of the JAX modules' own.
* ``hidden_act="gelu"`` of a safety tower survives a port round trip while
  the JAX package still loads the bundle; the JAX scheduler's three fields
  the port's config lacks are kept; ``convert`` runs through the CLI.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.models import flax_msgpack
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.clip_text import (
    CLIPTextConfig, CLIPTextEncoder)
from stable_diffusion_videos_tpu_torch.models.io import _state_dicts
from stable_diffusion_videos_tpu_torch.models.safety import (SafetyChecker,
                                                             SafetyConfig)
from stable_diffusion_videos_tpu_torch.models.tokenizer import (
    HashTokenizer, TextualInversionTokenizer)
from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                          VAEConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict, to_jax_params)

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
BUNDLE = ROOT / "tests" / "goldens" / "structured_bundle"
CPU = torch.device("cpu")


def as_numpy(x):
    """A tensor or array -> numpy, bf16 as ml_dtypes.bfloat16."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        return x.contiguous().numpy()
    return np.asarray(x)


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        x, y = as_numpy(a), as_numpy(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x.view(np.uint8), np.ascontiguousarray(y)
                              .view(np.uint8)), path
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def codec_tree():
    rng = np.random.default_rng(0)
    return {"params": {
        "conv": {"kernel": rng.standard_normal((3, 3, 4, 5), np.float32),
                 "bias": rng.standard_normal(5, np.float32)},
        "bf16": rng.standard_normal((7, 300)).astype(ml_dtypes.bfloat16),
        "ints": np.arange(-40000, 40000, 7, dtype=np.int32),
        "i64": np.array([2 ** 40, -3], np.int64),
        "f64": rng.standard_normal(70000),
        "scalar": np.float32(3.5), "step": np.int32(-9),
        "empty": np.zeros((0, 3), np.float32)},
        "meta": {"n": 3, "big": 2 ** 33, "neg": -70000, "x": 1.5,
                 "flag": True, "none": None, "name": "a" * 40}}


def test_codec_writes_flax_bytes_and_reads_them():
    import flax.serialization
    tree = codec_tree()
    want = flax.serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == want
    back = flax_msgpack.loads(want)
    # the array leaves come back as tensors, the numpy scalars as scalars
    assert torch.is_tensor(back["params"]["bf16"])
    assert back["params"]["bf16"].dtype == torch.bfloat16
    assert isinstance(back["params"]["scalar"], np.float32)
    assert_trees_equal(tree["params"], back["params"])
    assert back["meta"] == tree["meta"]


def test_flax_reads_what_the_port_writes(tmp_path):
    import flax.serialization
    rng = np.random.default_rng(1)
    tree = {"params": {
        "w": torch.from_numpy(rng.standard_normal((4, 6), np.float32))
        .to(torch.bfloat16),
        "t": torch.from_numpy(rng.standard_normal((3, 2, 5), np.float32))
        .permute(2, 0, 1),  # a non-contiguous view, written in C order
        "s": np.float64(2.25)}}
    flax_msgpack.write(tmp_path / "x.msgpack", tree)
    got = flax.serialization.msgpack_restore(
        (tmp_path / "x.msgpack").read_bytes())
    assert got["params"]["w"].dtype == ml_dtypes.bfloat16
    # flax hands a numpy scalar back as a python scalar
    assert got["params"]["s"] == 2.25
    assert_trees_equal({k: as_numpy(v) for k, v in tree["params"].items()
                        if k != "s"},
                       {k: v for k, v in got["params"].items() if k != "s"})
    # read() maps the file; the leaves are views of the mapping
    mapped = flax_msgpack.read(tmp_path / "x.msgpack")
    assert_trees_equal(mapped["params"]["t"], tree["params"]["t"])


def test_chunked_leaves_both_ways(monkeypatch):
    import flax.serialization
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "CHUNK_BYTES", 64)
    leaf = np.random.default_rng(2).standard_normal((5, 7), np.float32)
    flax_bytes = flax.serialization.msgpack_serialize({"c": leaf})
    assert b"__msgpack_chunked_array__" in flax_bytes
    assert flax_msgpack.dumps({"c": leaf}) == flax_bytes
    joined = flax_msgpack.loads(flax_bytes)["c"]
    assert torch.is_tensor(joined) and joined.shape == (5, 7)
    np.testing.assert_array_equal(joined.numpy(), leaf)
    np.testing.assert_array_equal(flax.serialization.msgpack_restore(
        flax_msgpack.dumps({"c": torch.from_numpy(leaf)}))["c"], leaf)


def test_codec_refuses_what_flax_never_writes():
    with pytest.raises(ValueError, match="not in the subset"):
        flax_msgpack.loads(b"\xc1")
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(b"\x01\x02")
    with pytest.raises(TypeError, match="cannot write"):
        flax_msgpack.dumps({"x": object()})


# ---------------------------------------------------------------------------
# the committed trained checkpoint
# ---------------------------------------------------------------------------

def test_structured_bundle_loads_as_the_from_jax_params_route():
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    from test_torch_structured import config
    port = SDModels.load(BUNDLE)
    jm = JModels.load(str(BUNDLE))
    meta = json.loads((BUNDLE / "bundle.json").read_text())
    cfgs = (config(UNetConfig, meta["unet_config"]),
            config(VAEConfig, meta["vae_config"]),
            config(CLIPTextConfig, meta["text_config"]))
    assert (port.unet_config, port.vae_config, port.text_config) == cfgs
    with torch.device("meta"):
        mods = (UNet2DCondition(cfgs[0]), AutoencoderKL(cfgs[1]),
                CLIPTextEncoder(cfgs[2]))
    for mod, part, cfg, got in zip(mods, ("unet", "vae", "text_encoder"),
                                   cfgs, (port.unet, port.vae,
                                          port.text_encoder)):
        load_state_dict(mod, from_jax_params(jm.params[part], cfg))
        mod.eval().requires_grad_(False)
        assert_trees_equal(mod.state_dict(), got.state_dict())
    route = SDModels(*cfgs, *mods, HashTokenizer(
        vocab_size=meta["tokenizer_vocab_size"]))
    assert port.tokenizer.vocab_size == meta["tokenizer_vocab_size"]
    assert port.dtype == torch.float32 and not port.tiled
    prompts = ["red circle", "blue stripes"] * 4
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (8, 16, 16, 4)).astype(np.float32))
    frames = []
    for models in (port, route):
        eng = Engine(models, CPU)
        frames.append(eng.denoise_frames(
            eng.embed_text(prompts), eng.embed_text(""), noise,
            num_inference_steps=10, guidance_scale=3.0))
    assert frames[0].std() > 0.05
    np.testing.assert_array_equal(frames[0], frames[1])


# ---------------------------------------------------------------------------
# port <-> JAX
# ---------------------------------------------------------------------------

def jax_config(cls, port_config):
    """The JAX config class filled with the port config's fields it has."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(port_config, f.name)
        if dataclasses.is_dataclass(v):
            from stable_diffusion_videos_tpu.models.safety import \
                CLIPVisionConfig
            v = jax_config(CLIPVisionConfig, v)
        kw[f.name] = v
    return cls(**kw)


def port_cases():
    tiny = SDModels.tiny(taesd=True, with_safety=True)
    xl = SDModels.tiny_xl()
    xl = dataclasses.replace(
        xl, tokenizer=TextualInversionTokenizer(xl.tokenizer,
                                                {"<cat>": [997, 996]}),
        tokenizer_2=TextualInversionTokenizer(xl.tokenizer_2,
                                              {"<cat>": [995]}))
    bf16 = SDModels.tiny(seed=3)
    for m in (bf16.unet, bf16.vae, bf16.text_encoder):
        m.to(torch.bfloat16)
    return {"tiny_safety_taesd": tiny, "tiny_xl_ti": xl,
            "tiled": SDModels.tiny(seed=2, tiled=True), "bf16": bf16}


def modules(m: SDModels) -> dict:
    """{component: state dict} of the port bundle, in JAX's names."""
    return {name: sd for name, (sd, _) in _state_dicts(m).items()}


def jax_bundle(port: SDModels):
    """The JAX package's bundle holding ``port``'s weights (its trees made
    by ``to_jax_params``, numpy, bf16 as ml_dtypes)."""
    from stable_diffusion_videos_tpu.core.schedulers import SchedulerConfig
    from stable_diffusion_videos_tpu.models import bundle as B
    from stable_diffusion_videos_tpu.models.safety import SafetyConfig as JS
    from stable_diffusion_videos_tpu.models.taesd import TAESDConfig as JT
    from stable_diffusion_videos_tpu.models.tokenizer import (
        HashTokenizer as JHash, TextualInversionTokenizer as JTI)
    params = {name: jax_tree(to_jax_params(sd, cfg))
              for name, (sd, cfg) in _state_dicts(port).items()}
    tok = JHash(vocab_size=port.text_config.vocab_size)
    if isinstance(port.tokenizer, TextualInversionTokenizer):
        tok = JTI(tok, port.tokenizer.triggers)
    return B.SDModels(
        jax_config(B.UNetConfig, port.unet_config),
        jax_config(B.VAEConfig, port.vae_config),
        jax_config(B.CLIPTextConfig, port.text_config), params, tok,
        SchedulerConfig(**dataclasses.asdict(port.scheduler_config)),
        safety_config=(jax_config(JS, port.safety.config)
                       if port.safety is not None else None),
        dtype=np.dtype(ml_dtypes.bfloat16 if port.dtype == torch.bfloat16
                       else np.float32),
        tiled=port.tiled,
        text_config_2=(jax_config(B.CLIPTextConfig, port.text_config_2)
                       if port.text_config_2 else None),
        taesd_config=(jax_config(JT, port.taesd.config)
                      if port.taesd is not None else None))


@pytest.fixture(scope="module")
def cases():
    return port_cases()


@pytest.mark.parametrize("case", ["tiny_safety_taesd", "tiny_xl_ti", "tiled",
                                  "bf16"])
def test_port_save_loads_in_jax(cases, case, tmp_path):
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    port = cases[case]
    port.save(tmp_path)
    jm = JModels.load(str(tmp_path))
    sds = modules(port)
    assert sorted(jm.params) == sorted(sds)
    for name, sd in sds.items():
        assert_trees_equal(jax_tree(jm.params[name]),
                           jax_tree(to_jax_params(sd, config_of(port, name))))
    assert jm.tiled == port.tiled
    assert str(jm.dtype) == str(port.dtype).split(".")[1]
    assert dataclasses.asdict(jm.unet_config) == dataclasses.asdict(
        port.unet_config)
    if isinstance(port.tokenizer, TextualInversionTokenizer):
        assert jm.tokenizer.triggers == port.tokenizer.triggers
        assert jm.tokenizer_2.triggers == port.tokenizer_2.triggers
    back = SDModels.load(tmp_path)
    for name, sd in modules(back).items():
        assert_trees_equal(sd, sds[name])
    assert back.tiled == port.tiled and back.dtype == port.dtype
    assert back.param_count() == port.param_count()
    assert type(back.tokenizer) is type(port.tokenizer)


def config_of(port: SDModels, name: str):
    return _state_dicts(port)[name][1]


def jax_tree(tree) -> dict:
    """A params tree with numpy leaves (tensors converted)."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return as_numpy(tree)


@pytest.mark.parametrize("case", ["tiny_safety_taesd", "tiny_xl_ti", "bf16"])
def test_jax_save_loads_in_the_port(cases, case, tmp_path):
    from stable_diffusion_videos_tpu.models.io import save_bundle
    port = cases[case]
    save_bundle(jax_bundle(port), tmp_path)
    got = SDModels.load(tmp_path)
    want = modules(port)
    assert sorted(modules(got)) == sorted(want)
    for name, sd in modules(got).items():
        assert_trees_equal(sd, want[name])
    assert got.dtype == port.dtype
    if port.safety is not None:
        # the JAX tower computes quick_gelu, which a bundle without the
        # port's key reads
        assert got.safety.config.vision.hidden_act == "quick_gelu"


def test_to_jax_params_has_the_jax_modules_paths_and_shapes():
    """Against ``jax.eval_shape`` of each JAX module's init: the UNet, the
    VAE, the text tower, the safety checker and both TAESD halves."""
    import jax
    import jax.numpy as jnp

    from stable_diffusion_videos_tpu.models import bundle as B
    from stable_diffusion_videos_tpu.models import safety as JS
    from stable_diffusion_videos_tpu.models import taesd as JT
    port = SDModels.tiny(taesd=True, with_safety=True)
    u = jax_config(B.UNetConfig, port.unet_config)
    v = jax_config(B.VAEConfig, port.vae_config)
    t = jax_config(B.CLIPTextConfig, port.text_config)
    s = jax_config(JS.SafetyConfig, port.safety.config)
    tc = jax_config(JT.TAESDConfig, port.taesd.config)
    img = u.sample_size * v.scale_factor
    inits = {
        "unet": lambda k: B.UNet2DCondition(u).init(
            k, jnp.zeros((1, u.sample_size, u.sample_size, 4)),
            jnp.zeros((1,)), jnp.zeros((1, 7, u.cross_attention_dim))),
        "vae": lambda k: B.AutoencoderKL(v).init(
            k, jnp.zeros((1, img, img, 3))),
        "text_encoder": lambda k: B.CLIPTextEncoder(t).init(
            k, jnp.zeros((1, 77), jnp.int32)),
        "safety_checker": lambda k: JS.SafetyChecker(s).init(
            k, jnp.zeros((1, s.vision.image_size, s.vision.image_size, 3))),
        "taesd_decoder": lambda k: JT.TAESDDecoder(tc).init(
            k, jnp.zeros((1, 4, 4, 4))),
        "taesd_encoder": lambda k: JT.TAESDEncoder(tc).init(
            k, jnp.zeros((1, 32, 32, 3))),
    }
    for name, (sd, cfg) in _state_dicts(port).items():
        want = jax.eval_shape(inits[name], jax.random.PRNGKey(0))
        got = to_jax_params(sd, cfg)
        want_shapes = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
                       jax.tree_util.tree_leaves_with_path(want)}
        got_shapes = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
                      jax.tree_util.tree_leaves_with_path(got)}
        assert got_shapes == want_shapes, name
    with pytest.raises(KeyError, match="no JAX path"):
        to_jax_params({**port.vae.state_dict(), "extra.weight":
                       torch.zeros(1)}, port.vae_config)


def test_gelu_tower_and_scheduler_fields_survive(tmp_path):
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    from stable_diffusion_videos_tpu.models.io import save_bundle
    cfg = SafetyConfig.tiny()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, hidden_act="gelu"))
    port = SDModels.tiny().with_safety_checker(
        SafetyChecker.random(cfg, 5, 0.1))
    port.save(tmp_path / "a")
    meta = json.loads((tmp_path / "a" / "bundle.json").read_text())
    assert "hidden_act" not in meta["safety_config"]["vision"]
    assert meta["safety_hidden_act"] == "gelu"
    back = SDModels.load(tmp_path / "a")
    assert back.safety.config == cfg
    assert JModels.load(str(tmp_path / "a")).safety_config is not None
    # the JAX scheduler's fields the port lacks, at values other than the
    # defaults: JAX -> port -> JAX keeps them
    jm = jax_bundle(SDModels.tiny())
    jm = dataclasses.replace(jm, scheduler_config=dataclasses.replace(
        jm.scheduler_config, solver_order=3, algorithm_type="dpmsolver",
        thresholding=True))
    save_bundle(jm, tmp_path / "j")
    port = SDModels.load(tmp_path / "j")
    assert port.bundle_scheduler_fields == dict(
        solver_order=3, algorithm_type="dpmsolver", thresholding=True)
    port.save(tmp_path / "p")
    again = JModels.load(str(tmp_path / "p"))
    assert dataclasses.asdict(again.scheduler_config) == dataclasses.asdict(
        jm.scheduler_config)
    assert json.loads((tmp_path / "p" / "bundle.json").read_text())[
        "scheduler_config"] == json.loads(
        (tmp_path / "j" / "bundle.json").read_text())["scheduler_config"]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_convert_through_the_cli(tmp_path, capsys):
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    from stable_diffusion_videos_tpu_torch.__main__ import main
    src = chip_smoke().write_checkpoint(SDModels.tiny(seed=4),
                                        tmp_path / "diffusers")
    main(["convert", "--checkpoint", str(src), "--out",
          str(tmp_path / "bundle")])
    out = capsys.readouterr().out
    assert str(tmp_path / "bundle") in out and "unet:" in out
    want = SDModels.from_pretrained(src)
    got = SDModels.load(tmp_path / "bundle")
    assert got.dtype == want.dtype == torch.bfloat16
    for name, sd in modules(want).items():
        assert_trees_equal(modules(got)[name], sd)
    assert got.tokenizer.encode("a fox") == want.tokenizer.encode("a fox")
    jm = JModels.load(str(tmp_path / "bundle"))
    assert sorted(jm.params) == ["text_encoder", "unet", "vae"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_quality_phase_keys_are_checked_on_the_card(monkeypatch, dtype):
    """The trained checkpoint's UNet at the batches ``chip_smoke.py``'s
    phase ``quality`` runs it at (CFG 16 and 2, cond-only and the gate's
    CFG 8, cond-only 1), its KL decoder at 8, 4 and 1 and its encoder at 1,
    recorded on the meta device: the kernel keys are exactly phase 3's
    quality rows, in either dtype."""
    from test_torch_encode import recorded_kernel_keys
    from test_torch_structured import config
    smoke = chip_smoke()
    meta = json.loads((BUNDLE / "bundle.json").read_text())
    ucfg = config(UNetConfig, meta["unet_config"])
    vcfg = config(VAEConfig, meta["vae_config"])
    with torch.device("meta"):
        unet = UNet2DCondition(ucfg).to(dtype)
        vae = AutoencoderKL(vcfg).to(dtype)
    h, e = ucfg.sample_size, dict(device="meta", dtype=dtype)

    def run():
        for b in (16, 8, 2, 1):
            unet(torch.empty(b, 4, h, h, **e), torch.empty(b, device="meta"),
                 torch.empty(b, 77, ucfg.cross_attention_dim, **e))
        for b in (8, 4, 1):
            vae.decode(torch.empty(b, 4, h, h, **e))
        vae.encode(torch.empty(1, 3, 2 * h, 2 * h, **e))
    attn, gn = recorded_kernel_keys(monkeypatch, run)
    assert attn == {(*s, dtype) for s in smoke.QUALITY_ATTN_SHAPES}
    assert gn == {(*c, dtype, dtype) for c in smoke.QUALITY_GN_SHAPES}
