"""``from_pretrained`` on the PyTorch package against the JAX package's, on
the CPU.

Diffusers-layout directories are written from the JAX package's exporters
(``export_unet``, ``export_vae``, ``export_text_encoder``) with
``safetensors.numpy``: SD 1.x tiny, an SD 2.x-shaped one (per-level heads,
exact GELU, the Linear ``proj_in``/``proj_out`` layout, v-prediction),
``tiny_xl`` (two towers) and the refiner's bigG-only layout.  Each is loaded
by both packages' ``from_pretrained``, and one engine dispatch of each,
embeddings from each package's own tokenizer and towers, agrees in fp32
within 1e-4.  Single original-layout files are built with
``tests/test_ldm.py``'s hand tables and loaded both ways: every parameter
within 1e-4.  ``tiled=True`` frames agree with the JAX package's tiled
bundle and differ from untiled ones.  ``resolve_checkpoint``: a hub id
(``snapshot_download`` replaced), the offline error and a bogus path.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.clip_text import CLIPTextConfig
from stable_diffusion_videos_tpu_torch.models.lora_file import parse_lora_arg
from stable_diffusion_videos_tpu_torch.models.textual_inversion import \
    parse_ti_arg
from stable_diffusion_videos_tpu_torch.models.unet import UNetConfig
from stable_diffusion_videos_tpu_torch.models.vae import VAEConfig
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, resolve_checkpoint)
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_ldm import (_ldm_unet_sd, _ldm_vae_sd, _openclip_text_sd,
                      _save_single_file, _write_tokenizer)
from test_torch_sdxl import jax_models
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPTS = ["a b", "ab a"]


# ---------------------------------------------------------------------------
# diffusers-layout directories from the JAX package's exporters
# ---------------------------------------------------------------------------

def unet_json(cfg) -> dict:
    out = dict(
        sample_size=cfg.sample_size, in_channels=cfg.in_channels,
        out_channels=cfg.out_channels,
        block_out_channels=list(cfg.block_out_channels),
        layers_per_block=cfg.layers_per_block,
        cross_attention_dim=cfg.cross_attention_dim,
        attention_head_dim=(cfg.attention_head_dim
                            if isinstance(cfg.attention_head_dim, int)
                            else list(cfg.attention_head_dim)),
        down_block_types=["CrossAttnDownBlock2D" if a else "DownBlock2D"
                          for a in cfg.attn_levels],
        transformer_layers_per_block=(
            cfg.transformer_depth if isinstance(cfg.transformer_depth, int)
            else list(cfg.transformer_depth)),
        flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift)
    if cfg.addition_embed_dim is not None:
        out.update(addition_embed_type="text_time",
                   addition_time_embed_dim=cfg.addition_embed_dim,
                   projection_class_embeddings_input_dim=(
                       cfg.addition_pooled_dim
                       + cfg.addition_num_ids * cfg.addition_embed_dim))
    return out


def vae_json(cfg) -> dict:
    return dict(in_channels=cfg.in_channels, out_channels=cfg.out_channels,
                latent_channels=cfg.latent_channels,
                block_out_channels=list(cfg.block_out_channels),
                layers_per_block=cfg.layers_per_block,
                scaling_factor=cfg.scaling_factor)


def text_json(cfg) -> dict:
    out = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
               intermediate_size=cfg.intermediate_size,
               num_hidden_layers=cfg.num_layers,
               num_attention_heads=cfg.num_heads,
               max_position_embeddings=cfg.max_position_embeddings,
               hidden_act=cfg.hidden_act)
    if cfg.projection_dim is not None:
        out["projection_dim"] = cfg.projection_dim
    return out


def write_part(root, sub, config: dict, sd: dict):
    from safetensors.numpy import save_file
    d = root / sub
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(config))
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()},
              str(d / "diffusion_pytorch_model.safetensors"))


def write_tokenizer(root, sub):
    d = root / sub
    d.mkdir(parents=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2,
             "b</w>": 3, "ab</w>": 4}
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\na b</w>\n")


def write_diffusers_dir(root, jm, scheduler: dict, linear_proj=False,
                        tower1=True):
    """The JAX bundle ``jm`` as a diffusers checkpoint directory;
    ``linear_proj`` stores the transformers' proj_in/proj_out as Linear
    weights (SD 2.x, SDXL); ``tower1=False`` writes tower 2 alone (the
    refiner)."""
    from stable_diffusion_videos_tpu.models.weights import (
        export_text_encoder, export_unet, export_vae)
    unet = export_unet(jm.params["unet"], jm.unet_config)
    if linear_proj:
        unet = {k: (v[:, :, 0, 0] if k.endswith((".proj_in.weight",
                                                  ".proj_out.weight"))
                    else v) for k, v in unet.items()}
    write_part(root, "unet", unet_json(jm.unet_config), unet)
    write_part(root, "vae", vae_json(jm.vae_config),
               export_vae(jm.params["vae"], jm.vae_config))
    towers = [("text_encoder", "tokenizer", "text_encoder", jm.text_config)]
    if jm.text_config_2 is not None:
        towers.append(("text_encoder_2", "tokenizer_2", "text_encoder_2",
                       jm.text_config_2))
    if not tower1:
        towers = towers[1:]
    for sub, tok, part, cfg in towers:
        write_part(root, sub, text_json(cfg),
                   export_text_encoder(jm.params[part], cfg))
        write_tokenizer(root, tok)
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(
        json.dumps(scheduler))
    return root


def sd2_port() -> SDModels:
    """An SD 2.x-shaped tiny bundle: per-level heads (2, 4) with attention
    at both levels (``tests/test_weights.py``'s geometry), a 16-wide
    OpenCLIP-style tower (exact GELU), v-prediction."""
    from stable_diffusion_videos_tpu_torch.core.schedulers import \
        SchedulerConfig
    return SDModels.build(
        UNetConfig(sample_size=8, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=16,
                   attention_head_dim=(2, 4), attn_levels=(True, True)),
        VAEConfig.tiny(),
        CLIPTextConfig(vocab_size=1000, hidden_size=16, intermediate_size=32,
                       num_layers=2, num_heads=2, hidden_act="gelu"),
        0, 0.1, torch.float32,
        scheduler_config=SchedulerConfig(prediction_type="v_prediction"))


def refiner_jax():
    jm = jax_models(SDModels.tiny_refiner())
    jm.params["text_encoder"] = jm.params["text_encoder_2"]
    return jm


LAYOUTS = {
    # name: (JAX bundle maker, scheduler config, sampler, writer kwargs)
    "sd1": (lambda: jax_models(SDModels.tiny()), {}, "pndm", {}),
    "sd2": (lambda: jax_models(sd2_port()),
            dict(prediction_type="v_prediction", timestep_spacing="leading"),
            "ddim", dict(linear_proj=True)),
    "sdxl": (lambda: jax_models(SDModels.tiny_xl()), {}, "pndm",
             dict(linear_proj=True)),
    "refiner": (refiner_jax, {}, "ddim", dict(linear_proj=True,
                                              tower1=False)),
}


def dispatch(engine, prompts, noise, xl: bool, **run):
    kw = {}
    if xl:
        kw = dict(pooled=engine.embed_text_pooled(prompts))
    return np.asarray(engine.denoise_frames(
        engine.embed_text(prompts), engine.embed_text(""), noise, **kw,
        **run))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_diffusers_directory_matches_jax(layout, tmp_path):
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    make, sched, sampler, write_kw = LAYOUTS[layout]
    root = write_diffusers_dir(tmp_path / layout, make(), sched, **write_kw)
    jm = JModels.from_pretrained(str(root), dtype=jnp.float32)
    pm = SDModels.from_pretrained(root, dtype=torch.float32)
    assert pm.unet_config == UNetConfig(**dataclasses.asdict(jm.unet_config))
    assert pm.vae_config.scaling_factor == jm.vae_config.scaling_factor
    assert pm.scheduler_config.prediction_type == \
        jm.scheduler_config.prediction_type
    assert pm.is_xl == jm.is_xl and not pm.tiled
    if layout == "refiner":
        assert pm.text_encoder is pm.text_encoder_2
        assert pm.tokenizer_2.pad_token_id == 0
    noise = np.random.default_rng(3).standard_normal(
        (2, 8, 8, 4)).astype(np.float32)
    run = dict(num_inference_steps=3, guidance_scale=3.0)
    want = dispatch(JEngine(jm, scheduler=sampler, batch_bucket=8), PROMPTS,
                    jnp.asarray(noise), jm.is_xl, **run)
    got = dispatch(Engine(pm, CPU, scheduler=sampler, batch_bucket=8),
                   PROMPTS, noise, pm.is_xl, **run)
    assert got.shape == want.shape == (2, 16, 16, 3) and got.std() > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_pipeline_from_pretrained_with_adapters(tmp_path):
    """The pipeline's ``from_pretrained`` on a directory, with a LoRA file
    (path, scale) and a textual-inversion file merged, on the CPU."""
    from safetensors.numpy import save_file
    root = write_diffusers_dir(tmp_path / "sd1",
                               jax_models(SDModels.tiny()), {})
    rng = np.random.default_rng(5)
    mod = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1"
    lora = tmp_path / "l.safetensors"
    save_file({f"{mod}_to_q.lora_down.weight":
               rng.standard_normal((2, 32)).astype(np.float32),
               f"{mod}_to_q.lora_up.weight":
               rng.standard_normal((32, 2)).astype(np.float32)}, str(lora))
    ti = tmp_path / "ti.safetensors"
    save_file({"emb_params": rng.standard_normal((1, 32))
               .astype(np.float32)}, str(ti))
    plain = StableDiffusionWalkPipeline.from_pretrained(
        root, device="cpu", dtype=torch.float32, safety=False)
    pipe = StableDiffusionWalkPipeline.from_pretrained(
        root, device="cpu", dtype=torch.float32, safety=False,
        lora=[(str(lora), 0.5)], textual_inversion=[(str(ti), "<cat>")])
    assert pipe.device == CPU
    q = ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q."
         "weight")
    delta = pipe.models.unet.state_dict()[q] - plain.models.unet.state_dict()[q]
    assert 0 < float(delta.abs().max())
    assert pipe.models.text_encoder.config.vocab_size == 1001
    assert parse_lora_arg("x.safetensors:0.7") == ("x.safetensors", 0.7)
    assert parse_lora_arg("C:/x.safetensors") == ("C:/x.safetensors", 1.0)
    assert parse_ti_arg("e.pt:<cat>") == ("e.pt", "<cat>")
    assert parse_ti_arg("C:/e.pt") == ("C:/e.pt", None)


# ---------------------------------------------------------------------------
# single original-layout files
# ---------------------------------------------------------------------------

def _hf(sd: dict) -> dict:
    return {k: np.asarray(v) for k, v in sd.items()}


def single_file(tmp_path, family: str):
    """(path, JAX bundle, the overrides the tiny geometry needs) of one
    original-layout file."""
    from stable_diffusion_videos_tpu.models.weights import (
        export_text_encoder, export_unet, export_vae)
    if family == "sd1":
        jm = jax_models(SDModels.tiny())
    elif family == "sd2":
        # the tiny UNet (the hand tables' geometry) under an OpenCLIP-style
        # tower, fused q/k/v and one unused last layer in the file
        jm = jax_models(SDModels.build(
            UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny_v2(), 0,
            0.1, torch.float32))
    else:
        jm = jax_models(SDModels.tiny_xl())
    flat = {}
    flat.update({f"model.diffusion_model.{k}": v for k, v in _ldm_unet_sd(
        export_unet(jm.params["unet"], jm.unet_config),
        xl=family == "sdxl").items()})
    flat.update({f"first_stage_model.{k}": v for k, v in _ldm_vae_sd(
        export_vae(jm.params["vae"], jm.vae_config)).items()})
    text = _hf(export_text_encoder(jm.params["text_encoder"],
                                   jm.text_config))
    over = dict(unet_overrides=dict(
        attention_head_dim=jm.unet_config.attention_head_dim,
        sample_size=8),
        text_overrides=dict(num_heads=jm.text_config.num_heads,
                            hidden_act=jm.text_config.hidden_act))
    if family == "sd1":
        flat.update({f"cond_stage_model.transformer.{k}": v
                     for k, v in text.items()})
    elif family == "sd2":
        flat.update({f"cond_stage_model.model.{k}": v for k, v in
                     _openclip_text_sd(text, jm.text_config.num_layers)
                     .items()})
    else:
        flat.update({f"conditioner.embedders.0.transformer.{k}": v
                     for k, v in text.items()})
        t2 = _hf(export_text_encoder(jm.params["text_encoder_2"],
                                     jm.text_config_2))
        flat.update({f"conditioner.embedders.1.model.{k}": v for k, v in
                     _openclip_text_sd(t2, jm.text_config_2.num_layers,
                                       extra_unused_layer=False).items()})
        over["text2_overrides"] = dict(
            num_heads=jm.text_config_2.num_heads,
            hidden_act=jm.text_config_2.hidden_act)
        # the tiny text_time widths, which shapes alone do not pin
        over["unet_overrides"].update(
            addition_embed_dim=jm.unet_config.addition_embed_dim,
            addition_pooled_dim=jm.unet_config.addition_pooled_dim,
            addition_num_ids=jm.unet_config.addition_num_ids)
    return _save_single_file(tmp_path, flat), jm, over


@pytest.mark.parametrize("family", ["sd1", "sd2", "sdxl"])
def test_single_file_matches_jax(family, tmp_path):
    from stable_diffusion_videos_tpu.models.ldm import \
        load_ldm_checkpoint as jax_load
    from stable_diffusion_videos_tpu_torch.models.ldm import \
        load_ldm_checkpoint
    path, _, over = single_file(tmp_path, family)
    tok = _write_tokenizer(tmp_path)
    jm = jax_load(path, tokenizer_dir=tok, dtype=jnp.float32, **over)
    pm = load_ldm_checkpoint(path, tokenizer_dir=tok, dtype=torch.float32,
                             **over)
    assert pm.unet_config == UNetConfig(**dataclasses.asdict(jm.unet_config))
    assert pm.text_config == CLIPTextConfig(
        **dataclasses.asdict(jm.text_config))
    parts = [(pm.unet, "unet", pm.unet_config),
             (pm.vae, "vae", pm.vae_config),
             (pm.text_encoder, "text_encoder", pm.text_config)]
    if family == "sdxl":
        parts.append((pm.text_encoder_2, "text_encoder_2", pm.text_config_2))
        assert pm.tokenizer_2.pad_token_id == 0
    for module, part, cfg in parts:
        want = from_jax_params(jm.params[part], cfg)
        got = module.state_dict()
        assert sorted(got) == sorted(want), part
        for k in want:
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
                err_msg=f"{part} {k}", **TOL)
    if family != "sdxl":  # the tiny text_time widths need the overrides
        via_bundle = SDModels.from_pretrained(path, tokenizer_dir=tok,
                                              dtype=torch.float32)
        assert via_bundle.unet_config.block_out_channels == (32, 64)
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        load_ldm_checkpoint(path)


# ---------------------------------------------------------------------------
# tiled: circular convolutions
# ---------------------------------------------------------------------------

def test_tiled_matches_jax_and_differs_from_untiled(tmp_path):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm = dataclasses.replace(jax_models(SDModels.tiny()), tiled=True)
    root = write_diffusers_dir(tmp_path / "sd1",
                               dataclasses.replace(jm, tiled=False), {})
    pm = SDModels.from_pretrained(root, dtype=torch.float32, tiled=True)
    assert pm.tiled
    assert pm.vae.encoder.down_blocks[0].downsamplers[0].conv.padding_mode \
        == "circular"
    noise = np.random.default_rng(4).standard_normal(
        (2, 8, 8, 4)).astype(np.float32)
    run = dict(num_inference_steps=3, guidance_scale=3.0)
    want = dispatch(JEngine(jm, batch_bucket=8), PROMPTS, jnp.asarray(noise),
                    False, **run)
    got = dispatch(Engine(pm, CPU, batch_bucket=8), PROMPTS, noise, False,
                   **run)
    np.testing.assert_allclose(got, want, **TOL)
    untiled = dispatch(Engine(SDModels.from_pretrained(
        root, dtype=torch.float32), CPU, batch_bucket=8), PROMPTS, noise,
        False, **run)
    assert np.abs(got - untiled).max() > 1e-2
    # the encoder's downsample wraps (1, 1) under tiled, as the JAX
    # package's: a 2-periodic image encodes to latents of one period
    img = np.tile(np.random.default_rng(5).uniform(-1, 1, (1, 8, 8, 3)),
                  (1, 2, 2, 1)).astype(np.float32)
    lat = Engine(pm, CPU).encode_image(img).numpy()
    np.testing.assert_allclose(lat[:, :4], lat[:, 4:], atol=1e-5)
    jlat = np.asarray(JEngine(jm, batch_bucket=8).encode_image(
        jnp.asarray(img)))
    np.testing.assert_allclose(lat, jlat, **TOL)


def test_tiny_tiled_pipeline_records_tiled(tmp_path):
    models = SDModels.tiny(tiled=True)
    assert models.tiled
    assert models.unet.conv_in.padding_mode == "circular"
    assert models.unet.down_blocks[0].resnets[0].conv_shortcut is None \
        or models.unet.down_blocks[0].resnets[0].conv_shortcut \
        .padding_mode == "zeros"
    pipe = StableDiffusionWalkPipeline(models, CPU, safety=False)
    run = pipe.walk(prompts=["a", "b"], seeds=[1, 2],
                    num_interpolation_steps=2, num_inference_steps=2,
                    output_dir=str(tmp_path), name="t", make_video=False)
    cfg = json.loads((tmp_path / "t" / "prompt_config.json").read_text())
    assert cfg["tiled"] is True and run.endswith("t")


# ---------------------------------------------------------------------------
# resolve_checkpoint
# ---------------------------------------------------------------------------

def test_resolve_checkpoint_hub_id(monkeypatch, tmp_path):
    import huggingface_hub
    calls = {}

    def fake_snapshot_download(repo_id, revision=None, cache_dir=None,
                               allow_patterns=None):
        calls.update(repo_id=repo_id, allow_patterns=allow_patterns)
        return str(tmp_path)

    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        fake_snapshot_download)
    assert resolve_checkpoint("org/model-v1") == tmp_path
    assert calls["repo_id"] == "org/model-v1"
    assert "*.safetensors" in calls["allow_patterns"]


def test_resolve_checkpoint_offline_error(monkeypatch):
    import huggingface_hub

    def boom(*a, **k):
        raise ConnectionError("no network")

    monkeypatch.setattr(huggingface_hub, "snapshot_download", boom)
    with pytest.raises(FileNotFoundError, match="offline or repo missing"):
        resolve_checkpoint("org/model-v1")


def test_resolve_checkpoint_local_and_bogus(tmp_path, monkeypatch):
    import sys
    assert resolve_checkpoint(str(tmp_path)) == tmp_path
    with pytest.raises(FileNotFoundError, match="neither a local"):
        resolve_checkpoint("/no/such/dir/anywhere")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError, match="not installed"):
        resolve_checkpoint("org/model-v1")
