"""LoRA and textual-inversion files, and the safetensors reader, on the
PyTorch package against the JAX package, on the CPU.

The reader against ``safetensors.numpy``/``safetensors.torch`` files (F32,
F16, BF16, I64, the metadata), exactly.  One LoRA file a format (kohya SD
1.x with Linear, 1x1 stored either way and LoCon 3x3 adapters and a text
tower; diffusers/peft ``lora_A``/``lora_B``; kohya SDXL with LDM block names
and both towers) merged by both packages and compared tensor by tensor
(fp32, 1e-6), the base bundle untouched; the trainer's ``.npz`` refused.
Textual-inversion files (A1111 ``.pt`` and ``.safetensors``, diffusers
``learned_embeds``, SDXL ``clip_l``/``clip_g``) applied by both: the same
token tables, vocabulary size and EOS id, and the engine's embeddings of a
trigger prompt within 1e-5.  The bundles are ``tests/test_torch_sdxl.py``'s.
"""

import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.lora_file import (
    apply_lora, ldm_unet_aliases, text_module_map, unet_module_map)
from stable_diffusion_videos_tpu_torch.models.textual_inversion import \
    apply_textual_inversion
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, read_safetensors)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sdxl import CPU, jax_models, load_port, xl_bundles  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

#: merged weights, fp32: the same sum of the same delta, reordered
MERGE_TOL = dict(atol=1e-6, rtol=1e-6)
#: the text towers, fp32
EMBED_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def sd1_bundles():
    port = SDModels.tiny()
    jm = jax_models(port)
    return jm, load_port(port, jm)


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.numpy import save_file as save_np
    from safetensors.torch import save_file as save_torch
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5), dtype=np.float32),
              "f16": rng.standard_normal((7,)).astype(np.float16),
              "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
              "scalar": np.array(2.5, np.float32),
              "empty": np.zeros((0, 4), np.float32)}
    save_np(arrays, str(tmp_path / "a.safetensors"),
            metadata={"format": "pt", "note": "x"})
    got, meta = read_safetensors(tmp_path / "a.safetensors")
    assert meta == {"format": "pt", "note": "x"}
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(got[k].numpy(), v)
    bf = {"bf16": torch.randn(4, 6, generator=torch.Generator()
                              .manual_seed(1)).to(torch.bfloat16)}
    save_torch(bf, str(tmp_path / "b.safetensors"))
    got, meta = read_safetensors(tmp_path / "b.safetensors")
    assert meta == {} and got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"], bf["bf16"])


def lora_pair(rng, weight_shape, rank: int = 4, flat_1x1: bool = False):
    """(down, up) of rank ``rank`` for a weight of ``weight_shape``: 2-D for
    a Linear (and, with ``flat_1x1``, a 1x1 convolution), LoCon for a
    k x k convolution."""
    out, inp = weight_shape[:2]
    spatial = tuple(weight_shape[2:])
    if flat_1x1 and spatial == (1, 1):
        spatial = ()
    down = rng.standard_normal((rank, inp) + spatial, dtype=np.float32) * 0.3
    up = rng.standard_normal((out, rank) + (1,) * len(spatial),
                             dtype=np.float32) * 0.3
    return down, up


def kohya_tensors(models, seed: int = 0, ldm: bool = False) -> dict:
    """A kohya file's tensors adapting every UNet module the map offers
    (the 1x1 convolutions stored flat on every other one), with alphas,
    and every text-tower projection (``lora_te_``, or ``lora_te1_`` and
    ``lora_te2_`` for two towers); with ``ldm`` the UNet blocks under
    their LDM names."""
    rng = np.random.default_rng(seed)
    out = {}
    names = {}
    if ldm:
        inverse = {d: a for a, d in ldm_unet_aliases(models.unet_config)
                   .items()}
        for name in unet_module_map(models.unet):
            hit = next((d for d in sorted(inverse, key=len, reverse=True)
                        if name == d or name.startswith(d + "_")), None)
            if hit is not None:
                names[name] = inverse[hit] + name[len(hit):]
    else:
        names = {n: n for n in unet_module_map(models.unet)}
    groups = [("lora_unet_", unet_module_map(models.unet), names)]
    if models.text_encoder_2 is None:
        groups.append(("lora_te_", text_module_map(models.text_encoder),
                       None))
    else:
        groups += [("lora_te1_", text_module_map(models.text_encoder), None),
                   ("lora_te2_", text_module_map(models.text_encoder_2),
                    None)]
    for prefix, mmap, rename in groups:
        for i, (name, mod) in enumerate(sorted(mmap.items())):
            if rename is not None and name not in rename:
                continue
            key = prefix + (rename[name] if rename else name)
            down, up = lora_pair(rng, tuple(mod.weight.shape),
                                 flat_1x1=i % 2 == 0)
            out[f"{key}.lora_down.weight"] = down
            out[f"{key}.lora_up.weight"] = up
            if i % 3:
                out[f"{key}.alpha"] = np.array(2.0 + i % 3, np.float32)
    return out


def peft_tensors(models, seed: int = 1) -> dict:
    """A diffusers/peft file: ``unet.<dotted>.lora_A/lora_B`` on the
    attention projections and ``text_encoder.<dotted>`` on the tower."""
    rng = np.random.default_rng(seed)
    out = {}
    for group, mmap in (("unet", unet_module_map(models.unet)),
                        ("text_encoder",
                         text_module_map(models.text_encoder))):
        for name, mod in sorted(mmap.items()):
            if group == "unet" and "attn" not in name:
                continue
            dotted = dict(models.unet.named_modules() if group == "unet"
                          else models.text_encoder.named_modules())
            path = next(k for k, v in dotted.items() if v is mod)
            down, up = lora_pair(rng, tuple(mod.weight.shape))
            out[f"{group}.{path}.lora_A.weight"] = down
            out[f"{group}.{path}.lora_B.weight"] = up
    return out


def save(tmp_path, tensors, name="lora.safetensors"):
    from safetensors.numpy import save_file
    path = tmp_path / name
    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()},
              str(path))
    return path


def assert_merged_match(jmm, pmm, parts):
    for part, module, cfg in parts:
        want = from_jax_params(jmm.params[part], cfg)
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]).reshape(
                v.shape), **MERGE_TOL, err_msg=f"{part}.{k}")


@pytest.mark.parametrize("fmt", ["kohya", "peft"])
def test_lora_merge_matches_jax(sd1_bundles, tmp_path, fmt):
    from stable_diffusion_videos_tpu.models.lora_file import \
        apply_lora as jax_apply
    jm, pm = sd1_bundles
    tensors = (kohya_tensors(pm) if fmt == "kohya" else peft_tensors(pm))
    path = save(tmp_path, tensors)
    before = {k: v.clone() for k, v in pm.unet.state_dict().items()}
    merged = apply_lora(pm, path, scale=0.7)
    assert_merged_match(jax_apply(jm, path, scale=0.7), merged,
                        [("unet", merged.unet, pm.unet_config),
                         ("text_encoder", merged.text_encoder,
                          pm.text_config)])
    changed = [k for k, v in merged.unet.state_dict().items()
               if not torch.equal(v, before[k])]
    assert changed
    for k, v in pm.unet.state_dict().items():
        assert torch.equal(v, before[k]), k  # the base is untouched


def test_kohya_xl_ldm_names_match_jax(xl_bundles, tmp_path):  # noqa: F811
    from stable_diffusion_videos_tpu.models.lora_file import \
        apply_lora as jax_apply
    jm, pm = xl_bundles
    tensors = kohya_tensors(pm, seed=3, ldm=True)
    blocks = {k.split("_")[2] for k in tensors if k.startswith("lora_unet_")}
    assert blocks == {"input", "middle", "output"}
    path = save(tmp_path, tensors)
    merged = apply_lora(pm, path)
    assert not torch.equal(merged.unet.mid_block.resnets[0].conv1.weight,
                           pm.unet.mid_block.resnets[0].conv1.weight)
    assert_merged_match(jax_apply(jm, path), merged,
                        [("unet", merged.unet, pm.unet_config),
                         ("text_encoder", merged.text_encoder,
                          pm.text_config),
                         ("text_encoder_2", merged.text_encoder_2,
                          pm.text_config_2)])


def test_unmatched_and_trainer_files_are_refused(sd1_bundles, tmp_path):
    _, pm = sd1_bundles
    path = save(tmp_path, {
        "lora_unet_no_such_module.lora_down.weight": np.ones((2, 3),
                                                             np.float32),
        "lora_unet_no_such_module.lora_up.weight": np.ones((3, 2),
                                                           np.float32)})
    with pytest.raises(ValueError, match="no LoRA module matched"):
        apply_lora(pm, path)
    with pytest.raises(NotImplementedError, match="item 27"):
        apply_lora(pm, tmp_path / "trainer.npz")


def ti_file(tmp_path, fmt: str, widths) -> tuple:
    """A textual-inversion file of ``fmt`` -> (path, trigger)."""
    rng = np.random.default_rng(5)
    vec = {w: rng.standard_normal((2, w), dtype=np.float32) for w in widths}
    if fmt == "a1111_pt":
        path = tmp_path / "emb.pt"
        torch.save({"string_to_param": {"*": torch.from_numpy(
            vec[widths[0]])}, "name": "<mystyle>"}, path)
        return path, "<mystyle>"
    if fmt == "learned_embeds":
        path = tmp_path / "learned_embeds.bin"
        torch.save({"<cat-toy>": torch.from_numpy(vec[widths[0]][0])}, path)
        return path, "<cat-toy>"
    if fmt == "a1111_safetensors":
        return save(tmp_path, {"emb_params": vec[widths[0]]},
                    "stylish.safetensors"), "stylish"
    return save(tmp_path, {"clip_l": vec[widths[0]], "clip_g": vec[widths[1]]},
                "xlstyle.safetensors"), "xlstyle"


@pytest.mark.parametrize("fmt", ["a1111_pt", "learned_embeds",
                                 "a1111_safetensors", "sdxl"])
def test_textual_inversion_matches_jax(sd1_bundles, xl_bundles,  # noqa: F811
                                       tmp_path, fmt):
    from stable_diffusion_videos_tpu.models.textual_inversion import \
        apply_textual_inversion as jax_apply
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = xl_bundles if fmt == "sdxl" else sd1_bundles
    widths = ((pm.text_config.hidden_size, pm.text_config_2.hidden_size)
              if fmt == "sdxl" else (pm.text_config.hidden_size,))
    path, trigger = ti_file(tmp_path, fmt, widths)
    jmm, pmm = jax_apply(jm, path), apply_textual_inversion(pm, path)
    towers = [("text_encoder", pmm.text_encoder, pmm.text_config,
               jmm.text_config)]
    if fmt == "sdxl":
        towers.append(("text_encoder_2", pmm.text_encoder_2,
                       pmm.text_config_2, jmm.text_config_2))
    for part, enc, cfg, jcfg in towers:
        table = enc.text_model.embeddings.token_embedding.weight
        np.testing.assert_array_equal(
            table.numpy(), np.asarray(jmm.params[part]["params"]
                                      ["token_embedding"]["embedding"]))
        assert (cfg.vocab_size, cfg.eos_token_id) == (jcfg.vocab_size,
                                                      jcfg.eos_token_id)
    prompt = f"a photo in {trigger} style"
    ids = pmm.tokenizer([prompt])["input_ids"]
    np.testing.assert_array_equal(ids, jmm.tokenizer([prompt])["input_ids"])
    assert ids.max() >= pm.text_config.vocab_size  # the trigger's new rows
    jeng, eng = JEngine(jmm, batch_bucket=8), Engine(pmm, CPU)
    np.testing.assert_allclose(eng.embed_text(prompt).float().numpy(),
                               np.asarray(jeng.embed_text(prompt)),
                               **EMBED_TOL)
    if fmt == "sdxl":
        np.testing.assert_allclose(eng.embed_text_pooled(prompt).numpy(),
                                   np.asarray(jeng.embed_text_pooled(prompt)),
                                   **EMBED_TOL)
    # the base bundle keeps its table and tokenizer
    assert (pm.text_encoder.text_model.embeddings.token_embedding.weight
            .shape[0] == pm.text_config.vocab_size)
    assert pm.tokenizer([prompt])["input_ids"].max() < \
        pm.text_config.vocab_size
