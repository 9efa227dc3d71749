"""The NSFW safety checker in the PyTorch package against the JAX package's.

``preprocess_for_safety`` (bilinear, antialiased when it shrinks) at a
downscale (64 -> 32), an upscale (16 -> 32) and a non-square frame, fp32
1e-5; the tiny checker's pooled tower output (1e-4) and its flags on the
same weights (a JAX tree drawn from a numpy seed, ``from_jax_params``)
with planted concepts: concept 0 is frame 0's embedding, its threshold
midway to the nearest other frame (flagged, the others clear by a margin);
concept 1 is frame 1's embedding at a threshold 0.005 above its cosine,
reached only through the special-care hit (special 0 is frame 1's
embedding) that lowers every concept threshold by 0.01; and
``adjustment``.  ``Engine.check_safety`` against the JAX engine's, and the
checker loaded from diffusers ``StableDiffusionSafetyChecker`` names
against the JAX converter of the same file.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.safety import (
    CLIPVisionConfig, SafetyChecker, SafetyConfig, load_safety_checker,
    preprocess_for_safety)
from stable_diffusion_videos_tpu_torch.models.weights import from_jax_params
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sampler_engines import tiny_bundles
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def jax_checker_tree(seed: int = 0) -> dict:
    """The JAX tiny checker's tree, every parameter N(0, 0.2) from a numpy
    seed but the LayerNorms' (scale 1, bias 0, as ``SafetyChecker.random``
    leaves them: random norms embed distinct frames alike)."""
    from stable_diffusion_videos_tpu.models import safety as J
    cfg = J.SafetyConfig.tiny()
    pix = jnp.zeros((1, 32, 32, 3))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        names = [getattr(k, "key", "") for k in path]
        if any("norm" in n or "layrnorm" in n for n in names[:-1]):
            return np.full(s.shape, names[-1] == "scale", np.float32)
        return rng.standard_normal(s.shape, dtype=np.float32) * 0.2
    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda k: J.SafetyChecker(cfg).init(k, pix),
                             jax.random.PRNGKey(0)))


def safety_frames(n: int = 4, side: int = 16) -> np.ndarray:
    """Distinct frames: a gradient, a checkerboard, noise, stripes."""
    y, x = np.mgrid[0:side, 0:side] / (side - 1)
    rng = np.random.default_rng(11)
    out = [np.stack([x, y, 1 - x], -1),
           np.repeat(((np.indices((side, side)).sum(0) // 2) % 2)[..., None],
                     3, -1),
           rng.random((side, side, 3)),
           np.stack([np.sin(9 * x) ** 2, np.cos(5 * y) ** 2, x * y], -1)]
    return np.stack(out[:n]).astype(np.float32)


def port_checker(tree) -> SafetyChecker:
    return SafetyChecker.build(SafetyConfig.tiny(),
                               from_jax_params(tree, SafetyConfig.tiny()))


@pytest.fixture(scope="module")
def planted():
    """(tree, frames): the concepts planted as the module docstring says,
    from the port's embeddings (fp32), with their margins asserted."""
    tree = jax_checker_tree()
    imgs = safety_frames()
    with torch.no_grad():
        emb = port_checker(tree).embed(preprocess_for_safety(
            torch.from_numpy(imgs), 32)).numpy()
    cos = emb @ emb.T
    p = tree["params"]
    p["concept_embeds_weights"][:] = 2.0           # never reached
    p["special_care_embeds_weights"][:] = 2.0
    p["concept_embeds"][0] = emb[0]
    near0 = np.delete(cos[0], 0).max()
    assert 1.0 - near0 > 0.04, near0
    p["concept_embeds_weights"][0] = (1.0 + near0) / 2
    p["special_care_embeds"][0] = emb[1]
    near1 = np.delete(cos[1], 1).max()
    assert 1.0 - near1 > 0.04, near1
    p["special_care_embeds_weights"][0] = (1.0 + near1) / 2
    p["concept_embeds"][1] = emb[1]
    p["concept_embeds_weights"][1] = cos[1, 1] + 0.005
    assert np.delete(cos[1], 1).max() < cos[1, 1] - 0.02
    return tree, imgs


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 16, 16, 3),
                                   (1, 48, 40, 3)])
def test_preprocess_matches_jax(shape):
    from stable_diffusion_videos_tpu.models.safety import \
        preprocess_for_safety as jpre
    x = np.random.default_rng(2).random(shape, dtype=np.float32)
    got = preprocess_for_safety(torch.from_numpy(x), 32)
    want = np.asarray(jpre(jnp.asarray(x), 32)).transpose(0, 3, 1, 2)
    assert got.shape == (shape[0], 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_tower_and_flags_match_jax(planted):
    from stable_diffusion_videos_tpu.models import safety as J
    tree, imgs = planted
    pix = preprocess_for_safety(torch.from_numpy(imgs), 32)
    jpix = jnp.asarray(pix.numpy().transpose(0, 2, 3, 1))
    checker = port_checker(tree)
    with torch.no_grad():
        pooled = checker.vision_model(pix).numpy()
        flags = {adj: checker(pix, adj).numpy() for adj in (0.0, -0.01)}
    want_pooled = J.CLIPVisionEncoder(J.SafetyConfig.tiny().vision).apply(
        {"params": tree["params"]["vision_model"]}, jpix)
    np.testing.assert_allclose(pooled, np.asarray(want_pooled), **MODEL_TOL)
    jchecker = J.SafetyChecker(J.SafetyConfig.tiny())
    for adj, want in ((0.0, [True, True, False, False]),
                      (-0.01, [True, False, False, False])):
        np.testing.assert_array_equal(flags[adj], want)
        np.testing.assert_array_equal(
            np.asarray(jchecker.apply(tree, jpix, adj)), want)


def test_engine_check_safety_matches_jax(planted):
    """Both engines on frames at the tiny bundle's 16² (upscaled to the
    checker's 32), with one frame repeated; the head stays fp32."""
    from stable_diffusion_videos_tpu.models import safety as J
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    tree, imgs = planted
    jm, pm = tiny_bundles()
    jm = dataclasses.replace(jm, safety_config=J.SafetyConfig.tiny(),
                             params={**jm.params, "safety_checker": tree})
    pm = pm.with_safety_checker(port_checker(tree))
    assert pm.safety.concept_embeds.dtype == torch.float32
    batch = np.concatenate([imgs, imgs[2:3]])
    got = Engine(pm, CPU).check_safety(batch)
    want = JEngine(jm, batch_bucket=8).check_safety(batch)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  [True, True, False, False, False])
    plain = Engine(tiny_bundles()[1], CPU).check_safety(batch)
    assert not plain.any() and plain.shape == (5,)


def test_load_from_diffusers_names(planted, tmp_path):
    """A diffusers ``safety_checker`` directory (config.json with its
    vision_config, weights under StableDiffusionSafetyChecker's names and
    transformers' position_ids buffer) loads into the port, and the JAX
    converter reads the same names into the same checker."""
    from stable_diffusion_videos_tpu.models import safety as J
    from stable_diffusion_videos_tpu.models.weights import \
        convert_safety_checker
    from safetensors.torch import save_file
    tree, imgs = planted
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          from_jax_params(tree, SafetyConfig.tiny()).items()}
    assert "vision_model.vision_model.encoder.layers.1.mlp.fc2.weight" in sd
    assert {"visual_projection.weight", "concept_embeds",
            "special_care_embeds_weights"} <= set(sd)
    sd["vision_model.vision_model.embeddings.position_ids"] = torch.arange(
        17)[None]
    v = CLIPVisionConfig.tiny()
    (tmp_path / "config.json").write_text(json.dumps({
        "projection_dim": v.projection_dim, "vision_config": {
            "image_size": v.image_size, "patch_size": v.patch_size,
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads}}))
    save_file(sd, str(tmp_path / "model.safetensors"))
    checker = load_safety_checker(tmp_path)
    assert checker.config == SafetyConfig.tiny()
    pix = preprocess_for_safety(torch.from_numpy(imgs), 32)
    jparams = convert_safety_checker(
        {k: v.numpy() for k, v in sd.items()}, J.SafetyConfig.tiny())
    with torch.no_grad():
        got = checker(pix).numpy()
    want = J.SafetyChecker(J.SafetyConfig.tiny()).apply(
        jparams, jnp.asarray(pix.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, [True, True, False, False])


@pytest.fixture
def cuda():
    """The card, with TF32 off for the test (cuDNN and cuBLAS would
    otherwise run fp32 convolutions and matmuls in TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = before


@pytest.mark.cuda
def test_checker_on_the_card(cuda):
    """fp32 on the card against the CPU: the embedding 1e-4 and the flags
    of a checker drawn by the port (the card's machine has no flax), and
    ``Engine.check_safety`` on the card."""
    checker = SafetyChecker.random(SafetyConfig.tiny(), seed=2, std=0.2)
    imgs = torch.from_numpy(safety_frames())
    pix = preprocess_for_safety(imgs, 32)
    with torch.no_grad():
        emb = checker.embed(pix)
        checker.concept_embeds[0] = emb[0]   # frame 0 flagged
        want = (emb, checker(pix))
        on = SafetyChecker.build(SafetyConfig.tiny(),
                                 checker.state_dict()).to(cuda)
        got = (on.embed(pix.to(cuda)).cpu(), on(pix.to(cuda)).cpu())
    torch.testing.assert_close(got[0], want[0], **MODEL_TOL)
    assert torch.equal(got[1], want[1]) and bool(want[1][0])
    models = SDModels.tiny().with_safety_checker(on)
    flags = Engine(models, cuda).check_safety(imgs.to(cuda))
    assert flags.device.type == "cuda"
    assert torch.equal(flags.cpu(), want[1])
