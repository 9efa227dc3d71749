"""Prompt weighting on the PyTorch package against the JAX package, on the
CPU.

The parser, the stripped prompt and the 77-token windows equal the JAX
package's exactly; ``apply_token_weights`` within 1e-6 (fp32) and an exact
no-op at weight 1; ``Engine.embed_text_weighted`` of SD 1.x-shaped and
SDXL-shaped tiny bundles (two windows, a forced window count, the second
tower at the same count) within 1e-5; a weighted walk of two windows
(frames within 2/255), and SDXL's pooled embedding from the stripped prompt.
The bundles are ``tests/test_torch_sdxl.py``'s.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.core import prompt_weighting as pw
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.tokenizer import HashTokenizer
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sdxl import CPU, jax_models, load_port, xl_bundles  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

#: the text towers, fp32
EMBED_TOL = dict(atol=1e-5, rtol=1e-5)
#: the weights' rescale, fp32
WEIGHT_TOL = dict(atol=1e-6, rtol=1e-6)
LONG = ("a (red fox:1.3) in [deep] snow, ((golden light)), "
        + " ".join(f"word{i}" for i in range(90)) + " BREAK a lighthouse")
PROMPTS = ["a plain prompt", "a (red:1.3) [cat]", "((very)) [[faint]]",
           "escaped \\(literal\\) and (unbalanced", "x:1.5) lone colon: y",
           "one BREAK two BREAK three", LONG, ""]


@pytest.mark.parametrize("text", PROMPTS)
def test_parser_matches_jax(text):
    from stable_diffusion_videos_tpu.core import prompt_weighting as jpw
    assert pw.parse_prompt_attention(text) == jpw.parse_prompt_attention(text)
    assert pw.strip_prompt_weights(text) == jpw.strip_prompt_weights(text)
    assert pw.has_prompt_weighting(text) == jpw.has_prompt_weighting(text)


@pytest.mark.parametrize("num_chunks", [None, 3])
def test_windows_match_jax(num_chunks):
    from stable_diffusion_videos_tpu.core import prompt_weighting as jpw
    from stable_diffusion_videos_tpu.models.tokenizer import \
        HashTokenizer as JTok
    tok, jtok = HashTokenizer(1000), JTok(vocab_size=1000)
    for text in PROMPTS:
        ids, w = pw.encode_weighted(tok, text, num_chunks)
        jids, jw = jpw.encode_weighted(jtok, text, num_chunks)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(w, jw)
        assert pw.chunks_needed(tok, text) == jpw.chunks_needed(jtok, text)
    assert pw.chunks_needed(tok, LONG) == 3  # 75 + 22 tokens, then BREAK
    with pytest.raises(ValueError, match="num_chunks"):
        pw.encode_weighted(tok, LONG, num_chunks=1)


def test_apply_token_weights_matches_jax():
    from stable_diffusion_videos_tpu.core import prompt_weighting as jpw
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 77, 16), dtype=np.float32)
    w = rng.uniform(0.5, 1.6, (3, 77)).astype(np.float32)
    got = pw.apply_token_weights(torch.from_numpy(h), w)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpw.apply_token_weights(h, w)),
                               **WEIGHT_TOL)
    ones = pw.apply_token_weights(torch.from_numpy(h), np.ones((3, 77)))
    assert torch.equal(ones, torch.from_numpy(h))


@pytest.fixture(scope="module")
def sd1_bundles():
    port = SDModels.tiny()
    jm = jax_models(port)
    return jm, load_port(port, jm)


@pytest.mark.parametrize("family", ["sd1", "tiny_xl"])
def test_embed_text_weighted_matches_jax(sd1_bundles, xl_bundles,  # noqa: F811
                                         family):
    """Two prompts of one and of three windows (the shorter padded to
    three), then a forced count of 4; SDXL's second tower encodes the same
    windows."""
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = sd1_bundles if family == "sd1" else xl_bundles
    jeng, eng = JEngine(jm, batch_bucket=8), Engine(pm, CPU)
    texts = ["a (red:1.3) fox", LONG]
    for n in (None, 4):
        got = eng.embed_text_weighted(texts, n)
        want = np.asarray(jeng.embed_text_weighted(texts, n))
        assert tuple(got.shape) == want.shape == (
            2, 77 * (n or 3), pm.unet_config.cross_attention_dim)
        np.testing.assert_allclose(got.numpy(), want, **EMBED_TOL)
    # no weights and one window: embed_text's values
    np.testing.assert_allclose(eng.embed_text_weighted("a fox").numpy(),
                               eng.embed_text("a fox").float().numpy(),
                               atol=0, rtol=0)


def frames(run_dir: Path) -> dict:
    return {p.relative_to(run_dir).as_posix(): np.asarray(Image.open(p),
                                                          np.int32)
            for p in sorted(run_dir.glob("**/frame*.png"))}


@pytest.mark.parametrize("family", ["sd1", "tiny_xl"])
def test_weighted_walk_matches_jax(sd1_bundles, xl_bundles,  # noqa: F811
                                   family, tmp_path):
    """A walk from a weighted prompt of three windows to a short weighted
    one, with a weighted negative prompt: cond, uncond and both endpoints
    share one window count; SDXL pools the stripped prompts.  Frames within
    2/255 of the JAX package's."""
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    jm, pm = sd1_bundles if family == "sd1" else xl_bundles
    walk = dict(prompts=[LONG, "a (blue:1.4) lighthouse"], seeds=[7, 1234],
                num_interpolation_steps=3, height=32, width=32,
                num_inference_steps=4, batch_size=2,
                negative_prompt="[blurry]", make_video=False, name="w")
    jax_dir = Path(JaxWalk(jm, prompt_weighting=True).walk(
        output_dir=str(tmp_path / "jax"), **walk))
    pipe = StableDiffusionWalkPipeline(pm, CPU, batch_bucket=2,
                                       prompt_weighting=True)
    port_dir = Path(pipe.walk(output_dir=str(tmp_path / "port"), **walk))
    want, got = frames(jax_dir), frames(port_dir)
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 2, name
    if family == "tiny_xl":
        torch.testing.assert_close(pipe._pooled(LONG),
                                   pipe.engine.embed_text_pooled(
                                       pw.strip_prompt_weights(LONG)))
        assert pw.strip_prompt_weights(LONG) != LONG
