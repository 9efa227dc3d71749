"""SDXL dispatches and the walk on the PyTorch package against the JAX
package, on the CPU: ``tiny_xl`` engine dispatches under CFG and under
limited-interval CFG with step caching (1e-4), and the ``tiny_xl`` walk's
frames (within 2/255), on the weights and helpers of
``tests/test_torch_sdxl.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sdxl import CPU, TOL, xl_bundles, xl_engine_inputs  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("kw", [
    {}, dict(guidance_interval=(0.3, 0.7), step_cache=2)],
    ids=["cfg", "guidance_interval_step_cache"])
def test_tiny_xl_engine_matches_jax(xl_bundles, kw):
    """One pndm-5 dispatch of 2 frames (bucket 8, the JAX package's CPU
    mesh: pad rows in both CFG halves) with given pooled embeddings; ``uncond_pooled`` defaults to the
    pooled embedding of ""."""
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = xl_bundles
    x = xl_engine_inputs()
    run = dict(num_inference_steps=5, guidance_scale=3.0)
    jeng = JEngine(jm, batch_bucket=8, **kw)
    want = np.asarray(jeng.denoise_frames(
        jnp.asarray(x["cond"]), jnp.asarray(x["uncond"]),
        jnp.asarray(x["noise"]), pooled=jnp.asarray(x["pooled"]), **run))
    eng = Engine(pm, CPU, batch_bucket=8, **kw)
    got = eng.denoise_frames(x["cond"], x["uncond"], x["noise"],
                             pooled=x["pooled"], **run)
    assert got.shape == (2, 16, 16, 3) and got.std() > 0
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(eng.embed_text_pooled("").numpy(),
                               np.asarray(jeng.embed_text_pooled("")), **TOL)


def frames(run_dir: Path) -> dict:
    return {p.relative_to(run_dir).as_posix(): np.asarray(Image.open(p),
                                                          np.int32)
            for p in sorted(run_dir.glob("**/frame*.png"))}


def test_tiny_xl_walk_matches_jax(xl_bundles, tmp_path):
    """The walk's frames within 2/255 of the JAX package's: the pooled
    embedding on the lerp trajectory, the negative prompt's pooled
    embedding as the uncond one."""
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    jm, pm = xl_bundles
    walk = dict(prompts=["a red fox", "a blue lighthouse"], seeds=[7, 1234],
                num_interpolation_steps=3, height=64, width=64,
                num_inference_steps=4, batch_size=2, negative_prompt="blurry",
                make_video=False, name="w")
    jax_dir = Path(JaxWalk(jm).walk(
        output_dir=str(tmp_path / "jax"), **walk))
    port_dir = Path(StableDiffusionWalkPipeline(pm, CPU, batch_bucket=2).walk(
        output_dir=str(tmp_path / "port"), **walk))
    want, got = frames(jax_dir), frames(port_dir)
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 2, name
    assert got["w_000000/frame000000.png"].std() > 0
    # the middle frame sits between the ends: the pooled trajectory moves
    assert np.abs(got["w_000000/frame000001.png"]
                  - got["w_000000/frame000000.png"]).max() > 0
    cfg = json.loads((port_dir / "prompt_config.json").read_text())
    assert cfg["negative_prompt"] == "blurry"
