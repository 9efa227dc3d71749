"""Post-processing in the PyTorch package's pipeline against the JAX
package's: the safety checker's black-out and Real-ESRGAN upsampling.

Both pipelines run the same tiny bundle (``tiny_bundles``), the same tiny
checker (``test_torch_safety.jax_checker_tree``) and the same Real-ESRGAN
``.pth``.  The checker's concepts are planted on frames the port makes
without post-processing: concept 0 on the walk's frame 0, concept 1 on
``generate``'s frame of seed 3 (the direction from the other frames' mean
embedding to that frame's), each threshold midway between that frame's
cosine and the nearest other frame's, so exactly those frames are flagged
on both sides.  Frames agree within 2/255, flags exactly.  Also: a resume of an
upsampled run, the ``slerp``/``lerp`` trajectories, ``generate_images``,
the edit paths through ``_postprocess``, ``_ensure_upsampler``'s order and
its failures, and ``walk(params=, jit=)``.
"""

import dataclasses
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from stable_diffusion_videos_tpu_torch.models.safety import \
    preprocess_for_safety
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline as Pipe
from stable_diffusion_videos_tpu_torch.pipeline.image_generation import (
    generate_images, generate_input_batches)
from stable_diffusion_videos_tpu_torch.pipeline.upsampling import \
    RealESRGANModel

from test_torch_safety import jax_checker_tree, port_checker
from test_torch_sampler_engines import tiny_bundles
from test_torch_upsample import basicsr_state, jax_rrdbnet
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
WALK = dict(prompts=["a red fox", "a blue lighthouse"], seeds=[7, 1234],
            num_interpolation_steps=3, height=32, width=32,
            num_inference_steps=3, batch_size=2, make_video=False)
GEN = dict(prompt="a red fox", height=32, width=32, num_inference_steps=3,
           seed=3)


def walk_frames(run_dir) -> np.ndarray:
    return np.stack([np.asarray(Image.open(p), np.int32)
                     for p in sorted(Path(run_dir).glob("**/frame*.png"))])


def embeddings(tree, frames: np.ndarray) -> np.ndarray:
    """The port checker's embeddings of uint8 frames, as the pipeline
    checks them (uint8 / 255)."""
    with torch.no_grad():
        return port_checker(tree).embed(preprocess_for_safety(
            torch.from_numpy(frames.astype(np.float32) / 255.0), 32)).numpy()


def plant(tree, emb: np.ndarray, concept: int, i: int) -> None:
    """Concept ``concept`` := the direction from the other frames' mean
    embedding to frame i's, its threshold midway between frame i's cosine
    and the nearest other frame's (the margin asserted).  The tiny
    model's frames embed within 0.01-0.04 of each other's cosine, which a
    frame's own embedding as the concept would leave as the margin."""
    direction = emb[i] - np.delete(emb, i, axis=0).mean(axis=0)
    cos = emb @ (direction / np.linalg.norm(direction))
    near = np.delete(cos, i).max()
    assert cos[i] - near > 0.05, (cos[i], near)
    tree["params"]["concept_embeds"][concept] = direction
    tree["params"]["concept_embeds_weights"][concept] = (cos[i] + near) / 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX bundle, port bundle, the .pth path, the port's plain walk and
    generate frames), the checker planted as the docstring says."""
    tmp = tmp_path_factory.mktemp("post")
    jm, pm = tiny_bundles()
    plain = Pipe(pm, CPU, safety=False)
    walk = walk_frames(plain.walk(output_dir=str(tmp), name="plain", **WALK))
    gen = np.stack([np.asarray(plain.generate(**{**GEN, "seed": seed})[0],
                               np.int32) for seed in (3, 4)])
    tree = jax_checker_tree(seed=1)
    p = tree["params"]
    p["concept_embeds_weights"][:] = 2.0            # never reached
    p["special_care_embeds_weights"][:] = 2.0
    emb = embeddings(tree, np.concatenate([walk, gen]).astype(np.uint8))
    plant(tree, emb, 0, 0)
    plant(tree, emb, 1, len(walk))
    from stable_diffusion_videos_tpu.models import safety as J
    jm = dataclasses.replace(jm, safety_config=J.SafetyConfig.tiny(),
                             params={**jm.params, "safety_checker": tree})
    pm = pm.with_safety_checker(port_checker(tree))
    jcfg, params = jax_rrdbnet(4, seed=2, std=0.1)
    pth = tmp / "RealESRGAN_tiny.pth"
    torch.save({"params_ema": basicsr_state(params, jcfg)}, pth)
    return dict(jm=jm, pm=pm, pth=str(pth), walk=walk, gen=gen, tmp=tmp)


@pytest.fixture(scope="module")
def jax_pipe(setup):
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    return JaxWalk(setup["jm"], batch_bucket=8, safety=True)


def assert_close_frames(got, want):
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want).max() <= 2


def test_walk_with_safety_and_upsample_matches_jax(setup, jax_pipe,
                                                   tmp_path):
    want = walk_frames(jax_pipe.walk(output_dir=str(tmp_path / "jax"),
                                     name="w", upsample=True,
                                     upsample_weights=setup["pth"], **WALK))
    port = Pipe(setup["pm"], CPU)
    assert port.safety  # on by default: the bundle has a checker
    got = walk_frames(port.walk(output_dir=str(tmp_path / "port"), name="w",
                                upsample=True, upsample_weights=setup["pth"],
                                **WALK))
    assert got.shape == (3, 128, 128, 3)
    assert_close_frames(got, want)
    black = np.asarray(port.upsampler(np.zeros((1, 32, 32, 3), np.float32)))
    black = np.round(black[0] * 255)
    np.testing.assert_array_equal(got[0], black)  # flagged, then upsampled
    assert np.abs(got[1:] - black).max(axis=(1, 2, 3)).min() > 10
    cfg = json.loads((tmp_path / "port" / "w" / "prompt_config.json")
                     .read_text())
    assert cfg["upsample"] is True and cfg["upsample_weights"] == \
        setup["pth"]


def test_resume_of_an_upsampled_run(setup, tmp_path):
    """A resume reads upsample and upsample_weights from
    prompt_config.json: a new pipeline, with no upsampler of its own,
    rebuilds the deleted frame upsampled and equal to the first run's."""
    run = Path(Pipe(setup["pm"], CPU).walk(
        output_dir=str(tmp_path), name="r", upsample=True,
        upsample_weights=setup["pth"], **WALK))
    before = walk_frames(run)
    (run / "r_000000" / "frame000002.png").unlink()
    fresh = Pipe(setup["pm"], CPU)
    fresh.walk(output_dir=str(tmp_path), name="r", resume=True,
               make_video=False)
    assert fresh.upsampler is not None
    np.testing.assert_array_equal(walk_frames(run), before)


def test_interpolation_trajectories_match_jax(setup):
    """embed_interp="slerp" and noise_interp="lerp": the batches of one
    clip, fp32 1e-5."""
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    kw = dict(embed_interp="slerp", noise_interp="lerp")
    jpipe = JaxWalk(setup["jm"], batch_bucket=8, safety=False, **kw)
    port = Pipe(setup["pm"], CPU, safety=False, **kw)
    args = ("a red fox", "a blue lighthouse", 7, 1234, (1, 8, 8, 4),
            np.linspace(0.0, 1.0, 5), 2)
    got = list(port.generate_inputs(*args))
    want = list(jpipe.generate_inputs(*args))
    assert len(got) == len(want) == 3
    for (e, n, _), (je, jn, _) in zip(got, want):
        np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-5,
                                   rtol=1e-5)
    plain = list(Pipe(setup["pm"], CPU, safety=False).generate_inputs(*args))
    assert np.abs(plain[1][1].numpy() - got[1][1].numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="noise_interp"):
        Pipe(setup["pm"], CPU, noise_interp="cubic")


def test_generate_return_dict_matches_jax(setup, jax_pipe):
    """The flagged generate frame (concept 1), black; without an upsampler
    on either side (the JAX pipeline's is cleared)."""
    jax_pipe.upsampler = None
    want = jax_pipe.generate(return_dict=True, **GEN)
    got = Pipe(setup["pm"], CPU)(return_dict=True, **GEN)
    assert got["nsfw_content_detected"] == [True]
    assert want["nsfw_content_detected"] == [True]
    assert_close_frames(np.asarray(got["images"][0]),
                        np.asarray(want["images"][0], np.int32))
    assert not np.asarray(got["images"][0]).any()
    clear = Pipe(setup["pm"], CPU).generate(return_dict=True,
                                            **{**GEN, "seed": 4})
    assert clear["nsfw_content_detected"] == [False]
    off = Pipe(setup["pm"], CPU, safety=False)
    assert off.generate(return_dict=True, **GEN)[
        "nsfw_content_detected"] == [False]
    frames = off.generate(output_type="np", **GEN)
    assert frames.dtype == np.float32 and frames.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(np.round(frames[0] * 255), setup["gen"][0])


def test_generate_images_matches_jax(setup, jax_pipe, tmp_path):
    from stable_diffusion_videos_tpu.pipeline.image_generation import \
        generate_images as jgenerate
    jax_pipe.upsampler = None
    kw = dict(prompt="a red fox", batch_size=2, num_batches=2,
              seeds=[3, 4, 5, 6], num_inference_steps=3, height=32,
              width=32, image_file_ext=".png", upsample=True,
              upsample_weights=setup["pth"])
    want = jgenerate(jax_pipe, output_dir=str(tmp_path), name="jax", **kw)
    port = Pipe(setup["pm"], CPU)
    got = generate_images(port, output_dir=str(tmp_path), name="port", **kw)
    assert [Path(p).name for p in got] == [Path(p).name for p in want] == [
        "3.png", "4.png", "5.png", "6.png"]
    for g, w in zip(got, want):
        assert_close_frames(np.asarray(Image.open(g)),
                            np.asarray(Image.open(w), np.int32))
    assert Image.open(got[0]).size == (128, 128)
    cfg = json.loads((tmp_path / "port" / "prompt_config.json").read_text())
    assert cfg["framework"] == "stable_diffusion_videos_tpu_torch"
    batches = list(generate_input_batches(port, ["a", "b", "c"], [1, 2, 3],
                                          2, 32, 32))
    assert [(i, tuple(e.shape), tuple(n.shape)) for i, e, n in batches] == [
        (0, (2, 77, 32), (2, 16, 16, 4)), (1, (1, 77, 32), (1, 16, 16, 4))]


def test_generate_images_with_control_and_weighting(setup, tmp_path):
    """``control_image`` and ``prompt_weighting`` reach the dispatch:
    the written images equal one engine dispatch with the weighted
    contexts and the same control map."""
    from stable_diffusion_videos_tpu_torch.models.controlnet import \
        ControlNetBundle
    pipe = Pipe(setup["pm"], CPU, safety=False, prompt_weighting=True,
                controlnet=ControlNetBundle.tiny())
    edge = np.zeros((32, 32, 3), np.float32)
    edge[:, 12:20] = 1.0
    prompt = "a (red:1.3) fox"
    paths = generate_images(pipe, prompt, batch_size=2, seeds=[3, 4],
                            num_inference_steps=3, height=32, width=32,
                            output_dir=str(tmp_path), name="c",
                            image_file_ext=".png", control_image=edge,
                            controlnet_scale=0.7)
    got = np.stack([np.asarray(Image.open(p)) for p in paths])
    n = pipe._num_chunks(prompt, "")
    noise = torch.cat([pipe.init_noise(s, (1, 16, 16, 4)) for s in (3, 4)])
    want = pipe.engine.denoise_frames(
        pipe._embed(prompt, n).expand(2, -1, -1), pipe._embed("", n), noise,
        num_inference_steps=3, output_dtype="uint8", control=edge[None],
        control_scale=0.7)
    np.testing.assert_array_equal(got, want)
    plain = pipe.engine.denoise_frames(
        pipe._embed(prompt, n).expand(2, -1, -1), pipe._embed("", n), noise,
        num_inference_steps=3, output_dtype="uint8")
    assert np.abs(plain.astype(int) - got).max() > 0


def test_generate_images_fails_before_writing(setup, tmp_path, monkeypatch):
    monkeypatch.delenv("SDV_REALESRGAN", raising=False)
    port = Pipe(setup["pm"], CPU)
    with pytest.raises(FileNotFoundError, match="SDV_REALESRGAN"):
        generate_images(port, "a", output_dir=str(tmp_path), name="x",
                        upsample=True, height=32, width=32)
    with pytest.raises(NotImplementedError, match="hub"):
        generate_images(port, "a", output_dir=str(tmp_path), name="x",
                        push_to_hub=True, repo_id="me/x")
    assert not (tmp_path / "x").exists()


def test_edit_paths_go_through_postprocess(setup):
    """img2img, inpaint and vid2vid frames are safety checked and
    upsampled: with every threshold below any cosine each output is the
    upsampler's image of a black frame."""
    tree = jax_checker_tree(seed=1)
    tree["params"]["concept_embeds_weights"][:] = -2.0
    models = setup["pm"].with_safety_checker(port_checker(tree))
    pipe = Pipe(models, CPU)
    pipe._ensure_upsampler(setup["pth"])
    black = np.round(np.asarray(pipe.upsampler(
        np.zeros((1, 32, 32, 3), np.float32)))[0] * 255)
    src = setup["walk"][:2].astype(np.uint8)
    outs = {"img2img": pipe.img2img(src, "a", num_inference_steps=3),
            "inpaint": pipe.inpaint(src[0], np.ones((32, 32)), "a",
                                    num_inference_steps=3),
            "vid2vid": pipe.vid2vid(src, "a", num_inference_steps=3,
                                    batch_size=2, output_type="frames")}
    for name, images in outs.items():
        assert len(images) == (1 if name == "inpaint" else 2), name
        for im in images:
            assert im.size == (128, 128), name
            np.testing.assert_array_equal(np.asarray(im), black,
                                          err_msg=name)
    raw = pipe.img2img(src, "a", num_inference_steps=3, output_type="np")
    assert raw.shape == (2, 32, 32, 3) and raw.dtype == np.float32


def test_ensure_upsampler_order_and_failures(setup, tmp_path, monkeypatch):
    """The argument, then SDV_REALESRGAN, then an assigned upsampler; a
    missing file or no source raises before the run directory exists; a
    path already loaded is not read again."""
    pth, other = setup["pth"], str(tmp_path / "other.pth")
    Path(other).write_bytes(Path(pth).read_bytes())
    monkeypatch.delenv("SDV_REALESRGAN", raising=False)
    pipe = Pipe(setup["pm"], CPU, safety=False)
    out = tmp_path / "runs"
    with pytest.raises(FileNotFoundError, match="SDV_REALESRGAN"):
        pipe.walk(output_dir=str(out), name="none", upsample=True, **WALK)
    with pytest.raises(FileNotFoundError, match="not found"):
        pipe.walk(output_dir=str(out), name="none", upsample=True,
                  upsample_weights=str(tmp_path / "missing.pth"), **WALK)
    assert not (out / "none").exists()
    pipe.upsampler = RealESRGANModel.tiny(torch.device("meta"))
    with pytest.raises(ValueError, match="pipeline's device"):
        pipe._ensure_upsampler()
    assigned = RealESRGANModel.tiny(CPU, tile=8)
    pipe.upsampler = assigned
    pipe._ensure_upsampler()
    assert pipe.upsampler is assigned
    monkeypatch.setenv("SDV_REALESRGAN", other)
    pipe._ensure_upsampler()
    assert pipe._upsampler_source() == other
    env_model = pipe.upsampler
    pipe._ensure_upsampler()
    assert pipe.upsampler is env_model  # not read again
    pipe._ensure_upsampler(pth)
    assert pipe._upsampler_source() == pth
    monkeypatch.setenv("SDV_REALESRGAN", str(tmp_path / "gone.pth"))
    with pytest.raises(FileNotFoundError, match="not found"):
        pipe._ensure_upsampler()


def test_walk_accepts_params_and_jit(setup, tmp_path, caplog):
    pipe = Pipe(setup["pm"], CPU, safety=False)
    with caplog.at_level(logging.INFO, logger="sdv_torch"):
        run = pipe.walk(output_dir=str(tmp_path), name="p", params={},
                        jit=True, **WALK)
    assert "arguments ignored" in caplog.text
    np.testing.assert_array_equal(walk_frames(run), setup["walk"])
