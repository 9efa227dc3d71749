"""vid2vid and video reading of the PyTorch package against the JAX
package's.

Reading: a native MJPEG AVI written by the port's ``NativeAviSink`` probes
and reads back (through the cv2 rung and the pure-Python native-AVI rung,
with resizing and frame skipping) equal to the JAX readers' output.
vid2vid: the tiny pipelines restyle a 5-frame video in dispatches of 2
(pndm-10, strength 0.5), both with the one shared re-noising field of the
video's seed, with and without ``latent_ema`` and ``frozen_noise``; frames
within 2/255.  On the port alone: under ``frozen_noise`` without the shared
field (a field a frame, keyed by its absolute index) and a stochastic
sampler, the frames do not depend on ``batch_size``; a video file in, a
video with audio out; an abort deletes the half-written video; the
ControlNet and IP-Adapter arguments raise.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.media import video as pvideo
from stable_diffusion_videos_tpu_torch.media.native_sink import NativeAviSink
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline

from test_torch_sampler_engines import tiny_bundles
from test_torch_walk import click_track
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
RUN = dict(strength=0.5, num_inference_steps=10, guidance_scale=3.0,
           batch_size=2, seed=21, output_type="frames")


def source_frames(n: int = 5, h: int = 16, w: int = 16) -> np.ndarray:
    """Smooth moving gradients, uint8 (n, h, w, 3)."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    frames = [np.stack([np.sin(3 * x + t), np.cos(2 * y - t),
                        np.sin(x + y + 0.5 * t)], -1) for t in range(n)]
    return ((np.stack(frames) + 1) * 127.5).round().astype(np.uint8)


@pytest.fixture
def avi(tmp_path) -> Path:
    path = tmp_path / "in.avi"
    sink = NativeAviSink(str(path), 48, 32, fps=12.5)
    for fr in source_frames(6, 32, 48):
        sink.add_frame(fr)
    sink.close()
    return path


def test_native_avi_reads_back_as_the_jax_readers(avi):
    from stable_diffusion_videos_tpu.media import video as jvideo
    assert pvideo.probe_video(avi) == jvideo.probe_video(avi)
    info = pvideo.probe_video(avi)
    assert (info["width"], info["height"], info["n_frames"]) == (48, 32, 6)
    for kw in ({}, dict(size=(16, 24), frame_skip=2, max_frames=2)):
        got = np.stack(list(pvideo.read_video_frames(avi, **kw)))
        want = np.stack(list(jvideo.read_video_frames(avi, **kw)))
        np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 16, 24, 3)
    fps, frames = pvideo._read_native_avi(avi)
    jfps, jframes = jvideo._read_native_avi(avi)
    got, want = np.stack(list(frames)), np.stack(list(jframes))
    assert fps == jfps == 12.5 and pvideo._is_native_avi(avi)
    np.testing.assert_array_equal(got, want)
    # MJPEG is lossy: the frames come back near what was written
    assert np.abs(got.astype(int) - source_frames(6, 32, 48)).mean() < 4


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


@pytest.mark.parametrize("latent_ema,frozen", [(0.0, False), (0.5, True)],
                         ids=["shared", "shared_ema_frozen"])
def test_vid2vid_matches_jax(bundles, latent_ema, frozen):
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    jm, pm = bundles
    video = list(source_frames())
    kw = dict(RUN, latent_ema=latent_ema, shared_noise=True)
    want = JaxWalk(jm, batch_bucket=8, safety=False,
                   frozen_noise=frozen).vid2vid(video, "a red fox", **kw)
    got = StableDiffusionWalkPipeline(pm, CPU, frozen_noise=frozen).vid2vid(
        video, "a red fox", **kw)
    assert len(got) == len(want) == 5
    got, want = (np.stack([np.asarray(f, np.int32) for f in fs])
                 for fs in (got, want))
    assert got.shape == (5, 16, 16, 3)
    assert np.abs(got - want).max() <= 2
    assert got.std() > 0


def test_frozen_vid2vid_does_not_depend_on_batch_size():
    pipe = StableDiffusionWalkPipeline(SDModels.tiny(), CPU,
                                       scheduler="euler_ancestral",
                                       frozen_noise=True)
    video = source_frames()
    runs = [np.stack([np.asarray(f, np.int32) for f in pipe.vid2vid(
        video, "a red fox", **dict(RUN, batch_size=b, shared_noise=False))])
        for b in (2, 3)]
    assert np.abs(runs[0] - runs[1]).max() <= 1
    # each frame its own field: not one field repeated every batch
    assert np.abs(runs[0][0] - runs[0][2]).max() > 2


def test_vid2vid_file_in_video_out(avi, tmp_path):
    wav = click_track(tmp_path / "beat.wav", seconds=0.5)
    pipe = StableDiffusionWalkPipeline.tiny(CPU)
    out = pipe.vid2vid(str(avi), "a red fox", strength=0.5,
                       num_inference_steps=3, batch_size=4,
                       output_filepath=str(tmp_path / "out.mp4"),
                       audio_filepath=str(wav))
    info = pvideo.probe_video(out)
    # sides snapped down to a multiple of 8·f (16 for the tiny VAE)
    assert (info["width"], info["height"], info["n_frames"]) == (48, 32, 6)


def test_vid2vid_abort_deletes_the_video(tmp_path):
    pipe = StableDiffusionWalkPipeline.tiny(CPU)

    def frames():
        yield from source_frames(3)
        raise KeyboardInterrupt

    target = tmp_path / "aborted.mp4"
    with pytest.raises(KeyboardInterrupt):
        pipe.vid2vid(frames(), "a red fox", num_inference_steps=2,
                     batch_size=2, output_filepath=str(target))
    assert not list(tmp_path.glob("aborted.*"))


@pytest.mark.parametrize("kw", [dict(control_video="x.mp4"),
                                dict(control_from_source="canny"),
                                dict(ip_image="x.png")])
def test_vid2vid_refuses_unported_conditioning(kw):
    """ControlNet and IP-Adapter conditioning on a pipeline built without
    the model it needs raises ValueError naming that model."""
    with pytest.raises(ValueError, match="ControlNet|controlnet|ip_adapter"):
        StableDiffusionWalkPipeline.tiny(CPU).vid2vid(
            source_frames(), "a red fox", **kw)
