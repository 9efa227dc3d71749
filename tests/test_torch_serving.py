"""Serving on the PyTorch package, on the CPU: the HTTP server, the dynamic
batcher, the out-of-memory split and the kernel library's first build.

The server cases mirror ``tests/test_server.py`` and the batcher cases
``tests/test_batcher.py`` on the port's tiny pipeline (``device="cpu"``,
16x16 frames), served on ``127.0.0.1:0`` with a stdlib client.  Added: the
engine's batch split on an injected ``torch.cuda.OutOfMemoryError`` (frames
equal to the unsplit ones, through the engine and through ``/generate``);
``/warmup`` beside a concurrent ``/generate``, whose sampler the JAX
server switches and the port's does not; eight threads making the first
kernel call at once, with the compiler and the loader replaced, and one
build among them.
"""

import base64
import io
import json
import logging
import pathlib
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest
import torch
from PIL import Image

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.batcher import DynamicBatcher
from stable_diffusion_videos_tpu_torch.runtime.engine import (
    batch_part, is_out_of_memory)
from stable_diffusion_videos_tpu_torch.runtime.server import Server

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def tiny(**kw) -> StableDiffusionWalkPipeline:
    return StableDiffusionWalkPipeline.tiny(CPU, safety=False, **kw)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("walk_root")
    server = Server(tiny(), output_root=str(root))
    host, port = server.start(port=0)
    yield host, port, server
    server.shutdown()


def _req(host, port, method, path, body=None):
    conn = HTTPConnection(host, port, timeout=300)
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    return resp.status, payload


def _wait(host, port, job_id, until=("done", "error"), seconds=240):
    deadline = time.time() + seconds
    while time.time() < deadline:
        _, job = _req(host, port, "GET", f"/jobs/{job_id}")
        if job["status"] in until:
            return job
        time.sleep(0.2)
    return job


def _png(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _b64(arr, mode="RGB") -> str:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# ---------------------------------------------------------------------------
# the server: tests/test_server.py's cases
# ---------------------------------------------------------------------------

def test_health(served):
    host, port, _ = served
    status, body = _req(host, port, "GET", "/health")
    assert status == 200
    assert body["status"] == "ok"
    assert body["backend"] == "cpu" and body["devices"] >= 1
    assert "mesh" not in body and body["compiled_programs"] >= 0


def test_generate(served):
    host, port, server = served
    status, body = _req(host, port, "POST", "/generate", {
        "prompt": "a tiny fox", "num_inference_steps": 2, "count": 2,
        "seed": 5})
    assert status == 200
    assert len(body["images"]) == 2
    assert body["seeds"] == [5, 6]
    img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
    assert img.size == (16, 16)
    # each image is the pipeline's generate of its prompt and seed
    want = server.pipeline.generate("a tiny fox", seed=6,
                                    num_inference_steps=2)[0]
    np.testing.assert_array_equal(_png(body["images"][1]), np.asarray(want))


def test_generate_validation(served):
    host, port, _ = served
    status, body = _req(host, port, "POST", "/generate", {})
    assert status == 400 and "prompt" in body["error"]
    status, body = _req(host, port, "POST", "/generate",
                        {"prompt": "x", "seeds": [1, 2]})
    assert status == 400
    status, body = _req(host, port, "POST", "/generate",
                        {"prompt": "x", "count": 65})
    assert status == 400 and "limit" in body["error"]


def test_bad_json(served):
    host, port, _ = served
    conn = HTTPConnection(host, port, timeout=60)
    conn.request("POST", "/generate", body=b"{not json",
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    conn.close()


def test_unknown_routes(served):
    host, port, _ = served
    assert _req(host, port, "GET", "/nope")[0] == 404
    assert _req(host, port, "POST", "/nope")[0] == 404
    assert _req(host, port, "GET", "/jobs/zzz")[0] == 404


def test_walk_job(served):
    host, port, server = served
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["a", "b"], "seeds": [1, 2],
        "num_interpolation_steps": 2, "num_inference_steps": 2,
        "fps": 2, "output_dir": "runs", "name": "served"})
    assert status == 202
    job = _wait(host, port, body["job_id"])
    assert job["status"] == "done", job
    assert job["result"]["video"].endswith(".mp4")
    assert job["result"]["video"].startswith(str(server.output_root))
    assert pathlib.Path(job["result"]["video"]).stat().st_size > 0
    perf = job["result"]["perf"]
    assert perf["frames"] >= 2
    assert {"embed", "denoise", "transfer", "save", "encode"} <= set(
        perf["stages_s"])
    assert job["progress"]["frames_done"] == job["progress"]["frames_total"] \
        == 2
    assert job["progress"]["clips_total"] == 1


def test_walk_job_error_surfaced(served):
    host, port, _ = served
    _, body = _req(host, port, "POST", "/walk", {"prompts": ["only one"],
                                                 "seeds": [1]})
    job = _wait(host, port, body["job_id"], seconds=60)
    assert job["status"] == "error"
    assert "ValueError" in job["error"]


def test_concurrent_generate(served):
    host, port, _ = served
    results = []

    def call(seed):
        status, body = _req(host, port, "POST", "/generate", {
            "prompt": "concurrent", "num_inference_steps": 2, "seed": seed})
        results.append((status, body["seeds"]))

    threads = [threading.Thread(target=call, args=(s,)) for s in (11, 22)]
    [t.start() for t in threads]
    [t.join(timeout=240) for t in threads]
    assert len(results) == 2
    assert all(status == 200 for status, _ in results)
    assert {tuple(s) for _, s in results} == {(11,), (22,)}


def test_sixteen_clients_merge_into_one_dispatch(monkeypatch):
    """16 clients connecting at once are all accepted (a listen backlog
    of 128) and their requests merge into one dispatch of 16."""
    server = Server(tiny(), batch_delay_ms=1000.0)
    host, port = server.start(port=0)
    assert server._httpd.request_queue_size >= 16
    sizes = spy_dispatches(monkeypatch, server.pipeline.engine)
    try:
        status = []
        threads = [threading.Thread(target=lambda i=i: status.append(_req(
            host, port, "POST", "/generate", {
                "prompt": "burst", "seed": i,
                "num_inference_steps": 2})[0])) for i in range(16)]
        [t.start() for t in threads]
        [t.join(timeout=240) for t in threads]
    finally:
        server.shutdown()
    assert status == [200] * 16 and sizes == [16]


def test_img2img_endpoint():
    server = Server(tiny(scheduler="ddim"))
    host, port = server.start(port=0)
    try:
        img = np.random.default_rng(0).integers(0, 255, (16, 16, 3)) \
            .astype(np.uint8)
        status, body = _req(host, port, "POST", "/img2img", {
            "image": _b64(img), "prompt": "remix", "num_inference_steps": 3,
            "strength": 0.6})
        assert status == 200
        out = _png(body["images"][0])
        assert out.shape == (16, 16, 3)
        want = server.pipeline.img2img(Image.fromarray(img), "remix",
                                       strength=0.6, num_inference_steps=3)
        np.testing.assert_array_equal(out, np.asarray(want[0]))
        status, body = _req(host, port, "POST", "/img2img", {"prompt": "x"})
        assert status == 400
    finally:
        server.shutdown()


def test_inpaint_endpoint():
    server = Server(tiny(scheduler="ddim"))
    host, port = server.start(port=0)
    try:
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
        mask = np.zeros((16, 16), np.uint8)
        mask[:, 8:] = 255
        status, body = _req(host, port, "POST", "/inpaint", {
            "image": _b64(img), "mask": _b64(mask, "L"), "prompt": "patch",
            "num_inference_steps": 3})
        assert status == 200 and len(body["images"]) == 1
        status, _ = _req(host, port, "POST", "/inpaint", {"prompt": "x"})
        assert status == 400
    finally:
        server.shutdown()


def test_walk_rejects_unknown_kwargs(served):
    host, port, _ = served
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["a", "b"], "seeds": [1, 2], "bogus_flag": True})
    assert status == 400
    assert "bogus_flag" in body["error"]


def test_walk_rejects_absolute_output_dir(served, tmp_path):
    host, port, _ = served
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["a", "b"], "seeds": [1, 2],
        "output_dir": str(tmp_path)})
    assert status == 400
    assert "relative" in body["error"]


def test_walk_rejects_path_escape(served):
    host, port, _ = served
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["a", "b"], "seeds": [1, 2], "output_dir": "../../etc"})
    assert status == 400
    assert "escape" in body["error"]


def test_walk_rejects_upsample_weights_kwarg(served):
    """A server path is the operator's to set, never the caller's."""
    host, port, _ = served
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["a", "b"], "seeds": [1, 2],
        "upsample_weights": "/etc/passwd"})
    assert status == 400


def test_walk_audio_path_confined(served):
    host, port, _ = served
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["a", "b"], "seeds": [1, 2],
        "audio_filepath": "/etc/passwd"})
    assert status == 400


def test_walk_clamps_steps_and_sides(served, monkeypatch):
    """Oversized steps and sides are clamped before the job (the ceilings
    of /generate): the walk is accepted and runs at the ceiling."""
    host, port, server = served
    seen = {}
    real = server.pipeline.walk

    def spy(**kw):
        seen.update(kw)
        return real(**{**kw, "num_inference_steps": 2, "height": 16,
                       "width": 16})

    monkeypatch.setattr(server.pipeline, "walk", spy)
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["a", "b"], "seeds": [1, 2],
        "num_interpolation_steps": 2, "num_inference_steps": 99999,
        "height": 10 ** 6, "width": 8, "fps": 2, "name": "clamped",
        "make_video": False})
    assert status == 202
    job = _wait(host, port, body["job_id"])
    assert job["status"] == "done", job
    assert (seen["num_inference_steps"], seen["height"], seen["width"]) \
        == (Server.MAX_STEPS, Server.MAX_SIDE, 64)


def test_walk_job_cancel(served):
    host, port, server = served
    status, body = _req(host, port, "POST", "/walk", {
        "prompts": ["c1", "c2", "c3", "c4"], "seeds": [1, 2, 3, 4],
        "num_interpolation_steps": 8, "num_inference_steps": 4,
        "batch_size": 2, "fps": 2, "output_dir": "cancel_run",
        "name": "tokill"})
    assert status == 202
    job_id = body["job_id"]
    deadline = time.time() + 120
    while time.time() < deadline:
        _, job = _req(host, port, "GET", f"/jobs/{job_id}")
        if job["status"] == "running" and job.get("progress", {}) \
                .get("frames_done", 0) > 0:
            break
        if job["status"] in ("done", "error"):
            pytest.fail(f"job finished before cancel: {job}")
        time.sleep(0.05)
    status, body = _req(host, port, "DELETE", f"/jobs/{job_id}")
    assert status == 202 and body["status"] == "cancelling"
    job = _wait(host, port, job_id, until=("cancelled", "done", "error"),
                seconds=120)
    assert job["status"] == "cancelled", job
    assert job["progress"]["frames_done"] < job["progress"]["frames_total"]
    run = pathlib.Path(server.output_root) / "cancel_run" / "tokill"
    assert not (run / "tokill.mp4").exists()
    # the clip being written when the cancel landed left no container
    clip = run / f"tokill_{job['progress']['clip']:06d}"
    assert not list(clip.glob("*.mp4")) + list(clip.glob("*.avi"))
    status, _ = _req(host, port, "DELETE", f"/jobs/{job_id}")
    assert status == 409


def test_cancel_unknown_and_done_jobs(served):
    host, port, _ = served
    assert _req(host, port, "DELETE", "/jobs/zzz")[0] == 404
    assert _req(host, port, "DELETE", "/nope")[0] == 404


def test_warmup_sync(served):
    """/warmup runs one dispatch a (sampler, batch, dtype); the warmed keys
    are counted and the engine's sampler stays as it was."""
    host, port, server = served
    eng = server.pipeline.engine
    before = len(eng.warmed)
    orig = eng.scheduler_name
    status, body = _req(host, port, "POST", "/warmup", {
        "num_inference_steps": 2, "schedulers": ["pndm", "ddim"],
        "batches": [2], "output_dtypes": ["float32", "uint8"]})
    assert status == 200, body
    assert set(body["schedulers"]) == {"pndm", "ddim"}
    assert all(s >= 0 for s in body["schedulers"].values())
    assert body["compiled_programs"] == before + 4 == len(eng.warmed)
    assert body["batches"] == [2] and body["num_inference_steps"] == 2
    assert eng.scheduler_name == orig
    assert ("ddim", 2, 8, 8, 2, "uint8") in eng.warmed
    _, health = _req(host, port, "GET", "/health")
    assert health["compiled_programs"] == len(eng.warmed)


def test_warmup_validation(served):
    host, port, _ = served
    status, body = _req(host, port, "POST", "/warmup",
                        {"schedulers": ["nope"]})
    assert status == 400 and "nope" in body["error"]
    status, body = _req(host, port, "POST", "/warmup", {"bogus": 1})
    assert status == 400 and "bogus" in body["error"]
    status, body = _req(host, port, "POST", "/warmup",
                        {"output_dtypes": ["float64"]})
    assert status == 400
    status, body = _req(host, port, "POST", "/warmup", {"batches": 8})
    assert status == 400 and "list" in body["error"]
    status, body = _req(host, port, "POST", "/warmup",
                        {"schedulers": "ddim"})
    assert status == 400 and "list" in body["error"]


def test_warmup_async(served):
    host, port, _ = served
    status, body = _req(host, port, "POST", "/warmup", {
        "num_inference_steps": 2, "batches": [1], "async": True})
    assert status == 202 and "job_id" in body
    job = _wait(host, port, body["job_id"], seconds=300)
    assert job["status"] == "done", job
    assert "schedulers" in job["result"]


def test_vid2vid_job(served):
    """A /vid2vid upload restyled into a video under the output root, with
    its progress, and the upload removed."""
    from stable_diffusion_videos_tpu_torch.media.video import FrameWriter
    host, port, server = served
    src = server.output_root / "src.mp4"
    w = FrameWriter(str(src), fps=4.0)
    rng = np.random.default_rng(1)
    for _ in range(3):
        w.add_frame(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8))
    src = pathlib.Path(w.close())
    status, body = _req(host, port, "POST", "/vid2vid", {
        "video": base64.b64encode(src.read_bytes()).decode(),
        "video_format": src.suffix, "prompt": "restyle",
        "num_inference_steps": 2, "batch_size": 2, "name": "restyled"})
    assert status == 202, body
    job = _wait(host, port, body["job_id"])
    assert job["status"] == "done", job
    assert pathlib.Path(job["result"]["video"]).parent == server.output_root
    assert job["progress"]["frames_done"] == 3
    assert not list(server.output_root.glob(".upload_*"))
    status, body = _req(host, port, "POST", "/vid2vid", {
        "prompt": "x", "video_path": "../outside.mp4"})
    assert status == 400


# ---------------------------------------------------------------------------
# the batcher: tests/test_batcher.py's cases
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline():
    return tiny()


def spy_dispatches(monkeypatch, engine) -> list:
    sizes = []
    real = engine.denoise_frames_device

    def spy(cond, uncond, noise, **kw):
        sizes.append(int(noise.shape[0]))
        return real(cond, uncond, noise, **kw)

    monkeypatch.setattr(engine, "denoise_frames_device", spy)
    return sizes


def test_batcher_merges_compatible_requests(pipeline, monkeypatch):
    b = DynamicBatcher(pipeline, max_batch=8, max_delay_ms=200).start()
    try:
        dispatches = spy_dispatches(monkeypatch, pipeline.engine)
        futs = [b.submit(f"p{i}", seed=i, num_inference_steps=2)
                for i in range(4)]
        frames = [f.result(timeout=300) for f in futs]
        assert all(f.shape == (16, 16, 3) for f in frames)
        assert sum(dispatches) == 4 and len(dispatches) <= 2
    finally:
        b.stop()


def test_batcher_separates_incompatible_signatures(pipeline):
    b = DynamicBatcher(pipeline, max_batch=8, max_delay_ms=100).start()
    try:
        f1 = b.submit("a", seed=1, num_inference_steps=2)
        f2 = b.submit("b", seed=2, num_inference_steps=3)
        r1, r2 = f1.result(timeout=300), f2.result(timeout=300)
        assert r1.shape == r2.shape
    finally:
        b.stop()


def test_batcher_result_matches_direct(pipeline):
    """A batched frame equals a direct generation of the same request, and
    stays on the pipeline's device."""
    b = DynamicBatcher(pipeline, max_batch=4, max_delay_ms=10).start()
    try:
        got = b.submit("same prompt", seed=9,
                       num_inference_steps=2).result(timeout=300)
        assert isinstance(got, torch.Tensor) and got.device == CPU
        direct = pipeline(prompt="same prompt", seed=9,
                          num_inference_steps=2, output_type="np")[0]
        np.testing.assert_allclose(got.numpy(), direct, atol=1e-5)
    finally:
        b.stop()


def test_batcher_error_propagates(pipeline, monkeypatch):
    b = DynamicBatcher(pipeline, max_batch=4, max_delay_ms=10).start()
    try:
        def boom(*a, **k):
            raise RuntimeError("boom")
        monkeypatch.setattr(pipeline.engine, "denoise_frames_device", boom)
        fut = b.submit("x", seed=1, num_inference_steps=2)
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=60)
    finally:
        b.stop()


def test_batcher_stop_drains_pending(pipeline):
    b = DynamicBatcher(pipeline, max_batch=2, max_delay_ms=5000).start()
    futs = [b.submit(f"drain{i}", seed=i, num_inference_steps=2)
            for i in range(3)]
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    frames = [f.result(timeout=300) for f in futs]
    stopper.join(timeout=300)
    assert all(f.shape[-1] == 3 for f in frames)
    assert not b._started


def test_batcher_stop_fail_fast(pipeline):
    b = DynamicBatcher(pipeline, max_batch=2, max_delay_ms=5000).start()
    first = b.submit("x", seed=0, num_inference_steps=2)
    time.sleep(0.05)
    rest = [b.submit(f"y{i}", seed=i, num_inference_steps=4)
            for i in range(2)]
    b.stop(drain=False)
    first.result(timeout=300)
    for f in rest:
        with pytest.raises(RuntimeError, match="batcher stopped"):
            f.result(timeout=60)


def test_batcher_restarts_after_stop(pipeline):
    b = DynamicBatcher(pipeline, max_batch=2, max_delay_ms=10).start()
    b.submit("a", seed=1, num_inference_steps=2).result(timeout=300)
    b.stop()
    f = b.submit("b", seed=2, num_inference_steps=2)
    assert f.result(timeout=300).shape[-1] == 3
    b.stop()


def test_batcher_merged_dispatch_pads_to_bucket(monkeypatch):
    """Five requests run as one dispatch of 5 rows padded to the engine's
    bucket of 8, and each frame equals a solo generation."""
    pipe = tiny(batch_bucket=8)
    dispatches = spy_dispatches(monkeypatch, pipe.engine)
    b = DynamicBatcher(pipe, max_batch=8, max_delay_ms=300).start()
    try:
        futs = [b.submit(f"req {i}", seed=i, num_inference_steps=2)
                for i in range(5)]
        frames = [f.result(timeout=300) for f in futs]
    finally:
        b.stop()
    assert dispatches == [5]
    solo = pipe(prompt="req 3", seed=3, num_inference_steps=2,
                output_type="np")[0]
    np.testing.assert_allclose(frames[3].numpy(), solo, atol=1e-5)


# ---------------------------------------------------------------------------
# repair: the batch split on out-of-memory
# ---------------------------------------------------------------------------

def inject_oom(monkeypatch, engine, above: int, err=None) -> list:
    """``engine.denoise_frames_async`` raising an out-of-memory error for
    batches of more than ``above`` rows; -> the batch sizes it was given."""
    sizes = []
    real = engine.denoise_frames_async

    def flaky(cond, uncond, noise, **kw):
        sizes.append(int(noise.shape[0]))
        if noise.shape[0] > above:
            raise err or torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(cond, uncond, noise, **kw)

    monkeypatch.setattr(engine, "denoise_frames_async", flaky)
    return sizes


def dispatch_inputs(pipe, rows: int):
    cond = torch.cat([pipe.engine.embed_text(f"frame {i}")
                      for i in range(rows)])
    noise = torch.cat([pipe.init_noise(i, pipe._latent_shape(16, 16))
                       for i in range(rows)])
    return cond, pipe.engine.embed_text(""), noise


@pytest.mark.parametrize("err", [
    None, RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                       "`cublasCreate(handle)`")], ids=["oom", "cublas"])
def test_oom_split_equals_unsplit(pipeline, monkeypatch, caplog, err):
    """The split run's frames are the unsplit run's: equal as uint8 (what
    the walk and the server keep), and in float32 within the rounding of
    the CPU's matmuls at another batch size (1e-6)."""
    cond, uncond, noise = dispatch_inputs(pipeline, 5)
    run = dict(num_inference_steps=3, guidance_scale=7.5)
    want = {dt: pipeline.engine.denoise_frames(cond, uncond, noise,
                                               output_dtype=dt, **run)
            for dt in ("float32", "uint8")}
    sizes = inject_oom(monkeypatch, pipeline.engine, above=2, err=err)
    with caplog.at_level(logging.WARNING, logger="sdv_torch"):
        got = {dt: pipeline.engine.denoise_frames(cond, uncond, noise,
                                                  output_dtype=dt, **run)
               for dt in ("float32", "uint8")}
    # 5 -> 2 + 3, 3 -> 1 + 2, for each dtype
    assert sizes == [5, 2, 3, 1, 2] * 2
    assert "out of device memory at batch 5" in caplog.text
    np.testing.assert_array_equal(got["uint8"], want["uint8"])
    np.testing.assert_allclose(got["float32"], want["float32"], atol=1e-6,
                               rtol=0)


def test_oom_split_slices_batch_aligned_arguments(monkeypatch):
    """SDXL's pooled embeddings are cut with the batch; the shared
    negative prompt's single row is not."""
    pipe = StableDiffusionWalkPipeline.tiny_xl(CPU, safety=False)
    cond, uncond, noise = dispatch_inputs(pipe, 4)
    pooled = torch.cat([pipe.engine.embed_text_pooled(f"frame {i}")
                        for i in range(4)])
    run = dict(num_inference_steps=2, pooled=pooled,
               uncond_pooled=pipe.engine.embed_text_pooled(""),
               output_dtype="uint8")
    want = pipe.engine.denoise_frames(cond, uncond, noise, **run)
    sizes = inject_oom(monkeypatch, pipe.engine, above=2)
    got = pipe.engine.denoise_frames(cond, uncond, noise, **run)
    assert sizes == [4, 2, 2]
    np.testing.assert_array_equal(got, want)


def test_oom_split_leaves_other_errors(pipeline, monkeypatch):
    cond, uncond, noise = dispatch_inputs(pipeline, 4)
    sizes = inject_oom(monkeypatch, pipeline.engine, above=0,
                       err=RuntimeError("shape mismatch"))
    with pytest.raises(RuntimeError, match="shape mismatch"):
        pipeline.engine.denoise_frames(cond, uncond, noise,
                                       num_inference_steps=2)
    assert sizes == [4]
    # a single row that does not fit has nothing left to split
    inject_oom(monkeypatch, pipeline.engine, above=0)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pipeline.engine.denoise_frames(cond[:1], uncond, noise[:1],
                                       num_inference_steps=2)


def test_oom_classification_and_batch_part():
    assert is_out_of_memory(torch.cuda.OutOfMemoryError("x"))
    assert is_out_of_memory(RuntimeError("CUDNN_STATUS_ALLOC_FAILED"))
    assert not is_out_of_memory(RuntimeError("CUDNN_STATUS_BAD_PARAM"))
    assert not is_out_of_memory(ValueError("out of memory"))
    x, row = torch.zeros(4, 3), torch.zeros(1, 3)
    maps = [np.zeros((4, 8, 8, 3)), np.zeros((8, 8, 3))]
    assert batch_part(x, 4, slice(2, None)).shape == (2, 3)
    assert batch_part(row, 4, slice(2, None)) is row
    cut = batch_part(maps, 4, slice(None, 1))
    assert cut[0].shape == (1, 8, 8, 3) and cut[1] is maps[1]
    assert batch_part(7.5, 4, slice(None, 1)) == 7.5


def test_generate_splits_on_oom(monkeypatch):
    """A merged /generate of 4 requests that does not fit runs as 2 + 2,
    and serves the images of the unsplit dispatch."""
    server = Server(tiny())
    host, port = server.start(port=0)
    try:
        req = {"prompt": "split me", "count": 4, "seed": 3,
               "num_inference_steps": 2}
        status, want = _req(host, port, "POST", "/generate", req)
        assert status == 200
        sizes = inject_oom(monkeypatch, server.pipeline.engine, above=2)
        status, got = _req(host, port, "POST", "/generate", req)
        assert status == 200
        assert sizes == [4, 2, 2]
        assert got["images"] == want["images"]
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# repair: /warmup and the sampler of a concurrent /generate
# ---------------------------------------------------------------------------

def test_warmup_switches_the_jax_engines_sampler():
    """The JAX server's /warmup sets the live engine's sampler while it
    runs: a dispatch read at that moment (the batcher's, which does not take
    the dispatch lock) gets the warm-up's sampler."""
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    from stable_diffusion_videos_tpu.runtime.server import Server as JServer

    from test_torch_sdxl import jax_models
    jax_pipe = JaxWalk(jax_models(SDModels.tiny()), scheduler="pndm")
    server = JServer(jax_pipe)
    eng = jax_pipe.engine
    seen = []

    def warmup(**kw):
        seen.append(eng._sched_snapshot()[0])
        return 0.0

    eng.warmup = warmup
    out = server._handle_warmup({"schedulers": ["dpm"],
                                 "num_inference_steps": 2})
    assert set(out["schedulers"]) == {"dpm"}
    assert seen == ["dpm"]  # what a concurrent dispatch would have read
    assert eng.scheduler_name == "pndm"  # restored afterwards


def test_warmup_keeps_a_concurrent_generates_sampler(monkeypatch):
    """While the port's /warmup runs dpm, a concurrent /generate is served
    with the engine's pndm: its image is pndm's, not dpm's."""
    server = Server(tiny())
    host, port = server.start(port=0)
    eng = server.pipeline.engine
    real = eng.warmup
    started, served = threading.Event(), threading.Event()

    def slow_warmup(**kw):
        started.set()
        assert served.wait(120)
        return real(**kw)

    monkeypatch.setattr(eng, "warmup", slow_warmup)
    try:
        warm = {}
        t = threading.Thread(target=lambda: warm.update(body=_req(
            host, port, "POST", "/warmup",
            {"schedulers": ["dpm"], "num_inference_steps": 3})[1]))
        t.start()
        assert started.wait(60)
        status, body = _req(host, port, "POST", "/generate", {
            "prompt": "during warmup", "seed": 4, "num_inference_steps": 3})
        served.set()
        t.join(timeout=120)
        assert status == 200 and set(warm["body"]["schedulers"]) == {"dpm"}
        got = _png(body["images"][0])
        pipe = server.pipeline
        pndm = pipe.generate("during warmup", seed=4, num_inference_steps=3)
        np.testing.assert_array_equal(got, np.asarray(pndm[0]))
        pipe.set_scheduler("dpm")
        dpm = pipe.generate("during warmup", seed=4, num_inference_steps=3)
        pipe.set_scheduler("pndm")
        assert np.abs(got.astype(int) - np.asarray(dpm[0], int)).max() > 0
        assert eng.scheduler_name == "pndm"
        assert ("dpm", 1, 8, 8, 3, "float32") in eng.warmed
    finally:
        served.set()
        server.shutdown()


# ---------------------------------------------------------------------------
# repair: the kernel library's first build under threads
# ---------------------------------------------------------------------------

def test_first_build_is_one_build_across_threads(tmp_path, monkeypatch):
    """Eight threads make the first kernel call at once: one compile of
    each source, one link, one load, and every thread gets that library."""
    from stable_diffusion_videos_tpu_torch.ops import build
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_LOADED", [])
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    compiles, links, loads = [], [], []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            compiles.append(cmd[cmd.index("-o") + 1])

        def communicate(self):
            time.sleep(0.2)  # both threads are inside the build by now
            return ("ptxas info: 0 bytes spill\n", None)

    def link(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        links.append(out)
        pathlib.Path(out).write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    prepared = []

    class Entry:
        """An entry point: takes its ctypes signature, returns 0."""

        def __init__(self, name):
            self.__name__ = name

        def __call__(self, *args):
            prepared.append(self.__name__)
            return 0

    class Lib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            entry = Entry(name)
            setattr(self, name, entry)
            return entry

    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build.subprocess, "run", link)
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.library()))
               for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n_cu = len(list(build.CSRC.glob("*.cu")))
    assert len(compiles) == n_cu and len(links) == 1 and len(loads) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    # the kernels were prepared once, under the lock, before any launch
    assert prepared == ["sdv_prepare_attention", "sdv_prepare_groupnorm",
                        "sdv_prepare_attention_backward",
                        "sdv_prepare_groupnorm_backward"]
    # the temporary names carry the process and the thread
    tag = pathlib.Path(links[0]).name.split(".", 1)[1]
    assert tag.count(".") == 2 and tag.endswith(".so")
    assert (pathlib.Path(loads[0]).name == "libsdv_kernels.so"
            and pathlib.Path(loads[0]).exists())
    assert build.library() is got[0] and len(loads) == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_launch_from_many_threads(cuda):
    """Eight host threads launch GroupNorm at shapes of different shared
    memory (on chip, 4 to 64 KB a block, and streamed) and attention at
    once, as a server's handler and batcher threads do: every launch
    succeeds and matches the plain version."""
    from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu, groupnorm_reference)
    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(2, 320, 16, 16), (2, 640, 64, 64), (1, 512, 128, 128),
              (1, 256, 512, 512)]
    gn = [(torch.randn(s, device=cuda, generator=g).to(torch.bfloat16),
           torch.randn(s[1], device=cuda, generator=g).to(torch.bfloat16),
           torch.randn(s[1], device=cuda, generator=g).to(torch.bfloat16))
          for s in shapes]
    qkv = [torch.randn(2, 1024, 8, 40, device=cuda, generator=g)
           .to(torch.bfloat16) for _ in range(3)]
    want = ([groupnorm_reference(x, w, b, 32, 1e-6, True) for x, w, b in gn]
            + [flash_attention_reference(*qkv)])
    errors, results = [], []

    def work(i):
        try:
            for r in range(40):
                j = (i + r) % (len(gn) + 1)
                out = (fused_groupnorm_silu(*gn[j], 32, 1e-6, True)
                       if j < len(gn) else flash_attention(*qkv))
                results.append((j, out))
        except Exception as e:  # reported below, with every thread's
            errors.append(f"thread {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=120) for t in threads]
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert not errors, "\n".join(errors)
    assert len(results) == 320
    for j, out in results:
        torch.testing.assert_close(out.float(), want[j].float(), atol=2e-2,
                                   rtol=2e-2)
