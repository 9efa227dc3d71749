"""HTTP serving: a JSON API over the walk pipeline, standard library only.

Counterpart of ``stable_diffusion_videos_tpu/runtime/server.py``, with the
same routes, bodies, allowlists, ceilings and status codes: a thread a
connection (``ThreadingHTTPServer``), a dynamic batcher merging concurrent
``/generate`` requests (``runtime/batcher.py``), one dispatch lock
serialising the long jobs and the other dispatches, and a job manager.

* ``GET  /health``    -> {status, backend (the torch device type), devices,
                          jobs, compiled_programs (the warmed keys)}
* ``POST /generate``  -> {images: [base64 PNG], seeds, format}
    body: {prompt | prompts, negative_prompt?, seed? | seeds?,
           num_inference_steps?, guidance_scale?, eta?, height?, width?,
           count?}
* ``POST /img2img`` / ``POST /inpaint`` -> {images: [base64 PNG], format}
* ``POST /warmup``    -> {schedulers: {name: seconds}, compiled_programs,
                          num_inference_steps, batches} or, with
                          ``async: true``, 202 {job_id}; the named samplers
                          run without switching the engine's own
* ``POST /walk`` / ``POST /vid2vid`` -> 202 {job_id}
* ``GET  /jobs/<id>`` -> {status: queued|running|cancelling|cancelled|done|
                          error, progress?, result?, error?}
* ``DELETE /jobs/<id>`` -> 202 {status: cancelling}: the job stops at its
                          next frame batch, and its half-written video is
                          removed

The JAX server's ``/warmup`` switches the live engine's sampler while it
runs, so a ``/generate`` dispatched meanwhile (the batcher does not take the
dispatch lock) is denoised with the warm-up's sampler; here the warm-up
names its sampler to each dispatch instead.  The listen backlog is 128
connections (``_HTTPServer``), where socketserver's default of 5 makes a
burst of more clients wait for TCP's retry.  Output and audio paths stay
under ``output_root``.  Start: ``python -m stable_diffusion_videos_tpu_torch
serve`` or ``Server(pipeline).serve_forever(port=8000)``.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import torch

from ..core.schedulers import get_scheduler
from .batcher import DynamicBatcher

logger = logging.getLogger("sdv_torch")


class _HTTPServer(ThreadingHTTPServer):
    """A thread a connection, with a listen backlog for a burst of clients:
    socketserver's default of 5 lets the kernel drop the connections of a
    larger burst, which then retry a second later."""
    request_queue_size = 128
    daemon_threads = True


class JobCancelled(Exception):
    """Raised inside a job once its cancel event is set; the walk's
    cleanup removes any half-written video container."""


class JobManager:
    def __init__(self):
        self._jobs: dict[str, dict] = {}
        self._cancel: dict[str, threading.Event] = {}
        self._lock = threading.Lock()

    def submit(self, fn, *args, **kwargs) -> str:
        job_id = uuid.uuid4().hex[:12]
        with self._lock:
            self._jobs[job_id] = {"status": "queued"}
            self._cancel[job_id] = threading.Event()

        def run():
            with self._lock:
                if self._cancel[job_id].is_set():  # cancelled while queued
                    self._jobs[job_id]["status"] = "cancelled"
                    return
                self._jobs[job_id]["status"] = "running"
            try:
                result = fn(*args, **kwargs)
                with self._lock:
                    self._jobs[job_id].update(status="done", result=result)
            except JobCancelled:
                logger.info("job %s cancelled", job_id)
                with self._lock:
                    self._jobs[job_id]["status"] = "cancelled"
            except Exception as e:  # reported through the API
                logger.exception("job %s failed", job_id)
                with self._lock:
                    self._jobs[job_id].update(
                        status="error", error=f"{type(e).__name__}: {e}")

        threading.Thread(target=run, daemon=True).start()
        return job_id

    def cancel(self, job_id: str) -> bool:
        """Ask a job to stop; it does at its next progress tick (a frame
        batch: a dispatch is never interrupted)."""
        with self._lock:
            if job_id not in self._jobs:
                return False
            if self._jobs[job_id]["status"] in ("done", "error", "cancelled"):
                return False
            self._cancel[job_id].set()
            self._jobs[job_id]["status"] = "cancelling"
            return True

    def cancel_event(self, job_id: str) -> threading.Event:
        with self._lock:
            return self._cancel[job_id]

    def update(self, job_id: str, **fields):
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id].update(fields)

    def get(self, job_id: str) -> dict | None:
        with self._lock:
            job = self._jobs.get(job_id)
            return dict(job) if job else None

    def count(self) -> dict:
        with self._lock:
            out: dict[str, int] = {}
            for j in self._jobs.values():
                out[j["status"]] = out.get(j["status"], 0) + 1
            return out


def _png_b64(pil) -> str:
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _image(b64: str):
    from PIL import Image
    return Image.open(io.BytesIO(base64.b64decode(b64)))


class Server:
    #: request ceilings: an unauthenticated caller must not pin the card
    #: with count=10^6 or steps=10^5
    MAX_COUNT = 64
    MAX_STEPS = 200
    MAX_SIDE = 2048

    #: the /walk body keys forwarded into walk(); anything else is a 400.
    #: Absent on purpose: upsample_weights (a server path, set by the
    #: operator), params/jit (ignored by the engine)
    WALK_KWARGS = frozenset({
        "prompts", "seeds", "num_interpolation_steps", "name",
        "image_file_ext", "fps", "num_inference_steps", "guidance_scale",
        "eta", "height", "width", "upsample", "batch_size", "resume",
        "audio_filepath", "audio_start_sec", "margin", "smooth",
        "negative_prompt", "make_video", "output_dir",
    })
    #: /warmup body allowlist
    WARMUP_KWARGS = frozenset({
        "num_inference_steps", "height", "width", "batches", "schedulers",
        "scheduler", "output_dtypes", "async",
    })
    #: /vid2vid body allowlist; the video comes as base64 bytes ('video')
    #: or a path under the output root ('video_path')
    VID2VID_KWARGS = frozenset({
        "video", "video_path", "video_format", "prompt", "strength",
        "num_inference_steps", "guidance_scale", "negative_prompt", "seed",
        "height", "width", "fps", "batch_size", "frame_skip", "max_frames",
        "name", "audio_filepath", "per_frame_noise", "ip_image", "ip_scale",
    })
    #: frames a /vid2vid job at most
    MAX_VID_FRAMES = 2048

    def __init__(self, pipeline, max_batch: int = 16,
                 batch_delay_ms: float = 25.0,
                 output_root: str = "./dreams"):
        self.pipeline = pipeline
        self.jobs = JobManager()
        #: serialises the jobs, the edit paths and the warm-up
        self.dispatch_lock = threading.Lock()
        self.batcher = DynamicBatcher(pipeline, max_batch=max_batch,
                                      max_delay_ms=batch_delay_ms)
        #: every path a request names resolves under this directory
        self.output_root = Path(output_root).resolve()
        self._httpd = None

    def _confine(self, sub) -> str:
        """A client's relative path resolved under ``output_root``; an
        absolute path or a ``..`` escape is refused."""
        if sub is None:
            return str(self.output_root)
        p = Path(str(sub))
        if p.is_absolute():
            raise ValueError("output_dir must be relative (it is created "
                             "under the server's output root)")
        full = (self.output_root / p).resolve()
        if full != self.output_root and self.output_root not in full.parents:
            raise ValueError("output_dir escapes the server output root")
        return str(full)

    def _steps(self, body: dict) -> int:
        return max(1, min(int(body.get("num_inference_steps", 50)),
                          self.MAX_STEPS))

    def _side(self, body: dict, key: str):
        v = body.get(key)
        if v is None:
            return None
        return max(64, min(int(v), self.MAX_SIDE))

    # ------------------------------------------------------------------
    def _handle_health(self):
        dev = torch.device(self.pipeline.device)
        return {
            "status": "ok",
            "backend": dev.type,
            "devices": (torch.cuda.device_count() if dev.type == "cuda"
                        else 1),
            "jobs": self.jobs.count(),
            "compiled_programs": len(self.pipeline.engine.warmed),
        }

    def _handle_generate(self, body: dict):
        prompts = body.get("prompts") or [body.get("prompt")]
        if not prompts or prompts[0] is None:
            raise ValueError("missing 'prompt' or 'prompts'")
        count = int(body.get("count", 1))
        if count > self.MAX_COUNT:
            raise ValueError(f"count {count} > limit {self.MAX_COUNT}")
        if count > 1 and len(prompts) == 1:
            prompts = prompts * count
        if len(prompts) > self.MAX_COUNT:
            raise ValueError(f"{len(prompts)} prompts > limit "
                             f"{self.MAX_COUNT}")
        seed = int(body.get("seed", 0))
        seeds = body.get("seeds") or [seed + i for i in range(len(prompts))]
        if len(seeds) != len(prompts):
            raise ValueError("len(seeds) != len(prompts)")
        futures = [self.batcher.submit(
            prompt, s, num_inference_steps=self._steps(body),
            guidance_scale=float(body.get("guidance_scale", 7.5)),
            eta=float(body.get("eta", 0.0)),
            height=self._side(body, "height"),
            width=self._side(body, "width"),
            negative_prompt=body.get("negative_prompt"))
            for prompt, s in zip(prompts, seeds)]
        # the frames stay on the device until post-processing: one copy
        images = torch.stack([f.result(timeout=600) for f in futures])
        pipe = self.pipeline
        pils = pipe._postprocess(images, upsample=pipe.upsampler is not None)
        return {"images": [_png_b64(p) for p in pils],
                "seeds": list(map(int, seeds)), "format": "png;base64"}

    def _handle_img2img(self, body: dict):
        if "image" not in body or "prompt" not in body:
            raise ValueError("img2img requires 'image' (base64 PNG/JPEG) "
                             "and 'prompt'")
        img = _image(body["image"])
        ip_kw = {}
        if body.get("ip_image"):
            # needs a pipeline built with ip_adapter=, which says so
            ip_kw = dict(ip_image=_image(body["ip_image"]),
                         ip_scale=float(body.get("ip_scale", 1.0)))
        with self.dispatch_lock:
            pils = self.pipeline.img2img(
                img, body["prompt"],
                strength=float(body.get("strength", 0.75)),
                num_inference_steps=self._steps(body),
                guidance_scale=float(body.get("guidance_scale", 7.5)),
                negative_prompt=body.get("negative_prompt"),
                seed=int(body.get("seed", 0)), **ip_kw)
        return {"images": [_png_b64(pils[0])], "format": "png;base64"}

    def _handle_inpaint(self, body: dict):
        for k in ("image", "mask", "prompt"):
            if k not in body:
                raise ValueError(f"inpaint requires '{k}'")
        with self.dispatch_lock:
            pils = self.pipeline.inpaint(
                _image(body["image"]), _image(body["mask"]), body["prompt"],
                num_inference_steps=self._steps(body),
                guidance_scale=float(body.get("guidance_scale", 7.5)),
                negative_prompt=body.get("negative_prompt"),
                seed=int(body.get("seed", 0)))
        return {"images": [_png_b64(pils[0])], "format": "png;base64"}

    def _handle_warmup(self, body: dict):
        """One dispatch a (sampler, batch, output dtype) at zero inputs, so
        that the first request meets built kernels, TMA maps, cuDNN plans
        and cached tables.  body: {num_inference_steps?, height?, width?,
        batches?: [int|null], scheduler? | schedulers?: [name],
        output_dtypes?: [str], async?: bool}.  Each sampler is named to its
        dispatches; the engine's own is never switched, so a concurrent
        ``/generate`` keeps the sampler it asked for."""
        unknown = sorted(set(body) - self.WARMUP_KWARGS)
        if unknown:
            raise ValueError(f"unknown warmup parameters: {unknown} "
                             f"(allowed: {sorted(self.WARMUP_KWARGS)})")
        eng = self.pipeline.engine
        for name in ("schedulers", "batches", "output_dtypes"):
            v = body.get(name)
            if v is not None and not isinstance(v, list):
                raise ValueError(f"'{name}' must be a JSON list, got "
                                 f"{type(v).__name__}")
        schedulers = body.get("schedulers") or (
            [body["scheduler"]] if body.get("scheduler")
            else [eng.scheduler_name])
        if len(schedulers) > 8:
            raise ValueError("at most 8 schedulers per warmup call")
        for s in schedulers:
            try:
                get_scheduler(s)  # an unknown name is a 400 before any run
            except KeyError as e:
                raise ValueError(str(e.args[0] if e.args else e)) from e
        batches = body.get("batches") or [None]
        if len(batches) > 4:
            raise ValueError("at most 4 batch shapes per warmup call")
        batches = tuple(None if b is None else max(1, min(int(b),
                                                          self.MAX_COUNT))
                        for b in batches)
        dtypes = body.get("output_dtypes") or ["float32"]
        if not set(dtypes) <= {"float32", "uint8"}:
            raise ValueError("output_dtypes entries must be float32|uint8")
        steps = self._steps(body)
        height, width = self._side(body, "height"), self._side(body, "width")

        def run():
            report: dict = {"schedulers": {}}
            with self.dispatch_lock:
                for name in schedulers:
                    report["schedulers"][name] = round(sum(
                        eng.warmup(num_inference_steps=steps, height=height,
                                   width=width, batches=batches,
                                   output_dtype=dt, scheduler=name)
                        for dt in dtypes), 3)
            report["compiled_programs"] = len(eng.warmed)
            report["num_inference_steps"] = steps
            report["batches"] = [b or eng.batch_bucket for b in batches]
            return report

        if body.get("async"):
            return {"job_id": self.jobs.submit(run)}
        return run()

    def _job(self, call, cleanup=None):
        """Submit ``call()`` as a job whose progress ticks update it and
        stop it once cancelled; -> {job_id}."""
        holder: dict = {}

        def run():
            def hook(p):
                # the first tick can come before submit() returns the id
                if "id" in holder:
                    self.jobs.update(holder["id"], progress=p)
                    if self.jobs.cancel_event(holder["id"]).is_set():
                        raise JobCancelled(holder["id"])
            with self.dispatch_lock:
                self.pipeline.on_progress = hook
                try:
                    result = call()
                finally:
                    self.pipeline.on_progress = None
                    if cleanup is not None:
                        cleanup.unlink(missing_ok=True)
            return {"video": result, "perf": self.pipeline.timer.summary()}

        holder["id"] = self.jobs.submit(run)
        return {"job_id": holder["id"]}

    def _handle_walk(self, body: dict):
        unknown = sorted(set(body) - self.WALK_KWARGS)
        if unknown:
            raise ValueError(f"unknown walk parameters: {unknown} "
                             f"(allowed: {sorted(self.WALK_KWARGS)})")
        body = dict(body)
        body["output_dir"] = self._confine(body.get("output_dir"))
        if body.get("audio_filepath") is not None:
            # a file the server reads: under the output root too
            body["audio_filepath"] = self._confine(body["audio_filepath"])
        if "num_inference_steps" in body:
            body["num_inference_steps"] = self._steps(body)
        for k in ("height", "width"):
            if body.get(k) is not None:
                body[k] = self._side(body, k)
        return self._job(lambda: self.pipeline.walk(**body))

    def _handle_vid2vid(self, body: dict):
        unknown = sorted(set(body) - self.VID2VID_KWARGS)
        if unknown:
            raise ValueError(f"unknown vid2vid parameters: {unknown} "
                             f"(allowed: {sorted(self.VID2VID_KWARGS)})")
        if not body.get("prompt"):
            raise ValueError("vid2vid requires 'prompt'")
        if ("video" in body) == ("video_path" in body):
            raise ValueError("vid2vid requires exactly one of 'video' "
                             "(base64 bytes) or 'video_path' (relative to "
                             "the server output root)")
        self.output_root.mkdir(parents=True, exist_ok=True)
        cleanup = None
        if "video" in body:
            fmt = str(body.get("video_format", "mp4")).lstrip(".")
            if not fmt.isalnum():
                raise ValueError(f"bad video_format {fmt!r}")
            src = self.output_root / f".upload_{uuid.uuid4().hex}.{fmt}"
            src.write_bytes(base64.b64decode(body["video"]))
            cleanup = src
        else:
            p = Path(str(body["video_path"]))
            if p.is_absolute():
                raise ValueError("video_path must be relative (resolved "
                                 "under the server's output root)")
            src = Path(self._confine(str(p)))
            if not src.is_file():
                raise ValueError("video_path not found under output root")
        name = Path(str(body.get("name")
                        or f"vid2vid_{uuid.uuid4().hex[:8]}")).name
        kwargs = dict(
            strength=float(body.get("strength", 0.5)),
            num_inference_steps=self._steps(body),
            guidance_scale=float(body.get("guidance_scale", 7.5)),
            negative_prompt=body.get("negative_prompt"),
            seed=int(body.get("seed", 0)),
            height=self._side(body, "height"),
            width=self._side(body, "width"),
            fps=float(body["fps"]) if body.get("fps") else None,
            batch_size=(int(body["batch_size"]) if body.get("batch_size")
                        else None),
            frame_skip=max(1, int(body.get("frame_skip", 1))),
            max_frames=min(int(body.get("max_frames", self.MAX_VID_FRAMES)),
                           self.MAX_VID_FRAMES),
            output_filepath=str(self.output_root / f"{name}.mp4"),
            audio_filepath=(self._confine(body["audio_filepath"])
                            if body.get("audio_filepath") else None),
            shared_noise=not bool(body.get("per_frame_noise", False)))
        if body.get("ip_image"):
            kwargs["ip_image"] = _image(body["ip_image"])
            kwargs["ip_scale"] = float(body.get("ip_scale", 1.0))
        return self._job(lambda: self.pipeline.vid2vid(
            str(src), body["prompt"], **kwargs), cleanup=cleanup)

    # ------------------------------------------------------------------
    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    return self._reply(200, server_self._handle_health())
                if self.path.startswith("/jobs/"):
                    job = server_self.jobs.get(self.path.split("/")[-1])
                    if job is None:
                        return self._reply(404, {"error": "unknown job"})
                    return self._reply(200, job)
                return self._reply(404, {"error": f"no route {self.path}"})

            def do_DELETE(self):
                if self.path.startswith("/jobs/"):
                    job_id = self.path.split("/")[-1]
                    if server_self.jobs.cancel(job_id):
                        return self._reply(202, {"status": "cancelling"})
                    job = server_self.jobs.get(job_id)
                    if job is None:
                        return self._reply(404, {"error": "unknown job"})
                    return self._reply(409, {"error": "not cancellable",
                                             "status": job["status"]})
                return self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError as e:
                    return self._reply(400, {"error": f"bad json: {e}"})
                routes = {"/generate": (server_self._handle_generate, 200),
                          "/img2img": (server_self._handle_img2img, 200),
                          "/inpaint": (server_self._handle_inpaint, 200),
                          "/warmup": (server_self._handle_warmup, 200),
                          "/walk": (server_self._handle_walk, 202),
                          "/vid2vid": (server_self._handle_vid2vid, 202)}
                if self.path not in routes:
                    return self._reply(404,
                                       {"error": f"no route {self.path}"})
                handle, code = routes[self.path]
                try:
                    out = handle(body)
                except (ValueError, TypeError, NotImplementedError) as e:
                    return self._reply(400, {"error": str(e)})
                except Exception as e:
                    logger.exception("request failed")
                    return self._reply(
                        500, {"error": f"{type(e).__name__}: {e}"})
                if self.path == "/warmup" and "job_id" in out:
                    code = 202
                return self._reply(code, out)
        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 8000):
        """Serve from a background thread; -> (host, the bound port)."""
        self._httpd = _HTTPServer((host, port), self.make_handler())
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        logger.info("serving on %s:%d", host, self._httpd.server_port)
        return host, self._httpd.server_port

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000):
        self._httpd = _HTTPServer((host, port), self.make_handler())
        logger.info("serving on %s:%d", host, self._httpd.server_port)
        try:
            self._httpd.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self):
        self.batcher.stop()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
