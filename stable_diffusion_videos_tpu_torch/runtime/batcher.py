"""Dynamic batching: concurrent txt2img requests merged into one dispatch.

Counterpart of ``stable_diffusion_videos_tpu/runtime/batcher.py``.  Requests
that share a signature (steps, guidance, eta, size, negative prompt) are
collected for up to ``max_delay_ms`` or ``max_batch`` requests and denoised
in one dispatch; requests of another signature go back to the queue.  Each
request's noise is ``pipeline.init_noise`` of its seed, concatenated on the
device, and each future resolves to its (H, W, 3) float32 frame, still on
the device: the caller post-processes the frames it gathers and copies them
to the host once.  A dispatch that runs out of device memory splits
(``Engine.denoise_frames_device``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import torch

logger = logging.getLogger("sdv_torch")


@dataclass
class _Request:
    prompt: str
    seed: int
    signature: tuple  # (steps, guidance, eta, height, width, negative)
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    def __init__(self, pipeline, max_batch: int = 16,
                 max_delay_ms: float = 25.0):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1000.0
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._drain = True
        self._lock = threading.Lock()

    def start(self):
        with self._lock:
            if not self._started:
                self._started = True
                # a new thread each start: a joined thread cannot restart
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name="dynamic-batcher")
                self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 120.0):
        """Shut down: ``drain=True`` (default) runs every request already
        queued first; ``drain=False`` fails their futures at once with
        ``RuntimeError``, so no client waits forever."""
        if self._started:
            self._drain = drain
            self._q.put(None)
            self._thread.join(timeout=timeout)
            self._started = False

    # ------------------------------------------------------------------
    def submit(self, prompt: str, seed: int, num_inference_steps: int = 50,
               guidance_scale: float = 7.5, eta: float = 0.0,
               height: Optional[int] = None, width: Optional[int] = None,
               negative_prompt: Optional[str] = None) -> Future:
        """-> a Future of one float32 (H, W, 3) frame in [0, 1], on the
        pipeline's device."""
        if not self._started:
            self.start()
        height = height or self.pipeline.models.default_size
        width = width or self.pipeline.models.default_size
        sig = (int(num_inference_steps), float(guidance_scale), float(eta),
               int(height), int(width), negative_prompt or "")
        req = _Request(prompt=prompt, seed=int(seed), signature=sig)
        self._q.put(req)
        return req.future

    # ------------------------------------------------------------------
    def _collect(self) -> list[_Request]:
        """Block for the first request, then gather requests of its
        signature for up to ``max_delay``; others go back to the queue."""
        first = self._q.get()
        if first is None:
            return []
        batch, deferred = [first], []
        deadline = time.monotonic() + self.max_delay
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                req = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # the shutdown marker, for the loop
                break
            if req.signature == first.signature:
                batch.append(req)
            else:
                deferred.append(req)
        for req in deferred:
            self._q.put(req)
        return batch

    def _loop(self):
        while True:
            batch = self._collect()
            if not batch:
                self._shutdown_pending()
                return
            self._run_safely(batch, "batched dispatch failed")

    def _run_safely(self, batch: list[_Request], what: str):
        try:
            self._run_batch(batch)
        except Exception as e:
            logger.exception(what)
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)

    def _shutdown_pending(self):
        """After the shutdown marker: the requests still queued run to the
        end (``drain``) or fail at once, never left pending."""
        rest: list[_Request] = []
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                rest.append(r)
        if not rest:
            return
        if not self._drain:
            err = RuntimeError("batcher stopped before request ran")
            for req in rest:
                if not req.future.done():
                    req.future.set_exception(err)
            return
        logger.info("batcher draining %d pending request(s)", len(rest))
        while rest:
            sig = rest[0].signature
            batch = [r for r in rest if r.signature == sig][:self.max_batch]
            ids = {id(r) for r in batch}
            rest = [r for r in rest if id(r) not in ids]
            self._run_safely(batch, "batched dispatch failed during drain")

    def _run_batch(self, batch: list[_Request]):
        pipe = self.pipeline
        steps, guidance, eta, height, width, negative = batch[0].signature
        logger.info("dynamic batch: %d request(s), steps=%d %dx%d",
                    len(batch), steps, height, width)
        prompts = [r.prompt for r in batch]
        eng = pipe.engine
        embeds, uncond = eng.embed_text(prompts), eng.embed_text(negative)
        xl_kw = {}
        if pipe.models.is_xl:
            xl_kw = dict(pooled=eng.embed_text_pooled(prompts),
                         uncond_pooled=eng.embed_text_pooled(negative))
        shape = pipe._latent_shape(height, width)
        noise = torch.cat([pipe.init_noise(r.seed, shape) for r in batch])
        with pipe.timer.stage("denoise", sync=pipe.device):
            images = eng.denoise_frames_device(
                embeds, uncond, noise, num_inference_steps=steps,
                guidance_scale=guidance, eta=eta, **xl_kw)
        pipe.timer.add_frames(len(batch))
        for req, img in zip(batch, images):
            req.future.set_result(img)
