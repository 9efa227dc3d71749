"""Entry ``serve``: the port's HTTP server (``runtime/server.Server``) in
the run's own process on 127.0.0.1, an ephemeral port, its batcher at the
mix's ``max_batch`` and ``batch_delay_ms``, under an open loop of
``POST /generate`` (one prompt, one seed, ``count`` 1) at the mix's fixed
rate (``traffic.arrivals``).

A request's latency runs from its due time to the whole reply read.  Every
request due in the window counts; the run waits up to ``drain_s`` past the
window's end for the ones in flight (and, above capacity, still queued).
A request that fails, is refused or never answers counts as failed, with
the time the run waited for it.  ``completed``: the replies that arrived
inside the window.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import flops, traffic
from ..reference import pipeline as ref_pipeline


def _spec(run) -> dict:
    f = 2 ** (len(run.config["vae"]["block_out_channels"]) - 1)
    return {"sampler": "pndm", "steps": run.mix["steps"],
            "guidance": run.mix["guidance"], "cfg": True,
            "latent": (run.height // f, run.width // f)}


def setup(run):
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.server import Server
    mix = run.mix
    pipe = StableDiffusionWalkPipeline(run.models, run.device,
                                       scheduler=mix["sampler"],
                                       safety=False)
    server = Server(pipe, max_batch=mix["max_batch"],
                    batch_delay_ms=mix["batch_delay_ms"],
                    output_root=str(run.out_dir))
    dispatches: list = []
    inner = server.batcher.dispatch

    def dispatch(prompts, seeds, signature):
        # what the batcher merged: when the dispatch began, its seeds
        t0 = time.perf_counter()
        with run.spans.span("batcher.dispatch"):
            out = inner(prompts, seeds, signature)
        dispatches.append((t0, time.perf_counter(), list(seeds)))
        return out
    server.batcher.dispatch = dispatch
    run.spans.wrap(pipe.engine, "denoise_frames_device", "engine.dispatch")
    run.spans.wrap(pipe, "_postprocess_frames", "server.to_host")
    host, port = server.start("127.0.0.1", 0)
    state = {"pipe": pipe, "server": server, "port": port,
             "dispatches": dispatches, "spec": _spec(run)}
    # every merged batch size at the cell's shapes, a few steps each, then
    # one request over HTTP at the cell's steps
    sig = (mix["warmup_steps"], float(mix["guidance"]), 0.0, run.height,
           run.width, "")
    r = traffic.rng(run.seed, 5)
    for b in range(1, mix["max_batch"] + 1):
        server._run_batch([traffic.prompt(mix, r) for _ in range(b)],
                          traffic.seeds(r, b), sig)
    _post(state, run, traffic.prompt(mix, r), traffic.seeds(r, 1)[0],
          timeout=600)
    dispatches.clear()
    return state


def _post(state, run, prompt, seed, timeout):
    body = json.dumps({"prompt": prompt, "seed": int(seed),
                       "num_inference_steps": run.mix["steps"],
                       "guidance_scale": run.mix["guidance"],
                       "height": run.height, "width": run.width,
                       "count": 1})
    conn = http.client.HTTPConnection("127.0.0.1", state["port"],
                                      timeout=timeout)
    try:
        conn.request("POST", "/generate", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        return json.loads(data)["images"][0]
    finally:
        conn.close()


def _load(run, state, plan, start, deadline):
    """Send ``plan`` [(due, prompt, seed)] from ``start`` (perf_counter);
    -> one record a request: due, sent, done (None when it failed),
    seed, prompt, the PNG (base64) or the error."""
    records = [{"due": start + d, "seed": s, "prompt": p, "done": None}
               for d, p, s in plan]

    def one(rec):
        rec["sent"] = time.perf_counter()
        try:
            rec["png"] = _post(state, run, rec["prompt"], rec["seed"],
                               timeout=max(1.0, deadline - time.perf_counter()))
            rec["done"] = time.perf_counter()
        except Exception as e:  # counted as failed
            rec["error"] = repr(e)[:200]

    with ThreadPoolExecutor(max_workers=run.mix["client_threads"],
                            thread_name_prefix="client") as pool:
        for rec in records:
            delay = rec["due"] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            pool.submit(one, rec)
    return records


def window(run, state) -> dict:
    mix = run.mix
    plan = traffic.arrivals(mix, run.seed, run.seconds)
    start = time.perf_counter()
    records = _load(run, state, plan, start,
                    start + run.seconds + mix["drain_s"])
    end = time.perf_counter()
    lat = []
    for rec in records:
        rec["latency"] = ((rec["done"] if rec["done"] is not None else end)
                          - rec["due"])
        lat.append(rec["latency"])
    by_seed = {}
    for t0, _, seeds in state["dispatches"]:
        for s in seeds:
            by_seed.setdefault(s, t0)
    waits = [by_seed[r["seed"]] - r["due"] for r in records
             if r["seed"] in by_seed]
    rows = [len(s) for _, _, s in state["dispatches"]]
    calls = ref_pipeline.unet_calls("pndm", run.config["scheduler"],
                                    mix["steps"])
    model_flops = sum(
        flops.text(run.config, b).flops
        + flops.dispatch(run.config, b, calls, True,
                         state["spec"]["latent"]).flops for b in rows)
    failed = [r for r in records if r["done"] is None]
    for r in failed[:3]:
        run.log(f"request seed {r['seed']} failed: {r.get('error')}")
    close = start + run.seconds
    return {"seconds": run.seconds, "elapsed": end - start,
            "completed": sum(1 for r in records
                             if r["done"] is not None and r["done"] <= close),
            "attempted": len(records),
            "failed": len(failed), "latencies": lat, "queue_waits": waits,
            "dispatch_rows": rows, "model_flops": model_flops,
            "late_s": max(r["sent"] - r["due"] for r in records),
            "records": records}


def stretch(run, state) -> flops.Work:
    """The profiled stretch: ``profile_seconds`` of the same arrivals;
    -> the work of the dispatches it caused."""
    mix = run.mix
    state["dispatches"].clear()
    plan = traffic.arrivals(mix, run.seed, mix["profile_seconds"], tag=6)
    start = time.perf_counter()
    _load(run, state, plan, start, start + mix["profile_seconds"]
          + mix["drain_s"])
    calls = ref_pipeline.unet_calls("pndm", run.config["scheduler"],
                                    mix["steps"])
    work = flops.Work()
    for _, _, seeds in state["dispatches"]:
        work += flops.text(run.config, len(seeds))
        work += flops.dispatch(run.config, len(seeds), calls, True,
                               state["spec"]["latent"])
    return work


def check(run, state, result: dict, count: int) -> tuple:
    """(spec, items, program frames) of ``count`` answered requests drawn
    from the seed; a request that failed is not compared (it is counted in
    ``failed``)."""
    from PIL import Image
    done = [r for r in result["records"] if r["done"] is not None]
    r = traffic.rng(run.seed, 4)
    pick = sorted(r.choice(len(done), size=min(count, len(done)),
                           replace=False))
    items, imgs = [], []
    for i in pick:
        rec = done[i]
        items.append({"prompt_a": rec["prompt"], "prompt_b": rec["prompt"],
                      "seed_a": rec["seed"], "seed_b": rec["seed"],
                      "t": 0.0})
        png = Image.open(io.BytesIO(base64.b64decode(rec["png"])))
        imgs.append(np.asarray(png.convert("RGB")))
    return state["spec"], items, np.stack(imgs)


def teardown(run, state) -> None:
    server = state.get("server")
    if server is not None:
        server.shutdown()
    state.clear()

