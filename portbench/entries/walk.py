"""Entry ``walk``: ``StableDiffusionWalkPipeline.walk()`` run back to back.

Each walk has the mix's prompts and seeds (``traffic.walk``), writes its
PNGs and videos under the run's scratch directory and is deleted once the
frames kept for the check are read back.  Walks start until ``--seconds``
have passed; the walk in progress finishes and counts.
"""

from __future__ import annotations

import shutil
import time

import numpy as np

from .. import flops, traffic
from ..reference import pipeline as ref_pipeline

#: walk indices of the warm-up and the profiled stretch (the window's
#: walks count from 0)
WARMUP = 1 << 30


def _spec(run) -> dict:
    mix, cfg = run.mix, run.config
    interval = mix.get("guidance_interval")
    if interval not in (None, [0, 1], [0, 0]):
        raise ValueError("the reference runs CFG on every step or on none")
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return {"sampler": mix["sampler"], "steps": mix["steps"],
            "guidance": mix["guidance"], "cfg": interval != [0, 0],
            "latent": (run.height // f, run.width // f)}


def setup(run):
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    mix = run.mix
    interval = mix.get("guidance_interval")
    pipe = StableDiffusionWalkPipeline(
        run.models, run.device, scheduler=mix["sampler"], safety=False,
        frozen_noise=mix.get("frozen_noise", False),
        guidance_interval=None if interval is None else tuple(interval))
    run.spans.wrap(pipe, "walk", "walk")
    run.spans.wrap(pipe, "_embed", "walk.embed")
    run.spans.wrap(pipe.engine, "denoise_frames_async", "engine.dispatch")
    run.spans.wrap(pipe, "_postprocess_frames", "walk.to_host")
    state = {"pipe": pipe, "spec": _spec(run)}
    # the cell's shapes, batch and host path at a few steps
    _walk(run, state, traffic.walk(mix, run.seed, WARMUP), "warmup",
          steps=mix["warmup_steps"], frames=mix["batch"])
    return state


def _walk(run, state, plan, name, steps=None, frames=None):
    mix = run.mix
    state["pipe"].walk(
        prompts=plan["prompts"], seeds=plan["seeds"],
        num_interpolation_steps=frames or mix["interpolation_steps"],
        output_dir=str(run.out_dir), name=name, fps=mix["fps"],
        num_inference_steps=steps or mix["steps"],
        guidance_scale=mix["guidance"], batch_size=mix["batch"],
        height=run.height, width=run.width, make_video=mix["make_video"])
    return run.out_dir / name


def _dispatch_rows(mix, clips, per_clip):
    b = mix["batch"]
    return [min(b, per_clip - i) for _ in range(clips)
            for i in range(0, per_clip, b)]


def window(run, state) -> dict:
    from stable_diffusion_videos_tpu_torch.utils.profiling import StageTimer
    mix, pipe = run.mix, state["pipe"]
    per_clip = mix["interpolation_steps"]
    clips = mix["prompts_per_walk"] - 1
    unet_calls = ref_pipeline.unet_calls(mix["sampler"],
                                         run.config["scheduler"],
                                         mix["steps"])
    per_walk = flops.text(run.config, mix["prompts_per_walk"]).flops + sum(
        flops.dispatch(run.config, rows, unet_calls, state["spec"]["cfg"],
                       state["spec"]["latent"]).flops
        for rows in _dispatch_rows(mix, clips, per_clip))
    keep = run.limits["sample"]["per_walk"]
    pipe.timer = StageTimer()
    kept, walks, done = [], 0, 0
    t0 = time.perf_counter()
    while True:
        plan = traffic.walk(mix, run.seed, walks)
        path = _walk(run, state, plan, f"walk{walks:05d}")
        done += clips * per_clip
        r = traffic.rng(run.seed, 3, walks)
        for k in r.choice(clips * per_clip, size=keep, replace=False):
            c, j = divmod(int(k), per_clip)
            png = path / f"walk{walks:05d}_{c:06d}" / f"frame{j:06d}.png"
            kept.append(({
                "prompt_a": plan["prompts"][c],
                "prompt_b": plan["prompts"][c + 1],
                "seed_a": plan["seeds"][c], "seed_b": plan["seeds"][c + 1],
                "t": float(np.linspace(0.0, 1.0, per_clip)[j]),
                "noise_key": (plan["seeds"][0] if mix.get("frozen_noise")
                              else None)}, run.read_png(png)))
        shutil.rmtree(path)
        walks += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    return {"seconds": wall, "frames": done, "attempted": done,
            "walks": walks, "model_flops": per_walk * walks,
            "stages": pipe.timer.summary()["stages_s"], "kept": kept}


def stretch(run, state) -> flops.Work:
    """The profiled stretch: one more walk of the mix; -> its work."""
    mix = run.mix
    path = _walk(run, state, traffic.walk(mix, run.seed, WARMUP + 1),
                 "profiled")
    shutil.rmtree(path)
    unet_calls = ref_pipeline.unet_calls(mix["sampler"],
                                         run.config["scheduler"],
                                         mix["steps"])
    work = flops.text(run.config, mix["prompts_per_walk"])
    for rows in _dispatch_rows(mix, mix["prompts_per_walk"] - 1,
                               mix["interpolation_steps"]):
        work += flops.dispatch(run.config, rows, unet_calls,
                               state["spec"]["cfg"],
                               state["spec"]["latent"])
    return work


def unet_rows(run, state) -> int:
    return run.mix["batch"] * (2 if state["spec"]["cfg"] else 1)


def check(run, state, result: dict, count: int) -> tuple:
    """(spec, items, program frames) of ``count`` kept frames drawn from
    the seed, ordered by noise key."""
    kept = result["kept"]
    r = traffic.rng(run.seed, 4)
    pick = sorted(r.choice(len(kept), size=min(count, len(kept)),
                           replace=False),
                  key=lambda i: (kept[i][0]["noise_key"] or 0, i))
    return (state["spec"], [kept[i][0] for i in pick],
            np.stack([kept[i][1] for i in pick]))


def teardown(run, state) -> None:
    state.clear()
