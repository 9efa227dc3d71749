"""Where a dispatch's time goes on the GPU.

    python3 -m stable_diffusion_videos_tpu_torch.runtime.profile

Builds the random SD 1.x bundle in bf16, times two dispatches of 8 frames
(pndm-50, 512², CFG 7.5; the first warms up) on the host clock ending in a
synchronize, times the decode alone with CUDA events, then runs one 10-step
dispatch under ``torch.profiler`` and prints device time by kernel family
and the device idle share.  Then the few-step point on the same weights:
one full and one shallow (DeepCache, split 1) UNet call at CFG batch 16
timed with CUDA events, two dpm-20 x ``step_cache=2`` "ends" dispatches
timed as above, and one under the profiler.  Then the distilled point: lcm-4
cond-only under frozen noise at batch 8, two dispatches timed and one
profiled, with the KL decoder and with the TAESD tiny decoder.  Last,
SDXL-base at 1024² on its random bf16 bundle: three warm dispatches of one
frame (pndm-50, CFG 7.5) timed as above after one that warms up, and one
10-step dispatch profiled.  Needs a CUDA device; exits non-zero without
one.
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models.bundle import SDModels
from ..pipeline import StableDiffusionWalkPipeline
from .engine import Engine

#: kernel-name fragments -> family, first match wins
FAMILIES = (("flash_", "flash attention"), ("gn_", "groupnorm"),
            ("conv", "convolution"), ("cudnn", "convolution"),
            ("xmma", "convolution"), ("gemm", "matmul"), ("nvjet", "matmul"),
            ("cutlass", "matmul"))
TIMED_DISPATCHES = 2
PROFILE_STEPS = 10


def family(kernel_name: str) -> str:
    name = kernel_name.lower()
    return next((f for frag, f in FAMILIES if frag in name), "other")


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean ms a call of ``fn`` between two CUDA events, after one warm
    call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_dispatches(dispatch, label: str, runs: int = TIMED_DISPATCHES,
                     frames: int = 8):
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        print(f"dispatch {i} ({frames} frames, {label}): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


def profiled(dispatch, label: str):
    """Run ``dispatch`` under the profiler; print device time by family,
    the idle share and the 20 largest kernels."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    print(f"profiled {label} dispatch: wall {wall_ms:.1f} ms (profiler "
          f"on), device busy {busy:.1f} ms, idle share "
          f"{1 - busy / wall_ms:.4f}")
    by_family: dict[str, float] = {}
    for name, ms, _ in kernels:
        by_family[family(name)] = by_family.get(family(name), 0.0) + ms
    for fam, ms in sorted(by_family.items(), key=lambda x: -x[1]):
        print(f"  {fam}: {ms:.1f} ms ({100 * ms / busy:.1f}%)")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:20]:
        print(f"  {ms:9.2f} ms  x{n:5d}  {name[:100]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    models = SDModels.random("sd1", seed=1, dtype=torch.bfloat16,
                             taesd=True)
    pipe = StableDiffusionWalkPipeline(models, dev)
    eng = pipe.engine
    cond = pipe.embed_text("a red fox").expand(8, -1, -1)
    uncond = pipe.embed_text("")
    noise = torch.randn(8, 64, 64, 4,
                        generator=torch.Generator().manual_seed(0))

    def dispatch(engine, steps, guidance=7.5):
        # ends in a device->host copy
        return lambda: engine.denoise_frames(cond, uncond, noise,
                                             num_inference_steps=steps,
                                             guidance_scale=guidance,
                                             output_dtype="uint8")

    timed_dispatches(dispatch(eng, 50), "pndm-50")
    lat = torch.randn(8, 4, 64, 64, device=dev)
    with torch.no_grad():
        print(f"decode alone (8 x 512^2): "
              f"{cuda_ms(lambda: eng._decode(lat, True), reps=1):.2f} ms")
    profiled(dispatch(eng, PROFILE_STEPS), f"{PROFILE_STEPS}-step pndm")

    x = torch.randn(16, 4, 64, 64, device=dev)
    t = torch.full((16,), 501.0, device=dev)
    ctx = torch.cat([uncond.expand(8, -1, -1), cond])
    with torch.no_grad():
        _, deep = models.unet(x, t, ctx, cache_split=1)
        full = cuda_ms(lambda: models.unet(x, t, ctx, cache_split=1))
        shallow = cuda_ms(lambda: models.unet(x, t, ctx, cache_split=1,
                                              deep_feature=deep))
    print(f"UNet call at batch 16: full {full:.2f} ms, shallow (split 1) "
          f"{shallow:.2f} ms ({shallow / full:.3f} of full)")
    few = Engine(models, dev, scheduler="dpm", step_cache=2,
                 step_cache_policy="ends")
    timed_dispatches(dispatch(few, 20), "dpm-20 x k=2 ends")
    profiled(dispatch(few, 20), "dpm-20 x k=2 ends")

    for tiny in (False, True):
        label = "lcm-4 cond-only frozen, " + ("TAESD" if tiny else "KL")
        lcm = Engine(models, dev, scheduler="lcm", frozen_noise=True,
                     guidance_interval=(0.0, 0.0), tiny_decoder=tiny)
        timed_dispatches(dispatch(lcm, 4, guidance=1.0), label)
        profiled(dispatch(lcm, 4, guidance=1.0), label)

    del pipe, eng, few, lcm, models
    torch.cuda.empty_cache()
    xl = Engine(SDModels.random("sdxl", seed=2, dtype=torch.bfloat16)
                .to(dev), dev)
    prompt = "a red fox"
    xl_in = dict(cond=xl.embed_text(prompt), uncond=xl.embed_text(""),
                 noise=torch.randn(1, 128, 128, 4, generator=torch.Generator()
                                   .manual_seed(3)),
                 pooled=xl.embed_text_pooled(prompt),
                 uncond_pooled=xl.embed_text_pooled(""),
                 guidance_scale=7.5, output_dtype="uint8")

    def xl_dispatch(steps):
        return lambda: xl.denoise_frames(num_inference_steps=steps, **xl_in)

    xl_dispatch(50)()
    timed_dispatches(xl_dispatch(50), "SDXL-base 1024², pndm-50", runs=3,
                     frames=1)
    profiled(xl_dispatch(PROFILE_STEPS), f"{PROFILE_STEPS}-step SDXL pndm")


if __name__ == "__main__":
    main()
