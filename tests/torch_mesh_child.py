"""One rank of a two-process gloo group on the CPU, for
tests/test_torch_parallel.py, tests/test_torch_multihost.py and
tests/test_torch_mesh_training.py.

    python tests/torch_mesh_child.py <scenario> <port> <rank> [workdir]

Scenarios:

* ``multihost``: ``initialize_multihost(coordinator_address=...)`` and one
  data-parallel sum whose reduction crosses the processes (the counterpart
  of tests/multihost_child.py); prints ``PROBE`` lines;
* ``unreachable``: rank 1 of a group whose coordinator never starts, with a
  5 s timeout: the start-up must raise, and the line says how soon;
* ``engines``: the tiny bundle in ``workdir/bundle`` and the inputs in
  ``workdir/inputs.npz`` through the port's engine on a (data 2) mesh, a
  tensor-parallel and a spatially sharded (model 2) one, the safety checker
  on 5 frames over data 2, and a walk over data 2 into ``workdir/walk``;
  each rank's results go to ``workdir/rank<r>.npz``;
* ``trainers``: the tiny bundle in ``workdir/bundle`` trained on a (data 2)
  mesh by every trainer on the steps' inputs in ``workdir/inputs.npz`` (t,
  noise, indices drawn for the padded batch, the LoRA adapters' first
  values), then the UNet trainer on a (data 1, model 2) mesh against one
  rank and a checkpoint saved and restored on the mesh; each rank's losses
  and weights go to ``workdir/rank<r>.npz``.

Every scenario ends by printing ``PROBE clean`` when neither jax, flax nor
the JAX package was imported.  No failure is caught: a rank that fails
exits non-zero.
"""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the rendezvous and every collective of the scenarios that run
TIMEOUT_S = 120.0


def engines(mesh, workdir: Path, rank: int):
    import numpy as np
    import torch

    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.parallel.mesh import make_mesh
    from stable_diffusion_videos_tpu_torch.parallel.tp import (
        bundle_modules, param_bytes_per_device)
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

    cpu = torch.device("cpu")
    inp = dict(np.load(workdir / "inputs.npz"))
    run = dict(num_inference_steps=2, guidance_scale=3.0)

    def bundle():
        return SDModels.load(workdir / "bundle", device=cpu)

    out = {}
    dp = Engine(bundle(), cpu, mesh=mesh, scheduler="ddim")
    assert dp.batch_bucket == 2
    out["dp"] = dp.denoise_frames(inp["cond"], inp["uncond"], inp["noise"],
                                  **run)
    out["flags"] = dp.check_safety(inp["frames"]).numpy()
    out["decoded"] = dp.decode_latents(inp["noise"][:3])

    model2 = make_mesh(model=2, devices=[cpu, cpu], backend="gloo")
    assert model2.shape == {"data": 1, "model": 2}
    whole = bundle()
    want = sum(param_bytes_per_device(m, 2)["per_device_bytes"]
               for m in bundle_modules(whole).values())
    tp = Engine(whole, cpu, mesh=model2, scheduler="ddim")
    held = sum(p.numel() * p.element_size()
               for m in bundle_modules(tp.models).values()
               for p in m.parameters())
    out["tp_bytes"] = np.array([held, want])
    out["tp"] = tp.denoise_frames(inp["cond"], inp["uncond"], inp["noise"],
                                  **run)
    sp = Engine(bundle(), cpu, mesh=model2, scheduler="ddim",
                spatial_shard=True)
    out["spatial"] = sp.denoise_frames(inp["cond"], inp["uncond"],
                                       inp["noise"], **run)

    pipe = StableDiffusionWalkPipeline(bundle(), cpu, mesh=mesh,
                                       scheduler="ddim")
    path = pipe.walk(prompts=["a fox", "a lighthouse"], seeds=[1, 2],
                     num_interpolation_steps=3, num_inference_steps=2,
                     batch_size=2, output_dir=str(workdir / "walk"), name="w",
                     make_video=False)
    out["walk_writer"] = np.array(pipe.writer)
    out["walk_path"] = np.array(str(path))
    np.savez(workdir / f"rank{rank}.npz", **out)


#: the UNet trainer's cases: (config, batch rows, first step key), shared
#: with tests/test_torch_mesh_training.py
UNET_CASES = {
    # a batch of 3 over data 2: wrap-padded to 4
    "wrap_pad": (dict(learning_rate=1e-3, snr_gamma=5.0, ema_decay=0.9,
                      warmup_steps=2), 3, 50),
    # a clip norm far below the gradient's, so every step clips
    "clipped": (dict(learning_rate=1e-3, objective="v_prediction",
                     weight_decay=0.1, max_grad_norm=0.05), 4, 60),
}
STEPS = 3


def trainers(mesh, workdir: Path, rank: int):
    import numpy as np
    import torch

    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.parallel.mesh import make_mesh
    from stable_diffusion_videos_tpu_torch.training import (
        LCMDistillConfig, LCMDistiller, LoRATrainer, TrainConfig,
        UNetTrainer, VAETrainer)

    cpu = torch.device("cpu")
    inp = dict(np.load(workdir / "inputs.npz"))
    models = SDModels.load(workdir / "bundle", device=cpu)
    out = {}

    def keep(prefix, state):
        out.update({f"{prefix}::{k}": v.detach().numpy().copy()
                    for k, v in state.items()})

    for case, (cfg, b, _) in UNET_CASES.items():
        tr = UNetTrainer(models, mesh=mesh, config=TrainConfig(**cfg))
        out[f"unet_{case}_loss"] = np.array([tr.train_step(
            inp["lat"][:b], inp["ctx"][:b], inp[f"unet_{case}_t{i}"],
            inp[f"unet_{case}_noise{i}"]) for i in range(STEPS)])
        keep(f"unet_{case}", tr.unet.state_dict())
        if tr.ema_params is not None:
            keep(f"unet_{case}_ema", tr.export_params().unet.state_dict())

    lora = LoRATrainer(models, rank=4, alpha=2.0, mesh=mesh,
                       learning_rate=1e-3)
    with torch.no_grad():
        for path, ab in lora.lora.items():
            for k, t in ab.items():
                t.copy_(torch.from_numpy(inp[f"lora_init::{path}::{k}"]))
    out["lora_loss"] = np.array([lora.train_step(
        inp["lat"], inp["ctx"], inp[f"lora_t{i}"], inp[f"lora_noise{i}"])
        for i in range(STEPS)])
    keep("lora", {f"{p}::{k}": t for p, ab in lora.lora.items()
                  for k, t in ab.items()})

    vae = VAETrainer(models, mesh=mesh, learning_rate=1e-3, kl_weight=0.1,
                     max_grad_norm=0.5)
    out["vae_loss"] = np.array([vae.train_step(
        inp["images"], inp[f"vae_noise{i}"]) for i in range(STEPS)])
    keep("vae", vae.weights.master.state_dict())

    lcm = LCMDistiller(models, mesh=mesh,
                       config=LCMDistillConfig(learning_rate=1e-3))
    out["lcm_loss"] = np.array([lcm.train_step(
        inp["lat"][:3], inp["ctx"][:3], inp["uctx"], inp[f"lcm_idx{i}"],
        inp[f"lcm_noise{i}"]) for i in range(STEPS)])
    keep("lcm_student", lcm.student.master.state_dict())
    keep("lcm_target", lcm.target.master.state_dict())

    # a (data 1, model 2) mesh: the ranks hold the same rows and weights,
    # bit-equal to one rank without a mesh
    model2 = make_mesh(model=2, devices=["cpu", "cpu"], backend="gloo")
    cfg = TrainConfig(learning_rate=1e-3)
    runs = [UNetTrainer(models, mesh=model2, config=cfg),
            UNetTrainer(models, config=cfg, device=cpu)]
    for tr in runs:
        for _ in range(2):
            tr.step(inp["lat"][:3], inp["ctx"][:3])
    out["model2_equal"] = np.array(all(torch.equal(a, b) for a, b in zip(
        *(tr.unet.parameters() for tr in runs))))

    # a checkpoint written by rank 0 after step 1, restored on both ranks:
    # the step after it bit-equal to the uninterrupted run's
    cfg = TrainConfig(learning_rate=1e-3, ema_decay=0.5, warmup_steps=3)
    run = UNetTrainer(models, mesh=mesh, config=cfg)
    run.step(inp["lat"][:3], inp["ctx"][:3])
    run.save_checkpoint(workdir / "ckpt.pt")
    run.step(inp["lat"][:3], inp["ctx"][:3])
    resumed = UNetTrainer(models, mesh=mesh, config=cfg).restore_checkpoint(
        workdir / "ckpt.pt")
    resumed.step(inp["lat"][:3], inp["ctx"][:3])
    state = [(list(t.unet.parameters()) + t.ema_params + [
        s[k] for s in t.optimizer.state.values() for k in sorted(s)])
        for t in (run, resumed)]
    out["ckpt_equal"] = np.array(resumed.step_count == 2 and all(
        torch.equal(a, b) for a, b in zip(*state)))
    np.savez(workdir / f"rank{rank}.npz", **out)


def main():
    scenario, port, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import torch
    torch.set_num_threads(1)
    from stable_diffusion_videos_tpu_torch.parallel.multihost import (
        initialize_multihost, shutdown)
    address = f"localhost:{port}"
    if scenario == "unreachable":
        t0 = time.perf_counter()
        try:
            initialize_multihost(coordinator_address=address,
                                 num_processes=2, process_id=rank,
                                 devices=["cpu", "cpu"], timeout_s=5.0)
        except (RuntimeError, TimeoutError) as e:
            print(f"PROBE raised {type(e).__name__} after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        else:
            raise SystemExit("PROBE no error")
    else:
        mesh = initialize_multihost(coordinator_address=address,
                                    num_processes=2, process_id=rank,
                                    devices=["cpu", "cpu"],
                                    timeout_s=TIMEOUT_S)
        import torch.distributed as dist
        if scenario == "multihost":
            print(f"PROBE processes={dist.get_world_size()} "
                  f"mesh={mesh.shape}", flush=True)
            x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
            local = x[mesh.rows(4)]
            val = float(mesh.all_reduce((local * 2.0).sum(), "data"))
            print(f"PROBE result={val}", flush=True)
        elif scenario == "engines":
            engines(mesh, Path(sys.argv[4]), rank)
        elif scenario == "trainers":
            trainers(mesh, Path(sys.argv[4]), rank)
        else:
            raise SystemExit(f"unknown scenario {scenario!r}")
        shutdown()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "stable_diffusion_videos_tpu"))
    if bad:
        raise SystemExit(f"imported {bad}")
    print("PROBE clean", flush=True)


if __name__ == "__main__":
    os.environ.pop("XLA_FLAGS", None)
    main()
