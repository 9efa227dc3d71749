"""The PyTorch package's parity gate and ``validate``
(``utils/parity_gate.py``, ``utils/validate.py``) and their command-line
wiring, on the CPU.

The gate's walk and thresholds are the JAX package's.  On the tiny model at
2 steps: the gate passes against frames the same pipeline wrote, fails
against another model's, and raises on a missing directory.  ``validate``
runs end to end on a saved tiny bundle, with and without a self-reference
gate and with a Real-ESRGAN file; a stage that raises gives ``error`` and
``pass`` false while the other stages still run, and ``KeyboardInterrupt``
propagates.  ``compare``, ``parity-gate`` and ``validate`` run through the
CLI, whose exit code is the verdict.
"""

import json

import pytest
import torch

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.utils import parity_gate
from stable_diffusion_videos_tpu_torch.utils.parity_gate import \
    run_parity_gate
from stable_diffusion_videos_tpu_torch.utils.validate import run_validation

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
SIDE = 32


@pytest.fixture(autouse=True)
def two_step_gate(monkeypatch):
    """The gate's walk at 2 denoising steps."""
    monkeypatch.setitem(parity_gate.GATE_CONFIG, "num_inference_steps", 2)


def gate_walk(pipe, root, name):
    pipe.walk(prompts=list(parity_gate.GATE_PROMPTS),
              seeds=list(parity_gate.GATE_SEEDS), output_dir=str(root),
              name=name, make_video=False, height=SIDE, width=SIDE,
              **parity_gate.GATE_CONFIG)
    return root / name


def test_gate_constants_are_the_jax_packages():
    from stable_diffusion_videos_tpu.utils import parity_gate as J
    assert parity_gate.GATE_PROMPTS == J.GATE_PROMPTS
    assert parity_gate.GATE_SEEDS == J.GATE_SEEDS
    assert (parity_gate.LPIPS_PASS, parity_gate.SSIM_PASS) == (
        J.LPIPS_PASS, J.SSIM_PASS)
    want = dict(J.GATE_CONFIG, num_inference_steps=2)
    assert parity_gate.GATE_CONFIG == want


def test_gate_passes_on_its_own_frames_and_fails_on_another_model(tmp_path):
    from stable_diffusion_videos_tpu_torch.utils.lpips import LPIPS
    pipe = StableDiffusionWalkPipeline.tiny(CPU, safety=False)
    ref = gate_walk(pipe, tmp_path, "ref")
    other = gate_walk(StableDiffusionWalkPipeline.tiny(CPU, seed=5,
                                                       safety=False),
                      tmp_path, "other")
    res = run_parity_gate(pipe, str(ref), str(tmp_path / "a"),
                          height=SIDE, width=SIDE)
    assert res["pass"] and res["frames"] == 4 and res["ssim_mean"] == 1.0
    assert res["gate"].startswith("ssim_mean > 0.85")
    bad = run_parity_gate(pipe, str(other), str(tmp_path / "b"),
                          height=SIDE, width=SIDE)
    assert not bad["pass"] and bad["ssim_mean"] < parity_gate.SSIM_PASS
    # with LPIPS weights the gate is LPIPS's
    torch.save(LPIPS("alex").state_dict(), tmp_path / "lpips.pth")
    lp = run_parity_gate(pipe, str(ref), str(tmp_path / "c"),
                         lpips_weights=str(tmp_path / "lpips.pth"),
                         height=SIDE, width=SIDE)
    assert lp["pass"] and lp["lpips_mean"] == 0.0
    assert lp["gate"] == "lpips_mean < 0.1"
    with pytest.raises(FileNotFoundError, match="does not exist"):
        run_parity_gate(pipe, str(tmp_path / "missing"), str(tmp_path / "d"))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("validate")
    return SDModels.tiny(taesd=True).save(root / "bundle")


def validate(bundle, out, **kw):
    return run_validation(bundle, str(out), num_inference_steps=2,
                          height=SIDE, width=SIDE, step_cache_ks=(2,),
                          device="cpu", **kw)


def test_validate_end_to_end(bundle, tmp_path):
    from stable_diffusion_videos_tpu_torch.pipeline.upsampling import \
        RealESRGANModel
    rep = validate(bundle, tmp_path / "plain")
    assert rep["pass"], rep
    assert rep["summary"] == {
        "load": "ok", "smoke": "ok", "vae_roundtrip": "ok",
        "walk_parity": "skipped", "step_cache_curve": "ok",
        "upsample": "skipped"}
    st = rep["stages"]
    assert st["load"]["layout"] == "native bundle"
    assert st["load"]["param_counts"] == SDModels.tiny(
        taesd=True).param_count()
    assert st["smoke"]["shape"] == [SIDE, SIDE, 3]
    assert sorted(st["step_cache_curve"]["curve"]) == [
        "fast_ends", "fast_preset", "k2"]
    assert json.loads((tmp_path / "plain" / "validation_report.json")
                      .read_text())["pass"]
    pipe = StableDiffusionWalkPipeline(SDModels.load(bundle), CPU,
                                       safety=False)
    ref = gate_walk(pipe, tmp_path, "ref")
    esrgan = tmp_path / "esrgan.pth"
    torch.save({"params_ema": RealESRGANModel.tiny(CPU).net.state_dict()},
               esrgan)
    rep = validate(bundle, tmp_path / "gated", reference_frames=str(ref),
                   upsample_weights=str(esrgan))
    assert rep["pass"], rep
    assert rep["stages"]["walk_parity"]["status"] == "ok"
    assert rep["stages"]["upsample"]["out_shape"] == [1, 4 * SIDE,
                                                      4 * SIDE, 3]
    assert (tmp_path / "gated" / "smoke_frame_x4.png").exists()


def test_a_broken_stage_is_an_error_and_interrupts_propagate(
        bundle, tmp_path, monkeypatch):
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

    def broken(self, images):
        raise RuntimeError("encoder exploded")
    monkeypatch.setattr(Engine, "encode_image", broken)
    rep = validate(bundle, tmp_path / "a")
    assert not rep["pass"]
    assert rep["stages"]["vae_roundtrip"]["status"] == "error"
    assert "encoder exploded" in rep["stages"]["vae_roundtrip"]["error"]
    assert rep["stages"]["step_cache_curve"]["status"] == "ok"

    def interrupted(self, images):
        raise KeyboardInterrupt
    monkeypatch.setattr(Engine, "encode_image", interrupted)
    with pytest.raises(KeyboardInterrupt):
        validate(bundle, tmp_path / "b")
    # a load that fails ends the run there
    rep = validate(str(tmp_path / "no_such_checkpoint"), tmp_path / "c")
    assert not rep["pass"] and rep["stages"]["load"]["status"] == "error"
    assert list(rep["stages"]) == ["load"]


def test_cli_compare_parity_gate_and_validate(bundle, tmp_path, capsys):
    from stable_diffusion_videos_tpu_torch.__main__ import main
    pipe = StableDiffusionWalkPipeline.tiny(CPU, safety=False)
    ref = gate_walk(pipe, tmp_path, "ref")
    main(["compare", "--a", str(ref), "--b", str(ref), "--device", "cpu"])
    res = json.loads(capsys.readouterr().out)
    assert res["frames"] == 4 and res["psnr_min"] == float("inf")
    common = ["--device", "cpu", "--height", str(SIDE), "--width",
              str(SIDE)]
    with pytest.raises(SystemExit) as e:
        main(["parity-gate", "--reference-frames", str(ref), "--output-dir",
              str(tmp_path / "gate"), *common])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["pass"]
    other = gate_walk(StableDiffusionWalkPipeline.tiny(CPU, seed=5,
                                                       safety=False),
                      tmp_path, "other")
    with pytest.raises(SystemExit) as e:
        main(["parity-gate", "--reference-frames", str(other),
              "--output-dir", str(tmp_path / "gate2"), *common])
    assert e.value.code == 1
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        main(["validate", bundle, "--output-dir", str(tmp_path / "v"),
              "--num-inference-steps", "2", "--step-cache-ks", "2", *common])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out)["pass"]
