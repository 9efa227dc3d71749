"""Whole runs of tiny cells on the CPU: the harness past its look for a
card, each entry end to end, ``correct`` true on the sound program and
false with the timed path broken underneath, no JAX in a run and nothing
of the port in the reference, and the command's refusals."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run

from .cells import REPO, SERVE, WALK, add_cell, copy_benchmark

SEED = 2 ** 31 + 4099
CELLS = {
    "tiny-walk": ("tiny", WALK),
    "tiny-xl-walk": ("tiny_xl", dict(WALK, sampler="euler")),
    "tiny-lcm": ("tiny", dict(WALK, sampler="lcm", guidance=1.0,
                              guidance_interval=[0, 0], frozen_noise=True)),
    "tiny-serve": ("tiny", SERVE),
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    for name, (cfg, mix) in CELLS.items():
        add_cell(root, name, cfg, mix)
    return root


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_correct(bench, name, trace):
    r = run.run_workload(bench, name, SEED + trace, 1.0, bool(trace), "cpu")
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    cell = run.resolve(bench, name)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    # on the CPU the device-trace metrics find nothing to read
    got = set(r["metrics"])
    assert got <= {m["name"] for m in wanted}
    if not trace:
        assert got == {m["name"] for m in wanted}
        for m in wanted:
            assert r["metrics"][m["name"]]["unit"] == m["unit"]
            assert r["metrics"][m["name"]]["value"] > 0
    else:
        assert "breakdown" in r and "window_s" in r["device"]
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def _broken_step(monkeypatch, sampler):
    from stable_diffusion_videos_tpu_torch.core.schedulers import \
        get_scheduler
    cls = type(get_scheduler(sampler))
    monkeypatch.setattr(cls, "step", lambda self, tables, state, i, out,
                        sample, noise=None: (state, sample))


def _altered_answer(monkeypatch):
    """Every frame 16 levels brighter in its top half, where the engine
    and the pipeline quantise it."""
    from stable_diffusion_videos_tpu_torch.pipeline import walk
    from stable_diffusion_videos_tpu_torch.runtime import engine
    plain = engine.quantise

    def altered(imgs):
        q = plain(imgs).clone()
        h = q.shape[1] // 2
        q[:, :h] = (q[:, :h].to(torch.int16) + 16).clamp(0, 255).to(
            torch.uint8)
        return q
    monkeypatch.setattr(engine, "quantise", altered)
    monkeypatch.setattr(walk, "quantise", altered)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state unchanged", "answer altered"])
def test_broken_timed_path_is_not_correct(bench, monkeypatch, name, fault):
    if fault == "state unchanged":
        _broken_step(monkeypatch, CELLS[name][1]["sampler"])
    else:
        _altered_answer(monkeypatch)
    r = run.run_workload(bench, name, SEED + 7, 0.5, False, "cpu")
    assert r["correct"] is False, r["checks"]


def _python(code, cwd, env=None):
    env = dict(os.environ, **(env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(bench):
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        f"r = run.run_workload({str(bench)!r}, 'tiny-walk', 3, 0.5, True,"
        " 'cpu')\n"
        "r2 = run.run_workload"
        f"({str(bench)!r}, 'tiny-serve', 4, 0.5, False, 'cpu')\n"
        "assert r['correct'] and r2['correct']\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = _python(code, REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    forbidden, tops = map(json.loads, p.stdout.strip().splitlines()[-2:])
    assert forbidden == []
    assert "stable_diffusion_videos_tpu_torch" in tops
    for name in run.FORBIDDEN:
        assert name not in tops


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    code = (
        "import json, sys, torch\n"
        "from portbench import reference, weights\n"
        "from portbench.reference import models\n"
        "cfg = json.load(open('portbench/tests/data/tiny_xl.json'))\n"
        "w = weights.draw(models.build(cfg), 1, 0.1, torch.float32, 'cpu')\n"
        "mods = reference.build(cfg, w, 'cpu')\n"
        "spec = dict(sampler='euler', steps=2, guidance=7.5, cfg=True,"
        " latent=(8, 8))\n"
        "items = [dict(prompt_a='a b', prompt_b='c d', seed_a=1, seed_b=2,"
        " t=0.5)]\n"
        "print(tuple(reference.frames(cfg, mods, spec, items, 'cpu')"
        ".shape))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = _python(code, REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    shape, tops = p.stdout.strip().splitlines()[-2:]
    assert shape == "(1, 16, 16, 3)"
    tops = json.loads(tops)
    assert not [t for t in tops
                if t.startswith("stable_diffusion_videos_tpu")]
    assert "jax" not in tops and "flax" not in tops


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "sd15-walk-pndm50-b8", "--seed", str(SEED),
                        "--seconds", "10", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_command_refuses_without_the_program(tmp_path):
    copy_benchmark(tmp_path)
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "sd15-walk-pndm50-b8", "--seed", "1", "--seconds",
                        "10", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
