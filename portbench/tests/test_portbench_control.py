"""The check's control: the reference in float8 (the precision below the
configurations' bfloat16) put in the program's place comes out as not
correct, while the program does.  On the CPU at the tiny sizes; on the
card (``-m cuda``) at a cell's own size, as ``python3 -m portbench.control``
reads it."""

import pytest
import torch

from portbench import run

from .cells import REPO, WALK, add_cell, copy_benchmark

SEED = 2 ** 31 + 333


@pytest.mark.parametrize("sampler", ["pndm", "lcm"])
def test_control_is_not_correct_at_tiny_size(tmp_path, sampler):
    root = copy_benchmark(tmp_path)
    mix = dict(WALK, sampler=sampler)
    if sampler == "lcm":
        mix.update(guidance=1.0, guidance_interval=[0, 0], frozen_noise=True)
    add_cell(root, "tiny-c", "tiny", mix)
    r = run.run_workload(root, "tiny-c", SEED, 0.5, False, "cpu",
                         control=True)
    assert r["correct"] is True
    limit = r["checks"]["frame_mae"]["limit"]
    assert r["control"]["frame_mae"] > limit
    assert r["control"]["frame_mae"] >= 3 * r["checks"]["frame_mae"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sd15-walk-pndm50-b8",
                                      "sdxl-walk-euler30-b4"])
def test_control_is_not_correct_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run.run_workload(REPO, workload, SEED, 1.0, False, "cuda",
                         control=True)
    assert r["correct"] is True
    assert any(r["control"][k] > c["limit"] for k, c in r["checks"].items())
