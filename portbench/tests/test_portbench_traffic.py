"""The generator and the statistics: traffic drawn from a seed is the same
every time, seeds change the order and never the amount of work, and the
end-to-end metrics are taken over all requests and all frames."""

import json

import numpy as np
import pytest

from portbench import run, stats, traffic

from .cells import REPO

SEED = 2 ** 31 + 977  # seeds may pass 32 signed bits


def mixes():
    return {p.stem: json.loads(p.read_text())
            for p in (REPO / "portbench" / "traffic").glob("*.json")}


@pytest.mark.parametrize("name", sorted(mixes()))
def test_same_seed_same_traffic(name):
    mix = mixes()[name]
    if mix["entry"] == "walk":
        first = [traffic.walk(mix, SEED, i) for i in range(5)]
        again = [traffic.walk(mix, SEED, i) for i in range(5)]
        other = [traffic.walk(mix, SEED + 1, i) for i in range(5)]
        assert first == again and first != other
        for w in first:
            assert len(w["prompts"]) == mix["prompts_per_walk"]
            assert len(set(w["seeds"])) == len(w["seeds"])
            for p in w["prompts"]:
                lo, hi = mix["prompt_words"]
                assert lo <= len(p.split()) <= hi
    else:
        a = traffic.arrivals(mix, SEED, 45.0)
        assert a == traffic.arrivals(mix, SEED, 45.0)
        b = traffic.arrivals(mix, SEED + 1, 45.0)
        assert a != b


def test_arrivals_same_work_every_seed():
    mix = mixes()["serve-pndm25-overload"]
    gaps = []
    for seed in (SEED, SEED + 1, 7):
        due = [t for t, _, _ in traffic.arrivals(mix, seed, 45.0)]
        assert due[0] == 0.0 and due[-1] < 45.0
        assert len(due) == round(mix["rate_per_s"] * 45.0)
        gaps.append(sorted(np.round(np.diff(due + [45.0]), 9)))
    assert gaps[0] == gaps[1] == gaps[2]
    seeds = [s for _, _, s in traffic.arrivals(mix, SEED, 45.0)]
    assert len(set(seeds)) == len(seeds)


def test_percentile_nearest_rank_over_all():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3


def test_end_to_end_readers_take_everything():
    rd = {n: run.load_module(REPO, "metrics", n) for n in
          ("frames_per_s", "images_per_s", "latency_p95_s.serve",
           "setup_s")}
    obs = {"setup_s": 12.5,
           "window": {"frames": 96, "seconds": 40.0, "completed": 150,
                      "latencies": [1.0] * 19 + [70.0]}}
    assert rd["frames_per_s"].read(obs) == 96 / 40.0
    assert rd["images_per_s"].read(obs) == 150 / 40.0
    # one request in twenty waited 70 s: the nearest rank below it
    assert rd["latency_p95_s.serve"].read(obs) == 1.0
    obs["window"]["latencies"] = [1.0] * 18 + [70.0, 71.0]
    assert rd["latency_p95_s.serve"].read(obs) == 70.0
    assert rd["setup_s"].read(obs) == 12.5
    assert rd["frames_per_s"].read({"window": {"seconds": 1.0}}) is None
