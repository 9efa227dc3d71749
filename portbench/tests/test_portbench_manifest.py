"""``BENCHMARK.json`` keeps to its contract, and the harness finds a
configuration, a traffic mix, an entry, limits and a metric by name, so
that a new cell or metric is new files and entries with nothing edited."""

import hashlib
import json
import re
import shutil

from portbench import run

from .cells import REPO, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "-m", "portbench"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024
    # a full check of 24 cells fits its budget
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_entries():
    names = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
    configs = {c["name"] for c in B["configs"]}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert run.resolve(REPO, w["name"])["limits"]["numbers"]
    assert {w["config"] for w in B["workloads"]} == configs
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert hasattr(run.load_module(REPO, "metrics", m["name"]), "read")
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in B["workloads"]:
        cell = run.resolve(REPO, w["name"])
        assert any(m["name"] != "setup_s" for m in cell["end_to_end"])
        assert cell["per_layer"]


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    copy_benchmark(tmp_path)
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    shutil.copy(pb / "configs" / "sd15.json", pb / "configs" / "sd15-x.json")
    cfg = json.loads((pb / "configs" / "sd15-x.json").read_text())
    cfg["name"] = "sd15-x"
    (pb / "configs" / "sd15-x.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "walk-pndm50-b8.json").read_text())
    mix["steps"] = 20
    (pb / "traffic" / "walk-pndm20-b8.json").write_text(json.dumps(mix))
    shutil.copy(pb / "limits" / "sd15-walk-pndm50-b8.json",
                pb / "limits" / "sd15-x-walk-pndm20-b8.json")
    (pb / "metrics" / "frames_x2.walk.py").write_text(
        "def read(obs):\n    return 2 * obs['window']['frames']\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "sd15-x", "source": "s",
                         "file": "portbench/configs/sd15-x.json",
                         "reduced": [], "why": "w"})
    b["workloads"].append({"name": "sd15-x-walk-pndm20-b8",
                           "config": "sd15-x", "traffic": "walk-pndm20-b8",
                           "chips": 1, "why": "w"})
    b["per_layer"].append({"name": "frames_x2.walk", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "walk", "moves": "frames_per_s",
                           "workloads": ["sd15-x-walk-pndm20-b8"]})
    b["end_to_end"][0]["workloads"].append("sd15-x-walk-pndm20-b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = run.resolve(tmp_path, "sd15-x-walk-pndm20-b8")
    assert cell["config"]["name"] == "sd15-x"
    assert cell["mix"]["steps"] == 20
    assert cell["entry"].__file__.endswith("walk.py")
    assert [m["name"] for m in cell["per_layer"]] == ["frames_x2.walk"]
    assert [m["name"] for m in cell["end_to_end"]] == ["frames_per_s",
                                                       "setup_s"]
    reader = run.load_module(tmp_path, "metrics", "frames_x2.walk")
    assert reader.read({"window": {"frames": 3}}) == 6
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    # the old cells resolve as they did
    assert run.resolve(tmp_path, "sd15-walk-pndm50-b8")["mix"]["steps"] == 50
