"""The harness finds each configuration, traffic mix and metric by name, a
cell is added by adding files and entries only, and BENCHMARK.json keeps
the contract's shape."""
import hashlib
import json
import os
import re
import shutil

import pytest

from bench_port_helpers import HERE, ROOT
from portbench import drivers, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.load_benchmark()


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = spec.Cell(b, w["name"])
        assert cell.config["task"] and cell.config["num_envs"] > 0
        assert cell.traffic["kind"] in drivers.DRIVERS
        for m in cell.per_layer:
            assert callable(spec.load_reader(m["name"]))
        assert os.path.exists(os.path.join(HERE, "limits", f"{w['name']}.json"))


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.Cell(bench(), "go1gate.nothing")
    with pytest.raises(spec.SpecError):
        spec.load_reader("no_such_metric.gym")


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_is_added_by_files_and_entries_only(tmp_path):
    """A new configuration, mix, metric and limits, as files beside the
    others and entries in BENCHMARK.json: found by name, and no file that
    was there is changed."""
    here = tmp_path / "bench_port"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(HERE, sub), here / sub)
    before = _digest(here)
    cfg = json.loads((here / "configs" / "go1gate.json").read_text())
    cfg.update(name="go1football-2vs2", task="go1football-2vs2")
    (here / "configs" / "go1football-2vs2.json").write_text(json.dumps(cfg))
    (here / "traffic" / "gym4096.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "gym.json").read_text()), action_pool=8)))
    (here / "metrics" / "steps_traced.gym.py").write_text(
        "def read(ctx):\n    return ctx['traced']['steps']\n")
    (here / "limits" / "go1football-2vs2.gym4096.json").write_text('{"limits": {}}')
    b = bench()
    b["configs"].append(dict(name="go1football-2vs2", source="https://example.org",
                             file="bench_port/configs/go1football-2vs2.json", reduced=[],
                             why="x"))
    b["workloads"].append(dict(name="go1football-2vs2.gym4096", config="go1football-2vs2",
                               traffic="gym4096", chips=1, why="x"))
    b["per_layer"].append(dict(name="steps_traced.gym", unit="steps", better="higher",
                               source="program_counter", layer="device",
                               moves="env_steps_per_s", workloads=["go1football-2vs2.gym4096"]))
    b["end_to_end"][0]["workloads"].append("go1football-2vs2.gym4096")
    cell = spec.Cell(b, "go1football-2vs2.gym4096", here=str(here))
    assert cell.config["task"] == "go1football-2vs2" and cell.traffic["action_pool"] == 8
    assert [m["name"] for m in cell.per_layer] == ["steps_traced.gym"]
    assert spec.load_reader("steps_traced.gym", str(here))({"traced": {"steps": 3}}) == 3
    assert isinstance(drivers.driver_for(cell, 1, "cpu", 2), drivers.GymDriver)
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["bench_port"] and b["command"][1].startswith("bench_port/")
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for c in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or c in moved["workloads"]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for name in cells:
        reported = [m for m in b["end_to_end"] if "workloads" not in m or name in m["workloads"]]
        assert len(reported) >= 2
        assert any(name in m.get("workloads", cells) for m in b["per_layer"])
