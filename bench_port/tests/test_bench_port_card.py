"""On the card: each cell runs end to end at its own size and comes out
correct; the TF32 control comes out not correct. Marked `cuda`: without a
card they skip (the fixture decides, not the import)."""
import json
import os
import subprocess
import sys

import pytest

from bench_port_helpers import HERE, ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_each_cell_runs_correct_on_the_card(card, cell):
    # 20 s: the gym cells check two steps among the first 24 (sheep: ~6
    # steps/s), the training cells one of the first two updates (MAT: ~7 s each)
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
                          "--seed", str(2**31 + 101), "--seconds", "20", "--trace", "0"],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["device"]["platform"] == "gpu" and result["correct"] is True, result


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["go1gate.gym", "go1gate.ppo"])
def test_the_tf32_control_is_not_correct_on_the_card(card, cell):
    import readings
    from portbench import main, spec

    c = spec.Cell(spec.load_benchmark(), cell)
    out = readings.readings(c, 2**31 + 103, 8.0, ["program", "tf32"])
    limits = main.load_limits(c)
    assert main.check.judge(out["program"], limits)[0] is True, out["program"]
    assert main.check.judge(out["tf32"], limits)[0] is False, out["tf32"]
