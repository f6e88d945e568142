"""One run of one cell: set-up, the measured window, on a traced run the
profiled and stage-timed segments, then the comparison with the reference,
and the result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

from portbench import check, spec, trace
from portbench.drivers import driver_for, sync

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mqe_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_limits(cell) -> dict:
    path = os.path.join(cell.here, "limits", f"{cell.name}.json")
    if not os.path.exists(path):
        raise spec.SpecError(f"no limits for cell {cell.name!r} ({path})")
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def ref_models(task: str) -> dict:
    """Model key (nb, nq, ns) -> the reference's BodyModel of the task's
    robot and NPC."""
    check.refsim()
    from refsim.envs.registry import ENV_DICT
    from refsim.physics.model import load_model

    cfg = ENV_DICT[task]["config"]
    ms = [load_model(cfg.asset.model)]
    if cfg.asset.npc_model:
        ms.append(load_model(cfg.asset.npc_model, root_free=not cfg.asset.fix_npc_base_link))
    return {(m.nb, m.nq, len(m.sph_tags)): m for m in ms}


def compare(drv, records, device, candidate=None):
    """(numbers, detail) of the cell's comparison, from the driver's records."""
    ref = check.Reference(drv.cfg["task"], drv.num_envs, drv.env_seed, device)
    if drv.kind == "gym":
        start, checks = records
        return check.gym_check(ref, start, checks, float(drv.mix.get("action_prescale", 0.5)),
                               candidate)
    fields = dict(drv.mix.get("ppo_config", {}))
    return check.train_check(ref, drv.mix["trainer"], fields, drv.run_seed, records, candidate)


def run(cell, seed: int, seconds: float, trace_on: bool, device="cuda", t_start=None,
        num_envs=None, log=sys.stderr) -> dict:
    """The result of one run (the dict the result line prints)."""
    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False   # the configuration's float32
    torch.backends.cudnn.allow_tf32 = False
    drv = driver_for(cell, seed, device, num_envs)
    drv.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s", file=log, flush=True)
    w = drv.window(seconds)
    units = w.get("step_s") or w.get("update_s")
    print(f"window {w['seconds']:.3f} s, work {w['work']}, {len(units)} units of "
          f"{min(units):.4f}/{sorted(units)[len(units) // 2]:.4f}/{max(units):.4f} s "
          f"(least/median/most)", file=log, flush=True)
    values = dict(drv.e2e(w), setup_s=setup_s)
    traced = None
    if trace_on:
        traced = drv.traced(int(drv.mix["trace_units"]))
    on_card = torch.device(device).type == "cuda"
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0

    records = drv.records(w)
    missing = w["missing"]
    kind = drv.kind
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    nums, detail = compare(drv, records, device) if records is not None else ({}, {})
    del records
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=log, flush=True)
    correct, shown = check.judge(nums, load_limits(cell))
    if missing:
        correct = False
        print(f"records that came out short: {missing}", file=log)
    for k, v in detail.items():
        print(f"detail {k}: {v}", file=log)

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": cell.chips if on_card else 0, "memory_peak_bytes": int(mem_peak)}
    breakdown = None
    if trace_on:
        summary = trace.summarize(trace.read(traced["prof"]))
        kinds = sorted({(k, key, flags) for k, key, _, _, flags in traced["launches"]})
        ops = trace.ops_per_launch(kinds, ref_models(drv.cfg["task"])) if kinds else {}
        roofs = trace.rooflines(summary, traced["launches"], ops)
        ctx = dict(kind=kind, summary=summary, rooflines=roofs, traced=traced,
                   stage_s=dict(traced["timer"].seconds), stage_calls=dict(traced["timer"].calls),
                   on_card=on_card)
        metrics = {}
        for m in cell.metrics(True):
            v = spec.load_reader(m["name"], cell.here)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        for k, r in roofs.items():
            print(f"roofline {k}: {r}", file=log)
        print(f"trace: busy {summary['busy_s']:.6f} s of {summary['window_s']:.6f} s, "
              f"{summary['kernels']} kernels", file=log)
        if on_card:
            dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            breakdown = summary["breakdown"]
    else:
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.metrics(False)}
    attempted = w.get("steps", w.get("updates"))
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": w["failed"],
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    return result


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, t_start=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of mqe_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    result["device"]["power"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may not import them", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
