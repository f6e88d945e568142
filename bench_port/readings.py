#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from: for each seed, one
set-up and a short window of the cell as the benchmark runs it, then the
comparison for the program and for each candidate put in its place (the
control, `tf32`: the reference with TF32 matrix products; the faults of
portbench/check.py::FAULTS planted in the reference). One process for all
seeds. Not run by the benchmark's own runs.

    python3 bench_port/readings.py --workload go1gate.gym --seeds 1,2,3 \\
        --seconds 10 --candidates program,tf32,half_batch [--out FILE]

Each seed prints one JSON line {seed, candidate: numbers}.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from portbench import main as pmain  # noqa: E402
from portbench import spec  # noqa: E402
from portbench.drivers import driver_for, sync  # noqa: E402


def readings(cell, seed, seconds, candidates, device="cuda", num_envs=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = driver_for(cell, seed, device, num_envs)
    drv.setup()
    sync(device)
    w = drv.window(seconds)
    records = drv.records(w)
    out = {"seed": seed, "missing": w["missing"]}
    drv.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    for cand in candidates if records is not None else ():
        nums, detail = pmain.compare(drv, records, device, None if cand == "program" else cand)
        out[cand] = nums
        out[cand + "_detail"] = {k: v for k, v in detail.items() if k in ("sets", "policy",
                                                                           "losses", "left_out")}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--candidates", default="program,tf32")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("readings: no CUDA device")
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    cands = args.candidates.split(",")
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(cell, int(s), args.seconds, cands)
        r["seconds"] = time.perf_counter() - t0
        line = json.dumps(r, default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
