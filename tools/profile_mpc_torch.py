"""Where one command-MPC solve of the PyTorch port spends its time on the card.

    python3 tools/profile_mpc_torch.py [--task go1gate] [--num-envs 4096 2] [--solves 3]

For each env count: CommandMPC's defaults (H = 20, 8 iterations, the task's
cost: gate for go1gate, pushbox for go1pushbox) on the task's reset state,
one warm solve, then
  * the wall time of a solve (host clock, synchronized);
  * its stages, each timed alone with torch.cuda.synchronize() on both sides
    from the same inputs: the first rollout and cost, one linearization, one
    backward pass (the linearization included), one forward pass of every
    step size, one whole iteration;
  * the device: torch.profiler over the solves; the kernels a solve and the
    sum of their device time against the wall time (the busy share).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mqe_tpu_torch.envs.registry import make_mqe_env  # noqa: E402
from mqe_tpu_torch.mpc import CommandMPC  # noqa: E402
from mqe_tpu_torch.mpc.controller import planner_state  # noqa: E402


def synced_ms(fn, n=1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, out


def profile(task, num_envs, solves, smi):
    wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0, device="cuda")
    mpc = CommandMPC(wrap, task={"go1gate": "gate", "go1pushbox": "pushbox"}.get(task, "waypoint"))
    ts, _ = wrap.reset()
    args = mpc.default_args(ts.env)
    x0 = planner_state(mpc.env, ts.env).reshape(num_envs, -1)
    us0 = mpc.init_mpc_state().us
    solve, cfg = mpc.solve, mpc.cfg
    solve(x0, us0, args)                                      # warm
    solve_ms, _ = synced_ms(lambda: solve(x0, us0, args), solves)

    alphas = torch.tensor(cfg.alphas, device="cuda")
    us = torch.maximum(torch.minimum(us0, torch.tensor(cfg.u_max, device="cuda")),
                       torch.tensor(cfg.u_min, device="cuda"))
    ms = {}
    ms["rollout + cost"], (xs, cost) = synced_ms(
        lambda: (lambda xs_: (xs_, solve.total_cost(xs_, us, args)))(solve.rollout(x0, us, args)))
    reg = torch.full_like(cost, cfg.reg_init)
    ms["linearize"], _ = synced_ms(lambda: solve.linearize(xs, us, args))
    ms["backward (with linearize)"], (ks, Ks, _) = synced_ms(
        lambda: solve.backward(xs, us, args, reg))
    ms["forward, every step size"], _ = synced_ms(
        lambda: solve.forward(xs, us, ks, Ks, args, alphas))
    ms["iteration"], _ = synced_ms(lambda: solve.iteration(xs, us, cost, reg, args, alphas))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_ms, _ = synced_ms(lambda: solve(x0, us0, args), solves)
    dev_us, n_kernels, by_name = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us += ev.self_device_time_total
        n_kernels += ev.count
        by_name.append((ev.self_device_time_total, ev.count, ev.key))
    by_name.sort(reverse=True)
    dev_ms = dev_us / 1e3 / solves
    print(f"{task} {num_envs} envs, H {cfg.horizon}, {cfg.n_iters} iterations, on {smi}: "
          f"{solve_ms:.2f} ms a solve ({num_envs / solve_ms * 1e3:.1f} env-solves/s); under the "
          f"profiler {prof_ms:.2f} ms; device {dev_ms:.3f} ms of kernels, "
          f"{n_kernels / solves:.0f} kernels a solve, busy share {dev_ms / prof_ms:.4f}", flush=True)
    for k, v in ms.items():
        print(f"  {v:9.3f} ms  {k}")
    for t, n, key in by_name[:8]:
        print(f"  {t / 1e3 / solves:9.3f} ms  {n / solves:7.0f}/solve  {key[:90]}")
    return {"task": task, "num_envs": num_envs, "ms_per_solve": solve_ms,
            "profiled_ms_per_solve": prof_ms, "device_ms_per_solve": dev_ms,
            "kernels_per_solve": n_kernels / solves, "stages_ms": ms, "device": smi}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="go1gate")
    ap.add_argument("--num-envs", type=int, nargs="+", default=[4096, 2])
    ap.add_argument("--solves", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_mpc_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = [profile(args.task, e, args.solves, smi) for e in args.num_envs]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
