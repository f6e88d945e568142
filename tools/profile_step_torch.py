"""Where one go1gate control step of the PyTorch port spends its time on the card.

    python3 tools/profile_step_torch.py [--num-envs 4096] [--steps 5]

Two views of the same steps, after 2 warm steps:
  * stage times: the host clock around each stage of the step, with
    torch.cuda.synchronize() on both sides (the step is bound by launching
    many small ops from the host, so the clock sees where the host spends);
  * the device: torch.profiler over the steps; the sum of the device time of
    every kernel against the wall time gives the device's busy share, and
    the kernel count per step the launches the host makes.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mqe_tpu_torch.envs import go1_env  # noqa: E402
from mqe_tpu_torch.envs.registry import make_mqe_env  # noqa: E402
from mqe_tpu_torch.physics import scene, soa  # noqa: E402

ACC = defaultdict(float)


def timed(name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        ACC[name] += time.perf_counter() - t0
        return out
    return wrapper


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_step_torch: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    wrap, _ = make_mqe_env("go1gate", num_envs=args.num_envs, seed=0, device="cuda")
    ts, _ = wrap.reset()
    cmds = torch.as_tensor(np.random.RandomState(1).uniform(
        -1, 1, (args.num_envs, wrap.num_agents, 3)).astype(np.float32), device="cuda")
    for _ in range(2):
        ts = wrap.step(ts, cmds)[0]
    torch.cuda.synchronize()

    # plain wall time of the steps
    t0 = time.perf_counter()
    for _ in range(args.steps):
        ts = wrap.step(ts, cmds)[0]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps

    # device view
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            ts = wrap.step(ts, cmds)[0]
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) / args.steps
    dev_us, n_kernels, by_name = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # host ops also carry their kernels' time
            continue
        t = ev.self_device_time_total
        dev_us += t
        n_kernels += ev.count
        by_name.append((t, ev.count, ev.key))
    by_name.sort(reverse=True)

    # stage view: wrap the stages in place (this process only)
    stages = {
        "locomotion (trot + body policy)": (go1_env.Go1Env, "_locomotion_action"),
        "actuator net + torques": (go1_env.Go1Env, "_torques"),
        "substep_batch (all)": (scene, "substep_batch"),
        "fk_spheres (plain)": (soa, "fk_spheres"),
        "ground + wall-box contact": (scene, "_terrain_and_box_force"),
        "dynamics kernel (pack, launch, unpack)": (scene, "step_actor_kernel"),
        "termination": (go1_env.Go1Env, "_termination"),
        "reset draw + masked reset + obs": (go1_env.Go1Env, "_step_finish"),
    }
    for name, (owner, attr) in stages.items():
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        ts = wrap.step(ts, cmds)[0]
    torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / args.steps
    ms = {k: v / args.steps * 1e3 for k, v in ACC.items()}
    ms["robot-robot contact + reshapes (rest of substep)"] = ms["substep_batch (all)"] - sum(
        ms[k] for k in ("fk_spheres (plain)", "ground + wall-box contact",
                        "dynamics kernel (pack, launch, unpack)"))
    ms["rest of the step"] = synced * 1e3 - sum(
        ms[k] for k in ("locomotion (trot + body policy)", "actuator net + torques",
                        "substep_batch (all)", "termination", "reset draw + masked reset + obs"))

    print(f"go1gate {args.num_envs} envs on {smi}: {wall * 1e3:.2f} ms/step "
          f"({args.num_envs / wall:.1f} env-steps/s); under the profiler {prof_wall * 1e3:.2f} ms/step")
    print(f"device: {dev_us / 1e3 / args.steps:.3f} ms of kernels per step, "
          f"{n_kernels / args.steps:.0f} kernels per step, busy share "
          f"{dev_us / 1e6 / args.steps / prof_wall:.4f} of the profiled wall time")
    for t, n, key in by_name[:12]:
        print(f"  {t / 1e3 / args.steps:9.3f} ms/step  {n / args.steps:7.0f}/step  {key[:90]}")
    print(f"stages (synchronized, {synced * 1e3:.2f} ms/step):")
    for k, v in sorted(ms.items(), key=lambda kv: -kv[1]):
        print(f"  {v:9.3f} ms/step  {k}")
    print(json.dumps({"num_envs": args.num_envs, "ms_per_step": wall * 1e3,
                      "env_steps_per_s": args.num_envs / wall,
                      "device_ms_per_step": dev_us / 1e3 / args.steps,
                      "kernels_per_step": n_kernels / args.steps,
                      "busy_share": dev_us / 1e6 / args.steps / prof_wall,
                      "stages_ms": ms, "card": smi}))


if __name__ == "__main__":
    main()
