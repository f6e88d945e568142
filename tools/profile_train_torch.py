"""Where one training update of the PyTorch port spends its time on the card.

    python3 tools/profile_train_torch.py [--task go1gate|locomotion] [--algo ppo|gru|mat]
        [--num-envs 4096] [--updates 2]

PPOConfig's defaults (T = 32, 4 minibatches, 4 epochs); `--task locomotion`
trains LocomotionEnv with learn/train_locomotion.py's PPOConfig (lr 3e-4,
entropy 1e-3; ppo only). One warm update, then three views of the same kind
of update:
  * wall: rollout and SGD timed apart by `PPOTrainer.timed_update` (the
    helper chip_smoke.py's phase `train` uses), the device synchronized at
    each end;
  * the device: torch.profiler over one update; the device time of every
    kernel against the wall time gives the busy share, the kernel count the
    launches the host makes;
  * stages: the host clock, synchronized on both sides, around the env step,
    the policy, the episode accumulator, GAE and the minibatch steps; and
    inside the env step around Go1Env's locomotion action, torques
    (actuator net), physics substeps and termination.
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

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mqe_tpu_torch.envs.registry import make_mqe_env  # noqa: E402
from mqe_tpu_torch.learn.locomotion_env import LocomotionEnv  # noqa: E402
from mqe_tpu_torch.learn.mat import MATTrainer  # noqa: E402
from mqe_tpu_torch.learn.ppo import PPOConfig, PPOTrainer  # noqa: E402
from mqe_tpu_torch.utils import metrics  # noqa: E402

ACC = defaultdict(float)
ALGOS = {"ppo": (PPOTrainer, PPOConfig()), "gru": (PPOTrainer, PPOConfig(recurrent=True)),
         "mat": (MATTrainer, PPOConfig(algo="mat"))}


def timed(name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        ACC[name] += time.perf_counter() - t0
        return out
    return wrapper


def update(tr, ts):
    """One update -> (ts, rollout seconds, SGD seconds), as chip_smoke.py
    times it (`PPOTrainer.timed_update`)."""
    ts, _, rollout_s, sgd_s = tr.timed_update(ts)
    return ts, rollout_s, sgd_s


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="go1gate",
                    help="a task of the registry, or 'locomotion' (LocomotionEnv)")
    ap.add_argument("--algo", default="ppo", choices=sorted(ALGOS))
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--updates", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train_torch: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.task == "locomotion":
        if args.algo != "ppo":
            sys.exit("profile_train_torch: locomotion trains with ppo only")
        wrap = LocomotionEnv(num_envs=args.num_envs, seed=0, device="cuda")
        cls, cfg = PPOTrainer, PPOConfig(lr=3e-4, ent_coef=1e-3)  # train_locomotion's
    else:
        wrap, _ = make_mqe_env(args.task, num_envs=args.num_envs, seed=0, device="cuda")
        cls, cfg = ALGOS[args.algo]
    tr = cls(wrap, cfg, seed=0)
    ts, _, _ = update(tr, tr.init_state())  # warm

    walls = []
    for _ in range(args.updates):
        ts, r, s = update(tr, ts)
        walls.append((r, s))
    rollout_s = sum(r for r, _ in walls) / len(walls)
    sgd_s = sum(s for _, s in walls) / len(walls)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ts, _, _ = update(tr, ts)
        prof_wall = time.perf_counter() - t0
    dev_us, n_kernels, by_name = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # host ops also carry their kernels' time
            continue
        dev_us += ev.self_device_time_total
        n_kernels += ev.count
        by_name.append((ev.self_device_time_total, ev.count, ev.key))
    by_name.sort(reverse=True)

    stages = {"env step (wrapper.step)": (wrap, "step"), "policy (sampling)": (tr, "_policy"),
              "episode accumulator": (metrics.EpisodeAccumulator, "update"),
              "GAE": (tr, "_gae"), "SGD (16 minibatch steps)": (tr, "_sgd")}
    inner = {"locomotion action": "_locomotion_action", "torques (actuator net)": "_torques",
             "physics (substeps)": "_physics", "termination": "_termination"}
    for name, (owner, attr) in stages.items():
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    for name, attr in inner.items():
        setattr(wrap.env, attr, timed(name, getattr(wrap.env, attr)))
    ts, r, s = update(tr, ts)
    ms = {k: ACC[k] * 1e3 for k in stages}
    inner_ms = {k: ACC[k] * 1e3 for k in inner}
    inner_ms["rest of the env step"] = ms["env step (wrapper.step)"] - sum(inner_ms.values())
    ms["rest of the rollout"] = r * 1e3 - sum(ms[k] for k in list(stages)[:3])
    ms["rest of the SGD half (valuenorm, batch)"] = s * 1e3 - ms["GAE"] - ms["SGD (16 minibatch steps)"]

    T, E, A = tr.cfg.rollout_len, tr.E, tr.A
    upd = rollout_s + sgd_s
    print(f"{args.task} {args.algo} {E} envs on {smi}: update {upd * 1e3:.1f} ms (rollout "
          f"{rollout_s * 1e3:.1f}, SGD {sgd_s * 1e3:.1f}), {T * E * A / upd:.1f} env-steps/s as "
          f"T*E*A, {T * E / upd:.1f} as T*E; under the profiler {prof_wall * 1e3:.1f} ms")
    print(f"device: {dev_us / 1e3:.2f} ms of kernels an update, {n_kernels} kernels, busy share "
          f"{dev_us / 1e6 / prof_wall:.4f} of the profiled wall time")
    for t, n, key in by_name[:12]:
        print(f"  {t / 1e3:9.3f} ms  {n:7d}  {key[:90]}")
    print(f"stages (synchronized, {(r + s) * 1e3:.1f} ms):")
    for k, v in sorted(ms.items(), key=lambda kv: -kv[1]):
        print(f"  {v:9.2f} ms  {k}")
    print("inside the env step (synchronized around each):")
    for k, v in sorted(inner_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {v:9.2f} ms  {k}")
    print(json.dumps({"task": args.task, "algo": args.algo, "num_envs": E,
                      "rollout_ms": rollout_s * 1e3, "sgd_ms": sgd_s * 1e3,
                      "env_steps_per_s": T * E * A / upd, "env_steps_per_s_TE": T * E / upd,
                      "device_ms": dev_us / 1e3, "kernels": n_kernels,
                      "busy_share": dev_us / 1e6 / prof_wall, "stages_ms": ms,
                      "env_step_ms": inner_ms, "card": smi}))


if __name__ == "__main__":
    main()
