"""CLI: closed-loop MPC rollout on a task (planner counterpart of
learn/evaluate.py's policy rollouts), the port's `mqe_tpu/mpc/run_mpc.py`.

  python -m mqe_tpu_torch.mpc.run_mpc --task go1gate --num-envs 8 --cycles 40
  python -m mqe_tpu_torch.mpc.run_mpc --task go1pushbox --mpc-task pushbox --fit

Fits the command-tracking model from the live env (--fit) or uses the
default, then runs receding-horizon iLQR and prints progress and the solve
rate as one JSON line (also returned). Runs on the card unless `--cpu`.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from mqe_tpu_torch import default_device


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="go1gate")
    p.add_argument("--mpc-task", default=None, help="waypoint|gate|pushbox (default: infer)")
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--cycles", type=int, default=40)
    p.add_argument("--horizon", type=int, default=15)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--fit", action="store_true", help="fit tracking model from env rollouts")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    from mqe_tpu_torch.envs.registry import make_mqe_env
    from mqe_tpu_torch.mpc import CommandMPC, ILQRConfig, fit_command_model
    from mqe_tpu_torch.mpc.controller import planner_state
    from mqe_tpu_torch.utils.random import Draws

    device = "cpu" if args.cpu else default_device()
    wrap, _ = make_mqe_env(args.task, num_envs=args.num_envs, seed=args.seed, device=device)
    mpc_task = args.mpc_task or {
        "go1gate": "gate", "go1pushbox": "pushbox",
    }.get(args.task, "waypoint")

    model = None
    if args.fit:
        t0 = time.time()
        model = fit_command_model(wrap, n_steps=80, seed=args.seed)
        print(
            f"fit model in {time.time()-t0:.1f}s: tau_v={model.tau_v:.2f}s "
            f"tau_w={model.tau_w:.2f}s gain_v={model.gain_v:.2f} gain_w={model.gain_w:.2f}"
        )

    mpc = CommandMPC(
        wrap, task=mpc_task,
        ilqr_cfg=ILQRConfig(horizon=args.horizon, n_iters=args.iters),
        model=model,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, _ = mpc.env.reset(Draws(gen))
    x0 = float(planner_state(mpc.env, state)[..., 0].mean())
    ms = mpc.init_mpc_state()
    cost = None

    # warm-up cycle (discarded), as the JAX CLI's compile call
    mpc.plan_step(state, ms, Draws(gen))
    _sync(device)

    t0 = time.time()
    for i in range(args.cycles):
        state, ms, done, cost = mpc.plan_step(state, ms, Draws(gen))
        if i % 10 == 0 or i == args.cycles - 1:
            x = planner_state(mpc.env, state)
            print(
                f"cycle {i:3d}  mean x={float(x[..., 0].mean()):.3f} m  "
                f"cost={float(cost.mean()):.2f}  resets={int(done.sum())}"
            )
    _sync(device)
    wall = time.time() - t0
    x1 = float(planner_state(mpc.env, state)[..., 0].mean())
    rec = {
        "task": args.task,
        "mpc_task": mpc_task,
        "mean_x_progress_m": round(x1 - x0, 3),
        "solves_per_s": round(args.cycles * args.num_envs / wall, 1),
        "sim_seconds": round(args.cycles * mpc.steps_per_knot * mpc.env.dt, 2),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
