"""Smoke/demo CLI mirroring the reference's root test.py (ref test.py:31-71),
the port's counterpart of `mqe_tpu/scripts/demo.py`: constructs a task,
steps constant commands, prints state stats.

  python -m mqe_tpu_torch.scripts.demo --task go1gate --num-envs 4 --seconds 5 [--cpu]

It runs on the card unless `--cpu` is passed.
"""
from __future__ import annotations

import argparse

from mqe_tpu_torch import default_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="go1gate")
    p.add_argument("--num-envs", type=int, default=4)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--vx", type=float, default=0.5)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    import torch

    from mqe_tpu_torch.envs.registry import make_mqe_env
    from mqe_tpu_torch.utils.random import Draws

    device = "cpu" if args.cpu else default_device()
    wrap, cfg = make_mqe_env(args.task, num_envs=args.num_envs, seed=0, device=device)
    A = wrap.controlled_agents
    print(f"task={args.task} envs={wrap.num_envs} agents={wrap.num_agents} "
          f"npcs={wrap.num_npcs} obs_dim={wrap.obs_dim} device={device}", flush=True)

    gen = torch.Generator(device=wrap.device).manual_seed(0)
    ts, obs = wrap.reset(Draws(gen))
    acts = torch.tensor([args.vx, args.vy, args.yaw], device=wrap.device).repeat(
        args.num_envs, A, 1)
    n = int(args.seconds / wrap.env.dt)
    total_rew = 0.0
    dones = 0
    for i in range(n):
        ts, obs, rew, done, info = wrap.step(ts, acts, Draws(gen))
        total_rew += float(rew.sum())
        dones += int(done.sum())
        if i % 50 == 49:
            pos = ts.env.phys.agents.pos[0].cpu().numpy()
            print(
                f"t={(i + 1) * wrap.env.dt:5.2f}s agent0 pos={pos[0].round(2)} "
                f"reward_sum={total_rew:.2f} resets={dones}",
                flush=True,
            )
    print(f"done: {n} steps, total reward {total_rew:.2f}, resets {dones}")
    return dict(steps=n, total_reward=total_rew, resets=dones)


if __name__ == "__main__":
    main()
