"""Policy evaluation CLI (ref openrl_ws/test.py:48-99), the port's
counterpart of `mqe_tpu/learn/evaluate.py`: load a checkpoint, roll out,
report per-episode returns and the success rate.

  python -m mqe_tpu_torch.learn.evaluate --task go1bridge \
      --checkpoint checkpoints/r5b/go1bridge_ppo_best.npz --episodes 1 [--cpu]

`--checkpoint` takes this package's checkpoint or a JAX package TrainState
file. It runs on the card unless `--cpu` is passed. `--max-steps` bounds the
loop (default: episodes x the task's episode length). `--video out.gif`
draws env 0 every second step with the host-side top-down renderer
(render/topdown.py: matplotlib and PIL, imported only then) and writes the
frames as a GIF.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.func import functional_call

from mqe_tpu_torch import default_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="go1gate")
    p.add_argument("--checkpoint", required=False, default=None)
    p.add_argument("--num-envs", type=int, default=4)
    p.add_argument("--episodes", type=int, default=2)
    p.add_argument("--max-steps", type=int, default=None,
                   help="steps at most (default: episodes x the episode length)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--video", default=None, help="output GIF path (env 0)")
    p.add_argument("--json", default=None, help="append one JSON record of the result here")
    p.add_argument("--recurrent", action="store_true",
                   help="checkpoint was trained with --recurrent (GRU policy)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--gait", default=None,
                   choices=[None, "trotting", "pacing", "bounding", "pronking"],
                   help="override the task's default-command gait (as trained)")
    p.add_argument("--stochastic", action="store_true",
                   help="sample actions from the policy instead of acting on the mean")
    args = p.parse_args(argv)

    from mqe_tpu_torch.envs.registry import make_mqe_env
    from mqe_tpu_torch.learn.networks import ActorCritic, RecurrentActorCritic
    from mqe_tpu_torch.learn.train import gait_cfg
    from mqe_tpu_torch.utils.checkpoint import params_from_checkpoint
    from mqe_tpu_torch.utils.random import Draws

    device = "cpu" if args.cpu else default_device()
    wrap, _ = make_mqe_env(args.task, num_envs=args.num_envs, seed=args.seed,
                           custom_cfg=gait_cfg(args.gait), device=device)
    E, A = args.num_envs, wrap.controlled_agents
    cls = RecurrentActorCritic if args.recurrent else ActorCritic
    net = cls(wrap.obs_dim, wrap.action_dim).to(device)
    h = net.initial_state((E, A), device=device) if args.recurrent else None
    params = None
    if args.checkpoint:
        params = params_from_checkpoint(args.checkpoint, net)
        print(f"loaded checkpoint {args.checkpoint}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    ts, obs = wrap.reset(Draws(gen))

    @torch.no_grad()
    def act(obs, h, draws):
        out = functional_call(net, params, (obs, h) if args.recurrent else (obs,))
        mean, log_std = out[0], out[1]
        if args.stochastic:
            mean = mean + torch.exp(log_std) * draws.normal("act_noise", mean.shape, device)
        return wrap.rl_prescale(mean), (out[3] if args.recurrent else None)

    frames, renderer = [], None
    if args.video:
        from mqe_tpu_torch.render.topdown import TopDownRenderer

        renderer = TopDownRenderer(wrap.env)

    ep_returns = np.zeros((E,))
    finished_returns, finished_succ = [], []
    max_steps = args.max_steps or args.episodes * wrap.env.max_episode_length
    for i in range(max_steps):
        draws = Draws(gen)
        if params is not None:
            actions, h = act(obs, h, draws)
        else:
            actions = torch.zeros((E, A, 3), device=device)
            actions[..., 0] = 0.5
        ts, obs, rew, done, info = wrap.step(ts, actions, draws)
        ep_returns += rew.mean(dim=-1).cpu().numpy()
        d = done.cpu().numpy()
        if d.any():
            if args.recurrent:  # fresh memory for new episodes
                h = torch.where(done[:, None, None], 0.0, h)
            finished_returns.extend(ep_returns[d].tolist())
            ep_returns[d] = 0.0
            if "ep_success" in info:  # the per-episode task success flag
                finished_succ.extend(info["ep_success"].cpu().numpy()[d].tolist())
        if renderer is not None and i % 2 == 0:
            frames.append(renderer.render(ts.env, env_idx=0))
        if len(finished_returns) >= args.episodes * E:
            break

    succ_str = f" success_rate={np.mean(finished_succ):.3f}" if finished_succ else ""
    mean_ret = float(np.mean(finished_returns)) if finished_returns else float(np.mean(ep_returns))
    print(f"episodes={len(finished_returns)} mean_return={mean_ret:.3f}" + succ_str)
    rec = {"task": args.task, "checkpoint": args.checkpoint, "episodes": len(finished_returns),
           "mean_return": round(mean_ret, 4), "seed": args.seed,
           "mode": "stochastic" if args.stochastic else "deterministic"}
    if finished_succ:
        rec["success_rate"] = round(float(np.mean(finished_succ)), 5)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(rec) + "\n")
    if renderer is not None and frames:
        renderer.save_gif(frames, args.video)
        print(f"wrote {args.video} ({len(frames)} frames)")
    return rec


if __name__ == "__main__":
    main()
