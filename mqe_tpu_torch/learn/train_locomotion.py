"""Train the low-level locomotion (body) policy with PPO, PyTorch.

Counterpart of `mqe_tpu/learn/train_locomotion.py`, with the same flags. It
produces a body policy for Go1Env's `policy` and `residual` backends: a
70-dim-obs -> 12-action MLP, saved as an npz in the JAX package's layout
(flax names "params/actor/Dense_i/kernel" (in, out), "params/critic/...",
"params/log_std", and "meta_prescale"), which `control/nets.py::
load_body_policy` of either package reads.

  python -m mqe_tpu_torch.learn.train_locomotion --num-envs 4096 \
      --train-timesteps 20000000 --out build/body_policy.npz [--cpu]

It runs on the card unless `--cpu` is passed. `--out` defaults to
build/body_policy.npz in the repository (git-ignored); the JAX package's
assets are not written. `--split-jit` is accepted and runs the same update
(learn/ppo.py).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from mqe_tpu_torch import REPO_ROOT, default_device

DEFAULT_OUT = os.path.join(REPO_ROOT, "build", "body_policy.npz")


def policy_npz(net, params, prescale) -> dict:
    """{flax name: numpy array} of `params` ({name: tensor} of `net`), and
    "meta_prescale"."""
    from mqe_tpu_torch.learn.networks import flax_path, to_flax_leaf

    out = {"meta_prescale": np.asarray(prescale, dtype=np.float32)}
    for name, t in params.items():
        out["/".join(("params",) + flax_path(net, name))] = to_flax_leaf(net, name, t)
    return out


def warm_start(net, params, path):
    """`params` with every leaf that the npz at `path` holds (flax names,
    shapes checked) -> (params, names of the leaves it lacks)."""
    from mqe_tpu_torch.learn.networks import flax_path, from_flax_leaf

    new, missing = {}, []
    with np.load(path) as d:
        for name, leaf in params.items():
            key = "/".join(("params",) + flax_path(net, name))
            if key in d:
                t = from_flax_leaf(net, name, d[key])
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: {tuple(t.shape)} in {path}, "
                                     f"{tuple(leaf.shape)} in the net")
                new[name] = t.to(leaf.device)
            else:
                missing.append(key)
                new[name] = leaf
    return new, missing


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--train-timesteps", type=int, default=10_000_000)
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--updates-per-call", type=int, default=1)
    p.add_argument("--split-jit", action="store_true",
                   help="accepted for the JAX CLI's sake; the same update runs")
    p.add_argument(
        "--resample-prob", type=float, default=0.0,
        help="per-env per-step probability of a random command switch "
             "(robustness to the task layer's 50 Hz command changes)")
    p.add_argument(
        "--multi-gait", type=float, default=0.0,
        help="per-episode probability of a non-trot library gait "
             "(pacing/bounding/pronking uniform); conditions the policy on "
             "the gait-params obs dims like the WTW reference")
    p.add_argument(
        "--init-policy", default=None,
        help="warm-start actor+critic from a previously saved body-policy "
             "npz (continue training instead of from scratch)")
    p.add_argument(
        "--backend", default="residual", choices=["residual", "policy", "trot"],
        help="'residual' = learn a correction on the model-based trot; "
             "'policy' = learn joint offsets from scratch against the bare "
             "actuator-net path (ref go1.py:315-354)")
    args = p.parse_args(argv)

    from mqe_tpu_torch.learn.locomotion_env import LocomotionEnv, locomotion_cfg
    from mqe_tpu_torch.learn.ppo import PPOConfig, PPOTrainer

    device = "cpu" if args.cpu else default_device()
    env = LocomotionEnv(num_envs=args.num_envs, seed=args.seed, cfg=locomotion_cfg(args.backend),
                        resample_prob=args.resample_prob, multi_gait=args.multi_gait,
                        device=device)
    trainer = PPOTrainer(env, PPOConfig(lr=args.lr, rollout_len=args.rollout_len, ent_coef=1e-3),
                         seed=args.seed)
    print(f"locomotion training: envs={args.num_envs} backend={args.backend} device={device}",
          flush=True)

    if args.init_policy:
        trainer.init_params, missing = warm_start(trainer.net, trainer.init_params,
                                                  args.init_policy)
        print(f"warm-started from {args.init_policy}"
              + (f" (fresh: {missing})" if missing else ""), flush=True)

    def cb(m):
        print(json.dumps(m), flush=True)

    t0 = time.time()
    ts, _ = trainer.train(args.train_timesteps, callback=cb,
                          updates_per_call=args.updates_per_call, log_every=1)
    print(f"done in {time.time() - t0:.0f}s", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **policy_npz(trainer.net, ts.params, env.prescale))
    print(f"saved body policy params to {args.out}", flush=True)
    return args.out


if __name__ == "__main__":
    main()
