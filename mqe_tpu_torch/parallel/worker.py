"""One rank of the env-axis split (parallel/mesh.py), for the tests and the
card's smoke run.

    python -m mqe_tpu_torch.parallel.worker --rank R --world W --port P \
        [--device cuda|cpu] [--backend gloo|nccl] [--task go1gate] [--num-envs E] \
        [--steps N] [--start FILE --case CASE] [--update] [--rollout N] [--out FILE]

Start W of them with the same arguments but the rank (any free port). Each
joins the process group at tcp://localhost:P, builds the task at E global
envs and keeps its E/W (`shard_wrapper`), then:
  - steps: from a reset (its draws sharded), or from the start state and
    actions that tools/make_torch_goldens.py recorded in FILE under CASE,
    N steps (actions uniform(-1, 1) from RandomState(1) over the global env
    axis when not recorded); each step's obs, reward and done and the end
    state are gathered over the ranks;
  - `--update`: one PPO update of a trainer with the mesh (PPOConfig's
    defaults unless --rollout-len, --num-minibatches, --ppo-epochs), from its
    init_state at the same seed; the params after it, its metrics, and a
    check that every rank holds the same params;
  - `--rollout N`: `sharded_rollout` of N steps under the drawn actions
    from a reset (the generator at the seed again), its all-reduced mean
    reward;
and counts each kernel's launches over its steps (and over the update).
Rank 0 writes the gathered results to FILE (--out, npz) and every rank prints
"WORKER OK rank=R" at its end. GEMMs run in float32 (TF32 off). Any
failure exits nonzero; the process group
has a timeout (--timeout) and is destroyed in a `finally`. With
`--device cuda` a rank that finds no GPU raises: nothing falls back.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from mqe_tpu_torch.parallel.mesh import (close_mesh, gather_env_axis, init_mesh, shard_env_axis,
                                         shard_wrapper, sharded_rollout, sharded_step,
                                         all_reduce_sum)

KERNEL_NAMES = ("fused_step_kernel", "fk_spheres_kernel", "fk_full_kernel")


def _kernels():
    from mqe_tpu_torch.physics import fused_step

    return {"fused_step_kernel": fused_step.step_actor_kernel,
            "fk_spheres_kernel": fused_step.fk_spheres_kernel,
            "fk_full_kernel": fused_step.fk_full_kernel}


def _counts_reset():
    for w in _kernels().values():
        w.launches = 0


def _counts():
    return {k: int(w.launches) for k, w in _kernels().items()}


def _per_rank(values: list, mesh, device):
    """(W, len(values)) table of every rank's `values`, rank 0's first."""
    row = torch.zeros((mesh.world, len(values)), dtype=torch.float64, device=device)
    row[mesh.rank] = torch.tensor(values, dtype=torch.float64, device=device)
    return all_reduce_sum(row, mesh).cpu().numpy()


def _flat_state(prefix, st, out):
    for who in ("agents", "npcs"):
        for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
            out[f"{prefix}/{who}/{f}"] = getattr(getattr(st.env.phys, who), f).cpu().numpy()


def _recorded_start(path, case, device):
    from mqe_tpu_torch.utils.convert import env_state_from_numpy

    with np.load(path) as f:
        rec = dict(f)
    root = {}
    for key, arr in rec.items():
        if key.startswith(f"{case}/start/"):
            *p, leaf = key[len(case) + 7:].split("/")
            node = root
            for name in p:
                node = node.setdefault(name, {})
            node[leaf] = arr

    from types import SimpleNamespace

    def build(node, name):
        if not isinstance(node, dict):
            return node
        kids = {k: build(v, k) for k, v in node.items()}
        return kids if name == "extra" else SimpleNamespace(**kids)

    return env_state_from_numpy(build(root, ""), device=device), rec[f"{case}/actions"]


def run(args) -> dict:
    from mqe_tpu_torch.envs.registry import make_mqe_env

    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"rank {args.rank}: --device cuda but torch finds no GPU")
    if args.threads:
        # a network's initial weights depend on the CPU threads (its
        # orthogonal init factorises on the CPU): give every rank the
        # launching process's count
        torch.set_num_threads(args.threads)
    # float32 throughout, as the rest of the port: no TF32 GEMMs on the card
    # (whatever this installation's default is), so a rank's arithmetic is
    # the one-process run's
    tf32_default = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_mesh(args.rank, args.world, args.port, backend=args.backend,
                     timeout_s=args.timeout)
    out, timing = {}, {}
    try:
        wrap, _ = make_mqe_env(args.task, num_envs=args.num_envs, seed=args.seed, device=dev)
        local = shard_wrapper(wrap, mesh)
        El, E = local.num_envs, args.num_envs
        drawn = np.random.RandomState(1).uniform(
            -1, 1, (E, local.controlled_agents, 3)).astype(np.float32)
        if args.start:
            ts_global, acts = _recorded_start(args.start, args.case, dev)
            ts = shard_env_axis(ts_global, mesh, E)
        else:
            ts, _ = local.reset()
            acts = drawn
        acts_l = shard_env_axis(torch.as_tensor(acts, device=dev), mesh, E)
        step = sharded_step(local, mesh)
        # steps
        _counts_reset()
        t0 = time.perf_counter()
        for t in range(args.steps):
            ts, obs, rew, done, _ = step(ts, acts_l)
            g = gather_env_axis({"obs": obs, "reward": rew, "done": done}, mesh, El)
            for k, v in g.items():
                out[f"step/{t}/{k}"] = v.cpu().numpy()
        if dev == "cuda":
            torch.cuda.synchronize()
        timing["steps_s"] = time.perf_counter() - t0
        _flat_state("step/end", gather_env_axis(ts, mesh, El), out)
        counts = _counts()
        table = _per_rank([counts[k] for k in KERNEL_NAMES], mesh, dev)
        for r in range(mesh.world):
            for i, k in enumerate(KERNEL_NAMES):
                out[f"launches/steps/{r}/{k}"] = np.asarray(table[r, i])
        if args.update:
            from mqe_tpu_torch.learn.ppo import PPOConfig, PPOTrainer

            kw = {k: getattr(args, k) for k in ("rollout_len", "num_minibatches", "ppo_epochs")
                  if getattr(args, k) is not None}
            tr = PPOTrainer(local, PPOConfig(**kw), seed=args.seed, mesh=mesh)
            ts_u = tr.init_state()
            _counts_reset()
            t0 = time.perf_counter()
            ts_u, metrics = tr.update(ts_u)
            if dev == "cuda":
                torch.cuda.synchronize()
            timing["update_s"] = time.perf_counter() - t0
            counts = _counts()
            table = _per_rank([counts[k] for k in KERNEL_NAMES], mesh, dev)
            for r in range(mesh.world):
                for i, k in enumerate(KERNEL_NAMES):
                    out[f"launches/update/{r}/{k}"] = np.asarray(table[r, i])
            flat = torch.cat([p.reshape(-1) for p in ts_u.params.values()])
            spread = float((all_reduce_sum(flat, mesh) / mesh.world - flat).abs().max())
            worst = _per_rank([spread], mesh, dev).max()
            if worst != 0.0:
                raise AssertionError(f"the ranks' params differ after the update: {worst:.3e}")
            for k, v in ts_u.params.items():
                out[f"update/params/{k}"] = v.detach().cpu().numpy()
            for k, v in metrics.items():
                out[f"update/metrics/{k}"] = np.asarray(float(v))
        if args.rollout:
            fresh = shard_wrapper(wrap, mesh)   # its generator at the seed again
            ts_r, _ = fresh.reset()
            roll = sharded_rollout(fresh, mesh, args.rollout)
            _, mean = roll(ts_r, shard_env_axis(torch.as_tensor(drawn, device=dev), mesh, E))
            out["rollout/mean_reward"] = np.asarray(float(mean))
        out["tf32_default"] = np.asarray(tf32_default)
        for k, v in timing.items():
            out[f"timing/{mesh.rank}/{k}"] = np.asarray(v)
        tt = _per_rank([timing.get("steps_s", 0.0), timing.get("update_s", 0.0)], mesh, dev)
        out["timing/steps_s"], out["timing/update_s"] = tt[:, 0], tt[:, 1]
    finally:
        close_mesh()
    if args.rank == 0 and args.out:
        np.savez(args.out, **out)
    return {"rank": args.rank, **timing}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--task", default="go1gate")
    p.add_argument("--num-envs", type=int, default=4096, help="global envs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--start", default=None, help="npz of a recorded start state and actions")
    p.add_argument("--case", default="in-contact")
    p.add_argument("--update", action="store_true")
    p.add_argument("--rollout-len", type=int, default=None)
    p.add_argument("--num-minibatches", type=int, default=None)
    p.add_argument("--ppo-epochs", type=int, default=None)
    p.add_argument("--rollout", type=int, default=0, help="steps of a sharded rollout")
    p.add_argument("--threads", type=int, default=0,
                   help="torch's CPU threads (default: torch's own default)")
    p.add_argument("--timeout", type=float, default=120.0, help="process group timeout, s")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    res = run(args)
    print(f"WORKER OK rank={args.rank} world={args.world} {json.dumps(res)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
