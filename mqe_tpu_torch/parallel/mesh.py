"""Data parallelism over envs: the env axis split over the ranks of a
`torch.distributed` process group.

Counterpart of `mqe_tpu/parallel/mesh.py`, which shards the EnvState's
leading env axis over a 1-D device mesh with `shard_map` and lets XLA
partition the step. Here there is no mesh of devices: the process group is
the mesh. Rank r of W owns envs [r*E/W, (r+1)*E/W) (E % W == 0). Envs are
independent, so the step has no collective; training all-reduces the
gradients (learn/ppo.py, `PPOTrainer(..., mesh=...)`), and the metric
reductions (`sharded_rollout`, the trainer's means) all-reduce their sums.

Every rank draws the global tensor of each random draw and keeps its rows
(utils/random.py, `Draws(env_slice=...)`), so a sharded run equals the
unsharded one draw for draw, and every rank's generator advances alike.

Start ranks with `init_mesh(rank, world, port)`, or run
`python -m mqe_tpu_torch.parallel.worker --rank R --world W --port P`. On one
card several ranks share it: NCCL refuses two ranks on one device, so they
use gloo over CUDA tensors; one rank a card may use NCCL.
"""
from __future__ import annotations

import copy
import datetime
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from mqe_tpu_torch.utils.tree import tree_map

# the Go1Env attributes that carry the env axis first (a dict's values too)
ENV_AXIS_ATTRS = ("env_rows", "env_origins", "agent_origins", "env_boxes", "env_info",
                  "static_geoms", "env_cols_j", "defender_gate")


@dataclass(frozen=True)
class EnvMesh:
    """The ranks of a process group, over which the env axis is split."""

    rank: int
    world: int
    group: object = None       # a torch.distributed ProcessGroup; None = the default group

    def env_slice(self, num_envs: int) -> tuple:
        """(start, stop) of this rank's envs of `num_envs`."""
        if num_envs % self.world:
            raise ValueError(f"{num_envs} envs do not split over {self.world} ranks")
        n = num_envs // self.world
        return self.rank * n, (self.rank + 1) * n


def init_mesh(rank: int, world: int, port: int, backend: str = "gloo",
              timeout_s: float = 60.0) -> EnvMesh:
    """Join the process group of `world` ranks at tcp://localhost:port and
    return its mesh. Call `close_mesh()` when done (in a `finally`)."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return env_mesh()


def close_mesh():
    if dist.is_initialized():
        dist.destroy_process_group()


def env_mesh(group=None) -> EnvMesh:
    """The mesh of an initialised process group (default: the whole world)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call init_mesh first")
    return EnvMesh(rank=dist.get_rank(group), world=dist.get_world_size(group), group=group)


def _slicer(num_envs, start, stop):
    def cut(t):
        if isinstance(t, torch.Tensor) or hasattr(t, "shape"):
            if len(t.shape) >= 1 and t.shape[0] == num_envs:
                return t[start:stop]
        return t
    return cut


def shard_env_axis(tree, mesh: EnvMesh, num_envs: int):
    """This rank's rows of every tensor (or numpy array) of `tree` whose
    leading axis is the env axis (`num_envs` long); the rest stays whole."""
    start, stop = mesh.env_slice(num_envs)
    return tree_map(_slicer(num_envs, start, stop), tree)


def all_reduce_sum(t: torch.Tensor, mesh: EnvMesh) -> torch.Tensor:
    """The sum over the ranks of `t` (a new tensor; bools and ints exact).
    A group of one rank still runs the collective."""
    out = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
    if mesh.world > 1 or dist.is_initialized():
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def gather_env_axis(tree, mesh: EnvMesh, num_envs_local: int):
    """The inverse of shard_env_axis: every rank gets the whole env axis of
    each tensor whose leading axis is its `num_envs_local` envs. Built as a
    sum of zero-padded slices (exact), since gloo gathers no CUDA tensors."""
    total = num_envs_local * mesh.world
    start = mesh.rank * num_envs_local

    def gather(t):
        if not isinstance(t, torch.Tensor) or t.ndim == 0 or t.shape[0] != num_envs_local:
            return t
        work = t.to(torch.int32) if t.dtype == torch.bool else t
        full = work.new_zeros((total,) + tuple(t.shape[1:]))
        full[start:start + num_envs_local] = work
        full = all_reduce_sum(full, mesh)
        return full.to(torch.bool) if t.dtype == torch.bool else full

    return tree_map(gather, tree)


def shard_wrapper(wrapper, mesh: EnvMesh):
    """A task wrapper over this rank's envs of `wrapper` (built for the
    global env count): a shallow copy whose env keeps the rank's rows of
    every per-env constant (`ENV_AXIS_ATTRS`, the terrain's per-env boxes
    and static geoms) and draws as one rank of the mesh. Model constants,
    nets and the generator's seed stay the global wrapper's."""
    env0 = wrapper.env
    E = env0.num_envs
    start, stop = mesh.env_slice(E)
    cut = _slicer(E, start, stop)
    env = copy.copy(env0)
    for name in ENV_AXIS_ATTRS:
        if hasattr(env0, name):
            setattr(env, name, tree_map(cut, getattr(env0, name)))
    env.terrain = replace(env0.terrain, boxes=cut(env0.terrain.boxes),
                          static_boxes=cut(env0.terrain.static_boxes),
                          static_cyls=cut(env0.terrain.static_cyls))
    env.num_envs = stop - start
    env.env_slice = (start, stop, E)
    env.generator = torch.Generator(device=env0.generator.device)
    env.generator.set_state(env0.generator.get_state())
    w = copy.copy(wrapper)
    w.env = env
    w.num_envs = env.num_envs
    return w


def sharded_step(wrapper, mesh: EnvMesh):
    """step(ts, actions, draws=None) -> (ts, obs, rew, done, info) of this
    rank's slice: `wrapper` is a global wrapper (sharded here) or one that
    shard_wrapper made. Envs are independent: no collective on the step."""
    local = wrapper if wrapper.env.env_slice is not None else shard_wrapper(wrapper, mesh)

    def step(ts, actions, draws=None):
        return local.step(ts, actions, draws)

    return step


def sharded_rollout(wrapper, mesh: EnvMesh, length: int):
    """rollout(ts, actions) -> (ts, mean reward): `length` sharded steps
    under fixed actions; the mean over every env of every rank and step
    (the reward's sum all-reduced)."""
    step = sharded_step(wrapper, mesh)

    def rollout(ts, actions):
        total = None
        count = 0
        for _ in range(length):
            ts, obs, rew, done, info = step(ts, actions)
            s = rew.sum()
            total = s if total is None else total + s
            count += rew.numel()
        return ts, all_reduce_sum(total, mesh) / (count * mesh.world)

    return rollout
