"""Task wrappers: observation assembly and reward shaping per task.

PyTorch counterpart of `mqe_tpu/envs/wrappers.py` (`TaskWrapper`,
`Go1GateWrapper`; ref mqe/envs/wrappers/*.py). Each task has a flat
observation (one-hot agent ids + own/teammate base info + task oracle state),
a Box(3) action of (vx, vy, yaw) commands scaled by [2.0, 0.5, 0.5]
(ref go1_pushbox_wrapper.py:16), and dense/sparse rewards. Carried wrapper
values live in `TaskState.extra`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mqe_tpu_torch.envs.go1_env import EnvState, Go1Env, ObsBuf
from mqe_tpu_torch.utils.random import Draws
from mqe_tpu_torch.utils.tree import tree_map

ACTION_SCALE = np.array([2.0, 0.5, 0.5], dtype=np.float32)


@dataclass
class TaskState:
    env: EnvState
    extra: dict  # task-specific carried tensors (stable key set per task)


def _scales(cfg):
    return {k: getattr(cfg.rewards.scales, k)
            for k in dir(cfg.rewards.scales) if not k.startswith("_")}


def _perenv(x):
    """(E,) per-env term value: sum over every non-env axis."""
    return x.sum(dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x


class TaskWrapper:
    """Base wrapper; subclasses override obs_dim, _extra_init, _obs, _reward.

    Subclasses with a task-success notion set `has_success = True` and
    implement `_success(state, obs, extra) -> (E,) bool`; the step carries a
    per-episode ever-succeeded flag in extra["ep_success"] and reports it in
    info["ep_success"].
    """

    has_success = False

    def __init__(self, env: Go1Env):
        self.env = env
        self.cfg = env.cfg
        self.device = env.device
        self.num_envs = env.num_envs
        self.num_agents = env.num_agents
        self.scales = _scales(env.cfg)
        self.bt = getattr(env.cfg.terrain, "BarrierTrack_kwargs", None)
        self.action_scale = torch.as_tensor(ACTION_SCALE, device=env.device)

    # ---- per-task hooks ----
    @property
    def obs_dim(self) -> int:
        raise NotImplementedError

    def _extra_init(self, state: EnvState, obs: ObsBuf) -> dict:
        return {}

    def _obs(self, state: EnvState, obs: ObsBuf, extra: dict) -> torch.Tensor:
        raise NotImplementedError

    def _reward(self, state: EnvState, obs: ObsBuf, extra: dict, actions, info):
        """Returns (reward (E, A), new_extra, terms dict of (E,) sums)."""
        return torch.zeros((self.num_envs, self.num_agents), device=self.device), extra, {}

    def _success(self, state: EnvState, obs: ObsBuf, extra: dict):
        raise NotImplementedError

    # ---- shared helpers ----
    def _ids(self):
        A = self.num_agents
        return torch.eye(A, device=self.device).expand(self.num_envs, A, A)

    def _base_info(self, obs: ObsBuf):
        """(E, A, 6): base_pos(3, env-relative) + base_rpy(3)."""
        return torch.cat([obs.base_pos, obs.base_rpy], dim=-1)

    def _gate_pos(self, obs: ObsBuf, x_offset: float):
        """(E, 2) env-relative gate center from the terrain oracle info."""
        dev = obs.env_info["gate_deviation"]
        return torch.stack([dev[:, 0] + x_offset, dev[:, 1]], dim=-1)

    # ---- public API ----
    @torch.no_grad()
    def reset(self, draws: Draws | None = None):
        state, obs_buf = self.env.reset(draws)
        extra = self._extra_init(state, obs_buf)
        if self.has_success:
            extra = {**extra, "ep_success": torch.zeros(
                (self.num_envs,), dtype=torch.bool, device=self.device)}
        return TaskState(env=state, extra=extra), self._obs(state, obs_buf, extra)

    @torch.no_grad()
    def step(self, ts: TaskState, actions, draws: Draws | None = None):
        """actions (E, A, 3) in [-1, 1]. Returns (ts, obs, reward, done, info)."""
        draws = draws or self.env.draws()
        actions = torch.clamp(actions, -1.0, 1.0)
        cmds = actions * self.action_scale
        pre_state, carry = self.env._step_pre(ts.env, cmds, draws)
        state, obs_buf, done, info = self.env._step_finish(pre_state, carry, draws)
        reward, extra, terms = self._reward(state, obs_buf, ts.extra, actions, info)
        # diff-based rewards reinitialize across resets: fresh extras for reset envs
        fresh_extra = self._extra_init(state, obs_buf)
        info = dict(info)
        if self.has_success:
            # evaluated on the PRE-reset state: a success that coincides with
            # termination is seen before the env respawns
            pre_obs = self.env._observations(pre_state)
            ever = ts.extra["ep_success"] | self._success(pre_state, pre_obs, ts.extra)
            info["ep_success"] = ever
            extra = {**extra, "ep_success": ever}
            fresh_extra = {**fresh_extra, "ep_success": torch.zeros_like(ever)}
        mask = info["reset_mask"]

        def sel(new, old):
            return torch.where(mask.reshape((self.num_envs,) + (1,) * (new.ndim - 1)), new, old)

        extra = tree_map(sel, fresh_extra, extra)
        obs = self._obs(state, obs_buf, extra)
        info["reward_terms"] = terms
        return TaskState(env=state, extra=extra), obs, reward, done, info


class Go1GateWrapper(TaskWrapper):
    """Cooperative gate passage; rewards per the reference's commented spec
    (ref go1_gate_wrapper.py:84-154)."""

    has_success = True

    @property
    def obs_dim(self):
        return 14 + self.num_agents

    def _success(self, state, obs, extra):
        # all agents through the gate (same threshold as the success term)
        return (obs.base_pos[..., 0] > extra["gate"][:, 0:1] + 0.25).all(dim=1)

    def _gate(self, obs):
        return self._gate_pos(
            obs, self.bt["init"]["block_length"] + self.bt["gate"]["block_length"] / 2)

    def _extra_init(self, state, obs):
        gate = self._gate(obs)                         # (E, 2)
        E, A = self.num_envs, self.num_agents
        tgt_x = (
            self.bt["init"]["block_length"]
            + self.bt["gate"]["block_length"]
            + self.bt["plane"]["block_length"] / 2
        )
        w = self.bt["track_width"]
        tgt_y = torch.tensor([w / 4, -w / 4][:A] if A <= 2 else [0.0] * A,
                             dtype=torch.float32, device=self.device)
        tgt = torch.stack(
            [torch.full((E, A), float(tgt_x), device=self.device), tgt_y.expand(E, A)], dim=-1)
        d0 = torch.linalg.norm(obs.base_pos[..., :2] - tgt, dim=-1)
        return {"target": tgt, "last_dist": d0, "gate": gate}

    def _obs(self, state, obs, extra):
        bi = self._base_info(obs)
        gate = extra["gate"][:, None, :].expand(-1, self.num_agents, -1)
        return torch.cat([self._ids(), bi, torch.flip(bi, dims=(1,)), gate], dim=-1)

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        rew = torch.zeros((E, A), device=self.device)
        terms = {}
        dist = torch.linalg.norm(obs.base_pos[..., :2] - extra["target"], dim=-1)
        if s.get("target_reward_scale", 0) != 0:
            prog = (extra["last_dist"] - dist).sum(dim=1, keepdim=True)
            prog = torch.where(info["reset_mask"][:, None], 0.0, prog)
            r = s["target_reward_scale"] * prog
            rew = rew + r
            terms["target reward"] = _perenv(r)
        if s.get("success_reward_scale", 0) != 0:
            gate_x = extra["gate"][:, 0:1]
            succ = (obs.base_pos[..., 0] > gate_x + 0.25).to(torch.float32)
            r = s["success_reward_scale"] * succ
            rew = rew + r
            terms["success reward"] = _perenv(r)
        if s.get("contact_punishment_scale", 0) != 0:
            r = s["contact_punishment_scale"] * state.collide.to(torch.float32)
            rew = rew + r[:, None]
            terms["contact punishment"] = _perenv(r)
        if s.get("agent_distance_punishment_scale", 0) != 0 and A > 1:
            other = torch.flip(obs.base_pos[..., :2], dims=(1,))
            d2 = ((obs.base_pos[..., :2] - other) ** 2).sum(-1)
            pun = torch.where(
                d2 < 0.25, s["agent_distance_punishment_scale"] / torch.clamp_min(d2, 1e-3), 0.0)
            rew = rew + pun
            terms["agent distance punishment"] = _perenv(pun)
        extra = {**extra, "last_dist": dist}
        return rew, extra, terms
