"""Task wrappers: observation assembly and reward shaping per task.

PyTorch counterpart of `mqe_tpu/envs/wrappers.py` (`TaskWrapper`,
`EmptyWrapper`, `Go1GateWrapper`, `Go1PushboxWrapper`, `Go1SeesawWrapper`;
ref mqe/envs/wrappers/*.py). Each task has a flat
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

    action_dim = 3
    has_success = False

    def __init__(self, env: Go1Env):
        # train-time option of the competitive tasks: a per-seat zero-sum
        # reward (`_selfplay_reward`) in place of the task's own;
        # selfplay_punishment overrides the config's own-fall penalty there
        # (None = the config's)
        self.selfplay = False
        self.selfplay_punishment = None
        self.env = env
        self.cfg = env.cfg
        self.device = env.device
        self.num_envs = env.num_envs
        self.num_agents = env.num_agents
        self.num_npcs = env.num_npcs
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

    def _gate_x(self, *blocks):
        """x-offset from the env origin of the end of the named blocks."""
        return sum(self.bt[b]["block_length"] for b in blocks)

    def _block_x(self, name, occurrence=0, frac=0.0):
        """x-offset from the env origin of the start of the `occurrence`-th
        block named `name` in the configured block list, plus `frac` of that
        block's length."""
        off, seen = 0.0, 0
        for b in self.bt["options"]:
            if b == name:
                if seen == occurrence:
                    return off + frac * self.bt[b]["block_length"]
                seen += 1
            off += self.bt[b]["block_length"]
        raise KeyError(f"block {name!r} (occurrence {occurrence}) not in options")

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
        cmds = self._transform_actions(actions) * self.action_scale
        pre_state, carry = self.env._step_pre(ts.env, cmds, draws)
        state, obs_buf, done, info = self.env._step_finish(pre_state, carry, draws)
        reward, extra, terms = self._reward(state, obs_buf, ts.extra, actions, info)
        if self.selfplay:
            # read on the PRE-reset state, where a fall that ends the
            # episode is still seen
            reward = self._selfplay_reward(
                pre_state, self.env._observations(pre_state), reward, ts.extra)
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

    def _transform_actions(self, actions):
        """Hook for competitive wrappers that mirror agent 1's actions."""
        return actions

    def _selfplay_reward(self, pre_state, pre_obs, reward, extra):
        """Hook: per-seat zero-sum reward for shared-policy self-play
        (`selfplay = True`). Default: the task reward unchanged."""
        return reward

    def observe(self, ts: TaskState) -> torch.Tensor:
        """Task observation of a TaskState (what the RL loop reads)."""
        return self._obs(ts.env, self.env._observations(ts.env), ts.extra)

    def rl_prescale(self, action):
        """Network output -> the wrapper's action space: the 0.5 pre-scale the
        reference applies at the RL boundary (ref openrl_ws/utils.py:59)."""
        return 0.5 * torch.tanh(action)


class EmptyWrapper(TaskWrapper):
    """go1plane: raw env passthrough (ref empty_wrapper.py)."""

    @property
    def obs_dim(self):
        return self.num_agents + 12

    def _obs(self, state, obs, extra):
        bi = self._base_info(obs)
        return torch.cat([self._ids(), bi, torch.flip(bi, dims=(1,))], dim=-1)


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


class Go1PushboxWrapper(TaskWrapper):
    """(ref go1_pushbox_wrapper.py)."""

    has_success = True

    @property
    def obs_dim(self):
        return 20 + self.num_agents

    def _success(self, state, obs, extra):
        # box pushed through the gate
        return self._box_pos(state)[:, 0] > extra["gate"][:, 0] + 0.25

    def _gate(self, obs):
        return self._gate_pos(
            obs, self.bt["init"]["block_length"] + self.bt["gate"]["block_length"] / 2)

    def _box_pos(self, state):
        return state.phys.npcs.pos[:, 0, :] - self.env.env_origins

    def _extra_init(self, state, obs):
        return {"gate": self._gate(obs), "last_box": self._box_pos(state)}

    def _obs(self, state, obs, extra):
        A = self.num_agents
        bi = self._base_info(obs)
        gate = extra["gate"][:, None, :].expand(-1, A, -1)
        box = self._box_pos(state)[:, None, :2].expand(-1, A, -1)
        bq = state.phys.npcs.quat[:, 0][:, None, :].expand(-1, A, -1)
        return torch.cat([self._ids(), bi, torch.flip(bi, dims=(1,)), gate, box, bq], dim=-1)

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        box = self._box_pos(state)
        dx = box[:, 0] - extra["last_box"][:, 0]
        dx = torch.where(info["reset_mask"], 0.0, dx)
        r = self.scales.get("box_x_movement_reward_scale", 10) * dx
        rew = r[:, None].expand(E, A)
        extra = {**extra, "last_box": box}
        return rew, extra, {"box movement reward": _perenv(r)}


class Go1SeesawWrapper(TaskWrapper):
    """(ref go1_seesaw_wrapper.py)."""

    has_success = True

    @property
    def obs_dim(self):
        return 12 + self.num_agents

    @property
    def _succ_thresholds(self):
        """(x, z) of the elevated far platform, relative to the configured
        pivot (the reference hard-codes 7.7/1.3 for a pivot at (8.0, z=1.0),
        ref go1_seesaw_wrapper.py:108)."""
        npc = self.env.cfg.init_state.init_states_npc[0].pos
        return npc[0] - 0.3, npc[2] + 0.3

    def _success(self, state, obs, extra):
        # an agent reached the elevated far platform (success-term condition)
        sx, sz = self._succ_thresholds
        x = obs.base_pos[..., 0]
        z = obs.base_pos[..., 2]
        return ((x > sx) & (z > sz)).any(dim=1)

    def _extra_init(self, state, obs):
        return {"last_x": obs.base_pos[..., 0]}

    def _obs(self, state, obs, extra):
        bi = self._base_info(obs)
        return torch.cat([self._ids(), bi, torch.flip(bi, dims=(1,))], dim=-1)

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        rew = torch.zeros((E, 1), device=self.device)
        terms = {}
        x = obs.base_pos[..., 0]
        z = obs.base_pos[..., 2]
        if s.get("x_movement_reward_scale", 0) != 0:
            dx = (x - extra["last_x"]).sum(dim=1)
            dx = torch.where(info["reset_mask"], 0.0, dx)
            r = s["x_movement_reward_scale"] * dx
            rew = rew + r[:, None]
            terms["x movement reward"] = _perenv(r)
        extra = {**extra, "last_x": x}
        if s.get("height_reward_scale", 0) != 0:
            r = s["height_reward_scale"] * (z.sum(dim=1) - 0.56)
            rew = rew + r[:, None]
            terms["height reward"] = _perenv(r)
        if s.get("y_punishment_scale", 0) != 0:
            r = s["y_punishment_scale"] * ((obs.base_pos[..., 1] ** 2).sum(dim=1) - 0.5)
            rew = rew + r[:, None]
            terms["y punishment"] = _perenv(r)
        if s.get("contact_punishment_scale", 0) != 0:
            r = s["contact_punishment_scale"] * state.collide.to(torch.float32)
            rew = rew + r[:, None]
            terms["contact punishment"] = _perenv(r)
        if s.get("agent_distance_punishment_scale", 0) != 0 and A > 1:
            other = torch.flip(obs.base_pos[..., :2], dims=(1,))
            d2 = ((obs.base_pos[..., :2] - other) ** 2).sum(-1)[:, :1]
            pun = torch.where(
                d2 < 0.25, s["agent_distance_punishment_scale"] / torch.clamp_min(d2, 1e-3), 0.0)
            rew = rew + pun
            terms["agent distance punishment"] = _perenv(pun)
        if s.get("success_reward_scale", 0) != 0:
            sx, sz = self._succ_thresholds
            succ = ((x > sx) & (z > sz)).sum(dim=1).to(torch.float32)
            r = s["success_reward_scale"] * succ
            rew = rew + r[:, None]
            terms["success reward"] = _perenv(r)
        if s.get("fall_punishment_scale", 0) != 0:
            fall = (state.r_term | state.p_term).to(torch.float32)
            r = s["fall_punishment_scale"] * fall
            rew = rew + r[:, None]
            terms["fall punishment"] = _perenv(r)
        return rew.expand(E, A), extra, terms
