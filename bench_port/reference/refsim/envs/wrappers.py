"""Task wrappers: observation assembly and reward shaping per task.

PyTorch counterpart of `mqe_tpu/envs/wrappers.py`, every wrapper of it (ref
mqe/envs/wrappers/*.py). Each task has a flat
observation (one-hot agent ids + own/teammate base info + task oracle state),
a Box(3) action of (vx, vy, yaw) commands scaled by [2.0, 0.5, 0.5]
(ref go1_pushbox_wrapper.py:16), and dense/sparse rewards. Carried wrapper
values live in `TaskState.extra`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from refsim.envs.go1_env import EnvState, Go1Env, ObsBuf
from refsim.ops import quat as quat_ops
from refsim.utils.random import Draws
from refsim.utils.tree import tree_map

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

    @property
    def controlled_agents(self) -> int:
        """The robots the wrapper takes actions for; a task whose env scripts
        some of its robots sets fewer."""
        return self.num_agents

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
        off = 0.0
        for b in blocks:  # summed in order, as JAX does (not math.fsum's rounding)
            off += self.bt[b]["block_length"]
        return off

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

    @torch.no_grad()
    def reward_term_names(self):
        """The names of the reward terms a step reports, from `_reward` on a
        reset state (no env step is taken)."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        ts, _ = self.reset(Draws(gen))
        actions = torch.zeros((self.num_envs, self.controlled_agents, self.action_dim),
                              device=self.device)
        info = {"reset_mask": torch.zeros((self.num_envs,), dtype=torch.bool, device=self.device)}
        _, _, terms = self._reward(ts.env, self.env._observations(ts.env), ts.extra, actions, info)
        return tuple(terms)

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
        """actions (E, A, 3) in [-1, 1], A the robots the wrapper controls.
        Returns (ts, obs, reward, done, info)."""
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


class Go1SheepWrapper(TaskWrapper):
    """(ref go1_sheep_wrapper.py)."""

    has_success = True

    @property
    def obs_dim(self):
        return 14 + 2 * self.num_npcs + self.num_agents

    def _success(self, state, obs, extra):
        # whole flock herded through the gate
        sheep_x = self._sheep_pos(state)[..., 0]
        return (sheep_x > extra["gate"][:, 0:1]).all(dim=1)

    def _gate(self, obs):
        return self._gate_pos(
            obs,
            self.bt["init"]["block_length"]
            + self.bt["plane"]["block_length"]
            + self.bt["gate"]["block_length"] / 2,
        )

    def _sheep_pos(self, state):
        return state.phys.npcs.pos - self.env.env_origins[:, None, :]

    def _extra_init(self, state, obs):
        sheep = self._sheep_pos(state)
        return {"gate": self._gate(obs), "last_avg": sheep[..., 0].mean(dim=1)}

    def _obs(self, state, obs, extra):
        A = self.num_agents
        bi = self._base_info(obs)
        gate = extra["gate"][:, None, :].expand(-1, A, -1)
        sheep = self._sheep_pos(state)[..., :2].reshape(self.num_envs, 1, -1).expand(-1, A, -1)
        return torch.cat([self._ids(), bi, torch.flip(bi, dims=(1,)), gate, sheep], dim=-1)

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        sheep = self._sheep_pos(state)
        gate_x = extra["gate"][:, 0]
        rew = torch.zeros((E, 1), device=self.device)
        terms = {}
        if s.get("success_reward_scale", 0) != 0:
            succ = (sheep[..., 0] > gate_x[:, None]).sum(dim=1).to(torch.float32)
            r = s["success_reward_scale"] * succ
            rew = rew + r[:, None]
            terms["success reward"] = _perenv(r)
        if s.get("contact_punishment_scale", 0) != 0:
            r = s["contact_punishment_scale"] * state.collide.to(torch.float32)
            rew = rew + r[:, None]
            terms["contact punishment"] = _perenv(r)
        if s.get("sheep_movement_reward_scale", 0) != 0:
            avg = sheep[..., 0].mean(dim=1)
            dx = torch.where(info["reset_mask"], 0.0, avg - extra["last_avg"])
            r = s["sheep_movement_reward_scale"] * dx
            rew = rew + r[:, None]
            terms["sheep movement reward"] = _perenv(r)
            extra = {**extra, "last_avg": avg}
        if s.get("mixed_sheep_reward_scale", 0) != 0:
            d = torch.linalg.norm(sheep[..., :2] - extra["gate"][:, None, :], dim=-1)
            m = torch.exp(-d / 2) * s["mixed_sheep_reward_scale"]
            m = torch.where(sheep[..., 0] >= gate_x[:, None],
                            float(s["mixed_sheep_reward_scale"]), m)
            r = m.sum(dim=1)
            rew = rew + r[:, None]
            terms["mixed sheep reward"] = _perenv(r)
        lin = s.get("sheep_pos_var_lin_punishment_scale", 0)
        exp_ = s.get("sheep_pos_var_exp_punishment_scale", 0)
        if lin != 0 or exp_ != 0:
            # the population variance, as jnp.var takes it
            var = state.phys.npcs.pos[..., :2].var(dim=1, unbiased=False).sum(-1)
            r = lin * (var - 1) + exp_ * torch.exp(var / 2 - 1)
            rew = rew + r[:, None]
            terms["sheep pos var punishment"] = _perenv(r)
        return rew.expand(E, A), extra, terms


class Go1FootballDefenderWrapper(TaskWrapper):
    """2 attackers vs the scripted defender (ref go1_football_wrapper.py:8-91).
    The wrapper controls the first two robots; the env scripts the third."""

    controlled_agents = 2
    has_success = True

    def __init__(self, env):
        super().__init__(env)
        self._gate_t = torch.tensor(self._gate(), dtype=torch.float32, device=self.device)

    @property
    def obs_dim(self):
        return 18 + 2

    def _success(self, state, obs, extra):
        # ball in the goal past the defender
        return self._ball(state)[:, 0] > self._gate()[0]

    def _gate(self):
        # goal line: the far end of the pitch plane
        return (self._block_x("plane", frac=1.0), 0.0)

    def _ball(self, state):
        return state.phys.npcs.pos[:, 0, :] - self.env.env_origins

    def _obs(self, state, obs, extra):
        bi = self._base_info(obs)[:, :2, :]
        ids = torch.eye(2, device=self.device).expand(self.num_envs, 2, 2)
        ball = self._ball(state)[:, None, :].expand(-1, 2, -1)
        bv = state.phys.npcs.lin_vel[:, 0][:, None, :].expand(-1, 2, -1)
        return torch.cat([ids, bi, torch.flip(bi, dims=(1,)), ball, bv], dim=-1)

    def _reward(self, state, obs, extra, actions, info):
        E = self.num_envs
        s = self.scales
        ball = self._ball(state)
        gate = self._gate_t
        rew = torch.zeros((E, 1), device=self.device)
        terms = {}
        if s.get("goal_reward_scale", 0) != 0:
            r = torch.where(ball[:, 0] > gate[0], float(s["goal_reward_scale"]), 0.0)
            rew = rew + r[:, None]
            terms["goal reward"] = _perenv(r)
        if s.get("ball_gate_distance_reward_scale", 0) != 0:
            d = torch.linalg.norm(ball[:, :2] - gate[None, :], dim=-1)
            r = s["ball_gate_distance_reward_scale"] * torch.exp(-d / 3)
            rew = rew + r[:, None]
            terms["ball gate distance reward"] = _perenv(r)
        return rew.expand(E, 2), extra, terms


class Go1FootballGameWrapper(TaskWrapper):
    """1v1 / 2v2 football: two teams, a goal at each end, a zero-sum goal
    reward (the reference's wrapper is scaffolding, ref
    go1_football_wrapper.py:93-157; the JAX package's completion)."""

    has_success = True

    def __init__(self, env):
        super().__init__(env)
        half = self.num_agents // 2
        self._team = torch.tensor([0] * half + [1] * (self.num_agents - half), device=self.device)

    @property
    def obs_dim(self):
        return 18 + self.num_agents

    def _success(self, state, obs, extra):
        # team 0 scored (ball past the right goal line = second gate block)
        return self._ball(state)[:, 0] > self._block_x("gate", occurrence=1)

    def _ball(self, state):
        return state.phys.npcs.pos[:, 0, :] - self.env.env_origins

    def _obs(self, state, obs, extra):
        A = self.num_agents
        bi = self._base_info(obs)
        ball = self._ball(state)[:, None, :].expand(-1, A, -1)
        bv = state.phys.npcs.lin_vel[:, 0][:, None, :].expand(-1, A, -1)
        return torch.cat([self._ids(), bi, torch.flip(bi, dims=(1,)), ball, bv], dim=-1)

    def _reward(self, state, obs, extra, actions, info):
        ball = self._ball(state)
        goal_r = (ball[:, 0] > self._block_x("gate", occurrence=1)).to(torch.float32)
        goal_l = (ball[:, 0] < self._block_x("gate", occurrence=0)).to(torch.float32)
        scale = self.scales.get("goal_reward_scale", 10)
        r_team0 = scale * (goal_r - goal_l)
        rew = torch.where(self._team[None, :] == 0, r_team0[:, None], -r_team0[:, None])
        return rew, extra, {"goal reward": scale * (goal_r + goal_l)}


def _seat1_sign(width, cols, device):
    """(2, width): 1, and -1 in seat 1's columns `cols`."""
    sign = np.ones((2, width), dtype=np.float32)
    sign[1, list(cols)] = -1.0
    return torch.as_tensor(sign, device=device)


class _MirroredWrapper(TaskWrapper):
    """A symmetric competitive task: agent 1's (vy, yaw) command is mirrored
    (ref go1_wrestling_wrapper.py:47 etc.), and the columns `mirror_cols` of
    its observation are negated. The signs are made once."""

    has_success = True
    mirror_cols = ()

    def __init__(self, env):
        super().__init__(env)
        self._act_sign = _seat1_sign(3, (1, 2), self.device)
        self._obs_sign = _seat1_sign(self.obs_dim, self.mirror_cols, self.device)

    def _transform_actions(self, actions):
        return actions * self._act_sign


class Go1TugWrapper(_MirroredWrapper):
    """(ref go1_tug_wrapper.py)."""

    # agent 1's lateral quantities (ref go1_tug_wrapper.py:53-56)
    mirror_cols = (1, 4, 6, 9)

    def __init__(self, env):
        super().__init__(env)
        # per seat, the sign that puts the disc on one's own side
        self._sgn = torch.tensor([-1.0, 1.0], device=self.device)

    @property
    def obs_dim(self):
        return 10

    def _success(self, state, obs, extra):
        # agent 0 pulled the disc to its side (q < 0)
        return state.phys.npcs.q[:, 0, 0] < 0

    def _npc_dof(self, state):
        return state.phys.npcs.q[:, 0, 0], state.phys.npcs.qd[:, 0, 0]

    def _handle(self, q):
        """(E, 2): the disc's handle, (1.6, q) in the env frame."""
        return torch.stack([torch.full_like(q, 1.6), q], dim=-1)

    def _extra_init(self, state, obs):
        q, _ = self._npc_dof(state)
        return {"last_dis": self._base_info(obs)[..., :2], "last_npc": q}

    def _obs(self, state, obs, extra):
        A = self.num_agents
        bi = self._base_info(obs)
        q, qd = self._npc_dof(state)
        dis = torch.linalg.norm(obs.base_pos[..., :2] - self._handle(q)[:, None, :],
                                dim=-1, keepdim=True)
        npc = torch.stack([q, qd], dim=-1)[:, None, :].expand(-1, A, -1)
        lastq = extra["last_npc"][:, None, None].expand(-1, A, -1)
        return torch.cat([bi, npc, dis, lastq], dim=-1) * self._obs_sign

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        q, _ = self._npc_dof(state)
        r0 = torch.zeros(E, device=self.device)          # agent 0's channel
        terms = {}
        lastq = extra["last_npc"]
        if s.get("success_reward_scale", 0) != 0:
            r = torch.where(q < 0, s["success_reward_scale"] * (-q), 0.0)
            r = torch.where(lastq <= q, r / 2, r)
            r0 = r0 + r
            terms["success reward"] = _perenv(r)
        if s.get("punishment_reward_scale", 0) != 0:
            pn = torch.where(q > 0, s["punishment_reward_scale"] * q, 0.0)
            pn = torch.where(lastq > q, pn / 2, pn)
            r0 = r0 - pn
            terms["punishment"] = _perenv(pn)
        handle = self._handle(q)
        d_now = torch.linalg.norm(obs.base_pos[:, 0, :2] - handle, dim=-1)
        d_last = torch.linalg.norm(extra["last_dis"][:, 0, :] - handle, dim=-1)
        if s.get("pos_reward_scale", 0) != 0:
            r = torch.where(d_now < d_last, (d_last - d_now) * s["pos_reward_scale"], 0.0)
            r0 = r0 + r
            terms["pos reward"] = _perenv(r)
        if s.get("pos_punishment_scale", 0) != 0:
            pn = torch.where(d_now >= d_last, 2.0 ** d_now * s["pos_punishment_scale"], 0.0)
            r0 = r0 - pn
            terms["pos punishment"] = _perenv(pn)
        rew = torch.cat([r0[:, None], torch.zeros((E, A - 1), device=self.device)], dim=1)
        return rew, {"last_dis": obs.base_pos[..., :2], "last_npc": q}, terms

    def _selfplay_reward(self, pre_state, pre_obs, reward, extra):
        """Per-seat mirror of the reference's agent-0 reward laws (ref
        go1_tug_wrapper.py:89-113): seat 0 wins as the disc DOF goes
        negative, seat 1 as it goes positive, each with the same
        improvement halving and handle-distance shaping on its own base.
        Pre-reset state."""
        s = self.scales
        q = pre_state.phys.npcs.q[:, 0, 0]
        lastq = extra["last_npc"]
        # per-seat "favor": how far the disc sits on my side
        favor = q[:, None] * self._sgn
        improving = lastq[:, None] * self._sgn < favor
        S = s.get("success_reward_scale", 0.0)
        P = s.get("punishment_reward_scale", 0.0)
        win = torch.where(favor > 0, S * favor, 0.0)
        win = torch.where(improving, win, win / 2)
        lose = torch.where(favor < 0, P * (-favor), 0.0)
        lose = torch.where(improving, lose / 2, lose)
        handle = self._handle(q)[:, None, :]
        d_now = torch.linalg.norm(pre_obs.base_pos[..., :2] - handle, dim=-1)
        d_last = torch.linalg.norm(extra["last_dis"] - handle, dim=-1)
        pos_r = torch.where(d_now < d_last, (d_last - d_now) * s.get("pos_reward_scale", 0.0), 0.0)
        pos_p = torch.where(d_now >= d_last, 2.0 ** d_now * s.get("pos_punishment_scale", 0.0), 0.0)
        return win - lose + pos_r - pos_p


def _fallen(r_, p_):
    """(…) bool: toppled past the reference's reward thresholds."""
    return (torch.abs(p_) > np.pi * 0.9) | (torch.abs(r_) >= np.pi * 0.4)


class Go1WrestlingWrapper(_MirroredWrapper):
    """(ref go1_wrestling_wrapper.py)."""

    mirror_cols = (1, 4, 7, 10)

    @property
    def obs_dim(self):
        return 12

    def _success(self, state, obs, extra):
        # agent 0 toppled its opponent (success-term condition for agent 1)
        return _fallen(quat_ops.wrap_to_pi(obs.base_rpy[:, 1, 0]),
                       quat_ops.wrap_to_pi(obs.base_rpy[:, 1, 1]))

    def _obs(self, state, obs, extra):
        bi = self._base_info(obs)
        return torch.cat([bi, torch.flip(bi, dims=(1,))], dim=-1) * self._obs_sign

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        fallen = _fallen(quat_ops.wrap_to_pi(obs.base_rpy[..., 0]),
                         quat_ops.wrap_to_pi(obs.base_rpy[..., 1]))
        r0 = torch.zeros(E, device=self.device)
        terms = {}
        if s.get("success_reward_scale", 0) != 0:
            r = torch.where(fallen[:, 1], float(s["success_reward_scale"]), 0.0)
            r0 = r0 + r
            terms["success reward"] = _perenv(r)
        if s.get("punishment_scale", 0) != 0:
            pn = torch.where(fallen[:, 0], float(s["punishment_scale"]), 0.0)
            r0 = r0 - pn
            terms["punishment"] = _perenv(pn)
        # the reward flows to agent 0's channel only (ref
        # go1_wrestling_wrapper.py:62-81); agent 1 is an unrewarded mirrored
        # seat unless `selfplay` is on
        rew = torch.cat([r0[:, None], torch.zeros((E, A - 1), device=self.device)], dim=1)
        return rew, extra, terms

    def _selfplay_reward(self, pre_state, pre_obs, reward, extra):
        """Per-seat zero-sum fall reward on the pre-reset state: fall = past
        the env's own termination thresholds (roll, pitch, z_low); +S when
        the opponent falls, -P for falling oneself (P may be overridden by
        `selfplay_punishment`)."""
        s = self.scales
        t = self.cfg.termination
        r_ = quat_ops.wrap_to_pi(pre_obs.base_rpy[..., 0])
        p_ = quat_ops.wrap_to_pi(pre_obs.base_rpy[..., 1])
        z = pre_obs.base_pos[..., 2]
        fallen = ((torch.abs(r_) > t.roll_kwargs["threshold"])
                  | (torch.abs(p_) > t.pitch_kwargs["threshold"])
                  | (z < t.z_low_kwargs["threshold"]))
        S = s.get("success_reward_scale", 0.0)
        P = s.get("punishment_scale", 0.0)
        if self.selfplay_punishment is not None:
            P = self.selfplay_punishment
        opp = torch.flip(fallen, dims=(1,))
        return S * opp.to(torch.float32) - P * fallen.to(torch.float32)


class Go1RotationWrapper(_MirroredWrapper):
    """(ref go1_rotation_wrapper.py)."""

    mirror_cols = (1, 4, 7, 10)

    def __init__(self, env):
        super().__init__(env)
        self._target_t = torch.tensor([self._target_x(), 0.0], dtype=torch.float32,
                                      device=self.device)

    @property
    def obs_dim(self):
        return 12

    def _success(self, state, obs, extra):
        # agent 0 through the revolving door past the target x
        return obs.base_pos[:, 0, 0] > self._target_x()

    def _target_x(self):
        return self.bt["rotation"]["block_length"] * 0.75 + self.bt["wall"]["block_length"]

    def _target_dist(self, obs):
        return torch.linalg.norm(obs.base_pos[..., :2] - self._target_t, dim=-1)

    def _extra_init(self, state, obs):
        return {"last_dis": self._target_dist(obs)}

    def _obs(self, state, obs, extra):
        bi = self._base_info(obs)
        return torch.cat([bi, torch.flip(bi, dims=(1,))], dim=-1) * self._obs_sign

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        tx = self._target_x()
        x = obs.base_pos[..., 0]
        r0 = torch.zeros(E, device=self.device)
        terms = {}
        if s.get("success_reward_scale", 0) != 0:
            r = torch.where(x[:, 0] > tx, float(s["success_reward_scale"]), 0.0)
            r0 = r0 + r
            terms["success reward"] = _perenv(r)
        if s.get("punishment_scale", 0) != 0:
            pn = torch.where(x[:, 1] > tx, float(s["punishment_scale"]), 0.0)
            r0 = r0 - pn
            terms["punishment"] = _perenv(pn)
        d = self._target_dist(obs)
        if s.get("distance_reward_scale", 0) != 0:
            r = torch.where(d[:, 0] < extra["last_dis"][:, 0],
                            float(s["distance_reward_scale"]), 0.0)
            r0 = r0 + r
            terms["distance reward"] = _perenv(r)
        rew = torch.cat([r0[:, None], torch.zeros((E, A - 1), device=self.device)], dim=1)
        return rew, {"last_dis": d}, terms

    def _selfplay_reward(self, pre_state, pre_obs, reward, extra):
        """Per-seat mirror of the agent-0 laws (ref go1_rotation_wrapper.py):
        +S for passing the door oneself, -P when the opponent passes, +D for
        closing one's own distance to the target. Pre-reset state."""
        s = self.scales
        x = pre_obs.base_pos[..., 0]
        passed = (x > self._target_x()).to(torch.float32)
        closer = (self._target_dist(pre_obs) < extra["last_dis"]).to(torch.float32)
        S = s.get("success_reward_scale", 0.0)
        P = s.get("punishment_scale", 0.0)
        D = s.get("distance_reward_scale", 0.0)
        return S * passed - P * torch.flip(passed, dims=(1,)) + D * closer


class Go1BridgeWrapper(_MirroredWrapper):
    """(ref go1_bridge_wrapper.py)."""

    @property
    def obs_dim(self):
        return 12

    def _success(self, state, obs, extra):
        # opponent knocked off the bridge (success-term condition)
        return obs.base_pos[:, 1, 2] < 0.5

    def _extra_init(self, state, obs):
        return {"target": torch.flip(obs.base_pos, dims=(1,))}

    def _obs(self, state, obs, extra):
        bi = self._base_info(obs)
        o = torch.cat([bi, torch.flip(bi, dims=(1,))], dim=-1)
        span = torch.abs(extra["target"][:, 0, 0] + extra["target"][:, 1, 0])
        o1 = o[:, 1].clone()
        # agent 1 sees the track from its own end: x from the far end, y mirrored
        o1[:, 0] = span - o1[:, 0]
        o1[:, 4] = -o1[:, 4]
        o1[:, 6] = span - o1[:, 6]
        o1[:, 10] = -o1[:, 10]
        return torch.stack([o[:, 0], o1], dim=1)

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        z = obs.base_pos[..., 2]
        x = obs.base_pos[..., 0]
        r0 = torch.zeros(E, device=self.device)
        terms = {}
        if s.get("success_reward_scale", 0) != 0:
            r = torch.where(z[:, 1] < 0.5, float(s["success_reward_scale"]), 0.0)
            r0 = r0 + r
            terms["success reward"] = _perenv(r)
        if s.get("punishment_scale", 0) != 0:
            pn = torch.where(z[:, 0] < 0.5, float(s["punishment_scale"]), 0.0)
            r0 = r0 - pn
            terms["punishment"] = _perenv(pn)
        if s.get("target_reward_scale", 0) != 0:
            r = torch.where(x[:, 0] > extra["target"][:, 0, 0],
                            float(s["target_reward_scale"]), 0.0)
            r0 = r0 + r
            terms["target reward"] = _perenv(r)
        rew = torch.cat([r0[:, None], torch.zeros((E, A - 1), device=self.device)], dim=1)
        return rew, extra, terms

    def _selfplay_reward(self, pre_state, pre_obs, reward, extra):
        """Per-seat mirror of the agent-0 laws (ref go1_bridge_wrapper.py):
        +S when the opponent drops below the deck (z < 0.5), -P for falling
        oneself, +T for reaching the opponent's start (agent 0 crosses in +x,
        agent 1 in -x). Pre-reset state."""
        s = self.scales
        z = pre_obs.base_pos[..., 2]
        x = pre_obs.base_pos[..., 0]
        fell = (z < 0.5).to(torch.float32)
        crossed = torch.stack([x[:, 0] > extra["target"][:, 0, 0],
                               x[:, 1] < extra["target"][:, 1, 0]], dim=1).to(torch.float32)
        S = s.get("success_reward_scale", 0.0)
        P = s.get("punishment_scale", 0.0)
        T = s.get("target_reward_scale", 0.0)
        return S * torch.flip(fell, dims=(1,)) - P * fell + T * crossed


class Go1DoorWrapper(TaskWrapper):
    """Push-open door (present but unregistered in the reference; simple
    pass-the-door shaping, as the JAX package has it)."""

    has_success = True

    @property
    def obs_dim(self):
        return 12 + self.num_agents + 2

    def _door_x(self):
        return self.bt["init"]["block_length"] + self.bt["gate"]["block_length"] / 2

    def _success(self, state, obs, extra):
        # all agents pushed through the doorway
        return (obs.base_pos[..., 0] > self._door_x()).all(dim=1)

    def _extra_init(self, state, obs):
        return {"last_x": obs.base_pos[..., 0], "door_q": state.phys.npcs.q[:, 0, 0]}

    def _obs(self, state, obs, extra):
        A = self.num_agents
        bi = self._base_info(obs)
        d = torch.stack([state.phys.npcs.q[:, 0, 0], state.phys.npcs.qd[:, 0, 0]], -1)
        return torch.cat([self._ids(), bi, torch.flip(bi, dims=(1,)),
                          d[:, None, :].expand(-1, A, -1)], dim=-1)

    def _reward(self, state, obs, extra, actions, info):
        E, A = self.num_envs, self.num_agents
        s = self.scales
        x = obs.base_pos[..., 0]
        rew = torch.zeros((E, A), device=self.device)
        terms = {}
        if s.get("target_reward_scale", 0) != 0:
            dx = (x - extra["last_x"]).sum(dim=1)
            dx = torch.where(info["reset_mask"], 0.0, dx)
            r = s["target_reward_scale"] * dx
            rew = rew + r[:, None]
            terms["target reward"] = _perenv(r)
        if s.get("success_reward_scale", 0) != 0:
            r = s["success_reward_scale"] * (x > self._door_x()).to(torch.float32)
            rew = rew + r
            terms["success reward"] = _perenv(r)
        return rew, {**extra, "last_x": x, "door_q": state.phys.npcs.q[:, 0, 0]}, terms
