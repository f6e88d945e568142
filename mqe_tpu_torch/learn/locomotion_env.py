"""Joint-level locomotion training env: velocity-tracking PPO task, PyTorch.

Counterpart of `mqe_tpu/learn/locomotion_env.py`. The reference consumes a
frozen walk-these-ways policy whose body blob is missing from its snapshot
(.MISSING_LARGE_BLOBS:2-3); this env trains an equivalent: one go1 on a
plane, random (vx, vy, yaw) commands, 12-dim position-offset actions through
the SAME actuator-net torque path the deployed policy uses (ref
go1.py:315-354), and the reference's velocity-tracking reward set (ref
legged_robot.py:1081-1173 with LeggedRobotCfg scales, x dt as in
_prepare_reward_function:659-664).

It offers what `learn/ppo.py::PPOTrainer` reads of an env: `reset(draws)`,
`step(ts, actions, draws)`, `observe`, `rl_prescale`, `reward_term_names`,
`device`, `num_envs`, `controlled_agents`, `obs_dim`, `action_dim`,
`has_success`. The physics is `Go1Env._torques` + `Go1Env._physics`: one
launch of the substep kernel and one of the sphere FK per substep, over
B = num_envs robots.

Every draw is named (`utils/random.py::Draws`): the fresh reset state
("fresh", taken by the envs that finish), the commands ("cmd_vx" in [-1, 1)
before the curriculum's scale, "cmd_vy" in [-0.6, 0.6), "cmd_wz" in
[-1, 1)), the fast command switch ("cmd_switch", U[0, 1) per env, with
`resample_prob` > 0) and the per-episode gait ("gait_switch", U[0, 1), and
"gait_other", the non-trot gait's index in [1, 4), with `multi_gait` > 0).
Reset draws the same names.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from mqe_tpu_torch.control.locomotion import step_gait_clocks
from mqe_tpu_torch.envs.config import Go1Cfg
from mqe_tpu_torch.envs.go1_env import EnvState, Go1Env
from mqe_tpu_torch.ops import quat as quat_ops
from mqe_tpu_torch.utils.random import Draws
from mqe_tpu_torch.utils.tree import tree_map


class LocomotionTrainCfg(Go1Cfg):
    class env(Go1Cfg.env):
        env_name = "locomotion"
        num_envs = 1024
        num_agents = 1
        episode_length_s = 10.0

    class terrain(Go1Cfg.terrain):
        mesh_type = "plane"

    class domain_rand(Go1Cfg.domain_rand):
        randomize_friction = True
        friction_range = [0.4, 1.5]
        init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])
        init_base_vel_range = [-0.2, 0.2]
        init_dof_pos_ratio_range = [0.8, 1.2]
        # action-lag DR on during locomotion training (ref go1.py:337-339,
        # go1_config.py:232-233): robustness to actuation latency
        randomize_lag_timesteps = True
        lag_timesteps = 6

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch", "z_low"]
        roll_kwargs = dict(threshold=0.8)
        pitch_kwargs = dict(threshold=1.0)
        z_low_kwargs = dict(threshold=0.12)

    class control(Go1Cfg.control):
        # "residual": RL learns a correction on top of the model-based trot;
        # "policy": RL learns joint offsets from scratch against the bare
        # actuator-net path
        locomotion_backend = "residual"
        policy_pd_augment = True


def locomotion_cfg(backend: str):
    """LocomotionTrainCfg with `backend` as its locomotion backend."""
    class Cfg(LocomotionTrainCfg):
        class control(LocomotionTrainCfg.control):
            locomotion_backend = backend

    return Cfg


# Full reference reward menu (LeggedRobotCfg.rewards.scales,
# ref legged_robot_config.py:159-174 + the _reward_* engine
# legged_robot.py:1081-1173; scales are multiplied by dt at build like
# _prepare_reward_function:659-664). Zero-scale terms are dropped.
REWARD_SCALES = dict(
    termination=-0.0,
    tracking_lin_vel=1.0,
    tracking_ang_vel=0.5,
    lin_vel_z=-2.0,
    ang_vel_xy=-0.05,
    orientation=-0.0,
    torques=-0.00001,
    dof_vel=-0.0,
    dof_acc=-2.5e-7,
    base_height=-0.0,
    feet_air_time=1.0,
    collision=-1.0,
    feet_stumble=-0.0,
    action_rate=-0.01,
    stand_still=-0.0,
    dof_pos_limits=-0.0,
    dof_vel_limits=-0.0,
    torque_limits=-0.0,
    feet_contact_forces=-0.0,
)
# Locomotion-training overrides: terms the reference leaves at 0 but which
# stabilize the trained walk policy
TRAIN_SCALES = dict(
    REWARD_SCALES,
    orientation=-0.2,
    dof_pos_limits=-2.0,
    feet_stumble=-0.5,
    feet_contact_forces=-0.001,
)
# the terms the reward engine computes, in the order it adds them
REWARD_TERMS = ("tracking_lin_vel", "tracking_ang_vel", "lin_vel_z", "ang_vel_xy", "orientation",
                "base_height", "torques", "dof_vel", "dof_acc", "action_rate", "collision",
                "termination", "dof_pos_limits", "dof_vel_limits", "torque_limits",
                "feet_stumble", "stand_still", "feet_contact_forces", "feet_air_time")
TRACKING_SIGMA = 0.25
# the reference rewards (air_time - 0.5 s) on touchdown; the gait here is
# clocked at 4 Hz (swing 0.125 s), so the threshold sits just above the
# nominal swing
AIR_TIME_TARGET = 0.11
SOFT_DOF_POS_LIMIT = 0.95   # ref rewards.soft_dof_pos_limit semantics (:178)
SOFT_DOF_VEL_LIMIT = 1.0
SOFT_TORQUE_LIMIT = 1.0
BASE_HEIGHT_TARGET = 0.30
MAX_CONTACT_FORCE = 100.0   # ref rewards.max_contact_force (:182)


@dataclass
class LocoTaskState:
    env: EnvState
    commands: torch.Tensor       # (E, 3)
    last_action: torch.Tensor    # (E, 12)
    last_qd: torch.Tensor        # (E, 12)
    feet_air: torch.Tensor       # (E, 4)
    last_contact: torch.Tensor   # (E, 4) bool
    cmd_scale: torch.Tensor      # () command-range curriculum multiplier
    track_acc: torch.Tensor      # (E,) episode tracking-reward accumulator
    gait_pob: torch.Tensor       # (E, 3) per-env [phases, offsets, bounds]
    extra: dict                  # {"obs": (E, 70)}


class LocomotionEnv:
    """Joint-level training env (one robot an env) for PPOTrainer."""

    action_dim = 12
    obs_dim = 70
    num_agents = 1
    controlled_agents = 1
    has_success = False

    GAIT_ORDER = ("trotting", "pacing", "bounding", "pronking")
    MAX_CURRICULUM = 2.0  # ref commands.max_curriculum semantics

    def __init__(self, num_envs: int = 1024, seed: int = 0, cfg=LocomotionTrainCfg,
                 scales: dict | None = None, resample_prob: float = 0.0,
                 multi_gait: float = 0.0, device=None):
        # resample_prob: per-env per-step probability of redrawing the
        # command on top of the 5 s periodic resample (robustness to the task
        # layer's 50 Hz command changes). multi_gait: per-episode probability
        # of a non-trot library gait (pacing/bounding/pronking, uniform);
        # 0 = trot only.
        self.resample_prob = float(resample_prob)
        self.multi_gait = float(multi_gait)
        self.env = Go1Env(cfg, num_envs=num_envs, seed=seed, device=device)
        # train from scratch even if a body policy was loaded from the assets
        self.env.body_policy = None
        self.device = self.env.device
        dev = self.device
        self.gait_table = torch.as_tensor(
            np.asarray([cfg.command.gaits[g] for g in self.GAIT_ORDER], dtype=np.float32),
            device=dev)  # (4, 3): [phases, offsets, bounds] rows
        self.residual = cfg.control.locomotion_backend == "residual"
        self.prescale = 1.0 if self.residual else 4.0
        self.cfg = cfg
        self.num_envs = num_envs
        self.dt = self.env.dt
        raw = dict(TRAIN_SCALES if scales is None else scales)
        # zero-scale terms are dropped (ref _prepare_reward_function
        # legged_robot.py:665-668); all scales x dt (:659-664)
        self.scales = {k: v * self.dt for k, v in raw.items() if v != 0.0}
        # soft dof-position limits (ref legged_robot.py:316-321)
        m = self.env.robot
        mid = (m.q_lower + m.q_upper) / 2.0
        rng = m.q_upper - m.q_lower
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)  # noqa: E731
        self.q_soft_lower = f32(mid - 0.5 * rng * SOFT_DOF_POS_LIMIT)
        self.q_soft_upper = f32(mid + 0.5 * rng * SOFT_DOF_POS_LIMIT)
        self.qd_limit = f32(m.qd_limit)
        self.pen_mask = torch.as_tensor(self.env.pen_sph, device=dev)

    def draws(self, given: dict | None = None) -> Draws:
        """Draws from the env's generator, with optional precomputed values."""
        return self.env.draws(given)

    def reward_term_names(self):
        """The names of the reward terms a step reports (its scales' nonzero
        terms), found without a step."""
        return tuple(sorted(k for k in REWARD_TERMS if k in self.scales))

    # -- command sampling (ref _resample_commands legged_robot.py:352-366) --
    def _sample_commands(self, draws: Draws, cmd_scale=1.0):
        E, dev = self.num_envs, self.device
        vx = draws.uniform("cmd_vx", (E,), -1.0, 1.0, dev) * cmd_scale
        vy = draws.uniform("cmd_vy", (E,), -0.6, 0.6, dev)
        wz = draws.uniform("cmd_wz", (E,), -1.0, 1.0, dev)
        cmd = torch.stack([vx, vy, wz], dim=-1)
        # zero small commands (ref legged_robot.py:366)
        small = torch.linalg.norm(cmd[:, :2], dim=-1) < 0.2
        keep = torch.where(small, 0.0, 1.0)[:, None]
        return torch.cat([cmd[:, :2] * keep, cmd[:, 2:]], dim=-1)

    def _sample_gaits(self, draws: Draws):
        """(E, 3) per-env [phases, offsets, bounds]: trot with prob
        1 - multi_gait, else uniform over the other library gaits."""
        E, dev = self.num_envs, self.device
        other = draws.integers("gait_other", (E,), 1, len(self.GAIT_ORDER), dev)
        u = draws.uniform("gait_switch", (E,), 0.0, 1.0, dev)
        idx = torch.where(u < self.multi_gait, other, 0)
        return self.gait_table[idx]

    def _gait_override(self, gait_pob):
        if self.multi_gait <= 0.0:
            return None
        return {"phases": gait_pob[:, 0:1], "offsets": gait_pob[:, 1:2],
                "bounds": gait_pob[:, 2:3]}

    def _locomotion_obs(self, es, commands, clock, gait_pob=None):
        """The 70-dim walk-these-ways obs of the one robot, (E, 70)."""
        pob = None
        if self.multi_gait > 0.0 and gait_pob is not None:
            pob = (gait_pob[:, 0:1], gait_pob[:, 1:2], gait_pob[:, 2:3])
        o, _ = self.env._fill_locomotion_obs(es, commands[:, None, :], clock, gait_pob=pob)
        return o[:, 0]

    def observe(self, ts: LocoTaskState):
        return ts.extra["obs"][:, None, :]

    def rl_prescale(self, action):
        # from-scratch policy: offsets up to +-4 (x action_scale 0.25 ->
        # +-1 rad); residual mode: a +-1 correction on the trot action
        return self.prescale * torch.tanh(action)

    @torch.no_grad()
    def reset(self, draws: Draws | None = None):
        draws = draws or self.draws()
        E, dev = self.num_envs, self.device
        es = draws.state("fresh", lambda: self.env._reset_all(draws))
        commands = self._sample_commands(draws)
        if self.multi_gait > 0.0:
            gait_pob = self._sample_gaits(draws)
        else:
            gait_pob = self.gait_table[0].expand(E, 3)
        obs = self._locomotion_obs(es, commands, es.clock_inputs, gait_pob)
        z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        ts = LocoTaskState(
            env=es, commands=commands, last_action=z(E, 12), last_qd=z(E, 12),
            feet_air=z(E, 4), last_contact=torch.zeros((E, 4), dtype=torch.bool, device=dev),
            cmd_scale=torch.ones((), device=dev), track_acc=z(E), gait_pob=gait_pob,
            extra={"obs": obs},
        )
        return ts, obs[:, None, :]

    @torch.no_grad()
    def step(self, ts: LocoTaskState, actions, draws: Draws | None = None):
        """actions: (E, 1, 12) position-offset actions (after rl_prescale)."""
        draws = draws or self.draws()
        env = self.env
        E, dev = self.num_envs, self.device
        action = actions.reshape(E, 12)
        resid = action  # the RL-controlled part (== action in policy mode)

        es = ts.env
        gait_ov = self._gait_override(ts.gait_pob)
        if self.residual:
            # model-based trot base + learned residual correction (the
            # composition Go1Env._locomotion_action applies at deployment)
            trot_action, gait_idx, clock, _, _, vel_int = env._locomotion_action(
                es, ts.commands[:, None, :], gait_override=gait_ov)
            es = replace(es, vel_int=vel_int)
            action = trot_action[:, 0] + action
        else:
            # the gait clocks advance (clock obs)
            gp = env.gait_params_static
            full = lambda v: torch.full((E, 1), float(v), device=dev)  # noqa: E731
            if gait_ov is not None:
                ph, off, bnd = gait_ov["phases"], gait_ov["offsets"], gait_ov["bounds"]
            else:
                ph, off, bnd = full(gp["phases"]), full(gp["offsets"]), full(gp["bounds"])
            gait_idx, _, clock, _, _ = step_gait_clocks(
                es.gait_indices, self.dt, full(gp["freq"]), ph, off, bnd, full(gp["duration"]))
        es = replace(es, gait_indices=gait_idx, clock_inputs=clock,
                     last2_loco_action=es.last_loco_action,
                     last_loco_action=action[:, None, :])

        # actuator-net torque path + physics, past the command stage
        tau_sum = torch.zeros((E, 12), device=dev)
        for _ in range(env.decimation):
            tau, err_hist, lag, _ = env._torques(es, action[:, None, :])
            phys, contacts = env._physics(es, tau)
            es = replace(es, phys=phys, err_hist=err_hist, lag_buffer=lag)
            tau_sum = tau_sum + tau[:, 0] ** 2
        tau_last = tau[:, 0]
        es = replace(es, episode_length=es.episode_length + 1)

        # termination first, so that the `termination` term can see it
        # (ref compute_reward runs after check_termination, legged_robot.py:143-146)
        done, _, _, _, timeout = env._termination(es, contacts)

        # ---- rewards (the reference engine, legged_robot.py:1081-1173) ----
        ag = es.phys.agents
        quat = ag.quat[:, 0]
        v_body = quat_ops.quat_rotate_inverse(quat, ag.lin_vel[:, 0])
        w_body = quat_ops.quat_rotate_inverse(quat, ag.ang_vel[:, 0])
        down = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(quat.shape[:-1] + (3,))
        g_body = quat_ops.quat_rotate_inverse(quat, down)
        q, qd = ag.q[:, 0], ag.qd[:, 0]
        cmd = ts.commands
        s = self.scales
        terms = {}

        lin_err = ((cmd[:, :2] - v_body[:, :2]) ** 2).sum(-1)
        feet_f = contacts.feet_force[:, 0]           # (E, 4, 3)
        feet_fz = feet_f[:, :, 2]
        contact = feet_fz > 1.0
        contact_filt = contact | ts.last_contact
        first_contact = (ts.feet_air > 0) & contact_filt
        feet_air = ts.feet_air + self.dt
        cmd_norm = torch.linalg.norm(cmd[:, :2], dim=-1)

        if "tracking_lin_vel" in s:
            terms["tracking_lin_vel"] = torch.exp(-lin_err / TRACKING_SIGMA)
        if "tracking_ang_vel" in s:
            terms["tracking_ang_vel"] = torch.exp(
                -((cmd[:, 2] - w_body[:, 2]) ** 2) / TRACKING_SIGMA)
        if "lin_vel_z" in s:
            terms["lin_vel_z"] = v_body[:, 2] ** 2
        if "ang_vel_xy" in s:
            terms["ang_vel_xy"] = (w_body[:, :2] ** 2).sum(-1)
        if "orientation" in s:
            terms["orientation"] = (g_body[:, :2] ** 2).sum(-1)
        if "base_height" in s:
            # plane terrain: the measured ground height is 0
            terms["base_height"] = (ag.pos[:, 0, 2] - BASE_HEIGHT_TARGET) ** 2
        if "torques" in s:
            terms["torques"] = tau_sum.sum(-1) / env.decimation
        if "dof_vel" in s:
            terms["dof_vel"] = (qd ** 2).sum(-1)
        if "dof_acc" in s:
            terms["dof_acc"] = (((ts.last_qd - qd) / self.dt) ** 2).sum(-1)
        if "action_rate" in s:
            # on the prescale-normalised RL output (the residual in residual
            # mode: the trot base sweeps by design and is not penalised)
            terms["action_rate"] = (((ts.last_action - resid) / self.prescale) ** 2).sum(-1)
        if "collision" in s:
            cf = torch.linalg.norm(contacts.sphere_force[:, 0], dim=-1)
            terms["collision"] = ((cf * self.pen_mask) > 0.1).sum(-1).to(torch.float32)
        if "termination" in s:
            terms["termination"] = (done & ~timeout).to(torch.float32)
        if "dof_pos_limits" in s:
            out = (-torch.clamp_max(q - self.q_soft_lower, 0.0)
                   + torch.clamp_min(q - self.q_soft_upper, 0.0))
            terms["dof_pos_limits"] = out.sum(-1)
        if "dof_vel_limits" in s:
            terms["dof_vel_limits"] = torch.clamp(
                torch.abs(qd) - self.qd_limit * SOFT_DOF_VEL_LIMIT, 0.0, 1.0).sum(-1)
        if "torque_limits" in s:
            terms["torque_limits"] = torch.clamp_min(
                torch.abs(tau_last) - env.torque_limits * SOFT_TORQUE_LIMIT, 0.0).sum(-1)
        if "feet_stumble" in s:
            terms["feet_stumble"] = (
                torch.linalg.norm(feet_f[:, :, :2], dim=-1) > 5.0 * torch.abs(feet_fz)
            ).any(-1).to(torch.float32)
        if "stand_still" in s:
            terms["stand_still"] = (torch.abs(q - env.default_q).sum(-1) * (cmd_norm < 0.1))
        if "feet_contact_forces" in s:
            terms["feet_contact_forces"] = torch.clamp_min(
                torch.linalg.norm(feet_f, dim=-1) - MAX_CONTACT_FORCE, 0.0).sum(-1)
        if "feet_air_time" in s:
            air_rew = ((feet_air - AIR_TIME_TARGET) * first_contact).sum(-1)
            terms["feet_air_time"] = air_rew * (cmd_norm > 0.1)
        feet_air = feet_air * (~contact_filt)

        r = torch.zeros((E,), device=dev)
        for k, v in terms.items():
            r = r + s[k] * v
        # only_positive_rewards (ref legged_robot_config.py:176)
        r = torch.clamp_min(r, 0.0)
        reward_terms = {k: s[k] * v for k, v in terms.items()}
        ep_len = torch.clamp_min(es.episode_length.to(torch.float32), 1.0)

        # masked reset of the finished envs
        fresh = draws.state("fresh", lambda: env._reset_all(draws))
        es = tree_map(lambda new, old: torch.where(
            done.reshape((E,) + (1,) * (new.ndim - 1)), new, old), fresh, es)

        # command curriculum (ref update_command_curriculum
        # legged_robot.py:505-514): when finished episodes track well, widen
        # the vx range, up to MAX_CURRICULUM
        track_acc = ts.track_acc + torch.exp(-lin_err / TRACKING_SIGMA)
        done_f = done.to(torch.float32)
        n_done = done_f.sum()
        mean_track = (track_acc / ep_len * done_f).sum() / torch.clamp_min(n_done, 1.0)
        grow = (n_done > 0) & (mean_track > 0.8)
        cmd_scale = torch.clamp(ts.cmd_scale + torch.where(grow, 0.02, 0.0),
                                1.0, self.MAX_CURRICULUM)
        track_acc = track_acc * (1.0 - done_f)

        # resample commands on reset and every 5 s (and at random fast
        # switches when resample_prob > 0)
        new_cmd = self._sample_commands(draws, cmd_scale)
        resample = done | (es.episode_length % int(5.0 / self.dt) == 0)
        if self.resample_prob > 0.0:
            resample = resample | (
                draws.uniform("cmd_switch", (E,), 0.0, 1.0, dev) < self.resample_prob)
        commands = torch.where(resample[:, None], new_cmd, cmd)

        # per-episode gait: redrawn for the envs that just reset
        gait_pob = ts.gait_pob
        if self.multi_gait > 0.0:
            gait_pob = torch.where(done[:, None], self._sample_gaits(draws), gait_pob)

        obs = self._locomotion_obs(es, commands, clock, gait_pob)
        keep = ~done[:, None]
        ts = LocoTaskState(
            env=es, commands=commands,
            last_action=torch.where(keep, resid, 0.0),
            last_qd=torch.where(keep, qd, 0.0),
            feet_air=torch.where(keep, feet_air, 0.0),
            last_contact=contact & keep,
            cmd_scale=cmd_scale, track_acc=track_acc, gait_pob=gait_pob,
            extra={"obs": obs},
        )
        info = {"time_outs": timeout, "reset_mask": done, "reward_terms": reward_terms}
        return ts, obs[:, None, :], r[:, None], done, info
