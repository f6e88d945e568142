"""Vectorized multi-agent Go1 environment, PyTorch.

Counterpart of `mqe_tpu/envs/go1_env.py` for tasks without NPCs, cameras or
a terrain curriculum (the go1gate slice): one control step runs the
command -> locomotion (trot controller + learned residual) -> actuator net ->
torque chain, `decimation` x `subiters` physics substeps, termination, a
masked auto-reset (`torch.where`, no indexed writes) and the observations.
The JAX package's two `lax.scan`s are Python loops here.

State is a dataclass of tensors with a leading env axis; the env object holds
only what is fixed at construction (models, terrain, nets, config values).
Random draws go through `utils.random.Draws`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from mqe_tpu_torch import ASSETS_DIR, default_device
from mqe_tpu_torch.control.locomotion import CLOCK_TO_LEG, TrotController, step_gait_clocks
from mqe_tpu_torch.control.nets import ActuatorNet, load_body_policy
from mqe_tpu_torch.envs.config import class_to_dict, default_joint_array
from mqe_tpu_torch.ops import quat as quat_ops
from mqe_tpu_torch.physics import contact as C
from mqe_tpu_torch.physics import scene as S
from mqe_tpu_torch.physics.model import load_model
from mqe_tpu_torch.terrain import get_terrain_builder, plane_terrain
from mqe_tpu_torch.utils.random import Draws
from mqe_tpu_torch.utils.tree import tree_map


@dataclass
class ObsBuf:
    """Namespace observation (per-component tensors, shapes (E, A, .))."""

    base_pos: torch.Tensor          # (E, A, 3) relative to env origin
    base_quat: torch.Tensor         # (E, A, 4)
    base_rpy: torch.Tensor          # (E, A, 3)
    lin_vel: torch.Tensor           # (E, A, 3) body frame, scaled
    ang_vel: torch.Tensor           # (E, A, 3) body frame, scaled
    dof_pos: torch.Tensor           # (E, A, 12) offset from default, scaled
    dof_vel: torch.Tensor           # (E, A, 12) scaled
    projected_gravity: torch.Tensor  # (E, A, 3)
    clock_inputs: torch.Tensor      # (E, A, 4)
    last_action: torch.Tensor       # (E, A, 12) locomotion-level
    last_last_action: torch.Tensor  # (E, A, 12)
    env_info: dict                  # oracle terrain info, e.g. gate_deviation (E, 2)


@dataclass
class EnvState:
    phys: S.PhysState               # (E, ...)
    episode_length: torch.Tensor    # (E,) int32
    gait_indices: torch.Tensor      # (E, A)
    clock_inputs: torch.Tensor      # (E, A, 4)
    loco_obs: torch.Tensor          # (E, A, 70)
    loco_hist: torch.Tensor         # (E, A, 0): no observation history is kept
    last_loco_action: torch.Tensor  # (E, A, 12)
    last2_loco_action: torch.Tensor
    err_hist: torch.Tensor          # (E, A, 4, 12) actuator history
    lag_buffer: torch.Tensor        # (E, A, L+1, 12) action lag DR (L=0 -> (E, A, 0, 12))
    dr: S.DomainRand                # (E, ...)
    commands: torch.Tensor          # (E, A, 3) current commands (set each step)
    vel_int: torch.Tensor           # (E, A, 3) velocity-error integrator (trot)
    push_timer: torch.Tensor        # (E,) int32
    done: torch.Tensor              # (E,) bool last-step termination
    terrain_levels: torch.Tensor    # (E,) int32 terrain row
    collide: torch.Tensor           # (E,) bool termination-contact flag
    r_term: torch.Tensor            # (E,) roll termination flag
    p_term: torch.Tensor            # (E,) pitch termination flag


def _unsupported(cfg):
    """What of a task config the port does not run yet, with its ROADMAP item."""
    out = []
    if cfg.env.num_npcs or cfg.asset.npc_model or cfg.asset.static_model:
        out.append("NPCs and static fixtures (ROADMAP Queue A item 11)")
    oc = cfg.obs.cfgs
    if getattr(oc, "depth_image", False) or getattr(oc, "rgb_image", False):
        out.append("onboard cameras (ROADMAP Queue A item 14)")
    if getattr(cfg.terrain, "curriculum", False) and cfg.terrain.mesh_type != "plane":
        out.append("the terrain curriculum (ROADMAP Queue A item 10)")
    if cfg.control.locomotion_backend not in ("trot", "residual"):
        out.append(f"the {cfg.control.locomotion_backend!r} locomotion backend "
                   "(ROADMAP Queue A item 12)")
    return out


class Go1Env:
    """Static env object: models, terrain, nets and config values.

    All per-task variability is fixed at construction.
    """

    def __init__(self, cfg, num_envs: int | None = None, seed: int = 0, device=None):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.env.env_name}: not ported yet: " + "; ".join(missing))
        self.cfg = cfg
        self.device = torch.device(device if device is not None else default_device())
        dev = self.device
        self.num_envs = num_envs or cfg.env.num_envs
        self.num_agents = cfg.env.num_agents
        E, A = self.num_envs, self.num_agents

        self.robot = load_model(cfg.asset.model)
        self.sim_dt = cfg.sim.dt
        self.subiters = cfg.sim.subiters
        self.decimation = cfg.control.decimation
        self.dt = self.sim_dt * self.decimation  # control dt (50 Hz)
        self.max_episode_length = int(np.ceil(cfg.env.episode_length_s / self.dt))

        self.default_q_np = np.asarray(default_joint_array(cfg), dtype=np.float32)
        self.default_q = torch.as_tensor(self.default_q_np, device=dev)
        # action-lag DR: joint targets delayed by lag_timesteps substeps
        # (ref go1.py:337-339, 363); L=0 disables the path
        self.lag_len = (
            int(cfg.domain_rand.lag_timesteps)
            if getattr(cfg.domain_rand, "randomize_lag_timesteps", False) else 0
        )
        self.torque_limits = torch.as_tensor(
            np.asarray(cfg.control.torque_limits, dtype=np.float32), device=dev)
        self.hip_scale = torch.as_tensor(
            np.asarray([cfg.control.hip_scale_reduction, 1.0, 1.0] * 4, dtype=np.float32),
            device=dev)
        self.action_scale = cfg.control.action_scale

        # ---- terrain (ref _create_terrain legged_robot.py:959-970) ----
        if cfg.terrain.mesh_type == "plane":
            self.build = plane_terrain(E, A, cfg.terrain.env_spacing)
        else:
            tcfg = class_to_dict(cfg.terrain)
            selected = getattr(cfg.terrain, "selected", "BarrierTrack") or "Legacy"
            builder = get_terrain_builder(selected if selected is not True else "BarrierTrack")
            self.build = builder(tcfg, A).build(seed=seed)
        R, Cc = self.build.env_origins.shape[:2]
        rng = np.random.default_rng(seed + 1)
        rows = rng.integers(0, R, size=E)
        cols = np.arange(E) % Cc
        self.env_rows = rows
        t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
        self.env_origins = t(self.build.env_origins[rows, cols])       # (E, 3)
        self.agent_origins = t(self.build.agent_origins[rows, cols])   # (E, A, 3)
        env_boxes = self.build.boxes[rows, cols]                       # (E, B, 7)
        # trim the box budget to what this task uses
        nbox_used = int((env_boxes[..., 6] > 0).any(axis=0).sum())
        self.env_boxes = t(env_boxes[:, :nbox_used])
        self.env_info = {k: t(v[rows, cols]) for k, v in self.build.env_info.items()}
        self.terrain = S.Terrain(
            height=t(self.build.height), origin=t(self.build.origin),
            scale=float(self.build.scale), boxes=self.env_boxes,
        )

        # flat ground (every predefined task) -> analytic plane contact
        hmin, hmax = float(self.build.height.min()), float(self.build.height.max())
        flat_height = hmin if hmin == hmax else None
        self.scene = S.SceneModel(
            robot=self.robot,
            num_agents=A,
            contact=C.ContactParams(
                kn=cfg.physx.kn, hc_damping=cfg.physx.hc_damping,
                v_slip=cfg.physx.v_slip, f_max=cfg.physx.f_max,
            ),
            flat_height=flat_height,
        )
        self.term_sph = self.robot.sphere_mask(cfg.asset.terminate_after_contacts_on)

        # ---- control backends ----
        self.actuator = ActuatorNet().to(dev)
        self.backend = cfg.control.locomotion_backend
        self.trot = TrotController(
            body_height=0.28,
            action_scale=cfg.control.action_scale,
            hip_scale_reduction=cfg.control.hip_scale_reduction,
            default_q=self.default_q_np,
        )
        # the residual backend adds the trained body policy to the trot
        # controller when its weights are there
        bp = os.path.join(ASSETS_DIR, "body_policy.npz")
        self.body_policy = (
            load_body_policy(bp).to(dev)
            if self.backend == "residual" and os.path.exists(bp) else None
        )

        dc = cfg.control.default_command
        gait_phase = np.asarray(cfg.command.gaits[dc.gait], dtype=np.float32)
        self.gait_params_static = dict(
            freq=dc.gait_freq,
            phases=float(gait_phase[0]),
            offsets=float(gait_phase[1]),
            bounds=float(gait_phase[2]),
            duration=0.5,
            swing_height=max(dc.footswing_height, 0.12),
            stance_width=dc.stance_width,
            stance_length=dc.stance_length,
            body_height_delta=dc.body_height,
        )

        # init states per agent (A, 13)
        ist = cfg.init_state
        if ist.multi_init_state and ist.init_states:
            arr = np.array(
                [s.pos + s.rot + s.lin_vel + s.ang_vel for s in ist.init_states],
                dtype=np.float32,
            )
            if arr.shape[0] < A:
                arr = np.tile(arr, (int(np.ceil(A / arr.shape[0])), 1))[:A]
        else:
            arr = np.tile(
                np.asarray(ist.pos + ist.rot + ist.lin_vel + ist.ang_vel, dtype=np.float32),
                (A, 1),
            )
        self.agent_init = t(arr)  # (A, 13)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)

    # ------------------------------------------------------------------
    # construction of fresh (reset) states
    # ------------------------------------------------------------------
    def _fresh_env_state(self, draws: Draws):
        """Spawn state of every env: (agents, npcs, dr), each (E, ...)."""
        cfg = self.cfg
        E, A, dev = self.num_envs, self.num_agents, self.device
        base = self.agent_init.expand(E, A, 13)
        pos = base[..., :3].clone()
        quat = base[..., 3:7].clone()

        dr_cfg = cfg.domain_rand
        if dr_cfg.init_base_pos_range is not None:
            rx = dr_cfg.init_base_pos_range["x"]
            ry = dr_cfg.init_base_pos_range["y"]
            pos[..., 0] += draws.uniform("spawn_x", (E, A), rx[0], rx[1], dev)
            pos[..., 1] += draws.uniform("spawn_y", (E, A), ry[0], ry[1], dev)

        q = self.default_q.expand(E, A, 12).clone()
        if dr_cfg.init_dof_pos_ratio_range is not None:
            r = dr_cfg.init_dof_pos_ratio_range
            q = q * draws.uniform("dof_ratio", (E, A, 12), r[0], r[1], dev)
        vr = dr_cfg.init_base_vel_range
        vel6 = draws.uniform("base_vel", (E, A, 6), vr[0], vr[1], dev)
        agents = S.ActorState(
            pos=pos, quat=quat, lin_vel=vel6[..., :3], ang_vel=vel6[..., 3:],
            q=q, qd=torch.zeros((E, A, 12), device=dev),
        )
        z = lambda *s: torch.zeros(s, device=dev)
        npcs = S.ActorState(z(E, 0, 3), z(E, 0, 4), z(E, 0, 3), z(E, 0, 3), z(E, 0, 0), z(E, 0, 0))

        mu = torch.ones(E, device=dev)
        if dr_cfg.randomize_friction:
            fr = dr_cfg.friction_range
            mu = draws.uniform("friction", (E,), fr[0], fr[1], dev)
        payload = z(E, A)
        com_shift = z(E, A, 3)
        motor = torch.ones((E, A, 12), device=dev)
        if dr_cfg.randomize_base_mass:
            mr = dr_cfg.added_mass_range
            payload = draws.uniform("payload", (E, A), mr[0], mr[1], dev)
        if dr_cfg.randomize_com:
            cr = dr_cfg.com_range
            com_shift = torch.stack(
                [draws.uniform(f"com_{k}", (E, A), cr[k][0], cr[k][1], dev) for k in "xyz"],
                dim=-1,
            )
        if dr_cfg.randomize_motor:
            mr = dr_cfg.leg_motor_strength_range
            motor = draws.uniform("motor", (E, A, 12), mr[0], mr[1], dev)
        dr = S.DomainRand(mu_scale=mu, payload=payload, com_shift=com_shift, motor_strength=motor)
        return agents, npcs, dr

    def _reset_all(self, draws: Draws) -> EnvState:
        E, A, dev = self.num_envs, self.num_agents, self.device
        agents, npcs, dr = self._fresh_env_state(draws)
        # spawn = init-state pos + terrain agent origin (xy only)
        ao = self.agent_origins.clone()
        ao[..., 2] = 0.0
        agents = replace(agents, pos=agents.pos + ao)
        z = lambda *s: torch.zeros(s, device=dev)
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        return EnvState(
            phys=S.PhysState(agents=agents, npcs=npcs),
            episode_length=zi(E),
            gait_indices=z(E, A),
            clock_inputs=z(E, A, 4),
            loco_obs=z(E, A, 70),
            loco_hist=z(E, A, 0),
            last_loco_action=z(E, A, 12),
            last2_loco_action=z(E, A, 12),
            err_hist=z(E, A, 4, 12),
            lag_buffer=z(E, A, self.lag_len + 1 if self.lag_len else 0, 12),
            dr=dr,
            commands=z(E, A, 3),
            vel_int=z(E, A, 3),
            push_timer=zi(E),
            done=zb(E),
            terrain_levels=torch.as_tensor(self.env_rows, dtype=torch.int32, device=dev),
            collide=zb(E),
            r_term=zb(E),
            p_term=zb(E),
        )

    def draws(self, given: dict | None = None) -> Draws:
        """Draws from this env's generator, with optional precomputed values."""
        return Draws(self.generator, given)

    def fresh_state(self, draws: Draws | None = None) -> EnvState:
        """A freshly reset state of every env (what `reset` starts from)."""
        return self._reset_all(draws or self.draws())

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _locomotion_action(self, state: EnvState, commands):
        """commands (E, A, 3) -> locomotion action (E, A, 12) + new clocks."""
        cfg = self.cfg
        gp = self.gait_params_static
        E, A, dev = self.num_envs, self.num_agents, self.device

        def bc(v):
            return torch.full((E, A), float(v), device=dev)

        phases, offsets, bounds = bc(gp["phases"]), bc(gp["offsets"]), bc(gp["bounds"])
        gait_idx, idx, clock, _, _ = step_gait_clocks(
            state.gait_indices, self.dt, bc(gp["freq"]), phases, offsets, bounds,
            bc(gp["duration"]),
        )
        idx_legs = idx[..., torch.as_tensor(CLOCK_TO_LEG, device=dev)]

        ag = state.phys.agents
        r, p, _ = quat_ops.get_euler_xyz_wrapped(ag.quat)
        yawq = quat_ops.yaw_quat(ag.quat)
        v_yaw = quat_ops.quat_rotate_inverse(yawq, ag.lin_vel)

        gait_arr = {k: bc(gp[k]) for k in (
            "freq", "duration", "swing_height", "stance_width", "stance_length",
            "body_height_delta")}
        loco_obs = self._fill_locomotion_obs(state, commands, clock)
        # velocity-error integrator (anti-windup clamped)
        verr = torch.stack(
            [
                commands[..., 0] - v_yaw[..., 0],
                commands[..., 1] - v_yaw[..., 1],
                commands[..., 2] - ag.ang_vel[..., 2],
            ],
            dim=-1,
        )
        cl = self.trot.INT_CLAMP
        vel_int = torch.clamp(state.vel_int + self.dt * verr, -cl, cl)
        z_meas = (
            ag.pos[..., 2] - self.scene.flat_height
            if self.scene.flat_height is not None else None
        )
        action = self.trot(
            commands, idx_legs, gait_arr, roll=r, pitch=p,
            v_meas=v_yaw[..., :2], w_meas=ag.ang_vel[..., 2],
            v_int=vel_int, z_meas=z_meas,
        )
        if self.body_policy is not None:
            # trained residual: model-based trot + learned correction
            action = action + self.body_policy(loco_obs)
        clip_a = cfg.normalization.clip_actions
        action = torch.clamp(action, -clip_a, clip_a)
        return action, gait_idx, clock, loco_obs, state.loco_hist, vel_int

    def _fill_locomotion_obs(self, state: EnvState, commands, clock):
        """The 70-dim walk-these-ways obs (layout per ref go1.py:64-108, 411-479)."""
        cfg = self.cfg
        sc = cfg.control.obs_scales
        dc = cfg.control.default_command
        ag = state.phys.agents
        E, A = self.num_envs, self.num_agents
        down = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand(ag.quat.shape[:-1] + (3,))
        g_body = quat_ops.quat_rotate_inverse(ag.quat, down)
        gait = cfg.command.gaits[dc.gait]
        o = torch.zeros((E, A, 70), device=self.device)
        o[..., 0:3] = g_body
        o[..., 3] = commands[..., 0] * sc.lin_vel
        o[..., 4] = commands[..., 1] * sc.lin_vel
        o[..., 5] = commands[..., 2] * sc.ang_vel
        o[..., 6] = dc.body_height * sc.body_height
        o[..., 7] = dc.gait_freq * sc.gait_freq
        o[..., 8] = gait[0] * sc.gait_phase
        o[..., 9] = gait[1] * sc.gait_phase
        o[..., 10] = gait[2] * sc.gait_phase
        o[..., 11] = 0.5 * sc.gait_phase
        o[..., 12] = dc.footswing_height * sc.footswing_height
        o[..., 13] = dc.body_pitch * sc.body_pitch
        o[..., 14] = dc.body_roll * sc.body_roll
        o[..., 15] = dc.stance_width * sc.stance_width
        o[..., 16] = dc.stance_length * sc.stance_length
        o[..., 17] = dc.aux_reward * sc.aux_reward
        o[..., 18:30] = (ag.q - self.default_q) * sc.dof_pos
        o[..., 30:42] = ag.qd * sc.dof_vel
        o[..., 42:54] = state.last_loco_action
        o[..., 54:66] = state.last2_loco_action
        o[..., 66:70] = clock
        return o

    def _torques(self, state: EnvState, action):
        """Locomotion action -> joint torques via the actuator net
        (ref go1.py:315-354). Returns (tau, err_hist, lag_buffer, target)."""
        scaled = action * self.action_scale * self.hip_scale
        if self.lag_len > 0:
            # shift the lag FIFO and actuate the OLDEST entry (ref go1.py:338-339)
            lag = torch.cat([state.lag_buffer[..., 1:, :], scaled[..., None, :]], dim=-2)
            target = lag[..., 0, :] + self.default_q
        else:
            lag = state.lag_buffer
            target = scaled + self.default_q
        ag = state.phys.agents
        err = ag.q - target
        vel = ag.qd
        h = state.err_hist  # (E, A, 4, 12): err_last, err_llast, vel_last, vel_llast
        tau = self.actuator(err, h[..., 0, :], h[..., 1, :], vel, h[..., 2, :], h[..., 3, :])
        # the trot controller's supplementary joint PD (both ported backends)
        tau = tau - self.trot.TAU_KP * err - self.trot.TAU_KD * vel
        tau = tau * state.dr.motor_strength
        tau = torch.maximum(torch.minimum(tau, self.torque_limits), -self.torque_limits)
        new_hist = torch.stack([err, h[..., 0, :], vel, h[..., 2, :]], dim=-2)
        return tau, new_hist, lag, target

    def _physics(self, state: EnvState, tau):
        """One decimation substep: `subiters` scene substeps over the env batch."""
        phys = state.phys
        for _ in range(self.subiters):
            phys, contacts = S.substep_batch(
                self.scene, self.terrain, phys, tau, state.dr, self.sim_dt / self.subiters)
        return phys, contacts

    def _termination(self, state: EnvState, contacts):
        """Contact on base + roll/pitch/z terms + timeout
        (ref legged_robot.py:159-169, legged_robot_field.py:121-146)."""
        cfg = self.cfg
        ag = state.phys.agents
        E, dev = self.num_envs, self.device

        cforce = torch.linalg.norm(contacts.sphere_force, dim=-1)  # (E, A, ns)
        if self.term_sph.any():
            term_mask = torch.as_tensor(self.term_sph, device=dev)
            collide = ((cforce * term_mask) > 1.0).flatten(1).any(dim=1)
        else:
            collide = torch.zeros(E, dtype=torch.bool, device=dev)
        reset = collide

        r, p, _ = quat_ops.get_euler_xyz_wrapped(ag.quat)
        z_rel = ag.pos[..., 2] - self.agent_origins[..., 2]
        terms = cfg.termination.termination_terms
        r_term = torch.zeros(E, dtype=torch.bool, device=dev)
        p_term = torch.zeros(E, dtype=torch.bool, device=dev)
        if "roll" in terms:
            r_term = (torch.abs(r) > cfg.termination.roll_kwargs["threshold"]).any(dim=-1)
            reset = reset | r_term
        if "pitch" in terms:
            p_term = (torch.abs(p) > cfg.termination.pitch_kwargs["threshold"]).any(dim=-1)
            reset = reset | p_term
        if "z_low" in terms:
            reset = reset | (z_rel < cfg.termination.z_low_kwargs["threshold"]).any(dim=-1)
        if "z_high" in terms:
            reset = reset | (z_rel > cfg.termination.z_high_kwargs["threshold"]).any(dim=-1)
        timeout = state.episode_length >= self.max_episode_length
        return reset | timeout, collide, r_term, p_term, timeout

    def _observations(self, state: EnvState) -> ObsBuf:
        sc = self.cfg.normalization.obs_scales
        ag = state.phys.agents
        r, p, y = quat_ops.get_euler_xyz(ag.quat)
        down = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand(ag.quat.shape[:-1] + (3,))
        return ObsBuf(
            base_pos=ag.pos - self.env_origins[:, None, :],
            base_quat=ag.quat,
            base_rpy=torch.stack([r, p, y], dim=-1),
            lin_vel=quat_ops.quat_rotate_inverse(ag.quat, ag.lin_vel) * sc.lin_vel,
            ang_vel=quat_ops.quat_rotate_inverse(ag.quat, ag.ang_vel) * sc.ang_vel,
            dof_pos=(ag.q - self.default_q) * sc.dof_pos,
            dof_vel=ag.qd * sc.dof_vel,
            projected_gravity=quat_ops.quat_rotate_inverse(ag.quat, down),
            clock_inputs=state.clock_inputs,
            last_action=state.last_loco_action,
            last_last_action=state.last2_loco_action,
            env_info=self.env_info,
        )

    def _step_pre(self, state: EnvState, commands, draws: Draws):
        """Physics + termination, BEFORE the masked auto-reset.

        Returns the pre-reset state (done/term flags set) plus a carry for
        `_step_finish` (wrappers read task success on the pre-reset state)."""
        cfg = self.cfg
        E, A, dev = self.num_envs, self.num_agents, self.device
        # action clip modes (ref legged_robot_field.py:96-115)
        nrm = cfg.normalization
        if getattr(nrm, "clip_actions_method", "hard") == "tanh":
            commands = torch.tanh(commands) * nrm.clip_actions
        delta = getattr(nrm, "clip_actions_delta", None)
        if delta is not None:
            d_arr = torch.as_tensor(delta, dtype=commands.dtype, device=dev)
            commands = torch.maximum(
                torch.minimum(commands, state.commands + d_arr), state.commands - d_arr)
        # reference clips incoming (pre-scaled) commands to [-1, 1] (ref go1.py:38)
        commands = torch.clamp(commands, -1.0, 1.0)

        action, gait_idx, clock, loco_obs, loco_hist, vel_int = (
            self._locomotion_action(state, commands)
        )
        state = replace(
            state, gait_indices=gait_idx, clock_inputs=clock,
            loco_obs=loco_obs, loco_hist=loco_hist,
            last2_loco_action=state.last_loco_action,
            last_loco_action=action,
            commands=commands,
            vel_int=vel_int,
        )

        for _ in range(self.decimation):
            tau, err_hist, lag, _ = self._torques(state, action)
            phys, contacts = self._physics(state, tau)
            state = replace(state, phys=phys, err_hist=err_hist, lag_buffer=lag)

        if cfg.domain_rand.push_robots:
            interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
            push_now = (state.push_timer % interval) == (interval - 1)
            mv = cfg.domain_rand.max_push_vel_xy
            push_vel = draws.uniform("push_vel", (E, A, 2), -mv, mv, dev)
            ag = state.phys.agents
            pushed = torch.cat([push_vel, ag.lin_vel[..., 2:]], dim=-1)
            new_lv = torch.where(push_now[:, None, None], pushed, ag.lin_vel)
            state = replace(state, phys=replace(state.phys, agents=replace(ag, lin_vel=new_lv)))

        state = replace(
            state,
            episode_length=state.episode_length + 1,
            push_timer=state.push_timer + 1,
        )
        done, collide, r_term, p_term, timeout = self._termination(state, contacts)
        state = replace(state, done=done, collide=collide, r_term=r_term, p_term=p_term)
        return state, (done, collide, r_term, p_term, timeout)

    def _step_finish(self, state: EnvState, carry, draws: Draws):
        """Masked auto-reset + observations (post-reset half)."""
        E = self.num_envs
        done, collide, r_term, p_term, timeout = carry
        fresh = draws.state("fresh", lambda: self._reset_all(draws))

        def sel(new, old):
            if new.ndim == 0:
                return old
            return torch.where(done.reshape((E,) + (1,) * (new.ndim - 1)), new, old)

        state = tree_map(sel, fresh, state)
        state = replace(state, done=done, collide=collide, r_term=r_term, p_term=p_term)
        obs = self._observations(state)
        info = {
            "time_outs": timeout,
            "reset_mask": done,
            "episode_length": state.episode_length,
        }
        return state, obs, done, info

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @torch.no_grad()
    def reset(self, draws: Draws | None = None):
        state = self._reset_all(draws or self.draws())
        return state, self._observations(state)

    @torch.no_grad()
    def step(self, state: EnvState, commands, draws: Draws | None = None):
        """One control step. commands: (E, A, 3). A draw named "fresh" in
        `draws` is the reset state that done envs take."""
        draws = draws or self.draws()
        state, carry = self._step_pre(state, commands, draws)
        return self._step_finish(state, carry, draws)
