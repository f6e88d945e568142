"""Vectorized multi-agent Go1 environment, PyTorch.

Counterpart of `mqe_tpu/envs/go1_env.py` for every task of the registry:
passive NPCs (box, seesaw, ball, hinged doors and discs), static fixtures
(the wrestling ring, the bridge), the scripted football defender and the
sheep's flee script; the onboard depth/RGB camera (render/onboard.py) and
the runtime terrain curriculum on a heightfield of several rows. One control
step runs the command -> locomotion (trot controller + learned residual, or
the `policy` backend's body policy) -> actuator net -> torque chain,
`decimation` x `subiters` physics substeps, the NPC script, termination, the
curriculum's promotion and demotion, a masked auto-reset (`torch.where`, no
indexed writes) and the observations. The JAX package's two `lax.scan`s are
Python loops here.

State is a dataclass of tensors with a leading env axis; the env object holds
only what is fixed at construction (models, terrain, nets, config values).
Random draws go through `utils.random.Draws`.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

import refsim
from refsim import default_device
from refsim.control.locomotion import CLOCK_TO_LEG, TrotController, step_gait_clocks
from refsim.control.nets import (ActuatorNet, AdaptationModule, WalkTheseWaysBody,
                                        load_body_policy)
from refsim.envs.config import class_to_dict, default_joint_array
from refsim.ops import quat as quat_ops
from refsim.physics import contact as C
from refsim.physics import scene as S
from refsim.physics.model import load_model, load_static_geoms
from refsim.render import onboard
from refsim.terrain import get_terrain_builder, plane_terrain
from refsim.utils.random import Draws
from refsim.utils.tree import tree_map


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
    # onboard forward camera (ref legged_robot_field.py:23-93); None unless
    # cfg.obs.cfgs.depth_image / rgb_image are on
    depth_image: torch.Tensor | None = None  # (E, A, H, W) meters in [0, far]
    rgb_image: torch.Tensor | None = None    # (E, A, H, W, 3) in [0, 1]


@dataclass
class EnvState:
    phys: S.PhysState               # (E, ...)
    episode_length: torch.Tensor    # (E,) int32
    gait_indices: torch.Tensor      # (E, A)
    clock_inputs: torch.Tensor      # (E, A, 4)
    loco_obs: torch.Tensor          # (E, A, 70)
    loco_hist: torch.Tensor         # (E, A, 70 * hist_len): the last hist_len obs70, oldest first
    last_loco_action: torch.Tensor  # (E, A, 12)
    last2_loco_action: torch.Tensor
    err_hist: torch.Tensor          # (E, A, 4, 12) actuator history
    lag_buffer: torch.Tensor        # (E, A, L+1, 12) action lag DR (L=0 -> (E, A, 0, 12))
    dr: S.DomainRand                # (E, ...)
    commands: torch.Tensor          # (E, A, 3) current commands (set each step)
    vel_int: torch.Tensor           # (E, A, 3) velocity-error integrator (trot)
    push_timer: torch.Tensor        # (E,) int32
    done: torch.Tensor              # (E,) bool last-step termination
    terrain_levels: torch.Tensor    # (E,) int32 curriculum row (static if off)
    collide: torch.Tensor           # (E,) bool termination-contact flag
    r_term: torch.Tensor            # (E,) roll termination flag
    p_term: torch.Tensor            # (E,) pitch termination flag


class Go1Env:
    """Static env object: models, terrain, nets and config values.

    All per-task variability is fixed at construction.
    """

    def __init__(self, cfg, num_envs: int | None = None, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = torch.device(device if device is not None else default_device())
        dev = self.device
        self.num_envs = num_envs or cfg.env.num_envs
        self.num_agents = cfg.env.num_agents
        self.num_npcs = cfg.env.num_npcs
        E, A, N = self.num_envs, self.num_agents, self.num_npcs

        self.robot = load_model(cfg.asset.model)
        self.npc = (load_model(cfg.asset.npc_model, root_free=not cfg.asset.fix_npc_base_link)
                    if cfg.asset.npc_model else None)
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
        # runtime terrain curriculum (ref _update_terrain_curriculum
        # legged_robot.py:479-503): the env's row is state, promoted or
        # demoted on each episode's outcome. The JAX package runs it only on
        # a terrain of more than one row; off, every origin lookup is static
        self.curriculum = (
            bool(getattr(cfg.terrain, "curriculum", False))
            and cfg.terrain.mesh_type != "plane"
            and R > 1
        )
        t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
        self.env_origins = t(self.build.env_origins[rows, cols])       # (E, 3)
        self.agent_origins = t(self.build.agent_origins[rows, cols])   # (E, A, 3)
        env_boxes = self.build.boxes[rows, cols]                       # (E, B, 7)
        # trim the box budget to what this task uses: under the curriculum
        # what any row uses, since an env may move to any row
        if self.curriculum:
            nbox_used = int((self.build.boxes[..., 6] > 0).any(axis=(0, 1)).sum())
            self.grid_env_origins = t(self.build.env_origins)          # (R, C, 3)
            self.grid_agent_origins = t(self.build.agent_origins)      # (R, C, A, 3)
            self.grid_boxes = t(self.build.boxes[:, :, :nbox_used])    # (R, C, B, 7)
            self.grid_env_info = {k: t(v) for k, v in self.build.env_info.items()}
            self.env_cols_j = torch.as_tensor(cols, device=dev)
            self.num_levels = R
            # promote when the farthest agent crossed half the track
            # (ref _get_terrain_curriculum_move legged_robot.py:496-503)
            self.curr_up_dist = float(self.build.track_length) / 2.0
        else:
            nbox_used = int((env_boxes[..., 6] > 0).any(axis=0).sum())
        self.env_boxes = t(env_boxes[:, :nbox_used])
        self.env_info = {k: t(v[rows, cols]) for k, v in self.build.env_info.items()}

        # static fixture geoms (bridge deck, wrestling ring) placed at the
        # first NPC init position of each env
        static_rows = np.zeros((0, 8), dtype=np.float32)
        if cfg.asset.static_model:
            sg = load_static_geoms(cfg.asset.static_model)
            base = np.asarray(cfg.init_state.init_states_npc[0].pos, dtype=np.float32)
            rows_ = [[S.SG_BOX, *(sg.boxes_center[i] + base), *sg.boxes_half[i], 1.0]
                     for i in range(sg.boxes_center.shape[0])]
            rows_ += [[S.SG_CYL, *(sg.cyl_center[i] + base), sg.cyl_radius[i],
                       sg.cyl_half_length[i], 0.0, 1.0] for i in range(sg.cyl_center.shape[0])]
            static_rows = np.asarray(rows_, dtype=np.float32)
        sgs = np.tile(static_rows[None], (E, 1, 1))
        sgs[:, :, 1:3] += np.asarray(self.build.env_origins[rows, cols][:, None, :2])
        self.static_geoms = t(sgs)                                     # (E, G, 8)
        # the contact takes each kind's rows apart, without the kind column
        # (and a cylinder's unused third size)
        kind = static_rows[:, 0]
        self.terrain = S.Terrain(
            height=t(self.build.height), origin=t(self.build.origin),
            scale=float(self.build.scale), boxes=self.env_boxes,
            static_boxes=t(np.ascontiguousarray(sgs[:, kind == S.SG_BOX, 1:8])),
            static_cyls=t(np.ascontiguousarray(sgs[:, kind == S.SG_CYL][..., [1, 2, 3, 4, 5, 7]])),
        )

        # the NPC collides unless a static fixture stands in for it
        self.npc_has_collision = cfg.asset.npc_collision and cfg.asset.static_model is None

        # flat ground (every predefined task) -> analytic plane contact
        hmin, hmax = float(self.build.height.min()), float(self.build.height.max())
        flat_height = hmin if hmin == hmax else None
        self.scene = S.SceneModel(
            robot=self.robot,
            num_agents=A,
            npc=self.npc if self.npc_has_collision else None,
            num_npcs=N if self.npc_has_collision else 0,
            npc_root_free=not cfg.asset.fix_npc_base_link,
            contact=C.ContactParams(
                kn=cfg.physx.kn, hc_damping=cfg.physx.hc_damping,
                v_slip=cfg.physx.v_slip, f_max=cfg.physx.f_max,
            ),
            flat_height=flat_height,
        )
        # sphere masks for termination / penalty classification
        self.term_sph = self.robot.sphere_mask(cfg.asset.terminate_after_contacts_on)
        self.pen_sph = self.robot.sphere_mask(cfg.asset.penalize_contacts_on)

        # ---- control backends ----
        self.actuator = ActuatorNet(device=dev)
        self.backend = cfg.control.locomotion_backend
        self.trot = TrotController(
            body_height=0.28,
            action_scale=cfg.control.action_scale,
            hip_scale_reduction=cfg.control.hip_scale_reduction,
            default_q=self.default_q_np,
        )
        # the body policy: the trained obs70 policy of assets/body_policy.npz
        # when it is there (residual: added to the trot controller; policy:
        # the whole action), else None (the trot controller) until
        # `load_locomotion_policy`. The `policy` backend without that file
        # keeps the walk-these-ways history for the adaptation module.
        self.adaptation = AdaptationModule(device=dev) if self.backend == "policy" else None
        self.body_policy = None
        self.hist_len = 30 if self.backend == "policy" else 0
        if self.backend in ("policy", "residual"):
            bp = os.path.join(refsim.ASSETS_DIR, "body_policy.npz")
            if os.path.exists(bp):
                self.body_policy = load_body_policy(bp, device=dev)
                self.hist_len = 0  # the obs70 policy needs no history

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

        # NPC init states (N, 13) and joint angles (nq_npc,)
        narr = np.zeros((N, 13), dtype=np.float32)
        narr[:, 6] = 1.0
        if N > 0 and ist.init_states_npc:
            narr = np.array(
                [s.pos + s.rot + s.lin_vel + s.ang_vel for s in ist.init_states_npc],
                dtype=np.float32,
            )
            if narr.shape[0] < N:
                narr = np.tile(narr, (int(np.ceil(N / narr.shape[0])), 1))[:N]
            narr = narr[:N]
        self.npc_init = t(narr)
        dnpc = np.zeros((0,), dtype=np.float32)
        if self.npc is not None:
            dnpc = np.asarray(ist.default_npc_joint_angles, dtype=np.float32)
            if dnpc.size < self.npc.nq:
                dnpc = np.zeros(self.npc.nq, dtype=np.float32)
            dnpc = dnpc[:self.npc.nq]
        self.npc_default_q = t(dnpc)

        # sheep grid init (ref go1_sheep.py:66-111) overrides init_states_npc
        self.npc_behavior = getattr(cfg.asset, "npc_behavior", "none")
        if self.npc_behavior == "sheep":
            nr, nc = cfg.asset.num_rows, cfg.asset.num_cols
            dis = cfg.asset.dis_sheep
            bt = cfg.terrain.BarrierTrack_kwargs
            ox = bt["init"]["block_length"] + bt["plane"]["block_length"] / 2 - (nr // 2) * dis[0]
            oy = -(nc // 2) * dis[1]
            pos = [[ox + i * dis[0], oy + j * dis[1], 0.3] for i in range(nr) for j in range(nc)]
            ni = np.zeros((N, 13), dtype=np.float32)
            ni[:, :3] = np.asarray(pos[:N], dtype=np.float32)
            ni[:, 6] = 1.0
            self.npc_init = t(ni)
        if self.npc_behavior == "defender":
            # the defender's gate: the far end of the pitch plane, per env
            bt = cfg.terrain.BarrierTrack_kwargs
            off = [bt["init"]["block_length"] + bt["plane"]["block_length"], 0.0, 0.0]
            self.defender_gate = self.env_origins + t(np.asarray(off, dtype=np.float32))

        # ---- onboard forward camera (ref legged_robot_field.py:23-93) ----
        oc = cfg.obs.cfgs
        self.cam_depth = bool(getattr(oc, "depth_image", False))
        self.cam_rgb = bool(getattr(oc, "rgb_image", False))
        self.cam_rays = None
        if self.cam_depth or self.cam_rgb:
            fc = cfg.sensor.forward_camera
            self.cam_res = tuple(fc.resolution)
            rays = onboard.camera_rays(self.cam_res, fc.horizontal_fov)
            self.cam_rays = t(rays.reshape(-1, 3))                      # (R, 3)
            self.cam_offset = t(np.asarray(fc.position, dtype=np.float32))
            # ZYX euler -> rotation matrix (camera mount in base frame,
            # ref Quat.from_euler_zyx at legged_robot_field.py:85)
            r_, p_, y_ = fc.rotation
            Rz = np.array([[np.cos(y_), -np.sin(y_), 0], [np.sin(y_), np.cos(y_), 0], [0, 0, 1]])
            Ry = np.array([[np.cos(p_), 0, np.sin(p_)], [0, 1, 0], [-np.sin(p_), 0, np.cos(p_)]])
            Rx = np.array([[1, 0, 0], [0, np.cos(r_), -np.sin(r_)], [0, np.sin(r_), np.cos(r_)]])
            self.cam_rot = t((Rz @ Ry @ Rx).astype(np.float32))
            self.cam_far = float(fc.far)
            # sphere-impostor radii for the other actors seen by the camera
            self.cam_agent_radius = 0.3
            if self.npc is not None and len(self.npc.sph_tags) > 0:
                self.cam_npc_radius = float(np.max(self.npc.sph_radius))
            else:
                self.cam_npc_radius = 0.25

        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        # (start, stop, total) when this env holds one rank's slice of a
        # larger env batch (parallel/mesh.py::shard_wrapper), else None
        self.env_slice = None

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
            pos=pos, quat=quat,  # contiguous, as the kernels of physics/fused_step.py take them
            lin_vel=vel6[..., :3].contiguous(), ang_vel=vel6[..., 3:].contiguous(),
            q=q, qd=torch.zeros((E, A, 12), device=dev),
        )
        z = lambda *s: torch.zeros(s, device=dev)
        N = self.num_npcs
        if N > 0:
            # every NPC field is made contiguous here, as the kernels take it
            ninit = self.npc_init.expand(E, N, 13)
            npos = ninit[..., :3].clone()
            nrange = dr_cfg.init_npc_base_pos_range
            if nrange is not None:
                npos[..., 0] += draws.uniform("npc_spawn_x", (E, N), nrange["x"][0], nrange["x"][1], dev)
                npos[..., 1] += draws.uniform("npc_spawn_y", (E, N), nrange["y"][0], nrange["y"][1], dev)
            nq = self.npc_default_q.expand(E, N, self.npc_default_q.shape[0]).clone()
            npcs = S.ActorState(
                pos=npos, quat=ninit[..., 3:7].clone(), lin_vel=ninit[..., 7:10].clone(),
                ang_vel=ninit[..., 10:13].clone(), q=nq, qd=torch.zeros_like(nq),
            )
        else:
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

    def _origins_for(self, levels):
        """(env_origins (E, 3), agent_origins (E, A, 3)): static when the
        curriculum is off, gathered by terrain level when on."""
        if self.curriculum:
            lv = levels.to(torch.int64)
            return (self.grid_env_origins[lv, self.env_cols_j],
                    self.grid_agent_origins[lv, self.env_cols_j])
        return self.env_origins, self.agent_origins

    def _terrain_for(self, levels) -> S.Terrain:
        """The contact's terrain: each env's wall boxes of its level under
        the curriculum, else the static ones."""
        if self.curriculum:
            return replace(self.terrain,
                           boxes=self.grid_boxes[levels.to(torch.int64), self.env_cols_j])
        return self.terrain

    def _reset_all(self, draws: Draws, levels=None) -> EnvState:
        E, A, dev = self.num_envs, self.num_agents, self.device
        if levels is None:
            levels = torch.as_tensor(self.env_rows, dtype=torch.int32, device=dev)
        agents, npcs, dr = self._fresh_env_state(draws)
        # spawn = init-state pos + terrain agent origin (xy only); NPCs are
        # placed from the env origin
        eo, ao = self._origins_for(levels)
        ao = ao.clone()
        ao[..., 2] = 0.0
        agents = replace(agents, pos=agents.pos + ao)
        if self.num_npcs > 0:
            eo = eo.clone()
            eo[:, 2] = 0.0
            npcs = replace(npcs, pos=npcs.pos + eo[:, None, :])
        z = lambda *s: torch.zeros(s, device=dev)
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        return EnvState(
            phys=S.PhysState(agents=agents, npcs=npcs),
            episode_length=zi(E),
            gait_indices=z(E, A),
            clock_inputs=z(E, A, 4),
            loco_obs=z(E, A, 70),
            loco_hist=z(E, A, 70 * self.hist_len),
            last_loco_action=z(E, A, 12),
            last2_loco_action=z(E, A, 12),
            err_hist=z(E, A, 4, 12),
            lag_buffer=z(E, A, self.lag_len + 1 if self.lag_len else 0, 12),
            dr=dr,
            commands=z(E, A, 3),
            vel_int=z(E, A, 3),
            push_timer=zi(E),
            done=zb(E),
            terrain_levels=levels,
            collide=zb(E),
            r_term=zb(E),
            p_term=zb(E),
        )

    def draws(self, given: dict | None = None) -> Draws:
        """Draws from this env's generator, with optional precomputed values."""
        return Draws(self.generator, given, env_slice=self.env_slice)

    def fresh_state(self, draws: Draws | None = None) -> EnvState:
        """A freshly reset state of every env (what `reset` starts from)."""
        return self._reset_all(draws or self.draws())

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _locomotion_action(self, state: EnvState, commands, gait_override=None):
        """commands (E, A, 3) -> locomotion action (E, A, 12) + new clocks.

        gait_override: optional dict of per-env gait params ("phases",
        "offsets", "bounds", optionally "freq") as (E,) or (E, 1) tensors,
        for multi-gait locomotion training (learn/locomotion_env.py)."""
        cfg = self.cfg
        gp = self.gait_params_static
        E, A, dev = self.num_envs, self.num_agents, self.device

        def bc(v):
            if isinstance(v, torch.Tensor):
                return (v[:, None] if v.ndim == 1 else v).expand(E, A)
            return torch.full((E, A), float(v), device=dev)

        def g(name):
            if gait_override is not None and name in gait_override:
                return bc(gait_override[name])
            return bc(gp[name])

        phases, offsets, bounds = g("phases"), g("offsets"), g("bounds")
        gait_idx, idx, clock, _, _ = step_gait_clocks(
            state.gait_indices, self.dt, g("freq"), phases, offsets, bounds,
            bc(gp["duration"]),
        )
        idx_legs = idx[..., torch.as_tensor(CLOCK_TO_LEG, device=dev)]

        ag = state.phys.agents
        r, p, _ = quat_ops.get_euler_xyz_wrapped(ag.quat)
        yawq = quat_ops.yaw_quat(ag.quat)
        v_yaw = quat_ops.quat_rotate_inverse(yawq, ag.lin_vel)

        gait_arr = {k: bc(gp[k]) for k in (
            "duration", "swing_height", "stance_width", "stance_length", "body_height_delta")}
        gait_arr["freq"] = g("freq")
        loco_obs, loco_hist = self._fill_locomotion_obs(
            state, commands, clock,
            gait_pob=(phases, offsets, bounds) if gait_override else None)
        vel_int = state.vel_int
        if self.backend in ("trot", "residual") or self.body_policy is None:
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
            if self.backend == "residual" and self.body_policy is not None:
                # trained residual: model-based trot + learned correction
                action = action + self.body_policy(loco_obs)
        elif isinstance(self.body_policy, WalkTheseWaysBody):
            # the walk-these-ways stack: adaptation(hist) -> latent,
            # body(hist || latent) -> action (ref go1.py:400-407)
            latent = self.adaptation(loco_hist)
            action = self.body_policy(torch.cat([loco_hist, latent], dim=-1))
        else:
            # the trained obs70 body policy
            action = self.body_policy(loco_obs)
        clip_a = cfg.normalization.clip_actions
        action = torch.clamp(action, -clip_a, clip_a)
        return action, gait_idx, clock, loco_obs, loco_hist, vel_int

    def _fill_locomotion_obs(self, state: EnvState, commands, clock, gait_pob=None):
        """The 70-dim walk-these-ways obs (layout per ref go1.py:64-108,
        411-479) and the history rolled by it. gait_pob: optional (phases,
        offsets, bounds) (E, A) tensors in place of the config gait in obs
        dims 8-10 (multi-gait training)."""
        cfg = self.cfg
        sc = cfg.control.obs_scales
        dc = cfg.control.default_command
        ag = state.phys.agents
        E, A = self.num_envs, self.num_agents
        down = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand(ag.quat.shape[:-1] + (3,))
        g_body = quat_ops.quat_rotate_inverse(ag.quat, down)
        o = torch.zeros((E, A, 70), device=self.device)
        o[..., 0:3] = g_body
        o[..., 3] = commands[..., 0] * sc.lin_vel
        o[..., 4] = commands[..., 1] * sc.lin_vel
        o[..., 5] = commands[..., 2] * sc.ang_vel
        o[..., 6] = dc.body_height * sc.body_height
        o[..., 7] = dc.gait_freq * sc.gait_freq
        if gait_pob is not None:
            for i, v in enumerate(gait_pob):
                o[..., 8 + i] = v * sc.gait_phase
        else:
            gait = cfg.command.gaits[dc.gait]
            for i in range(3):
                o[..., 8 + i] = gait[i] * sc.gait_phase
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
        hist = state.loco_hist
        if self.hist_len > 0:
            hist = torch.cat([hist[..., 70:], o], dim=-1)
        return o, hist

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
        # the trot controller's supplementary joint PD: for the trot and
        # residual backends, and for `policy` only when asked for
        if self.backend in ("trot", "residual") or getattr(
                self.cfg.control, "policy_pd_augment", False):
            tau = tau - self.trot.TAU_KP * err - self.trot.TAU_KD * vel
        tau = tau * state.dr.motor_strength
        tau = torch.maximum(torch.minimum(tau, self.torque_limits), -self.torque_limits)
        new_hist = torch.stack([err, h[..., 0, :], vel, h[..., 2, :]], dim=-2)
        return tau, new_hist, lag, target

    def _physics(self, state: EnvState, tau):
        """One decimation substep: `subiters` scene substeps over the env batch.

        The default is scene.substep_batch (the SoA dynamics and its
        kernels); a scene with use_soa=False runs scene.substep, the AoS
        reference path (`env.scene = dataclasses.replace(env.scene,
        use_soa=False)`)."""
        phys = state.phys
        terrain = self._terrain_for(state.terrain_levels)
        sub = S.substep_batch if self.scene.use_soa else S.substep
        for _ in range(self.subiters):
            phys, contacts = sub(self.scene, terrain, phys, tau, state.dr,
                                 self.sim_dt / self.subiters)
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
        z_rel = ag.pos[..., 2] - self._origins_for(state.terrain_levels)[1][..., 2]
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
        origins = self._origins_for(state.terrain_levels)[0][:, None, :]  # (E, 1, 3)
        r, p, y = quat_ops.get_euler_xyz(ag.quat)
        down = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand(ag.quat.shape[:-1] + (3,))
        depth_img = rgb_img = None
        if self.cam_rays is not None:
            depth_img, rgb_img = self._render_cameras(state)
        if self.curriculum:
            lv = state.terrain_levels.to(torch.int64)
            env_info = {k: v[lv, self.env_cols_j] for k, v in self.grid_env_info.items()}
        else:
            env_info = self.env_info
        return ObsBuf(
            base_pos=ag.pos - origins,
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
            env_info=env_info,
            depth_image=depth_img,
            rgb_image=rgb_img,
        )

    def _render_cameras(self, state: EnvState):
        """Every robot's onboard depth/RGB image, all cameras in one batch
        (ref onboard camera sensors, legged_robot_field.py:23-93). The other
        actors are sphere impostors at their roots; each camera masks out
        its own robot. Returns (E, A, H, W) depth and (E, A, H, W, 3) RGB,
        each None when off."""
        ag = state.phys.agents
        E, A, N = self.num_envs, self.num_agents, self.num_npcs
        H, W = self.cam_res
        dev = self.device
        Rb = quat_ops.quat_to_matrix(ag.quat)                      # (E, A, 3, 3)
        cam_o = ag.pos + torch.einsum("eaij,j->eai", Rb, self.cam_offset)
        d_world = torch.einsum("eaij,rj->eari", Rb @ self.cam_rot, self.cam_rays)  # (E, A, R, 3)

        # sphere impostors: every agent and every NPC root
        cent = ag.pos                                              # (E, A, 3)
        rad = torch.full((E, A), self.cam_agent_radius, device=dev)
        if N > 0:
            cent = torch.cat([cent, state.phys.npcs.pos], dim=1)
            rad = torch.cat([rad, torch.full((E, N), self.cam_npc_radius, device=dev)], dim=1)
        valid = torch.ones((A, A + N), device=dev)
        valid[:, :A] -= torch.eye(A, device=dev)                   # (A, M): not its own robot
        spheres = torch.cat([cent[:, None].expand(E, A, A + N, 3),
                             rad[:, None, :, None].expand(E, A, A + N, 1),
                             valid[None, :, :, None].expand(E, A, A + N, 1)], dim=-1)  # (E, A, M, 5)

        boxes = self._terrain_for(state.terrain_levels).boxes      # (E, B, 7)
        sg = self.static_geoms
        if sg.shape[1]:
            # the fixture's rows as boxes, a cylinder's row invalid
            sg_boxes = torch.cat(
                [sg[:, :, 1:7], ((sg[:, :, 0] == S.SG_BOX) * sg[:, :, 7])[..., None]], dim=-1)
            boxes = torch.cat([boxes, sg_boxes], dim=1)

        depth, rgb = onboard.render(
            cam_o, d_world, boxes[:, None], spheres, self.cam_far,
            flat_height=self.scene.flat_height, hf=self.terrain.height,
            hf_origin=self.terrain.origin, hf_scale=self.terrain.scale, rgb=self.cam_rgb)
        depth_img = depth.reshape(E, A, H, W) if self.cam_depth else None
        rgb_img = rgb.reshape(E, A, H, W, 3) if self.cam_rgb else None
        return depth_img, rgb_img

    def _npc_script(self, state: EnvState, draws: Draws):
        """Scripted NPC dynamics at control rate: the sheep flee the dogs
        (ref go1_sheep.py:35-64). Returns the NPCs' new state, every field
        contiguous, as the kernels take it."""
        cfg = self.cfg
        N = self.num_npcs
        nc = state.phys.npcs
        dog = state.phys.agents.pos                       # (E, A, 3)
        sheep = nc.pos                                    # (E, N, 3)
        rnd = cfg.asset.sheep_movement_randomness
        dv = rnd * 2.0 * draws.normal("npc_noise", sheep.shape, self.device)
        if N != 1:
            rel = sheep.mean(dim=1, keepdim=True) - sheep
            dv = dv + rnd * rel / (torch.linalg.norm(rel, dim=-1, keepdim=True) + 1e-9) / 1.5
        scale = cfg.asset.sheep_movement_scale
        for i in range(self.num_agents):
            rel = sheep - dog[:, i:i + 1, :]
            # the reference's relative_pos_to_dv: dis is the norm of the
            # squared coordinates; rel / dis^1.4, zero beyond range
            # (go1_sheep.py:14-18)
            dis = torch.linalg.norm(rel ** 2, dim=-1)
            contrib = rel / (dis[..., None] ** 1.4 + 1e-9)
            contrib = torch.where((dis > 9.0)[..., None], 0.0, contrib)
            dv = dv + scale * contrib
        lin = nc.lin_vel[..., :2] + dv[..., :2]
        lin = torch.cat([torch.clamp(lin, -2.0, 2.0), nc.lin_vel[..., 2:]], dim=-1)
        pos = torch.cat([nc.pos[..., :2], torch.clamp(nc.pos[..., 2:], 0.0, 0.3)], dim=-1)
        quat = torch.cat([torch.zeros_like(nc.quat[..., :2]), nc.quat[..., 2:]], dim=-1)
        return replace(nc, lin_vel=lin, pos=pos, quat=quat_ops.quat_normalize(quat))

    def _defender_commands(self, state: EnvState):
        """Scripted football defender command (3rd agent), ref
        go1_football_defender.py:56-80. (E, 3)."""
        ag = state.phys.agents
        dpos = ag.pos[:, 2, :]                            # defender = 3rd agent
        ball = state.phys.npcs.pos[:, 0, :]
        gate = self.defender_gate
        target = 0.6 * ball + 0.4 * gate
        _, _, dyaw = quat_ops.get_euler_xyz_wrapped(ag.quat[:, 2])
        to_gate = gate - dpos
        # arctan of the ratio, as the reference has it, not atan2: the two
        # differ off the principal branch
        yaw_to_gate = math.pi + torch.atan(to_gate[:, 1] / (to_gate[:, 0] + 1e-9))
        yaw_cmd = torch.clamp(yaw_to_gate - dyaw, -0.3, 0.3) / 0.3
        tg_dist = torch.linalg.norm((target - gate)[:, :2], dim=-1)
        d_dist = torch.linalg.norm((dpos - gate)[:, :2], dim=-1)
        x_cmd = torch.clamp(tg_dist - d_dist, -0.5, 0.5)
        y_cmd = -torch.clamp(
            gate[:, 1]
            + (target[:, 1] - gate[:, 1]) * (dpos[:, 0] - gate[:, 0])
            / (target[:, 0] - gate[:, 0] + 1e-9)
            - dpos[:, 1],
            -0.5, 0.5,
        )
        return torch.stack([x_cmd, y_cmd, yaw_cmd], dim=-1)

    def _step_pre(self, state: EnvState, commands, draws: Draws):
        """Physics + termination, BEFORE the masked auto-reset.

        Returns the pre-reset state (done/term flags set) plus a carry for
        `_step_finish` (wrappers read task success on the pre-reset state)."""
        cfg = self.cfg
        E, A, dev = self.num_envs, self.num_agents, self.device
        if self.npc_behavior == "defender":
            # the wrapper commands the first A-1 robots; the script the last
            commands = torch.cat([commands, self._defender_commands(state)[:, None, :]], dim=1)
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

        if self.npc_behavior == "sheep" and self.num_npcs > 0:
            # scripted NPCs, at control rate (the reference's _step_npc)
            state = replace(state, phys=replace(state.phys, npcs=self._npc_script(state, draws)))

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
        """Curriculum + masked auto-reset + observations (post-reset half).
        Under the curriculum an env that solved the last level takes a
        random level, the draw named "curr_level"."""
        E = self.num_envs
        done, collide, r_term, p_term, timeout = carry

        # terrain curriculum: promote envs whose farthest agent crossed half
        # the track, demote envs that covered less than half the commanded
        # distance (ref _update_terrain_curriculum legged_robot.py:479-503)
        levels = state.terrain_levels
        if self.curriculum:
            eo_cur = self._origins_for(levels)[0]
            dist = torch.linalg.norm(
                state.phys.agents.pos[..., :2] - eo_cur[:, None, :2], dim=-1).amax(dim=-1)
            move_up = dist > self.curr_up_dist
            cmd_dist = (torch.linalg.norm(state.commands[..., :2], dim=-1).mean(-1)
                        * (self.max_episode_length * self.dt) * 0.5)
            move_down = (dist < cmd_dist) & ~move_up
            new_lv = levels + move_up.to(torch.int32) - move_down.to(torch.int32)
            # solved the last level -> random level (ref legged_robot.py:491-494)
            rand_lv = draws.integers("curr_level", (E,), 0, self.num_levels,
                                     self.device).to(torch.int32)
            new_lv = torch.where(new_lv >= self.num_levels, rand_lv, torch.clamp(new_lv, min=0))
            levels = torch.where(done, new_lv, levels)

        fresh = draws.state("fresh", lambda: self._reset_all(draws, levels))

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

    def load_locomotion_policy(self, policy):
        """Install a body policy: an obs70 -> action12 module (the trained
        `BodyPolicy`), or a `WalkTheseWaysBody`, which the `policy` backend
        runs behind the adaptation module over the 30-step history."""
        self.body_policy = policy

    @torch.no_grad()
    def step(self, state: EnvState, commands, draws: Draws | None = None):
        """One control step. commands: (E, A, 3), or (E, A - 1, 3) where the
        last robot is the scripted defender. A draw named "fresh" in `draws`
        is the reset state that done envs take; "npc_noise" the sheep
        script's normal draw; "curr_level" the curriculum's random level."""
        draws = draws or self.draws()
        state, carry = self._step_pre(state, commands, draws)
        return self._step_finish(state, carry, draws)
