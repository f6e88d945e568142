"""Config system: nested-class trees with inheritance, like the reference's
BaseConfig kernel (ref mqe/envs/base/base_config.py:38-55) but consumed as
STATIC data — configs are resolved to plain python values at env-build time.

A verbatim copy of `mqe_tpu/envs/config.py` (that package is the reference
and this one imports nothing of it); keep the two in step.

Class-attribute inheritance gives the same three-level specialization the
reference uses (base -> robot -> task, SURVEY.md §5 config section).
"""
from __future__ import annotations

import copy


def class_to_dict(obj) -> dict:
    """Recursively turn a nested-class config into plain dicts."""
    if not hasattr(obj, "__dict__") and not isinstance(obj, type):
        return obj
    result = {}
    for key in dir(obj):
        if key.startswith("_") or key in ("keys",):
            continue
        val = getattr(obj, key)
        if callable(val) and not isinstance(val, type):
            continue
        if isinstance(val, type):
            result[key] = class_to_dict(val)
        else:
            result[key] = val
    return result


def merge_dict(base: dict, update: dict) -> dict:
    """Non-destructive dict merge (ref mqe/utils/helpers.py:237-243)."""
    out = copy.deepcopy(base)
    out.update(copy.deepcopy(update))
    return out


class InitState:
    """One actor's initial state (pos + xyzw quat + twists)."""

    def __init__(self, pos=(0, 0, 1.0), rot=(0, 0, 0, 1.0), lin_vel=(0, 0, 0), ang_vel=(0, 0, 0)):
        self.pos = list(pos)
        self.rot = list(rot)
        self.lin_vel = list(lin_vel)
        self.ang_vel = list(ang_vel)


class Go1Cfg:
    """Base config for all go1 tasks (values mirror the reference defaults:
    ref mqe/envs/go1/go1_config.py + legged_robot_config.py)."""

    class env:
        env_name = "go1"
        num_envs = 256
        num_agents = 1
        num_npcs = 0
        num_actions_npc = 0
        episode_length_s = 5.0

    class sim:
        dt = 0.005          # reference PhysX substep (legged_robot_config.py:212)
        subiters = 2        # explicit-integration sub-iterations per substep
        gravity = (0.0, 0.0, -9.81)

    class terrain:
        mesh_type = "BarrierTrack"     # plane | BarrierTrack | heightfield | trimesh
        selected = "BarrierTrack"      # named terrain builder (BarrierTrack |
        #                                TerrainPerlin | Legacy)
        horizontal_scale = 0.025
        border_size = 1.0
        num_rows = 1
        num_cols = 1
        curriculum = False
        static_friction = 1.0
        dynamic_friction = 1.0
        x_init_range = 1.0   # plane-mode spawn jitter
        y_init_range = 1.0
        env_spacing = 3.0
        BarrierTrack_kwargs = dict(
            options=["init", "gate", "wall", "plane"],
            track_width=2.0,
            wall_thickness=0.04,
            wall=dict(block_length=3.0),
            plane=dict(block_length=3.0),
            init=dict(block_length=3.0, room_size=(1.0, 1.0), border_width=0.0, offset=(0, 0)),
            gate=dict(block_length=1.6, width=0.5, depth=0.1, offset=(0.4, 0), random=(0.0, 0.0)),
            wall_height=0.5,
            add_perlin_noise=False,
            border_perlin_noise=False,
            border_height=0.0,
            virtual_terrain=False,
            curriculum_perlin=False,
            no_perlin_threshold=0.06,
        )
        TerrainPerlin_kwargs = dict(zScale=0.12, frequency=10)

    class asset:
        name = "go1"
        model = "go1"                # mqe_tpu/assets/<model>.json
        foot_name = "foot"
        penalize_contacts_on = ("trunk", "thigh")
        terminate_after_contacts_on = ("trunk", "collision_box")
        npc_model = None             # assets json name for the NPC
        name_npc = ""
        npc_collision = True
        fix_npc_base_link = False
        npc_gravity = True
        static_model = None          # assets json with static geoms (bridge etc.)

    class init_state:
        pos = [0.0, 0.0, 0.42]
        rot = [0.0, 0.0, 0.0, 1.0]
        lin_vel = [0.0, 0.0, 0.0]
        ang_vel = [0.0, 0.0, 0.0]
        multi_init_state = False
        init_states: list = []
        init_states_npc: list = []
        default_npc_joint_angles: list = []
        # joint order FR,FL,RR,RL x hip,thigh,calf (go1.json joint order)
        default_joint_angles = {
            "FR_hip_joint": -0.1, "FR_thigh_joint": 0.8, "FR_calf_joint": -1.5,
            "FL_hip_joint": 0.1, "FL_thigh_joint": 0.8, "FL_calf_joint": -1.5,
            "RR_hip_joint": -0.1, "RR_thigh_joint": 1.0, "RR_calf_joint": -1.5,
            "RL_hip_joint": 0.1, "RL_thigh_joint": 1.0, "RL_calf_joint": -1.5,
        }

    class control:
        control_type = "C"           # P | V | T | C (command / hierarchical)
        stiffness = 20.0
        damping = 0.5
        action_scale = 0.25
        hip_scale_reduction = 0.5
        decimation = 4
        torque_limits = (20.0, 20.0, 25.0) * 4
        # locomotion backend: "residual" = model-based trot + trained RL
        # correction (assets/body_policy.npz, trained in-framework by
        # learn/train_locomotion.py; default — best command tracking),
        # "trot" = bare heuristic IK controller, "policy" = walk-these-ways
        # MLP stack (adaptation module + body policy, ref go1.py:389-409)
        locomotion_backend = "residual"
        # add the trot backend's supplementary joint PD to the actuator-net
        # torque path when running a trained body policy (must match between
        # training and deployment; the recovered-WTW-weights path keeps the
        # bare actuator net for reference parity, ref go1.py:315-354)
        policy_pd_augment = False

        class default_command:
            lin_vel_x = 1.0
            lin_vel_y = 0.0
            ang_vel = 0.0
            body_height = 0.0
            # reference default is 3.0 Hz (ref go1_config.py:141-155); 4.0
            # measured better-tracking/stable on the trot backend across the
            # command grid (tools/sweep_trot.py, BENCHLOG round 3) and is an
            # in-range walk-these-ways frequency command
            gait_freq = 4.0
            gait = "trotting"
            footswing_height = 0.08
            body_pitch = 0.0
            body_roll = 0.0
            stance_width = 0.25
            stance_length = 0.428
            aux_reward = 0.0

        class obs_scales:
            lin_vel = 2.0
            ang_vel = 0.25
            dof_pos = 1.0
            dof_vel = 0.05
            body_height = 2.0
            gait_phase = 1.0
            gait_freq = 1.0
            footswing_height = 0.15
            body_pitch = 0.3
            body_roll = 0.3
            aux_reward = 1.0
            stance_width = 1.0
            stance_length = 1.0

    class command:
        gaits = {
            "pronking": [0, 0, 0],
            "trotting": [0.5, 0, 0],
            "bounding": [0, 0.5, 0],
            "pacing": [0, 0, 0.5],
        }

        class cfg:
            vel = False
            body_height = False
            body_pose = False
            gait_freq = False
            gait = False
            footswing_height = False
            stance_width = False
            stance_length = False
            aux_reward = False

    class termination:
        termination_terms = ["roll", "pitch", "z_low", "z_high"]
        roll_kwargs = dict(threshold=0.8)
        pitch_kwargs = dict(threshold=1.6)
        z_low_kwargs = dict(threshold=0.08)
        z_high_kwargs = dict(threshold=1.5)

    class domain_rand:
        randomize_friction = False
        friction_range = [0.05, 4.5]
        randomize_base_mass = False
        added_mass_range = [-1.0, 3.0]
        randomize_com = False
        com_range = dict(x=[-0.05, 0.15], y=[-0.1, 0.1], z=[-0.05, 0.05])
        randomize_motor = False
        leg_motor_strength_range = [0.9, 1.1]
        push_robots = False
        push_interval_s = 15.0
        max_push_vel_xy = 1.0
        init_base_pos_range = dict(x=[0.1, 0.1], y=[-0.1, 0.1])
        init_base_vel_range = [-0.5, 0.5]
        init_dof_pos_ratio_range = [0.7, 1.3]
        init_npc_base_pos_range = dict(x=[-0.2, 0.2], y=[-0.2, 0.2])
        # action-lag DR (ref go1_config.py:232-233): joint-position targets
        # delayed by lag_timesteps physics substeps when enabled
        randomize_lag_timesteps = False
        lag_timesteps = 6

    class rewards:
        class scales:
            pass

    class obs:
        class cfgs:
            base_pos = True
            base_quat = True
            base_rpy = True
            dof_pos = True
            dof_vel = True
            lin_vel = True
            ang_vel = True
            projected_gravity = True
            last_action = True
            last_last_action = True
            clock_inputs = False
            env_info = True
            # onboard forward camera (ref legged_robot_field_config.py:72-77;
            # dead in all 13 predefined tasks, available here for parity)
            depth_image = False
            rgb_image = False

        class scales:
            base_pos = 1.0
            base_quat = 1.0

    class normalization:
        clip_actions = 10.0
        clip_observations = 100.0
        # ref legged_robot_field.py:96-115: "hard" | "tanh"; delta rate-limits
        # the command against the previous step's (None = off)
        clip_actions_method = "hard"
        clip_actions_delta = None

        class obs_scales:
            lin_vel = 2.0
            ang_vel = 0.25
            dof_pos = 1.0
            dof_vel = 0.05

    class sensor:
        # ref legged_robot_field_config.py:72-77 (+ isaacgym's default 90deg
        # horizontal fov); far/near are our analytic-raycaster clip range
        class forward_camera:
            resolution = [16, 16]
            position = [0.26, 0.0, 0.03]   # in base_link
            rotation = [0.0, 0.0, 0.0]     # ZYX euler in base_link
            horizontal_fov = 90.0
            near = 0.05
            far = 4.0

    class physx:
        # contact model tuning (TPU penalty-contact replacement for the
        # reference's PhysX solver block, legged_robot_config.py:218-229)
        kn = 4000.0
        hc_damping = 3.0
        v_slip = 0.05
        f_max = 500.0


def default_joint_array(cfg) -> list:
    """default_joint_angles dict -> array in go1 DOF order."""
    order = [
        "FR_hip_joint", "FR_thigh_joint", "FR_calf_joint",
        "FL_hip_joint", "FL_thigh_joint", "FL_calf_joint",
        "RR_hip_joint", "RR_thigh_joint", "RR_calf_joint",
        "RL_hip_joint", "RL_thigh_joint", "RL_calf_joint",
    ]
    d = cfg.init_state.default_joint_angles
    return [d[k] for k in order]
