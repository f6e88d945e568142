"""Task configs for the 13 predefined environments.

Values mirror the reference task configs (ref mqe/envs/configs/*.py) — layout,
agent/NPC counts, terrain block lists, init states, termination terms, reward
scales — expressed over our config tree.

A copy of `mqe_tpu/envs/tasks.py` with its import re-pointed; keep the two
in step.
"""
from __future__ import annotations

from refsim.envs.config import Go1Cfg, InitState, merge_dict

BT = Go1Cfg.terrain.BarrierTrack_kwargs


def _two_agents(z=0.42):
    return [InitState(pos=[0, 0, z]), InitState(pos=[0, 0, z])]


class Go1PlaneCfg(Go1Cfg):
    """Single go1 on a flat plane (ref go1_plane_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1plane"
        num_envs = 25
        num_agents = 1
        episode_length_s = 20

    class terrain(Go1Cfg.terrain):
        mesh_type = "plane"
        x_init_range = 1.0
        y_init_range = 1.0


class Go1GateCfg(Go1Cfg):
    """Two agents pass a narrow gate cooperatively (ref go1_gate_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1gate"
        num_envs = 256
        num_agents = 2
        episode_length_s = 10

    class terrain(Go1Cfg.terrain):
        num_rows = 4
        num_cols = 4
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "gate", "plane", "wall"],
            track_width=3.0,
            init=dict(block_length=2.0, room_size=(1.0, 1.5), border_width=0.0, offset=(0, 0)),
            gate=dict(block_length=3.0, width=0.6, depth=0.1, offset=(0, 0), random=(0.5, 0.5)),
            plane=dict(block_length=1.0),
            wall=dict(block_length=0.1),
            wall_height=0.5,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = _two_agents()

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch", "z_low", "z_high"]

    class domain_rand(Go1Cfg.domain_rand):
        init_base_pos_range = None

    class rewards(Go1Cfg.rewards):
        class scales:
            target_reward_scale = 1
            success_reward_scale = 5
            agent_distance_punishment_scale = -0.025
            contact_punishment_scale = -2


class _SheepBase(Go1Cfg):
    class asset(Go1Cfg.asset):
        npc_model = "sheep"
        name_npc = "sheep"
        npc_behavior = "sheep"
        num_rows = 1
        num_cols = 1
        dis_sheep = (1.5, 1.5)
        sheep_movement_scale = 0.2
        sheep_movement_randomness = 0.0
        sheep_movement_range = (2.0, 2.0, 0)
        terminate_after_contacts_on = ("trunk", "collision_box")

    class command(Go1Cfg.command):
        pass

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = _two_agents()

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch"]

    class domain_rand(Go1Cfg.domain_rand):
        init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])
        init_npc_base_pos_range = dict(x=[-0.3, 0.3], y=[-0.3, 0.3])


class SingleSheepCfg(_SheepBase):
    """2 dogs herd 1 sheep through a gate (ref go1_sheep_config.py:5-130)."""

    class env(Go1Cfg.env):
        env_name = "go1sheep"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        episode_length_s = 15

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "plane", "gate", "plane", "wall"],
            track_width=4.0,
            init=dict(block_length=1.5, room_size=(1.0, 1.95), border_width=0.0, offset=(0.5, 0)),
            gate=dict(block_length=1.0, width=0.8, depth=0.1, offset=(0, 0), random=(0, 0.5)),
            plane=dict(block_length=3.0),
            wall=dict(block_length=0.1),
            wall_height=0.5,
            add_perlin_noise=False,
        ))

    class rewards(Go1Cfg.rewards):
        class scales:
            success_reward_scale = 1
            contact_punishment_scale = 0
            sheep_movement_reward_scale = 2
            mixed_sheep_reward_scale = 0
            sheep_pos_var_exp_punishment_scale = 0
            sheep_pos_var_lin_punishment_scale = 0


class NineSheepCfg(_SheepBase):
    """2 dogs herd a 3x3 flock (ref go1_sheep_config.py:132-256)."""

    class env(Go1Cfg.env):
        env_name = "go1sheep"
        num_envs = 64
        num_agents = 2
        num_npcs = 9
        episode_length_s = 15

    class asset(_SheepBase.asset):
        num_rows = 3
        num_cols = 3
        sheep_movement_randomness = 0.1

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "plane", "gate", "plane", "wall"],
            track_width=6.0,
            init=dict(block_length=2.0, room_size=(1.0, 3.0), border_width=0.0, offset=(0.5, 0)),
            gate=dict(block_length=1.0, width=1.5, depth=0.1, offset=(0, 0), random=(0, 1)),
            plane=dict(block_length=6.0),
            wall=dict(block_length=0.1),
            wall_height=0.5,
            add_perlin_noise=False,
        ))

    class rewards(Go1Cfg.rewards):
        class scales:
            success_reward_scale = 0
            contact_punishment_scale = 0
            sheep_movement_reward_scale = 0
            mixed_sheep_reward_scale = 1
            sheep_pos_var_exp_punishment_scale = 0
            sheep_pos_var_lin_punishment_scale = 0


class Go1FootballDefenderCfg(Go1Cfg):
    """2 attackers + 1 scripted defender + ball (ref go1_football_config.py:5-132)."""

    class env(Go1Cfg.env):
        env_name = "go1football"
        num_envs = 128
        num_agents = 3
        num_npcs = 1
        episode_length_s = 20

    class asset(Go1Cfg.asset):
        npc_model = "ball"
        name_npc = "ball"
        npc_behavior = "defender"
        terminate_after_contacts_on = ()

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "gate", "plane", "gate", "wall"],
            track_width=9.0,
            init=dict(block_length=1.0, room_size=(0, 3.0), border_width=0.0, offset=(0.5, 0)),
            plane=dict(block_length=10.0),
            gate=dict(block_length=1.0, width=2.0, depth=1.0, offset=(0, 0), random=(0, 0)),
            wall=dict(block_length=0.1),
            wall_height=1.0,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = [
            InitState(pos=[3.0, 1.0, 0.42]),
            InitState(pos=[3.0, 2.0, 0.42]),
            InitState(pos=[9.0, -3.0, 0.42], rot=[0, 0, 1.0, 0.0]),
        ]
        init_states_npc = [InitState(pos=[5.0, -2.1, 0.3])]

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch"]

    class domain_rand(Go1Cfg.domain_rand):
        init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])

    class rewards(Go1Cfg.rewards):
        class scales:
            goal_reward_scale = 10
            ball_gate_distance_reward_scale = 3


class Go1Football1vs1Cfg(Go1FootballDefenderCfg):
    """1v1 football (reference wrapper is scaffolding; completed here)."""

    class env(Go1Cfg.env):
        env_name = "go1football"
        num_envs = 128
        num_agents = 2
        num_npcs = 1
        episode_length_s = 20

    class asset(Go1FootballDefenderCfg.asset):
        npc_behavior = "none"

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = [
            InitState(pos=[3.0, 0.0, 0.42]),
            InitState(pos=[9.0, 0.0, 0.42], rot=[0, 0, 1.0, 0.0]),
        ]
        init_states_npc = [InitState(pos=[6.0, 0.0, 0.3])]

    class rewards(Go1Cfg.rewards):
        class scales:
            goal_reward_scale = 10


class Go1Football2vs2Cfg(Go1Football1vs1Cfg):
    class env(Go1Cfg.env):
        env_name = "go1football"
        num_envs = 64
        num_agents = 4
        num_npcs = 1
        episode_length_s = 20

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = [
            InitState(pos=[3.0, 1.5, 0.42]),
            InitState(pos=[3.0, -1.5, 0.42]),
            InitState(pos=[9.0, 1.5, 0.42], rot=[0, 0, 1.0, 0.0]),
            InitState(pos=[9.0, -1.5, 0.42], rot=[0, 0, 1.0, 0.0]),
        ]
        init_states_npc = [InitState(pos=[6.0, 0.0, 0.3])]


class Go1SeesawCfg(Go1Cfg):
    """Two agents ride a seesaw plank up a height step (ref go1_seesaw_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1seesaw"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        num_actions_npc = 1
        episode_length_s = 10

    class asset(Go1Cfg.asset):
        npc_model = "seesaw"
        name_npc = "seesaw"
        fix_npc_base_link = True

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "plane", "wall"],
            track_width=3.0,
            init=dict(block_length=2.0, room_size=(1.0, 1.5), border_width=0.0, offset=(0, 0)),
            plane=dict(block_length=8.0),
            wall=dict(block_length=0.1),
            wall_height=0.5,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = _two_agents()
        init_states_npc = [InitState(pos=[8.0, 0.0, 1.0])]
        default_npc_joint_angles = [-0.2]

    class control(Go1Cfg.control):
        class default_command(Go1Cfg.control.default_command):
            gait = "pacing"

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch", "z_low"]

    class domain_rand(Go1Cfg.domain_rand):
        init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])
        init_npc_base_pos_range = None

    class obs(Go1Cfg.obs):
        class cfgs(Go1Cfg.obs.cfgs):
            env_info = False

    class rewards(Go1Cfg.rewards):
        class scales:
            height_reward_scale = 1
            success_reward_scale = 10
            contact_punishment_scale = -2
            agent_distance_punishment_scale = -0.25
            x_movement_reward_scale = 5
            fall_punishment_scale = -2
            y_punishment_scale = -0.5


class Go1PushboxCfg(Go1Cfg):
    """Push a 1m box through a gate (ref go1_pushbox_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1pushbox"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        episode_length_s = 15

    class asset(Go1Cfg.asset):
        npc_model = "box"
        name_npc = "box"
        terminate_after_contacts_on = ()

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "gate", "wall"],
            track_width=5.0,
            init=dict(block_length=2.0, room_size=(1.0, 2.5), border_width=0.0, offset=(0, 0)),
            gate=dict(block_length=5.0, width=1.5, depth=0.1, offset=(0, 0), random=(0, 0.5)),
            wall=dict(block_length=0.1),
            wall_height=0.5,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = _two_agents()
        init_states_npc = [InitState(pos=[2.5, 0.0, 0.6])]

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch"]

    class domain_rand(Go1Cfg.domain_rand):
        init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])
        init_npc_base_pos_range = dict(x=[-0.5, 0.5], y=[-0.5, 0.5])

    class rewards(Go1Cfg.rewards):
        class scales:
            box_x_movement_reward_scale = 10


class Go1TugCfg(Go1Cfg):
    """Competitive tug: pull the shared disc to your side (ref go1_tug_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1tug"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        num_actions_npc = 1
        episode_length_s = 15

    class asset(Go1Cfg.asset):
        npc_model = "cylinder"
        name_npc = "circular"
        fix_npc_base_link = True
        terminate_after_contacts_on = ()

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "wall", "plane", "wall"],
            track_width=6.0,
            init=dict(block_length=0.0, room_size=(0.0, 0.0), border_width=0.0, offset=(0, 0)),
            plane=dict(block_length=3.0),
            wall=dict(block_length=0.1),
            wall_height=1.0,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = [
            InitState(pos=[1.6, 2.5, 0.34], rot=[0, 0, -1.0, 1.0]),
            InitState(pos=[1.6, -2.5, 0.34], rot=[0, 0, 1.0, 1.0]),
        ]
        init_states_npc = [InitState(pos=[1.6, 0.0, 0.0])]

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch", "z_low", "z_high"]

    class domain_rand(Go1Cfg.domain_rand):
        init_dof_pos_ratio_range = None
        init_base_pos_range = dict(x=[-1.0, 1.0], y=[-0.0, 0.0])
        init_npc_base_pos_range = None

    class rewards(Go1Cfg.rewards):
        class scales:
            success_reward_scale = 10
            punishment_reward_scale = 10
            pos_reward_scale = 2
            pos_punishment_scale = 2


class Go1WrestlingCfg(Go1Cfg):
    """Competitive wrestling on a circular ring (ref go1_wrestling_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1wrestling"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        episode_length_s = 15

    class asset(Go1Cfg.asset):
        npc_model = "ball"          # anchor only; collision from static ring
        name_npc = "wrestling"
        fix_npc_base_link = True
        static_model = "wrestling"
        terminate_after_contacts_on = ()

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "plane"],
            track_width=6.0,
            init=dict(block_length=0.0, room_size=(0.0, 0.0), border_width=0.0, offset=(0, 0)),
            plane=dict(block_length=7.0),
            wall=dict(block_length=0.1),
            wall_height=0.001,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = [
            InitState(pos=[3.1, 1.0, 0.74], rot=[0, 0, -1.0, 1.0]),
            InitState(pos=[3.1, -1.0, 0.74], rot=[0, 0, 1.0, 1.0]),
        ]
        init_states_npc = [InitState(pos=[3.1, 0.0, 0.0])]

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch", "z_low"]
        z_low_kwargs = dict(threshold=0.3)

    class domain_rand(Go1Cfg.domain_rand):
        init_dof_pos_ratio_range = None
        init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])
        init_npc_base_pos_range = None

    class rewards(Go1Cfg.rewards):
        class scales:
            punishment_scale = 1
            success_reward_scale = 10


class Go1RotationCfg(Go1Cfg):
    """Push through a revolving door (ref go1_rotation_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1rotation"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        num_actions_npc = 1
        episode_length_s = 5

    class asset(Go1Cfg.asset):
        npc_model = "rotation_door"
        name_npc = "rotation"
        fix_npc_base_link = True
        terminate_after_contacts_on = ()

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "wall", "gate", "wall"],
            track_width=3.5,
            init=dict(block_length=0.0, room_size=(0.0, 0.0), border_width=0.0, offset=(0, 0)),
            gate=dict(block_length=5.0, width=2.0, depth=0.1, offset=(0, 0), random=(0, 0)),
            rotation=dict(block_length=5.0, depth=0.1, offset=(0, 0), wide_px=(0.84, 0.2)),
            wall=dict(block_length=0.1),
            wall_height=0.85,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = [
            InitState(pos=[0.5, -1.0, 0.42]),
            InitState(pos=[0.5, 1.0, 0.42]),
        ]
        init_states_npc = [InitState(pos=[2.59, -0.01, 0.04])]

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch", "z_low", "z_high"]

    class domain_rand(Go1Cfg.domain_rand):
        init_base_pos_range = None
        init_npc_base_pos_range = None

    class rewards(Go1Cfg.rewards):
        class scales:
            punishment_scale = 1
            success_reward_scale = 5
            distance_reward_scale = 1


class Go1BridgeCfg(Go1Cfg):
    """Competitive: cross a narrow bridge, push the opponent off
    (ref go1_bridge_config.py)."""

    class env(Go1Cfg.env):
        env_name = "go1bridge"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        episode_length_s = 20

    class asset(Go1Cfg.asset):
        npc_model = "ball"          # anchor; collision via static bridge geoms
        name_npc = "bridge"
        fix_npc_base_link = True
        static_model = "bridge"
        terminate_after_contacts_on = ()

    class terrain(Go1Cfg.terrain):
        num_rows = 2
        num_cols = 2
        BarrierTrack_kwargs = merge_dict(BT, dict(
            options=["init", "wall", "plane", "wall"],
            track_width=6.0,
            init=dict(block_length=0.5, room_size=(0.0, 0.0), border_width=0.0, offset=(0, 0)),
            plane=dict(block_length=10.0),
            wall=dict(block_length=0.1),
            wall_height=0.01,
            add_perlin_noise=False,
        ))

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = [
            InitState(pos=[2.0, 0.0, 1.4]),
            InitState(pos=[7.5, 0.0, 1.4], rot=[0, 0, 1.0, 0.0]),
        ]
        init_states_npc = [InitState(pos=[5.0, 0.0, 0.72])]

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch", "z_low"]
        z_low_kwargs = dict(threshold=0.3)

    class domain_rand(Go1Cfg.domain_rand):
        init_dof_pos_ratio_range = None
        init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])
        init_npc_base_pos_range = None

    class rewards(Go1Cfg.rewards):
        class scales:
            target_reward_scale = 1
            punishment_scale = 1
            success_reward_scale = 10


class Go1DoorCfg(Go1Cfg):
    """Push-open door task (present but unregistered in the reference,
    ref go1_door_config.py + ENV_DICT comment mqe/envs/utils.py:104-108)."""

    class env(Go1Cfg.env):
        env_name = "go1door"
        num_envs = 256
        num_agents = 2
        num_npcs = 1
        num_actions_npc = 1
        episode_length_s = 15

    class asset(Go1Cfg.asset):
        npc_model = "door"
        name_npc = "door"
        fix_npc_base_link = True
        terminate_after_contacts_on = ()

    class terrain(Go1PushboxCfg.terrain):
        pass

    class init_state(Go1Cfg.init_state):
        multi_init_state = True
        init_states = _two_agents()
        init_states_npc = [InitState(pos=[2.5, 0.0, 0.0])]

    class termination(Go1Cfg.termination):
        termination_terms = ["roll", "pitch"]

    class rewards(Go1Cfg.rewards):
        class scales:
            success_reward_scale = 5
            target_reward_scale = 1
