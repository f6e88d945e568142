"""Task registry + factory (ref mqe/envs/utils.py:38-133).

Counterpart of `mqe_tpu/envs/registry.py`: the same 14 task names (the 13
reference tasks plus the unregistered door task), each a config and a
wrapper.
"""
from __future__ import annotations

from refsim.envs import tasks as T
from refsim.envs import wrappers as W
from refsim.envs.go1_env import Go1Env

ENV_DICT = {
    "go1plane": {"config": T.Go1PlaneCfg, "wrapper": W.EmptyWrapper},
    "go1gate": {"config": T.Go1GateCfg, "wrapper": W.Go1GateWrapper},
    "go1sheep-easy": {"config": T.SingleSheepCfg, "wrapper": W.Go1SheepWrapper},
    "go1sheep-hard": {"config": T.NineSheepCfg, "wrapper": W.Go1SheepWrapper},
    "go1football-defender": {"config": T.Go1FootballDefenderCfg,
                             "wrapper": W.Go1FootballDefenderWrapper},
    "go1football-1vs1": {"config": T.Go1Football1vs1Cfg, "wrapper": W.Go1FootballGameWrapper},
    "go1football-2vs2": {"config": T.Go1Football2vs2Cfg, "wrapper": W.Go1FootballGameWrapper},
    "go1seesaw": {"config": T.Go1SeesawCfg, "wrapper": W.Go1SeesawWrapper},
    "go1pushbox": {"config": T.Go1PushboxCfg, "wrapper": W.Go1PushboxWrapper},
    "go1tug": {"config": T.Go1TugCfg, "wrapper": W.Go1TugWrapper},
    "go1wrestling": {"config": T.Go1WrestlingCfg, "wrapper": W.Go1WrestlingWrapper},
    "go1revolvingdoor": {"config": T.Go1RotationCfg, "wrapper": W.Go1RotationWrapper},
    "go1bridge": {"config": T.Go1BridgeCfg, "wrapper": W.Go1BridgeWrapper},
    "go1door": {"config": T.Go1DoorCfg, "wrapper": W.Go1DoorWrapper},
}


def make_mqe_env(env_name: str, num_envs: int | None = None, seed: int = 0,
                 custom_cfg=None, device=None):
    """Build (wrapper, cfg) for a named task (ref mqe/envs/utils.py:111-121).

    device: where the env's tensors live; default `default_device()` (cuda).
    """
    entry = ENV_DICT[env_name]
    cfg = entry["config"]
    if callable(custom_cfg):
        cfg = custom_cfg(cfg)
    env = Go1Env(cfg, num_envs=num_envs, seed=seed, device=device)
    return entry["wrapper"](env), cfg
