"""Task registry + factory (ref mqe/envs/utils.py:38-133).

Counterpart of `mqe_tpu/envs/registry.py`. The port runs go1plane, go1gate,
go1pushbox and go1seesaw so far; the other tasks of the JAX package raise
NotImplementedError naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from mqe_tpu_torch.envs import tasks as T
from mqe_tpu_torch.envs import wrappers as W
from mqe_tpu_torch.envs.go1_env import Go1Env

ENV_DICT = {
    "go1plane": {"config": T.Go1PlaneCfg, "wrapper": W.EmptyWrapper},
    "go1gate": {"config": T.Go1GateCfg, "wrapper": W.Go1GateWrapper},
    "go1seesaw": {"config": T.Go1SeesawCfg, "wrapper": W.Go1SeesawWrapper},
    "go1pushbox": {"config": T.Go1PushboxCfg, "wrapper": W.Go1PushboxWrapper},
}

# tasks of mqe_tpu/envs/registry.py not ported yet -> ROADMAP Queue A item
NOT_PORTED = {
    name: "ROADMAP Queue A item 11 (NPC scripts, static fixtures and task wrappers)"
    for name in (
        "go1sheep-easy", "go1sheep-hard", "go1football-defender", "go1football-1vs1",
        "go1football-2vs2", "go1tug", "go1wrestling", "go1revolvingdoor", "go1bridge",
        "go1door",
    )
}


def make_mqe_env(env_name: str, num_envs: int | None = None, seed: int = 0,
                 custom_cfg=None, device=None):
    """Build (wrapper, cfg) for a named task (ref mqe/envs/utils.py:111-121).

    device: where the env's tensors live; default `default_device()` (cuda).
    """
    if env_name in NOT_PORTED:
        raise NotImplementedError(f"{env_name} is not ported yet: {NOT_PORTED[env_name]}")
    entry = ENV_DICT[env_name]
    cfg = entry["config"]
    if callable(custom_cfg):
        cfg = custom_cfg(cfg)
    env = Go1Env(cfg, num_envs=num_envs, seed=seed, device=device)
    return entry["wrapper"](env), cfg
