"""The helpers of the per-task wrapper tests, tests/test_wrappers_golden*.py,
and `BUILD_TASKS`, the task each file's `test_build_step_all` takes."""
import jax
import jax.numpy as jnp

from mqe_tpu.envs import ENV_DICT, make_mqe_env

ALL_TASKS = sorted(ENV_DICT.keys())

# the tasks of each file's `test_build_step_all`
BUILD_TASKS = {
    "test_wrappers_golden_bridge.py": ("go1bridge",),
    "test_wrappers_golden_door.py": ("go1door",),
    "test_wrappers_golden_football_1vs1.py": ("go1football-1vs1",),
    "test_wrappers_golden_football_2vs2.py": ("go1football-2vs2",),
    "test_wrappers_golden_football_defender.py": ("go1football-defender",),
    "test_wrappers_golden.py": ("go1gate",),
    "test_wrappers_golden_plane.py": ("go1plane",),
    "test_wrappers_golden_pushbox.py": ("go1pushbox",),
    "test_wrappers_golden_revolvingdoor.py": ("go1revolvingdoor",),
    "test_wrappers_golden_seesaw.py": ("go1seesaw",),
    "test_wrappers_golden_sheep_easy.py": ("go1sheep-easy",),
    "test_wrappers_golden_sheep_hard.py": ("go1sheep-hard",),
    "test_wrappers_golden_tug.py": ("go1tug",),
    "test_wrappers_golden_wrestling.py": ("go1wrestling",),
}

_CACHE = {}


def get_wrap(task, num_envs=2):
    if task not in _CACHE:
        wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0)
        ts, obs = wrap.reset(jax.random.PRNGKey(0))
        _CACHE[task] = (wrap, ts, obs)
    return _CACHE[task]


def no_reset_info(E=2):
    return {
        "reset_mask": jnp.zeros(E, dtype=bool),
        "time_outs": jnp.zeros(E, dtype=bool),
    }


def obs_of(wrap, state):
    return wrap.env._observations(state)


def _move_agent(state, env, idx, world_xy=None, dz=None, rpy=None):
    """Return a state with agent idx teleported (world coordinates)."""
    ag = state.phys.agents
    pos = ag.pos
    if world_xy is not None:
        pos = pos.at[:, idx, 0].set(world_xy[0]).at[:, idx, 1].set(world_xy[1])
    if dz is not None:
        pos = pos.at[:, idx, 2].set(dz)
    ag = ag.replace(pos=pos)
    if rpy is not None:
        from mqe_tpu.ops import quat as qo

        r, p, y = rpy
        q = qo.quat_from_euler_xyz(jnp.array(r), jnp.array(p), jnp.array(y))
        ag = ag.replace(quat=ag.quat.at[:, idx].set(q))
    return state.replace(phys=state.phys.replace(agents=ag))
