"""Wrapper tests of go1bridge: `test_build_step_all` for it, then its golden
reward tests, which reuse the wrap `get_wrap` built and reset. The two layers
are described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, _move_agent, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_bridge.py"])
def test_build_step_all(task):
    wrap, ts, obs = get_wrap(task)
    A = getattr(wrap, "controlled_agents", wrap.num_agents)
    assert obs.shape == (2, A, wrap.obs_dim)
    acts = jnp.zeros((2, A, 3)).at[..., 0].set(0.5)
    ts2, obs2, rew, done, info = wrap.step(ts, acts, jax.random.PRNGKey(1))
    assert obs2.shape == (2, A, wrap.obs_dim)
    assert rew.shape == (2, A)
    assert done.shape == (2,)
    assert np.isfinite(np.asarray(obs2)).all()
    assert np.isfinite(np.asarray(rew)).all()
    for k, v in info["reward_terms"].items():
        assert np.asarray(v).shape == (2,), k  # per-env term values
        assert np.isfinite(np.asarray(v)).all(), k


def test_bridge_golden():
    wrap, ts, _ = get_wrap("go1bridge")
    s = wrap.scales
    env = wrap.env
    state = ts.env
    obs0 = obs_of(wrap, state)
    extra = wrap._extra_init(state, obs0)
    # opponent fell below the bridge -> success
    st = _move_agent(state, env, 1, dz=0.2)
    obs = obs_of(wrap, st)
    rew, _, _ = wrap._reward(st, obs, extra, None, no_reset_info())
    assert float(rew[0, 0]) >= s["success_reward_scale"] - 1e-4
    # self fell -> punishment
    st2 = _move_agent(state, env, 0, dz=0.2)
    rew2, _, _ = wrap._reward(st2, obs_of(wrap, st2), extra, None, no_reset_info())
    assert float(rew2[0, 0]) <= -s["punishment_scale"] + s["success_reward_scale"] * 0 + 1e-4
    # crossed to the opponent's start -> target reward
    tgt_x = float(extra["target"][0, 0, 0])
    ox, oy = float(env.env_origins[0, 0]), float(env.env_origins[0, 1])
    st3 = _move_agent(state, env, 0, world_xy=(ox + tgt_x + 0.2, oy))
    st3 = _move_agent(st3, env, 0, dz=0.6)
    rew3, _, _ = wrap._reward(st3, obs_of(wrap, st3), extra, None, no_reset_info())
    assert float(rew3[0, 0]) == pytest.approx(s["target_reward_scale"], abs=1e-4)
