"""Wrapper tests of go1revolvingdoor: `test_build_step_all` for it, then its golden
reward tests, which reuse the wrap `get_wrap` built and reset. The two layers
are described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, _move_agent, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_revolvingdoor.py"])
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


def test_rotation_golden():
    wrap, ts, _ = get_wrap("go1revolvingdoor")
    s = wrap.scales
    env = wrap.env
    state = ts.env
    tx = wrap._target_x()
    ox, oy = float(env.env_origins[0, 0]), float(env.env_origins[0, 1])
    st = _move_agent(state, env, 0, world_xy=(ox + tx + 0.3, oy))
    obs = obs_of(wrap, st)
    extra = wrap._extra_init(st, obs)
    rew, _, _ = wrap._reward(st, obs, extra, None, no_reset_info())
    # agent 0 past target: success; distance reward can't fire (fresh extra)
    assert float(rew[0, 0]) == pytest.approx(s["success_reward_scale"], abs=1e-5)
    # opponent past target: punishment
    st2 = _move_agent(state, env, 1, world_xy=(ox + tx + 0.3, oy))
    obs2 = obs_of(wrap, st2)
    rew2, _, _ = wrap._reward(st2, obs2, wrap._extra_init(st2, obs2), None, no_reset_info())
    assert float(rew2[0, 0]) == pytest.approx(-s["punishment_scale"], abs=1e-5)
    # distance reward: moved closer than last_dis
    extra3 = wrap._extra_init(state, obs_of(wrap, state))
    extra3 = {**extra3, "last_dis": extra3["last_dis"] + 1.0}
    rew3, _, _ = wrap._reward(state, obs_of(wrap, state), extra3, None, no_reset_info())
    assert float(rew3[0, 0]) == pytest.approx(s["distance_reward_scale"], abs=1e-5)
