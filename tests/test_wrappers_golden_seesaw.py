"""Wrapper tests of go1seesaw: `test_build_step_all` for it, then its golden
reward tests, which reuse the wrap `get_wrap` built and reset. The two layers
are described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_seesaw.py"])
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


def test_seesaw_golden():
    wrap, ts, _ = get_wrap("go1seesaw")
    env, s = wrap.env, wrap.scales
    state = ts.env
    obs = obs_of(wrap, state)
    extra = wrap._extra_init(state, obs)
    # x movement: +0.2 each agent -> dx.sum = 0.4 (shared)
    ag = state.phys.agents
    st = state.replace(
        phys=state.phys.replace(agents=ag.replace(pos=ag.pos.at[..., 0].add(0.2)))
    )
    obs2 = obs_of(wrap, st)
    rew, _, terms = wrap._reward(st, obs2, extra, None, no_reset_info())
    z = np.asarray(obs2.base_pos[..., 2])
    y = np.asarray(obs2.base_pos[..., 1])
    exp = (
        s["x_movement_reward_scale"] * 0.4
        + s["height_reward_scale"] * (z.sum(axis=1) - 0.56)
        + s["y_punishment_scale"] * ((y ** 2).sum(axis=1) - 0.5)
    )
    np.testing.assert_allclose(np.asarray(rew)[:, 0], exp, rtol=1e-4, atol=1e-5)
    # fall punishment
    st2 = st.replace(r_term=jnp.array([True, False]))
    rew2, _, _ = wrap._reward(st2, obs2, wrap._extra_init(st2, obs2), None, no_reset_info())
    base, _, _ = wrap._reward(st, obs2, wrap._extra_init(st, obs2), None, no_reset_info())
    assert float(rew2[0, 0] - base[0, 0]) == pytest.approx(s["fall_punishment_scale"], abs=1e-5)
