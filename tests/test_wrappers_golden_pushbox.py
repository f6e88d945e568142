"""Wrapper tests of go1pushbox: `test_build_step_all` for it, then its golden
reward tests, which reuse the wrap `get_wrap` built and reset. The two layers
are described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_pushbox.py"])
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


def test_pushbox_golden():
    wrap, ts, _ = get_wrap("go1pushbox")
    s = wrap.scales
    state = ts.env
    obs = obs_of(wrap, state)
    extra = wrap._extra_init(state, obs)
    # move the box +0.3 x
    npcs = state.phys.npcs
    st = state.replace(
        phys=state.phys.replace(npcs=npcs.replace(pos=npcs.pos.at[:, 0, 0].add(0.3)))
    )
    rew, _, terms = wrap._reward(st, obs_of(wrap, st), extra, None, no_reset_info())
    exp = s["box_x_movement_reward_scale"] * 0.3
    np.testing.assert_allclose(np.asarray(rew), exp, rtol=1e-4)
    # reward is zeroed across resets (ref go1_pushbox_wrapper.py:75)
    info = no_reset_info()
    info["reset_mask"] = jnp.array([True, False])
    rew2, _, _ = wrap._reward(st, obs_of(wrap, st), extra, None, info)
    assert float(rew2[0, 0]) == pytest.approx(0.0, abs=1e-6)
    assert float(rew2[1, 0]) == pytest.approx(exp, rel=1e-4)
