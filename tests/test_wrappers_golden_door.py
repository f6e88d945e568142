"""Wrapper test of go1door: `test_build_step_all` for it. The two layers are
described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, get_wrap


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_door.py"])
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
