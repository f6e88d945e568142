"""Wrapper tests of go1football-1vs1: `test_build_step_all` for it, then its golden
reward tests, which reuse the wrap `get_wrap` built and reset. The two layers
are described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_football_1vs1.py"])
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


def test_football_game_zero_sum_golden():
    wrap, ts, _ = get_wrap("go1football-1vs1")
    s = wrap.scales
    state = ts.env
    bt = wrap.bt
    gx_right = bt["init"]["block_length"] + bt["gate"]["block_length"] + bt["plane"]["block_length"]
    npcs = state.phys.npcs
    ox = wrap.env.env_origins[:, 0]
    st = state.replace(
        phys=state.phys.replace(
            npcs=npcs.replace(pos=npcs.pos.at[:, 0, 0].set(ox + gx_right + 0.5))
        )
    )
    rew, _, _ = wrap._reward(st, obs_of(wrap, st), {}, None, no_reset_info())
    g = s.get("goal_reward_scale", 10)
    assert float(rew[0, 0]) == pytest.approx(g)
    assert float(rew[0, 1]) == pytest.approx(-g)  # zero-sum
