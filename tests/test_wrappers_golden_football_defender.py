"""Wrapper tests of go1football-defender: `test_build_step_all` for it, then its golden
reward tests, which reuse the wrap `get_wrap` built and reset. The two layers
are described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_football_defender.py"])
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


def test_football_defender_golden():
    wrap, ts, _ = get_wrap("go1football-defender")
    s = wrap.scales
    state = ts.env
    gate = np.asarray(wrap._gate(state))
    # put the ball past the goal line
    npcs = state.phys.npcs
    ox = wrap.env.env_origins[:, 0]
    st = state.replace(
        phys=state.phys.replace(
            npcs=npcs.replace(pos=npcs.pos.at[:, 0, 0].set(ox + gate[0] + 0.5))
        )
    )
    obs = obs_of(wrap, st)
    rew, _, terms = wrap._reward(st, obs, {}, None, no_reset_info())
    ball = np.asarray(wrap._ball(st))
    d = np.linalg.norm(ball[:, :2] - gate[None, :], axis=-1)
    exp = s["goal_reward_scale"] + s["ball_gate_distance_reward_scale"] * np.exp(-d / 3)
    np.testing.assert_allclose(np.asarray(rew)[:, 0], exp, rtol=1e-4)
    assert rew.shape == (2, 2)  # defender (3rd agent) is not rewarded
