"""Wrapper tests of go1wrestling: `test_build_step_all` for it, then its golden
reward tests, which reuse the wrap `get_wrap` built and reset. The two layers
are described in tests/test_wrappers_golden.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, _move_agent, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden_wrestling.py"])
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


def test_wrestling_fall_golden():
    wrap, ts, _ = get_wrap("go1wrestling")
    s = wrap.scales
    state = ts.env
    # flip agent 1 upside-down (pitch ~ pi) -> agent 0 success
    st = _move_agent(state, wrap.env, 1, rpy=(0.0, np.pi * 0.95, 0.0))
    obs = obs_of(wrap, st)
    rew, _, _ = wrap._reward(st, obs, {}, None, no_reset_info())
    assert float(rew[0, 0]) == pytest.approx(s["success_reward_scale"])
    # reference parity: reward flows to agent 0's channel ONLY
    # (ref go1_wrestling_wrapper.py:62-81 — no repeat)
    assert float(rew[0, 1]) == pytest.approx(0.0, abs=1e-6)
    # flip agent 0 (roll) -> punishment on agent 0
    st2 = _move_agent(state, wrap.env, 0, rpy=(np.pi * 0.5, 0.0, 0.0))
    rew2, _, _ = wrap._reward(st2, obs_of(wrap, st2), {}, None, no_reset_info())
    assert float(rew2[0, 0]) == pytest.approx(-s["punishment_scale"])
    assert float(rew2[0, 1]) == pytest.approx(0.0, abs=1e-6)

    # self-play training mode: per-seat zero-sum reward on the pre-reset
    # state with env-termination fall thresholds (|pitch| 0.95pi > 1.6 and
    # |roll| 0.5pi > 0.8 both qualify)
    rew_sp = wrap._selfplay_reward(st, obs, rew, {})
    # agent 1 fell: seat 0 earns +S, seat 1 earns -P
    assert float(rew_sp[0, 0]) == pytest.approx(s["success_reward_scale"])
    assert float(rew_sp[0, 1]) == pytest.approx(-s["punishment_scale"])
    rew_sp2 = wrap._selfplay_reward(st2, obs_of(wrap, st2), rew2, {})
    # agent 0 fell: seat 0 earns -P, seat 1 earns +S
    assert float(rew_sp2[0, 0]) == pytest.approx(-s["punishment_scale"])
    assert float(rew_sp2[0, 1]) == pytest.approx(s["success_reward_scale"])


def test_wrestling_obs_mirror_layout():
    wrap, ts, obs = get_wrap("go1wrestling")
    state = ts.env
    ob = obs_of(wrap, state)
    o = np.asarray(wrap._obs(state, ob, ts.extra))
    bi = np.asarray(wrap._base_info(ob))
    np.testing.assert_allclose(o[:, 0, :6], bi[:, 0, :], atol=1e-6)
    flip = np.flip(bi, axis=1)
    for col in (1, 4, 7, 10):
        np.testing.assert_allclose(
            o[:, 1, col],
            -(flip[:, 1, col - 6] if col >= 6 else bi[:, 1, col]),
            atol=1e-6,
        )
