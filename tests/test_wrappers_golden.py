"""Per-task wrapper correctness tests (VERDICT r1 #4).

Two layers:
  1. `test_build_step_all[task]` — every registry entry builds, resets, and
     steps once with finite obs/reward and the documented obs layout.
  2. Golden reward tests — hand-positioned states pushed through each
     wrapper's `_reward` (pure, runs eagerly), asserting values against the
     reference wrapper semantics (ref mqe/envs/wrappers/*.py): tug halving
     rules (go1_tug_wrapper.py:89-113), wrestling fall detection
     (go1_wrestling_wrapper.py), sheep mixed reward (go1_sheep_wrapper.py),
     gate commented spec (go1_gate_wrapper.py:84-154), pushbox box-delta
     (go1_pushbox_wrapper.py:53-84), seesaw terms (go1_seesaw_wrapper.py),
     rotation/bridge success-punishment pairs, football goal rewards.

A task's build, reset and step take one to three minutes on the CPU, so each
task has a file of its own, this one for go1gate and
tests/test_wrappers_golden_<task>.py for the others, which `--dist loadfile`
hands to different workers. A file holds the golden tests of its own task, so
that no task's env is built and reset in two workers. The helpers and
`BUILD_TASKS`, the task of each file, are in tests/_wrappers_golden_common.py;
tests/test_wrappers_golden_tasks.py checks that the files take every task of
the registry once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _wrappers_golden_common import BUILD_TASKS, _move_agent, get_wrap, no_reset_info, obs_of


@pytest.mark.parametrize("task", BUILD_TASKS["test_wrappers_golden.py"])
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


def test_gate_golden():
    wrap, ts, _ = get_wrap("go1gate")
    env, s = wrap.env, wrap.scales
    state = ts.env
    gate_x_env = float(wrap._gate(obs_of(wrap, state))[0, 0])
    ox, oy = float(env.env_origins[0, 0]), float(env.env_origins[0, 1])

    # agent 0 past the gate -> success for agent 0 only
    st = _move_agent(state, env, 0, world_xy=(ox + gate_x_env + 0.5, oy))
    obs = obs_of(wrap, st)
    extra = wrap._extra_init(st, obs)
    rew, _, terms = wrap._reward(st, obs, extra, None, no_reset_info())
    exp_succ = s["success_reward_scale"]
    # target reward: extra freshly initialized -> progress 0
    assert float(rew[0, 0]) == pytest.approx(exp_succ, abs=1e-5)
    assert float(rew[0, 1]) == pytest.approx(0.0, abs=1e-5)

    # progress reward: pretend last_dist was 1.0 larger for both agents
    extra2 = dict(extra)
    obs2 = obs_of(wrap, state)
    extra_base = wrap._extra_init(state, obs2)
    extra2 = {**extra_base, "last_dist": extra_base["last_dist"] + 1.0}
    rew2, _, _ = wrap._reward(state, obs2, extra2, None, no_reset_info())
    # both agents advanced 1.0 -> team progress 2.0, shared per agent
    exp = s["target_reward_scale"] * 2.0
    assert float(rew2[0, 0]) == pytest.approx(exp, rel=1e-5)
    assert float(rew2[0, 1]) == pytest.approx(exp, rel=1e-5)

    # contact punishment hits all agents of the colliding env
    st3 = state.replace(collide=jnp.array([True, False]))
    obs3 = obs_of(wrap, st3)
    extra3 = wrap._extra_init(st3, obs3)
    rew3, _, _ = wrap._reward(st3, obs3, extra3, None, no_reset_info())
    assert float(rew3[0, 0]) == pytest.approx(s["contact_punishment_scale"], abs=1e-5)
    assert float(rew3[1, 0]) == pytest.approx(0.0, abs=1e-5)
