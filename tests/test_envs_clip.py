"""Env behavior test: the tanh and delta clipping of the commands, on go1plane."""
import jax
import jax.numpy as jnp
import numpy as np


def test_action_clip_modes():
    # ref legged_robot_field.py:96-115: tanh squash + delta rate limit
    from mqe_tpu.envs.go1_env import Go1Env
    from mqe_tpu.envs.tasks import Go1PlaneCfg

    class TanhCfg(Go1PlaneCfg):
        class normalization(Go1PlaneCfg.normalization):
            clip_actions_method = "tanh"
            clip_actions = 1.0
            clip_actions_delta = [0.1, 0.1, 0.1]

    env = Go1Env(TanhCfg, num_envs=2, seed=0)
    key = jax.random.PRNGKey(0)
    state = env._reset_all(key)
    assert np.asarray(state.commands == 0).all()
    # huge raw action: tanh bounds it to ~1, delta limits the step to 0.1
    big = jnp.full((2, 1, 3), 50.0)
    state2, obs, done, info = env.step(state, big, jax.random.PRNGKey(1))
    np.testing.assert_allclose(np.asarray(state2.commands), 0.1, atol=1e-6)
    state3, *_ = env.step(state2, big, jax.random.PRNGKey(2))
    np.testing.assert_allclose(np.asarray(state3.commands), 0.2, atol=1e-6)
