"""Training-stack test: the locomotion env resets and steps."""
import jax
import jax.numpy as jnp
import numpy as np


def test_locomotion_env_step():
    from mqe_tpu.learn.locomotion_env import LocomotionEnv

    env = LocomotionEnv(num_envs=4, seed=0)
    key = jax.random.PRNGKey(0)
    ts, obs = env.reset(key)
    assert obs.shape == (4, 1, 70)
    for _ in range(3):
        key, k = jax.random.split(key)
        ts, obs, rew, done, info = env.step(ts, jnp.zeros((4, 1, 12)), k)
    assert np.isfinite(np.asarray(obs)).all()
    assert np.isfinite(np.asarray(rew)).all()
    assert rew.shape == (4, 1)
    # zero-action near default posture should collect some tracking reward
    # for small commands, and never NaN
    assert float(ts.cmd_scale) >= 1.0
