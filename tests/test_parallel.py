"""Multi-chip sharding tests on the virtual 8-device CPU mesh (SURVEY.md §4:
'test multi-node without a real cluster'). The sharded PPO update is in
tests/test_parallel_ppo.py, so that `--dist loadfile` runs it in parallel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mqe_tpu.envs import make_mqe_env
from mqe_tpu.parallel.mesh import env_mesh, shard_env_axis, sharded_step


@pytest.fixture(scope="module")
def setup():
    wrap, _ = make_mqe_env("go1gate", num_envs=8, seed=0)
    key = jax.random.PRNGKey(0)
    ts, obs = wrap.reset(key)
    return wrap, ts, obs


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_sharded_matches_single_device(setup):
    """Bit-for-bit: stepping with the env axis sharded across 8 devices gives
    identical results to unsharded execution."""
    wrap, ts, _ = setup
    key = jax.random.PRNGKey(1)
    acts = jnp.zeros((8, 2, 3)).at[..., 0].set(0.7)

    ts_ref, obs_ref, rew_ref, done_ref, _ = wrap.step(ts, acts, key)

    mesh = env_mesh(8)
    step = sharded_step(wrap, mesh)
    ts_sh = shard_env_axis(ts, mesh)
    ts_out, obs_out, rew_out, done_out, _ = step(ts_sh, acts, key)

    np.testing.assert_allclose(np.asarray(obs_out), np.asarray(obs_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(rew_out), np.asarray(rew_ref), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(done_out), np.asarray(done_ref))


def test_sharded_multi_step_stable(setup):
    wrap, ts, _ = setup
    mesh = env_mesh(8)
    step = sharded_step(wrap, mesh)
    ts = shard_env_axis(ts, mesh)
    key = jax.random.PRNGKey(2)
    acts = jnp.zeros((8, 2, 3)).at[..., 0].set(0.7)
    for _ in range(10):
        key, k = jax.random.split(key)
        ts, obs, rew, done, info = step(ts, acts, k)
    assert np.isfinite(np.asarray(obs)).all()
    # state stayed sharded across the mesh
    shard_devs = {d for d in ts.env.phys.agents.pos.devices()}
    assert len(shard_devs) == 8


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])
