"""Training-stack tests: PPO/MAT updates, locomotion env, gym adapter. The PPO
update, its episode metrics and the locomotion env are in tests/test_learn_*.py,
so that `--dist loadfile` runs them in parallel; the shared `gate` fixture is in
tests/_learn_common.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _learn_common import gate  # noqa: F401


@pytest.mark.slow
def test_ppo_update_many_chunked(gate):
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    tr = PPOTrainer(gate, PPOConfig(rollout_len=2, num_minibatches=2, ppo_epochs=1))
    ts = tr.init_state()
    ts, m = tr.update_many(ts, 3)
    assert np.isfinite(float(m["loss"]))
    assert int(ts.update_count) == 3


@pytest.mark.slow
def test_mat_update(gate):
    from mqe_tpu.learn.mat import MATTrainer
    from mqe_tpu.learn.ppo import PPOConfig

    tr = MATTrainer(gate, PPOConfig(rollout_len=2, num_minibatches=2, ppo_epochs=1))
    ts = tr.init_state()
    ts, m = tr.update(ts)
    assert np.isfinite(float(m["loss"]))


def test_gym_adapter(gate):
    from mqe_tpu.envs.gym_adapter import GymAdapter, SingleAgentAdapter

    ad = GymAdapter(gate, seed=1)
    obs = ad.reset()
    assert obs.shape == (4, 2, gate.obs_dim)
    o, r, d, info = ad.step(np.zeros((4, 2, 3)))
    assert o.shape == (4, 2, gate.obs_dim) and r.shape == (4, 2) and d.shape == (4, 2)
    assert isinstance(info["reward_terms"], dict)

    sa = SingleAgentAdapter(gate, seed=2)
    o = sa.reset()
    assert o.shape == (8, 1, gate.obs_dim)
    o, r, d, info = sa.step(np.zeros((8, 1, 3)))
    assert o.shape == (8, 1, gate.obs_dim) and r.shape == (8, 1)


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])


def test_lag_buffer_delays_targets():
    """Action-lag DR (ref go1.py:337-339): with lag on, the actuated joint
    target is the OLDEST lag entry, so a fresh nonzero action has no effect
    until the FIFO fills."""
    from mqe_tpu.learn.locomotion_env import LocomotionTrainCfg
    from mqe_tpu.envs.go1_env import Go1Env

    class Cfg(LocomotionTrainCfg):
        class env(LocomotionTrainCfg.env):
            num_envs = 2

    env = Go1Env(Cfg, num_envs=2, seed=0)
    assert env.lag_len == 6
    state = env._reset_all(jax.random.PRNGKey(0))
    action = jnp.ones((2, 1, 12))
    # zero FIFO: target must be default_q exactly (delayed action)
    _, _, lag, target = env._torques(state, action)
    np.testing.assert_allclose(
        np.asarray(target), np.broadcast_to(env.default_q, (2, 1, 12)), atol=1e-6
    )
    # after lag_len+1 pushes the scaled action reaches the actuator
    st = state
    for _ in range(env.lag_len + 1):
        _, _, lagbuf, target = env._torques(st, action)
        st = st.replace(lag_buffer=lagbuf)
    expect = env.default_q + np.asarray(env.action_scale) * np.asarray(env.hip_scale)
    np.testing.assert_allclose(np.asarray(target[0, 0]), expect, atol=1e-5)

    # lag off -> immediate
    class CfgOff(Cfg):
        class domain_rand(Cfg.domain_rand):
            randomize_lag_timesteps = False

    env0 = Go1Env(CfgOff, num_envs=2, seed=0)
    assert env0.lag_len == 0
    st0 = env0._reset_all(jax.random.PRNGKey(0))
    _, _, _, target0 = env0._torques(st0, action)
    np.testing.assert_allclose(np.asarray(target0[0, 0]), expect, atol=1e-5)


def test_episode_accumulator_semantics():
    """Per-term episode sums flush at done; summarize = mean per-episode sum
    (ref _fill_extras legged_robot.py:1063-1076)."""
    from mqe_tpu.utils.metrics import EpisodeAccumulator

    acc = EpisodeAccumulator.create(2, ("a",))
    r = jnp.array([1.0, 2.0])
    terms = {"a": jnp.array([0.5, 0.25])}
    nodone = jnp.array([False, False])
    acc = acc.update(r, nodone, terms)
    acc = acc.update(r, jnp.array([True, False]), terms)  # env0 ends, len 2
    s = acc.summarize()
    assert s["episodes"] == 1.0
    assert s["mean_episode_return"] == pytest.approx(2.0)
    assert s["mean_episode_length"] == pytest.approx(2.0)
    assert s["rew_a"] == pytest.approx(1.0)
    # window reset zeroes aggregates but keeps env1's live sums
    acc = acc.reset_window()
    acc = acc.update(r, jnp.array([False, True]), terms)  # env1 ends, len 3
    s = acc.summarize()
    assert s["episodes"] == 1.0
    assert s["mean_episode_return"] == pytest.approx(6.0)
    assert s["rew_a"] == pytest.approx(0.75)


@pytest.mark.slow
def test_checkpoint_kill_and_resume(tmp_path, gate):
    """Full-TrainState checkpointing: save mid-run, restore, continue — the
    resumed run reproduces the uninterrupted run bit-for-bit (VERDICT r1 #6)."""
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    cfg = PPOConfig(rollout_len=2, num_minibatches=2, ppo_epochs=1)
    tr = PPOTrainer(gate, cfg)

    # uninterrupted: 2 updates
    ts = tr.init_state()
    ts, _ = tr.update(ts)
    snap = jax.device_get(ts)  # snapshot BEFORE donation by the 2nd update
    ts, _ = tr.update(ts)
    ref_params = jax.device_get(ts.params)

    # interrupted: save after update 1 (from the snapshot), restore, 1 more
    path = str(tmp_path / "ckpt")
    tr.save_checkpoint(snap, path)
    ts2 = tr.restore_checkpoint(path)
    assert int(ts2.update_count) == 1
    ts2, _ = tr.update(ts2)
    got = jax.device_get(ts2.params)
    for a, b in zip(jax.tree.leaves(ref_params), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)
