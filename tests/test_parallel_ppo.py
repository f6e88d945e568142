"""Sharding test on the virtual 8-device CPU mesh: a PPO update with the env
state sharded."""
import numpy as np

from mqe_tpu.envs import make_mqe_env
from mqe_tpu.parallel.mesh import env_mesh, shard_env_axis


def test_ppo_update_sharded():
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    wrap, _ = make_mqe_env("go1gate", num_envs=8, seed=0)
    trainer = PPOTrainer(wrap, PPOConfig(rollout_len=2, num_minibatches=2, ppo_epochs=1))
    ts = trainer.init_state()
    mesh = env_mesh(8)
    ts = ts.replace(env_state=shard_env_axis(ts.env_state, mesh))
    ts, metrics = trainer.update(ts)
    assert np.isfinite(float(metrics["loss"]))
