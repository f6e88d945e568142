"""Training-stack test: one PPO update on go1gate changes the params."""
import jax
import jax.numpy as jnp
import numpy as np

from _learn_common import gate  # noqa: F401


def test_ppo_update_improves_nothing_breaks(gate):
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    tr = PPOTrainer(gate, PPOConfig(rollout_len=2, num_minibatches=2, ppo_epochs=1))
    ts = tr.init_state()
    # updates donate their input state; snapshot params on host first
    before = jax.tree.map(np.asarray, tr.init_params)
    ts, m = tr.update(ts)
    assert np.isfinite(float(m["loss"]))
    delta = jax.tree.map(lambda a, b: float(jnp.abs(jnp.asarray(a) - b).max()), before, ts.params)
    assert max(jax.tree.leaves(delta)) > 0
