"""Training-stack test: a PPO update on go1gate logs the episode metrics."""
from _learn_common import gate  # noqa: F401


def test_ppo_logs_episode_metrics(gate):
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    tr = PPOTrainer(gate, PPOConfig(rollout_len=2, num_minibatches=2, ppo_epochs=1))
    assert len(tr.term_names) > 0  # discovered from the wrapper's terms dict
    ts = tr.init_state()
    ts, m = tr.update(ts)
    s = ts.ep_acc.summarize()
    assert "mean_episode_return" in s
    assert any(k.startswith("rew_") for k in s)
