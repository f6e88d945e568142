"""ms of an update's rollout (T env steps with the policy), from
`PPOTrainer.timed_update`, the mean over the traced updates."""


def read(ctx):
    r = ctx["traced"].get("rollout_s")
    return sum(r) / len(r) * 1e3 if r else None
