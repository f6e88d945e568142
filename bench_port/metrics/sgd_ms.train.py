"""ms of an update's second half (value norm, GAE, the 16 minibatch Adam
steps), from `PPOTrainer.timed_update`, the mean over the traced updates."""


def read(ctx):
    s = ctx["traced"].get("sgd_s")
    return sum(s) / len(s) * 1e3 if s else None
