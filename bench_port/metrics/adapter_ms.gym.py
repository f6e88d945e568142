"""adapter_ms.gym: ms a step in the gym adapter itself (`GymAdapter.step`
less the wrapper's `step`: the numpy copies), synchronized stage timers."""


def read(ctx):
    s, n = ctx["stage_s"], ctx["stage_calls"]
    if not n.get("adapter_step"):
        return None
    return (s["adapter_step"] - s["wrapper_step"]) / n["adapter_step"] * 1e3
