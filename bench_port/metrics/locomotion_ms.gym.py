"""ms an env step in the locomotion chain: `Go1Env._locomotion_action` (gait
clocks, obs70, trot + residual body policy) plus `_torques` (actuator net),
synchronized stage timers, over the traced env steps."""


def read(ctx):
    s, steps = ctx["stage_s"], ctx["traced"]["steps"]
    if "locomotion_action" not in s or not steps:
        return None
    return (s["locomotion_action"] + s["torques"]) / steps * 1e3
