"""The device's idle share in %: 1 minus the union of every device
operation's interval over the profiled segment's wall (no synchronize
inside the step)."""


def read(ctx):
    if not ctx["on_card"]:
        return None
    return 100.0 * ctx["summary"]["idle_share"]
