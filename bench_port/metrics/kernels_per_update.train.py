"""Device operations a training update in the profiled segment: the
launches the host makes."""


def read(ctx):
    if not ctx["on_card"]:
        return None
    return ctx["summary"]["kernels"] / ctx["traced"]["units"]
