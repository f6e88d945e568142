"""fk_spheres_kernel's share of its roofline in %: the sum over its launches
in the profiled segment of the least time the card needs (bytes read and
written once at 3.35 TB/s, or the frozen op count at 67 TFLOP/s fp32) over
the sum of their device time in the trace. None when the trace holds no
launch of it, or fewer records than the wrapper made launches."""


def read(ctx):
    r = ctx["rooflines"].get("fk_spheres_kernel")
    if not r or not r["device_s"] or r["records"] != r["launches"]:
        return None
    return r["share"]
