"""ms an env step in the physics substeps less their kernels' wrappers:
`scene.substep_batch` minus `fk_spheres_kernel`, `step_actor_kernel` and
`fk_full_kernel` (contact, NPC primitives and pairs, reshapes),
synchronized stage timers, over the traced env steps."""


def read(ctx):
    s, steps = ctx["stage_s"], ctx["traced"]["steps"]
    if "substep_batch" not in s or not steps:
        return None
    kernels = sum(s.get(k, 0.0) for k in ("fk_spheres_kernel", "step_actor_kernel",
                                          "fk_full_kernel"))
    return (s["substep_batch"] - kernels) / steps * 1e3
