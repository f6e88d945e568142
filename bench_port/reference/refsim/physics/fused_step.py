"""The reference's stand-in for the program's kernel wrappers: the plain
versions of the three kernels (`soa.step_actor`, `soa.fk_spheres`,
`soa.fk_full`) on every device."""
from __future__ import annotations

from refsim.physics import soa


def step_actor_kernel(model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                      payload=None, com_shift=None, extra_wrench=None, dt=0.0025,
                      root_free=None):
    return soa.step_actor(model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                          payload=payload, com_shift=com_shift, extra_wrench=extra_wrench,
                          dt=dt, root_free=root_free)


def fk_spheres_kernel(model, pos, quat, lin_vel, ang_vel, q, qd):
    return soa.fk_spheres(model, pos, quat, lin_vel, ang_vel, q, qd)


def fk_full_kernel(model, pos, quat, lin_vel, ang_vel, q, qd):
    return soa.fk_full(model, pos, quat, lin_vel, ang_vel, q, qd)
