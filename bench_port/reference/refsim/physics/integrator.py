"""Semi-implicit Euler integration of articulated-body state.

Counterpart of `mqe_tpu/physics/integrator.py` (the AoS path's integrator):
the reference's sim cadence is dt = 0.005 s, 4 substeps per control step
(ref mqe/envs/base/legged_robot_config.py:211-213, control:121). Every
argument carries the same leading batch dims (E, A, ...).
"""
from __future__ import annotations

import torch

from refsim.ops import quat as quat_ops
from refsim.physics.model import BodyModel


def _clip(x, lo, hi):
    """jnp.clip's order: max with lo, then min with hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def integrate(model: BodyModel, base_pos, base_quat, base_lin_vel, base_ang_vel, q, qd,
              omega_dot_w, a_lin_w, qdd, dt, max_lin_vel: float = 100.0,
              max_ang_vel: float = 50.0):
    """One semi-implicit Euler step -> (pos, quat, lin_vel, ang_vel, q, qd)."""
    base_ang_vel = base_ang_vel + dt * omega_dot_w
    base_lin_vel = base_lin_vel + dt * a_lin_w
    # velocity clamps mirror the asset options max_*_velocity (go1_config.py:80-82)
    base_lin_vel = torch.clamp(base_lin_vel, -max_lin_vel, max_lin_vel)
    base_ang_vel = torch.clamp(base_ang_vel, -max_ang_vel, max_ang_vel)

    base_pos = base_pos + dt * base_lin_vel
    base_quat = quat_ops.quat_integrate(base_quat, base_ang_vel, dt)

    c = lambda x: torch.as_tensor(x, dtype=q.dtype, device=q.device)  # noqa: E731
    qd = qd + dt * qdd
    qd_lim = c(model.qd_limit)
    qd = _clip(qd, -qd_lim, qd_lim)
    q = q + dt * qd

    # hard joint limits: clamp the position, kill the velocity into the limit
    lo, hi = c(model.q_lower), c(model.q_upper)
    at_lo = q < lo
    at_hi = q > hi
    q = _clip(q, lo, hi)
    qd = torch.where(at_lo & (qd < 0), 0.0, qd)
    qd = torch.where(at_hi & (qd > 0), 0.0, qd)

    return base_pos, base_quat, base_lin_vel, base_ang_vel, q, qd
