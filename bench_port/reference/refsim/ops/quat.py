"""Quaternion / SO(3) math, batched over leading dims.

PyTorch counterpart of `mqe_tpu/ops/quat.py`, function for function.
Quaternions are stored **xyzw** (Isaac Gym root-state layout, ref
mqe/envs/base/legged_robot.py:132); rotations are world-from-body.
"""
from __future__ import annotations

import math

import torch

# xyzw component indices
_X, _Y, _Z, _W = 0, 1, 2, 3


def quat_identity(shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device, dtype=dtype)
    q[..., _W] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-9)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, xyzw layout."""
    ax, ay, az, aw = a[..., _X], a[..., _Y], a[..., _Z], a[..., _W]
    bx, by, bz, bw = b[..., _X], b[..., _Y], b[..., _Z], b[..., _W]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (body -> world for a body pose quat)."""
    qvec = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qvec, v)
    return v + w * t + _cross(qvec, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^-1 (world -> body)."""
    qvec = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qvec, v)
    return v - w * t + _cross(qvec, t)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(q, v)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix R such that R @ v_body = v_world."""
    x, y, z, w = q[..., _X], q[..., _Y], q[..., _Z], q[..., _W]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Unit-axis rotation quaternion, xyzw."""
    half = 0.5 * angle
    s = torch.sin(half)
    xyz = axis * s[..., None]
    w = torch.cos(half)[..., None].expand(xyz.shape[:-1] + (1,))
    return torch.cat([xyz, w], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ euler -> quaternion (matches isaacgym.torch_utils)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def get_euler_xyz(q: torch.Tensor):
    """Quaternion -> (roll, pitch, yaw), each wrapped to [0, 2*pi)."""
    qx, qy, qz, qw = q[..., _X], q[..., _Y], q[..., _Z], q[..., _W]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.copysign(torch.full_like(sinp, math.pi / 2.0), sinp),
        torch.asin(sinp.clamp(-1.0, 1.0)),
    )

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)

    two_pi = 2.0 * math.pi
    return (
        torch.remainder(roll, two_pi),
        torch.remainder(pitch, two_pi),
        torch.remainder(yaw, two_pi),
    )


def get_euler_xyz_wrapped(q: torch.Tensor):
    """(roll, pitch, yaw) each in (-pi, pi]."""
    r, p, y = get_euler_xyz(q)
    return wrap_to_pi(r), wrap_to_pi(p), wrap_to_pi(y)


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] (ref mqe/utils/math.py:45-49)."""
    wrapped = torch.remainder(angle, 2.0 * math.pi)
    return torch.where(wrapped > math.pi, wrapped - 2.0 * math.pi, wrapped)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q (ref mqe/utils/math.py:38-43)."""
    return quat_rotate(yaw_quat(q), v)


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """Extract the yaw-only quaternion of q."""
    qz = q[..., _Z]
    qw = q[..., _W]
    norm = torch.sqrt(qz * qz + qw * qw).clamp_min(1e-9)
    zeros = torch.zeros_like(qz)
    return torch.stack([zeros, zeros, qz / norm, qw / norm], dim=-1)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate quaternion by world-frame angular velocity over dt (exp map)."""
    angle = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / angle.clamp_min(1e-9)
    dq = quat_from_angle_axis((angle * dt)[..., 0], axis)
    ident = quat_identity(q.shape[:-1], device=q.device, dtype=q.dtype)
    dq = torch.where(angle < 1e-9, ident, dq)
    return quat_normalize(quat_mul(dq, q))


def quat_box_minus(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Rotation vector taking q2 to q1 (world frame), i.e. log(q1 * q2^-1)."""
    dq = quat_normalize(quat_mul(q1, quat_conjugate(q2)))
    # enforce shortest path
    sign = torch.sign(dq[..., 3:4])
    sign = torch.where(sign == 0, 1.0, sign)
    dq = dq * sign
    xyz = dq[..., :3]
    w = dq[..., 3].clamp(-1.0, 1.0)
    norm_xyz = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm_xyz[..., 0], w)
    return xyz / norm_xyz.clamp_min(1e-9) * angle[..., None]


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)
