"""6D spatial-vector algebra (Featherstone convention).

Counterpart of `mqe_tpu/physics/spatial.py`. Motion vectors m = (angular,
linear); force vectors F = (torque, force), both expressed at a frame origin.
Frame transform (R, p): pose of the CHILD frame in the PARENT frame,
x_p = R x_c + p.

Two kinds of callers:
  - the model loader (physics/model.py) computes model constants once in
    numpy (float64): `skew` and `spatial_inertia` given numpy arrays or
    sequences return numpy arrays;
  - the AoS dynamics (physics/dynamics.py, star_dynamics.py, scene.substep)
    work on tensors over any leading batch dims: `skew` and
    `spatial_inertia` given tensors return tensors, and the other functions
    take tensors only.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_t(x):
    return isinstance(x, torch.Tensor)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix, skew(a) @ b = a x b."""
    if not _is_t(v):
        x, y, z = (float(c) for c in v)
        return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def mv(M, v):
    """Matrix-vector product over leading batch dims: (..., n, k) @ (..., k)."""
    return (M @ v[..., None])[..., 0]


def motion_transform(R, p):
    """6x6 X with v_child = X @ v_parent, for child pose (R, p) in parent."""
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, torch.zeros_like(Rt)], dim=-1)
    bot = torch.cat([-Rt @ skew(p), Rt], dim=-1)
    return torch.cat([top, bot], dim=-2)


def motion_transform_inv(R, p):
    """6x6 X^-1 with v_parent = X^-1 @ v_child."""
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([skew(p) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def cross_motion(v, m):
    """Spatial motion cross product v x m."""
    w, vl = v[..., :3], v[..., 3:]
    mw, mvl = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, mw), _cross(w, mvl) + _cross(vl, mw)], dim=-1)


def cross_force(v, F):
    """Spatial force cross product v x* F."""
    w, vl = v[..., :3], v[..., 3:]
    n, f = F[..., :3], F[..., 3:]
    return torch.cat([_cross(w, n) + _cross(vl, f), _cross(w, f)], dim=-1)


def solve_spd6(A, b):
    """Solve A x = b for SPD 6x6 A by a fully unrolled Cholesky, elementwise
    over any batch dims. A: (..., 6, 6), b: (..., 6).

    Each pivot is clamped to 1e-12 before its square root, as the JAX
    package's solve is, so a matrix that is not positive definite gives the
    same numbers there (a library Cholesky would fail or differ)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def spatial_inertia(mass, com, inertia_com):
    """6x6 spatial inertia at the body-frame origin.

    I = [[I_com + m c^ c^T, m c^], [m c^T, m E]], acting on (w, v) -> (n, f).
    Numpy (float64) for a numpy or python mass; over batch dims for tensors
    (mass (...,), com (..., 3), inertia_com (..., 3, 3)).
    """
    if not _is_t(com):
        C = skew(com)
        m = float(mass)
        out = np.zeros((6, 6))
        out[:3, :3] = np.asarray(inertia_com) + m * (C @ C.T)
        out[:3, 3:] = m * C
        out[3:, :3] = m * C.T
        out[3:, 3:] = m * np.eye(3)
        return out
    C = skew(com)
    mass = torch.as_tensor(mass, dtype=com.dtype, device=com.device)
    m = mass[..., None, None]
    I_O = inertia_com + m * (C @ C.transpose(-1, -2))
    mC = m * C
    E = m * torch.eye(3, dtype=com.dtype, device=com.device).expand(C.shape)
    top = torch.cat([I_O, mC], dim=-1)
    bot = torch.cat([mC.transpose(-1, -2), E], dim=-1)
    return torch.cat([top, bot], dim=-2)
