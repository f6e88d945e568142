"""Floating-base Featherstone dynamics (FK + ABA) of one body tree, batched.

Counterpart of `mqe_tpu/physics/dynamics.py`, the JAX package's
array-of-structures (AoS) reference: 6x6 spatial algebra per body, where
physics/soa.py works on scalar lanes. The JAX functions are written for ONE
tree and vmapped over envs and agents; these take any leading batch dims
(E, A, ...) instead. The body count is static, so the tree is a Python loop
over the `nb` bodies in tree order, as JAX unrolls it.

Joints are hard constraints (exact generalized coordinates); only contact is
a soft penalty model (physics/contact.py). Revolute and prismatic joints.
"""
from __future__ import annotations

import torch

from refsim.ops import quat as quat_ops
from refsim.physics import spatial
from refsim.physics.model import JOINT_PRISMATIC, BodyModel
from refsim.physics.spatial import mv


def _const(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def kinematics(model: BodyModel, base_pos, base_quat, q):
    """Forward kinematics.

    Args:
      base_pos (..., 3), base_quat (..., 4) xyzw, q (..., nq).
    Returns:
      Rw (..., nb, 3, 3) world-from-body rotations, pw (..., nb, 3) body
      origins, X_up: list of (..., 6, 6) parent->child motion transforms
      (X_up[0] None), S: list of (6,) joint motion subspaces in the child
      frame (S[0] zero), Rl: list of (..., 3, 3) child-in-parent rotations,
      pl: list of (..., 3) child-in-parent positions.
    """
    nb = model.nb
    Rw = [None] * nb
    pw = [None] * nb
    X_up = [None] * nb
    zero6 = torch.zeros(6, dtype=base_pos.dtype, device=base_pos.device)
    S = [zero6] * nb
    Rl = [None] * nb
    pl = [None] * nb

    Rw[0] = quat_ops.quat_to_matrix(base_quat)
    pw[0] = base_pos

    jrot = _const(model.joint_rot, base_pos)
    jpos = _const(model.joint_pos, base_pos)
    jaxis = _const(model.joint_axis, base_pos)
    zero3 = torch.zeros_like(base_pos)

    for i in range(1, nb):
        par = int(model.parent[i])
        qi = q[..., i - 1]
        axis = jaxis[i]
        if int(model.joint_type[i]) == JOINT_PRISMATIC:
            Rj = torch.eye(3, dtype=base_pos.dtype, device=base_pos.device).expand(
                qi.shape + (3, 3))
            pj = axis * qi[..., None]
            S[i] = torch.cat([torch.zeros_like(axis), axis])
        else:  # revolute
            Rj = quat_ops.quat_to_matrix(quat_ops.quat_from_angle_axis(qi, axis))
            pj = zero3
            S[i] = torch.cat([axis, torch.zeros_like(axis)])
        # child pose in the parent frame: the joint frame, then the joint motion
        Rl[i] = jrot[i] @ Rj
        pl[i] = jpos[i] + mv(jrot[i], pj)
        X_up[i] = spatial.motion_transform(Rl[i], pl[i])
        Rw[i] = Rw[par] @ Rl[i]
        pw[i] = pw[par] + mv(Rw[par], pl[i])

    return torch.stack(Rw, dim=-3), torch.stack(pw, dim=-2), X_up, S, Rl, pl


def _world_to_body(R, x):
    """R^T @ x over batch dims."""
    return mv(R.transpose(-1, -2), x)


def body_velocities(model: BodyModel, Rw, X_up, S, base_lin_vel_w, base_ang_vel_w, qd):
    """Spatial velocity of each body, in its own frame and in world coords.

    Returns v_body: list of (..., 6) body-frame spatial velocities (the ABA's
    input) and vw (..., nb, 6): world-frame (omega_w, v_origin_w) per body.
    """
    nb = model.nb
    v = [None] * nb
    R0 = Rw[..., 0, :, :]
    v[0] = torch.cat([_world_to_body(R0, base_ang_vel_w), _world_to_body(R0, base_lin_vel_w)],
                     dim=-1)
    for i in range(1, nb):
        par = int(model.parent[i])
        v[i] = mv(X_up[i], v[par]) + S[i] * qd[..., i - 1:i]
    vw = []
    for i in range(nb):
        Ri = Rw[..., i, :, :]
        vw.append(torch.cat([mv(Ri, v[i][..., :3]), mv(Ri, v[i][..., 3:])], dim=-1))
    return v, torch.stack(vw, dim=-2)


def forward_dynamics(model: BodyModel, Ispat, base_pos, base_quat, base_lin_vel_w,
                     base_ang_vel_w, q, qd, tau, f_ext_w, joint_damping=None):
    """Full pipeline: FK -> velocities -> ABA, over batch dims.

    Ispat (..., nb, 6, 6) body-frame spatial inertias (or (nb, 6, 6) shared);
    tau (..., nq); f_ext_w (..., nb, 6) world wrenches about the body origins.
    Returns (omega_dot_w (..., 3), a_lin_w (..., 3), qdd (..., nq), aux) where
    aux carries the FK results for reuse (Rw, pw, vw).
    """
    kin = kinematics(model, base_pos, base_quat, q)
    return forward_dynamics_kin(model, Ispat, kin, base_lin_vel_w, base_ang_vel_w, qd, tau,
                                f_ext_w, joint_damping=joint_damping)


def _dot(a, b):
    return (a * b).sum(-1)


def forward_dynamics_kin(model: BodyModel, Ispat, kin, base_lin_vel_w, base_ang_vel_w, qd,
                         tau, f_ext_w, joint_damping=None):
    """forward_dynamics with precomputed kinematics() output."""
    nb = model.nb
    Rw, pw, X_up, S, _, _ = kin
    like = base_lin_vel_w
    v, vw = body_velocities(model, Rw, X_up, S, base_lin_vel_w, base_ang_vel_w, qd)

    # external wrench world -> body frames
    f_ext = []
    for i in range(nb):
        Ri = Rw[..., i, :, :]
        f_ext.append(torch.cat([_world_to_body(Ri, f_ext_w[..., i, :3]),
                                _world_to_body(Ri, f_ext_w[..., i, 3:])], dim=-1))

    # joint-space damping folded into tau
    if joint_damping is None:
        joint_damping = _const(model.joint_damping, like)
    tau_eff = tau - joint_damping * qd

    Ii = [Ispat[..., i, :, :] for i in range(nb)]
    IA = list(Ii)
    pA = [spatial.cross_force(v[i], mv(Ii[i], v[i])) - f_ext[i] for i in range(nb)]
    c = [None] * nb
    for i in range(1, nb):
        vJ = S[i] * qd[..., i - 1:i]
        c[i] = spatial.cross_motion(v[i], vJ)

    U = [None] * nb
    d = [None] * nb
    u = [None] * nb
    # inward pass (children before parents; bodies are topologically ordered)
    for i in range(nb - 1, 0, -1):
        par = int(model.parent[i])
        U[i] = mv(IA[i], S[i])
        d[i] = _dot(S[i], U[i]) + 1e-9
        u[i] = tau_eff[..., i - 1] - _dot(S[i], pA[i])
        Ia = IA[i] - U[i][..., :, None] * U[i][..., None, :] / d[i][..., None, None]
        pa = pA[i] + mv(Ia, c[i]) + U[i] * (u[i] / d[i])[..., None]
        X = X_up[i]
        Xt = X.transpose(-1, -2)
        IA[par] = IA[par] + Xt @ Ia @ X
        pA[par] = pA[par] + mv(Xt, pa)

    # root (unrolled SPD Cholesky)
    if model.root_free:
        eye6 = torch.eye(6, dtype=like.dtype, device=like.device)
        a0 = spatial.solve_spd6(IA[0] + 1e-9 * eye6, -pA[0])
    else:
        a0 = torch.zeros_like(pA[0])

    a = [None] * nb
    a[0] = a0
    qdd = [None] * (nb - 1)
    for i in range(1, nb):
        par = int(model.parent[i])
        ai = mv(X_up[i], a[par]) + c[i]
        qdd_i = (u[i] - _dot(U[i], ai)) / d[i]
        a[i] = ai + S[i] * qdd_i[..., None]
        qdd[i - 1] = qdd_i
    qdd = torch.stack(qdd, dim=-1) if nb > 1 else torch.zeros_like(like[..., :0])

    # base spatial acceleration (body frame) -> world classical derivatives
    R0 = Rw[..., 0, :, :]
    w_b, v_b = v[0][..., :3], v[0][..., 3:]
    omega_dot_w = mv(R0, a0[..., :3])
    a_lin_w = mv(R0, a0[..., 3:] + torch.linalg.cross(w_b, v_b, dim=-1))
    return omega_dot_w, a_lin_w, qdd, (Rw, pw, vw)


def total_momentum(model: BodyModel, Ispat, base_pos, base_quat, base_lin_vel_w,
                   base_ang_vel_w, q, qd):
    """Total (angular about the world origin, linear) momentum of the tree.

    Internal joint torques must conserve both in free space (the tests).
    """
    Rw, pw, X_up, S, _, _ = kinematics(model, base_pos, base_quat, q)
    v, _ = body_velocities(model, Rw, X_up, S, base_lin_vel_w, base_ang_vel_w, qd)
    h_ang = torch.zeros_like(base_pos)
    h_lin = torch.zeros_like(base_pos)
    for i in range(model.nb):
        Ri = Rw[..., i, :, :]
        h_b = mv(Ispat[..., i, :, :], v[i])  # body-frame spatial momentum at the origin
        n_w = mv(Ri, h_b[..., :3])
        f_w = mv(Ri, h_b[..., 3:])
        # shift the moment to the world origin: n_O = n_i + p_i x f
        h_ang = h_ang + n_w + torch.linalg.cross(pw[..., i, :], f_w, dim=-1)
        h_lin = h_lin + f_w
    return h_ang, h_lin
