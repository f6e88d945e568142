"""Leg-parallel Featherstone dynamics for star-of-chains topologies, batched.

Counterpart of `mqe_tpu/physics/star_dynamics.py`. go1 is a trunk with 4
chains of equal depth (hip -> thigh -> calf); the generic ABA of dynamics.py
walks the 12 bodies one at a time, this one takes each tree DEPTH as one step
over all legs (chains). It is what the AoS substep (scene.substep) runs for a
robot whose model `star_layout` accepts, and gives what
dynamics.forward_dynamics gives (the tests hold them to each other).

Leading batch dims (E, A, ...) as in dynamics.py; the leg axis L sits just
before each quantity's own dims: (..., L, 3), (..., L, 6, 6).
"""
from __future__ import annotations

import numpy as np
import torch

from refsim.ops import quat as quat_ops
from refsim.physics import spatial
from refsim.physics.model import JOINT_PRISMATIC, BodyModel
from refsim.physics.spatial import mv

_LAYOUT_CACHE: dict = {}


def star_layout(model: BodyModel):
    """Detect a trunk with L >= 2 chains of equal depth D. Returns (L, D,
    bodies (L, D)) with bodies[l, d] the body index, or None."""
    key = id(model)
    if key in _LAYOUT_CACHE:
        return _LAYOUT_CACHE[key][1]
    nb = model.nb
    children = {i: [] for i in range(nb)}
    for i in range(1, nb):
        children[int(model.parent[i])].append(i)
    chains = []
    ok = True
    for r in children[0]:
        chain = [r]
        cur = r
        while children[cur]:
            if len(children[cur]) != 1:
                ok = False
                break
            cur = children[cur][0]
            chain.append(cur)
        chains.append(chain)
    layout = None
    if ok and chains and len({len(c) for c in chains}) == 1 and len(chains) >= 2:
        layout = (len(chains), len(chains[0]), np.array(chains, dtype=np.int64))
    # keep the model alive beside its layout, so that its id is not reused
    _LAYOUT_CACHE[key] = (model, layout)
    return layout


def _dot(a, b):
    return (a * b).sum(-1)


def forward_dynamics_star(model: BodyModel, Ispat, base_pos, base_quat, base_lin_vel_w,
                          base_ang_vel_w, q, qd, tau, f_ext_w, joint_damping=None):
    """Leg-parallel FK + ABA. Same arguments and returns as
    dynamics.forward_dynamics."""
    L, D, bidx = star_layout(model)
    dtype, dev = base_pos.dtype, base_pos.device
    c = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
    jrot = c(model.joint_rot[bidx])                          # (L, D, 3, 3)
    jpos = c(model.joint_pos[bidx])                          # (L, D, 3)
    jaxis = c(model.joint_axis[bidx])                        # (L, D, 3)
    jtype = model.joint_type[bidx]                           # numpy (L, D)
    dof = torch.as_tensor(bidx - 1, device=dev)              # joint index per body
    q_l = q[..., dof]                                        # (..., L, D)
    qd_l = qd[..., dof]
    batch = base_pos.shape[:-1]

    # ---- FK over depth (the trunk, then D steps over the legs) ----
    R0 = quat_ops.quat_to_matrix(base_quat)
    Rw = [None] * D    # per depth: (..., L, 3, 3) world rotations
    pw = [None] * D    # (..., L, 3)
    Xup = [None] * D   # (..., L, 6, 6)
    S = [None] * D     # (L, 6)
    prismatic = c(jtype == JOINT_PRISMATIC)[..., None]       # (L, D, 1)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    Rw_par = R0[..., None, :, :].expand(batch + (L, 3, 3))
    pw_par = base_pos[..., None, :].expand(batch + (L, 3))
    for d in range(D):
        axis = jaxis[:, d]                                   # (L, 3)
        qi = q_l[..., d]                                     # (..., L)
        pris = prismatic[:, d]                               # (L, 1)
        Rj_rev = quat_ops.quat_to_matrix(quat_ops.quat_from_angle_axis(qi, axis))
        Rj = torch.where(pris[..., None] > 0, eye3, Rj_rev)
        pj = pris * axis * qi[..., None]
        S[d] = torch.cat([axis * (1 - pris), axis * pris], dim=-1)
        Rl = jrot[:, d] @ Rj
        pl = jpos[:, d] + mv(jrot[:, d], pj)
        Xup[d] = spatial.motion_transform(Rl, pl)
        Rw[d] = Rw_par @ Rl
        pw[d] = pw_par + mv(Rw_par, pl)
        Rw_par, pw_par = Rw[d], pw[d]

    # ---- velocities ----
    R0t = R0.transpose(-1, -2)
    v0 = torch.cat([mv(R0t, base_ang_vel_w), mv(R0t, base_lin_vel_w)], dim=-1)
    v = [None] * D
    v_par = v0[..., None, :].expand(batch + (L, 6))
    for d in range(D):
        v[d] = mv(Xup[d], v_par) + S[d] * qd_l[..., d:d + 1]
        v_par = v[d]

    # ---- external wrenches to body frames ----
    if joint_damping is None:
        joint_damping = c(model.joint_damping)
    tau_eff = (tau - joint_damping * qd)[..., dof]           # (..., L, D)

    f_ext_l = f_ext_w[..., torch.as_tensor(bidx, device=dev), :]  # (..., L, D, 6)
    fe = [None] * D
    for d in range(D):
        Rt = Rw[d].transpose(-1, -2)
        fe[d] = torch.cat([mv(Rt, f_ext_l[..., d, :3]), mv(Rt, f_ext_l[..., d, 3:])], dim=-1)
    fe0 = torch.cat([mv(R0t, f_ext_w[..., 0, :3]), mv(R0t, f_ext_w[..., 0, 3:])], dim=-1)

    I_l = Ispat[..., torch.as_tensor(bidx, device=dev), :, :]  # (..., L, D, 6, 6)
    IA = [I_l[..., d, :, :] for d in range(D)]
    pA = [spatial.cross_force(v[d], mv(I_l[..., d, :, :], v[d])) - fe[d] for d in range(D)]
    cc = [spatial.cross_motion(v[d], S[d] * qd_l[..., d:d + 1]) for d in range(D)]

    IA0 = Ispat[..., 0, :, :]
    pA0 = spatial.cross_force(v0, mv(IA0, v0)) - fe0

    # ---- inward pass over depth ----
    U = [None] * D
    dnm = [None] * D
    u = [None] * D
    for d in range(D - 1, -1, -1):
        U[d] = mv(IA[d], S[d])
        dnm[d] = _dot(S[d], U[d]) + 1e-9
        u[d] = tau_eff[..., d] - _dot(S[d], pA[d])
        Ia = IA[d] - U[d][..., :, None] * U[d][..., None, :] / dnm[d][..., None, None]
        pa = pA[d] + mv(Ia, cc[d]) + U[d] * (u[d] / dnm[d])[..., None]
        X = Xup[d]
        Xt = X.transpose(-1, -2)
        IA_up = Xt @ Ia @ X
        pa_up = mv(Xt, pa)
        if d > 0:
            IA[d - 1] = IA[d - 1] + IA_up
            pA[d - 1] = pA[d - 1] + pa_up
        else:
            IA0 = IA0 + IA_up.sum(dim=-3)
            pA0 = pA0 + pa_up.sum(dim=-2)

    # ---- root ----
    if model.root_free:
        a0 = spatial.solve_spd6(IA0 + 1e-9 * torch.eye(6, dtype=dtype, device=dev), -pA0)
    else:
        a0 = torch.zeros_like(pA0)

    # ---- outward pass ----
    qdd_l = [None] * D
    a_par = a0[..., None, :].expand(batch + (L, 6))
    for d in range(D):
        ai = mv(Xup[d], a_par) + cc[d]
        qdd_d = (u[d] - _dot(U[d], ai)) / dnm[d]
        a_par = ai + S[d] * qdd_d[..., None]
        qdd_l[d] = qdd_d

    qdd = torch.zeros_like(q)
    for d in range(D):
        qdd[..., dof[:, d]] = qdd_l[d]

    w_b, v_b = v0[..., :3], v0[..., 3:]
    omega_dot_w = mv(R0, a0[..., :3])
    a_lin_w = mv(R0, a0[..., 3:] + torch.linalg.cross(w_b, v_b, dim=-1))

    # aux: full-tree world kinematics in body-index order (for reuse)
    nb = model.nb
    Rw_full = R0.new_zeros(batch + (nb, 3, 3))
    pw_full = R0.new_zeros(batch + (nb, 3))
    vw_full = R0.new_zeros(batch + (nb, 6))
    Rw_full[..., 0, :, :] = R0
    pw_full[..., 0, :] = base_pos
    vw_full[..., 0, :] = torch.cat([mv(R0, v0[..., :3]), mv(R0, v0[..., 3:])], dim=-1)
    for d in range(D):
        col = torch.as_tensor(bidx[:, d], device=dev)
        Rw_full[..., col, :, :] = Rw[d]
        pw_full[..., col, :] = pw[d]
        vw_full[..., col, :] = torch.cat([mv(Rw[d], v[d][..., :3]), mv(Rw[d], v[d][..., 3:])],
                                         dim=-1)
    return omega_dot_w, a_lin_w, qdd, (Rw_full, pw_full, vw_full)
