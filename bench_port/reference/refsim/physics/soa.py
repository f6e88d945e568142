"""Structure-of-arrays (SoA) batched articulated dynamics, plain PyTorch.

The plain twin of `mqe_tpu/physics/soa.py`, line for line: every physical
scalar is a `(B,)` tensor over the flattened robot batch ("entry"), model
constants stay python floats, and the static body tree is unrolled in Python
into elementwise tensor ops (`jnp.where/clip/maximum/sqrt` map one to one to
their torch counterparts).

Its role in the port: `step_actor` and `fk_spheres` are the references of
the two hand-written CUDA kernels (csrc/fused_step.cu, wrappers in
physics/fused_step.py), and what a CPU tensor runs through. `fk_spheres`
and `fk_full` feed the contact stage of the scene.

Conventions: quats xyzw, body 0 = floating base, motion vectors (angular,
linear), world-frame external wrenches about body origins.
"""
from __future__ import annotations

import math

import torch

from refsim.physics.model import JOINT_PRISMATIC, BodyModel


def _is_t(x):
    return isinstance(x, torch.Tensor)


def _sqrt(x):
    return torch.sqrt(x) if _is_t(x) else math.sqrt(x)


def _maximum(x, c):
    return torch.clamp_min(x, c) if _is_t(x) else max(x, c)


# ---------------------------------------------------------------------------
# small algebra on tuples-of-entries (entries: (B,) arrays or python floats)
# ---------------------------------------------------------------------------


def v3(x, y, z):
    return (x, y, z)


def v_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def v_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def v_scale(a, s):
    return tuple(x * s for x in a)


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def m_vec(M, v):
    return tuple(M[i][0] * v[0] + M[i][1] * v[1] + M[i][2] * v[2] for i in range(3))


def mT_vec(M, v):
    return tuple(M[0][i] * v[0] + M[1][i] * v[1] + M[2][i] * v[2] for i in range(3))


def m_mul(A, B):
    return tuple(
        tuple(sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3))
        for i in range(3)
    )


def m_mulT(A, B):
    """A @ B.T"""
    return tuple(
        tuple(sum(A[i][k] * B[j][k] for k in range(3)) for j in range(3))
        for i in range(3)
    )


def mT_mul(A, B):
    """A.T @ B"""
    return tuple(
        tuple(sum(A[k][i] * B[k][j] for k in range(3)) for j in range(3))
        for i in range(3)
    )


def m_add(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3))


def m_sub(A, B):
    return tuple(tuple(A[i][j] - B[i][j] for j in range(3)) for i in range(3))


def m_skew(p):
    x, y, z = p
    return ((0.0, -z, y), (z, 0.0, -x), (-y, x, 0.0))


def m_outer(a, b):
    return tuple(tuple(a[i] * b[j] for j in range(3)) for i in range(3))


def m_const(M):
    """numpy (3,3) -> Mat3 of python floats."""
    return tuple(tuple(float(M[i][j]) for j in range(3)) for i in range(3))


def quat_to_mat(q):
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def rodrigues(angle, axis):
    """Rotation by `angle` ((B,) array) about static unit `axis` (floats)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    one_c = 1.0 - c
    ax, ay, az = (float(a) for a in axis)
    return (
        (c + one_c * ax * ax, one_c * ax * ay - s * az, one_c * ax * az + s * ay),
        (one_c * ay * ax + s * az, c + one_c * ay * ay, one_c * ay * az - s * ax),
        (one_c * az * ax - s * ay, one_c * az * ay + s * ax, c + one_c * az * az),
    )


# spatial vectors: (w, v) pairs of Vec3; spatial matrices: ((A,B),(C,D)) Mat3 blocks


def s_vec(M, x):
    (A, B), (C, D) = M
    w, v = x
    return (v_add(m_vec(A, w), m_vec(B, v)), v_add(m_vec(C, w), m_vec(D, v)))


def s_add(M, N):
    return tuple(tuple(m_add(M[i][j], N[i][j]) for j in range(2)) for i in range(2))


def s_sub(M, N):
    return tuple(tuple(m_sub(M[i][j], N[i][j]) for j in range(2)) for i in range(2))


def s_outer_scaled(x, y, s):
    """outer(x, y) * s for spatial vectors x, y and entry s."""
    xs = (v_scale(x[0], s), v_scale(x[1], s))
    return (
        (m_outer(xs[0], y[0]), m_outer(xs[0], y[1])),
        (m_outer(xs[1], y[0]), m_outer(xs[1], y[1])),
    )


def s_dot(x, y):
    return v_dot(x[0], y[0]) + v_dot(x[1], y[1])


def cross_motion(v, m):
    w, vl = v
    mw, mv = m
    return (v_cross(w, mw), v_add(v_cross(w, mv), v_cross(vl, mw)))


def cross_force(v, F):
    w, vl = v
    n, f = F
    return (v_add(v_cross(w, n), v_cross(vl, f)), v_cross(w, f))


def solve_spd6(M, b):
    """Unrolled Cholesky solve; M: ((A,B),(C,D)) blocks, b: spatial vector.
    The caller adds the 1e-9 jitter on the diagonal."""
    A = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            A[i][j] = M[0][0][i][j]
            A[i][j + 3] = M[0][1][i][j]
            A[i + 3][j] = M[1][0][i][j]
            A[i + 3][j + 3] = M[1][1][i][j]
    bb = list(b[0]) + list(b[1])
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = _sqrt(_maximum(s, 1e-12))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = bb[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return ((x[0], x[1], x[2]), (x[3], x[4], x[5]))


# ---------------------------------------------------------------------------
# FK / velocities / spheres
# ---------------------------------------------------------------------------


def _fk(model: BodyModel, pos, quat, q):
    """pos: Vec3, quat: (x,y,z,w), q: list of nq entries.

    Returns Rw (list Mat3), pw (list Vec3), Rl, pl (child-in-parent pose;
    entries floats for revolute joints, arrays for prismatic).
    """
    nb = model.nb
    Rw = [None] * nb
    pw = [None] * nb
    Rl = [None] * nb
    pl = [None] * nb
    Rw[0] = quat_to_mat(quat)
    pw[0] = pos
    for i in range(1, nb):
        par = int(model.parent[i])
        jrot = m_const(model.joint_rot[i])
        jpos = tuple(float(c) for c in model.joint_pos[i])
        axis = tuple(float(c) for c in model.joint_axis[i])
        qi = q[i - 1]
        if int(model.joint_type[i]) == JOINT_PRISMATIC:
            Rl[i] = jrot
            pj = v_scale(axis, qi)
            pl[i] = v_add(jpos, m_vec(jrot, pj))
        else:
            Rl[i] = m_mul(jrot, rodrigues(qi, axis))
            pl[i] = jpos
        Rw[i] = m_mul(Rw[par], Rl[i])
        pw[i] = v_add(pw[par], m_vec(Rw[par], pl[i]))
    return Rw, pw, Rl, pl


def _joint_S(model: BodyModel, i):
    """Motion subspace (spatial, child frame) for joint of body i; floats."""
    axis = tuple(float(c) for c in model.joint_axis[i])
    zero = (0.0, 0.0, 0.0)
    if int(model.joint_type[i]) == JOINT_PRISMATIC:
        return (zero, axis)
    return (axis, zero)


def _x_motion(Rl, pl, x):
    """Apply X_up = motion_transform(Rl, pl): v_child = X v_parent."""
    w, vl = x
    return (mT_vec(Rl, w), mT_vec(Rl, v_sub(vl, v_cross(pl, w))))


def _xT_force(Rl, pl, F):
    """Apply X_up^T to a force vector: F_parent = X^T F_child."""
    n, f = F
    Rf = m_vec(Rl, f)
    return (v_add(m_vec(Rl, n), v_cross(pl, Rf)), Rf)


def _body_vels(model: BodyModel, Rw, Rl, pl, lin_vel, ang_vel, qd):
    """Body-frame spatial velocities v and world-frame (w_w, v_origin_w)."""
    nb = model.nb
    v = [None] * nb
    v[0] = (mT_vec(Rw[0], ang_vel), mT_vec(Rw[0], lin_vel))
    for i in range(1, nb):
        par = int(model.parent[i])
        S = _joint_S(model, i)
        vi = _x_motion(Rl[i], pl[i], v[par])
        v[i] = (
            v_add(vi[0], v_scale(S[0], qd[i - 1])),
            v_add(vi[1], v_scale(S[1], qd[i - 1])),
        )
    vw = [(m_vec(Rw[i], v[i][0]), m_vec(Rw[i], v[i][1])) for i in range(nb)]
    return v, vw


def _spheres(model: BodyModel, Rw, pw, vw):
    """World position and point velocity of each collision sphere."""
    xs, vs = [], []
    for s in range(len(model.sph_tags)):
        b = int(model.sph_body[s])
        off = tuple(float(c) for c in model.sph_pos[s])
        x = v_add(pw[b], m_vec(Rw[b], off))
        vel = v_add(vw[b][1], v_cross(vw[b][0], v_sub(x, pw[b])))
        xs.append(x)
        vs.append(vel)
    return xs, vs


# ---------------------------------------------------------------------------
# inertias / wrenches
# ---------------------------------------------------------------------------


def _spatial_inertia_blocks(mass, com, I_com):
    """((A,B),(C,D)) spatial inertia at body origin; any entry types."""
    C = m_skew(com)
    # I_O = I_com + m * C @ C.T
    CCt = m_mulT(C, C)
    A = tuple(tuple(I_com[i][j] + mass * CCt[i][j] for j in range(3)) for i in range(3))
    B = tuple(tuple(mass * C[i][j] for j in range(3)) for i in range(3))
    Ct = tuple(tuple(mass * C[j][i] for j in range(3)) for i in range(3))
    D = ((mass, 0.0, 0.0), (0.0, mass, 0.0), (0.0, 0.0, mass))
    return (A, B), (Ct, D)


def _inertias(model: BodyModel, payload=None, com_shift=None):
    """Per-body spatial inertias; body 0 gets DR payload/CoM shift."""
    out = []
    for i in range(model.nb):
        if i == 0 and (payload is not None or com_shift is not None):
            m0 = float(model.mass[0]) + (payload if payload is not None else 0.0)
            com0 = tuple(float(c) for c in model.com[0])
            if com_shift is not None:
                com0 = v_add(com0, com_shift)
            out.append(_spatial_inertia_blocks(m0, com0, m_const(model.inertia[0])))
        else:
            Sp = model.spatial_inertia[i]
            out.append(
                (
                    (m_const(Sp[:3, :3]), m_const(Sp[:3, 3:])),
                    (m_const(Sp[3:, :3]), m_const(Sp[3:, 3:])),
                )
            )
    return out


def _gravity_wrenches(model: BodyModel, Rw, payload=None, com_shift=None, g=-9.81):
    """World gravity wrench per body about body origin."""
    out = []
    for i in range(model.nb):
        mass = float(model.mass[i])
        com = tuple(float(c) for c in model.com[i])
        if i == 0:
            if payload is not None:
                mass = mass + payload
            if com_shift is not None:
                com = v_add(com, com_shift)
        com_w = m_vec(Rw[i], com)
        f = (0.0, 0.0, mass * g)
        n = v_cross(com_w, f)
        out.append((n, f))
    return out


def _contact_wrenches(model: BodyModel, pw, sph_x, sph_f):
    """Per-sphere world forces -> per-body world wrench about body origin."""
    nb = model.nb
    zero = (0.0, 0.0, 0.0)
    out = [(zero, zero)] * nb
    for s in range(len(model.sph_tags)):
        b = int(model.sph_body[s])
        arm = v_sub(sph_x[s], pw[b])
        n = v_cross(arm, sph_f[s])
        out[b] = (v_add(out[b][0], n), v_add(out[b][1], sph_f[s]))
    return out


# ---------------------------------------------------------------------------
# ABA
# ---------------------------------------------------------------------------


def _aba(model: BodyModel, Ispat, v, Rw, Rl, pl, qd, tau, f_ext_w):
    """Articulated-body algorithm. f_ext_w: list of world wrenches per body.

    Returns (a0 body-frame spatial accel of base, qdd list).
    """
    nb = model.nb
    # external wrench world -> body frame
    f_ext = [
        (mT_vec(Rw[i], f_ext_w[i][0]), mT_vec(Rw[i], f_ext_w[i][1]))
        for i in range(nb)
    ]
    damping = model.joint_damping
    tau_eff = [tau[j] - float(damping[j]) * qd[j] for j in range(nb - 1)]

    IA = list(Ispat)
    pA = [
        (
            v_sub(cross_force(v[i], s_vec(Ispat[i], v[i]))[0], f_ext[i][0]),
            v_sub(cross_force(v[i], s_vec(Ispat[i], v[i]))[1], f_ext[i][1]),
        )
        for i in range(nb)
    ]
    c = [None] * nb
    S = [None] * nb
    for i in range(1, nb):
        S[i] = _joint_S(model, i)
        vJ = (v_scale(S[i][0], qd[i - 1]), v_scale(S[i][1], qd[i - 1]))
        c[i] = cross_motion(v[i], vJ)

    U = [None] * nb
    d = [None] * nb
    u = [None] * nb
    for i in range(nb - 1, 0, -1):
        par = int(model.parent[i])
        U[i] = s_vec(IA[i], S[i])
        d[i] = s_dot(S[i], U[i]) + 1e-9
        u[i] = tau_eff[i - 1] - s_dot(S[i], pA[i])
        inv_d = 1.0 / d[i]
        Ia = s_sub(IA[i], s_outer_scaled(U[i], U[i], inv_d))
        Iac = s_vec(Ia, c[i])
        Uu = (v_scale(U[i][0], u[i] * inv_d), v_scale(U[i][1], u[i] * inv_d))
        pa = (v_add(v_add(pA[i][0], Iac[0]), Uu[0]), v_add(v_add(pA[i][1], Iac[1]), Uu[1]))

        # IA[par] += X^T Ia X with X = [[Rt, 0], [-Rt phat, Rt]]
        R = Rl[i]
        Rt = tuple(tuple(R[j][k] for j in range(3)) for k in range(3))
        RtP = m_mul(Rt, m_skew(pl[i]))         # Rt @ phat
        PR = m_mul(m_skew(pl[i]), R)           # phat @ R
        (A, B), (C, D) = Ia
        M11 = m_sub(m_mul(A, Rt), m_mul(B, RtP))
        M12 = m_mul(B, Rt)
        M21 = m_sub(m_mul(C, Rt), m_mul(D, RtP))
        M22 = m_mul(D, Rt)
        N11 = m_add(m_mul(R, M11), m_mul(PR, M21))
        N12 = m_add(m_mul(R, M12), m_mul(PR, M22))
        N21 = m_mul(R, M21)
        N22 = m_mul(R, M22)
        IA[par] = s_add(IA[par], ((N11, N12), (N21, N22)))
        pA[par] = (
            v_add(pA[par][0], _xT_force(Rl[i], pl[i], pa)[0]),
            v_add(pA[par][1], _xT_force(Rl[i], pl[i], pa)[1]),
        )

    if model.root_free:
        # +1e-9 I jitter on the diagonal blocks
        (A, B), (C, D) = IA[0]
        A = tuple(
            tuple(A[i][j] + (1e-9 if i == j else 0.0) for j in range(3)) for i in range(3)
        )
        D = tuple(
            tuple(D[i][j] + (1e-9 if i == j else 0.0) for j in range(3)) for i in range(3)
        )
        neg = (v_scale(pA[0][0], -1.0), v_scale(pA[0][1], -1.0))
        a0 = solve_spd6(((A, B), (C, D)), neg)
    else:
        zero_like = pA[0][0][0] * 0.0
        z3 = (zero_like, zero_like, zero_like)
        a0 = (z3, z3)

    a = [None] * nb
    a[0] = a0
    qdd = [None] * (nb - 1)
    for i in range(1, nb):
        par = int(model.parent[i])
        ai = _x_motion(Rl[i], pl[i], a[par])
        ai = (v_add(ai[0], c[i][0]), v_add(ai[1], c[i][1]))
        qdd_i = (u[i] - s_dot(U[i], ai)) / d[i]
        a[i] = (
            v_add(ai[0], v_scale(S[i][0], qdd_i)),
            v_add(ai[1], v_scale(S[i][1], qdd_i)),
        )
        qdd[i - 1] = qdd_i
    return a0, qdd


# ---------------------------------------------------------------------------
# integrator (semi-implicit Euler)
# ---------------------------------------------------------------------------


def _quat_integrate(quat, omega, dt):
    wx, wy, wz = omega
    angle = torch.sqrt(wx * wx + wy * wy + wz * wz)
    inv = 1.0 / torch.clamp_min(angle, 1e-9)
    half = 0.5 * angle * dt
    s = torch.sin(half) * inv
    dq = (wx * s, wy * s, wz * s, torch.cos(half))
    small = angle < 1e-9
    one = torch.ones_like(angle)
    dq = tuple(
        torch.where(small, ident, comp)
        for ident, comp in zip((0.0 * one, 0.0 * one, 0.0 * one, one), dq)
    )
    ax, ay, az, aw = dq
    bx, by, bz, bw = quat
    out = (
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    )
    norm = torch.clamp_min(
        torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2), 1e-9
    )
    return tuple(c / norm for c in out)


def _integrate(model, pos, quat, lv, av, q, qd, omega_dot_w, a_lin_w, qdd, dt,
               max_lin_vel=100.0, max_ang_vel=50.0):
    av = tuple(torch.clamp(a + dt * da, -max_ang_vel, max_ang_vel) for a, da in zip(av, omega_dot_w))
    lv = tuple(torch.clamp(vv + dt * da, -max_lin_vel, max_lin_vel) for vv, da in zip(lv, a_lin_w))
    pos = tuple(p + dt * vv for p, vv in zip(pos, lv))
    quat = _quat_integrate(quat, av, dt)
    new_q, new_qd = [], []
    for j in range(model.nq):
        qdj = qd[j] + dt * qdd[j]
        lim = float(model.qd_limit[j])
        qdj = torch.clamp(qdj, -lim, lim)
        qj = q[j] + dt * qdj
        lo, hi = float(model.q_lower[j]), float(model.q_upper[j])
        at_lo = qj < lo
        at_hi = qj > hi
        qj = torch.clamp(qj, lo, hi)
        # a joint stop zeroes qd only when qd points outward
        qdj = torch.where(at_lo & (qdj < 0), 0.0, qdj)
        qdj = torch.where(at_hi & (qdj > 0), 0.0, qdj)
        new_q.append(qj)
        new_qd.append(qdj)
    return pos, quat, lv, av, new_q, new_qd


# ---------------------------------------------------------------------------
# public batched API ((..., k) tensors in, same out; batch shape free)
# ---------------------------------------------------------------------------


def _cols(x):
    return tuple(x[..., i] for i in range(x.shape[-1]))


def _pack(cols):
    return torch.stack(cols, dim=-1)


def fk_spheres(model: BodyModel, pos, quat, lin_vel, ang_vel, q, qd):
    """Sphere world positions/velocities. Args (..., k); returns (..., ns, 3)."""
    Rw, pw, Rl, pl = _fk(model, _cols(pos), _cols(quat), _cols(q))
    _, vw = _body_vels(model, Rw, Rl, pl, _cols(lin_vel), _cols(ang_vel), _cols(qd))
    xs, vs = _spheres(model, Rw, pw, vw)
    sph_x = torch.stack([_pack(x) for x in xs], dim=-2)
    sph_v = torch.stack([_pack(v) for v in vs], dim=-2)
    return sph_x, sph_v


def fk_full(model: BodyModel, pos, quat, lin_vel, ang_vel, q, qd):
    """FK packed for AoS consumers (e.g. the NPC primitive contact).

    Returns Rw (..., nb, 3, 3), pw (..., nb, 3), vw (..., nb, 6) and sphere
    arrays (..., ns, 3) x2.
    """
    Rw, pw, Rl, pl = _fk(model, _cols(pos), _cols(quat), _cols(q))
    _, vw = _body_vels(model, Rw, Rl, pl, _cols(lin_vel), _cols(ang_vel), _cols(qd))
    xs, vs = _spheres(model, Rw, pw, vw)
    batch = pos.shape[:-1]

    def ent(e):
        return torch.as_tensor(e, dtype=pos.dtype, device=pos.device).expand(batch)

    Rw_a = torch.stack(
        [torch.stack([torch.stack([ent(R[i][j]) for j in range(3)], -1) for i in range(3)], -2)
         for R in Rw], dim=-3,
    )
    pw_a = torch.stack([torch.stack([ent(c) for c in p], -1) for p in pw], dim=-2)
    vw_a = torch.stack(
        [torch.stack([ent(c) for c in w] + [ent(c) for c in v], -1) for (w, v) in vw],
        dim=-2,
    )
    if len(model.sph_tags):
        sph_x = torch.stack([_pack(x) for x in xs], dim=-2)
        sph_v = torch.stack([_pack(v) for v in vs], dim=-2)
    else:
        sph_x = pos.new_zeros(batch + (0, 3))
        sph_v = pos.new_zeros(batch + (0, 3))
    return Rw_a, pw_a, vw_a, sph_x, sph_v


def step_entries(
    model: BodyModel,
    p3, q4, lv, av, ql, qdl,    # entry tuples (len 3/4/3/3/nq/nq)
    taul,                        # entry tuple (nq,)
    sph_xs, sph_fs,              # lists of per-sphere 3-entry tuples (world)
    pay=None, cs=None,           # payload entry, com-shift 3-entry tuple
    extra=None,                  # per-body [(w3, v3)] world wrenches or None
    dt=0.0025,
    root_free=None,
):
    """Entry-level dynamics+integration core: contact/gravity wrenches ->
    ABA -> semi-implicit Euler, all as elementwise ops on entries of ANY
    broadcastable shape. csrc/fused_step.cu computes the same chain, one
    lane per body. Returns entry tuples (pos, quat, lin_vel, ang_vel, q, qd).

    Two switches on purpose: `_aba` picks the base solve from
    `model.root_free`, the world accelerations are zeroed from the
    `root_free` argument (default: `model.root_free`)."""
    Rw, pw, Rl, pl = _fk(model, p3, q4, ql)
    v, vw = _body_vels(model, Rw, Rl, pl, lv, av, qdl)

    wr = _contact_wrenches(model, pw, sph_xs, sph_fs)
    gw = _gravity_wrenches(model, Rw, pay, cs)
    f_ext = [
        (v_add(wr[i][0], gw[i][0]), v_add(wr[i][1], gw[i][1]))
        for i in range(model.nb)
    ]
    if extra is not None:
        f_ext = [
            (v_add(f_ext[i][0], extra[i][0]), v_add(f_ext[i][1], extra[i][1]))
            for i in range(model.nb)
        ]

    Ispat = _inertias(model, pay, cs)
    a0, qdd = _aba(model, Ispat, v, Rw, Rl, pl, qdl, taul, f_ext)
    if root_free is None:
        root_free = model.root_free

    w_b, v_b = v[0]
    omega_dot_w = m_vec(Rw[0], a0[0])
    a_lin_w = m_vec(Rw[0], v_add(a0[1], v_cross(w_b, v_b)))
    if not root_free:
        # welded root: zero the WORLD accelerations (incl. the w x v term)
        zero = p3[0] * 0.0
        omega_dot_w = (zero, zero, zero)
        a_lin_w = (zero, zero, zero)

    return _integrate(
        model, p3, q4, lv, av, ql, qdl, omega_dot_w, a_lin_w, qdd, dt
    )


def step_actor(
    model: BodyModel,
    pos, quat, lin_vel, ang_vel, q, qd,       # (..., k) state
    tau,                                      # (..., nq)
    sph_force, sph_x,                         # (..., ns, 3) world
    payload=None, com_shift=None,             # (...,), (..., 3) trunk DR
    extra_wrench=None,                        # (..., nb, 6) world (NPC coupling)
    dt=0.0025,
    root_free=None,
):
    """One dynamics+integration step for a batch of one actor type.

    Contact/gravity wrenches -> ABA -> semi-implicit Euler. Returns the six
    new state tensors.
    """
    sph_xs = [tuple(sph_x[..., s, i] for i in range(3)) for s in range(sph_x.shape[-2])]
    sph_fs = [tuple(sph_force[..., s, i] for i in range(3)) for s in range(sph_force.shape[-2])]
    extra = None
    if extra_wrench is not None:
        extra = [
            (
                tuple(extra_wrench[..., i, k] for k in range(3)),
                tuple(extra_wrench[..., i, k] for k in range(3, 6)),
            )
            for i in range(model.nb)
        ]
    np_, nq_, nlv, nav, nql, nqdl = step_entries(
        model,
        _cols(pos), _cols(quat), _cols(lin_vel), _cols(ang_vel),
        _cols(q), _cols(qd), _cols(tau),
        sph_xs, sph_fs,
        pay=payload,
        cs=_cols(com_shift) if com_shift is not None else None,
        extra=extra,
        dt=dt,
        root_free=root_free,
    )
    empty = pos.new_zeros(pos.shape[:-1] + (0,))
    return (
        _pack(np_), _pack(nq_), _pack(nlv), _pack(nav),
        _pack(nql) if model.nq else empty,
        _pack(nqdl) if model.nq else empty,
    )
