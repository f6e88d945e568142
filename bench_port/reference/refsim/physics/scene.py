"""Composed physics of the robots and NPCs of a batch of envs, one substep
at a time.

PyTorch counterpart of `mqe_tpu/physics/scene.py::substep_batch`: forward
kinematics of the robots' collision spheres and of the NPCs' bodies and
spheres -> contact forces against the ground, the env's wall boxes and static
fixtures (boxes and vertical cylinders), the other robots' coarse spheres and
the NPCs' collision primitives (with the reaction wrench on the NPC bodies),
and of the NPCs' spheres against the ground, the boxes, the fixtures and each
other (physics/contact.py,
batched over the env axis where the JAX package vmaps) -> the dynamics
substep of the robots, then of the NPCs. The sphere FK, the full FK and the
dynamics substep are the entry points of physics/fused_step.py: CUDA kernels
for CUDA tensors, their plain versions (physics/soa.py) for CPU tensors.

`substep` is the counterpart of the JAX package's `scene.substep` under
`vmap`, the array-of-structures (AoS) path a `SceneModel` with
`use_soa=False` runs: the same contact functions, then the per-tree 6x6
spatial dynamics of physics/dynamics.py and star_dynamics.py and
physics/integrator.py. It launches none of the kernels and calls nothing of
physics/soa.py, so it checks the SoA path and its kernels by a second
derivation.

Actor layout: agents first, then NPCs; per-agent tensors carry (E, A, ...),
per-NPC tensors (E, N, ...).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from refsim.physics import contact as C
from refsim.physics import dynamics, integrator, spatial
from refsim.physics.fused_step import (
    fk_full_kernel,
    fk_spheres_kernel,
    step_actor_kernel,
)
from refsim.physics.model import PRIM_BOX, PRIM_SPHERE, BodyModel
from refsim.physics.spatial import mv
from refsim.physics.star_dynamics import forward_dynamics_star, star_layout


@dataclass
class ActorState:
    pos: torch.Tensor       # (..., A, 3)
    quat: torch.Tensor      # (..., A, 4) xyzw
    lin_vel: torch.Tensor   # (..., A, 3) world
    ang_vel: torch.Tensor   # (..., A, 3) world
    q: torch.Tensor         # (..., A, nq)
    qd: torch.Tensor        # (..., A, nq)


@dataclass
class PhysState:
    agents: ActorState
    npcs: ActorState        # zero-A actor state when the task has no NPCs


@dataclass
class Terrain:
    height: torch.Tensor    # (X, Y) meters, shared across envs
    origin: torch.Tensor    # (2,) world xy of cell (0, 0)
    scale: float            # meters per cell
    boxes: torch.Tensor     # (E, nbox, 7) per env: center(3) half(3) valid
    # a static fixture's geoms per env, split by kind when the env is built:
    # (E, Gb, 7) boxes as `boxes`, (E, Gc, 6) vertical cylinders: center(3)
    # radius, half length, valid
    static_boxes: torch.Tensor
    static_cyls: torch.Tensor


# row kinds of the env's (E, G, 8) static geom table (kind, center(3), p0,
# p1, p2, valid; a box row's p is its half extents, a cylinder row's
# (radius, half length, 0)), the JAX package's layout
SG_BOX = 0.0
SG_CYL = 1.0


@dataclass
class DomainRand:
    mu_scale: torch.Tensor        # (E,) friction multiplier
    payload: torch.Tensor         # (E, A) extra trunk mass
    com_shift: torch.Tensor       # (E, A, 3) trunk com displacement
    motor_strength: torch.Tensor  # (E, A, nq) torque multiplier (env layer)


@dataclass
class Contacts:
    sphere_force: torch.Tensor    # (E, A, ns, 3) world force on each agent sphere
    npc_sphere_force: torch.Tensor  # (E, N, ns_npc, 3); (E, 0, 0, 3) without NPCs
    feet_force: torch.Tensor      # (E, A, 4, 3) foot spheres


@dataclass(frozen=True)
class SceneModel:
    """Static scene description."""

    robot: BodyModel
    num_agents: int
    npc: BodyModel | None = None
    num_npcs: int = 0
    npc_root_free: bool = True
    contact: C.ContactParams = C.DEFAULT_PARAMS
    self_collision: bool = True
    # the SoA dynamics (physics/soa.py and its CUDA kernels) through
    # substep_batch; False runs `substep`, the AoS reference path
    use_soa: bool = True
    # ground height when the heightfield is constant (every predefined task):
    # analytic plane contact. None = sample the heightfield.
    flat_height: float | None = None

    def foot_sphere_indices(self) -> np.ndarray:
        idx = [i for i, t in enumerate(self.robot.sph_tags) if "foot" in t]
        return np.array(idx, dtype=np.int64)

    def coarse_sphere_indices(self) -> np.ndarray:
        """Spheres used for agent-agent collision (trunk + head + hips)."""
        idx = [
            i
            for i, t in enumerate(self.robot.sph_tags)
            if ("trunk" in t or "collision_box" in t or "hip" in t)
        ]
        return np.array(idx, dtype=np.int64)


def _terrain_and_box_force(pos, vel, radius, terrain: Terrain, params, mu_scale,
                           flat_height=None):
    """Force on spheres from the ground, each env's wall boxes and its static
    geoms, summed in that order.

    pos/vel: (E, S, 3); radius: (S,); mu_scale: (E,). Returns (E, S, 3).
    """
    mu = mu_scale[:, None]
    if flat_height is not None:
        f = C.sphere_plane(pos, vel, radius, flat_height, params, mu)
    else:
        f = C.sphere_heightfield(
            pos, vel, radius, terrain.height, terrain.origin, terrain.scale, params, mu
        )
    x, v, r = pos[:, :, None, :], vel[:, :, None, :], radius[None, :, None]
    # the static geoms after the wall boxes, as JAX sums them; each kind's
    # force only over its own rows (JAX computes both on every row and picks
    # one by the row's kind: the same sums where a fixture has one kind, as
    # every fixture of the repo has)
    for rows in (terrain.boxes, terrain.static_boxes):      # (E, nbox, 7)
        if rows.shape[1]:
            fb = C.sphere_box(x, v, r, rows[:, None, :, 0:3], rows[:, None, :, 3:6], params,
                              mu[..., None])               # (E, S, nbox, 3)
            f = f + (fb * rows[:, None, :, 6, None]).sum(dim=2)
    cyls = terrain.static_cyls                              # (E, Gc, 6)
    if cyls.shape[1]:
        fc = C.sphere_vertical_cylinder(x, v, r, cyls[:, None, :, 0:3], cyls[:, None, :, 3],
                                        cyls[:, None, :, 4], params, mu[..., None])
        f = f + (fc * cyls[:, None, :, 5, None]).sum(dim=2)
    return f


def _npc_prim_force(scene: SceneModel, sph_x, sph_v, sph_r, npc_Rw, npc_pw, npc_vw, params,
                    mu_scale):
    """Agent spheres vs NPC collision primitives, over the env batch.

    sph_x/v: (E, S, 3) agent spheres, agent-major; sph_r: (S,); npc_*: FK of
    the NPCs, (E, N, nb_n, ...); mu_scale: (E,). Returns (E, S, 3) force on
    the spheres and (E, N, nb_n, 6) reaction wrench on the NPC bodies (world,
    about the body origin). Sums keep the JAX package's order: the sphere
    force over N, the reaction over S.
    """
    npc = scene.npc
    E = sph_x.shape[0]
    dt_ = sph_x.dtype
    mu = mu_scale[:, None, None]
    f_sph = torch.zeros_like(sph_x)
    wrench = torch.zeros((E, scene.num_npcs, npc.nb, 6), dtype=dt_, device=sph_x.device)
    r = sph_r[:, None]                                       # (S, 1)
    for pi in range(len(npc.prim_tags)):
        b = int(npc.prim_body[pi])
        kind = int(npc.prim_kind[pi])
        ppos = torch.as_tensor(npc.prim_pos[pi], dtype=dt_, device=sph_x.device)
        prot = torch.as_tensor(npc.prim_rot[pi], dtype=dt_, device=sph_x.device)
        psize = np.asarray(npc.prim_size[pi])
        # world pose of the prim frame, per NPC
        Rb = npc_Rw[:, :, b]                                 # (E, N, 3, 3)
        pb = npc_pw[:, :, b]                                 # (E, N, 3)
        Rp = Rb @ prot
        pp = pb + torch.einsum("enij,j->eni", Rb, ppos)
        w_n = npc_vw[:, :, b, :3]
        v_n0 = npc_vw[:, :, b, 3:]

        # the spheres in the prim frame: (E, S, N, 3)
        x = sph_x[:, :, None, :]
        rel = x - pp[:, None]
        x_local = torch.einsum("enji,esnj->esni", Rp, rel)  # R^T @ rel
        v_npc_at_x = v_n0[:, None] + torch.linalg.cross(w_n[:, None], x - pb[:, None], dim=-1)
        v_rel = sph_v[:, :, None, :] - v_npc_at_x
        v_local = torch.einsum("enji,esnj->esni", Rp, v_rel)

        if kind == PRIM_SPHERE:
            f_local = C.sphere_sphere(
                x_local, v_local, r, torch.zeros_like(x_local), torch.zeros_like(v_local),
                float(psize[0]), params, mu,
            )
        elif kind == PRIM_BOX:
            half = torch.as_tensor(psize / 2.0, dtype=dt_, device=sph_x.device)
            f_local = C.sphere_box(x_local, v_local, r, torch.zeros(3, dtype=dt_, device=sph_x.device),
                                   half, params, mu)
        else:  # cylinder (axis = prim z)
            f_local = C.sphere_vertical_cylinder(
                x_local, v_local, r, torch.zeros(3, dtype=dt_, device=sph_x.device),
                float(psize[0]), float(psize[1]) / 2.0, params, mu,
            )
        f_world = torch.einsum("enij,esnj->esni", Rp, f_local)  # (E, S, N, 3)
        f_sph = f_sph + f_world.sum(dim=2)
        # reaction on NPC body b, the arm taken at the sphere center
        react = -f_world
        arm = x - pb[:, None]
        wrench[:, :, b, :3] += torch.linalg.cross(arm, react, dim=-1).sum(dim=1)
        wrench[:, :, b, 3:] += react.sum(dim=1)
    return f_sph, wrench


def _sphere_pairs(x, v, r, instances, params, mu_scale):
    """Force on each of the (E, P) spheres x, v (radii r (P,)) from every
    sphere of another instance (`instances` (P,)); mu_scale (E,)."""
    ff = C.sphere_sphere(
        x[:, :, None, :], v[:, :, None, :], r[:, None],
        x[:, None, :, :], v[:, None, :, :], r[None, :], params, mu_scale[:, None, None],
    )                                                       # (E, P, P, 3)
    mask = (instances[:, None] != instances[None, :]).to(ff.dtype)
    return (ff * mask[..., None]).sum(dim=2)


def substep_batch(scene: SceneModel, terrain: Terrain, state: PhysState, tau,
                  dr: DomainRand, dt: float, npc_tau=None):
    """One physics substep for the whole env batch.

    state: actor tensors with a leading env axis (E, A, ...) and (E, N, ...);
    tau (E, A, nq); npc_tau (E, N, nq_npc), zero when not given (the env's
    NPCs are passive, as the JAX package's env passes them zero torques).
    Returns (new PhysState, Contacts).
    """
    robot = scene.robot
    A = scene.num_agents
    N = scene.num_npcs
    params = scene.contact
    ag = state.agents
    E = ag.pos.shape[0]
    ns = len(robot.sph_tags)
    dev = ag.pos.device

    def flat(x):
        return x.reshape((E * A,) + x.shape[2:])

    # ---- agent kinematics + spheres (SoA over E*A robots) ----
    sph_x_f, sph_v_f = fk_spheres_kernel(
        robot, flat(ag.pos), flat(ag.quat), flat(ag.lin_vel), flat(ag.ang_vel),
        flat(ag.q), flat(ag.qd),
    )
    sph_r = torch.as_tensor(robot.sph_radius, dtype=sph_x_f.dtype, device=dev)

    # ---- NPC kinematics (SoA over E*N) ----
    npc = scene.npc
    if N > 0:
        nc = state.npcs
        ns_n = len(npc.sph_tags)

        def nflat(x):
            return x.reshape((E * N,) + x.shape[2:])

        nRw_f, npw_f, nvw_f, nsx_f, nsv_f = fk_full_kernel(
            npc, nflat(nc.pos), nflat(nc.quat), nflat(nc.lin_vel),
            nflat(nc.ang_vel), nflat(nc.q), nflat(nc.qd),
        )
        nsph_r = torch.as_tensor(npc.sph_radius, dtype=sph_x_f.dtype, device=dev)

    # ---- contact forces, batched over the env axis ----
    sx = sph_x_f.reshape(E, A * ns, 3)
    sv = sph_v_f.reshape(E, A * ns, 3)
    flat_r = sph_r.repeat(A)
    force = _terrain_and_box_force(
        sx, sv, flat_r, terrain, params, dr.mu_scale, scene.flat_height
    )
    if N > 0:
        f_npc, npc_wrench = _npc_prim_force(
            scene, sx, sv, flat_r, nRw_f.reshape(E, N, npc.nb, 3, 3),
            npw_f.reshape(E, N, npc.nb, 3), nvw_f.reshape(E, N, npc.nb, 6),
            params, dr.mu_scale,
        )
        force = force + f_npc
        # NPC spheres vs the ground and the wall boxes, then each other
        nfx = nsx_f.reshape(E, N * ns_n, 3)
        nfv = nsv_f.reshape(E, N * ns_n, 3)
        nfr = nsph_r.repeat(N)
        nsph_f = _terrain_and_box_force(
            nfx, nfv, nfr, terrain, params, dr.mu_scale, scene.flat_height
        )
        if N > 1:
            inst = torch.arange(N, device=dev).repeat_interleave(ns_n)
            nsph_f = nsph_f + _sphere_pairs(nfx, nfv, nfr, inst, params, dr.mu_scale)
        nsph_f = nsph_f.reshape(E, N, ns_n, 3)
    if A > 1 and scene.self_collision:
        ci = torch.as_tensor(scene.coarse_sphere_indices(), device=dev)
        nc_ = ci.shape[0]
        cx = sph_x_f.reshape(E, A, ns, 3)[:, :, ci].reshape(E, A * nc_, 3)
        cv = sph_v_f.reshape(E, A, ns, 3)[:, :, ci].reshape(E, A * nc_, 3)
        inst = torch.arange(A, device=dev).repeat_interleave(nc_)
        fcoarse = _sphere_pairs(cx, cv, sph_r[ci].repeat(A), inst, params,
                                dr.mu_scale).reshape(E, A, nc_, 3)
        force = force.reshape(E, A, ns, 3)
        force = force.index_add(2, ci, fcoarse)
    force = force.reshape(E, A, ns, 3)

    # ---- agent dynamics: the CUDA kernel for CUDA tensors ----
    np_, nq_, nlv, nav, nql, nqdl = step_actor_kernel(
        robot,
        flat(ag.pos), flat(ag.quat), flat(ag.lin_vel), flat(ag.ang_vel),
        flat(ag.q), flat(ag.qd), flat(tau),
        force.reshape(E * A, ns, 3), sph_x_f,
        payload=dr.payload.reshape(E * A),
        com_shift=dr.com_shift.reshape(E * A, 3),
        dt=dt,
    )

    def unflat(x):
        return x.reshape((E, A) + x.shape[1:])

    new_agents = ActorState(
        unflat(np_), unflat(nq_), unflat(nlv), unflat(nav), unflat(nql), unflat(nqdl)
    )

    # ---- NPC dynamics: the same kernel, with the reaction wrench ----
    if N > 0:
        if npc_tau is None:
            npc_tau = torch.zeros((E, N, npc.nq), dtype=sph_x_f.dtype, device=dev)

        def nunflat(x):
            return x.reshape((E, N) + x.shape[1:])

        nout = step_actor_kernel(
            npc,
            nflat(nc.pos), nflat(nc.quat), nflat(nc.lin_vel), nflat(nc.ang_vel),
            nflat(nc.q), nflat(nc.qd), nflat(npc_tau),
            nsph_f.reshape(E * N, ns_n, 3), nsx_f,
            extra_wrench=npc_wrench.reshape(E * N, npc.nb, 6),
            dt=dt,
            root_free=scene.npc_root_free,
        )
        new_npcs = ActorState(*(nunflat(x) for x in nout))
    else:
        new_npcs = state.npcs
        nsph_f = torch.zeros((E, 0, 0, 3), dtype=sph_x_f.dtype, device=dev)

    fi = torch.as_tensor(scene.foot_sphere_indices(), device=dev)
    contacts = Contacts(sphere_force=force, npc_sphere_force=nsph_f, feet_force=force[:, :, fi])
    return PhysState(agents=new_agents, npcs=new_npcs), contacts


# ---------------------------------------------------------------------------
# the AoS reference path (use_soa=False): per-tree 6x6 spatial dynamics
# ---------------------------------------------------------------------------

_SPH_ONEHOT_CACHE: dict = {}


def _sphere_onehot(model: BodyModel, like) -> torch.Tensor:
    """(nb, ns) constant 0/1 matrix mapping spheres to their bodies."""
    key = (id(model), like.dtype, str(like.device))
    hit = _SPH_ONEHOT_CACHE.get(key)
    if hit is None or hit[0] is not model:
        m = np.zeros((model.nb, len(model.sph_tags)), dtype=np.float32)
        m[model.sph_body, np.arange(len(model.sph_tags))] = 1.0
        # the model is kept beside its matrix so that its id is not reused
        hit = (model, torch.as_tensor(m, dtype=like.dtype, device=like.device))
        _SPH_ONEHOT_CACHE[key] = hit
    return hit[1]


def _sphere_world(model: BodyModel, Rw, pw, vw):
    """World position and velocity of each collision sphere.

    Rw (..., nb, 3, 3), pw (..., nb, 3), vw (..., nb, 6). Returns (..., ns, 3)
    twice. Each sphere's body pose is gathered by index, where the JAX
    package multiplies by the one-hot matrix: the same values.
    """
    b = torch.as_tensor(model.sph_body, dtype=torch.int64, device=pw.device)
    Rb = Rw[..., b, :, :]
    pb = pw[..., b, :]
    x = pb + mv(Rb, torch.as_tensor(model.sph_pos, dtype=pw.dtype, device=pw.device))
    w = vw[..., b, :3]
    v0 = vw[..., b, 3:]
    v = v0 + torch.linalg.cross(w, x - pb, dim=-1)
    return x, v


def _accumulate_wrench(model: BodyModel, pw, sph_x, force):
    """Per-sphere world forces -> per-body world wrench about the body origin.

    pw (..., nb, 3); sph_x, force (..., ns, 3). Returns (..., nb, 6). Summed
    over each body's spheres by the one-hot matrix product, as JAX sums.
    """
    M = _sphere_onehot(model, force)
    b = torch.as_tensor(model.sph_body, dtype=torch.int64, device=pw.device)
    arm = sph_x - pw[..., b, :]
    torque = torch.linalg.cross(arm, force, dim=-1)
    return torch.cat([M @ torque, M @ force], dim=-1)


def _gravity_wrench(model: BodyModel, Rw, payload=None, com_shift=None, g=-9.81):
    """(..., nb, 6) gravity wrench per body (world, about the body origin);
    payload (...,) and com_shift (..., 3) change the trunk's mass and com."""
    batch = Rw.shape[:-3]
    c = lambda x: torch.as_tensor(x, dtype=Rw.dtype, device=Rw.device)  # noqa: E731
    mass = c(model.mass).expand(batch + (model.nb,))
    com = c(model.com).expand(batch + (model.nb, 3))
    if payload is not None:
        mass = torch.cat([(mass[..., 0] + payload)[..., None], mass[..., 1:]], dim=-1)
    if com_shift is not None:
        com = torch.cat([(com[..., 0, :] + com_shift)[..., None, :], com[..., 1:, :]], dim=-2)
    com_w = mv(Rw, com)
    f = torch.zeros_like(com_w)
    f[..., 2] = mass * g
    n = torch.linalg.cross(com_w, f, dim=-1)
    return torch.cat([n, f], dim=-1)


def _spatial_inertias(model: BodyModel, payload, com_shift):
    """(..., nb, 6, 6) spatial inertias with the trunk's DR-modified one."""
    c = lambda x: torch.as_tensor(x, dtype=payload.dtype, device=payload.device)  # noqa: E731
    Ispat = c(model.spatial_inertia)
    m0 = c(model.mass[0]) + payload
    com0 = c(model.com[0]) + com_shift
    I0 = spatial.spatial_inertia(m0, com0, c(model.inertia[0]).expand(com0.shape[:-1] + (3, 3)))
    rest = Ispat[1:].expand(payload.shape + Ispat[1:].shape)
    return torch.cat([I0[..., None, :, :], rest], dim=-3)


def _tree_kinematics(model: BodyModel, st: ActorState):
    """FK and world velocities of actor trees: (Rw, pw, vw)."""
    Rw, pw, X_up, S_, _, _ = dynamics.kinematics(model, st.pos, st.quat, st.q)
    _, vw = dynamics.body_velocities(model, Rw, X_up, S_, st.lin_vel, st.ang_vel, st.qd)
    return Rw, pw, vw


def substep(scene: SceneModel, terrain: Terrain, state: PhysState, tau, dr: DomainRand,
            dt: float, npc_tau=None):
    """One physics substep for the whole env batch by the AoS formulation.

    The counterpart of the JAX package's `scene.substep` vmapped over the env
    axis: the same arguments and returns as `substep_batch`. Contact is
    `substep_batch`'s (the functions of this module); the robots' dynamics
    is `forward_dynamics_star` when their tree is a star of equal chains,
    else `dynamics.forward_dynamics`; the NPCs' is `forward_dynamics`, with
    the base's accelerations zeroed when `npc_root_free` is off.
    """
    robot = scene.robot
    A = scene.num_agents
    N = scene.num_npcs
    params = scene.contact
    ag = state.agents
    E = ag.pos.shape[0]
    ns = len(robot.sph_tags)
    dev = ag.pos.device

    # ---- agent kinematics ----
    Rw, pw, vw = _tree_kinematics(robot, ag)
    sph_x, sph_v = _sphere_world(robot, Rw, pw, vw)       # (E, A, ns, 3)
    sph_r = torch.as_tensor(robot.sph_radius, dtype=sph_x.dtype, device=dev)

    # ---- NPC kinematics ----
    npc = scene.npc
    if N > 0:
        nc = state.npcs
        ns_n = len(npc.sph_tags)
        nRw, npw, nvw = _tree_kinematics(npc, nc)
        nsph_x, nsph_v = _sphere_world(npc, nRw, npw, nvw)
        nsph_r = torch.as_tensor(npc.sph_radius, dtype=sph_x.dtype, device=dev)

    # ---- contact forces on the agent spheres ----
    sx = sph_x.reshape(E, A * ns, 3)
    sv = sph_v.reshape(E, A * ns, 3)
    flat_r = sph_r.repeat(A)
    force = _terrain_and_box_force(sx, sv, flat_r, terrain, params, dr.mu_scale,
                                   scene.flat_height)
    if N > 0:
        f_npc, npc_wrench = _npc_prim_force(scene, sx, sv, flat_r, nRw, npw, nvw, params,
                                            dr.mu_scale)
        force = force + f_npc
        # NPC spheres vs the ground and the wall boxes, then each other
        nfx = nsph_x.reshape(E, N * ns_n, 3)
        nfv = nsph_v.reshape(E, N * ns_n, 3)
        nfr = nsph_r.repeat(N)
        nsph_f = _terrain_and_box_force(nfx, nfv, nfr, terrain, params, dr.mu_scale,
                                        scene.flat_height)
        if N > 1:
            inst = torch.arange(N, device=dev).repeat_interleave(ns_n)
            nsph_f = nsph_f + _sphere_pairs(nfx, nfv, nfr, inst, params, dr.mu_scale)
        nsph_f = nsph_f.reshape(E, N, ns_n, 3)

    # ---- agent-agent collision (coarse spheres) ----
    if A > 1 and scene.self_collision:
        ci = torch.as_tensor(scene.coarse_sphere_indices(), device=dev)
        nc_ = ci.shape[0]
        cx = sph_x[:, :, ci].reshape(E, A * nc_, 3)
        cv = sph_v[:, :, ci].reshape(E, A * nc_, 3)
        inst = torch.arange(A, device=dev).repeat_interleave(nc_)
        fcoarse = _sphere_pairs(cx, cv, sph_r[ci].repeat(A), inst, params,
                                dr.mu_scale).reshape(E, A, nc_, 3)
        force = force.reshape(E, A, ns, 3).index_add(2, ci, fcoarse)
    force = force.reshape(E, A, ns, 3)

    # ---- agent dynamics ----
    robot_fd = (forward_dynamics_star if star_layout(robot) is not None
                else dynamics.forward_dynamics)
    Ispat = _spatial_inertias(robot, dr.payload, dr.com_shift)
    wrench = _accumulate_wrench(robot, pw, sph_x, force)
    wrench = wrench + _gravity_wrench(robot, Rw, dr.payload, dr.com_shift)
    wd, ad, qdd, _ = robot_fd(robot, Ispat, ag.pos, ag.quat, ag.lin_vel, ag.ang_vel, ag.q,
                              ag.qd, tau, wrench)
    new_agents = ActorState(*integrator.integrate(
        robot, ag.pos, ag.quat, ag.lin_vel, ag.ang_vel, ag.q, ag.qd, wd, ad, qdd, dt))

    # ---- NPC dynamics ----
    if N > 0:
        if npc_tau is None:
            npc_tau = torch.zeros((E, N, npc.nq), dtype=sph_x.dtype, device=dev)
        nIspat = torch.as_tensor(npc.spatial_inertia, dtype=sph_x.dtype, device=dev)
        nwrench = _accumulate_wrench(npc, npw, nsph_x, nsph_f)
        nwrench = nwrench + npc_wrench + _gravity_wrench(npc, nRw)
        nwd, nad, nqdd, _ = dynamics.forward_dynamics(
            npc, nIspat, nc.pos, nc.quat, nc.lin_vel, nc.ang_vel, nc.q, nc.qd, npc_tau, nwrench)
        if not scene.npc_root_free:
            nwd = torch.zeros_like(nwd)
            nad = torch.zeros_like(nad)
        new_npcs = ActorState(*integrator.integrate(
            npc, nc.pos, nc.quat, nc.lin_vel, nc.ang_vel, nc.q, nc.qd, nwd, nad, nqdd, dt))
    else:
        new_npcs = state.npcs
        nsph_f = torch.zeros((E, 0, 0, 3), dtype=sph_x.dtype, device=dev)

    fi = torch.as_tensor(scene.foot_sphere_indices(), device=dev)
    contacts = Contacts(sphere_force=force, npc_sphere_force=nsph_f, feet_force=force[:, :, fi])
    return PhysState(agents=new_agents, npcs=new_npcs), contacts
