"""Composed physics of the robots of a batch of envs, one substep at a time.

PyTorch counterpart of `mqe_tpu/physics/scene.py::substep_batch` for scenes
without NPCs (the go1gate slice): forward kinematics of the collision spheres
(plain, physics/soa.py) -> contact forces against the ground, the env's wall
boxes and the other robots' coarse spheres (physics/contact.py, batched over
the env axis where the JAX package vmaps) -> the dynamics substep
(physics/fused_step.py: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors).

Actor layout: agents first, then NPCs; per-agent tensors carry (E, A, ...).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mqe_tpu_torch.physics import contact as C
from mqe_tpu_torch.physics import soa
from mqe_tpu_torch.physics.fused_step import step_actor_kernel
from mqe_tpu_torch.physics.model import BodyModel


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


@dataclass
class DomainRand:
    mu_scale: torch.Tensor        # (E,) friction multiplier
    payload: torch.Tensor         # (E, A) extra trunk mass
    com_shift: torch.Tensor       # (E, A, 3) trunk com displacement
    motor_strength: torch.Tensor  # (E, A, nq) torque multiplier (env layer)


@dataclass
class Contacts:
    sphere_force: torch.Tensor    # (E, A, ns, 3) world force on each agent sphere
    feet_force: torch.Tensor      # (E, A, 4, 3) foot spheres


@dataclass(frozen=True)
class SceneModel:
    """Static scene description."""

    robot: BodyModel
    num_agents: int
    contact: C.ContactParams = C.DEFAULT_PARAMS
    self_collision: bool = True
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
    """Force on spheres from the ground and each env's wall boxes.

    pos/vel: (E, S, 3); radius: (S,); mu_scale: (E,). Returns (E, S, 3).
    """
    mu = mu_scale[:, None]
    if flat_height is not None:
        f = C.sphere_plane(pos, vel, radius, flat_height, params, mu)
    else:
        f = C.sphere_heightfield(
            pos, vel, radius, terrain.height, terrain.origin, terrain.scale, params, mu
        )
    boxes = terrain.boxes                                   # (E, nbox, 7)
    if boxes.shape[1]:
        fb = C.sphere_box(
            pos[:, :, None, :], vel[:, :, None, :], radius[None, :, None],
            boxes[:, None, :, 0:3], boxes[:, None, :, 3:6], params, mu[..., None],
        )                                                   # (E, S, nbox, 3)
        f = f + (fb * boxes[:, None, :, 6, None]).sum(dim=2)
    return f


def substep_batch(scene: SceneModel, terrain: Terrain, state: PhysState, tau,
                  dr: DomainRand, dt: float):
    """One physics substep for the whole env batch.

    state: actor tensors with a leading env axis (E, A, ...); tau (E, A, nq).
    Returns (new PhysState, Contacts).
    """
    robot = scene.robot
    A = scene.num_agents
    params = scene.contact
    ag = state.agents
    E = ag.pos.shape[0]
    ns = len(robot.sph_tags)
    dev = ag.pos.device

    def flat(x):
        return x.reshape((E * A,) + x.shape[2:])

    # ---- agent kinematics + spheres (SoA over E*A robots) ----
    sph_x_f, sph_v_f = soa.fk_spheres(
        robot, flat(ag.pos), flat(ag.quat), flat(ag.lin_vel), flat(ag.ang_vel),
        flat(ag.q), flat(ag.qd),
    )
    sph_r = torch.as_tensor(robot.sph_radius, dtype=sph_x_f.dtype, device=dev)

    # ---- contact forces, batched over the env axis ----
    sx = sph_x_f.reshape(E, A * ns, 3)
    sv = sph_v_f.reshape(E, A * ns, 3)
    force = _terrain_and_box_force(
        sx, sv, sph_r.repeat(A), terrain, params, dr.mu_scale, scene.flat_height
    )
    if A > 1 and scene.self_collision:
        ci = torch.as_tensor(scene.coarse_sphere_indices(), device=dev)
        nc = ci.shape[0]
        cx = sph_x_f.reshape(E, A, ns, 3)[:, :, ci].reshape(E, A * nc, 3)
        cv = sph_v_f.reshape(E, A, ns, 3)[:, :, ci].reshape(E, A * nc, 3)
        cr = sph_r[ci].repeat(A)
        ff = C.sphere_sphere(
            cx[:, :, None, :], cv[:, :, None, :], cr[:, None],
            cx[:, None, :, :], cv[:, None, :, :], cr[None, :], params,
            dr.mu_scale[:, None, None],
        )                                                   # (E, A*nc, A*nc, 3)
        inst = torch.arange(A, device=dev).repeat_interleave(nc)
        mask = (inst[:, None] != inst[None, :]).to(ff.dtype)
        fcoarse = (ff * mask[..., None]).sum(dim=2).reshape(E, A, nc, 3)
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
    fi = torch.as_tensor(scene.foot_sphere_indices(), device=dev)
    contacts = Contacts(sphere_force=force, feet_force=force[:, :, fi])
    return PhysState(agents=new_agents, npcs=state.npcs), contacts
