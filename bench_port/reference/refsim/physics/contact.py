"""Penalty contact model: spheres vs plane / heightfield / boxes / spheres /
vertical cylinders.

PyTorch counterpart of `mqe_tpu/physics/contact.py`. All robot-side collision
geometry is spheres; the world side is a flat plane or a regular-grid
heightfield plus analytic axis-aligned boxes (walls), and the NPCs' sphere,
box and cylinder primitives in their own frames. Forces are compliant:
Hunt-Crossley normal force and regularised Coulomb friction.

All functions are per contact point and broadcast over leading dims.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ContactParams:
    kn: float = 4000.0     # normal stiffness [N/m]
    hc_damping: float = 3.0  # Hunt-Crossley damping ratio [s/m]: fn = kn*d*(1 - hc*vn)
    mu: float = 1.0        # friction coefficient (terrain static_friction=1.0)
    v_slip: float = 0.02   # regularization slip velocity [m/s]
    f_max: float = 500.0   # per-point normal force clamp [N]


DEFAULT_PARAMS = ContactParams()


def penalty_force(depth, normal, vel, params: ContactParams, mu_scale=1.0):
    """Contact force at a point.

    depth: (...,) penetration (>0 when in contact)
    normal: (..., 3) unit contact normal (pointing away from the surface)
    vel: (..., 3) velocity of the contact point relative to the surface
    mu_scale: float or tensor broadcasting against depth
    Returns (..., 3) world-frame force on the point's body.
    """
    vn = torch.sum(vel * normal, dim=-1)
    active = depth > 0.0
    fn = torch.clamp(params.kn * depth * (1.0 - params.hc_damping * vn), 0.0, params.f_max)
    fn = torch.where(active, fn, 0.0)
    vt = vel - vn[..., None] * normal
    vt_norm = torch.linalg.norm(vt, dim=-1)
    ft_mag = params.mu * mu_scale * fn * torch.clamp_max(vt_norm / params.v_slip, 1.0)
    ft = -ft_mag[..., None] * vt / (vt_norm[..., None] + 1e-8)
    return fn[..., None] * normal + ft


class Heightfield:
    """Static heightfield sampler."""

    @staticmethod
    def sample(height, origin, scale, xy):
        """Bilinear height + gradient at world xy.

        height: (X, Y) meters; origin: (2,) world coords of cell (0,0);
        scale: meters/cell; xy: (..., 2).
        Returns h: (...,), grad: (..., 2).
        """
        u = (xy - origin) / scale
        X, Y = height.shape
        ux = torch.clamp(u[..., 0], 0.0, X - 1.001)
        uy = torch.clamp(u[..., 1], 0.0, Y - 1.001)
        ix = torch.floor(ux).to(torch.int64)
        iy = torch.floor(uy).to(torch.int64)
        fx = ux - ix
        fy = uy - iy
        h00 = height[ix, iy]
        h10 = height[ix + 1, iy]
        h01 = height[ix, iy + 1]
        h11 = height[ix + 1, iy + 1]
        h0 = h00 * (1 - fy) + h01 * fy
        h1 = h10 * (1 - fy) + h11 * fy
        h = h0 * (1 - fx) + h1 * fx
        dhdx = (h1 - h0) / scale
        dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / scale
        return h, torch.stack([dhdx, dhdy], dim=-1)


def sphere_heightfield(pos, vel, radius, height, origin, scale, params, mu_scale=1.0):
    """Force on a sphere from the heightfield ground. pos/vel: (..., 3)."""
    h, grad = Heightfield.sample(height, origin, scale, pos[..., :2])
    n = torch.cat([-grad, torch.ones_like(grad[..., :1])], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    depth = (h - (pos[..., 2] - radius)) * n[..., 2]
    return penalty_force(depth, n, vel, params, mu_scale)


def sphere_plane(pos, vel, radius, plane_h, params, mu_scale=1.0):
    """Force on a sphere from the horizontal plane z = plane_h."""
    n = torch.zeros_like(pos)
    n[..., 2] = 1.0
    depth = plane_h - (pos[..., 2] - radius)
    return penalty_force(depth, n, vel, params, mu_scale)


def sphere_box(pos, vel, radius, center, half, params, mu_scale=1.0, box_vel=None):
    """Force on a sphere from an axis-aligned box. Broadcasts over leading dims."""
    rel = pos - center
    clamped = torch.maximum(torch.minimum(rel, half), -half)
    # outside: vector from closest surface point to sphere center
    delta = rel - clamped
    dist = torch.linalg.norm(delta, dim=-1)
    outside = dist > 1e-9
    n_out = delta / (dist[..., None] + 1e-9)
    depth_out = radius - dist

    # inside: push out along the face with least penetration
    gap = half - torch.abs(rel)  # (..., 3), >=0 when inside
    min_gap = torch.amin(gap, dim=-1, keepdim=True)
    is_min = (gap <= min_gap).to(pos.dtype)
    is_min = is_min / torch.sum(is_min, dim=-1, keepdim=True)
    sign = torch.where(rel >= 0, 1.0, -1.0)
    n_in = is_min * sign
    depth_in = min_gap[..., 0] + radius

    n = torch.where(outside[..., None], n_out, n_in)
    depth = torch.where(outside, depth_out, depth_in)
    rel_vel = vel if box_vel is None else vel - box_vel
    return penalty_force(depth, n, rel_vel, params, mu_scale)


def sphere_sphere(pos_a, vel_a, r_a, pos_b, vel_b, r_b, params, mu_scale=1.0):
    """Force on sphere A from sphere B (equal-opposite applies to B)."""
    delta = pos_a - pos_b
    dist = torch.linalg.norm(delta, dim=-1)
    n = delta / (dist[..., None] + 1e-9)
    depth = (r_a + r_b) - dist
    return penalty_force(depth, n, vel_a - vel_b, params, mu_scale)


def sphere_vertical_cylinder(pos, vel, radius, center, cyl_radius, half_length, params,
                             mu_scale=1.0, cyl_vel=None):
    """Force on a sphere from a vertical (z-axis) cylinder (e.g. the seesaw's
    pivot, the tug disc). center: cylinder center."""
    rel = pos - center
    rho = torch.linalg.norm(rel[..., :2], dim=-1)
    dr = rho - cyl_radius                      # >0: radially outside
    dz = torch.abs(rel[..., 2]) - half_length  # >0: above/below

    radial_dir = rel[..., :2] / (rho[..., None] + 1e-9)
    z_dir = torch.sign(rel[..., 2])
    z_dir = torch.where(z_dir == 0, 1.0, z_dir)

    # closest-feature logic
    outside_r = dr > 0
    outside_z = dz > 0
    # side contact normal (radial), cap contact normal (z), edge blend
    n_side = torch.cat([radial_dir, torch.zeros_like(rho[..., None])], dim=-1)
    n_cap = torch.cat([torch.zeros_like(rel[..., :2]), z_dir[..., None]], dim=-1)
    dist_out = torch.sqrt(torch.clamp_min(dr, 0) ** 2 + torch.clamp_min(dz, 0) ** 2)
    n_edge_2d = torch.stack([torch.clamp_min(dr, 0), torch.clamp_min(dz, 0)], dim=-1)
    n_edge_2d = n_edge_2d / (torch.linalg.norm(n_edge_2d, dim=-1, keepdim=True) + 1e-9)
    n_edge = n_side * n_edge_2d[..., 0:1] + n_cap * n_edge_2d[..., 1:2]

    both_out = outside_r & outside_z
    n = torch.where(both_out[..., None], n_edge,
                    torch.where(outside_r[..., None], n_side, n_cap))
    # penetration depth
    depth_partial = radius - torch.where(both_out, dist_out, torch.where(outside_r, dr, dz))
    inside = (~outside_r) & (~outside_z)
    # fully inside: exit along the axis with the smaller penetration
    n_inside = torch.where((torch.abs(dr) < torch.abs(dz))[..., None], n_side, n_cap)
    n = torch.where(inside[..., None], n_inside, n)
    depth = torch.where(inside, radius + torch.minimum(torch.abs(dr), torch.abs(dz)),
                        depth_partial)
    rel_vel = vel if cyl_vel is None else vel - cyl_vel
    return penalty_force(depth, n, rel_vel, params, mu_scale)
