"""Onboard forward camera: batched analytic raycaster (depth + RGB), PyTorch.

Counterpart of `mqe_tpu/render/onboard.py`, the replacement for the
reference's Isaac Gym onboard camera sensors (ref
mqe/envs/field/legged_robot_field.py:23-93, sensor cfg
legged_robot_field_config.py:72-77: 16x16 forward camera at (0.26, 0, 0.03)
on the trunk). Every pixel is one analytic ray test against the primitives
the physics uses: the ground plane or heightfield, the wall boxes, and sphere
impostors for the other actors.

The JAX package writes each function for one camera and vmaps it over
agents and envs; here every function takes any leading batch of cameras
(`...`, e.g. (E, A)) and computes the same numbers for each. It is plain
PyTorch: the JAX package has no Pallas kernel here (XLA fuses its
elementwise program), so the port has none either.

RGB is flat-shaded Lambertian over per-primitive albedos, with sky where a
ray hits nothing before `far` (the JAX package's documented deviation from
the reference's rasterizer, PARITY.md).

One difference: with no boxes (a Legacy or Perlin terrain has no wall boxes
and a task without a fixture adds none), the JAX package's min over an empty
box axis raises; here the boxes then hit nothing, as the spheres do when
there are none.
"""
from __future__ import annotations

import numpy as np
import torch

# per-primitive albedos for the RGB channel
ALBEDO_GROUND = np.array([0.45, 0.42, 0.38], dtype=np.float32)
ALBEDO_BOX = np.array([0.65, 0.25, 0.2], dtype=np.float32)
ALBEDO_ACTOR = np.array([0.25, 0.55, 0.3], dtype=np.float32)
ALBEDO_SKY = np.array([0.7, 0.8, 0.95], dtype=np.float32)
LIGHT_DIR = np.array([0.3, 0.2, 0.93], dtype=np.float32)  # world, normalized-ish


def camera_rays(resolution, hfov_deg: float) -> np.ndarray:
    """Pixel ray directions in the camera frame (x fwd, y left, z up).

    Returns (H, W, 3) unit vectors. Pinhole model; vertical fov scales with
    aspect like the reference notes (legged_robot_field.py:44).
    """
    H, W = resolution
    half_w = np.tan(np.radians(hfov_deg) / 2.0)
    half_h = half_w * H / W
    # pixel centers; v runs top->bottom (image convention), y left-positive
    u = (np.arange(W) + 0.5) / W * 2.0 - 1.0   # [-1, 1)
    v = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    yy = -u[None, :] * half_w * np.ones((H, 1))
    zz = -v[:, None] * half_h * np.ones((1, W))
    xx = np.ones((H, W))
    d = np.stack([xx, yy, zz], axis=-1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _ray_plane(o, d, height, far):
    """t of ray-vs-horizontal-plane z=height. o, d: (..., 3) -> (...)."""
    dz = d[..., 2]
    t = (height - o[..., 2]) / torch.where(torch.abs(dz) < 1e-6, -1e-6, dz)
    return torch.where((t > 0) & (dz < 0), t, far)


def _ray_heightfield(o, d, hf, origin, scale, far, n_steps: int = 48):
    """Fixed-step ray march against a bilinear heightfield. o, d: (..., 3).

    Returns (...) first-crossing t (linear-refined) or far.
    """
    ts = torch.linspace(0.0, far, n_steps, dtype=d.dtype, device=d.device)   # (K,)
    p = o[..., None, :] + d[..., None, :] * ts[:, None]                      # (..., K, 3)
    gx = (p[..., 0] - origin[0]) / scale
    gy = (p[..., 1] - origin[1]) / scale
    X, Y = hf.shape
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, X - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, Y - 2)
    fx = torch.clamp(gx - x0, 0.0, 1.0)
    fy = torch.clamp(gy - y0, 0.0, 1.0)
    flat = hf.reshape(-1)
    i00 = x0 * Y + y0
    h00 = flat[i00]
    h10 = flat[i00 + Y]
    h01 = flat[i00 + 1]
    h11 = flat[i00 + Y + 1]
    h = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
         + h01 * (1 - fx) * fy + h11 * fx * fy)                             # (..., K)
    gap = p[..., 2] - h
    below = gap < 0
    # first k with below[k] (0 if none); linear refine between k-1 and k
    first = torch.argmax(below.to(torch.uint8), dim=-1)
    hit = below.any(dim=-1)
    k1 = torch.clamp(first, min=1)
    t0 = ts[k1 - 1]
    t1 = ts[k1]
    gap0 = torch.gather(gap, -1, (k1 - 1)[..., None])[..., 0]
    gap1 = torch.gather(gap, -1, k1[..., None])[..., 0]
    frac = gap0 / torch.clamp(gap0 - gap1, min=1e-6)
    t = t0 + frac * (t1 - t0)
    return torch.where(hit, t, far)


def _ray_boxes(o, d, boxes, far):
    """Slab test vs axis-aligned boxes. o, d: (..., R, 3); boxes: (..., B, 7).

    Returns (..., R) min-hit t and (..., R, 3) hit normal (axis of entry face).
    """
    c = boxes[..., None, :, 0:3]                                # (..., 1, B, 3)
    h = boxes[..., None, :, 3:6]
    valid = boxes[..., None, :, 6] > 0                          # (..., 1, B)
    lo = c - h
    hi = c + h
    inv = 1.0 / torch.where(torch.abs(d) < 1e-8, 1e-8, d)      # (..., R, 3)
    t1 = (lo - o[..., None, :]) * inv[..., None, :]             # (..., R, B, 3)
    t2 = (hi - o[..., None, :]) * inv[..., None, :]
    tmin_ax = torch.minimum(t1, t2)
    tmax_ax = torch.maximum(t1, t2)
    tmin = tmin_ax.amax(dim=-1)                                 # (..., R, B)
    tmax = tmax_ax.amin(dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin > 0) & valid
    t = torch.where(hit, tmin, far)
    tb, bi = t.min(dim=-1)                                      # (..., R)
    # entry-face normal: axis whose tmin_ax equals tmin, signed against d
    ax = torch.gather(tmin_ax, -2, bi[..., None, None].expand(bi.shape + (1, 3)))[..., 0, :]
    tsel = torch.gather(tmin, -1, bi[..., None])                # (..., R, 1)
    is_entry = torch.abs(ax - tsel) < 1e-5
    normal = torch.where(is_entry, -torch.sign(d), 0.0)
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    return tb, normal / torch.clamp(nn, min=1e-6)


def _ray_spheres(o, d, spheres, far):
    """Quadratic vs spheres. o, d: (..., R, 3); spheres: (..., M, 5)
    center/radius/valid.

    Returns (..., R) min-hit t and (..., R, 3) hit normal.
    """
    c = spheres[..., None, :, 0:3]                              # (..., 1, M, 3)
    r = spheres[..., None, :, 3]
    valid = spheres[..., None, :, 4] > 0
    oc = o[..., None, :] - c                                    # (..., R, M, 3)
    b = (oc * d[..., None, :]).sum(-1)                          # (..., R, M)
    disc = b * b - ((oc * oc).sum(-1) - r * r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    hit = (disc > 0) & (t > 0) & valid
    t = torch.where(hit, t, far)
    ts, mi = t.min(dim=-1)                                      # (..., R)
    hit_p = o + d * ts[..., None]
    cm = torch.gather(c.expand(mi.shape + c.shape[-2:]), -2,
                      mi[..., None, None].expand(mi.shape + (1, 3)))[..., 0, :]
    normal = hit_p - cm
    return ts, normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-6)


def render(o, d, boxes, spheres, far, flat_height=None, hf=None,
           hf_origin=None, hf_scale=None, rgb: bool = False):
    """Render depth (and optionally RGB) for R rays of each camera of a batch.

    o: (..., 3) camera origins; d: (..., R, 3) world ray dirs; boxes
    (..., B, 7); spheres (..., M, 5), each broadcast over the batch `...`.
    Returns depth (..., R) in [0, far] and rgb (..., R, 3) or None.
    """
    o_b = o[..., None, :].expand(d.shape)
    if flat_height is not None:
        t_g = _ray_plane(o_b, d, flat_height, far)
    else:
        t_g = _ray_heightfield(o_b, d, hf, hf_origin, hf_scale, far)
    if boxes.shape[-2] > 0:
        t_b, n_b = _ray_boxes(o_b, d, boxes, far)
    else:
        t_b, n_b = torch.full_like(t_g, far), torch.zeros_like(d)
    if spheres.shape[-2] > 0:
        t_s, n_s = _ray_spheres(o_b, d, spheres, far)
    else:
        t_s, n_s = torch.full_like(t_g, far), torch.zeros_like(d)
    depth = torch.minimum(torch.minimum(t_g, t_b), t_s)
    if not rgb:
        return depth, None
    t = lambda a: torch.as_tensor(a, dtype=d.dtype, device=d.device)  # noqa: E731
    up = t([0.0, 0.0, 1.0])
    which = torch.stack([t_g, t_b, t_s], dim=-1).argmin(dim=-1)[..., None]   # (..., R, 1)
    normal = torch.where(which == 0, up, torch.where(which == 1, n_b, n_s))
    albedo = torch.where(which == 0, t(ALBEDO_GROUND),
                         torch.where(which == 1, t(ALBEDO_BOX), t(ALBEDO_ACTOR)))
    light = t(LIGHT_DIR / np.linalg.norm(LIGHT_DIR))
    shade = 0.35 + 0.65 * torch.clamp((normal * light).sum(-1), min=0.0)
    color = albedo * shade[..., None]
    sky = depth >= far - 1e-6
    return depth, torch.where(sky[..., None], t(ALBEDO_SKY), color)
