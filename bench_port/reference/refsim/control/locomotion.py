"""Low-level locomotion: gait clocks, analytic leg IK, trot controller.

PyTorch counterpart of `mqe_tpu/control/locomotion.py`. The reference turns
(vx, vy, yaw-rate) commands into 12 joint actions through a frozen policy
(ref mqe/envs/go1/go1.py:64-108, 389-409); here the model-based
TrotController (Raibert-style gait + analytic 3-DoF leg IK) produces the
"locomotion action" (position-target offsets through the actuator-net torque
path, ref go1.py:315-354), optionally plus a learned residual
(control/nets.py::BodyPolicy).

Leg order everywhere: FR, FL, RR, RL (go1 DOF order). Gait clocks follow the
reference layout (FL, FR, RL, RR) and are remapped.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# go1 geometry (from resources/robots/go1/urdf/go1.urdf joint origins)
HIP_X = 0.1881
HIP_Y = 0.04675
L_HIP = 0.08     # hip -> thigh lateral offset
L_THIGH = 0.213
L_CALF = 0.213
# per-leg signs, FR FL RR RL: x of hip, y of hip
LEG_SIGN_X = np.array([1.0, 1.0, -1.0, -1.0])
LEG_SIGN_Y = np.array([-1.0, 1.0, -1.0, 1.0])
HIP_OFFSETS = np.stack(
    [LEG_SIGN_X * HIP_X, LEG_SIGN_Y * HIP_Y, np.zeros(4)], axis=-1
)  # (4, 3) in trunk frame

# clock index remap: reference clock order (FL, FR, RL, RR) -> leg order
CLOCK_TO_LEG = np.array([1, 0, 3, 2])


def step_gait_clocks(gait_indices, dt, frequencies, phases, offsets, bounds, durations):
    """Advance gait phase and compute per-foot indices + clock inputs.

    Mirrors the reference's `_step_contact_targets` (ref go1.py:240-279):
    raw foot phases [FL, FR, RL, RR] are remapped so [0, 0.5) is stance and
    [0.5, 1) is swing, each sub-interval normalized by `durations`.

    All args (...,). Returns (gait_indices, foot_indices(...,4),
    clock_inputs(...,4), doubletime(...,4), halftime(...,4)) in clock order.
    """
    gait_indices = torch.remainder(gait_indices + dt * frequencies, 1.0)
    raw = torch.stack(
        [
            gait_indices + phases + offsets + bounds,
            gait_indices + offsets,
            gait_indices + bounds,
            gait_indices + phases,
        ],
        dim=-1,
    )
    rem = torch.remainder(raw, 1.0)
    dur = durations[..., None]
    stance = rem < dur
    idx = torch.where(
        stance,
        rem * (0.5 / torch.clamp_min(dur, 1e-6)),
        0.5 + (rem - dur) * (0.5 / torch.clamp_min(1.0 - dur, 1e-6)),
    )
    clock = torch.sin(2 * math.pi * idx)
    double = torch.sin(4 * math.pi * idx)
    half = torch.sin(math.pi * idx)
    return gait_indices, idx, clock, double, half


def leg_ik(p_hip, leg_sign_y):
    """Analytic IK of one go1 leg: foot target in HIP frame -> (q1, q2, q3).

    Hip frame: x forward, y left, z up, origin at the hip joint.
    Kinematics: p = Rx(q1) ([0, s*L_HIP, 0] + Ry(q2) [0,0,-L_THIGH]
                            + Ry(q2) Ry(q3) [0,0,-L_CALF]).
    """
    px, py, pz = p_hip[..., 0], p_hip[..., 1], p_hip[..., 2]
    s = leg_sign_y
    rho = torch.sqrt(torch.clamp_min(py * py + pz * pz, (L_HIP + 1e-4) ** 2))
    # abduction: Rx(-q1) must map (py, pz) to (s*L_HIP, -L)
    psi = torch.atan2(pz, py)
    q1 = psi + torch.acos(torch.clamp(s * L_HIP / rho, -1.0, 1.0))
    L = torch.sqrt(torch.clamp_min(rho * rho - L_HIP * L_HIP, 1e-8))
    # planar 2-link in the leg plane: target (px, -L)
    r = torch.sqrt(px * px + L * L)
    r = torch.clamp(r, abs(L_THIGH - L_CALF) + 1e-4, L_THIGH + L_CALF - 1e-4)
    cos_knee = (r * r - L_THIGH**2 - L_CALF**2) / (2 * L_THIGH * L_CALF)
    knee_inner = torch.acos(torch.clamp(cos_knee, -1.0, 1.0))
    q3 = -knee_inner  # calf always bends backward (q3 = -(pi - interior))
    phi = torch.atan2(-px, L)   # thigh-plane target angle from straight-down
    beta = torch.asin(torch.clamp(L_CALF * torch.sin(knee_inner) / r, -1.0, 1.0))
    q2 = phi + beta
    return q1, q2, q3


def leg_fk(q, leg_sign_y):
    """FK of one leg (hip frame), q: (..., 3). Inverse of leg_ik for tests."""
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]

    def rx(a, v):
        c, s_ = torch.cos(a), torch.sin(a)
        return torch.stack(
            [v[..., 0], c * v[..., 1] - s_ * v[..., 2], s_ * v[..., 1] + c * v[..., 2]], dim=-1
        )

    def ry(a, v):
        c, s_ = torch.cos(a), torch.sin(a)
        return torch.stack(
            [c * v[..., 0] + s_ * v[..., 2], v[..., 1], -s_ * v[..., 0] + c * v[..., 2]], dim=-1
        )

    zero = torch.zeros_like(q1)
    one = torch.ones_like(q1)
    thigh = torch.stack([zero, leg_sign_y * L_HIP * one, zero], dim=-1)
    knee = ry(q2, torch.stack([zero, zero, -L_THIGH * one], dim=-1))
    foot = ry(q2 + q3, torch.stack([zero, zero, -L_CALF * one], dim=-1))
    return rx(q1, thigh + knee + foot)


class TrotController:
    """Raibert-heuristic gait: foot targets from commands + clocks -> IK ->
    joint position targets, expressed as locomotion actions compatible with
    the shared actuator-net torque path."""

    def __init__(self, body_height: float = 0.30, action_scale: float = 0.25,
                 hip_scale_reduction: float = 0.5, default_q=None):
        self.body_height = body_height
        self.action_scale = action_scale
        self.hip_scale_reduction = hip_scale_reduction
        self.default_q = np.asarray(default_q) if default_q is not None else None

    K_RAIBERT = 0.03      # landing-point feedback gain [s]
    K_SWEEP = 1.5         # stance-sweep velocity-error boost (proportional)
    K_INT = 1.5           # stance-sweep integral gain [1/s] on the velocity-error integrator
    INT_CLAMP = 0.25      # anti-windup clamp on the integrator [m] / [rad]
    PHASE_LEAD = 0.0      # foot-target phase lead [gait cycles]
    K_HEIGHT = 0.0        # stance-height feedback gain on the measured body sag
    SWING_XY_DELAY = 0.0  # fraction of swing before the foot travels horizontally
    TRIM_X = 0.0          # fore-aft neutral-stance trim [m]
    # supplementary joint PD of the trot backend on top of the actuator net
    TAU_KP = 20.0
    TAU_KD = 0.8

    def __call__(self, commands, foot_idx_legs, gait_params, roll=None, pitch=None,
                 v_meas=None, w_meas=None, v_int=None, z_meas=None):
        """commands: (..., 3) = (vx, vy, yaw_rate); foot_idx_legs: (..., 4)
        remapped gait index per LEG (FR,FL,RR,RL), [0,0.5) stance, [0.5,1)
        swing; gait_params: dict of (...,) tensors (freq, duration,
        swing_height, stance_width, stance_length, body_height_delta);
        v_meas (..., 2) / w_meas (...,): measured body-yaw-frame velocity and
        yaw rate (default: the commands); v_int (..., 3): velocity-error
        integral; z_meas (...,): base height above ground (None disables the
        anti-sag feedback). Returns the locomotion action (..., 12)."""
        dev, dt_ = commands.device, commands.dtype
        vx = commands[..., 0]
        vy = commands[..., 1]
        wz = commands[..., 2]
        if v_meas is None:
            vmx, vmy = vx, vy
        else:
            vmx, vmy = v_meas[..., 0], v_meas[..., 1]
        wm = wz if w_meas is None else w_meas
        freq = gait_params["freq"]
        duration = gait_params["duration"]
        h_swing = gait_params["swing_height"]
        stance_w = gait_params["stance_width"]
        h_body = self.body_height + gait_params["body_height_delta"]

        T = 1.0 / torch.clamp_min(freq, 1e-3)
        T_stance = duration * T

        hip = torch.as_tensor(HIP_OFFSETS, dtype=dt_, device=dev)  # (4,3)
        sy = torch.as_tensor(LEG_SIGN_Y, dtype=dt_, device=dev)
        sx = torch.as_tensor(LEG_SIGN_X, dtype=dt_, device=dev)
        stance_l = gait_params["stance_length"]
        neutral_x = sx * stance_l[..., None] / 2.0 + self.TRIM_X
        neutral_y = hip[:, 1] + sy * (stance_w[..., None] / 2.0 - HIP_Y)

        kv = self.K_SWEEP
        vsx = vx + kv * torch.clamp(vx - vmx, -0.5, 0.5)
        vsy = vy + kv * torch.clamp(vy - vmy, -0.5, 0.5)
        wsz = wz + kv * torch.clamp(wz - wm, -0.8, 0.8)
        if v_int is not None:
            vsx = vsx + self.K_INT * v_int[..., 0]
            vsy = vsy + self.K_INT * v_int[..., 1]
            wsz = wsz + self.K_INT * v_int[..., 2]
        vfx = vsx[..., None] - wsz[..., None] * neutral_y
        vfy = vsy[..., None] + wsz[..., None] * neutral_x

        idx = torch.remainder(foot_idx_legs + self.PHASE_LEAD, 1.0)
        in_stance = idx < 0.5
        ph_st = torch.clamp(idx / 0.5, 0.0, 1.0)
        ph_sw = torch.clamp((idx - 0.5) / 0.5, 0.0, 1.0)

        fb_x = torch.clamp(self.K_RAIBERT * (vmx - vx), -0.06, 0.06)[..., None]
        fb_y = torch.clamp(self.K_RAIBERT * (vmy - vy), -0.06, 0.06)[..., None]
        land_x = 0.5 * T_stance[..., None] * vfx + fb_x
        land_y = 0.5 * T_stance[..., None] * vfy + fb_y
        lift_x = -0.5 * T_stance[..., None] * vfx
        lift_y = -0.5 * T_stance[..., None] * vfy

        dx_st = land_x - ph_st * T_stance[..., None] * vfx
        dy_st = land_y - ph_st * T_stance[..., None] * vfy
        d0 = self.SWING_XY_DELAY
        ph_xy = torch.clamp((ph_sw - d0) / (0.7 - d0), 0.0, 1.0)
        sw_prof = 0.5 * (1.0 - torch.cos(math.pi * ph_xy))  # 0 -> 1 smooth
        dx_sw = lift_x + sw_prof * (land_x - lift_x)
        dy_sw = lift_y + sw_prof * (land_y - lift_y)

        dx = torch.where(in_stance, dx_st, dx_sw)
        dy = torch.where(in_stance, dy_st, dy_sw)
        z_lift = torch.where(in_stance, 0.0, h_swing[..., None] * torch.sin(math.pi * ph_sw))

        foot_x = neutral_x + dx
        foot_y = neutral_y + dy
        foot_z = -h_body[..., None] + z_lift
        if z_meas is not None:
            sag = torch.clamp(h_body - z_meas, -0.05, 0.08)
            foot_z = foot_z - self.K_HEIGHT * sag[..., None]

        # attitude leveling: extend legs on the dropped side
        if roll is not None:
            foot_z = foot_z + (-pitch[..., None] * foot_x + roll[..., None] * foot_y)

        p_hip = torch.stack(
            [foot_x - hip[:, 0], foot_y - hip[:, 1], foot_z - hip[:, 2]], dim=-1
        )  # (..., 4, 3)
        q1, q2, q3 = leg_ik(p_hip, sy)
        q_target = torch.stack([q1, q2, q3], dim=-1).reshape(commands.shape[:-1] + (12,))

        dq = q_target - torch.as_tensor(self.default_q, dtype=dt_, device=dev)
        action = dq / self.action_scale
        hip_cols = torch.as_tensor(
            [1.0 / self.hip_scale_reduction, 1.0, 1.0] * 4, dtype=dt_, device=dev)
        return action * hip_cols
