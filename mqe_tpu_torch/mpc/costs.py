"""Task cost functions for command-space trajectory optimization, PyTorch.

Counterpart of `mqe_tpu/mpc/costs.py`. Costs operate on the joint
multi-agent planner state (A*6,) and joint control (A*3,) of one problem;
mpc/ilqr.py vmaps and differentiates them with `torch.func`. `args` carries
per-env data (targets, gate position from the terrain env_info oracle — the
same oracle the task wrappers feed to RL, ref barrier_track.py:356-358 ->
wrapper obs).

The hinges are `torch.maximum` / `torch.minimum` against a tensor: at a tie
they split the derivative 0.5 / 0.5 between their arguments, as JAX's do
(`clamp` would pass it whole), so the planner's gradients and Hessians agree
at the kinks too.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CostWeights:
    w_pos: float = 2.0        # squared distance to target waypoint
    w_vel: float = 0.05       # velocity magnitude (settle at the target)
    w_u: float = 0.02         # control effort
    w_du: float = 0.0         # (reserved) control rate
    w_sep: float = 4.0        # inter-agent separation hinge
    d_min: float = 0.7        # minimum inter-agent distance (m)
    w_heading: float = 0.1    # face the target while far from it
    terminal_scale: float = 10.0


def _split(x, A):
    xa = x.reshape(A, 6)
    return xa[:, 0:2], xa[:, 2], xa[:, 3:5], xa[:, 5]


# per-channel control effort: lateral and yaw commands cost more than forward
# (the gait tracks vx best; saturated vy/yaw commands destabilize the trot)
_U_CHAN = (1.0, 3.0, 2.0)


def _u_cost(u, A, w: CostWeights):
    ua = u.reshape(A, 3)
    chan = torch.tensor(_U_CHAN, dtype=u.dtype, device=u.device)
    return w.w_u * (chan[None, :] * ua**2).sum()


def _separation_penalty(pos, A, w: CostWeights):
    if A < 2:
        return 0.0
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    off = ~torch.eye(A, dtype=torch.bool, device=pos.device)
    # smooth hinge: penalize closer than d_min
    gap = torch.maximum(w.d_min**2 - d2, torch.zeros_like(d2))
    return 0.5 * w.w_sep * (gap * off).sum()


def _stance_targets(A, box, d):
    """Each agent's shoving pose: box - 0.6 * push_dir, offset laterally."""
    lat = torch.stack([-d[1], d[0]])
    offs = (torch.arange(A, dtype=box.dtype, device=box.device) - (A - 1) / 2.0)[:, None] \
        * 0.5 * lat[None]
    return box[None] - 0.6 * d[None] + offs


def waypoint_cost(A: int, w: CostWeights = CostWeights()):
    """Per-agent waypoint tracking. args = {"targets": (A, 2)} env-local xy."""

    def stage(x, u, t, args):
        pos, yaw, vel, wz = _split(x, A)
        tgt = args["targets"]
        e = pos - tgt
        c = w.w_pos * (e**2).sum()
        c = c + w.w_vel * ((vel**2).sum() + (wz**2).sum())
        c = c + _u_cost(u, A, w)
        # heading alignment: cos distance between yaw and direction-to-target
        to_t = tgt - pos
        dist = torch.sqrt((to_t**2).sum(-1) + 1e-6)
        hd = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
        align = (hd * to_t).sum(-1) / dist
        c = c + w.w_heading * ((1.0 - align) * torch.minimum(dist, torch.full_like(dist, 2.0))).sum()
        c = c + _separation_penalty(pos, A, w)
        return c

    def final(x, args):
        pos, yaw, vel, wz = _split(x, A)
        e = pos - args["targets"]
        return w.terminal_scale * (
            w.w_pos * (e**2).sum() + w.w_vel * ((vel**2).sum() + (wz**2).sum())
        )

    return stage, final


def gate_cost(A: int, w: CostWeights = CostWeights()):
    """go1gate: both agents pass through the gate opening then keep going.

    args = {"gate": (2,) gate center xy in env-local coords, "goal_x": ()}.

    Smooth corridor formulation: quadratic progress toward goal_x in x, plus
    a Gaussian-weighted lateral alignment to the gate's y (the oracle
    gate_deviation) that activates near the gate plane; monotone in
    progress, so iLQR drives straight through. Separation hinge is softened
    (agents must queue through a ~1 m opening).
    """
    w = CostWeights(
        w_pos=w.w_pos, w_vel=w.w_vel, w_u=w.w_u, w_du=w.w_du,
        w_sep=min(w.w_sep, 2.0), d_min=min(w.d_min, 0.45),
        w_heading=w.w_heading, terminal_scale=w.terminal_scale,
    )
    W_GATE_Y = 3.0     # lateral alignment strength at the gate plane
    GATE_SIGMA = 0.7   # (m) how far from the plane alignment starts to bind
    W_PROG = 0.25      # progress-to-goal weight (x only)

    def _lateral(pos, args):
        gate = args["gate"]
        near = torch.exp(-((pos[:, 0] - gate[0]) / GATE_SIGMA) ** 2)
        return ((W_GATE_Y * near + 0.02) * (pos[:, 1] - gate[1]) ** 2).sum()

    def stage(x, u, t, args):
        pos, yaw, vel, wz = _split(x, A)
        goal_x = args["goal_x"]
        c = W_PROG * ((pos[:, 0] - goal_x) ** 2).sum()
        c = c + _lateral(pos, args)
        c = c + _u_cost(u, A, w)
        c = c + 0.02 * (wz**2).sum()
        c = c + _separation_penalty(pos, A, w)
        return c

    def final(x, args):
        pos, yaw, vel, wz = _split(x, A)
        goal_x = args["goal_x"]
        return w.terminal_scale * (
            W_PROG * ((pos[:, 0] - goal_x) ** 2).sum() + _lateral(pos, args)
        )

    return stage, final


def pushbox_cost(A: int, w: CostWeights = CostWeights()):
    """go1pushbox: drive agents to a shoving pose behind the box.

    args = {"box": (2,) box xy, "push_dir": (2,) unit direction to push}.
    Stance point = box - 0.6 * push_dir, with small per-agent lateral offsets
    so two agents don't fight for the same spot.
    """

    def stage(x, u, t, args):
        pos, yaw, vel, wz = _split(x, A)
        tgt = _stance_targets(A, args["box"], args["push_dir"])
        e = pos - tgt
        c = w.w_pos * (e**2).sum() + _u_cost(u, A, w)
        c = c + _separation_penalty(pos, A, w)
        return c

    def final(x, args):
        pos, yaw, vel, wz = _split(x, A)
        tgt = _stance_targets(A, args["box"], args["push_dir"])
        return w.terminal_scale * w.w_pos * ((pos - tgt) ** 2).sum()

    return stage, final
