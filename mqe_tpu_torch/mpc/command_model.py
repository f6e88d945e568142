"""Reduced command-space dynamics of the hierarchical Go1 stack, PyTorch.

Counterpart of `mqe_tpu/mpc/command_model.py`. The hierarchical design (ref
mqe/envs/go1/go1.py:35-108) means the planner never touches joints: the walk
policy closes the loop on base velocity, so from the command interface the
robot is a velocity-tracked unicycle-with-sideslip:

    state  x = (px, py, yaw, vx, vy, wz)        [vx, vy in the yaw frame]
    input  u = (vx_cmd, vy_cmd, wz_cmd) in [-1, 1]  (post-clip command units)
    vx'  = vx + a_v  * (vx_cmd - vx)            a = 1 - exp(-dt / tau)
    vy'  = vy + a_v  * (vy_cmd - vy)
    wz'  = wz + a_w  * (wz_cmd - wz)
    yaw' = yaw + wz' dt
    px'  = px + (cos(yaw) vx' - sin(yaw) vy') dt
    py'  = py + (sin(yaw) vx' + cos(yaw) vy') dt

The dynamics are plain tensor functions of one problem (x (A*6,), u
(A*3,)), which `torch.func` differentiates and vmaps (mpc/ilqr.py). The
tracking time constants are fit from closed-loop rollouts of the env
(`fit_command_model`); the least-squares fit itself is numpy on the host, as
in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mqe_tpu_torch.ops import quat as quat_ops
from mqe_tpu_torch.utils.random import Draws


@dataclass(frozen=True)
class CommandModel:
    dt: float = 0.1          # planner knot spacing (s); >= env control dt
    tau_v: float = 0.35      # linear-velocity tracking time constant (s)
    tau_w: float = 0.30      # yaw-rate tracking time constant (s)
    gain_v: float = 1.0      # steady-state velocity gain (realized v / cmd)
    gain_w: float = 1.0      # steady-state yaw-rate gain
    num_agents: int = 1

    @property
    def nx(self) -> int:
        return 6 * self.num_agents

    @property
    def nu(self) -> int:
        return 3 * self.num_agents

    def alpha(self):
        return (
            1.0 - np.exp(-self.dt / self.tau_v),
            1.0 - np.exp(-self.dt / self.tau_w),
        )


def single_dynamics(model: CommandModel):
    """f(x6, u3) -> x6 for one agent (any leading dims)."""
    a_v, a_w = (float(a) for a in model.alpha())
    dt = model.dt
    g_v, g_w = model.gain_v, model.gain_w

    def f(x, u):
        px, py, yaw, vx, vy, wz = x.unbind(-1)
        vx_n = vx + a_v * (g_v * u[..., 0] - vx)
        vy_n = vy + a_v * (g_v * u[..., 1] - vy)
        wz_n = wz + a_w * (g_w * u[..., 2] - wz)
        yaw_n = yaw + wz_n * dt
        c, s = torch.cos(yaw), torch.sin(yaw)
        px_n = px + (c * vx_n - s * vy_n) * dt
        py_n = py + (s * vx_n + c * vy_n) * dt
        return torch.stack([px_n, py_n, yaw_n, vx_n, vy_n, wz_n], dim=-1)

    return f


def joint_dynamics(model: CommandModel):
    """f(x, u, args) -> x for A stacked agents; args unused (cost-only).

    Block-diagonal over agents: the agent axis is a leading dim of the
    one-agent function, so the planner's Jacobians fx/fu are block matrices.
    """
    f1 = single_dynamics(model)
    A = model.num_agents

    def f(x, u, args):
        return f1(x.reshape(A, 6), u.reshape(A, 3)).reshape(-1)

    return f


def fit_command_model(env, dt_plan: float = 0.1, n_steps: int = 150, seed: int = 0):
    """Fit tau_v / tau_w from closed-loop step responses of the env.

    Drives the env (Go1Env, or a wrapper of one; command interface) with
    piecewise-constant random commands, one draw named "fit_cmd" every 25
    steps, records the realized yaw-frame base velocity, and least-squares
    fits the discrete first-order tracking coefficient a in
    v' = v + a (cmd - v) at the env's control dt; returns a CommandModel
    with taus converted to continuous time (valid at any planner dt). The
    env's draws come from a generator seeded with `seed`.
    """
    env = env.env if hasattr(env, "env") else env
    E, A, dev = env.num_envs, env.num_agents, env.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, _ = env.reset(Draws(gen))

    def yaw_frame_vel(st):
        ag = st.phys.agents
        v = quat_ops.quat_rotate_inverse(quat_ops.yaw_quat(ag.quat), ag.lin_vel)
        return v[..., :2].cpu().numpy(), ag.ang_vel[..., 2].cpu().numpy()

    cmds, vs, ws = [], [], []
    cmd = torch.zeros((E, A, 3), device=dev)
    for t in range(n_steps):
        draws = Draws(gen)
        if t % 25 == 0:
            cmd = draws.uniform("fit_cmd", (E, A, 3), -1.0, 1.0, dev)
        state, _, _, _ = env.step(state, cmd, draws)
        v, w = yaw_frame_vel(state)
        cmds.append(cmd.cpu().numpy())
        vs.append(v)
        ws.append(w)

    cmds = np.stack(cmds)   # (T, E, A, 3)
    vs = np.stack(vs)       # (T, E, A, 2)
    ws = np.stack(ws)       # (T, E, A)

    def fit_ag(c, v, dv):
        """LS fit of v' = v + a (g c - v): regress dv on [c, v] ->
        dv = b1 c + b2 v with a = -b2, g = b1 / a."""
        X = np.stack([c.ravel(), v.ravel()], axis=-1)
        y = dv.ravel()
        (b1, b2), *_ = np.linalg.lstsq(X, y, rcond=None)
        a = float(np.clip(-b2, 1e-3, 1.0))
        g = float(np.clip(b1 / a, 0.05, 2.0))
        return a, g

    a_v, g_v = fit_ag(cmds[:-1, ..., :2], vs[:-1], vs[1:] - vs[:-1])
    a_w, g_w = fit_ag(cmds[:-1, ..., 2], ws[:-1], ws[1:] - ws[:-1])

    dt_env = env.dt
    tau_v = -dt_env / np.log(max(1.0 - a_v, 1e-6))
    tau_w = -dt_env / np.log(max(1.0 - a_w, 1e-6))
    return CommandModel(
        dt=dt_plan, tau_v=float(tau_v), tau_w=float(tau_w),
        gain_v=g_v, gain_w=g_w, num_agents=A,
    )
