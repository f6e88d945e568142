"""Batched iterative LQR (iLQR/DDP) trajectory optimizer, PyTorch.

Counterpart of `mqe_tpu/mpc/ilqr.py`, which builds a solver for one problem
and vmaps it over the envs. Here the solver takes the env batch directly:
x0 (E, n), u_init (E, H, m) and per-env `args` (a dict of (E, ...) tensors),
and the problem's functions are written for one problem (dynamics(x, u,
args), stage_cost(x, u, t, args), final_cost(x, args)), which `torch.func`
vmaps and differentiates:

- linearize: `jacfwd` of the dynamics and `grad` / `hessian` of the stage
  cost, taken with respect to z = (x, u) at once and split into the
  fx/fu, lx/lu and lxx/luu/lux blocks, vmapped over all (E, H) knots;
- backward Riccati pass: a Python loop over the horizon in reverse, each
  step small dense linear algebra batched over E;
- forward line search: every step size at once, as a leading batch of the
  rollout (len(alphas) x E), as the JAX package vmaps over `alphas`;
- the best step size per env, the `improved` mask and the Levenberg-
  Marquardt regularisation schedule, each per env.

A `Quu` that is not positive definite: JAX's `cho_factor` returns NaNs,
which become an `inf` candidate cost, rejected for that env alone.
`torch.linalg.cholesky` would raise for the whole batch instead, so the
factorisation is `cholesky_ex`, and an env whose factorisation failed at any
knot gets `inf` for every candidate of that iteration: rejected per env,
the other envs' plans unchanged.

Box control limits are handled by clamped forward rollouts plus a
regularised backward pass, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, vmap


@dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 20
    n_iters: int = 10
    reg_init: float = 1e-2
    reg_min: float = 1e-6
    reg_max: float = 1e4
    # parallel line-search step sizes (all evaluated at once)
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    # box control limits; scalar or per-channel tuple of length m
    u_min: float | tuple | None = -1.0
    u_max: float | tuple | None = 1.0


class ILQRSolution(NamedTuple):
    xs: torch.Tensor          # (E, H+1, n) optimized state trajectory
    us: torch.Tensor          # (E, H, m) optimized controls
    cost: torch.Tensor        # (E,) final total cost
    cost_trace: torch.Tensor  # (E, n_iters) cost after each iteration


def _clamp(u, cfg: ILQRConfig):
    if cfg.u_min is None and cfg.u_max is None:
        return u
    t = lambda v: torch.as_tensor(v, dtype=u.dtype, device=u.device)  # noqa: E731
    if cfg.u_min is not None:
        u = torch.maximum(u, t(cfg.u_min))
    if cfg.u_max is not None:
        u = torch.minimum(u, t(cfg.u_max))
    return u


def _repeat(args, n):
    """Each (E, ...) tensor of `args` repeated n times along a new leading
    axis, flattened to (n*E, ...)."""
    return {k: v.repeat((n,) + (1,) * (v.ndim - 1)) for k, v in args.items()}


def _knots(args, H):
    """Each (E, ...) tensor of `args` once per knot, (E*H, ...), E-major."""
    return {k: v.repeat_interleave(H, dim=0) for k, v in args.items()}


def make_ilqr(
    dynamics: Callable,      # f(x, u, args) -> x_next, one problem
    stage_cost: Callable,    # l(x, u, t, args) -> scalar
    final_cost: Callable,    # lf(x, args) -> scalar
    cfg: ILQRConfig = ILQRConfig(),
):
    """Build solve(x0, u_init, args) -> ILQRSolution over a batch of envs.

    x0 (E, n), u_init (E, H, m); `args` is a dict of per-env (E, ...)
    tensors (targets, obstacle positions, ...) threaded through dynamics
    and costs. The solver's pieces are attributes of `solve` (`rollout`,
    `total_cost`, `linearize`, `backward`, `forward`, `iteration`), which
    the tests hold one by one against the JAX package's.
    """
    H = cfg.horizon
    dyn_b = vmap(dynamics)                                   # over a batch
    stage_b = vmap(stage_cost)
    final_b = vmap(final_cost)

    def rollout(x0, us, args):
        xs = [x0]
        for t in range(H):
            xs.append(dyn_b(xs[-1], _clamp(us[:, t], cfg), args))
        return torch.stack(xs, dim=1)

    def total_cost(xs, us, args):
        E = xs.shape[0]
        ts = torch.arange(H, device=xs.device).repeat(E)
        l_run = stage_b(xs[:, :-1].reshape(E * H, -1), us.reshape(E * H, -1), ts,
                        _knots(args, H)).reshape(E, H)
        return l_run.sum(-1) + final_b(xs[:, -1], args)

    def linearize(xs, us, args):
        """fx (E, H, n, n), fu (E, H, n, m), lx, lu, lxx, luu, lux at every knot."""
        E, n, m = xs.shape[0], xs.shape[-1], us.shape[-1]
        z = torch.cat([xs[:, :-1], us], dim=-1).reshape(E * H, n + m)
        ts = torch.arange(H, device=xs.device).repeat(E)
        ka = _knots(args, H)
        f_z = lambda z, a: dynamics(z[:n], z[n:], a)          # noqa: E731
        l_z = lambda z, t, a: stage_cost(z[:n], z[n:], t, a)  # noqa: E731
        fz = vmap(jacfwd(f_z))(z, ka).reshape(E, H, n, n + m)
        lz = vmap(grad(l_z))(z, ts, ka).reshape(E, H, n + m)
        lzz = vmap(hessian(l_z))(z, ts, ka).reshape(E, H, n + m, n + m)
        return (fz[..., :n], fz[..., n:], lz[..., :n], lz[..., n:],
                lzz[..., :n, :n], lzz[..., n:, n:], lzz[..., n:, :n])

    def backward(xs, us, args, reg):
        """Gains ks (E, H, m), Ks (E, H, m, n), and the envs whose Quu
        failed to factorise at some knot (E,) bool."""
        fx, fu, lx, lu, lxx, luu, lux = linearize(xs, us, args)
        Vx = vmap(grad(final_cost))(xs[:, -1], args)
        Vxx = vmap(hessian(final_cost))(xs[:, -1], args)
        E, m = us.shape[0], us.shape[-1]
        eye_m = torch.eye(m, dtype=us.dtype, device=us.device)
        reg_m = reg[:, None, None] * eye_m
        failed = torch.zeros(E, dtype=torch.bool, device=us.device)
        ks, Ks = [None] * H, [None] * H
        for t in reversed(range(H)):
            fxT, fuT = fx[:, t].transpose(-1, -2), fu[:, t].transpose(-1, -2)
            Qx = lx[:, t] + (fxT @ Vx[..., None])[..., 0]
            Qu = lu[:, t] + (fuT @ Vx[..., None])[..., 0]
            Qxx = lxx[:, t] + fxT @ Vxx @ fx[:, t]
            Quu = luu[:, t] + fuT @ Vxx @ fu[:, t] + reg_m
            Qux = lux[:, t] + fuT @ Vxx @ fx[:, t]
            Quu = 0.5 * (Quu + Quu.transpose(-1, -2))
            chol, info = torch.linalg.cholesky_ex(Quu)
            failed = failed | (info != 0)
            k = -torch.cholesky_solve(Qu[..., None], chol)[..., 0]
            K = -torch.cholesky_solve(Qux, chol)
            KT, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
            Vx = (Qx + (KT @ Quu @ k[..., None])[..., 0] + (KT @ Qu[..., None])[..., 0]
                  + (QuxT @ k[..., None])[..., 0])
            Vxx = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
            Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
            ks[t], Ks[t] = k, K
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), failed

    def forward(xs_ref, us_ref, ks, Ks, args, alphas):
        """Rollouts of the new policy for every step size at once: xs
        (S, E, H+1, n), us (S, E, H, m), cost (S, E) for S = len(alphas)."""
        S, (E, _, n) = alphas.shape[0], xs_ref.shape
        rep = lambda v: v[None].expand((S,) + v.shape).reshape((S * E,) + v.shape[1:])  # noqa: E731
        a_sE = alphas[:, None, None].expand(S, E, 1).reshape(S * E, 1)
        xr, ur, kr, Kr = rep(xs_ref), rep(us_ref), rep(ks), rep(Ks)
        ra = _repeat(args, S)
        x = xr[:, 0]
        c = torch.zeros(S * E, dtype=xs_ref.dtype, device=xs_ref.device)
        xs_new, us_new = [x], []
        for t in range(H):
            u = _clamp(ur[:, t] + a_sE * kr[:, t] + (Kr[:, t] @ (x - xr[:, t])[..., None])[..., 0],
                       cfg)
            c = c + stage_b(x, u, torch.full((S * E,), t, device=x.device), ra)
            x = dyn_b(x, u, ra)
            xs_new.append(x)
            us_new.append(u)
        c = c + final_b(x, ra)
        return (torch.stack(xs_new, dim=1).reshape(S, E, H + 1, n),
                torch.stack(us_new, dim=1).reshape(S, E, H, -1), c.reshape(S, E))

    def iteration(xs, us, cost, reg, args, alphas):
        """One iLQR iteration. Returns (xs, us, cost, reg, best): `best` (E,)
        the index of the step size each env chose (taken only where it
        improved the cost)."""
        ks, Ks, failed = backward(xs, us, args, reg)
        # parallel line search: roll out every alpha at once
        xs_c, us_c, c_c = forward(xs, us, ks, Ks, args, alphas)
        # a failed factorisation (non-PD Quu before enough regularization)
        # rejects every candidate of that env; NaN costs likewise
        c_c = torch.where(torch.isnan(c_c) | failed[None], torch.inf, c_c)
        c_best, best = c_c.min(dim=0)                        # (E,)
        improved = c_best < cost
        E = xs.shape[0]
        ar = torch.arange(E, device=xs.device)
        xs_n = torch.where(improved[:, None, None], xs_c[best, ar], xs)
        us_n = torch.where(improved[:, None, None], us_c[best, ar], us)
        cost_n = torch.where(improved, c_best, cost)
        # Levenberg-Marquardt style regularization schedule
        reg_n = torch.where(improved, torch.clamp(reg * 0.5, min=cfg.reg_min),
                            torch.clamp(reg * 10.0, max=cfg.reg_max))
        return xs_n, us_n, cost_n, reg_n, best

    def solve(x0, u_init, args) -> ILQRSolution:
        alphas = torch.tensor(cfg.alphas, dtype=x0.dtype, device=x0.device)
        us = _clamp(u_init, cfg)
        xs = rollout(x0, us, args)
        cost = total_cost(xs, us, args)
        reg = torch.full_like(cost, cfg.reg_init)
        trace = []
        for _ in range(cfg.n_iters):
            xs, us, cost, reg, _ = iteration(xs, us, cost, reg, args, alphas)
            trace.append(cost)
        return ILQRSolution(xs=xs, us=us, cost=cost, cost_trace=torch.stack(trace, dim=-1))

    solve.rollout, solve.total_cost, solve.linearize = rollout, total_cost, linearize
    solve.backward, solve.forward, solve.iteration = backward, forward, iteration
    return solve
