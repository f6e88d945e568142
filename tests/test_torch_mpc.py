"""The port's command-space MPC (mqe_tpu_torch/mpc/) against the JAX package.

- The iLQR's analytic cases of tests/test_mpc.py: LQR against the Riccati
  cost (rel 1e-4), a non-increasing cost trace, the control limits held, a
  batched solve, and the command-model cases (waypoint, separation, gate).
- Against the JAX solver's record (tests/goldens/torch_mpc.npz, written by
  tools/make_torch_goldens.py), for `gate_cost` at A = 2, H = 20 from equal
  (xs, us, args): the linearization, one backward pass (`ks`, `Ks`) and one
  forward pass per step size, each at rel 1e-5; whole solves at 2 envs for
  gate, pushbox and waypoint: cost rel 1e-3, the step size each iteration
  chose and whether it improved, equal; the costs' value, gradient and
  Hessian at their hinges' kinks (rel 1e-5), where torch.maximum/minimum
  split the derivative as JAX does.
- A Quu that is not positive definite in one env: rejected for that env,
  the other env's plan the same as solved alone.
- `fit_command_model`'s bounds (tests/test_mpc.py, go1plane at 2 envs), the
  controller's args under the curriculum, and the `run_mpc` CLI. The closed
  loop on go1gate is tests/test_torch_mpc_loop.py, a file of its own so
  that a second worker runs its 100 env steps beside this file's 70.

"rel" is the largest difference over the largest magnitude of JAX's array.
"""
import os

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs import tasks as T
from mqe_tpu_torch.envs.go1_env import Go1Env
from mqe_tpu_torch.envs.registry import make_mqe_env
from mqe_tpu_torch.mpc import CommandModel, CommandMPC, ILQRConfig, fit_command_model, make_ilqr
from mqe_tpu_torch.mpc import costs as task_costs
from mqe_tpu_torch.mpc.command_model import joint_dynamics

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "torch_mpc.npz")
MPC_H = 20
STEP_REL = 1e-5
SOLVE_REL = 1e-3


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def rec():
    with np.load(GOLDEN) as f:
        return dict(f)


def _args(rec, prefix):
    n = len(prefix) + len("/args/")
    return {k[n:]: _t(v) for k, v in rec.items() if k.startswith(prefix + "/args/")}


def _problem(task, A=2):
    """The recorder's `_mpc_problem`: CommandMPC's defaults for `task`."""
    lim = tuple([1.0, 0.5, 0.5] * A)
    cfg = ILQRConfig(horizon=MPC_H, n_iters=8, u_min=tuple(-v for v in lim), u_max=lim)
    stage, final = {"gate": task_costs.gate_cost, "pushbox": task_costs.pushbox_cost,
                    "waypoint": task_costs.waypoint_cost}[task](A)
    return make_ilqr(joint_dynamics(CommandModel(dt=0.1, num_agents=A)), stage, final, cfg)


# ---------------------------------------------------------------------------
# the iLQR on analytic problems (tests/test_mpc.py)
# ---------------------------------------------------------------------------

def _lqr():
    dt = 0.1
    A = _t([[1.0, dt], [0.0, 1.0]])
    B = _t([[0.0], [dt]])
    Q = torch.diag(_t([1.0, 0.1]))
    R = _t([[0.1]])
    return A, B, Q, R, 10.0 * Q


def _riccati_cost(A, B, Q, R, Qf, x0, H):
    A, B, Q, R, Qf = (np.asarray(m, np.float64) for m in (A, B, Q, R, Qf))
    P = Qf.copy()
    for _ in range(H):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ (A - B @ K)
    x0 = np.asarray(x0, np.float64)
    return 0.5 * x0 @ P @ x0


def test_matches_riccati_on_lqr():
    A, B, Q, R, Qf = _lqr()
    H = 30
    solve = make_ilqr(lambda x, u, a: A @ x + B @ u,
                      lambda x, u, t, a: 0.5 * (x @ Q @ x + u @ R @ u),
                      lambda x, a: 0.5 * x @ Qf @ x,
                      ILQRConfig(horizon=H, n_iters=3, u_min=None, u_max=None))
    x0 = _t([[2.0, -1.0]])
    sol = solve(x0, torch.zeros((1, H, 1)), {})
    assert float(sol.cost[0]) == pytest.approx(_riccati_cost(A, B, Q, R, Qf, x0[0], H), rel=1e-4)


def test_cost_trace_nonincreasing():
    A, B, Q, R, Qf = _lqr()

    def dyn(x, u, a):
        xn = A @ x + B @ u
        return xn - 0.01 * torch.tanh(xn)

    solve = make_ilqr(dyn, lambda x, u, t, a: 0.5 * (x @ Q @ x + u @ R @ u),
                      lambda x, a: 0.5 * x @ Qf @ x, ILQRConfig(horizon=25, n_iters=8))
    sol = solve(_t([[3.0, 0.0]]), torch.zeros((1, 25, 1)), {})
    assert np.all(np.diff(sol.cost_trace[0].numpy()) <= 1e-6)


def test_control_limits_respected():
    A, B, Q, R, Qf = _lqr()
    solve = make_ilqr(lambda x, u, a: A @ x + B @ u,
                      lambda x, u, t, a: 0.5 * (x @ Q @ x + 0.001 * (u @ u)),
                      lambda x, a: 0.5 * x @ Qf @ x,
                      ILQRConfig(horizon=20, n_iters=6, u_min=-0.5, u_max=0.5))
    sol = solve(_t([[5.0, 0.0]]), torch.zeros((1, 20, 1)), {})
    assert float(sol.us.abs().max()) <= 0.5 + 1e-6


def test_batched_solve():
    A, B, Q, R, Qf = _lqr()
    H, E = 20, 8

    def stage(x, u, t, a):
        e = x - a["target"]
        return 0.5 * (e @ Q @ e + u @ R @ u)

    def final(x, a):
        e = x - a["target"]
        return 0.5 * e @ Qf @ e

    solve = make_ilqr(lambda x, u, a: A @ x + B @ u, stage, final,
                      ILQRConfig(horizon=H, n_iters=5, u_min=None, u_max=None))
    targets = torch.stack([torch.linspace(-2, 2, E), torch.zeros(E)], dim=-1)
    sols = solve(torch.zeros((E, 2)), torch.zeros((E, H, 1)), {"target": targets})
    np.testing.assert_allclose(sols.xs[:, -1, 0].numpy(), targets[:, 0].numpy(), atol=0.25)


def test_waypoint_reached_in_model():
    stage, final = task_costs.waypoint_cost(1)
    solve = make_ilqr(joint_dynamics(CommandModel(dt=0.1, num_agents=1)), stage, final,
                      ILQRConfig(horizon=30, n_iters=10))
    sol = solve(torch.zeros((1, 6)), torch.zeros((1, 30, 3)), {"targets": _t([[[2.0, 1.0]]])})
    end = sol.xs[0, -1].numpy()
    assert abs(end[0] - 2.0) < 0.3 and abs(end[1] - 1.0) < 0.3


def test_two_agents_keep_separation():
    w = task_costs.CostWeights(d_min=0.7, w_sep=8.0)
    stage, final = task_costs.waypoint_cost(2, w)
    solve = make_ilqr(joint_dynamics(CommandModel(dt=0.1, num_agents=2)), stage, final,
                      ILQRConfig(horizon=30, n_iters=12))
    x0 = _t([[0.0, 0.05, 0.0, 0.0, 0.0, 0.0, 3.0, -0.05, np.pi, 0.0, 0.0, 0.0]])
    sol = solve(x0, torch.zeros((1, 30, 6)), {"targets": _t([[[3.0, 0.05], [0.0, -0.05]]])})
    xs = sol.xs[0].numpy().reshape(-1, 2, 6)
    assert np.linalg.norm(xs[:, 0, :2] - xs[:, 1, :2], axis=-1).min() > 0.4
    assert abs(xs[-1, 0, 0] - 3.0) < 1.0 and abs(xs[-1, 1, 0] - 0.0) < 1.0


def test_gate_cost_routes_through_gate():
    stage, final = task_costs.gate_cost(2)
    solve = make_ilqr(joint_dynamics(CommandModel(dt=0.1, num_agents=2)), stage, final,
                      ILQRConfig(horizon=40, n_iters=12))
    x0 = _t([[0.0, 0.8, 0.0, 0.0, 0.0, 0.0, 0.0, -0.8, 0.0, 0.0, 0.0, 0.0]])
    sol = solve(x0, torch.zeros((1, 40, 6)), {"gate": _t([[2.0, 0.3]]), "goal_x": _t([5.0])})
    xs = sol.xs[0].numpy().reshape(-1, 2, 6)
    for a in range(2):
        xa = xs[:, a]
        assert (xa[:, 0] > 2.0).any(), "agent never crossed the gate plane"
        assert abs(xa[np.argmax(xa[:, 0] > 2.0), 1] - 0.3) < 0.5


def test_non_pd_quu_rejected_per_env():
    """Env 1's stage cost is concave in u (Quu < 0 until the
    regularisation outgrows it): its candidates are rejected, its plan and
    cost stay as they started, and env 0's plan is the one it gets alone."""
    cfg = ILQRConfig(horizon=6, n_iters=2, u_min=-1.0, u_max=1.0)
    dyn = lambda x, u, a: x + 0.1 * u                         # noqa: E731
    stage = lambda x, u, t, a: 0.5 * (x @ x) + 0.5 * a["c"] * (u @ u)  # noqa: E731
    final = lambda x, a: 0.5 * (x @ x)                        # noqa: E731
    solve = make_ilqr(dyn, stage, final, cfg)
    x0, u0 = _t([[1.0], [1.0]]), torch.full((2, 6, 1), 0.3)
    sol = solve(x0, u0, {"c": _t([0.1, -5.0])})
    start = solve.total_cost(solve.rollout(x0, u0, {"c": _t([0.1, -5.0])}), u0,
                             {"c": _t([0.1, -5.0])})
    assert torch.equal(sol.us[1], u0[1])
    assert torch.equal(sol.cost_trace[1], start[1].expand(2))
    assert float(sol.cost[0]) < float(start[0])
    alone = solve(x0[:1], u0[:1], {"c": _t([0.1])})
    np.testing.assert_allclose(sol.us[:1].numpy(), alone.us.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sol.cost[:1].numpy(), alone.cost.numpy(), rtol=1e-6)
    # the factorisation that failed: torch.linalg.cholesky raises for the batch
    _, _, failed = solve.backward(solve.rollout(x0, u0, {"c": _t([0.1, -5.0])}), u0,
                                  {"c": _t([0.1, -5.0])}, torch.full((2,), 1e-2))
    assert failed.tolist() == [False, True]


# ---------------------------------------------------------------------------
# against the JAX solver's record
# ---------------------------------------------------------------------------

def test_linearize_matches_jax(rec):
    solve = _problem("gate")
    lin = solve.linearize(_t(rec["gate/pass/xs"]), _t(rec["gate/pass/us"]),
                          _args(rec, "gate/pass"))
    for name, v in zip(("fx", "fu", "lx", "lu", "lxx", "luu", "lux"), lin):
        r = _rel(v.numpy(), rec[f"gate/pass/{name}"])
        assert r <= STEP_REL, f"{name}: rel {r:.3e}"


def test_backward_pass_matches_jax(rec):
    solve = _problem("gate")
    ks, Ks, failed = solve.backward(_t(rec["gate/pass/xs"]), _t(rec["gate/pass/us"]),
                                    _args(rec, "gate/pass"), _t(rec["gate/pass/reg"]))
    assert not failed.any()
    for name, v in (("ks", ks), ("Ks", Ks)):
        r = _rel(v.numpy(), rec[f"gate/pass/{name}"])
        assert r <= STEP_REL, f"{name}: rel {r:.3e}"


def test_forward_pass_per_alpha_matches_jax(rec):
    """One forward pass for each step size from JAX's gains, all at once."""
    solve = _problem("gate")
    alphas = _t(ILQRConfig().alphas)
    xs, us, cost = solve.forward(_t(rec["gate/pass/xs"]), _t(rec["gate/pass/us"]),
                                 _t(rec["gate/pass/ks"]), _t(rec["gate/pass/Ks"]),
                                 _args(rec, "gate/pass"), alphas)
    for name, v in (("fw_xs", xs), ("fw_us", us), ("fw_cost", cost)):
        r = _rel(v.numpy(), rec[f"gate/pass/{name}"])
        assert r <= STEP_REL, f"{name}: rel {r:.3e}"


def _port_alpha_trace(solve, cfg, x0, u0, args):
    """The port's solve, iteration by iteration: the step size each env
    chose and whether it improved, (E, n_iters), and the final cost."""
    alphas = _t(cfg.alphas)
    us = torch.clamp(u0, _t(cfg.u_min), _t(cfg.u_max))
    xs = solve.rollout(x0, us, args)
    cost = solve.total_cost(xs, us, args)
    reg = torch.full_like(cost, cfg.reg_init)
    best, improved = [], []
    for _ in range(cfg.n_iters):
        prev = cost
        xs, us, cost, reg, b = solve.iteration(xs, us, cost, reg, args, alphas)
        best.append(b)
        improved.append(cost < prev)
    return torch.stack(best, -1).numpy(), torch.stack(improved, -1).numpy(), us, cost


@pytest.mark.parametrize("task", ["gate", "pushbox", "waypoint"])
def test_solve_matches_jax(rec, task):
    pre = f"{task}/solve"
    solve = _problem(task)
    x0, u0, args = _t(rec[f"{pre}/x0"]), _t(rec[f"{pre}/u_init"]), _args(rec, pre)
    sol = solve(x0, u0, args)
    r = _rel(sol.cost.numpy(), rec[f"{pre}/cost"])
    assert r <= SOLVE_REL, f"cost: rel {r:.3e}"
    assert _rel(sol.cost_trace.numpy(), rec[f"{pre}/cost_trace"]) <= SOLVE_REL
    lim = [1.0, 0.5, 0.5] * 2
    cfg = ILQRConfig(horizon=MPC_H, n_iters=8, u_min=tuple(-v for v in lim), u_max=tuple(lim))
    best, improved, us, cost = _port_alpha_trace(solve, cfg, x0, u0, args)
    assert torch.equal(cost, sol.cost) and torch.equal(us, sol.us)
    np.testing.assert_array_equal(improved, rec[f"{pre}/improved"])
    np.testing.assert_array_equal(np.where(improved, best, -1),
                                  np.where(rec[f"{pre}/improved"], rec[f"{pre}/best"], -1))


@pytest.mark.parametrize("kink", ["sep", "heading"])
def test_cost_kinks_match_jax(rec, kink):
    """The stage cost, its gradient and its Hessian in (x, u) at a hinge's
    kink: two robots exactly gate_cost's d_min apart ("sep"); a robot
    exactly 2 m from its waypoint ("heading")."""
    from torch.func import grad, hessian

    pre = f"kink/{kink}"
    stage = task_costs.gate_cost(2)[0] if kink == "sep" else task_costs.waypoint_cost(1)[0]
    x, u, args = _t(rec[f"{pre}/x"]), _t(rec[f"{pre}/u"]), _args(rec, pre)
    n = x.shape[0]
    lz = lambda z: stage(z[:n], z[n:], 0, args)  # noqa: E731
    z = torch.cat([x, u])
    for name, v in (("value", lz(z)), ("grad", grad(lz)(z)), ("hessian", hessian(lz)(z))):
        r = _rel(v.detach().numpy(), rec[f"{pre}/{name}"])
        assert r <= STEP_REL, f"{name}: rel {r:.3e}"


# ---------------------------------------------------------------------------
# the command model fit from the env, the controller's args, the CLI
# ---------------------------------------------------------------------------

def test_fit_command_model_sane():
    """tests/test_mpc.py::test_fit_command_model_sane: go1plane at 2 envs,
    60 steps."""
    wrap, _ = make_mqe_env("go1plane", num_envs=2, seed=0, device="cpu")
    model = fit_command_model(wrap, n_steps=60)
    assert model.num_agents == 1 and model.dt == 0.1
    assert 0.01 < model.tau_v < 5.0
    assert 0.01 < model.tau_w < 5.0
    assert 0.05 < model.gain_v <= 2.0
    assert 0.05 < model.gain_w <= 2.0


def test_default_args_follow_the_level():
    """Under the curriculum the gate's args come from each env's level's
    oracle row; the pushbox's from the box and the level's origin."""
    class GateRows(T.Go1GateCfg):
        class terrain(T.Go1GateCfg.terrain):
            num_rows = 2
            curriculum = True

    env = Go1Env(GateRows, num_envs=2, seed=0, device="cpu")
    levels = torch.as_tensor(1 - env.env_rows, dtype=torch.int32)
    state = env._reset_all(env.draws(), levels)
    args = CommandMPC(env, task="gate").default_args(state)
    bt = env.cfg.terrain.BarrierTrack_kwargs
    dev = env.grid_env_info["gate_deviation"][levels.long(), env.env_cols_j]
    gate_x = bt["init"]["block_length"] + bt["gate"]["block_length"] / 2
    assert torch.equal(args["gate"], torch.stack([dev[:, 0] + gate_x, dev[:, 1]], -1))
    wrap, _ = make_mqe_env("go1pushbox", num_envs=2, seed=0, device="cpu")
    ts, _ = wrap.reset()
    pargs = CommandMPC(wrap, task="pushbox").default_args(ts.env)
    assert torch.equal(pargs["box"], ts.env.phys.npcs.pos[:, 0, :2] - wrap.env.env_origins[:, :2])
    assert pargs["push_dir"].tolist() == [[1.0, 0.0]] * 2


def test_run_mpc_cli():
    from mqe_tpu_torch.mpc import run_mpc

    out = run_mpc.main(["--task", "go1gate", "--num-envs", "2", "--cycles", "1",
                        "--horizon", "5", "--iters", "2", "--cpu"])
    assert out["mpc_task"] == "gate" and out["sim_seconds"] == 0.1
    assert np.isfinite(out["mean_x_progress_m"]) and out["solves_per_s"] > 0
