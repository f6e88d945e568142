"""Tests for the batched iLQR trajectory optimizer and command-space MPC.

Strategy (SURVEY.md §4): analytic solver validation (LQR vs Riccati),
convergence properties, batched multi-agent solves, and a closed-loop MPC
smoke run on the real go1gate env.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mqe_tpu.mpc import CommandModel, CommandMPC, ILQRConfig, make_ilqr
from mqe_tpu.mpc import costs as task_costs
from mqe_tpu.mpc.command_model import joint_dynamics
from mqe_tpu.mpc.ilqr import ILQRSolution


# ---------------------------------------------------------------------------
# iLQR core on analytic problems
# ---------------------------------------------------------------------------
class TestILQRCore:
    def _lqr_problem(self):
        # double integrator: x = (p, v), u = accel
        dt = 0.1
        A = jnp.array([[1.0, dt], [0.0, 1.0]])
        B = jnp.array([[0.0], [dt]])
        Q = jnp.diag(jnp.array([1.0, 0.1]))
        R = jnp.array([[0.1]])
        Qf = 10.0 * Q
        return A, B, Q, R, Qf

    def _riccati_cost(self, A, B, Q, R, Qf, x0, H):
        """Optimal finite-horizon LQR cost 0.5 x0' P0 x0 via backward Riccati."""
        A, B, Q, R, Qf = map(np.asarray, (A, B, Q, R, Qf))
        P = Qf.copy()
        for _ in range(H):
            K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
            P = Q + A.T @ P @ (A - B @ K)
        x0 = np.asarray(x0)
        return 0.5 * x0 @ P @ x0

    def test_matches_riccati_on_lqr(self):
        A, B, Q, R, Qf = self._lqr_problem()
        H = 30

        def dyn(x, u, args):
            return A @ x + B @ u

        def stage(x, u, t, args):
            return 0.5 * (x @ Q @ x + u @ R @ u)

        def final(x, args):
            return 0.5 * x @ Qf @ x

        solve = make_ilqr(
            dyn, stage, final,
            ILQRConfig(horizon=H, n_iters=3, u_min=None, u_max=None),
        )
        x0 = jnp.array([2.0, -1.0])
        sol = jax.jit(solve)(x0, jnp.zeros((H, 1)), {})
        expected = self._riccati_cost(A, B, Q, R, Qf, x0, H)
        # LQR is exactly solved by one iLQR iteration (quadratic problem)
        assert float(sol.cost) == pytest.approx(expected, rel=1e-4)

    def test_cost_trace_nonincreasing(self):
        A, B, Q, R, Qf = self._lqr_problem()

        def dyn(x, u, args):
            # nonlinear twist: slight drag
            xn = A @ x + B @ u
            return xn - 0.01 * jnp.tanh(xn)

        def stage(x, u, t, args):
            return 0.5 * (x @ Q @ x + u @ R @ u)

        def final(x, args):
            return 0.5 * x @ Qf @ x

        solve = make_ilqr(dyn, stage, final, ILQRConfig(horizon=25, n_iters=8))
        sol = solve(jnp.array([3.0, 0.0]), jnp.zeros((25, 1)), {})
        trace = np.asarray(sol.cost_trace)
        assert np.all(np.diff(trace) <= 1e-6)

    def test_control_limits_respected(self):
        A, B, Q, R, Qf = self._lqr_problem()

        def dyn(x, u, args):
            return A @ x + B @ u

        def stage(x, u, t, args):
            return 0.5 * (x @ Q @ x + 0.001 * (u @ u))

        def final(x, args):
            return 0.5 * x @ Qf @ x

        solve = make_ilqr(
            dyn, stage, final, ILQRConfig(horizon=20, n_iters=6, u_min=-0.5, u_max=0.5)
        )
        sol = solve(jnp.array([5.0, 0.0]), jnp.zeros((20, 1)), {})
        assert float(jnp.abs(sol.us).max()) <= 0.5 + 1e-6

    def test_batched_solve_vmap(self):
        A, B, Q, R, Qf = self._lqr_problem()
        H = 20

        def dyn(x, u, args):
            return A @ x + B @ u

        def stage(x, u, t, args):
            e = x - args["target"]
            return 0.5 * (e @ Q @ e + u @ R @ u)

        def final(x, args):
            e = x - args["target"]
            return 0.5 * e @ Qf @ e

        solve = jax.vmap(make_ilqr(dyn, stage, final, ILQRConfig(horizon=H, n_iters=5, u_min=None, u_max=None)))
        E = 8
        x0 = jnp.zeros((E, 2))
        targets = jnp.stack(
            [jnp.linspace(-2, 2, E), jnp.zeros(E)], axis=-1
        )
        sols = solve(x0, jnp.zeros((E, H, 1)), {"target": targets})
        final_p = np.asarray(sols.xs[:, -1, 0])
        np.testing.assert_allclose(final_p, np.asarray(targets[:, 0]), atol=0.25)


# ---------------------------------------------------------------------------
# Command-space model + multi-agent costs
# ---------------------------------------------------------------------------
class TestCommandMPC:
    def test_waypoint_reached_in_model(self):
        model = CommandModel(dt=0.1, num_agents=1)
        dyn = joint_dynamics(model)
        stage, final = task_costs.waypoint_cost(1)
        solve = make_ilqr(dyn, stage, final, ILQRConfig(horizon=30, n_iters=10))
        x0 = jnp.zeros(6)
        args = {"targets": jnp.array([[2.0, 1.0]])}
        sol = solve(x0, jnp.zeros((30, 3)), args)
        end = np.asarray(sol.xs[-1])
        assert abs(end[0] - 2.0) < 0.3
        assert abs(end[1] - 1.0) < 0.3

    def test_two_agents_keep_separation(self):
        model = CommandModel(dt=0.1, num_agents=2)
        dyn = joint_dynamics(model)
        w = task_costs.CostWeights(d_min=0.7, w_sep=8.0)
        stage, final = task_costs.waypoint_cost(2, w)
        solve = make_ilqr(dyn, stage, final, ILQRConfig(horizon=30, n_iters=12))
        # agents start facing each other, targets swap positions; a small
        # lateral offset breaks the exact head-on symmetry (a perfectly
        # symmetric start has zero lateral cost gradient by construction)
        x0 = jnp.array([0.0, 0.05, 0.0, 0.0, 0.0, 0.0,
                        3.0, -0.05, np.pi, 0.0, 0.0, 0.0])
        args = {"targets": jnp.array([[3.0, 0.05], [0.0, -0.05]])}
        sol = solve(x0, jnp.zeros((30, 6)), args)
        xs = np.asarray(sol.xs).reshape(-1, 2, 6)
        dists = np.linalg.norm(xs[:, 0, :2] - xs[:, 1, :2], axis=-1)
        assert dists.min() > 0.4  # separation hinge keeps them apart
        # and both still make progress toward their targets
        assert abs(xs[-1, 0, 0] - 3.0) < 1.0
        assert abs(xs[-1, 1, 0] - 0.0) < 1.0

    def test_gate_cost_routes_through_gate(self):
        model = CommandModel(dt=0.1, num_agents=2)
        dyn = joint_dynamics(model)
        stage, final = task_costs.gate_cost(2)
        solve = make_ilqr(dyn, stage, final, ILQRConfig(horizon=40, n_iters=12))
        x0 = jnp.array([0.0, 0.8, 0.0, 0.0, 0.0, 0.0,
                        0.0, -0.8, 0.0, 0.0, 0.0, 0.0])
        args = {"gate": jnp.array([2.0, 0.3]), "goal_x": jnp.asarray(5.0)}
        sol = solve(x0, jnp.zeros((40, 6)), args)
        xs = np.asarray(sol.xs).reshape(-1, 2, 6)
        # when crossing the gate plane x=2, y must be near the opening (0.3)
        for a in range(2):
            xa = xs[:, a]
            crossing = np.argmax(xa[:, 0] > 2.0) if (xa[:, 0] > 2.0).any() else None
            assert crossing is not None, "agent never crossed the gate plane"
            assert abs(xa[crossing, 1] - 0.3) < 0.5

    @pytest.mark.slow
    def test_closed_loop_mpc_on_go1gate(self):
        """Full stack: fit the command-tracking model from the real env,
        then iLQR plans commands the real env executes."""
        from mqe_tpu.envs import make_mqe_env
        from mqe_tpu.mpc import fit_command_model
        from mqe_tpu.mpc.controller import planner_state

        wrap, _ = make_mqe_env("go1gate", num_envs=2, seed=0)
        model = fit_command_model(wrap, n_steps=60)
        mpc = CommandMPC(
            wrap, task="gate",
            ilqr_cfg=ILQRConfig(horizon=10, n_iters=4),
            model=model,
        )
        key = jax.random.PRNGKey(0)
        key, k = jax.random.split(key)
        state, _ = mpc.env.reset(k)
        x_start = float(planner_state(mpc.env, state)[..., 0].mean())
        ms = mpc.init_mpc_state()
        args = mpc.default_args(state)
        for _ in range(20):
            key, k = jax.random.split(key)
            state, ms, done, cost = mpc.plan_step(state, ms, k, args)
        x_end = float(planner_state(mpc.env, state)[..., 0].mean())
        # 20 cycles x 5 env steps x 0.02 s = 2 s of sim; MPC should have
        # driven the agents forward toward the gate
        assert x_end > x_start + 0.1, f"{x_start=} {x_end=}"

    def test_fit_command_model_sane(self):
        from mqe_tpu.envs import make_mqe_env
        from mqe_tpu.mpc import fit_command_model

        wrap, _ = make_mqe_env("go1plane", num_envs=2, seed=0)
        model = fit_command_model(wrap, n_steps=60)
        assert 0.01 < model.tau_v < 5.0
        assert 0.01 < model.tau_w < 5.0
        assert 0.05 < model.gain_v <= 2.0
        assert 0.05 < model.gain_w <= 2.0
