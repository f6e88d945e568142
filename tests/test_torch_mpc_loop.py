"""The port's command-space MPC closed around the env: go1gate at 2 envs
on the CPU, as tests/test_mpc.py::test_closed_loop_mpc_on_go1gate runs the
JAX package's. CommandMPC (task "gate", H = 10, 4 iterations) plans, the env
executes the first knot for 5 steps, 20 cycles: 2 s of sim must move the
robots forward by more than 0.1 m.

The JAX test fits the command model from 60 of the env's steps first; here
the default CommandModel plans (its fit is held in tests/test_torch_mpc.py),
since the plain physics takes ~1.1 s an env step on one CPU thread and the
loop's 100 steps are most of this file's time.
"""
import torch

from mqe_tpu_torch.envs.registry import make_mqe_env
from mqe_tpu_torch.mpc import CommandMPC, ILQRConfig
from mqe_tpu_torch.mpc.controller import planner_state
from mqe_tpu_torch.utils.random import Draws

torch.set_num_threads(1)


def test_closed_loop_mpc_on_go1gate():
    wrap, _ = make_mqe_env("go1gate", num_envs=2, seed=0, device="cpu")
    mpc = CommandMPC(wrap, task="gate", ilqr_cfg=ILQRConfig(horizon=10, n_iters=4))
    assert mpc.steps_per_knot == 5 and mpc.cfg.u_max == (1.0, 0.5, 0.5) * 2
    gen = torch.Generator().manual_seed(0)
    state, _ = mpc.env.reset(Draws(gen))
    x_start = float(planner_state(mpc.env, state)[..., 0].mean())
    ms = mpc.init_mpc_state()
    args = mpc.default_args(state)
    for _ in range(20):
        state, ms, done, cost = mpc.plan_step(state, ms, Draws(gen), args)
        assert torch.isfinite(cost).all() and ms.us.shape == (2, 10, 6)
    x_end = float(planner_state(mpc.env, state)[..., 0].mean())
    assert x_end > x_start + 0.1, f"{x_start=} {x_end=}"
