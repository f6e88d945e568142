"""Trajectory optimization / MPC over the locomotion command space, PyTorch.

Counterpart of `mqe_tpu/mpc/`: a batched multi-agent iLQR trajectory
optimizer (mpc/ilqr.py) that plans sequences of walk-policy commands (vx,
vy, yaw-rate) for every env at once, over a command-space model of the
walking robot fit from the env (mpc/command_model.py), with task costs
(mpc/costs.py), closed around the env by CommandMPC (mpc/controller.py) and
the `run_mpc` CLI.
"""
from mqe_tpu_torch.mpc.command_model import CommandModel, fit_command_model, joint_dynamics
from mqe_tpu_torch.mpc.controller import CommandMPC
from mqe_tpu_torch.mpc.ilqr import ILQRConfig, make_ilqr

__all__ = [
    "ILQRConfig",
    "make_ilqr",
    "CommandModel",
    "joint_dynamics",
    "fit_command_model",
    "CommandMPC",
]
