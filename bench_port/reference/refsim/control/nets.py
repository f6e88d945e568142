"""Small MLPs of the control path, as `nn.Module`s.

PyTorch counterpart of `mqe_tpu/control/nets.py`:

  actuator net:  per-joint MLP 6 -> 32 -> 32 -> 1, softsign activations
                 (ref go1.py:367-382; weights mqe_tpu/assets/actuator_go1.npz)
  body policy:   obs70 -> 256 -> 128 -> 64 -> 12, ELU, then prescale * tanh
                 (trained by learn/train_locomotion.py;
                 mqe_tpu/assets/body_policy.npz)
  adaptation:    2100 -> 256 -> 128 -> 2, ELU (the walk-these-ways
                 adaptation module; mqe_tpu/assets/adaptation_wtw.npz)
  WTW body:      (2100 + 2) -> 512 -> 256 -> 128 -> 12, ELU; the reference's
                 blob is missing from its snapshot, so its weights come from
                 the caller (utils/convert.py::wtw_body_from_numpy)

Weights are read in place from the JAX package's asset files with numpy.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from refsim import ASSETS_DIR


def softsign(x):
    return x / (1.0 + torch.abs(x))


def elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


ACTIVATIONS = {"softsign": softsign, "elu": elu, "tanh": torch.tanh}


class MLP(nn.Module):
    """Linear layers with one activation between them (none after the last)."""

    def __init__(self, sizes, activation: str):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        act = ACTIVATIONS[self.activation]
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = act(x)
        return x


def _npz(name_or_path):
    path = name_or_path if os.path.isabs(name_or_path) else os.path.join(ASSETS_DIR, name_or_path)
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


class ActuatorNet(nn.Module):
    """Unitree go1 actuator model: (joint err x3 hist, joint vel x3 hist) ->
    torque, evaluated per joint (ref go1.py:369-380). With no `mlp` it loads
    the committed weights onto `device`."""

    def __init__(self, mlp: MLP | None = None, device="cuda"):
        super().__init__()
        if mlp is None:
            from refsim.utils.convert import mlp_from_numpy

            mlp = mlp_from_numpy(_npz("actuator_go1.npz"), device=device)
        self.mlp = mlp

    def forward(self, err, err_last, err_last_last, vel, vel_last, vel_last_last):
        """All inputs (..., 12). Returns torques (..., 12)."""
        x = torch.stack([err, err_last, err_last_last, vel, vel_last, vel_last_last], dim=-1)
        return self.mlp(x)[..., 0]


class AdaptationModule(nn.Module):
    """The walk-these-ways adaptation module: obs history (..., 2100) ->
    latent (..., 2). With no `mlp` it loads the committed weights onto
    `device`."""

    def __init__(self, mlp: MLP | None = None, device="cuda"):
        super().__init__()
        if mlp is None:
            from refsim.utils.convert import mlp_from_numpy

            mlp = mlp_from_numpy(_npz("adaptation_wtw.npz"), device=device)
        self.mlp = mlp

    def forward(self, obs_history):
        return self.mlp(obs_history)


class WalkTheseWaysBody(nn.Module):
    """The walk-these-ways body MLP: (history || latent) (..., 2102) ->
    action (..., 12), no squash (the JAX package's `mlp_apply` of it)."""

    def __init__(self, mlp: MLP):
        super().__init__()
        self.mlp = mlp

    def forward(self, x):
        return self.mlp(x)


class BodyPolicy(nn.Module):
    """Deterministic body policy obs70 -> action12: `prescale * tanh(mlp(obs))`,
    the action squash the policy was trained with."""

    def __init__(self, mlp: MLP, prescale: float = 4.0):
        super().__init__()
        self.mlp = mlp
        self.prescale = float(prescale)

    def forward(self, obs):
        return self.prescale * torch.tanh(self.mlp(obs))


def load_body_policy(path, device="cuda") -> BodyPolicy:
    """Body policy on `device` from a trainer npz (flax
    `params/actor/Dense_i/kernel` (in, out) and `bias` entries, optional
    `meta_prescale`, default 4.0)."""
    from refsim.utils.convert import mlp_from_numpy

    d = _npz(path)
    params, i = {"activation": "elu"}, 0
    while f"params/actor/Dense_{i}/kernel" in d:
        params[f"w{i}"] = d[f"params/actor/Dense_{i}/kernel"].T
        params[f"b{i}"] = d[f"params/actor/Dense_{i}/bias"]
        i += 1
    prescale = float(d["meta_prescale"]) if "meta_prescale" in d else 4.0
    return BodyPolicy(mlp_from_numpy(params, device=device), prescale)
