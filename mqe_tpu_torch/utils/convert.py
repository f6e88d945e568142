"""Weights and state carried across from the JAX package, through numpy.

`mlp_from_numpy` builds the port's MLP from a parameter dict in the layout of
the npz assets; `env_state_from_numpy` builds the port's state dataclasses
from a JAX `EnvState` or `TaskState` whose leaves were turned into numpy
arrays (`jax.tree.map(np.asarray, state)`, done by the caller). Attributes
are read by name, so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from mqe_tpu_torch.control.nets import MLP
from mqe_tpu_torch.utils.tree import tree_map


def mlp_from_numpy(params, device=None) -> MLP:
    """MLP from {w0, b0, w1, b1, ..., activation}: w_i is (out, in) as in the
    npz assets (the JAX package transposes it to (in, out) when loading)."""
    n = 0
    while f"w{n}" in params:
        n += 1
    if n == 0:
        raise ValueError("no w0 in the parameter dict")
    ws = [np.array(params[f"w{i}"], dtype=np.float32) for i in range(n)]
    bs = [np.array(params[f"b{i}"], dtype=np.float32) for i in range(n)]
    sizes = [ws[0].shape[1]] + [w.shape[0] for w in ws]
    mlp = MLP(sizes, str(params["activation"]))
    with torch.no_grad():
        for layer, w, b in zip(mlp.layers, ws, bs):
            layer.weight.copy_(torch.from_numpy(w))
            layer.bias.copy_(torch.from_numpy(b))
    return mlp.to(device) if device is not None else mlp


def _tensor(x, device):
    return torch.as_tensor(np.array(x), device=device)


def env_state_from_numpy(tree, device="cpu"):
    """Port EnvState / TaskState from a JAX one with numpy leaves."""
    from mqe_tpu_torch.envs.go1_env import EnvState
    from mqe_tpu_torch.envs.wrappers import TaskState
    from mqe_tpu_torch.physics.scene import ActorState, DomainRand, PhysState

    def actors(a):
        return ActorState(**{k: _tensor(getattr(a, k), device)
                             for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")})

    def env(s):
        kw = {}
        for name in EnvState.__dataclass_fields__:
            if name == "phys":
                kw[name] = PhysState(agents=actors(s.phys.agents), npcs=actors(s.phys.npcs))
            elif name == "dr":
                kw[name] = DomainRand(**{k: _tensor(getattr(s.dr, k), device)
                                         for k in DomainRand.__dataclass_fields__})
            else:
                kw[name] = _tensor(getattr(s, name), device)
        return EnvState(**kw)

    if hasattr(tree, "extra"):
        return TaskState(env=env(tree.env),
                         extra={k: _tensor(v, device) for k, v in tree.extra.items()})
    return env(tree)


def env_state_to(state, device):
    """The same state (any of the port's state dataclasses) on `device`."""
    return tree_map(lambda t: t.to(device), state)
