"""Policy/value networks of the PPO-family trainers, as `nn.Module`s.

Counterpart of `mqe_tpu/learn/networks.py`. Submodules carry the names flax
gives them (`actor.Dense_0`, `gru.ir`, ...), so a parameter's name maps to its
flax path by rule (`flax_path`): "." becomes "/", a Linear's `weight` is the
Dense `kernel` transposed ((out, in) here, (in, out) in flax), a LayerNorm's
`weight` is its `scale`. New modules are initialised as flax initialises
them: the MLPs' kernels orthogonal(sqrt 2), every bias zero, `log_std` -0.5.

The GRU cell is written out rather than taken from `nn.GRUCell`: flax's
`GRUCell` has biases on `ir`, `iz`, `in` and `hn` only, and
`nn.GRUCell.bias_hh` would train two more bias vectors than flax has (the
update differs under Adam even where the function is the same). It computes
r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
n = tanh(in(x) + r * hn(h)) and h' = (1 - z) * n + z * h, as flax 0.12.3 does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_F32_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default kernel init: variance_scaling(1, fan_in, truncated normal)."""
    std = math.sqrt(1.0 / weight.shape[1]) / _F32_TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def dense(in_dim: int, out_dim: int, scale: float | None = None, bias: bool = True) -> nn.Linear:
    """A Linear initialised as a flax Dense: orthogonal(scale) when `scale` is
    given, else lecun normal; zero bias."""
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    with torch.no_grad():
        if scale is None:
            lecun_normal_(layer.weight)
        else:
            nn.init.orthogonal_(layer.weight, gain=scale)
        if bias:
            layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Dense layers `Dense_0 ... Dense_{n-1}` with ELU between them, none after
    the last; kernels orthogonal(sqrt 2)."""

    def __init__(self, in_dim: int, features):
        super().__init__()
        self.n = len(features)
        for i, (a, b) in enumerate(zip((in_dim, *features[:-1]), features)):
            self.add_module(f"Dense_{i}", dense(a, b, scale=math.sqrt(2.0)))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1:
                x = F.elu(x)
        return x


def _log_std(action_dim: int) -> nn.Parameter:
    return nn.Parameter(torch.full((action_dim,), -0.5))


class ActorCritic(nn.Module):
    """Shared-parameter actor-critic over per-agent observations."""

    recurrent = False

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 128, 64)):
        super().__init__()
        self.actor = MLP(obs_dim, (*hidden, action_dim))
        self.critic = MLP(obs_dim, (*hidden, 1))
        self.log_std = _log_std(action_dim)

    def forward(self, obs):
        """obs (..., obs_dim) -> mean (..., act), log_std (act,), value (...)."""
        return self.actor(obs), self.log_std, self.critic(obs)[..., 0]


class GRUCell(nn.Module):
    """flax's `GRUCell`, written out: input denses `ir`, `iz`, `in` with bias,
    recurrent `hr`, `hz` without and `hn` with; input kernels lecun normal,
    recurrent kernels orthogonal."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for g in ("ir", "iz", "in"):
            self.add_module(g, dense(in_dim, features))
        for g in ("hr", "hz", "hn"):
            self.add_module(g, dense(features, features, scale=1.0, bias=g == "hn"))

    def forward(self, h, x):
        g = lambda name, v: getattr(self, name)(v)  # noqa: E731
        r = torch.sigmoid(g("ir", x) + g("hr", h))
        z = torch.sigmoid(g("iz", x) + g("hz", h))
        n = torch.tanh(g("in", x) + r * g("hn", h))
        return (1.0 - z) * n + z * h


class RecurrentActorCritic(nn.Module):
    """GRU actor-critic: embed MLP, ELU, GRU, actor and critic heads. Called
    with the previous hidden state, returns the next one. PPO trains it with
    the stored-state scheme (hidden states recorded during the rollout,
    one-step gradients)."""

    recurrent = True

    def __init__(self, obs_dim: int, action_dim: int, embed=(256,), rnn_size: int = 128,
                 head=(64,)):
        super().__init__()
        self.rnn_size = rnn_size
        self.embed = MLP(obs_dim, tuple(embed))
        self.gru = GRUCell(embed[-1], rnn_size)
        self.actor = MLP(rnn_size, (*head, action_dim))
        self.critic = MLP(rnn_size, (*head, 1))
        self.log_std = _log_std(action_dim)

    def forward(self, obs, h):
        """-> mean, log_std, value, the next hidden state."""
        x = F.elu(self.embed(obs))
        h_new = self.gru(h, x)
        return self.actor(h_new), self.log_std, self.critic(h_new)[..., 0], h_new

    def initial_state(self, batch_shape, device=None):
        return torch.zeros((*batch_shape, self.rnn_size), device=device)


def gaussian_logp(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi))).sum(-1)


def flax_path(net: nn.Module, name: str) -> tuple:
    """The flax path of the parameter `name` of `net` ("params" excluded)."""
    *mod, leaf = name.split(".")
    if leaf == "weight":
        owner = net.get_submodule(".".join(mod))
        leaf = "scale" if isinstance(owner, nn.LayerNorm) else "kernel"
    return (*mod, leaf)


def flax_ordered_names(net: nn.Module) -> list:
    """The parameter names of `net` in the order of flax's tree flatten (dict
    keys sorted at every level)."""
    return sorted((n for n, _ in net.named_parameters()), key=lambda n: flax_path(net, n))


def from_flax_leaf(net: nn.Module, name: str, leaf):
    """A flax leaf as the tensor the parameter `name` holds: a Dense kernel
    (in, out) transposed; an attention DenseGeneral kernel, (in, heads,
    head_dim) for query/key/value and (heads, head_dim, out) for out, as the
    (out, in) weight of the Linear over the flattened heads; its bias flat."""
    t = torch.from_numpy(np.array(leaf, dtype=np.float32))
    path = flax_path(net, name)
    if path[-1] == "kernel":
        if t.ndim == 3:
            t = t.reshape(-1, t.shape[-1]) if path[-2] == "out" else t.reshape(t.shape[0], -1)
        t = t.T
    elif path[-1] == "bias":
        t = t.reshape(-1)
    return t.contiguous()


def to_flax_leaf(net: nn.Module, name: str, t: torch.Tensor) -> np.ndarray:
    """The parameter `name` as its flax leaf, for the MLP networks: a Dense
    kernel as (in, out); every other leaf as it is."""
    a = t.detach().cpu().numpy()
    if flax_path(net, name)[-1] == "kernel":
        if a.ndim != 2:
            raise ValueError(f"{name}: only 2-D Dense kernels are written, got {a.shape}")
        a = a.T
    return np.ascontiguousarray(a)
