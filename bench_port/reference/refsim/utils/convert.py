"""Weights and state carried across from the JAX package, through numpy.

`mlp_from_numpy` builds the port's MLP from a parameter dict in the layout of
the npz assets; `env_state_from_numpy` builds the port's state dataclasses
from a JAX `EnvState`, `TaskState` or `LocoTaskState` whose leaves were
turned into numpy arrays (`jax.tree.map(np.asarray, state)`, done by the
caller). Attributes are read by name, so this module needs no JAX. The
training networks come across from flax params (`actor_critic_from_numpy`,
`mat_from_numpy`) or from the JAX package's TrainState files
(`params_from_jax_checkpoint`); the walk-these-ways body MLP from the JAX
package's `mlp_apply` params (`wtw_body_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from refsim.control.nets import MLP
from refsim.utils.tree import tree_map


def mlp_from_numpy(params, device="cuda") -> MLP:
    """MLP on `device` from {w0, b0, w1, b1, ..., activation}: w_i is (out, in)
    as in the npz assets (the JAX package transposes it to (in, out) when
    loading)."""
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
    return mlp.to(device)


def wtw_body_from_numpy(params, device="cuda"):
    """`WalkTheseWaysBody` on `device` from the JAX package's `mlp_apply`
    params: {"w": [(in, out) kernels], "b": [biases], "act": name}."""
    from refsim.control.nets import WalkTheseWaysBody

    flat = {"activation": str(params["act"])}
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        flat[f"w{i}"], flat[f"b{i}"] = np.asarray(w).T, np.asarray(b)
    return WalkTheseWaysBody(mlp_from_numpy(flat, device=device))


def _tensor(x, device):
    return torch.as_tensor(np.array(x), device=device)


def env_state_from_numpy(tree, device="cuda"):
    """Port EnvState / TaskState / LocoTaskState on `device` from a JAX one
    with numpy leaves."""
    from refsim.envs.go1_env import EnvState
    from refsim.envs.wrappers import TaskState
    from refsim.physics.scene import ActorState, DomainRand, PhysState

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

    if hasattr(tree, "cmd_scale"):  # a LocomotionEnv state
        from refsim.learn.locomotion_env import LocoTaskState

        return LocoTaskState(env=env(tree.env), extra={
            k: _tensor(v, device) for k, v in tree.extra.items()}, **{
            k: _tensor(getattr(tree, k), device)
            for k in LocoTaskState.__dataclass_fields__ if k not in ("env", "extra")})
    if hasattr(tree, "env"):  # a TaskState; an empty `extra` may have left no trace
        return TaskState(env=env(tree.env), extra={
            k: _tensor(v, device) for k, v in getattr(tree, "extra", {}).items()})
    return env(tree)


def env_state_to(state, device):
    """The same state (any of the port's state dataclasses) on `device`."""
    return tree_map(lambda t: t.to(device), state)


def _load_flax(net, params, device):
    """`net` on `device` with every parameter taken from flax `params`
    ({"params": {...}} with numpy leaves), shapes checked."""
    from refsim.learn.networks import flax_path, from_flax_leaf

    tree = params["params"]
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = tree
            for k in flax_path(net, name):
                leaf = leaf[k]
            t = from_flax_leaf(net, name, np.asarray(leaf))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax leaf gives {tuple(t.shape)}, net has {tuple(p.shape)}")
            p.copy_(t)
    return net.to(device)


def _dense_outs(mlp):
    """Output widths of an MLP's flax params, Dense_0 first."""
    return [mlp[f"Dense_{i}"]["kernel"].shape[1] for i in range(len(mlp))]


def actor_critic_from_numpy(params, recurrent=False, device="cuda"):
    """The port's `ActorCritic` (or `RecurrentActorCritic`) on `device` from
    flax params {"params": {...}} with numpy leaves; widths read off them."""
    from refsim.learn.networks import ActorCritic, RecurrentActorCritic

    p = params["params"]
    actor = _dense_outs(p["actor"])
    if recurrent:
        net = RecurrentActorCritic(
            obs_dim=p["embed"]["Dense_0"]["kernel"].shape[0], action_dim=actor[-1],
            embed=tuple(_dense_outs(p["embed"])), rnn_size=p["gru"]["hn"]["kernel"].shape[0],
            head=tuple(actor[:-1]))
    else:
        net = ActorCritic(obs_dim=p["actor"]["Dense_0"]["kernel"].shape[0],
                          action_dim=actor[-1], hidden=tuple(actor[:-1]))
    return _load_flax(net, params, device)


def mat_from_numpy(params, enc_blocks=2, device="cuda"):
    """The port's `MATNetwork` on `device` from flax params; widths, heads and
    decoder depth read off them (the encoder has `enc_blocks` blocks)."""
    from refsim.learn.mat import MATNetwork

    p = params["params"]
    blocks = sum(k.startswith("SelfAttnBlock_") for k in p)
    query = p["SelfAttnBlock_0"]["MultiHeadDotProductAttention_0"]["query"]["kernel"]
    net = MATNetwork(obs_dim=p["Dense_0"]["kernel"].shape[0],
                     action_dim=p["Dense_4"]["kernel"].shape[1],
                     embed=p["Dense_0"]["kernel"].shape[1], enc_blocks=enc_blocks,
                     dec_blocks=blocks - enc_blocks, heads=query.shape[1])
    return _load_flax(net, params, device)


def params_from_jax_checkpoint(path, net, with_optimizer=False):
    """The params {name: tensor} of `net` (flax order, on `net`'s device)
    from a JAX package TrainState file (`mqe_tpu/utils/checkpoint.py`: leaves
    "leaf_00000", ... in `jax.tree_util` flatten order, `TrainState.params`
    first, each dict's keys sorted, a Dense as bias then kernel). Every
    shape is checked. With `with_optimizer`, also the Adam state that follows
    the params (count, mu, nu) as (count tensor, mu dict, nu dict)."""
    from refsim.learn.networks import flax_ordered_names, from_flax_leaf

    names = flax_ordered_names(net)
    own = dict(net.named_parameters())
    dev = own[names[0]].device
    n = len(names)
    path = path if path.endswith(".npz") else path + ".npz"
    with np.load(path) as data:
        def leaves(start):
            out = {}
            for i, name in enumerate(names):
                t = from_flax_leaf(net, name, data[f"leaf_{start + i:05d}"])
                if tuple(t.shape) != tuple(own[name].shape):
                    raise ValueError(f"leaf {start + i} ({name}): {tuple(t.shape)} in the "
                                     f"checkpoint, {tuple(own[name].shape)} in the net")
                out[name] = t.to(dev)
            return out

        params = leaves(0)
        if not with_optimizer:
            return params
        count = torch.as_tensor(data[f"leaf_{n:05d}"], dtype=torch.int32, device=dev)
        if count.ndim != 0:
            raise ValueError(f"leaf {n}: expected the Adam count, got shape {tuple(count.shape)}")
        return params, (count, leaves(n + 1), leaves(2 * n + 1))
