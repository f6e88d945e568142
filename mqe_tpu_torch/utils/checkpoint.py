"""State checkpoints: one .npz file per snapshot, keyed by path in the state.

Counterpart of `mqe_tpu/utils/checkpoint.py` for the port's own states (a
`learn.ppo.TrainState`: params, Adam state, the env's `TaskState`, the
`torch.Generator`, counters, return statistics and the episode
accumulator). Tensors, numbers and generators round-trip exactly, so a run
resumed from a checkpoint repeats the uninterrupted one bit for bit. The
JAX package's TrainState files hold their leaves by flatten index instead
("leaf_00000", ...); `utils.convert.params_from_jax_checkpoint` reads their
network params.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass, replace

import numpy as np
import torch

FORMAT = "mqe_tpu_torch/state-v1"


def _norm(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(prefix: str, tree, out: dict):
    """{path: numpy array} of tensors, numbers and generators in dataclass
    fields and dict values; None leaves nothing."""
    if tree is None:
        return out
    if is_dataclass(tree):
        for f in fields(tree):
            _flatten(f"{prefix}/{f.name}", getattr(tree, f.name), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif isinstance(tree, torch.Generator):
        out[prefix] = tree.get_state().numpy()
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:  # int, float, bool
        out[prefix] = np.asarray(tree)
    return out


def save_state(path: str, tree) -> str:
    """Save a state tree to one .npz; returns the file path."""
    arrs = _flatten("state", tree, {})
    arrs["format"] = np.asarray(FORMAT)
    path = _norm(path)
    with open(path, "wb") as f:
        np.savez(f, **arrs)
    return path


def _fill(prefix: str, template, data):
    if template is None:
        return None
    if is_dataclass(template):
        return replace(template, **{f.name: _fill(f"{prefix}/{f.name}", getattr(template, f.name), data)
                                    for f in fields(template)})
    if isinstance(template, dict):
        return {k: _fill(f"{prefix}/{k}", v, data) for k, v in template.items()}
    arr = data[prefix]
    if isinstance(template, torch.Generator):
        template.set_state(torch.from_numpy(np.array(arr)))
        return template
    if isinstance(template, torch.Tensor):
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape}, state {tuple(template.shape)}")
        return torch.as_tensor(np.array(arr), dtype=template.dtype, device=template.device)
    return type(template)(arr.item())


def restore_state(path: str, template):
    """Restore a state saved by `save_state` into `template`'s structure,
    dtypes and devices (the template's generator takes the saved state)."""
    with np.load(_norm(path)) as data:
        if "format" not in data.files or str(data["format"]) != FORMAT:
            raise ValueError(f"{path}: not a checkpoint of this package")
        keys = set(_flatten("state", template, {}))
        if keys != set(data.files) - {"format"}:
            missing = sorted(keys ^ (set(data.files) - {"format"}))
            raise ValueError(f"{path}: checkpoint and state differ in {missing[:8]}")
        return _fill("state", template, data)


def is_port_checkpoint(path: str) -> bool:
    """True for a file `save_state` wrote, False for the JAX package's."""
    with np.load(_norm(path)) as data:
        return "format" in data.files


def params_from_checkpoint(path: str, net) -> dict:
    """The network params {name: tensor} of `net`, in flax order, from a
    checkpoint of this package or of the JAX package, on `net`'s device."""
    from mqe_tpu_torch.learn.networks import flax_ordered_names
    from mqe_tpu_torch.utils.convert import params_from_jax_checkpoint

    if not is_port_checkpoint(path):
        return params_from_jax_checkpoint(path, net)
    dev = next(net.parameters()).device
    own = dict(net.named_parameters())
    out = {}
    with np.load(_norm(path)) as data:
        for name in flax_ordered_names(net):
            arr = data[f"state/params/{name}"]
            if tuple(arr.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                                 f"net {tuple(own[name].shape)}")
            out[name] = torch.as_tensor(np.array(arr), device=dev)
    return out
