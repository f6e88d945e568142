"""Count the elementwise arithmetic a plain PyTorch function performs.

Used for the compute bound of a kernel: the kernel does the work of its
plain version, so the float operations that version asks of aten, weighted
by the elements each call produces, are the operations the kernel must do.
Data movement (select, stack, cat, views, fills) is not counted; a clamp or a
where counts as one operation per element, as does a sine or a square root.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ARITHMETIC = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "pow", "sqrt",
    "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "exp",
    "expm1", "log", "tanh", "abs", "sign", "copysign", "remainder", "floor",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where", "lt",
    "gt", "le", "ge", "eq", "ne", "bitwise_and", "bitwise_or", "logical_and",
    "logical_or", "logical_not", "sum", "mm", "addmm", "bmm",
})


class OpCounter(TorchDispatchMode):
    """Context manager; `.ops` holds the count when it exits."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ARITHMETIC and isinstance(out, torch.Tensor):
            if name in ("mm", "addmm", "bmm"):
                k = args[-1].shape[-2]  # multiply-adds per output element
                self.ops += 2 * k * out.numel()
            elif name == "sum":
                self.ops += args[0].numel()
            else:
                self.ops += out.numel()
        return out


def count_ops(fn, *args, **kwargs) -> int:
    """Elementwise float operations that `fn(*args, **kwargs)` performs."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.ops
