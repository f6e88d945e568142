"""The yardstick: the card's published peaks and the bytes and operations
of a kernel's work. Frozen copies of `chip_smoke.py`'s peaks, `nbytes` and
`bound` and of `mqe_tpu_torch/utils/opcount.py`'s `OpCounter`, kept here so
that a change to the program cannot change how it is measured.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM3 bandwidth and float32
# outside the tensor cores (the kernels' arithmetic is float32 CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_s(n_bytes: float, ops: float) -> tuple:
    """(seconds, 'bytes' or 'operations'): the least time the card takes for
    work that moves n_bytes (each input read once, each output written once)
    and does `ops` float operations."""
    b, o = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return (b, "bytes") if b >= o else (o, "operations")


ARITHMETIC = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "pow", "sqrt",
    "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "exp",
    "expm1", "log", "tanh", "abs", "sign", "copysign", "remainder", "floor",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where", "lt",
    "gt", "le", "ge", "eq", "ne", "bitwise_and", "bitwise_or", "logical_and",
    "logical_or", "logical_not", "sum", "mm", "addmm", "bmm",
})


class OpCounter(TorchDispatchMode):
    """Context manager; `.ops` holds the elementwise float operations that
    the plain PyTorch code run inside it asks of aten, weighted by the
    elements each call produces (a matrix product 2k a output element).
    Data movement (select, stack, cat, views, fills) is not counted."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ARITHMETIC and isinstance(out, torch.Tensor):
            if name in ("mm", "addmm", "bmm"):
                k = args[-1].shape[-2]
                self.ops += 2 * k * out.numel()
            elif name == "sum":
                self.ops += args[0].numel()
            else:
                self.ops += out.numel()
        return out


def count_ops(fn, *args, **kwargs) -> int:
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.ops
