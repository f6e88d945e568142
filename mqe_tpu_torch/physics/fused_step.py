"""The fused dynamics substep (FK + ABA + integrate) as one CUDA kernel.

`step_actor_kernel` has the signature of `step_actor_pallas`
(mqe_tpu/physics/pallas_step.py), the TPU kernel it replaces, and returns what
`soa.step_actor` returns. For CUDA tensors it packs the inputs channel-major
into one (C_in, B) float32 buffer, launches csrc/fused_step.cu (one thread per
robot, 128 a block) on PyTorch's current stream and unpacks the (C_out, B)
result. For CPU tensors it runs the plain version, `soa.step_actor`; on any
other device it raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mqe_tpu_torch.physics import soa
from mqe_tpu_torch.physics.model import MAX_NB, MAX_NS, TABLE_SIZE, BodyModel, model_tables
from mqe_tpu_torch.utils.build import load_library

_c_int, _c_float, _c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def channel_count(model: BodyModel, has_pay: bool, has_cs: bool, has_extra: bool) -> int:
    """Input channels of the kernel (pallas_step._channel_count)."""
    nq, ns, nb = model.nq, len(model.sph_tags), model.nb
    return 13 + 3 * nq + 6 * ns + int(has_pay) + 3 * int(has_cs) + 6 * nb * int(has_extra)


def out_channel_count(model: BodyModel) -> int:
    return 13 + 2 * model.nq


@functools.cache
def library():
    """The built kernel library with its argument types set (built at first use)."""
    built = load_library("fused_step")
    lib = built.lib
    lib.fused_step_table_size.argtypes = []
    lib.fused_step_table_size.restype = _c_int
    lib.fused_step_max_sizes.argtypes = [ctypes.POINTER(_c_int), ctypes.POINTER(_c_int)]
    lib.fused_step_max_sizes.restype = _c_int
    lib.fused_step_launch.argtypes = [
        _c_ptr, _c_ptr, _c_ptr,                      # X, Y, tables
        _c_int, _c_int, _c_int, _c_int,              # B, nb, nq, ns
        _c_int, _c_int, _c_int, _c_int, _c_int,      # has_pay, has_cs, has_extra, root_free, model_root_free
        _c_float, _c_ptr,                            # dt, stream
    ]
    lib.fused_step_launch.restype = _c_int
    nb, ns = _c_int(), _c_int()
    lib.fused_step_max_sizes(ctypes.byref(nb), ctypes.byref(ns))
    if (lib.fused_step_table_size(), nb.value, ns.value) != (TABLE_SIZE, MAX_NB, MAX_NS):
        raise RuntimeError(
            "csrc/fused_step.cu and physics/model.py disagree on the model "
            f"table: kernel ({lib.fused_step_table_size()}, {nb.value}, {ns.value}) "
            f"vs python ({TABLE_SIZE}, {MAX_NB}, {MAX_NS})"
        )
    return built


_TABLES: dict = {}  # (id(model), device) -> (model, table tensor)


def tables_for(model: BodyModel, device) -> torch.Tensor:
    """The model's float32 table on `device`, built once per (model, device)."""
    key = (id(model), str(torch.device(device)))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not model:
        table = torch.as_tensor(model_tables(model), device=device).contiguous()
        hit = (model, table)
        _TABLES[key] = hit
    return hit[1]


def pack_inputs(model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                payload=None, com_shift=None, extra_wrench=None) -> torch.Tensor:
    """Channel-major (C_in, B) float32 buffer, as pallas_step.py packs it."""
    B = pos.shape[0]
    nq, ns, nb = model.nq, len(model.sph_tags), model.nb
    expect = {
        "pos": (pos, (B, 3)), "quat": (quat, (B, 4)), "lin_vel": (lin_vel, (B, 3)),
        "ang_vel": (ang_vel, (B, 3)), "q": (q, (B, nq)), "qd": (qd, (B, nq)),
        "tau": (tau, (B, nq)), "sph_force": (sph_force, (B, ns, 3)),
        "sph_x": (sph_x, (B, ns, 3)),
    }
    if payload is not None:
        expect["payload"] = (payload, (B,))
    if com_shift is not None:
        expect["com_shift"] = (com_shift, (B, 3))
    if extra_wrench is not None:
        expect["extra_wrench"] = (extra_wrench, (B, nb, 6))
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
    chans = [
        pos.T, quat.T, lin_vel.T, ang_vel.T, q.T, qd.T, tau.T,
        sph_x.reshape(B, ns * 3).T, sph_force.reshape(B, ns * 3).T,
    ]
    if payload is not None:
        chans.append(payload[None, :])
    if com_shift is not None:
        chans.append(com_shift.T)
    if extra_wrench is not None:
        chans.append(extra_wrench.reshape(B, nb * 6).T)
    return torch.cat(chans, dim=0).contiguous()


def launch(model: BodyModel, X: torch.Tensor, has_pay: bool, has_cs: bool,
           has_extra: bool, dt: float, root_free: bool) -> torch.Tensor:
    """Run the kernel on a packed (C_in, B) buffer; returns (C_out, B)."""
    C, B = X.shape
    if X.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {X.device}")
    if X.dtype != torch.float32 or not X.is_contiguous():
        raise ValueError("X must be a contiguous float32 (C_in, B) tensor")
    if C != channel_count(model, has_pay, has_cs, has_extra):
        raise ValueError(f"X has {C} channels, expected "
                         f"{channel_count(model, has_pay, has_cs, has_extra)}")
    if B >= 2**31 // max(C, 1):
        raise ValueError(f"batch {B} too large for 32-bit launch arithmetic")
    lib = library().lib
    table = tables_for(model, X.device)
    Y = torch.empty((out_channel_count(model), B), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.fused_step_launch(
        X.data_ptr(), Y.data_ptr(), table.data_ptr(),
        B, model.nb, model.nq, len(model.sph_tags),
        int(has_pay), int(has_cs), int(has_extra), int(root_free), int(model.root_free),
        float(dt), stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed: cudaError {rc}")
    step_actor_kernel.launches += 1
    return Y


def step_actor_kernel(
    model: BodyModel,
    pos, quat, lin_vel, ang_vel, q, qd,       # (B, k) flat-batch state
    tau,                                      # (B, nq)
    sph_force, sph_x,                         # (B, ns, 3) world
    payload=None, com_shift=None,             # (B,), (B, 3) trunk DR
    extra_wrench=None,                        # (B, nb, 6) world (NPC coupling)
    dt=0.0025,
    root_free=None,
):
    """One dynamics + integration substep for a flat batch of one model.

    Returns the six new state tensors (B, k), as `soa.step_actor` does.
    """
    if pos.device.type == "cpu":
        return soa.step_actor(
            model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
            payload=payload, com_shift=com_shift, extra_wrench=extra_wrench,
            dt=dt, root_free=root_free,
        )
    if pos.device.type != "cuda":
        raise ValueError(f"step_actor_kernel: no kernel for device {pos.device}")
    if root_free is None:
        root_free = model.root_free
    B, nq = pos.shape[0], model.nq
    X = pack_inputs(model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                    payload, com_shift, extra_wrench)
    Y = launch(model, X, payload is not None, com_shift is not None,
               extra_wrench is not None, dt, root_free)
    out = [Y[0:3].T, Y[3:7].T, Y[7:10].T, Y[10:13].T]
    if nq:
        out += [Y[13:13 + nq].T, Y[13 + nq:13 + 2 * nq].T]
    else:
        empty = pos.new_zeros((B, 0))
        out += [empty, empty]
    return tuple(out)


step_actor_kernel.launches = 0  # kernel launches since the last reset to 0
