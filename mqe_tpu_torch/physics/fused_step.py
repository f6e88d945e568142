"""The fused dynamics substep and the FK stages as hand-written CUDA kernels.

`step_actor_kernel` has the signature of `step_actor_pallas`
(mqe_tpu/physics/pallas_step.py), the TPU kernel it replaces, and returns what
`soa.step_actor` returns; `fk_spheres_kernel` and `fk_full_kernel` return what
`soa.fk_spheres` and `soa.fk_full` return. All three are entry points of
csrc/fused_step.cu (one lane per body, see its header); the FK launches'
geometry, robots a block, is chosen here (`fk_robots_per_block`). For CUDA
tensors a wrapper launches its kernel on PyTorch's current stream, reading the (B, k) state tensors in place and writing
outputs it allocates; for CPU tensors it runs the plain version; on any other
device it raises. Inputs are checked on every device, so the CPU tests hold
the callers to what the kernels take: float32, contiguous, the model's shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mqe_tpu_torch.physics import soa
from mqe_tpu_torch.physics.model import MAX_NB, MAX_NS, TABLE_SIZE, BodyModel, model_tables
from mqe_tpu_torch.utils.build import load_library

_c_int, _c_float, _c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


@functools.cache
def library():
    """The built kernel library with its argument types set (built at first use)."""
    built = load_library("fused_step")
    lib = built.lib
    lib.fused_step_table_size.argtypes = []
    lib.fused_step_table_size.restype = _c_int
    lib.fused_step_max_sizes.argtypes = [ctypes.POINTER(_c_int), ctypes.POINTER(_c_int)]
    lib.fused_step_max_sizes.restype = _c_int
    lib.fused_step_launch.argtypes = (
        [_c_ptr] * 12                                # pos .. extra (inputs)
        + [_c_ptr] * 6                               # pos_o .. qd_o
        + [_c_ptr]                                   # tables
        + [_c_int] * 5                               # B, nb, nq, ns, lanes_log2
        + [_c_int, _c_int, _c_float, _c_ptr]         # root_free, model_root_free, dt, stream
    )
    lib.fused_step_launch.restype = _c_int
    lib.fk_spheres_launch.argtypes = (
        [_c_ptr] * 6 + [_c_ptr] * 2 + [_c_ptr]       # pos .. qd, sph_x, sph_v, tables
        + [_c_int] * 6 + [_c_ptr]                    # B, nb, nq, ns, lanes_log2, rpb, stream
    )
    lib.fk_spheres_launch.restype = _c_int
    lib.fk_full_launch.argtypes = (
        [_c_ptr] * 6 + [_c_ptr] * 5 + [_c_ptr]       # pos .. qd, Rw .. sph_v, tables
        + [_c_int] * 6 + [_c_ptr]                    # B, nb, nq, ns, lanes_log2, rpb, stream
    )
    lib.fk_full_launch.restype = _c_int
    lib.fk_shared_bytes.argtypes = [_c_int, _c_int]
    lib.fk_shared_bytes.restype = _c_int
    nb, ns = _c_int(), _c_int()
    lib.fused_step_max_sizes(ctypes.byref(nb), ctypes.byref(ns))
    if (lib.fused_step_table_size(), nb.value, ns.value) != (TABLE_SIZE, MAX_NB, MAX_NS):
        raise RuntimeError(
            "csrc/fused_step.cu and physics/model.py disagree on the model "
            f"table: kernel ({lib.fused_step_table_size()}, {nb.value}, {ns.value}) "
            f"vs python ({TABLE_SIZE}, {MAX_NB}, {MAX_NS})"
        )
    if lib.fk_shared_bytes(8, MAX_NS) != fk_shared_bytes(8, MAX_NS):
        raise RuntimeError(
            "csrc/fused_step.cu and physics/fused_step.py disagree on an FK block's "
            f"shared memory: {lib.fk_shared_bytes(8, MAX_NS)} vs "
            f"{fk_shared_bytes(8, MAX_NS)} bytes"
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


def lanes_log2(model: BodyModel) -> int:
    """log2 of the lanes a robot gets: the smallest power of two >= nb."""
    return (model.nb - 1).bit_length()


THREADS = 128             # threads a block (csrc/fused_step.cu THREADS)
FK_FIELDS = 24            # floats of a body's slot in an FK block (FK_FIELDS there)
SHARED_LIMIT = 48 * 1024  # a block's shared memory without opting in to more
# blocks an FK launch keeps where B allows: about four on each of the H100's
# 132 SMs (tools/sweep_fk_geometry.py: of 1 to 128 robots a block, 8 gave
# the least time to both NPC launches at B = 4096)
FK_MIN_BLOCKS = 512


def fk_shared_bytes(robots_per_block: int, ns: int) -> int:
    """Shared memory of an FK block: the slots, and its spheres' staged x, v."""
    return (FK_FIELDS * THREADS + 6 * robots_per_block * ns) * 4


@functools.lru_cache(maxsize=None)
def fk_robots_per_block(lanes_log2: int, ns: int, B: int) -> int:
    """The robots each block of an FK launch takes, for B robots of
    2**lanes_log2 lanes and ns spheres; the launch has ceil(B / robots)
    blocks of THREADS threads, the last with fewer robots.

    As many robots a block as its threads hold and its shared memory takes
    (full blocks: go1's 8 robots of 16 lanes), but no more than keeps the
    grid at FK_MIN_BLOCKS blocks where B allows: an NPC launch of 4096
    robots of one or two lanes would fill only 32 or 64 blocks otherwise
    (it takes 512 blocks of 8 robots).
    """
    robots = THREADS >> lanes_log2
    while robots > 1 and fk_shared_bytes(robots, ns) > SHARED_LIMIT:
        robots -= 1
    return max(1, min(robots, B // FK_MIN_BLOCKS))


def _check(fn: str, expect: dict) -> torch.device:
    """Raise unless every given tensor is float32, contiguous, of its expected
    shape and on the device of the first, a CPU or CUDA device."""
    device = next(iter(expect.values()))[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {device}")
    for name, (t, shape) in expect.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes float32")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, pos on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    return device


def _state_shapes(model, pos, quat, lin_vel, ang_vel, q, qd):
    if pos.dim() != 2:
        raise ValueError(f"pos has shape {tuple(pos.shape)}, expected (B, 3)")
    B, nq = pos.shape[0], model.nq
    return B, {
        "pos": (pos, (B, 3)), "quat": (quat, (B, 4)), "lin_vel": (lin_vel, (B, 3)),
        "ang_vel": (ang_vel, (B, 3)), "q": (q, (B, nq)), "qd": (qd, (B, nq)),
    }


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, fn: str):
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {rc}")


def launch_step(model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                payload, com_shift, extra_wrench, out, dt, root_free):
    """Launch the step kernel on checked CUDA tensors into `out`, the six
    output tensors; counts the launch."""
    B, ns = pos.shape[0], len(model.sph_tags)
    rc = library().lib.fused_step_launch(
        pos.data_ptr(), quat.data_ptr(), lin_vel.data_ptr(), ang_vel.data_ptr(),
        q.data_ptr(), qd.data_ptr(), tau.data_ptr(), sph_force.data_ptr(), sph_x.data_ptr(),
        _ptr(payload), _ptr(com_shift), _ptr(extra_wrench),
        *(t.data_ptr() for t in out),
        tables_for(model, pos.device).data_ptr(),
        B, model.nb, model.nq, ns, lanes_log2(model),
        int(root_free), int(model.root_free), float(dt),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    _raise_on(rc, "fused_step")
    step_actor_kernel.launches += 1


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
    B, expect = _state_shapes(model, pos, quat, lin_vel, ang_vel, q, qd)
    ns, nq = len(model.sph_tags), model.nq
    expect.update({
        "tau": (tau, (B, nq)), "sph_force": (sph_force, (B, ns, 3)),
        "sph_x": (sph_x, (B, ns, 3)), "payload": (payload, (B,)),
        "com_shift": (com_shift, (B, 3)), "extra_wrench": (extra_wrench, (B, model.nb, 6)),
    })
    device = _check("step_actor_kernel", expect)
    if device.type == "cpu":
        return soa.step_actor(
            model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
            payload=payload, com_shift=com_shift, extra_wrench=extra_wrench,
            dt=dt, root_free=root_free,
        )
    if root_free is None:
        root_free = model.root_free
    out = tuple(torch.empty((B, k), dtype=torch.float32, device=device)
                for k in (3, 4, 3, 3, nq, nq))
    launch_step(model, pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                payload, com_shift, extra_wrench, out, dt, root_free)
    return out


step_actor_kernel.launches = 0  # kernel launches since the last reset to 0


def _fk_launch_args(model, pos, robots_per_block):
    """The trailing arguments of both FK launches: tables, sizes, geometry, stream."""
    B, ns, ll = pos.shape[0], len(model.sph_tags), lanes_log2(model)
    if robots_per_block is None:
        robots_per_block = fk_robots_per_block(ll, ns, B)
    return (tables_for(model, pos.device).data_ptr(), B, model.nb, model.nq, ns, ll,
            robots_per_block, torch.cuda.current_stream(pos.device).cuda_stream)


def launch_fk(model, pos, quat, lin_vel, ang_vel, q, qd, sph_x, sph_v, robots_per_block=None):
    """Launch the sphere-FK kernel on checked CUDA tensors into sph_x, sph_v,
    at `fk_robots_per_block`'s robots a block unless given; counts the
    launch."""
    rc = library().lib.fk_spheres_launch(
        pos.data_ptr(), quat.data_ptr(), lin_vel.data_ptr(), ang_vel.data_ptr(),
        q.data_ptr(), qd.data_ptr(), sph_x.data_ptr(), sph_v.data_ptr(),
        *_fk_launch_args(model, pos, robots_per_block),
    )
    _raise_on(rc, "fk_spheres")
    fk_spheres_kernel.launches += 1


def fk_spheres_kernel(model: BodyModel, pos, quat, lin_vel, ang_vel, q, qd):
    """World positions and velocities of the collision spheres, (B, ns, 3)
    each, as `soa.fk_spheres` returns them, for a flat (B, k) batch."""
    B, expect = _state_shapes(model, pos, quat, lin_vel, ang_vel, q, qd)
    device = _check("fk_spheres_kernel", expect)
    if device.type == "cpu":
        return soa.fk_spheres(model, pos, quat, lin_vel, ang_vel, q, qd)
    ns = len(model.sph_tags)
    sph_x = torch.empty((B, ns, 3), dtype=torch.float32, device=device)
    sph_v = torch.empty((B, ns, 3), dtype=torch.float32, device=device)
    launch_fk(model, pos, quat, lin_vel, ang_vel, q, qd, sph_x, sph_v)
    return sph_x, sph_v


fk_spheres_kernel.launches = 0  # kernel launches since the last reset to 0


def launch_fk_full(model, pos, quat, lin_vel, ang_vel, q, qd, out, robots_per_block=None):
    """Launch the full-FK kernel on checked CUDA tensors into `out`, the five
    output tensors, at `fk_robots_per_block`'s robots a block unless given;
    counts the launch."""
    rc = library().lib.fk_full_launch(
        pos.data_ptr(), quat.data_ptr(), lin_vel.data_ptr(), ang_vel.data_ptr(),
        q.data_ptr(), qd.data_ptr(), *(t.data_ptr() for t in out),
        *_fk_launch_args(model, pos, robots_per_block),
    )
    _raise_on(rc, "fk_full")
    fk_full_kernel.launches += 1


def fk_full_kernel(model: BodyModel, pos, quat, lin_vel, ang_vel, q, qd):
    """Each body's world pose Rw (B, nb, 3, 3), pw (B, nb, 3) and world velocity
    vw (B, nb, 6) in (angular, linear) order, and the spheres' sph_x, sph_v
    (B, ns, 3), as `soa.fk_full` returns them, for a flat (B, k) batch."""
    B, expect = _state_shapes(model, pos, quat, lin_vel, ang_vel, q, qd)
    device = _check("fk_full_kernel", expect)
    if device.type == "cpu":
        return soa.fk_full(model, pos, quat, lin_vel, ang_vel, q, qd)
    nb, ns = model.nb, len(model.sph_tags)
    out = tuple(torch.empty(shape, dtype=torch.float32, device=device)
                for shape in ((B, nb, 3, 3), (B, nb, 3), (B, nb, 6), (B, ns, 3), (B, ns, 3)))
    launch_fk_full(model, pos, quat, lin_vel, ang_vel, q, qd, out)
    return out


fk_full_kernel.launches = 0  # kernel launches since the last reset to 0
