"""The device trace of a profiled segment: every kernel's interval, the
union of them over the segment's wall (busy and idle), the time of each
kernel by name, the idle gaps by the stage the host was in, and each of the
program's kernels' roofline share from the launches' bytes and operations.
A frozen, extended copy of the reading in tools/profile_step_torch.py."""
from __future__ import annotations

from collections import defaultdict

from torch.autograd import DeviceType

from portbench import stats, yardstick
from portbench.record import LABEL


def base_name(name: str) -> str:
    """A kernel's name without its argument list (a kernel built by nvcc
    is recorded with its signature)."""
    return name.split("(", 1)[0].strip()[:200]


def read(prof) -> dict:
    """Kernel intervals (µs) and the benchmark's labels, from the
    profiler's raw events (building its event tree takes minutes for an
    update's records), and the segment's pb:window range."""
    kernels, labels, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        name = e.name()
        if name.startswith(LABEL):
            if e.device_type() != DeviceType.CUDA:
                if name == LABEL + "window":
                    window = (s, t)
                else:
                    labels.append((name[len(LABEL):], s, t))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            kernels.append((base_name(name), s, t))
    return dict(kernels=kernels, labels=labels, window=window)


def summarize(tr: dict) -> dict:
    """busy_s, window_s, idle share, kernel count and per-name time, and the
    idle gaps summed by the innermost stage the host was in at their start."""
    w0, w1 = tr["window"]
    iv = [(max(s, w0), min(e, w1)) for _, s, e in tr["kernels"] if e > w0 and s < w1]
    busy_us = stats.union_length(iv)
    by_name = defaultdict(float)
    count = defaultdict(int)
    for name, s, e in tr["kernels"]:
        by_name[name] += (e - s) * 1e-6
        count[name] += 1
    gaps = stats.gaps(iv, w0, w1)
    by_stage = defaultdict(float)
    labels = sorted(tr["labels"], key=lambda x: x[1])
    for gs, ge in gaps:
        inner, width = "outside the program's stages", None
        for name, s, e in labels:
            if s <= gs < e and (width is None or e - s < width):
                inner, width = name, e - s
        by_stage[inner] += (ge - gs) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return dict(busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
                idle_share=1.0 - busy_us / (w1 - w0), kernels=len(tr["kernels"]),
                kernel_s=dict(by_name), kernel_n=dict(count),
                breakdown={"device_ops": top(by_name), "idle_gaps": top(by_stage)})


def ops_per_launch(launch_kinds, models: dict, device="cpu") -> dict:
    """(kernel, model key, flags) -> (a, b): the float operations of a launch
    over B items, a + b B, counted by the frozen OpCounter over the
    reference's plain version at B = 2 and B = 4 on the CPU. `models`: model
    key -> the reference's BodyModel."""
    import torch

    from refsim.physics import soa

    out = {}
    for kernel, key, flags in launch_kinds:
        m = models[key]
        counts = []
        for B in (2, 4):
            g = torch.Generator().manual_seed(0)
            r = lambda *s: torch.randn(*s, generator=g) * 0.1  # noqa: E731
            quat = torch.nn.functional.normalize(r(B, 4) + torch.tensor([1.0, 0, 0, 0]), dim=-1)
            st = (r(B, 3), quat, r(B, 3), r(B, 3), r(B, m.nq), r(B, m.nq))
            ns = len(m.sph_tags)
            if kernel == "fused_step_kernel":
                payload, com, extra, root_free = flags
                fn = lambda: soa.step_actor(  # noqa: E731
                    m, *st, r(B, m.nq), r(B, ns, 3), r(B, ns, 3),
                    payload=r(B) if payload else None, com_shift=r(B, 3) if com else None,
                    extra_wrench=r(B, m.nb, 6) if extra else None, dt=0.0025,
                    root_free=root_free)
            elif kernel == "fk_spheres_kernel":
                fn = lambda: soa.fk_spheres(m, *st)  # noqa: E731
            else:
                fn = lambda: soa.fk_full(m, *st)  # noqa: E731
            counts.append(yardstick.count_ops(fn))
        b = (counts[1] - counts[0]) / 2.0
        out[(kernel, key, flags)] = (counts[0] - 2 * b, b)
    return out


def rooflines(summary: dict, launches: list, ops: dict) -> dict:
    """kernel -> dict(share %, bound s, device s, launches, records, bound_by):
    the sum of each launch's bound over the sum of its device time."""
    out = {}
    for kernel in sorted({k for k, *_ in launches}):
        mine = [x for x in launches if x[0] == kernel]
        bound, by = 0.0, defaultdict(float)
        for _, key, B, n_bytes, flags in mine:
            a, b = ops[(kernel, key, flags)]
            s, which = yardstick.bound_s(n_bytes, a + b * B)
            bound += s
            by[which] += s
        dev = summary["kernel_s"].get(kernel, 0.0)
        out[kernel] = dict(share=100.0 * bound / dev if dev > 0 else None, bound_s=bound,
                           device_s=dev, launches=len(mine),
                           records=summary["kernel_n"].get(kernel, 0),
                           bound_by=max(by, key=by.get) if by else None)
    return out
