"""What the benchmark wraps around the program's functions, from its own
files: named draws recorded for the reference, synchronized stage timers,
profiler labels, and the kernel wrappers' launches with their bytes. Each
is installed for one segment and taken off after it, so the measured window
runs the program as it stands."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import fields, is_dataclass

import numpy as np
import torch

from portbench.yardstick import nbytes

DRAW_METHODS = ("uniform", "normal", "integers", "permutation")


_MISSING = object()


def clone_tree(x):
    """A copy of what the program handed over (its dataclasses, dicts,
    lists, tuples), every tensor and array cloned: what is recorded for the
    reference stays as it was if the program later updates it in place."""
    if is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: clone_tree(getattr(x, f.name)) for f in fields(x)})
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


@contextmanager
def patched(pairs):
    """Set each (owner, attr, new) for the duration; restore after. An owner
    is a class, a module or an instance; an attribute it did not hold itself
    (an instance's method) is removed again."""
    saved = [(owner, attr, vars(owner).get(attr, _MISSING)) for owner, attr, _ in pairs]
    try:
        for owner, attr, new in pairs:
            setattr(owner, attr, new)
        yield
    finally:
        for owner, attr, own in reversed(saved):
            if own is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, own)


class DrawRecorder:
    """Records the named draws the program's `Draws` class makes from its
    generator (given draws are not recorded), each under the tag current
    when it is drawn, as a list in the order drawn (a permutation is drawn
    once an epoch). `keep(tag, name)` says which to hold."""

    def __init__(self, draws_cls, keep=lambda tag, name: True):
        self.cls = draws_cls
        self.keep = keep
        self.tag = None
        self.by_tag = defaultdict(dict)

    def _wrap(self, method):
        orig = getattr(self.cls, method)
        rec = self

        def recording(draws, name, *args, **kwargs):
            out = orig(draws, name, *args, **kwargs)
            if name not in draws.given and rec.keep(rec.tag, name):
                rec.by_tag[rec.tag].setdefault(name, []).append(clone_tree(out))
            return out
        return recording

    def installed(self):
        return patched([(self.cls, m, self._wrap(m)) for m in DRAW_METHODS])


class StageTimer:
    """Host-clock seconds of each wrapped function, the device synchronized
    on both sides of every call (the profile tools' stage view)."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._sync()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        return timed

    def installed(self, stages: dict):
        """stages: name -> (owner, attr)."""
        return patched([(o, a, self.wrap(n, getattr(o, a))) for n, (o, a) in stages.items()])


LABEL = "pb:"


def labelled(stages: dict):
    """Profiler ranges named pb:<stage> around each wrapped function, with
    no synchronize: what the host was doing when the device went idle."""
    def wrap(name, fn):
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(LABEL + name):
                return fn(*args, **kwargs)
        return ranged
    return patched([(o, a, wrap(n, getattr(o, a))) for n, (o, a) in stages.items()])


class LaunchRecorder:
    """Each launch of the program's three kernels, as its wrapper module
    makes it: (kernel, model key, B, bytes read once and written once,
    optional inputs present)."""

    KERNELS = {"launch_step": "fused_step_kernel", "launch_fk": "fk_spheres_kernel",
               "launch_fk_full": "fk_full_kernel"}

    def __init__(self, module):
        self.module = module
        self.launches = []

    def _wrap(self, attr):
        orig = getattr(self.module, attr)
        kernel = self.KERNELS[attr]
        rec = self

        def recording(model, *args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            outs = [t for a in args if isinstance(a, tuple) for t in a]
            key = (model.nb, model.nq, len(model.sph_tags))
            if attr == "launch_step":
                (pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                 payload, com_shift, extra, out) = args[:13]
                root_free = args[14] if len(args) > 14 else kwargs.get("root_free")
                n = nbytes([pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x,
                                payload, com_shift, extra]) + nbytes(out)
                flags = (payload is not None, com_shift is not None, extra is not None,
                         bool(root_free))
            else:
                n = nbytes(tensors) + nbytes(outs)
                flags = ()
            rec.launches.append((kernel, key, int(args[0].shape[0]), n, flags))
            return orig(model, *args, **kwargs)
        return recording

    def installed(self):
        return patched([(self.module, a, self._wrap(a)) for a in self.KERNELS])
