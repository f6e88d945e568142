"""The one place the env draws random numbers.

Every draw is named. A caller may hand `Draws` precomputed values by name
(the tests pass the JAX package's draws, whose streams torch cannot
reproduce); every other draw comes from the explicit `torch.Generator`.

With `env_slice=(start, stop, total)` the draws are those of a rank that
holds envs [start, stop) of `total` (parallel/mesh.py): every draw over the
env axis draws the whole (total, ...) tensor and keeps the rank's rows, so a
sharded run draws what one process draws and every rank's generator
advances alike; a given value of the whole env axis is sliced the same way.
"""
from __future__ import annotations

import torch

from refsim.utils.tree import tree_map


class Draws:
    def __init__(self, generator: torch.Generator, given: dict | None = None,
                 env_slice: tuple | None = None):
        self.generator = generator
        self.given = dict(given or {})
        self.env_slice = env_slice

    def _full(self, name, shape):
        """The shape to draw: the whole env axis when sharded."""
        shape = tuple(shape)
        if self.env_slice is None:
            return shape
        start, stop, total = self.env_slice
        if not shape or shape[0] != stop - start:
            raise ValueError(f"draw {name!r} of shape {shape}: a sharded draw is over the "
                             f"env axis ({stop - start} envs of this rank)")
        return (total,) + shape[1:]

    def _mine(self, t):
        return t if self.env_slice is None else t[self.env_slice[0]:self.env_slice[1]]

    def uniform(self, name: str, shape, lo: float, hi: float, device) -> torch.Tensor:
        """U[lo, hi) of `shape` (float32), or the value given under `name`."""
        if name in self.given:
            return self._given(name, shape, device)
        u = torch.rand(self._full(name, shape), generator=self.generator, device=device)
        return self._mine(lo + (hi - lo) * u)

    def normal(self, name: str, shape, device) -> torch.Tensor:
        """N(0, 1) of `shape` (float32), or the value given under `name`."""
        if name in self.given:
            return self._given(name, shape, device)
        return self._mine(torch.randn(self._full(name, shape), generator=self.generator,
                                      device=device))

    def integers(self, name: str, shape, lo: int, hi: int, device) -> torch.Tensor:
        """Integers uniform in [lo, hi) of `shape` (int64), or the value given
        under `name`."""
        if name in self.given:
            return self._given(name, shape, device, torch.int64)
        return self._mine(torch.randint(lo, hi, self._full(name, shape),
                                        generator=self.generator, device=device))

    def permutation(self, name: str, n: int, device) -> torch.Tensor:
        """A permutation of range(n) (int64), or the one given under `name`."""
        if name in self.given:
            p = torch.as_tensor(self.given[name], dtype=torch.int64, device=device)
            if tuple(p.shape) != (n,):
                raise ValueError(f"draw {name!r}: given shape {tuple(p.shape)}, expected ({n},)")
            return p
        return torch.randperm(n, generator=self.generator, device=device)

    def _given(self, name, shape, device, dtype=torch.float32):
        t = torch.as_tensor(self.given[name], dtype=dtype, device=device)
        if self.env_slice is not None and t.ndim and t.shape[0] == self.env_slice[2]:
            t = self._mine(t)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"draw {name!r}: given shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t

    def state(self, name: str, build):
        """A random state object: the one given under `name` (its env axis
        sliced when sharded), else build()."""
        if name not in self.given:
            return build()
        if self.env_slice is None:
            return self.given[name]
        total = self.env_slice[2]
        return tree_map(lambda t: self._mine(t) if t.ndim and t.shape[0] == total else t,
                        self.given[name])
