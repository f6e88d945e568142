"""The one place the env draws random numbers.

Every draw is named. A caller may hand `Draws` precomputed values by name
(the tests pass the JAX package's draws, whose streams torch cannot
reproduce); every other draw comes from the explicit `torch.Generator`.
"""
from __future__ import annotations

import torch


class Draws:
    def __init__(self, generator: torch.Generator, given: dict | None = None):
        self.generator = generator
        self.given = dict(given or {})

    def uniform(self, name: str, shape, lo: float, hi: float, device) -> torch.Tensor:
        """U[lo, hi) of `shape` (float32), or the value given under `name`."""
        if name in self.given:
            return self._given(name, shape, device)
        u = torch.rand(tuple(shape), generator=self.generator, device=device)
        return lo + (hi - lo) * u

    def normal(self, name: str, shape, device) -> torch.Tensor:
        """N(0, 1) of `shape` (float32), or the value given under `name`."""
        if name in self.given:
            return self._given(name, shape, device)
        return torch.randn(tuple(shape), generator=self.generator, device=device)

    def integers(self, name: str, shape, lo: int, hi: int, device) -> torch.Tensor:
        """Integers uniform in [lo, hi) of `shape` (int64), or the value given
        under `name`."""
        if name in self.given:
            t = torch.as_tensor(self.given[name], dtype=torch.int64, device=device)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"draw {name!r}: given shape {tuple(t.shape)}, "
                                 f"expected {tuple(shape)}")
            return t
        return torch.randint(lo, hi, tuple(shape), generator=self.generator, device=device)

    def permutation(self, name: str, n: int, device) -> torch.Tensor:
        """A permutation of range(n) (int64), or the one given under `name`."""
        if name in self.given:
            p = torch.as_tensor(self.given[name], dtype=torch.int64, device=device)
            if tuple(p.shape) != (n,):
                raise ValueError(f"draw {name!r}: given shape {tuple(p.shape)}, expected ({n},)")
            return p
        return torch.randperm(n, generator=self.generator, device=device)

    def _given(self, name, shape, device):
        t = torch.as_tensor(self.given[name], dtype=torch.float32, device=device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"draw {name!r}: given shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t

    def state(self, name: str, build):
        """A random state object: the one given under `name`, else build()."""
        return self.given[name] if name in self.given else build()
