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
            t = torch.as_tensor(self.given[name], dtype=torch.float32, device=device)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"draw {name!r}: given shape {tuple(t.shape)}, expected {tuple(shape)}")
            return t
        u = torch.rand(tuple(shape), generator=self.generator, device=device)
        return lo + (hi - lo) * u

    def state(self, name: str, build):
        """A random state object: the one given under `name`, else build()."""
        return self.given[name] if name in self.given else build()
