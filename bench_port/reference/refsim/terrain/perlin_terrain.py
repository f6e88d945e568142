"""Standalone fractal-perlin terrain builder (ref mqe/utils/terrain/perlin.py
TerrainPerlin class): one continuous noisy field with a grid of env origins.

A copy of `mqe_tpu/terrain/perlin_terrain.py` with its imports re-pointed.
The noise is `terrain/perlin.py`'s numpy path; the JAX package can hand the
interpolation to a host C++ helper (`mqe_tpu/native/terrain_kernels.cc`),
which computes the same numbers on the CPU at build time. That helper is no
TPU kernel and has no counterpart here: the port keeps the numpy path only.
"""
from __future__ import annotations

import numpy as np

from refsim.terrain.barrier_track import BarrierTrackBuilder, TerrainBuild
from refsim.terrain.perlin import fractal_noise_2d


class PerlinTerrainBuilder:
    def __init__(self, terrain_cfg: dict, num_agents: int = 1):
        self.cfg = terrain_cfg
        self.num_agents = num_agents
        self.rows = terrain_cfg.get("num_rows", 1)
        self.cols = terrain_cfg.get("num_cols", 1)
        self.length = terrain_cfg.get("terrain_length", 8.0)
        self.width = terrain_cfg.get("terrain_width", 8.0)
        self.scale = terrain_cfg.get("horizontal_scale", 0.025)
        self.perlin_kwargs = dict(terrain_cfg.get("TerrainPerlin_kwargs", {}))

    def build(self, seed: int = 0) -> TerrainBuild:
        rng = np.random.default_rng(seed)
        X = int(self.rows * self.length / self.scale)
        Y = int(self.cols * self.width / self.scale)
        height = fractal_noise_2d(
            rng,
            xSize=self.rows * self.length,
            ySize=self.cols * self.width,
            xSamples=X,
            ySamples=Y,
            **self.perlin_kwargs,
        ).astype(np.float32)
        env_origins = np.zeros((self.rows, self.cols, 3), dtype=np.float32)
        for r in range(self.rows):
            for c in range(self.cols):
                ox = (r + 0.5) * self.length
                oy = (c + 0.5) * self.width
                env_origins[r, c] = [
                    ox, oy,
                    float(height[int(ox / self.scale), int(oy / self.scale)]),
                ]
        return TerrainBuild(
            height=height,
            origin=np.zeros(2, dtype=np.float32),
            scale=self.scale,
            boxes=np.zeros(
                (self.rows, self.cols, BarrierTrackBuilder.MAX_BOXES, 7), dtype=np.float32
            ),
            env_origins=env_origins,
            agent_origins=env_origins[:, :, None, :].repeat(self.num_agents, axis=2),
            env_info={},
            track_width=self.width,
            track_length=self.length,
        )
