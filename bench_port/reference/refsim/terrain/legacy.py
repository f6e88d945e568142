"""Classic legged-gym curriculum terrain (slopes / stairs / obstacles /
stones / gaps / pits), behavioral port of the reference's legacy Terrain class
(ref mqe/utils/terrain/terrain.py:75-164) and the isaacgym.terrain_utils
generators it calls — pure numpy, emits a ground heightfield grid compatible
with the BarrierTrack TerrainBuild product.

A copy of `mqe_tpu/terrain/legacy.py` with its import re-pointed: the same
seed draws the same `np.random.default_rng` stream in the same loop order, so
both packages build equal arrays. Build-time numpy; the env uploads the
result to the device once.

Used when cfg.terrain.mesh_type is 'heightfield'/'trimesh' without
`selected="BarrierTrack"` (ref legged_robot.py:959-970).
"""
from __future__ import annotations

import numpy as np

from refsim.terrain.barrier_track import BarrierTrackBuilder, TerrainBuild


def sloped(rng, shape, scale, vscale, slope):
    x = np.arange(shape[0])[:, None] * scale
    return (slope * x * np.ones(shape)).astype(np.float32)


def random_uniform(rng, shape, scale, vscale, min_h, max_h, step=0.005, downsample=0.2):
    ds = max(int(downsample / scale), 1)
    small = rng.uniform(min_h, max_h, (shape[0] // ds + 1, shape[1] // ds + 1))
    small = np.round(small / step) * step
    out = np.repeat(np.repeat(small, ds, 0), ds, 1)[: shape[0], : shape[1]]
    return out.astype(np.float32)


def stairs(rng, shape, scale, vscale, step_width, step_height):
    sw = max(int(step_width / scale), 1)
    n = shape[0] // sw
    hf = np.zeros(shape, dtype=np.float32)
    for i in range(n):
        hf[i * sw :, :] = (i + 1) * step_height
    return hf


def pyramid_stairs(rng, shape, scale, vscale, step_width, step_height, platform=3.0):
    hf = np.zeros(shape, dtype=np.float32)
    sw = max(int(step_width / scale), 1)
    plat = int(platform / scale / 2)
    cx, cy = shape[0] // 2, shape[1] // 2
    x0, x1, y0, y1 = 0, shape[0], 0, shape[1]
    h = 0.0
    while (x1 - x0) > plat * 2 and (y1 - y0) > plat * 2:
        x0 += sw; x1 -= sw; y0 += sw; y1 -= sw
        h += step_height
        hf[x0:x1, y0:y1] = h
    return hf


def discrete_obstacles(rng, shape, scale, vscale, max_h, min_size, max_size, num_rects, platform=3.0):
    hf = np.zeros(shape, dtype=np.float32)
    for _ in range(num_rects):
        w = rng.integers(int(min_size / scale), max(int(max_size / scale), 2))
        l = rng.integers(int(min_size / scale), max(int(max_size / scale), 2))
        x = rng.integers(0, max(shape[0] - w, 1))
        y = rng.integers(0, max(shape[1] - l, 1))
        hf[x : x + w, y : y + l] = rng.choice([-max_h, -max_h / 2, max_h / 2, max_h])
    plat = int(platform / scale / 2)
    cx, cy = shape[0] // 2, shape[1] // 2
    hf[cx - plat : cx + plat, cy - plat : cy + plat] = 0.0
    return hf


def stepping_stones(rng, shape, scale, vscale, stone_size, stone_distance, max_h, platform=3.0, depth=-2.0):
    hf = np.full(shape, depth, dtype=np.float32)
    ss = max(int(stone_size / scale), 1)
    sd = int(stone_distance / scale)
    y = 0
    while y < shape[1]:
        x = rng.integers(0, ss)
        while x < shape[0]:
            hf[x : x + ss, y : y + ss] = rng.uniform(0, max_h)
            x += ss + sd
        y += ss + sd
    plat = int(platform / scale / 2)
    cx, cy = shape[0] // 2, shape[1] // 2
    hf[cx - plat : cx + plat, cy - plat : cy + plat] = 0.0
    return hf


def gap(rng, shape, scale, vscale, gap_size, platform=3.0, depth=-1.0):
    hf = np.zeros(shape, dtype=np.float32)
    g = int(gap_size / scale)
    p = int(platform / scale / 2)
    cx, cy = shape[0] // 2, shape[1] // 2
    hf[cx - p - g : cx + p + g, cy - p - g : cy + p + g] = depth
    hf[cx - p : cx + p, cy - p : cy + p] = 0.0
    return hf


def pit(rng, shape, scale, vscale, depth, platform=3.0):
    hf = np.full(shape, depth, dtype=np.float32)
    p = int(platform / scale / 2)
    cx, cy = shape[0] // 2, shape[1] // 2
    hf[cx - p : cx + p, cy - p : cy + p] = 0.0
    return hf


class LegacyTerrainBuilder:
    """Curriculum grid of classic terrain tiles (rows = difficulty levels,
    cols = terrain types with cfg proportions; ref terrain.py:75-164)."""

    def __init__(self, terrain_cfg: dict, num_agents: int = 1):
        self.cfg = terrain_cfg
        self.num_agents = num_agents
        self.rows = terrain_cfg.get("num_rows", 10)
        self.cols = terrain_cfg.get("num_cols", 20)
        self.length = terrain_cfg.get("terrain_length", 8.0)
        self.width = terrain_cfg.get("terrain_width", 8.0)
        self.scale = terrain_cfg.get("horizontal_scale", 0.1)
        self.border = terrain_cfg.get("border_size", 1.0)
        self.proportions = terrain_cfg.get(
            "terrain_proportions", [0.1, 0.1, 0.35, 0.25, 0.2]
        )

    def _make_tile(self, rng, difficulty, choice, shape):
        p = np.cumsum(self.proportions)
        slope = difficulty * 0.4
        step_h = 0.05 + 0.175 * difficulty
        obstacle_h = 0.05 + difficulty * 0.15
        if choice < p[0]:
            hf = sloped(rng, shape, self.scale, 1.0, slope * (1 if choice < p[0] / 2 else -1))
        elif choice < p[1]:
            hf = sloped(rng, shape, self.scale, 1.0, slope)
            hf += random_uniform(rng, shape, self.scale, 1.0, -0.05, 0.05)
        elif choice < p[2]:
            hf = pyramid_stairs(rng, shape, self.scale, 1.0, 0.31, step_h * (1 if choice < (p[1] + p[2]) / 2 else -1))
        elif choice < p[3]:
            hf = discrete_obstacles(rng, shape, self.scale, 1.0, obstacle_h, 1.0, 2.0, 20)
        elif len(p) > 4 and choice < p[4]:
            hf = stepping_stones(rng, shape, self.scale, 1.0, 1.5 * (1.1 - difficulty), 0.1 * difficulty, 0.0)
        elif len(p) > 5:
            hf = gap(rng, shape, self.scale, 1.0, difficulty)
        else:
            hf = random_uniform(rng, shape, self.scale, 1.0, -0.05 * difficulty, 0.05 * difficulty)
        return hf

    def build(self, seed: int = 0) -> TerrainBuild:
        rng = np.random.default_rng(seed)
        Lpx = int(self.length / self.scale)
        Wpx = int(self.width / self.scale)
        bpx = int(self.border / self.scale)
        X = self.rows * Lpx + 2 * bpx
        Y = self.cols * Wpx + 2 * bpx
        height = np.zeros((X, Y), dtype=np.float32)
        env_origins = np.zeros((self.rows, self.cols, 3), dtype=np.float32)
        for r in range(self.rows):
            difficulty = r / max(self.rows - 1, 1)
            for c in range(self.cols):
                choice = (c + 0.001) / self.cols
                tile = self._make_tile(rng, difficulty, choice, (Lpx, Wpx))
                x0 = bpx + r * Lpx
                y0 = bpx + c * Wpx
                height[x0 : x0 + Lpx, y0 : y0 + Wpx] = tile
                cx = x0 + Lpx // 2
                cy = y0 + Wpx // 2
                env_origins[r, c] = [
                    cx * self.scale,
                    cy * self.scale,
                    float(tile[Lpx // 2, Wpx // 2]),
                ]
        return TerrainBuild(
            height=height,
            origin=np.zeros(2, dtype=np.float32),
            scale=self.scale,
            boxes=np.zeros((self.rows, self.cols, BarrierTrackBuilder.MAX_BOXES, 7), dtype=np.float32),
            env_origins=env_origins,
            agent_origins=env_origins[:, :, None, :].repeat(self.num_agents, axis=2),
            env_info={},
            track_width=self.width,
            track_length=self.length,
        )
