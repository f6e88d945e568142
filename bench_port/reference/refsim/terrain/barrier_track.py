"""BarrierTrack "LEGO-block" terrain generator (build-time numpy).

A copy of `mqe_tpu/terrain/barrier_track.py` with its import re-pointed: the
same seed gives the same arrays in both packages.

Behavioral port of the reference generator (ref mqe/utils/terrain/
barrier_track.py:55-638): a track is a sequence of named blocks along +x
(init / gate / wall / plane / rotation), tiled on a num_rows x num_cols grid
with a border. Instead of emitting a triangle mesh for a native physics
runtime, we emit:

  * a GROUND heightfield (meters, float32) carrying perlin noise — a regular
    grid so terrain collision is a pure gather on TPU, and
  * per-track WALL BOXES (axis-aligned, world coords) obtained by greedy
    rectangle decomposition of the wall mask — walls get exact analytic
    contact instead of near-vertical heightfield gradients.

Plus the same side products the envs need: `agent_origins` (spawn points from
init-block rooms), `env_origins`, and the `env_info` oracle dict
(gate_deviation etc., ref barrier_track.py:356-358) consumed by task wrappers.

Everything here is build-time numpy; results are uploaded once as device
constants.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from refsim.terrain.perlin import fractal_noise_2d

DEFAULT_TRACK_KWARGS = dict(
    options=["gate", "init", "wall", "plane"],
    track_width=1.6,
    wall_thickness=0.04,
    wall_height=0.5,
    wall=dict(block_length=3.0),
    plane=dict(block_length=3.0),
    init=dict(block_length=1.2, room_size=(0.8, 0.8), border_width=0.05, offset=(0, 0)),
    gate=dict(block_length=1.2, width=1.0, depth=1.0, offset=(0, 0), random=(0.0, 0.0)),
    rotation=dict(block_length=5.0, depth=0.1, offset=(0, 0), wide_px=(0.84, 0.2)),
    add_perlin_noise=False,
    border_perlin_noise=False,
    border_height=0.0,
    virtual_terrain=False,
    curriculum_perlin=True,
    no_perlin_threshold=0.02,
)


def greedy_rects(mask: np.ndarray):
    """Decompose a binary mask into maximal axis-aligned rectangles.

    Returns list of (x0, x1, y0, y1) half-open pixel ranges. Greedy row-run
    expansion — wall masks are blocky so counts stay small.
    """
    m = mask.copy().astype(bool)
    rects = []
    while m.any():
        xs, ys = np.nonzero(m)
        x0, y0 = xs[0], ys[0]
        # expand in y
        y1 = y0
        while y1 + 1 < m.shape[1] and m[x0, y1 + 1]:
            y1 += 1
        # expand in x while the full row-run holds
        x1 = x0
        while x1 + 1 < m.shape[0] and m[x1 + 1, y0 : y1 + 1].all():
            x1 += 1
        m[x0 : x1 + 1, y0 : y1 + 1] = False
        rects.append((x0, x1 + 1, y0, y1 + 1))
    return rects


@dataclass
class TrackBlock:
    """Result of painting one block (track-local pixel coords)."""

    wall_mask: np.ndarray          # (L, W) bool: wall cells
    noise_mask: np.ndarray         # (L, W) float: 1 where perlin applies
    info: dict = field(default_factory=dict)
    spawn_px: np.ndarray | None = None   # (num_agents, 2) agent spawn pixels


@dataclass
class TerrainBuild:
    """Build products consumed by the env layer."""

    height: np.ndarray             # (X, Y) float32 meters, ground only
    origin: np.ndarray             # (2,) world xy of cell (0,0)
    scale: float
    boxes: np.ndarray              # (R, C, MAXB, 7) world center/half/valid
    env_origins: np.ndarray        # (R, C, 3)
    agent_origins: np.ndarray      # (R, C, A, 3)
    env_info: dict                 # name -> (R, C, k) arrays
    track_width: float
    track_length: float


class BarrierTrackBuilder:
    MAX_BOXES = 16

    def __init__(self, terrain_cfg: dict, num_agents: int):
        """terrain_cfg carries the reference cfg.terrain fields used here:
        num_rows, num_cols, horizontal_scale, border_size,
        BarrierTrack_kwargs, TerrainPerlin_kwargs."""
        self.cfg = terrain_cfg
        self.num_agents = num_agents
        kw = dict(DEFAULT_TRACK_KWARGS)
        kw.update(terrain_cfg.get("BarrierTrack_kwargs", {}))
        self.kw = kw
        self.scale = terrain_cfg.get("horizontal_scale", 0.025)
        self.rows = terrain_cfg.get("num_rows", 1)
        self.cols = terrain_cfg.get("num_cols", 1)
        self.border = terrain_cfg.get("border_size", 1.0)
        self.perlin_kwargs = dict(terrain_cfg.get("TerrainPerlin_kwargs", {}))

        self.block_res = []
        tl = 0.0
        width_px = int(np.ceil(kw["track_width"] / self.scale))
        for opt in kw["options"]:
            bl = kw[opt]["block_length"]
            tl += bl
            self.block_res.append((int(np.ceil(bl / self.scale)), width_px))
        self.track_length = tl
        self.track_width = kw["track_width"]
        self.track_res = (
            sum(r[0] for r in self.block_res),
            width_px,
        )

    # ---- block painters (track-local; wall mask + noise mask + info) ----

    def _px(self, meters):
        return int(np.ceil(meters / self.scale))

    def _wall_height(self, rng):
        wh = self.kw["wall_height"]
        return rng.uniform(*wh) if isinstance(wh, (tuple, list)) else wh

    def paint_wall(self, res, rng, thick_px):
        wall = np.ones(res, dtype=bool)
        noise = np.zeros(res, dtype=np.float32)
        return TrackBlock(wall, noise)

    def paint_plane(self, res, rng, thick_px):
        wall = np.zeros(res, dtype=bool)
        wall[:, :thick_px] = True
        wall[:, -thick_px:] = True
        noise = np.zeros(res, dtype=np.float32)
        noise[:, thick_px : res[1] - thick_px] = 1.0
        return TrackBlock(wall, noise)

    def paint_init(self, res, rng, thick_px):
        kw = self.kw["init"]
        wall = np.zeros(res, dtype=bool)
        noise = np.zeros(res, dtype=np.float32)
        off = (self._px(kw["offset"][0]), self._px(kw["offset"][1]))
        room = (self._px(kw["room_size"][0]), self._px(kw["room_size"][1]))
        border_px = self._px(kw.get("border_width", 0.0))
        A = self.num_agents
        room_x = room[0]
        room_y_total = room[1] * A + border_px * (A - 1)
        ox = int(np.ceil((res[0] - room_x) / 2)) + off[0]
        oy = int(np.ceil((res[1] - room_y_total) / 2)) + off[1]
        # everything up to the room exit is wall; rooms carved out
        wall[: ox + room_x, :] = True
        noise[ox + room_x :, thick_px : res[1] - thick_px] = 1.0
        spawn = np.zeros((A, 2), dtype=np.float32)
        for i in range(A):
            y0 = oy + i * (room[1] + border_px)
            if room_x > 0 and room[1] > 0:
                wall[ox : ox + room_x, y0 : y0 + room[1]] = False
                noise[ox : ox + room_x, y0 : y0 + room[1]] = 1.0
            spawn[i] = (ox + room_x // 2, y0 + room[1] // 2)
        # side + back walls
        if thick_px > 0:
            wall[:, :thick_px] = True
            wall[:, -thick_px:] = True
            wall[:thick_px, :] = True
        # degenerate init block (tug/wrestling: block_length 0-ish rooms):
        if res[0] <= 1 or room_x == 0:
            wall[:] = False
            wall[:, :thick_px] = True
            wall[:, -thick_px:] = True
            spawn[:, 0] = max(res[0] // 2, 0)
            spawn[:, 1] = res[1] // 2
        return TrackBlock(wall, noise, spawn_px=spawn)

    def paint_gate(self, res, rng, thick_px):
        kw = self.kw["gate"]
        wall = np.zeros(res, dtype=bool)
        noise = np.ones(res, dtype=np.float32)
        depth = kw["depth"]
        depth = rng.uniform(*depth) if isinstance(depth, (tuple, list)) else depth
        width = kw["width"]
        width = rng.uniform(*width) if isinstance(width, (tuple, list)) else width
        off = np.array([self._px(kw["offset"][0]), self._px(kw["offset"][1])])
        rand_m = np.asarray(kw.get("random", (0.0, 0.0))) / self.scale
        rand_px = np.ceil(rand_m * (rng.random(2) - 0.5) * 2).astype(int)
        depth_px = max(int(depth / self.scale), 1)
        width_px = int(width / self.scale)
        gate_origin = (
            np.array(
                [
                    int(np.ceil((res[0] - depth_px) / 2)),
                    int(np.ceil((res[1] - width_px) / 2)),
                ]
            )
            + off
            + rand_px
        )
        wall[gate_origin[0] : gate_origin[0] + depth_px, :] = True
        noise[gate_origin[0] : gate_origin[0] + depth_px, :] = 0.0
        wall[
            gate_origin[0] : gate_origin[0] + depth_px,
            gate_origin[1] : gate_origin[1] + width_px,
        ] = False
        noise[
            gate_origin[0] : gate_origin[0] + depth_px,
            gate_origin[1] : gate_origin[1] + width_px,
        ] = 1.0
        if thick_px > 0:
            wall[:, :thick_px] = True
            wall[:, -thick_px:] = True
            noise[:, :thick_px] = 0.0
            noise[:, -thick_px:] = 0.0
        # oracle obs: gate center deviation from block center, meters
        # (ref barrier_track.py:356-358)
        info = {"gate_deviation": (off + rand_px).astype(np.float32) * self.scale}
        return TrackBlock(wall, noise, info=info)

    def paint_rotation(self, res, rng, thick_px):
        kw = self.kw["rotation"]
        wall = np.zeros(res, dtype=bool)
        noise = np.ones(res, dtype=np.float32)
        depth = kw["depth"]
        depth = rng.uniform(*depth) if isinstance(depth, (tuple, list)) else depth
        off = (self._px(kw["offset"][0]), self._px(kw["offset"][1]))
        wide = (self._px(kw["wide_px"][0]), self._px(kw["wide_px"][1]))
        depth_px = max(int(depth / self.scale), 1)
        ox = int(np.ceil((res[0] - depth_px) / 2)) + off[0]
        wall[ox : ox + depth_px, : wide[0]] = True
        wall[ox : ox + depth_px, -wide[0] :] = True
        noise[ox : ox + depth_px, : wide[0]] = 0.0
        noise[ox : ox + depth_px, -wide[0] :] = 0.0
        if thick_px > 0:
            wall[:, :thick_px] = True
            wall[:, -thick_px:] = True
            noise[:, :thick_px] = 0.0
            noise[:, -thick_px:] = 0.0
        info = {"rotation_size": np.array([depth], dtype=np.float32)}
        return TrackBlock(wall, noise, info=info)

    # ---- assembly ----

    def build(self, seed: int = 0) -> TerrainBuild:
        rng = np.random.default_rng(seed)
        scale = self.scale
        border_px = int(self.border / scale)
        X = self.rows * self.track_res[0] + 2 * border_px
        Y = self.cols * self.track_res[1] + 2 * border_px
        height = np.zeros((X, Y), dtype=np.float32)

        if self.kw["add_perlin_noise"] and self.kw["border_perlin_noise"]:
            pk = dict(self.perlin_kwargs)
            for k, v in pk.items():
                if isinstance(v, (tuple, list)):
                    pk[k] = v[0]
            height += fractal_noise_2d(
                rng,
                xSize=self.track_length * self.rows + 2 * self.border,
                ySize=self.track_width * self.cols + 2 * self.border,
                xSamples=X,
                ySamples=Y,
                **pk,
            ).astype(np.float32)
            if self.kw["border_height"] != 0.0:
                height[:, :border_px] += self.kw["border_height"]
                height[:, -border_px:] += self.kw["border_height"]

        boxes = np.zeros((self.rows, self.cols, self.MAX_BOXES, 7), dtype=np.float32)
        env_origins = np.zeros((self.rows, self.cols, 3), dtype=np.float32)
        agent_origins = np.zeros((self.rows, self.cols, self.num_agents, 3), dtype=np.float32)
        env_info: dict = {}

        thick = self.kw["wall_thickness"]
        painters = {
            "wall": self.paint_wall,
            "plane": self.paint_plane,
            "init": self.paint_init,
            "gate": self.paint_gate,
            "rotation": self.paint_rotation,
        }

        for r in range(self.rows):
            for c in range(self.cols):
                tx = r * self.track_res[0] + border_px
                ty = c * self.track_res[1] + border_px
                wall_h = self._wall_height(rng)
                thick_px = self._px(
                    rng.uniform(*thick) if isinstance(thick, (tuple, list)) else thick
                )
                track_wall = np.zeros(self.track_res, dtype=bool)
                track_noise = np.zeros(self.track_res, dtype=np.float32)
                spawn_px = None
                info: dict = {}
                x_off = 0
                difficulty = (
                    r / max(self.rows - 1, 1) if self.cfg.get("curriculum", False) else None
                )
                for bi, opt in enumerate(self.kw["options"]):
                    blk = painters[opt](self.block_res[bi], rng, thick_px)
                    L = self.block_res[bi][0]
                    track_wall[x_off : x_off + L] = blk.wall_mask
                    track_noise[x_off : x_off + L] = blk.noise_mask
                    if blk.spawn_px is not None:
                        spawn_px = blk.spawn_px + np.array([x_off, 0.0], dtype=np.float32)
                    info.update(blk.info)
                    x_off += L

                # perlin ground noise inside the track
                if self.kw["add_perlin_noise"]:
                    pk = dict(self.perlin_kwargs)
                    for k, v in pk.items():
                        if isinstance(v, (tuple, list)):
                            if difficulty is None or not self.kw["curriculum_perlin"]:
                                pk[k] = rng.uniform(*v)
                            else:
                                pk[k] = v[0] * (1 - difficulty) + v[1] * difficulty
                            if self.kw["no_perlin_threshold"] > pk[k]:
                                pk[k] = 0.0
                    tnoise = fractal_noise_2d(
                        rng,
                        xSize=self.track_length,
                        ySize=self.track_width,
                        xSamples=self.track_res[0],
                        ySamples=self.track_res[1],
                        **pk,
                    ).astype(np.float32)
                    height[tx : tx + self.track_res[0], ty : ty + self.track_res[1]] = (
                        tnoise * track_noise
                    )

                # wall boxes from the mask
                rects = greedy_rects(track_wall)
                if len(rects) > self.MAX_BOXES:
                    # merge smallest boxes away by keeping the largest
                    rects.sort(key=lambda rct: -(rct[1] - rct[0]) * (rct[3] - rct[2]))
                    rects = rects[: self.MAX_BOXES]
                for bi_, (x0, x1, y0, y1) in enumerate(rects):
                    cx = (tx + (x0 + x1) / 2.0) * scale
                    cy = (ty + (y0 + y1) / 2.0) * scale
                    hx = (x1 - x0) / 2.0 * scale
                    hy = (y1 - y0) / 2.0 * scale
                    boxes[r, c, bi_] = [cx, cy, wall_h / 2.0, hx, hy, wall_h / 2.0, 1.0]

                env_origins[r, c] = [tx * scale, (ty * scale) + self.track_width / 2.0, 0.0]
                if spawn_px is not None:
                    for a in range(self.num_agents):
                        ax = tx + spawn_px[a, 0]
                        ay = ty + spawn_px[a, 1]
                        agent_origins[r, c, a] = [ax * scale, ay * scale, 0.0]
                else:
                    agent_origins[r, c, :] = env_origins[r, c]

                for k, v in info.items():
                    if k not in env_info:
                        env_info[k] = np.zeros(
                            (self.rows, self.cols, len(np.atleast_1d(v))), dtype=np.float32
                        )
                        # first-track broadcast, then per-track overwrite
                        env_info[k][:, :] = np.atleast_1d(v)
                    env_info[k][r, c] = np.atleast_1d(v)

        return TerrainBuild(
            height=height,
            origin=np.zeros(2, dtype=np.float32),
            scale=scale,
            boxes=boxes,
            env_origins=env_origins,
            agent_origins=agent_origins,
            env_info=env_info,
            track_width=self.track_width,
            track_length=self.track_length,
        )


def plane_terrain(num_envs: int, num_agents: int, env_spacing: float = 3.0) -> TerrainBuild:
    """Flat-plane layout for mesh_type='plane' tasks (ref legged_robot.py:999-1011):
    a grid of env origins on an infinite flat floor."""
    cols = int(np.floor(np.sqrt(num_envs)))
    rows = int(np.ceil(num_envs / cols))
    xx, yy = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    origins = np.zeros((rows, cols, 3), dtype=np.float32)
    origins[..., 0] = env_spacing * xx
    origins[..., 1] = env_spacing * yy
    return TerrainBuild(
        height=np.zeros((4, 4), dtype=np.float32),
        origin=np.array([-1000.0, -1000.0], dtype=np.float32),
        scale=666.0,
        boxes=np.zeros((rows, cols, BarrierTrackBuilder.MAX_BOXES, 7), dtype=np.float32),
        env_origins=origins,
        agent_origins=origins[:, :, None, :].repeat(num_agents, axis=2),
        env_info={},
        track_width=0.0,
        track_length=0.0,
    )
