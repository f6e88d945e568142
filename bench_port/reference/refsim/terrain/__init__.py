"""Terrain generators (build-time numpy, uploaded to the device once).

Registry mirrors the reference's name->class dispatch
(ref mqe/utils/terrain/__init__.py:3-13), as `mqe_tpu/terrain/__init__.py`.
"""
from refsim.terrain.barrier_track import BarrierTrackBuilder, TerrainBuild, plane_terrain  # noqa: F401
from refsim.terrain.perlin import fractal_noise_2d  # noqa: F401


def get_terrain_builder(name: str):
    if name == "BarrierTrack":
        return BarrierTrackBuilder
    if name == "TerrainPerlin":
        from refsim.terrain.perlin_terrain import PerlinTerrainBuilder

        return PerlinTerrainBuilder
    if name in ("Legacy", "heightfield", "trimesh"):
        from refsim.terrain.legacy import LegacyTerrainBuilder

        return LegacyTerrainBuilder
    raise KeyError(f"unknown terrain builder {name}")
