"""Terrain generators (build-time numpy, uploaded to the device once)."""
from mqe_tpu_torch.terrain.barrier_track import BarrierTrackBuilder, plane_terrain  # noqa: F401


def get_terrain_builder(name: str):
    if name == "BarrierTrack":
        return BarrierTrackBuilder
    raise NotImplementedError(
        f"terrain builder {name!r} is not ported yet (ROADMAP Queue A item 9)"
    )
