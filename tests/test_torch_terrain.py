"""The port's terrain builders and runtime terrain curriculum against the JAX
package.

- The Legacy and Perlin builds (terrain/legacy.py, terrain/perlin_terrain.py)
  are equal, array for array, to the JAX package's for the same seed.
- The curriculum (Go1Env with `curriculum` on a heightfield of several
  rows): the two steps of tests/test_envs.py::test_terrain_curriculum_levels_progress
  from JAX's states, with JAX's random-level draw handed in under
  "curr_level" and its reset state under "fresh": the levels equal JAX's.
- One step on the Legacy heightfield within an episode (the heightfield
  contact, `scene._terrain_and_box_force` with `flat_height=None`), and one
  step of go1gate on two rows of its track with the curriculum on (each
  env's wall boxes of its level), within tests/test_soa_episode.py::TOLS.

The JAX side is tests/goldens/torch_terrain.npz (tools/make_torch_goldens.py).
"""
import os

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs import tasks as T
from mqe_tpu_torch.envs.config import Go1Cfg
from mqe_tpu_torch.envs.go1_env import Go1Env
from mqe_tpu_torch.terrain import BarrierTrackBuilder, get_terrain_builder
from mqe_tpu_torch.terrain.legacy import LegacyTerrainBuilder
from mqe_tpu_torch.terrain.perlin_terrain import PerlinTerrainBuilder
from mqe_tpu_torch.utils.convert import env_state_from_numpy
from test_torch_env import TOLS, _tree

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "torch_terrain.npz")
BUILD_FIELDS = ("height", "origin", "boxes", "env_origins", "agent_origins")
# the recorder's cases (tools/make_torch_goldens.py LEGACY_CASES, PERLIN_CASES)
LEGACY_CASES = {
    "defaults": dict(num_rows=3, num_cols=10, terrain_length=4.0, terrain_width=4.0,
                     horizontal_scale=0.1),
    "gap": dict(num_rows=3, num_cols=5, terrain_length=4.0, terrain_width=4.0,
                horizontal_scale=0.1, terrain_proportions=[0.1, 0.1, 0.2, 0.2, 0.2, 0.2]),
    "flat-noise": dict(num_rows=2, num_cols=5, terrain_length=4.0, terrain_width=4.0,
                       horizontal_scale=0.1, terrain_proportions=[0.2, 0.2, 0.2, 0.2, 0.1]),
}
PERLIN_CASES = {
    "perlin": dict(num_rows=2, num_cols=3, terrain_length=4.0, terrain_width=4.0,
                   horizontal_scale=0.05, TerrainPerlin_kwargs=dict(zScale=0.12, frequency=10)),
}


@pytest.fixture(scope="module")
def rec():
    with np.load(GOLDEN) as f:
        return dict(f)


@pytest.mark.parametrize("kind,case", [("legacy", c) for c in LEGACY_CASES]
                         + [("perlin", c) for c in PERLIN_CASES])
def test_builds_equal_jax(rec, kind, case):
    if kind == "legacy":
        b = LegacyTerrainBuilder(LEGACY_CASES[case], 2).build(seed=3)
    else:
        b = PerlinTerrainBuilder(PERLIN_CASES[case], 2).build(seed=1)
    for f in BUILD_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(b, f)), rec[f"{kind}/{case}/{f}"],
                                      err_msg=f)
    assert b.height.dtype == np.float32 and np.ptp(b.height) > 0


def test_registry_names_the_builders():
    """The name -> builder dispatch of mqe_tpu/terrain/__init__.py."""
    from mqe_tpu.terrain import get_terrain_builder as jax_builder

    for name in ("BarrierTrack", "TerrainPerlin", "Legacy", "heightfield", "trimesh"):
        assert get_terrain_builder(name).__name__ == jax_builder(name).__name__
    for get in (get_terrain_builder, jax_builder):
        with pytest.raises(KeyError):
            get("nope")


def test_perlin_ground():
    """tests/test_terrain.py::test_perlin_ground on the port's builder."""
    from test_terrain import gate_cfg

    cfg = gate_cfg()
    cfg["BarrierTrack_kwargs"]["add_perlin_noise"] = True
    cfg["TerrainPerlin_kwargs"] = {"zScale": 0.08, "frequency": 10}
    t = BarrierTrackBuilder(cfg, num_agents=2).build(seed=1)
    assert np.abs(t.height).max() > 0.005
    assert np.abs(t.height).max() < 0.2


class CurrCfg(Go1Cfg):
    """The recorder's `_curr_cfg`: one robot, a Legacy heightfield of 4 rows
    x 2 columns of 8 m tiles, the curriculum on, 2 s episodes."""

    class env(Go1Cfg.env):
        num_envs = 4
        num_agents = 1
        num_npcs = 0
        episode_length_s = 2.0

    class terrain(Go1Cfg.terrain):
        mesh_type = "heightfield"
        selected = "Legacy"
        curriculum = True
        num_rows = 4
        num_cols = 2
        terrain_length = 8.0
        terrain_width = 8.0


class GateRowsCfg(T.Go1GateCfg):
    class terrain(T.Go1GateCfg.terrain):
        num_rows = 2
        curriculum = True


@pytest.fixture(scope="module")
def curr_env():
    return Go1Env(CurrCfg, num_envs=4, seed=0, device="cpu")


def _step(env, rec, prefix):
    """The port's step of the recorded start with JAX's draws ("fresh",
    "curr_level"); returns (state, obs, done)."""
    state = env_state_from_numpy(_tree(rec, f"{prefix}/start"), device="cpu")
    fresh = env_state_from_numpy(_tree(rec, f"{prefix}/fresh"), device="cpu")
    draws = env.draws({"fresh": fresh, "curr_level": rec[f"{prefix}/curr_level"]})
    out, obs, done, _ = env.step(state, torch.as_tensor(rec[f"{prefix}/commands"]), draws)
    np.testing.assert_array_equal(done.numpy(), rec[f"{prefix}/done"])
    return out, obs, done


def _compare_agents(rec, prefix, out):
    ag_j = _tree(rec, f"{prefix}/out").phys.agents
    worst = {}
    for name, tol in TOLS.items():
        d = float(np.abs(getattr(out.phys.agents, name).numpy() - getattr(ag_j, name)).max())
        worst[name] = d
        assert d <= tol, f"{prefix} {name}: max diff {d:.3e} > {tol:.0e}"
    return worst


def test_curriculum_built_as_jax(curr_env):
    env = curr_env
    assert env.curriculum and env.num_levels == 4
    assert env.curr_up_dist == 4.0 and env.scene.flat_height is None
    assert tuple(env.grid_env_origins.shape) == (4, 2, 3)
    assert env.grid_boxes.shape[2] == 0         # Legacy tiles carry no wall boxes


def test_terrain_curriculum_levels_progress(rec, curr_env):
    """Promotion past half the track (a random level past the last), then
    demotion with large commands, the levels equal JAX's."""
    env = curr_env
    lv0 = rec["curr/step1/start/terrain_levels"]
    out, obs, done = _step(env, rec, "curr/step1")
    assert done.all()
    lv1 = out.terrain_levels.numpy()
    np.testing.assert_array_equal(lv1, rec["curr/step1/out/terrain_levels"])
    at_top = lv0 == env.num_levels - 1
    assert (lv1[~at_top] == lv0[~at_top] + 1).all()
    np.testing.assert_array_equal(lv1[at_top], rec["curr/step1/curr_level"][at_top])
    # spawn positions and observations follow the level
    expect = env.grid_env_origins[torch.as_tensor(lv1, dtype=torch.int64), env.env_cols_j]
    assert torch.equal(env._origins_for(out.terrain_levels)[0], expect)
    np.testing.assert_allclose(obs.base_pos.numpy(), rec["curr/step1/base_pos"], atol=1e-6)

    out2, _, done2 = _step(env, rec, "curr/step2")
    assert done2.all()
    lv2 = out2.terrain_levels.numpy()
    np.testing.assert_array_equal(lv2, rec["curr/step2/out/terrain_levels"])
    assert (lv2 <= lv1).all() and (lv2 >= 0).all()


def test_heightfield_step_matches_jax(rec, curr_env):
    """A step on the Legacy heightfield within an episode: the heightfield
    contact against JAX's, within TOLS."""
    out, obs, done = _step(curr_env, rec, "hf/step")
    assert not done.any()
    np.testing.assert_array_equal(out.terrain_levels.numpy(), rec["hf/step/out/terrain_levels"])
    _compare_agents(rec, "hf/step", out)
    np.testing.assert_allclose(obs.base_pos.numpy(), rec["hf/step/base_pos"], atol=TOLS["pos"])


def test_gate_two_rows_step_matches_jax(rec):
    """go1gate on two rows with the curriculum on, each env on the other
    row than it was built on: the level's wall boxes in the contact."""
    env = Go1Env(GateRowsCfg, num_envs=2, seed=0, device="cpu")
    assert env.curriculum
    np.testing.assert_array_equal(env.env_rows, rec["gate-rows/env_rows"])
    np.testing.assert_array_equal(env.grid_env_origins.numpy(), rec["gate-rows/grid_env_origins"])
    out, obs, done = _step(env, rec, "gate-rows/step")
    assert not done.any()
    levels = out.terrain_levels.numpy()
    np.testing.assert_array_equal(levels, 1 - env.env_rows)
    _compare_agents(rec, "gate-rows/step", out)
    np.testing.assert_allclose(obs.base_pos.numpy(), rec["gate-rows/step/base_pos"],
                               atol=TOLS["pos"])
    # the contact's boxes are those of each env's level
    boxes = env._terrain_for(out.terrain_levels).boxes
    assert torch.equal(boxes, env.grid_boxes[torch.as_tensor(levels, dtype=torch.int64),
                                             env.env_cols_j])


def test_origins_static_without_curriculum():
    env = Go1Env(T.Go1GateCfg, num_envs=2, seed=0, device="cpu")
    assert not env.curriculum
    eo, ao = env._origins_for(torch.tensor([5, 7], dtype=torch.int32))
    assert eo is env.env_origins and ao is env.agent_origins
    assert env._terrain_for(torch.zeros(2, dtype=torch.int32)) is env.terrain
