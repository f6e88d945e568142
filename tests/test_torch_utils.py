"""The port's helpers that need no JAX: the kernel's model table, the build's
compiler lookup, the random-draw helper, the op counter, the state map, and
the card as the default device of the entry points that carry nets and
state across."""
import os

import numpy as np
import pytest
import torch

from mqe_tpu_torch.physics import model as M
from mqe_tpu_torch.utils import build
from mqe_tpu_torch.utils.convert import env_state_to
from mqe_tpu_torch.utils.opcount import count_ops
from mqe_tpu_torch.utils.random import Draws
from mqe_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["go1", "ball", "seesaw", "cylinder"])
def test_model_table_holds_the_model(name):
    m = M.load_model(name)
    t = M.model_tables(m)
    assert t.dtype == np.float32 and t.shape == (M.TABLE_SIZE,)
    off = M.TABLE_OFFSETS
    nb, nq, ns = m.nb, m.nq, len(m.sph_tags)
    np.testing.assert_array_equal(t[off["parent"]:off["parent"] + nb], m.parent)
    np.testing.assert_array_equal(t[off["joint_type"]:off["joint_type"] + nb], m.joint_type)
    np.testing.assert_allclose(t[off["joint_rot"] + 9:off["joint_rot"] + 9 * nb],
                               m.joint_rot[1:].reshape(-1), rtol=1e-7)
    np.testing.assert_allclose(t[off["spatial_inertia"]:off["spatial_inertia"] + 36 * nb],
                               m.spatial_inertia.reshape(-1), rtol=1e-6)
    np.testing.assert_allclose(t[off["q_lower"]:off["q_lower"] + nq], m.q_lower, rtol=1e-7)
    np.testing.assert_array_equal(t[off["sph_body"]:off["sph_body"] + ns], m.sph_body)
    np.testing.assert_allclose(t[off["sph_pos"]:off["sph_pos"] + 3 * ns],
                               m.sph_pos.reshape(-1), rtol=1e-7)
    # the offsets the CUDA source hard-codes
    assert (M.TABLE_SIZE, M.MAX_NB, M.MAX_NS) == (1664, 16, 64)


def test_model_table_rejects_a_model_too_large():
    m = M.load_model("go1")
    big = M.BodyModel(**{**m.__dict__, "nb": M.MAX_NB + 1})
    with pytest.raises(ValueError):
        M.model_tables(big)


def test_find_nvcc_raises_without_a_compiler(monkeypatch, tmp_path):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_draws_take_given_values_and_else_the_generator():
    g = torch.Generator().manual_seed(3)
    d = Draws(g, {"a": np.full((2, 3), 0.25, np.float32)})
    assert torch.equal(d.uniform("a", (2, 3), -1, 1, "cpu"), torch.full((2, 3), 0.25))
    with pytest.raises(ValueError):
        d.uniform("a", (3, 2), -1, 1, "cpu")
    u = d.uniform("b", (1000,), -2.0, 3.0, "cpu")
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0 and float(u.std()) > 1.0
    again = Draws(torch.Generator().manual_seed(3)).uniform("b", (1000,), -2.0, 3.0, "cpu")
    assert torch.equal(u, again)
    assert d.state("fresh", lambda: "built") == "built"
    assert Draws(g, {"fresh": "given"}).state("fresh", lambda: "built") == "given"


def test_count_ops_counts_elementwise_work():
    a, b = torch.ones(10), torch.ones(10)
    assert count_ops(lambda: a * b + a) == 20
    assert count_ops(lambda: torch.stack([a, b]).reshape(2, 10)[0]) == 0
    assert count_ops(lambda: torch.ones(3, 4) @ torch.ones(4, 5)) == 2 * 4 * 15


def test_tree_map_and_env_state_to():
    from mqe_tpu_torch.envs.registry import make_mqe_env

    wrap, _ = make_mqe_env("go1gate", num_envs=3, seed=0, device="cpu")
    ts, obs = wrap.reset()
    assert tuple(obs.shape) == (3, 2, wrap.obs_dim)
    moved = env_state_to(ts, "cpu")
    flags = []
    tree_map(lambda x, y: flags.append(torch.equal(x, y)), ts, moved)
    assert len(flags) > 20 and all(flags)
    assert moved.env.episode_length.dtype == torch.int32
    assert moved.env.done.dtype == torch.bool


def test_other_tasks_name_their_roadmap_item():
    """A config the port once refused, go1sheep-easy with an onboard
    camera, builds and returns depth images of the JAX package's shape
    (E, A, H, W) and no RGB image (`rgb_image` off)."""
    from mqe_tpu_torch.envs.registry import make_mqe_env

    def camera(cfg):
        class cfgs(cfg.obs.cfgs):
            depth_image = True

        class obs(cfg.obs):
            pass

        obs.cfgs = cfgs
        return type("CameraCfg", (cfg,), {"obs": obs})

    wrap, _ = make_mqe_env("go1sheep-easy", num_envs=2, device="cpu", custom_cfg=camera)
    ts, _ = wrap.reset()
    ob = wrap.env._observations(ts.env)
    H, W = wrap.env.cfg.sensor.forward_camera.resolution
    assert tuple(ob.depth_image.shape) == (2, wrap.num_agents, H, W)
    assert ob.rgb_image is None
    far = wrap.env.cam_far
    assert bool(torch.isfinite(ob.depth_image).all()) and float(ob.depth_image.max()) <= far


def test_entry_points_default_to_the_card():
    """The functions that build the port's nets and carry state across from
    the JAX package put them on the card unless the caller names a device."""
    import inspect

    from mqe_tpu_torch.control import nets
    from mqe_tpu_torch.utils import convert

    for fn in (convert.mlp_from_numpy, convert.env_state_from_numpy, nets.ActuatorNet,
               nets.load_body_policy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
