"""The port's onboard camera (render/onboard.py, Go1Env._render_cameras) and
the top-down renderer against the JAX package.

- The five unit cases of tests/test_camera.py at its own bounds: 1e-5 m,
  0.06 m for the heightfield march against the plane.
- Depth and RGB images from equal state against the JAX package's
  `_observations`, recorded in tests/goldens/torch_camera.npz by
  tools/make_torch_goldens.py: go1gate after its reset and in contact,
  go1sheep-easy (the NPC's impostor), go1gate's track with perlin ground
  noise (the heightfield march) and go1gate on two rows with the curriculum
  on (each env's boxes and origins of its level). Bounds: depth 1e-4 m, RGB
  1e-4.
- tests/test_camera.py's env-integration assertions on the port, a batch
  of cameras against each camera alone, a Legacy heightfield (no wall
  boxes), and the top-down renderer with `evaluate --video`.
"""
import os

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs import tasks as T
from mqe_tpu_torch.envs.config import Go1Cfg
from mqe_tpu_torch.envs.go1_env import Go1Env
from mqe_tpu_torch.envs.registry import make_mqe_env
from mqe_tpu_torch.render import onboard
from mqe_tpu_torch.utils.convert import env_state_from_numpy
from test_torch_env import _tree

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "torch_camera.npz")
DEPTH_TOL = 1e-4   # m
RGB_TOL = 1e-4
NUM_ENVS = 2


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _cam_cfg(base, perlin=False, rows=None):
    """A task's config with the depth and RGB camera on, optionally perlin
    ground noise or `rows` rows with the curriculum on (the recorder's
    `_gate_rows_cfg`)."""
    class Cfg(base):
        class terrain(base.terrain):
            if rows is not None:
                num_rows = rows
                curriculum = True
            BarrierTrack_kwargs = dict(base.terrain.BarrierTrack_kwargs, add_perlin_noise=perlin)

        class obs(base.obs):
            class cfgs(base.obs.cfgs):
                depth_image = True
                rgb_image = True

    return Cfg


# ---------------------------------------------------------------------------
# the ray caster's units (tests/test_camera.py)
# ---------------------------------------------------------------------------

def test_camera_rays_geometry():
    rays = onboard.camera_rays((16, 16), 90.0)
    assert rays.shape == (16, 16, 3)
    np.testing.assert_allclose(np.linalg.norm(rays, axis=-1), 1.0, atol=1e-6)
    assert rays[8, 8, 0] > 0.95
    assert rays[8, 0, 1] > 0.3
    assert rays[0, 8, 2] > 0.3


def test_ray_plane_depth():
    o = _t([0.0, 0.0, 1.0])
    d = _t([[1.0, 0.0, -1.0]]) / np.sqrt(2.0)
    depth, _ = onboard.render(o, d, torch.zeros((1, 7)), torch.zeros((0, 5)), far=10.0,
                              flat_height=0.0)
    np.testing.assert_allclose(float(depth[0]), np.sqrt(2.0), atol=1e-5)


def test_ray_box_hit_and_normal_shading():
    o = _t([0.0, 0.0, 0.5])
    d = _t([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    boxes = _t([[3.0, 0.0, 0.5, 0.5, 0.5, 0.5, 1.0]])
    depth, rgb = onboard.render(o, d, boxes, torch.zeros((0, 5)), far=10.0, flat_height=-1.0,
                                rgb=True)
    np.testing.assert_allclose(float(depth[0]), 2.5, atol=1e-5)
    assert float(depth[1]) == 10.0
    np.testing.assert_allclose(rgb[1].numpy(), onboard.ALBEDO_SKY, atol=1e-5)
    assert float(rgb[0, 0]) > float(rgb[0, 2])


def test_ray_sphere_depth():
    o = torch.zeros(3)
    d = _t([[1.0, 0.0, 0.0]])
    spheres = _t([[2.0, 0.0, 0.0, 0.5, 1.0]])
    depth, _ = onboard.render(o, d, torch.zeros((1, 7)), spheres, far=10.0, flat_height=-5.0)
    np.testing.assert_allclose(float(depth[0]), 1.5, atol=1e-5)
    off = spheres.clone()
    off[0, 4] = 0.0
    depth2, _ = onboard.render(o, d, torch.zeros((1, 7)), off, far=10.0, flat_height=-5.0)
    assert float(depth2[0]) == 10.0


def test_ray_heightfield_matches_plane():
    o = _t([1.0, 1.0, 0.8])
    d = _t(onboard.camera_rays((4, 4), 90.0).reshape(-1, 3))
    kw = dict(far=5.0, hf=torch.full((64, 64), 0.2), hf_origin=_t([-2.0, -2.0]), hf_scale=0.1)
    depth_hf, _ = onboard.render(o, d, torch.zeros((1, 7)), torch.zeros((0, 5)),
                                 flat_height=None, **kw)
    depth_pl, _ = onboard.render(o, d, torch.zeros((1, 7)), torch.zeros((0, 5)),
                                 flat_height=0.2, **kw)
    hit = depth_pl.numpy() < 5.0
    np.testing.assert_allclose(depth_hf.numpy()[hit], depth_pl.numpy()[hit], atol=0.06)


def test_batch_of_cameras_matches_each_camera_alone():
    """`render` over an (E, A) batch gives each camera's image as a call
    for that camera alone does (the JAX package vmaps one camera)."""
    rng = np.random.RandomState(0)
    E, A, R = 2, 3, 5
    o = _t(rng.uniform(-1, 1, (E, A, 3)) + [0, 0, 1.0])
    d = torch.nn.functional.normalize(_t(rng.randn(E, A, R, 3)), dim=-1)
    boxes = _t(np.concatenate([rng.uniform(-2, 2, (E, 1, 4, 3)), rng.uniform(0.2, 1, (E, 1, 4, 3)),
                               (rng.rand(E, 1, 4, 1) > 0.2)], -1))
    sph = _t(np.concatenate([rng.uniform(-2, 2, (E, A, 3, 3)), rng.uniform(0.2, 0.5, (E, A, 3, 1)),
                             (rng.rand(E, A, 3, 1) > 0.3)], -1))
    hf = _t(rng.uniform(-0.2, 0.2, (40, 40)))
    for flat in (0.0, None):
        kw = dict(far=4.0, flat_height=flat, hf=hf, hf_origin=_t([-2.0, -2.0]), hf_scale=0.1,
                  rgb=True)
        depth, rgb = onboard.render(o, d, boxes, sph, **kw)
        for e in range(E):
            for a in range(A):
                d1, c1 = onboard.render(o[e, a], d[e, a], boxes[e, 0], sph[e, a], **kw)
                assert torch.equal(depth[e, a], d1) and torch.equal(rgb[e, a], c1)


# ---------------------------------------------------------------------------
# the camera in the env, against the JAX package's recorded images
# ---------------------------------------------------------------------------

CASES = {
    "gate/post-reset": ("go1gate", lambda: _cam_cfg(T.Go1GateCfg)),
    "gate/in-contact": ("go1gate", lambda: _cam_cfg(T.Go1GateCfg)),
    "sheep/in-contact": ("go1sheep-easy", lambda: _cam_cfg(T.SingleSheepCfg)),
    "perlin-gate": ("go1gate", lambda: _cam_cfg(T.Go1GateCfg, perlin=True)),
    "gate-rows": (None, lambda: _cam_cfg(T.Go1GateCfg, rows=2)),
}


@pytest.fixture(scope="module")
def rec():
    with np.load(GOLDEN) as f:
        return dict(f)


@pytest.mark.parametrize("case", list(CASES))
def test_camera_images_match_jax(rec, case):
    task, cfg = CASES[case]
    if task is None:
        env = Go1Env(cfg(), num_envs=NUM_ENVS, seed=0, device="cpu")
        assert env.curriculum
    else:
        env = make_mqe_env(task, num_envs=NUM_ENVS, seed=0, device="cpu",
                           custom_cfg=lambda _c: cfg())[0].env
    assert (env.scene.flat_height is None) == (case == "perlin-gate")
    state = env_state_from_numpy(_tree(rec, f"{case}/state"), device="cpu")
    ob = env._observations(state)
    depth_j, rgb_j = rec[f"{case}/depth"], rec[f"{case}/rgb"]
    assert tuple(ob.depth_image.shape) == depth_j.shape
    assert tuple(ob.rgb_image.shape) == rgb_j.shape
    dd = float(np.abs(ob.depth_image.numpy() - depth_j).max())
    dc = float(np.abs(ob.rgb_image.numpy() - rgb_j).max())
    assert dd <= DEPTH_TOL, f"depth: max diff {dd:.3e}"
    assert dc <= RGB_TOL, f"rgb: max diff {dc:.3e}"
    # the images see something: ground, walls or impostors, and sky
    assert (depth_j < env.cam_far).any() and (depth_j >= env.cam_far - 1e-6).any()


def test_env_depth_camera_integration():
    """tests/test_camera.py::test_env_depth_camera_integration on the port."""
    wrap, _ = make_mqe_env("go1gate", num_envs=2, seed=0, device="cpu",
                           custom_cfg=lambda _c: _cam_cfg(T.Go1GateCfg))
    ts, _ = wrap.reset()
    ob = wrap.env._observations(ts.env)
    E, A = 2, 2
    assert ob.depth_image.shape == (E, A, 16, 16)
    assert ob.rgb_image.shape == (E, A, 16, 16, 3)
    d = ob.depth_image.numpy()
    far = wrap.env.cam_far
    assert np.isfinite(d).all() and (d > 0).all() and (d <= far).all()
    assert d[:, :, -1, :].mean() < d[:, :, 0, :].mean()
    assert (d[:, :, 0, :] > 0.9 * far).mean() > 0.5
    rgb = ob.rgb_image.numpy()
    assert (rgb >= 0).all() and (rgb <= 1).all()
    assert (d > 0.05).all()


def test_depth_only_camera_in_a_step():
    """With depth on and RGB off, a step's observation carries the depth
    image and no RGB image."""
    class Cfg(T.Go1GateCfg):
        class obs(T.Go1GateCfg.obs):
            class cfgs(T.Go1GateCfg.obs.cfgs):
                depth_image = True

    env = Go1Env(Cfg, num_envs=2, seed=0, device="cpu")
    state, _ = env.reset()
    _, ob, _, _ = env.step(state, torch.zeros((2, 2, 3)))
    assert ob.depth_image.shape == (2, 2, 16, 16) and ob.rgb_image is None
    assert torch.isfinite(ob.depth_image).all()


def test_legacy_heightfield_camera_without_boxes():
    """A Legacy heightfield has no wall boxes: the port's cameras render
    over it (the JAX package's box test takes a min over the empty box
    axis and raises), and a ray that misses the ground reads far."""
    class Cfg(Go1Cfg):
        class env(Go1Cfg.env):
            num_envs = 2
            num_agents = 1
            num_npcs = 0

        class terrain(Go1Cfg.terrain):
            mesh_type = "heightfield"
            selected = "Legacy"
            num_rows = 2
            num_cols = 2
            curriculum = True

        class obs(Go1Cfg.obs):
            class cfgs(Go1Cfg.obs.cfgs):
                depth_image = True

    env = Go1Env(Cfg, num_envs=2, seed=0, device="cpu")
    assert env.env_boxes.shape[1] == 0 and env.grid_boxes.shape[2] == 0
    state, ob = env.reset()
    assert ob.depth_image.shape == (2, 1, 16, 16)
    d = ob.depth_image.numpy()
    assert np.isfinite(d).all() and (d <= env.cam_far).all()
    assert (d[:, :, 0, :] >= env.cam_far - 1e-6).any()   # the top rows see sky


def test_topdown_frame_and_evaluate_video(tmp_path):
    """The top-down renderer draws env 0 from the card's or the CPU's
    tensors, and `evaluate --video` writes the GIF."""
    from PIL import Image

    from mqe_tpu_torch.learn import evaluate
    from mqe_tpu_torch.render.topdown import TopDownRenderer

    wrap, _ = make_mqe_env("go1pushbox", num_envs=2, seed=0, device="cpu")
    ts, _ = wrap.reset()
    frame = TopDownRenderer(wrap.env).render(ts.env, env_idx=1)
    assert frame.dtype == np.uint8 and frame.ndim == 3 and frame.shape[2] == 3
    assert frame.std() > 0
    out = tmp_path / "eval.gif"
    rec = evaluate.main(["--task", "go1gate", "--num-envs", "2", "--max-steps", "3",
                         "--video", str(out), "--cpu"])
    assert np.isfinite(rec["mean_return"])
    with Image.open(out) as gif:
        assert gif.n_frames == 2 and gif.size[0] > 100
