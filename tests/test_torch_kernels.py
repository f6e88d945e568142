"""The kernels' wrappers and tables on the CPU, and the env config the port
builds as the JAX package does.

- The tree schedule of the kernels' model table (each body's level and its
  children in descending index) against `parent`, for every body model.
- `fk_spheres_kernel` and `step_actor_kernel` on CPU tensors are their plain
  versions and launch nothing; `substep_batch` runs through both.
- Both wrappers check their inputs on every device: they raise on a device
  that is neither CPU nor CUDA, and on input of another dtype, shape or
  layout than the kernels take.
- The terrain curriculum: on a terrain of one row the JAX package builds with
  it off, and so does the port; with more rows both turn it on, with the same
  grid of origins and boxes. Both envs are built, not stepped.
"""
import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.physics import fused_step, scene, soa
from mqe_tpu_torch.physics import model as M

torch.set_num_threads(1)

MODELS = ("go1", "ball", "box", "cylinder", "door", "rotation_door", "seesaw", "sheep")


def _fk_args(m, B=16, seed=5):
    """Inputs drawn as tests/test_torch_soa.py::test_fk_matches_jax draws them."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, 3) * 0.1, rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0]),
            rng.randn(B, 3) * 0.3, rng.randn(B, 3) * 0.3, rng.randn(B, m.nq) * 0.2,
            rng.randn(B, m.nq) * 0.5]
    arrs[1] /= np.linalg.norm(arrs[1], axis=1, keepdims=True)
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


def _step_args(m, B=16, seed=0):
    rng = np.random.RandomState(seed)
    fk = _fk_args(m, B, seed)
    ns = len(m.sph_tags)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    tau, sf = f32(rng.randn(B, m.nq) * 2.0), f32(rng.randn(B, ns, 3) * 5.0)
    sx, _ = soa.fk_spheres(m, *fk)
    kw = dict(payload=f32(rng.rand(B)), com_shift=f32(rng.randn(B, 3) * 0.01))
    return [*fk, tau, sf, sx], kw


@pytest.mark.parametrize("name", MODELS)
def test_tree_schedule_follows_parent(name):
    m = M.load_model(name)
    level, children = M.tree_schedule(m)
    assert level[0] == 0 and len(children) == m.nb
    for i in range(1, m.nb):
        par = int(m.parent[i])
        assert level[i] == level[par] + 1
        assert i in children[par]
    for i, ch in enumerate(children):
        assert ch == sorted((c for c in range(1, m.nb) if m.parent[c] == i), reverse=True)
    # the model table holds the same schedule, at the offsets csrc/fused_step.cu reads
    t, off = M.model_tables(m), M.TABLE_OFFSETS
    np.testing.assert_array_equal(t[off["level"]:off["level"] + m.nb], level)
    np.testing.assert_array_equal(t[off["num_children"]:off["num_children"] + m.nb],
                                  [len(c) for c in children])
    rows = t[off["children"]:off["children"] + M.MAX_NB * M.MAX_NB].reshape(M.MAX_NB, M.MAX_NB)
    for i, ch in enumerate(children):
        np.testing.assert_array_equal(rows[i, :len(ch)], ch)
        assert (rows[i, len(ch):] == -1).all()


def test_tree_schedule_rejects_a_body_before_its_parent():
    m = M.load_model("cylinder")
    bad = M.BodyModel(**{**m.__dict__, "parent": np.array([-1, 1], dtype=np.int32)})
    with pytest.raises(ValueError, match="must follow their parents"):
        M.tree_schedule(bad)


@pytest.mark.parametrize("name", ["go1", "seesaw", "ball"])
def test_fk_spheres_kernel_on_cpu_is_the_plain_version(name):
    m = M.load_model(name)
    args = _fk_args(m)
    before = fused_step.fk_spheres_kernel.launches
    out = fused_step.fk_spheres_kernel(m, *args)
    assert fused_step.fk_spheres_kernel.launches == before
    for a, b in zip(soa.fk_spheres(m, *args), out):
        assert b.shape == (16, len(m.sph_tags), 3)
        assert torch.equal(a, b)


def _call(which, m, args, kw):
    if which == "fk_spheres":
        return fused_step.fk_spheres_kernel(m, *args[:6])
    return fused_step.step_actor_kernel(m, *args, **kw)


@pytest.mark.parametrize("which", ["fk_spheres", "step_actor"])
def test_wrappers_raise_on_another_device(which):
    m = M.go1_model()
    args, kw = _step_args(m)
    to = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _call(which, m, [to(a) for a in args], {k: to(v) for k, v in kw.items()})


# (input, how it is spoiled): a strided view, a wrong shape, float64
BAD = [("quat", "strided"), ("q", "shape"), ("pos", "float64"),
       ("sph_x", "strided"), ("payload", "shape"), ("tau", "float64")]
POS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "tau", "sph_force", "sph_x")


@pytest.mark.parametrize("which,field,spoil",
                         [("fk_spheres", f, s) for f, s in BAD[:3]]
                         + [("step_actor", f, s) for f, s in BAD])
def test_wrappers_raise_on_input_the_kernel_does_not_take(which, field, spoil):
    m = M.go1_model()
    args, kw = _step_args(m)
    t = args[POS.index(field)] if field in POS else kw[field]
    bad = {"strided": lambda x: torch.stack([x, x], dim=-1)[..., 0],
           "shape": lambda x: x[:-1],
           "float64": lambda x: x.double()}[spoil](t)
    assert torch.equal(bad.float(), t) or spoil == "shape"
    if field in POS:
        args[POS.index(field)] = bad
    else:
        kw[field] = bad
    err = TypeError if spoil == "float64" else ValueError
    with pytest.raises(err, match=field):
        _call(which, m, args, kw)


def test_substep_batch_runs_both_kernel_wrappers(monkeypatch):
    """The scene's substep goes through the two wrappers, once each, with the
    flat (E*A, ...) contiguous tensors the kernels take."""
    wrap, _ = make_torch_env("go1gate", num_envs=2, seed=0, device="cpu")
    ts, _ = wrap.reset()
    calls = []
    for name in ("fk_spheres_kernel", "step_actor_kernel"):
        real = getattr(scene, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(scene, name, spy)
    env = wrap.env
    tau = torch.zeros((2, 2, 12))
    scene.substep_batch(env.scene, env.terrain, ts.env.phys, tau, ts.env.dr, 0.0025)
    assert calls == ["fk_spheres_kernel", "step_actor_kernel"]


def _one_row_or_more(base, rows):
    class Cfg(base):
        class terrain(base.terrain):
            curriculum = True
            num_rows = rows

    return Cfg


@pytest.mark.parametrize("rows", [1, 2], ids=["one-row-builds", "two-rows-refused"])
def test_terrain_curriculum_as_the_jax_package_decides(rows):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mqe_tpu.envs.registry import make_mqe_env as make_jax_env
    from mqe_tpu.envs.tasks import Go1GateCfg as JaxCfg
    from mqe_tpu_torch.envs.tasks import Go1GateCfg as TorchCfg

    jwrap, _ = make_jax_env("go1gate", num_envs=2, seed=0,
                            custom_cfg=lambda c: _one_row_or_more(JaxCfg, rows))
    jenv = jwrap.env
    assert jenv.curriculum == (rows > 1)
    custom = lambda c: _one_row_or_more(TorchCfg, rows)
    twrap, _ = make_torch_env("go1gate", num_envs=2, seed=0, device="cpu", custom_cfg=custom)
    tenv = twrap.env
    assert tenv.curriculum == (rows > 1)
    if rows > 1:
        # two rows build with the curriculum on, the grid as JAX's
        assert tenv.num_levels == jenv.num_levels and tenv.curr_up_dist == jenv.curr_up_dist
        np.testing.assert_array_equal(tenv.grid_env_origins.numpy(),
                                      np.asarray(jenv.grid_env_origins))
        np.testing.assert_array_equal(tenv.grid_agent_origins.numpy(),
                                      np.asarray(jenv.grid_agent_origins))
        np.testing.assert_array_equal(tenv.grid_boxes.numpy(), np.asarray(jenv.grid_boxes))
        np.testing.assert_array_equal(tenv.env_cols_j.numpy(), np.asarray(jenv.env_cols_j))
    np.testing.assert_array_equal(tenv.env_origins.numpy(), np.asarray(jenv.env_origins))
    np.testing.assert_array_equal(tenv.agent_origins.numpy(), np.asarray(jenv.agent_origins))
    ts, _ = twrap.reset()
    # the JAX reset takes its terrain levels from env_rows
    np.testing.assert_array_equal(ts.env.terrain_levels.numpy(), jenv.env_rows)
