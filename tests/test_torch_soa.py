"""The plain dynamics of the port (mqe_tpu_torch.physics.soa) against JAX's.

`step_actor` of both packages on the inputs of tests/test_pallas_step.py
(go1 with payload and com shift; go1 with a per-body wrench; the ball, nq 0;
the seesaw with a welded base), at its six tolerances. The JAX side runs op
by op (no jit), which keeps the file to seconds.

The `cuda` cases hold the CUDA kernels against their plain versions on the
same inputs (the step kernel on the cases above, the sphere-FK kernel on the
inputs of `test_fk_matches_jax` at its bound) and run only on a card. The machine with the card has no JAX, so JAX
is imported inside the JAX cases only; there they run with
`python -m pytest --noconftest tests/test_torch_soa.py -m cuda`.
"""
import numpy as np
import pytest
import torch

from mqe_tpu_torch.physics import fused_step
from mqe_tpu_torch.physics import soa
from mqe_tpu_torch.physics.model import go1_model, load_model

torch.set_num_threads(1)

NAMES = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
TOLS = (1e-6, 1e-6, 1e-5, 1e-5, 1e-6, 1e-4)  # tests/test_pallas_step.py


CASE_IDS = ("go1-payload-comshift", "go1-extra-wrench", "ball-root_free=True",
            "seesaw-root_free=False")


def _inputs(case_id, xp, fk):
    """(model name, positional args, keyword args) of one case, drawn as
    tests/test_pallas_step.py draws them; `xp(array)` makes a float32 array
    of the package under test and `fk` is its soa.fk_spheres."""
    if case_id.startswith("go1"):
        name, m = "go1", go1_model()
        B, seed = (100, 0) if case_id == "go1-payload-comshift" else (37, 3)
        rng = np.random.RandomState(seed)   # _rand_state(m, B, seed)
        pos = xp(rng.randn(B, 3) * 0.1 + np.array([0, 0, 0.35]))
        qt = rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0])
        quat = xp(qt / np.linalg.norm(qt, axis=1, keepdims=True))
        lv, av = xp(rng.randn(B, 3) * 0.3), xp(rng.randn(B, 3) * 0.3)
        q, qd = xp(rng.randn(B, m.nq) * 0.2), xp(rng.randn(B, m.nq) * 0.5)
        tau = xp(rng.randn(B, m.nq) * 2.0)
        sf = xp(rng.randn(B, len(m.sph_tags), 3) * 5.0)
        payload, cshift = xp(rng.rand(B) * 2), xp(rng.randn(B, 3) * 0.01)
        if case_id == "go1-payload-comshift":
            kwargs = dict(payload=payload, com_shift=cshift)
        else:
            kwargs = dict(extra_wrench=xp(np.random.RandomState(7).randn(37, m.nb, 6) * 3.0))
        root_free = None
    else:
        name, rf = case_id.split("-root_free=")
        m = _torch_model(name)
        B = 13
        rng = np.random.RandomState(11)   # test_pallas_step_npc_models_match_soa
        pos = xp(rng.randn(B, 3) * 0.1 + np.array([0, 0, 1.0]))
        qt = rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0])
        quat = xp(qt / np.linalg.norm(qt, axis=1, keepdims=True))
        lv, av = xp(rng.randn(B, 3) * 0.3), xp(rng.randn(B, 3) * 0.3)
        q, qd = xp(rng.randn(B, m.nq) * 0.1), xp(rng.randn(B, m.nq) * 0.3)
        tau = xp(np.zeros((B, m.nq)))
        sf = xp(rng.randn(B, len(m.sph_tags), 3) * 2.0)
        kwargs = dict(extra_wrench=xp(rng.randn(B, m.nb, 6) * 1.5), root_free=rf == "True")
    sx, _ = fk(name, pos, quat, lv, av, q, qd)
    return name, (pos, quat, lv, av, q, qd, tau, sf, sx), kwargs


def _torch_model(name):
    return go1_model() if name == "go1" else load_model(name, root_free=True)


def _torch_inputs(case_id, device="cpu"):
    xp = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    fk = lambda name, *a: soa.fk_spheres(_torch_model(name), *a)
    name, args, kwargs = _inputs(case_id, xp, fk)
    return _torch_model(name), args, kwargs


def _torch(x):
    return torch.from_numpy(np.array(x)) if not isinstance(x, bool) else x


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_step_actor_matches_jax(case_id):
    import jax.numpy as jnp
    from mqe_tpu.physics import soa as jsoa
    from mqe_tpu.physics.model import go1_model as jax_go1, load_model as jax_load

    jmodel = lambda name: jax_go1() if name == "go1" else jax_load(name, root_free=True)
    xp = lambda a: jnp.asarray(a, dtype=jnp.float32)
    fk = lambda name, *a: jsoa.fk_spheres(jmodel(name), *a)
    name, args, kwargs = _inputs(case_id, xp, fk)
    if name == "go1":  # the very inputs of tests/test_pallas_step.py::_rand_state
        from test_pallas_step import _rand_state

        B, seed = (100, 0) if case_id == "go1-payload-comshift" else (37, 3)
        drawn = _rand_state(jmodel(name), B, seed)
        for a, b in zip(drawn[:9], args):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        if "payload" in kwargs:
            np.testing.assert_array_equal(np.asarray(kwargs["payload"]), np.asarray(drawn[9]))
            np.testing.assert_array_equal(np.asarray(kwargs["com_shift"]), np.asarray(drawn[10]))
    ref = jsoa.step_actor(jmodel(name), *args, **kwargs)
    out = soa.step_actor(_torch_model(name), *(_torch(a) for a in args),
                         **{k: _torch(v) for k, v in kwargs.items()})
    for n, a, b, tol in zip(NAMES, ref, out, TOLS):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), n
        if a.size:
            diff = np.abs(a - b.numpy()).max()
            assert diff <= tol, f"{n}: max diff {diff:.3e} > {tol:.0e}"


def test_fk_matches_jax():
    """fk_spheres and fk_full (the contact stage's kinematics) on go1."""
    import jax.numpy as jnp
    from mqe_tpu.physics import soa as jsoa
    from mqe_tpu.physics.model import go1_model as jax_go1

    rng = np.random.RandomState(5)
    arrs = [rng.randn(16, 3) * 0.1, rng.randn(16, 4) * 0.05 + np.array([0, 0, 0, 1.0]),
            rng.randn(16, 3) * 0.3, rng.randn(16, 3) * 0.3, rng.randn(16, 12) * 0.2,
            rng.randn(16, 12) * 0.5]
    arrs[1] /= np.linalg.norm(arrs[1], axis=1, keepdims=True)
    arrs = [a.astype(np.float32) for a in arrs]
    jargs = [jnp.asarray(a) for a in arrs]
    targs = [torch.from_numpy(a) for a in arrs]
    jm, tm = jax_go1(), go1_model()
    for a, b in zip(jsoa.fk_spheres(jm, *jargs), soa.fk_spheres(tm, *targs)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    for a, b in zip(jsoa.fk_full(jm, *jargs), soa.fk_full(tm, *targs)):
        assert np.asarray(a).shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_kernel_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors the kernel's wrapper is the plain version, and launches nothing."""
    tm, targs, tkw = _torch_inputs("go1-payload-comshift")
    before = fused_step.step_actor_kernel.launches
    out = fused_step.step_actor_kernel(tm, *targs, **tkw)
    ref = soa.step_actor(tm, *targs, **tkw)
    assert fused_step.step_actor_kernel.launches == before
    for a, b in zip(ref, out):
        assert torch.equal(a, b)
    # a robot gets the smallest power of two of lanes that holds its bodies
    assert [fused_step.lanes_log2(_torch_model(n)) for n in ("go1", "seesaw", "ball")] == [4, 1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("case_id", CASE_IDS)
def test_kernel_matches_plain_on_card(case_id):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tm, targs, tkw = _torch_inputs(case_id, device="cuda")
    ref = soa.step_actor(tm, *targs, **tkw)
    before = fused_step.step_actor_kernel.launches
    out = fused_step.step_actor_kernel(tm, *targs, **tkw)
    torch.cuda.synchronize()
    assert fused_step.step_actor_kernel.launches == before + 1
    for n, a, b, tol in zip(NAMES, ref, out, TOLS):
        assert a.shape == b.shape, n
        if a.numel():
            diff = float((a - b).abs().max())
            assert diff <= tol, f"{n}: max diff {diff:.3e} > {tol:.0e}"


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", [("go1", 16), ("go1", 8192), ("seesaw", 37), ("ball", 37)])
def test_fk_kernel_matches_plain_on_card(name, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    m = _torch_model(name)
    rng = np.random.RandomState(5)   # the draws of test_fk_matches_jax
    arrs = [rng.randn(B, 3) * 0.1, rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0]),
            rng.randn(B, 3) * 0.3, rng.randn(B, 3) * 0.3, rng.randn(B, m.nq) * 0.2,
            rng.randn(B, m.nq) * 0.5]
    arrs[1] /= np.linalg.norm(arrs[1], axis=1, keepdims=True)
    args = [torch.as_tensor(a.astype(np.float32), device="cuda") for a in arrs]
    ref = soa.fk_spheres(m, *args)
    before = fused_step.fk_spheres_kernel.launches
    out = fused_step.fk_spheres_kernel(m, *args)
    torch.cuda.synchronize()
    assert fused_step.fk_spheres_kernel.launches == before + 1
    for a, b in zip(ref, out):
        assert a.shape == b.shape
        diff = float((a - b).abs().max())
        assert diff <= 1e-6, f"max diff {diff:.3e} > 1e-06"
