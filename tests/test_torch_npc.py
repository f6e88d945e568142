"""NPC physics of the port (mqe_tpu_torch) against the JAX package, and the
full-FK kernel's wrapper.

- `contact.sphere_vertical_cylinder` on points that take every branch (side,
  cap, edge, inside), with and without a cylinder velocity.
- `scene._npc_prim_force` for each primitive kind: a ball (sphere), the box,
  the cylinder model (a cylinder on a small box), over 2 envs, from spheres
  drawn around the NPC so that many overlap it.
- `scene.substep_batch` with NPCs at 2 envs from hand-placed states: the
  go1pushbox scene (robots pressed against the box, the box on the ground),
  the go1seesaw scene (a robot on the plank, one against the pivot cylinder,
  one on the platform) and two balls on the pushbox terrain (NPC-NPC
  pairs). The states and JAX's substep from them (op by op, no jit) are the
  record tests/goldens/torch_npc_substep.npz, which
  tools/make_torch_goldens.py writes; the `slow`
  `test_substep_batch_with_npcs_matches_live_jax` compares with a live run.
- `fk_full_kernel` on CPU tensors is `soa.fk_full` exactly; its wrapper
  raises on input the kernel does not take; `substep_batch` runs both FK
  kernels and the step kernel twice, the NPC launch with the reaction wrench
  and the scene's `npc_root_free`.

Tolerances: tests/test_pallas_step.py's for one substep (pos, quat 1e-6, lin
and ang vel 1e-5, q 1e-6, qd 1e-4), NPC state held to the agents' bounds;
5e-4 N on forces of up to 500 N (1e-6 relative), as tests/test_torch_scene.py
has, and on the reaction wrench.

The `cuda` cases hold the kernels against their plain versions on the card,
at every NPC launch of the tasks (`NPC_LAUNCHES`).
JAX is imported inside the JAX cases only, so that on the card's machine,
which has no JAX, `python -m pytest --noconftest tests/test_torch_npc.py -m
cuda` runs them.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.physics import contact as tc
from mqe_tpu_torch.physics import fused_step, scene, soa
from mqe_tpu_torch.physics.model import load_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPC_GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_npc_substep.npz")
E = 2
NAMES = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
TOLS = (1e-6, 1e-6, 1e-5, 1e-5, 1e-6, 1e-4)   # tests/test_pallas_step.py
F_TOL = 5e-4
FK_TOL = 1e-6                                 # tests/test_torch_soa.py::test_fk_matches_jax
FK_NAMES = ("Rw", "pw", "vw", "sph_x", "sph_v")


def _cmp(a, b, tol, name=""):
    a = np.asarray(a)
    assert a.shape == tuple(b.shape), name
    diff = float(np.abs(a - b.numpy()).max()) if a.size else 0.0
    assert diff <= tol, f"{name}: max diff {diff:.3e} > {tol:.0e}"


def _fk_args(m, B, seed=5, device="cpu"):
    """NPC states drawn as tests/test_torch_soa.py::test_fk_matches_jax draws them."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, 3) * 0.1, rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0]),
            rng.randn(B, 3) * 0.3, rng.randn(B, 3) * 0.3, rng.randn(B, m.nq) * 0.2,
            rng.randn(B, m.nq) * 0.5]
    arrs[1] /= np.linalg.norm(arrs[1], axis=1, keepdims=True)
    return [torch.as_tensor(a.astype(np.float32), device=device) for a in arrs]


# ---------------------------------------------------------------------------
# contact: the vertical cylinder
# ---------------------------------------------------------------------------

def test_sphere_vertical_cylinder_matches_jax():
    import jax.numpy as jnp
    from mqe_tpu.physics import contact as jc

    rng = np.random.RandomState(4)
    n = 400
    # around a cylinder of radius 0.3 and half length 0.2 at (0.1, -0.2, 0.5):
    # radially out, above and below the caps, past the edge, and inside
    rel = rng.uniform(-1, 1, (n, 3)) * np.array([0.45, 0.45, 0.35])
    rel[:40] *= 0.5                                   # well inside
    rel[40:50, 2] = 0.0                               # on the mid plane
    pos = (rel + np.array([0.1, -0.2, 0.5])).astype(np.float32)
    vel = (rng.randn(n, 3) * 0.5).astype(np.float32)
    rad = rng.uniform(0.01, 0.08, n).astype(np.float32)
    center = np.array([0.1, -0.2, 0.5], np.float32)
    cvel = np.array([0.2, -0.1, 0.05], np.float32)
    pj = jc.ContactParams(kn=4000.0, hc_damping=3.0, v_slip=0.05, f_max=500.0)
    pt = tc.ContactParams(kn=4000.0, hc_damping=3.0, v_slip=0.05, f_max=500.0)
    for cv in (None, cvel):
        ref = jc.sphere_vertical_cylinder(
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad), jnp.asarray(center), 0.3, 0.2,
            pj, 0.8, cyl_vel=None if cv is None else jnp.asarray(cv))
        out = tc.sphere_vertical_cylinder(
            torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(rad),
            torch.from_numpy(center), 0.3, 0.2, pt, 0.8,
            cyl_vel=None if cv is None else torch.from_numpy(cv))
        touching = int((out.abs().sum(-1) > 1.0).sum())
        assert float(out.abs().max()) > 100.0 and touching > 50, touching
        _cmp(ref, out, F_TOL, "force")


# ---------------------------------------------------------------------------
# _npc_prim_force, one primitive kind at a time
# ---------------------------------------------------------------------------

PRIM_CASES = {"sphere": ("ball", 0.15), "box": ("box", 0.6), "cylinder": ("cylinder", 0.8)}


@pytest.mark.parametrize("kind", list(PRIM_CASES))
def test_npc_prim_force_matches_jax(kind):
    import jax
    import jax.numpy as jnp
    from mqe_tpu.physics import contact as jc
    from mqe_tpu.physics import scene as JS
    from mqe_tpu.physics import soa as jsoa
    from mqe_tpu.physics.model import go1_model as jax_go1, load_model as jax_load

    name, spread = PRIM_CASES[kind]
    N, A = 2, 2
    jm, tm = jax_load(name), load_model(name)
    rng = np.random.RandomState(8)
    npc_args = [a.numpy().reshape((E, N) + a.shape[1:]) for a in _fk_args(tm, E * N, seed=9)]
    npc_args[0] = npc_args[0] + np.array([[[0.0, 0.0, 0.5], [1.5, 0.0, 0.5]]], np.float32)
    flat = [a.reshape((E * N,) + a.shape[2:]) for a in npc_args]
    nRw, npw, nvw, _, _ = (np.asarray(x).reshape((E, N) + x.shape[1:])
                           for x in jsoa.fk_full(jm, *(jnp.asarray(a) for a in flat)))
    # the agents' spheres, S = A * 40, scattered around both NPCs
    go1 = jax_go1()
    S = A * len(go1.sph_tags)
    near = npc_args[0][:, rng.randint(0, N, S)]                      # (E, S, 3)
    sx = (near + rng.randn(E, S, 3) * spread).astype(np.float32)
    sv = (rng.randn(E, S, 3) * 0.5).astype(np.float32)
    sr = np.tile(go1.sph_radius, A).astype(np.float32)
    mu = np.array([0.7, 1.2], np.float32)
    params = dict(kn=4000.0, hc_damping=3.0, v_slip=0.05, f_max=500.0)

    jscene = JS.SceneModel(robot=go1, num_agents=A, npc=jm, num_npcs=N,
                           contact=jc.ContactParams(**params))
    f_j, w_j = jax.vmap(
        lambda x, v, R, p, w, m: JS._npc_prim_force(jscene, x, v, jnp.asarray(sr), R, p, w,
                                                    jscene.contact, m)
    )(jnp.asarray(sx), jnp.asarray(sv), jnp.asarray(nRw), jnp.asarray(npw), jnp.asarray(nvw),
      jnp.asarray(mu))
    tscene = scene.SceneModel(robot=load_model("go1"), num_agents=A, npc=tm, num_npcs=N,
                              contact=tc.ContactParams(**params))
    t = lambda a: torch.from_numpy(np.array(a))
    f_t, w_t = scene._npc_prim_force(tscene, t(sx), t(sv), t(sr), t(nRw), t(npw), t(nvw),
                                     tscene.contact, t(mu))
    in_contact = int((f_t.abs().sum(-1) > 1.0).sum())
    assert in_contact >= 10, f"only {in_contact} spheres touch the {kind}"
    _cmp(f_j, f_t, F_TOL, "sphere force")
    _cmp(w_j, w_t, F_TOL, "reaction wrench")


# ---------------------------------------------------------------------------
# substep_batch with NPCs, from hand-placed states
# ---------------------------------------------------------------------------

NPC_CASES = ("pushbox", "seesaw", "two-balls")


def _port_scene(rec, case):
    """(port env, port scene) of one recorded case: the task's, with its
    NPC model replaced by two of the recorded one where one is named."""
    twrap, _ = make_torch_env(str(rec[f"{case}/task"]), num_envs=E, seed=0, device="cpu")
    tenv = twrap.env
    tscene = tenv.scene
    npc_name = str(rec[f"{case}/npc"])
    if npc_name:
        tscene = dataclasses.replace(tscene, npc=load_model(npc_name), num_npcs=2)
    return tenv, tscene


def _port_state(rec, case):
    t = lambda k: torch.from_numpy(rec[f"{case}/{k}"])
    return scene.PhysState(agents=scene.ActorState(**{k: t(f"agents/{k}") for k in NAMES}),
                           npcs=scene.ActorState(**{k: t(f"npcs/{k}") for k in NAMES}))


def _substep_matches(rec, case, monkeypatch):
    tenv, tscene = _port_scene(rec, case)
    t = lambda k: torch.from_numpy(rec[f"{case}/{k}"])
    A = tscene.num_agents
    tdr = scene.DomainRand(mu_scale=t("dr/mu"), payload=t("dr/payload"), com_shift=t("dr/com"),
                           motor_strength=torch.ones((E, A, 12)))
    seen = []
    real = scene._npc_prim_force
    monkeypatch.setattr(scene, "_npc_prim_force",
                        lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    tnew, tcon = scene.substep_batch(tscene, tenv.terrain, _port_state(rec, case), t("tau"), tdr,
                                     float(rec[f"{case}/dt"]), npc_tau=t("npc_tau"))

    # the robots pushed on the NPC in both envs, and the NPCs touched something
    wrench = seen[0][1]
    assert float(wrench[0].abs().max()) > 1.0 and float(wrench[1].abs().max()) > 1.0
    assert float(tcon.npc_sphere_force.abs().max()) > 1.0 or case == "seesaw"
    for k in ("sphere_force", "npc_sphere_force", "feet_force"):
        _cmp(rec[f"{case}/contact/{k}"], getattr(tcon, k), F_TOL, k)
    for who in ("agents", "npcs"):
        for n, tol in zip(NAMES, TOLS):
            _cmp(rec[f"{case}/out/{who}/{n}"], getattr(getattr(tnew, who), n), tol, f"{who}.{n}")


@pytest.fixture(scope="module")
def npc_golden():
    with np.load(NPC_GOLDEN) as f:
        return dict(f)


@pytest.mark.parametrize("case", NPC_CASES)
def test_substep_batch_with_npcs_matches_jax(npc_golden, case, monkeypatch):
    _substep_matches(npc_golden, case, monkeypatch)


@pytest.fixture(scope="module")
def npc_live_record():
    spec = importlib.util.spec_from_file_location(
        "make_torch_goldens", os.path.join(REPO, "tools", "make_torch_goldens.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.record_npc_substep()


@pytest.mark.slow
@pytest.mark.parametrize("case", NPC_CASES)
def test_substep_batch_with_npcs_matches_live_jax(npc_live_record, case, monkeypatch):
    _substep_matches(npc_live_record, case, monkeypatch)


# ---------------------------------------------------------------------------
# the full-FK kernel's wrapper, and the kernels of the NPC substep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["box", "seesaw"])
def test_fk_full_kernel_on_cpu_is_the_plain_version(name):
    m = load_model(name, root_free=name != "seesaw")
    args = _fk_args(m, 16)
    before = fused_step.fk_full_kernel.launches
    out = fused_step.fk_full_kernel(m, *args)
    assert fused_step.fk_full_kernel.launches == before
    ns = len(m.sph_tags)
    shapes = ((16, m.nb, 3, 3), (16, m.nb, 3), (16, m.nb, 6), (16, ns, 3), (16, ns, 3))
    for a, b, shape in zip(soa.fk_full(m, *args), out, shapes):
        assert tuple(b.shape) == shape and b.is_contiguous()
        assert torch.equal(a, b)


# (input, how it is spoiled): another device, a strided view, a wrong shape, float64
FK_BAD = [("pos", "meta"), ("quat", "strided"), ("q", "shape"), ("qd", "float64")]


@pytest.mark.parametrize("field,spoil", FK_BAD)
def test_fk_full_kernel_raises_on_input_the_kernel_does_not_take(field, spoil):
    m = load_model("seesaw")
    args = _fk_args(m, 16)
    i = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd").index(field)
    if spoil == "meta":
        args = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fused_step.fk_full_kernel(m, *args)
        return
    args[i] = {"strided": lambda x: torch.stack([x, x], dim=-1)[..., 0],
               "shape": lambda x: x[:-1],
               "float64": lambda x: x.double()}[spoil](args[i])
    with pytest.raises(TypeError if spoil == "float64" else ValueError, match=field):
        fused_step.fk_full_kernel(m, *args)


@pytest.mark.parametrize("case", ["pushbox", "seesaw"])
def test_substep_batch_runs_the_npc_kernels(npc_golden, case, monkeypatch):
    """One substep with an NPC calls the sphere FK, the full FK and the step
    kernel twice: the robots, then the NPCs with the reaction wrench and the
    scene's `npc_root_free` (False for the welded seesaw, whose model is
    loaded welded too), all on flat contiguous tensors."""
    tenv, tscene = _port_scene(npc_golden, case)
    assert tscene.npc_root_free == tscene.npc.root_free == (case == "pushbox")
    state = _port_state(npc_golden, case)
    calls = []
    for name in ("fk_spheres_kernel", "fk_full_kernel", "step_actor_kernel"):
        real = getattr(scene, name)

        def spy(model, *a, _real=real, _name=name, **k):
            assert all(x.is_contiguous() for x in a)
            calls.append((_name, model.nb, k.get("root_free"), k.get("extra_wrench") is not None))
            return _real(model, *a, **k)

        monkeypatch.setattr(scene, name, spy)
    dr = scene.DomainRand(mu_scale=torch.ones(E), payload=torch.zeros(E, 2),
                          com_shift=torch.zeros(E, 2, 3), motor_strength=torch.ones(E, 2, 12))
    new, con = scene.substep_batch(tscene, tenv.terrain, state, torch.zeros(E, 2, 12), dr, 0.0025)
    nb = tscene.npc.nb
    assert calls == [("fk_spheres_kernel", 13, None, False), ("fk_full_kernel", nb, None, False),
                     ("step_actor_kernel", 13, None, False),
                     ("step_actor_kernel", nb, case == "pushbox", True)]
    assert tuple(con.npc_sphere_force.shape) == (E, 1, len(tscene.npc.sph_tags), 3)
    if case == "seesaw":  # the welded base stays where it is
        assert torch.equal(new.npcs.pos, state.npcs.pos)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# every NPC launch of the tasks, as the scene makes it: (model, root_free, B);
# the sheep's second is go1sheep-hard's 9 sheep in each of 4096 envs
NPC_LAUNCHES = [
    pytest.param("box", True, 4096, id="box"),
    pytest.param("seesaw", False, 4096, id="seesaw"),
    pytest.param("ball", True, 4096, id="ball"),
    pytest.param("cylinder", False, 4096, id="cylinder"),
    pytest.param("rotation_door", False, 4096, id="rotation_door"),
    pytest.param("door", False, 4096, id="door"),
    pytest.param("sheep", True, 4096, id="sheep"),
    pytest.param("sheep", True, 36864, id="sheep-x9"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,root_free,B", NPC_LAUNCHES)
def test_npc_launch_kernels_match_plain_on_card(name, root_free, B):
    """An NPC launch as the scene makes it, each kernel against its plain
    version: the full FK, and the step kernel with no payload, a reaction
    wrench, and for a welded model a welded root in both flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    m = load_model(name, root_free=root_free)
    args = _fk_args(m, B, device="cuda")
    ref = soa.fk_full(m, *args)
    before = fused_step.fk_full_kernel.launches
    out = fused_step.fk_full_kernel(m, *args)
    torch.cuda.synchronize()
    assert fused_step.fk_full_kernel.launches == before + 1
    for n, a, b in zip(FK_NAMES, ref, out):
        assert a.shape == b.shape, n
        diff = float((a - b).abs().max())
        assert diff <= FK_TOL, f"fk_full {n}: max diff {diff:.3e} > {FK_TOL:.0e}"

    rng = np.random.RandomState(12)
    c = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")
    ns = len(m.sph_tags)
    sx, _ = soa.fk_spheres(m, *args)
    rest = (c(rng.randn(B, m.nq) * 2.0), c(rng.randn(B, ns, 3) * 2.0), sx)
    kw = dict(extra_wrench=c(rng.randn(B, m.nb, 6) * 1.5), root_free=root_free)
    ref = soa.step_actor(m, *args, *rest, **kw)
    before = fused_step.step_actor_kernel.launches
    out = fused_step.step_actor_kernel(m, *args, *rest, **kw)
    torch.cuda.synchronize()
    assert fused_step.step_actor_kernel.launches == before + 1
    for n, a, b, tol in zip(NAMES, ref, out, TOLS):
        assert a.shape == b.shape, n
        if a.numel():
            diff = float((a - b).abs().max())
            assert diff <= tol, f"step {n}: max diff {diff:.3e} > {tol:.0e}"
