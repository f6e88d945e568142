"""The port's AoS reference dynamics (mqe_tpu_torch/physics/spatial.py,
dynamics.py, star_dynamics.py, integrator.py) on the analytic cases of
tests/test_dynamics.py, with that file's own bounds, and against the JAX
package on recorded inputs.

The JAX side is tests/goldens/torch_dynamics.npz, written by
`JAX_PLATFORMS=cpu python tools/make_torch_goldens.py torch_dynamics.npz`
(`record_dynamics`: vmapped `forward_dynamics`, `forward_dynamics_star`,
`total_momentum`, `integrate`, `solve_spd6` and the scene's per-tree
helpers, op by op). Bounds are those of tests/test_pallas_step.py for one
substep: pos/quat/q 1e-6, lin/ang vel 1e-5, qd 1e-4. The FK outputs are
held to them directly (poses 1e-6, velocities 1e-5); an acceleration by
what it adds over one substep of DT = 0.005 s (the record's integration
step): dt * (omega_dot, a_lin) within 1e-5, dt * qdd within 1e-4.
"""
import os

import numpy as np
import pytest
import torch

from mqe_tpu_torch.ops import quat as quat_ops
from mqe_tpu_torch.physics import dynamics, integrator, scene, spatial
from mqe_tpu_torch.physics.model import BodyModel, go1_model, load_model
from mqe_tpu_torch.physics.star_dynamics import forward_dynamics_star, star_layout

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_dynamics.npz")
DT = 0.005
# the record's models: (asset, root_free)
MODELS = (("go1", True), ("box", True), ("seesaw", False), ("rotation_door", False),
          ("cylinder", True))
STATE_TOLS = dict(pos=1e-6, quat=1e-6, lin_vel=1e-5, ang_vel=1e-5, q=1e-6, qd=1e-4)
FD_TOLS = dict(Rw=1e-6, pw=1e-6, vw=1e-5, wd=1e-5 / DT, ad=1e-5 / DT, qdd=1e-4 / DT)


@pytest.fixture(scope="module")
def rec():
    with np.load(GOLDEN) as f:
        return dict(f)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# the analytic cases of tests/test_dynamics.py
# ---------------------------------------------------------------------------

def make_pendulum(axis=(0.0, 1.0, 0.0), length=1.0, mass=1.0) -> BodyModel:
    """Fixed root + single revolute joint, point mass at distance `length`."""
    nb = 2
    return BodyModel(
        name="pendulum", nb=nb, nq=1, root_free=False,
        parent=np.array([-1, 0], dtype=np.int32),
        joint_type=np.array([0, 1], dtype=np.int32),
        joint_pos=np.zeros((nb, 3)), joint_rot=np.tile(np.eye(3), (nb, 1, 1)),
        joint_axis=np.array([[0.0, 0.0, 0.0], list(axis)]),
        mass=np.array([0.0, mass]), com=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -length]]),
        inertia=np.zeros((nb, 3, 3)),
        q_lower=np.array([-1e9]), q_upper=np.array([1e9]), qd_limit=np.array([1e9]),
        tau_limit=np.array([0.0]), joint_damping=np.array([0.0]),
        joint_names=("hinge",), body_names=("root", "bob"),
        sph_body=np.zeros(0, dtype=np.int32), sph_pos=np.zeros((0, 3)),
        sph_radius=np.zeros(0), sph_tags=(),
        prim_body=np.zeros(0, dtype=np.int32), prim_kind=np.zeros(0, dtype=np.int32),
        prim_pos=np.zeros((0, 3)), prim_rot=np.zeros((0, 3, 3)), prim_size=np.zeros((0, 3)),
        prim_tags=(),
    )


def _ispat(model):
    return torch.as_tensor(model.spatial_inertia, dtype=torch.float32)


def step_free(model, Ispat, state, tau, dt, with_gravity=True):
    base_pos, base_quat, lv, av, q, qd = state
    Rw = dynamics.kinematics(model, base_pos, base_quat, q)[0]
    f_ext = (scene._gravity_wrench(model, Rw) if with_gravity
             else torch.zeros((model.nb, 6)))
    wd, ad, qdd, _ = dynamics.forward_dynamics(model, Ispat, base_pos, base_quat, lv, av, q, qd,
                                               tau, f_ext)
    return integrator.integrate(model, base_pos, base_quat, lv, av, q, qd, wd, ad, qdd, dt)


def _rest(pos, nq=0, av=None):
    return (torch.tensor(pos), quat_ops.quat_identity(), torch.zeros(3),
            torch.zeros(3) if av is None else torch.tensor(av), torch.zeros(nq), torch.zeros(nq))


def test_free_fall():
    model = load_model("ball")
    state = _rest([0.0, 0.0, 10.0])
    dt = 0.005
    for _ in range(100):
        state = step_free(model, _ispat(model), state, torch.zeros(0), dt)
    # semi-implicit Euler: z = z0 - g dt^2 n (n + 1) / 2
    expected_z = 10.0 - 9.81 * dt * dt * 100 * 101 / 2
    np.testing.assert_allclose(float(state[0][2]), expected_z, atol=1e-3)
    np.testing.assert_allclose(float(state[2][2]), -9.81 * 100 * dt, atol=1e-3)


def test_torque_free_spin():
    model = load_model("ball")
    omega0 = [1.0, 2.0, 3.0]
    state = _rest([0.0, 0.0, 0.0], av=omega0)
    for _ in range(200):
        state = step_free(model, _ispat(model), state, torch.zeros(0), 0.005, with_gravity=False)
    np.testing.assert_allclose(state[3].numpy(), omega0, atol=1e-4)


def test_pendulum_small_oscillation():
    model = make_pendulum()
    dt, theta0 = 0.001, 0.05
    state = _rest([0.0, 0.0, 0.0], nq=1)
    state = state[:4] + (torch.tensor([theta0]), torch.zeros(1))
    n = int(2 * np.pi * np.sqrt(1.0 / 9.81) / dt)
    traj = []
    for _ in range(n):
        state = step_free(model, _ispat(model), state, torch.zeros(1), dt)
        traj.append(float(state[4][0]))
    # after one period the angle returns near theta0, with a bounded amplitude
    assert abs(traj[-1] - theta0) < 0.005, traj[-1]
    assert max(np.abs(traj)) < theta0 * 1.05


def test_pendulum_energy_conservation():
    model = make_pendulum()
    dt = 0.001

    def energy(q, qd):
        return 0.5 * qd ** 2 + 9.81 * (-np.cos(q) + 1.0)

    state = _rest([0.0, 0.0, 0.0], nq=1)
    state = state[:4] + (torch.tensor([1.0]), torch.zeros(1))
    e0 = energy(1.0, 0.0)
    for _ in range(2000):
        state = step_free(model, _ispat(model), state, torch.zeros(1), dt)
    e1 = energy(float(state[4][0]), float(state[5][0]))
    assert abs(e1 - e0) / e0 < 0.02, (e0, e1)


def _go1_start():
    model = go1_model()
    q0 = torch.as_tensor((model.q_lower + model.q_upper) / 2, dtype=torch.float32)
    return model, _ispat(model), q0


def test_go1_momentum_conservation_instantaneous():
    """d/dt of the total momentum along the computed state derivative
    vanishes for internal joint torques in free space (torch.func.jvp)."""
    model, Ispat, q0 = _go1_start()
    gen = torch.Generator().manual_seed(0)
    base_pos = torch.tensor([0.0, 0.0, 5.0])
    base_quat = quat_ops.quat_normalize(torch.tensor([0.1, -0.2, 0.3, 0.9]))
    lv = torch.tensor([0.3, -0.1, 0.2])
    av = torch.tensor([0.5, 0.4, -0.3])
    qd = 0.1 * torch.randn(12, generator=gen)
    tau = 3.0 * torch.randn(12, generator=gen)
    wd, ad, qdd, _ = dynamics.forward_dynamics(model, Ispat, base_pos, base_quat, lv, av, q0, qd,
                                               tau, torch.zeros((model.nb, 6)))

    def mom(base_pos, base_quat, lv, av, q, qd):
        return torch.cat(dynamics.total_momentum(model, Ispat, base_pos, base_quat, lv, av, q, qd),
                         dim=-1)[0]

    def quat_dot(qt, w):
        return 0.5 * quat_ops.quat_mul(torch.cat([w, torch.zeros(1)]), qt)

    # a batch of one: forward-mode AD promotes the tangent of a python float
    # times a 0-d float32 tensor (a joint angle q[i]) to float64
    primals = tuple(x[None] for x in (base_pos, base_quat, lv, av, q0, qd))
    tangents = tuple(x[None] for x in (lv, quat_dot(base_quat, av), ad, wd, qd, qdd))
    h0, dh = torch.func.jvp(mom, primals, tangents)
    assert dh.dtype == torch.float32
    scale = float(h0.abs().max()) + 1.0
    np.testing.assert_allclose(dh.numpy() / scale, np.zeros(6), atol=1e-4)


def test_go1_momentum_drift_small():
    """Discrete rollout: the momentum drift stays small at a fine dt."""
    model, Ispat, q0 = _go1_start()
    state = (torch.tensor([0.0, 0.0, 5.0]), quat_ops.quat_identity(),
             torch.tensor([0.3, -0.1, 0.2]), torch.tensor([0.1, 0.05, -0.08]), q0, torch.zeros(12))
    h_ang0, h_lin0 = dynamics.total_momentum(model, Ispat, *state)
    tau = 1.0 * torch.randn(12, generator=torch.Generator().manual_seed(1))
    for _ in range(100):
        state = step_free(model, Ispat, state, tau, 1e-4, with_gravity=False)
    h_ang1, h_lin1 = dynamics.total_momentum(model, Ispat, *state)
    np.testing.assert_allclose(h_lin1.numpy(), h_lin0.numpy(), atol=5e-3)
    np.testing.assert_allclose(h_ang1.numpy(), h_ang0.numpy(), atol=5e-2)


def test_go1_composite_mass():
    model = go1_model()
    assert 10.0 < model.mass.sum() < 15.0, model.mass.sum()
    assert model.nb == 13 and model.nq == 12
    # the leg-parallel ABA takes go1 as 4 chains of depth 3; an NPC is no star
    L, D, bodies = star_layout(model)
    assert (L, D) == (4, 3) and sorted(bodies.ravel().tolist()) == list(range(1, 13))
    assert star_layout(load_model("seesaw", root_free=False)) is None


# ---------------------------------------------------------------------------
# against the JAX package's recorded outputs
# ---------------------------------------------------------------------------

def _inputs(rec, name):
    d = {k: _t(rec[f"{name}/in/{k}"]) for k in
         ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "tau", "f_ext", "payload", "com_shift",
          "q_int")}
    return d


def _fd(fd, m, d):
    Isp = scene._spatial_inertias(m, d["payload"], d["com_shift"])
    wd, ad, qdd, (Rw, pw, vw) = fd(m, Isp, d["pos"], d["quat"], d["lin_vel"], d["ang_vel"],
                                   d["q"], d["qd"], d["tau"], d["f_ext"])
    return dict(wd=wd, ad=ad, qdd=qdd, Rw=Rw, pw=pw, vw=vw)


def _hold(label, want, got, tols):
    diffs = {}
    for k, tol in tols.items():
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.shape == b.shape, (label, k, a.shape, b.shape)
        diffs[k] = float(np.abs(a - b).max()) if a.size else 0.0
        assert diffs[k] <= tol, f"{label} {k}: {diffs[k]:.3e} > {tol:.1e}"
    print(label, {k: f"{v:.2e}" for k, v in diffs.items()})  # shown with -s


@pytest.mark.parametrize("name,root_free", MODELS)
def test_forward_dynamics_matches_jax(rec, name, root_free):
    """forward_dynamics (and, for go1, forward_dynamics_star) of random
    states with random torques and wrenches against JAX's; the star ABA
    against the generic one as well."""
    m = load_model(name, root_free=root_free)
    d = _inputs(rec, name)
    out = _fd(dynamics.forward_dynamics, m, d)
    _hold(f"{name} fd", {k: rec[f"{name}/fd/{k}"] for k in FD_TOLS}, out, FD_TOLS)
    if star_layout(m) is not None:
        star = _fd(forward_dynamics_star, m, d)
        _hold(f"{name} star", {k: rec[f"{name}/star/{k}"] for k in FD_TOLS}, star, FD_TOLS)
        _hold(f"{name} star vs fd", {k: v.numpy() for k, v in out.items()}, star, FD_TOLS)
    h_ang, h_lin = dynamics.total_momentum(
        m, scene._spatial_inertias(m, d["payload"], d["com_shift"]),
        *(d[k] for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")))
    for k, h in (("ang", h_ang), ("lin", h_lin)):
        want = rec[f"{name}/momentum/{k}"]
        assert float(np.abs(want - h.numpy()).max()) <= 1e-5 * (1.0 + np.abs(want).max()), k


@pytest.mark.parametrize("name,root_free", MODELS)
def test_integrate_matches_jax(rec, name, root_free):
    """integrate of the recorded state by JAX's accelerations, q pushed past
    the joint limits in every other row (the clamps and the velocity kill)."""
    m = load_model(name, root_free=root_free)
    d = _inputs(rec, name)
    acc = [_t(rec[f"{name}/fd/{k}"]) for k in ("wd", "ad", "qdd")]
    out = integrator.integrate(m, d["pos"], d["quat"], d["lin_vel"], d["ang_vel"], d["q_int"],
                               d["qd"], *acc, DT)
    names = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
    _hold(f"{name} integrate", {k: rec[f"{name}/int/{k}"] for k in names},
          dict(zip(names, out)), STATE_TOLS)


def test_solve_spd6_matches_jax_including_non_pd(rec):
    """The unrolled Cholesky solve: SPD rows, then a zero, a negative and a
    rank-deficient pivot and -I, where the 1e-12 clamp decides the result."""
    x = spatial.solve_spd6(_t(rec["solve/A"]), _t(rec["solve/b"])).numpy()
    want = rec["solve/x"]
    assert np.array_equal(np.isnan(x), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(x[ok], want[ok], rtol=1e-5, atol=1e-6)
    # the SPD rows solve the system
    A, b = rec["solve/A"][:4].astype(np.float64), rec["solve/b"][:4]
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x[:4]), b, atol=1e-4)


def test_scene_helpers_match_jax(rec):
    """The AoS substep's per-tree helpers on go1: sphere poses, the sphere
    forces' wrench about each body origin, and the gravity wrench with the
    trunk's payload and com shift."""
    m = load_model("go1")
    Rw, pw, vw = (_t(rec[f"go1/fd/{k}"]) for k in ("Rw", "pw", "vw"))
    sx, sv = scene._sphere_world(m, Rw, pw, vw)
    np.testing.assert_allclose(sx.numpy(), rec["spheres/x"], atol=1e-6)
    np.testing.assert_allclose(sv.numpy(), rec["spheres/v"], atol=1e-6)
    wr = scene._accumulate_wrench(m, pw, _t(rec["spheres/x"]), _t(rec["spheres/force"]))
    np.testing.assert_allclose(wr.numpy(), rec["spheres/wrench"], atol=1e-5)
    grav = scene._gravity_wrench(m, Rw, _t(rec["go1/in/payload"]), _t(rec["go1/in/com_shift"]))
    np.testing.assert_allclose(grav.numpy(), rec["gravity/wrench"], atol=1e-5)
    # the gravity wrench of a tree at rest: its weight
    assert abs(float(grav[..., 5].sum(-1)[0]) + 9.81 * (m.mass.sum() + float(
        rec["go1/in/payload"][0]))) < 1e-3
