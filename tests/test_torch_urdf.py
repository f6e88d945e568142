"""The port's URDF compiler (mqe_tpu_torch/physics/urdf.py) against the JAX
package's (mqe_tpu/physics/urdf.py, numpy only: no JAX compile).

A synthetic URDF written to tmp_path: a floating base, two revolute chains
(one of them through a fixed joint that the compiler collapses into its
parent), and box, cylinder and sphere collisions. Both compilers must give
equal output: `parse_urdf`, `reduce_tree`, `spherize` and the whole
`compile_model_spec`. The spec then loads through the port's
`load_model` and runs its dynamics.
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

URDF = """<?xml version="1.0"?>
<robot name="synthetic">
  <link name="base">
    <inertial><origin xyz="0.01 0 0.02" rpy="0 0 0"/><mass value="4.0"/>
      <inertia ixx="0.05" ixy="0.001" ixz="0" iyy="0.08" iyz="0" izz="0.09"/></inertial>
    <collision><origin xyz="0 0 0" rpy="0 0 0"/><geometry><box size="0.4 0.2 0.1"/></geometry></collision>
  </link>
  <link name="head">
    <inertial><origin xyz="0 0 0" rpy="0 0 0"/><mass value="0.5"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.001"/></inertial>
    <collision><origin xyz="0.02 0 0" rpy="0 0 0"/><geometry><sphere radius="0.06"/></geometry></collision>
  </link>
  <joint name="head_fixed" type="fixed">
    <parent link="base"/><child link="head"/><origin xyz="0.25 0 0.03" rpy="0 0.1 0"/>
  </joint>
  <link name="l_upper">
    <inertial><origin xyz="0 0 -0.1" rpy="0 0 0"/><mass value="1.0"/>
      <inertia ixx="0.004" ixy="0" ixz="0" iyy="0.004" iyz="0" izz="0.0005"/></inertial>
    <collision><origin xyz="0 0 -0.1" rpy="0 0 0"/><geometry><cylinder radius="0.03" length="0.2"/></geometry></collision>
  </link>
  <joint name="l_hip" type="revolute">
    <parent link="base"/><child link="l_upper"/><origin xyz="0.1 0.12 0" rpy="0 0 0"/>
    <axis xyz="0 1 0"/><limit lower="-1.0" upper="2.0" effort="20" velocity="15"/>
    <dynamics damping="0.1" friction="0.01"/>
  </joint>
  <link name="l_lower">
    <inertial><origin xyz="0 0 -0.1" rpy="0 0 0"/><mass value="0.3"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.0002"/></inertial>
    <collision><origin xyz="0 0 -0.2" rpy="0 0 0"/><geometry><sphere radius="0.025"/></geometry></collision>
  </link>
  <joint name="l_knee" type="revolute">
    <parent link="l_upper"/><child link="l_lower"/><origin xyz="0 0 -0.2" rpy="0 0 0"/>
    <axis xyz="0 1 0"/><limit lower="-2.5" upper="-0.5" effort="30" velocity="20"/>
  </joint>
  <link name="r_upper">
    <inertial><origin xyz="0 0 -0.1" rpy="0 0 0"/><mass value="1.0"/>
      <inertia ixx="0.004" ixy="0" ixz="0" iyy="0.004" iyz="0" izz="0.0005"/></inertial>
    <collision><origin xyz="0 0 -0.1" rpy="0.2 0 0"/><geometry><box size="0.05 0.04 0.2"/></geometry></collision>
  </link>
  <joint name="r_hip" type="revolute">
    <parent link="base"/><child link="r_upper"/><origin xyz="0.1 -0.12 0" rpy="0.05 0 0"/>
    <axis xyz="1 0 0"/><limit lower="-0.8" upper="0.8" effort="20" velocity="15"/>
  </joint>
  <link name="r_lower">
    <inertial><origin xyz="0 0 -0.1" rpy="0 0 0"/><mass value="0.3"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.0002"/></inertial>
    <collision><origin xyz="0 0 -0.2" rpy="0 0 0"/><geometry><sphere radius="0.025"/></geometry></collision>
  </link>
  <joint name="r_knee" type="revolute">
    <parent link="r_upper"/><child link="r_lower"/><origin xyz="0 0 -0.2" rpy="0 0 0"/>
    <axis xyz="0 1 0"/><limit lower="-2.5" upper="-0.5" effort="30" velocity="20"/>
  </joint>
</robot>
"""


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("urdf") / "synthetic.urdf"
    path.write_text(URDF)
    return str(path)


def _equal(a, b, where="spec"):
    """Structural equality of nested dicts, lists, dataclasses and arrays."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, where
        for k in a.__dataclass_fields__:
            _equal(getattr(a, k), getattr(b, k), f"{where}.{k}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def test_compile_model_spec_equals_jax(urdf_path):
    from mqe_tpu.physics import urdf as J

    from mqe_tpu_torch.physics import urdf as T

    spec_j = J.compile_model_spec(urdf_path)
    spec_t = T.compile_model_spec(urdf_path)
    _equal(spec_j, spec_t)
    # the fixed head joint collapsed: base + two chains of two bodies
    assert [b["name"] for b in spec_t["bodies"]] == ["base", "l_upper", "l_lower",
                                                     "r_upper", "r_lower"]
    assert {p["kind"] for p in spec_t["prims"]} == {"box", "cylinder", "sphere"}
    assert json.loads(json.dumps(spec_t)) == spec_t   # JSON-able
    _equal(J.compile_model_spec(urdf_path, spherize_collisions=False, max_spheres_per_axis=2),
           T.compile_model_spec(urdf_path, spherize_collisions=False, max_spheres_per_axis=2))


def test_parse_reduce_spherize_equal_jax(urdf_path):
    from mqe_tpu.physics import urdf as J

    from mqe_tpu_torch.physics import urdf as T

    links_j, joints_j, root_j = J.parse_urdf(urdf_path)
    links_t, joints_t, root_t = T.parse_urdf(urdf_path)
    assert root_j == root_t
    _equal(links_j, links_t, "links")
    _equal(joints_j, joints_t, "joints")
    _equal(J.reduce_tree(links_j, joints_j), T.reduce_tree(links_t, joints_t), "bodies")
    for name, link in links_t.items():
        for cj, ct in zip(links_j[name].collisions, link.collisions):
            for n in (1, 2, 4):
                _equal(J.spherize(cj, n), T.spherize(ct, n), f"spherize {name} {n}")
    np.testing.assert_array_equal(J.rpy_to_matrix(np.array([0.1, -0.4, 2.0])),
                                  T.rpy_to_matrix(np.array([0.1, -0.4, 2.0])))


def test_compiled_spec_loads_and_steps(urdf_path, tmp_path, monkeypatch):
    """The port's spec is what load_model reads: the synthetic robot loads,
    and one substep of its AoS dynamics (forward_dynamics with gravity, then
    integrate) equals the SoA plain version's (soa.step_actor, which adds
    gravity itself) within the bounds of tests/test_pallas_step.py."""
    import mqe_tpu_torch.physics.model as M
    from mqe_tpu_torch.physics import dynamics, integrator, scene, soa
    from mqe_tpu_torch.physics import urdf as T

    (tmp_path / "synthetic.json").write_text(json.dumps(T.compile_model_spec(urdf_path)))
    monkeypatch.setattr(M, "ASSETS_DIR", str(tmp_path))
    m = M.load_model("synthetic")
    assert (m.nb, m.nq) == (5, 4) and m.root_free
    rng = np.random.RandomState(0)
    t = lambda *s: torch.as_tensor(rng.randn(*s).astype(np.float32))  # noqa: E731
    pos, lv, av = t(3, 3), t(3, 3), t(3, 3)
    quat = torch.nn.functional.normalize(t(3, 4) * 0.2 + torch.tensor([0, 0, 0, 1.0]), dim=-1)
    q, qd, tau = t(3, 4) * 0.3, t(3, 4), t(3, 4)
    Ispat = torch.as_tensor(m.spatial_inertia, dtype=torch.float32)
    Rw = dynamics.kinematics(m, pos, quat, q)[0]
    wd, ad, qdd, _ = dynamics.forward_dynamics(m, Ispat, pos, quat, lv, av, q, qd, tau,
                                               scene._gravity_wrench(m, Rw))
    aos = integrator.integrate(m, pos, quat, lv, av, q, qd, wd, ad, qdd, 0.005)
    ns = len(m.sph_tags)
    assert ns > 0
    soa_out = soa.step_actor(m, pos, quat, lv, av, q, qd, tau, torch.zeros(3, ns, 3),
                             soa.fk_spheres(m, pos, quat, lv, av, q, qd)[0], dt=0.005)
    for name, a, b, tol in zip(("pos", "quat", "lin_vel", "ang_vel", "q", "qd"), aos, soa_out,
                               (1e-6, 1e-6, 1e-5, 1e-5, 1e-6, 1e-4)):
        assert float((a - b).abs().max()) <= tol, name
