"""mqe_tpu_torch.physics.contact against mqe_tpu.physics.contact.

Contact points from a numpy seed, placed so that every branch is taken:
spheres above and inside the plane, outside / inside / on the edge of a box,
overlapping and apart sphere pairs, a ramp heightfield. float32 both sides;
forces reach f_max = 500 N, so the bound is 5e-4 N (1e-6 relative), and
2e-6 for the heightfield's height and slope.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqe_tpu.physics import contact as jc
from mqe_tpu_torch.physics import contact as tc

P_J = jc.ContactParams(kn=4000.0, hc_damping=3.0, v_slip=0.05, f_max=500.0)
P_T = tc.ContactParams(kn=4000.0, hc_damping=3.0, v_slip=0.05, f_max=500.0)
F_TOL = 5e-4


def _pts(n=200, seed=0):
    rng = np.random.RandomState(seed)
    pos = (rng.randn(n, 3) * np.array([0.6, 0.6, 0.08]) + np.array([0, 0, 0.03])).astype(np.float32)
    vel = (rng.randn(n, 3) * 0.5).astype(np.float32)
    rad = rng.uniform(0.01, 0.06, n).astype(np.float32)
    return pos, vel, rad


def _cmp(a, b, tol=F_TOL):
    a = np.asarray(a)
    assert a.shape == tuple(b.shape)
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol)


def test_sphere_plane_matches_jax():
    pos, vel, rad = _pts()
    mu = np.float32(0.7)
    ref = jc.sphere_plane(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad), 0.0, P_J, mu)
    out = tc.sphere_plane(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(rad),
                          0.0, P_T, float(mu))
    assert float(out.abs().max()) > 1.0, "no contact exercised"
    _cmp(ref, out)


def test_sphere_box_matches_jax():
    pos, vel, rad = _pts(seed=1)
    pos[:20] = np.array([0.0, 0.0, 0.1])  # deep inside: the least-gap face
    centers = np.array([[0.0, 0.0, 0.1], [0.5, -0.3, 0.25]], dtype=np.float32)
    halves = np.array([[0.3, 0.2, 0.1], [0.05, 0.6, 0.25]], dtype=np.float32)
    ref = jc.sphere_box(jnp.asarray(pos)[:, None], jnp.asarray(vel)[:, None],
                        jnp.asarray(rad)[:, None], jnp.asarray(centers)[None],
                        jnp.asarray(halves)[None], P_J, 1.0)
    out = tc.sphere_box(torch.from_numpy(pos)[:, None], torch.from_numpy(vel)[:, None],
                        torch.from_numpy(rad)[:, None], torch.from_numpy(centers)[None],
                        torch.from_numpy(halves)[None], P_T, 1.0)
    assert float(out.abs().max()) > 1.0
    _cmp(ref, out)


def test_sphere_sphere_matches_jax():
    pos, vel, rad = _pts(n=40, seed=2)
    pos *= 0.2
    ref = jc.sphere_sphere(jnp.asarray(pos)[:, None], jnp.asarray(vel)[:, None],
                           jnp.asarray(rad)[:, None], jnp.asarray(pos)[None],
                           jnp.asarray(vel)[None], jnp.asarray(rad)[None], P_J, 1.3)
    out = tc.sphere_sphere(torch.from_numpy(pos)[:, None], torch.from_numpy(vel)[:, None],
                           torch.from_numpy(rad)[:, None], torch.from_numpy(pos)[None],
                           torch.from_numpy(vel)[None], torch.from_numpy(rad)[None], P_T, 1.3)
    assert float(out.abs().max()) > 1.0
    _cmp(ref, out)


@pytest.mark.parametrize("fn", ["sample", "sphere_heightfield"])
def test_heightfield_matches_jax(fn):
    rng = np.random.RandomState(3)
    X, Y = np.meshgrid(np.arange(40), np.arange(30), indexing="ij")
    height = (0.01 * X + 0.02 * np.sin(0.3 * Y) + 0.005 * rng.rand(40, 30)).astype(np.float32)
    origin = np.array([-0.5, -0.4], dtype=np.float32)
    scale = 0.025
    pos, vel, rad = _pts(seed=4)
    pos[:, :2] = rng.uniform(-0.6, 0.6, (len(pos), 2))  # some outside the grid: clamped
    pos[:, 2] = 0.15 + rng.randn(len(pos)).astype(np.float32) * 0.1
    if fn == "sample":
        ref = jc.Heightfield.sample(jnp.asarray(height), jnp.asarray(origin), scale,
                                    jnp.asarray(pos[:, :2]))
        out = tc.Heightfield.sample(torch.from_numpy(height), torch.from_numpy(origin), scale,
                                    torch.from_numpy(pos[:, :2]))
        for a, b in zip(ref, out):
            _cmp(a, b, tol=2e-6)
    else:
        ref = jc.sphere_heightfield(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad),
                                    jnp.asarray(height), jnp.asarray(origin), scale, P_J)
        out = tc.sphere_heightfield(torch.from_numpy(pos), torch.from_numpy(vel),
                                    torch.from_numpy(rad), torch.from_numpy(height),
                                    torch.from_numpy(origin), scale, P_T)
        assert float(out.abs().max()) > 1.0
        _cmp(ref, out)
