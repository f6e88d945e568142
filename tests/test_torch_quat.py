"""mqe_tpu_torch.ops.quat against mqe_tpu.ops.quat, function by function.

Inputs from a numpy seed (random unit quaternions, vectors, angles, including
exact-identity and zero-rate rows); float32 on both sides, so the bound is a
few ulp: 2e-6 absolute, except the angle functions near +-pi (atan2, asin)
held to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqe_tpu.ops import quat as jq
from mqe_tpu_torch.ops import quat as tq

N = 64


def _data():
    rng = np.random.RandomState(0)
    q = rng.randn(N, 4).astype(np.float32)
    q[0] = [0, 0, 0, 1]                      # identity row
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.randn(N, 4).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    v = rng.randn(N, 3).astype(np.float32)
    w = rng.randn(N, 3).astype(np.float32) * 3.0
    w[1] = 0.0                               # zero rate: small-angle branch
    ang = rng.uniform(-7, 7, N).astype(np.float32)
    axis = rng.randn(N, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rpy = rng.uniform(-1.4, 1.4, (3, N)).astype(np.float32)
    return dict(q=q, q2=q2, v=v, w=w, ang=ang, axis=axis, rpy=rpy)


D = _data()

# name -> (argument names, tolerance)
CASES = {
    "quat_normalize": (("q2",), 2e-6),
    "quat_conjugate": (("q",), 0.0),
    "quat_mul": (("q", "q2"), 2e-6),
    "quat_rotate": (("q", "v"), 2e-6),
    "quat_rotate_inverse": (("q", "v"), 2e-6),
    "quat_apply": (("q", "v"), 2e-6),
    "quat_to_matrix": (("q",), 2e-6),
    "quat_from_angle_axis": (("ang", "axis"), 2e-6),
    "quat_from_euler_xyz": (("rpy",), 2e-6),
    "get_euler_xyz": (("q",), 1e-5),
    "get_euler_xyz_wrapped": (("q",), 1e-5),
    "wrap_to_pi": (("ang",), 1e-5),
    "quat_apply_yaw": (("q", "v"), 2e-6),
    "yaw_quat": (("q",), 2e-6),
    "quat_integrate": (("q", "w", 0.02), 2e-6),
    "quat_box_minus": (("q", "q2"), 1e-5),
    "normalize": (("v",), 2e-6),
}


def _args(names, mod):
    out = []
    for n in names:
        if isinstance(n, float):
            out.append(n)
        elif n == "rpy":
            out.extend(jnp.asarray(r) if mod is jq else torch.from_numpy(r) for r in D[n])
        else:
            out.append(jnp.asarray(D[n]) if mod is jq else torch.from_numpy(D[n]))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_quat_function_matches_jax(name):
    names, tol = CASES[name]
    ref = getattr(jq, name)(*_args(names, jq))
    out = getattr(tq, name)(*_args(names, tq))
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(refs) == len(outs)
    for a, b in zip(refs, outs):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol)


def test_quat_identity_matches_jax():
    np.testing.assert_array_equal(tq.quat_identity((3,)).numpy(), np.asarray(jq.quat_identity((3,))))
