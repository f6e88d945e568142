"""mqe_tpu_torch.control against mqe_tpu.control: gait clocks, leg IK/FK,
the trot controller, and the two nets (actuator net, body policy) carried
across with `mlp_from_numpy`.

Inputs from a numpy seed. float32 both sides; the bounds are a few ulp of
the values' scale: 1e-5 for angles and clocks, 1e-4 for actions (|a| up to
~10) and torques (|tau| up to ~25 Nm, matmul sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqe_tpu.control import locomotion as jl
from mqe_tpu.control import nets as jn
from mqe_tpu_torch import ASSETS_DIR
from mqe_tpu_torch.control import locomotion as tl
from mqe_tpu_torch.control import nets as tn
from mqe_tpu_torch.utils.convert import mlp_from_numpy

RNG = np.random.RandomState(0)
DEFAULT_Q = np.array([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 1.0, -1.5, 0.1, 1.0, -1.5],
                     dtype=np.float32)


def _f32(*shape, scale=1.0, offset=0.0):
    return (RNG.randn(*shape) * scale + offset).astype(np.float32)


def _cmp(a, b, tol):
    a = np.asarray(a)
    assert a.shape == tuple(b.shape)
    np.testing.assert_allclose(b.detach().numpy(), a, rtol=0, atol=tol)


def test_step_gait_clocks_matches_jax():
    gi = RNG.rand(8, 2).astype(np.float32)
    args = [0.02, np.full((8, 2), 4.0, np.float32), np.full((8, 2), 0.5, np.float32),
            np.zeros((8, 2), np.float32), np.zeros((8, 2), np.float32),
            np.full((8, 2), 0.5, np.float32)]
    ref = jl.step_gait_clocks(jnp.asarray(gi), *[a if isinstance(a, float) else jnp.asarray(a) for a in args])
    out = tl.step_gait_clocks(torch.from_numpy(gi), *[a if isinstance(a, float) else torch.from_numpy(a) for a in args])
    for a, b in zip(ref, out):
        _cmp(a, b, 1e-5)


def test_leg_ik_fk_match_jax():
    p = _f32(16, 4, 3, scale=0.05, offset=0.0) + np.array([0.0, 0.08, -0.27], np.float32)
    sy = tl.LEG_SIGN_Y.astype(np.float32)
    ref = jl.leg_ik(jnp.asarray(p), jnp.asarray(sy))
    out = tl.leg_ik(torch.from_numpy(p), torch.from_numpy(sy))
    for a, b in zip(ref, out):
        _cmp(a, b, 1e-5)
    q = np.stack([np.asarray(r) for r in ref], -1)
    _cmp(jl.leg_fk(jnp.asarray(q), jnp.asarray(sy)), tl.leg_fk(torch.from_numpy(q), torch.from_numpy(sy)), 1e-6)


def test_trot_controller_matches_jax():
    B = 12
    cmds = _f32(B, 3, scale=0.5)
    idx = RNG.rand(B, 4).astype(np.float32)
    gp = dict(freq=4.0, duration=0.5, swing_height=0.12, stance_width=0.25,
              stance_length=0.428, body_height_delta=0.0)
    roll, pitch = _f32(B, scale=0.1), _f32(B, scale=0.1)
    v_meas, w_meas = _f32(B, 2, scale=0.3), _f32(B, scale=0.3)
    v_int, z_meas = _f32(B, 3, scale=0.1), _f32(B, scale=0.02, offset=0.27)
    kw = dict(body_height=0.28, action_scale=0.25, hip_scale_reduction=0.5, default_q=DEFAULT_Q)
    ref = jl.TrotController(**kw)(
        jnp.asarray(cmds), jnp.asarray(idx), {k: jnp.full((B,), v, jnp.float32) for k, v in gp.items()},
        roll=jnp.asarray(roll), pitch=jnp.asarray(pitch), v_meas=jnp.asarray(v_meas),
        w_meas=jnp.asarray(w_meas), v_int=jnp.asarray(v_int), z_meas=jnp.asarray(z_meas))
    out = tl.TrotController(**kw)(
        torch.from_numpy(cmds), torch.from_numpy(idx), {k: torch.full((B,), v) for k, v in gp.items()},
        roll=torch.from_numpy(roll), pitch=torch.from_numpy(pitch), v_meas=torch.from_numpy(v_meas),
        w_meas=torch.from_numpy(w_meas), v_int=torch.from_numpy(v_int), z_meas=torch.from_numpy(z_meas))
    _cmp(ref, out, 1e-4)


def test_actuator_net_matches_jax():
    """The JAX package's loaded parameters, carried across by mlp_from_numpy."""
    jnet = jn.ActuatorNet()
    params = {"activation": jnet.params["act"]}
    for i, (w, b) in enumerate(zip(jnet.params["w"], jnet.params["b"])):
        params[f"w{i}"] = np.asarray(w).T     # (in, out) -> (out, in)
        params[f"b{i}"] = np.asarray(b)
    tnet = tn.ActuatorNet(mlp_from_numpy(params))
    ins = [_f32(5, 2, 12, scale=0.3) for _ in range(3)] + [_f32(5, 2, 12, scale=3.0) for _ in range(3)]
    _cmp(jnet(*[jnp.asarray(x) for x in ins]), tnet(*[torch.from_numpy(x) for x in ins]), 1e-4)
    # the port's own loader reads the same weights
    for a, b in zip(tnet.parameters(), tn.ActuatorNet().parameters()):
        assert torch.equal(a, b)


def test_body_policy_matches_jax():
    path = f"{ASSETS_DIR}/body_policy.npz"
    japply = jn.load_body_policy(path)
    tpol = tn.load_body_policy(path)
    d = np.load(path)
    params, i = {"activation": "elu"}, 0
    while f"params/actor/Dense_{i}/kernel" in d:
        params[f"w{i}"] = d[f"params/actor/Dense_{i}/kernel"].T
        params[f"b{i}"] = d[f"params/actor/Dense_{i}/bias"]
        i += 1
    prescale = float(d["meta_prescale"]) if "meta_prescale" in d else 4.0
    carried = tn.BodyPolicy(mlp_from_numpy(params), prescale)
    obs = _f32(6, 2, 70, scale=0.5)
    ref = japply(jnp.asarray(obs))
    _cmp(ref, tpol(torch.from_numpy(obs)), 1e-4)
    _cmp(ref, carried(torch.from_numpy(obs)), 1e-4)


def test_mlp_from_numpy_rejects_empty():
    with pytest.raises(ValueError):
        mlp_from_numpy({"activation": "elu"})
