"""mqe_tpu_torch.physics.scene.substep_batch against the JAX package's, and
the terrain both packages build from one seed.

The substep runs on the go1gate scene at 2 envs (2 robots each) from a state
drawn with a numpy seed so that every contact term acts: feet on the ground,
the two robots of an env overlapping, a robot against a wall box. The JAX
side runs op by op (no jit). One substep: the tolerances of
tests/test_pallas_step.py on the state, 5e-4 N on forces of up to 500 N.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqe_tpu.envs.registry import make_mqe_env as make_jax_env
from mqe_tpu.physics import scene as JS
from mqe_tpu.terrain import BarrierTrackBuilder as JaxTrack
from mqe_tpu.terrain.perlin import fractal_noise_2d as jax_noise
from mqe_tpu_torch.envs.config import class_to_dict
from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.envs.tasks import Go1GateCfg
from mqe_tpu_torch.physics import scene as TS
from mqe_tpu_torch.terrain import BarrierTrackBuilder as TorchTrack
from mqe_tpu_torch.terrain.perlin import fractal_noise_2d as torch_noise

E = 2
NAMES = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
TOLS = (1e-6, 1e-6, 1e-5, 1e-5, 1e-6, 1e-4)


def _state(env):
    """Actor state (E, A, ...) in contact with ground, boxes and each other."""
    rng = np.random.RandomState(0)
    A = env.num_agents
    ao = np.asarray(env.agent_origins)
    pos = np.zeros((E, A, 3), np.float32)
    pos[..., :2] = ao[..., :2]
    pos[..., 2] = 0.30 + rng.randn(E, A) * 0.01
    pos[0, 1, :2] = pos[0, 0, :2] + np.array([0.25, 0.0])     # trunks overlapping
    box = np.asarray(env.env_boxes)[1]
    box = box[box[:, 6] > 0][0]
    pos[1, 0, :2] = box[:2] - np.array([box[3] + 0.1, 0.0])   # against a wall box
    qt = rng.randn(E, A, 4) * 0.05 + np.array([0, 0, 0, 1.0])
    quat = qt / np.linalg.norm(qt, axis=-1, keepdims=True)
    q = np.asarray(env.default_q) + rng.randn(E, A, 12) * 0.1
    arrays = dict(pos=pos, quat=quat, lin_vel=rng.randn(E, A, 3) * 0.3,
                  ang_vel=rng.randn(E, A, 3) * 0.3, q=q, qd=rng.randn(E, A, 12) * 0.5)
    extra = dict(tau=rng.randn(E, A, 12) * 3.0, mu=rng.uniform(0.5, 1.5, E),
                 payload=rng.rand(E, A), com=rng.randn(E, A, 3) * 0.01)
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return f32(arrays), f32(extra)


def test_substep_batch_matches_jax():
    jwrap, _ = make_jax_env("go1gate", num_envs=E, seed=0)
    twrap, _ = make_torch_env("go1gate", num_envs=E, seed=0, device="cpu")
    jenv, tenv = jwrap.env, twrap.env
    st, ex = _state(jenv)
    dt = jenv.sim_dt / jenv.subiters

    jz = jnp.zeros((E, 0, 3))
    jstate = JS.PhysState(
        agents=JS.ActorState(**{k: jnp.asarray(v) for k, v in st.items()}),
        npcs=JS.ActorState(jz, jnp.zeros((E, 0, 4)), jz, jz, jnp.zeros((E, 0, 0)), jnp.zeros((E, 0, 0))),
    )
    jdr = JS.DomainRand(mu_scale=jnp.asarray(ex["mu"]), payload=jnp.asarray(ex["payload"]),
                        com_shift=jnp.asarray(ex["com"]), motor_strength=jnp.ones((E, 2, 12)))
    jterrain = JS.Terrain(height=jenv.hf, origin=jenv.hf_origin, scale=jenv.hf_scale,
                          boxes=jenv.env_boxes, static_geoms=jenv.static_geoms)
    jnew, jc = JS.substep_batch(jenv.scene, jterrain, jstate, jnp.asarray(ex["tau"]),
                                jnp.zeros((E, 0, 0)), jdr, dt)

    tz = torch.zeros((E, 0, 3))
    tstate = TS.PhysState(
        agents=TS.ActorState(**{k: torch.from_numpy(v) for k, v in st.items()}),
        npcs=TS.ActorState(tz, torch.zeros((E, 0, 4)), tz, tz, torch.zeros((E, 0, 0)), torch.zeros((E, 0, 0))),
    )
    tdr = TS.DomainRand(mu_scale=torch.from_numpy(ex["mu"]), payload=torch.from_numpy(ex["payload"]),
                        com_shift=torch.from_numpy(ex["com"]), motor_strength=torch.ones((E, 2, 12)))
    tnew, tc = TS.substep_batch(tenv.scene, tenv.terrain, tstate, torch.from_numpy(ex["tau"]), tdr, dt)

    f_j = np.asarray(jc.sphere_force)
    # every contact term acted: ground (feet), robot-robot (env 0), wall box (env 1)
    assert np.abs(f_j).max() > 10.0
    coarse = jenv.scene.coarse_sphere_indices()
    assert np.abs(f_j[0, :, coarse]).max() > 1.0   # the two trunks
    assert np.abs(f_j[1, 0, coarse]).max() > 1.0   # trunk front in the box
    np.testing.assert_allclose(tc.sphere_force.numpy(), f_j, rtol=0, atol=5e-4)
    np.testing.assert_allclose(tc.feet_force.numpy(), np.asarray(jc.feet_force), rtol=0, atol=5e-4)
    for n, tol in zip(NAMES, TOLS):
        a = np.asarray(getattr(jnew.agents, n))
        b = getattr(tnew.agents, n).numpy()
        assert a.shape == b.shape, n
        diff = np.abs(a - b).max()
        assert diff <= tol, f"{n}: max diff {diff:.3e} > {tol:.0e}"


@pytest.mark.parametrize("perlin", [False, True], ids=["go1gate", "with-perlin"])
def test_barrier_track_same_arrays(perlin):
    tcfg = class_to_dict(Go1GateCfg.terrain)
    if perlin:
        tcfg["BarrierTrack_kwargs"] = {**tcfg["BarrierTrack_kwargs"], "add_perlin_noise": True}
        tcfg["num_rows"] = tcfg["num_cols"] = 2
    a = JaxTrack(tcfg, 2).build(seed=3)
    b = TorchTrack(tcfg, 2).build(seed=3)
    for name in ("height", "boxes", "env_origins", "agent_origins"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    assert a.origin.tolist() == b.origin.tolist() and a.scale == b.scale
    assert a.env_info.keys() == b.env_info.keys()
    for k in a.env_info:
        np.testing.assert_array_equal(b.env_info[k], a.env_info[k], err_msg=k)
    if perlin:
        assert float(np.ptp(a.height)) > 0.0


def test_fractal_noise_same_arrays():
    a = jax_noise(np.random.default_rng(5), xSize=2.0, ySize=3.0, xSamples=40, ySamples=60)
    b = torch_noise(np.random.default_rng(5), xSize=2.0, ySize=3.0, xSamples=40, ySamples=60)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
