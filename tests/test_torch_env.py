"""One go1gate control step of the port (mqe_tpu_torch) against the JAX package.

Both start from the same JAX-produced state and take the same actions; the
port runs on the CPU, where its dynamics substep is the plain version of the
CUDA kernel. The JAX step is jitted once for the module (about a minute of
CPU compile); each case then costs a few seconds.

Tolerances on the agent state are the per-step bounds that
tests/test_soa_episode.py holds between two physics paths of the JAX package
(`TOLS`); the derived quantities (observations, reward, controller state) are
held to the same scale.
"""
import jax
import numpy as np
import pytest
import torch

from mqe_tpu.envs.registry import make_mqe_env as make_jax_env
from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.utils.convert import env_state_from_numpy

NUM_ENVS = 2
# per-step bounds of tests/test_soa_episode.py::TOLS
TOLS = dict(pos=1e-6, quat=1e-5, lin_vel=3e-4, ang_vel=5e-3, q=2e-4, qd=2e-2)
# observation, reward, and carried controller state
OTHER_TOLS = dict(obs=1e-4, reward=1e-4, gait_indices=1e-6, clock_inputs=1e-5,
                  loco_obs=1e-3, last_loco_action=1e-3, err_hist=2e-2, vel_int=1e-5)
WARM_STEPS = 25  # JAX steps before the compared step: feet on the ground


@pytest.fixture(scope="module")
def jax_run():
    wrap, _ = make_jax_env("go1gate", num_envs=NUM_ENVS, seed=0)
    ts, _ = wrap.reset(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    acts = rng.uniform(-1, 1, (WARM_STEPS + 1, NUM_ENVS, wrap.num_agents, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    states = [ts]
    for t in range(WARM_STEPS):
        key, k = jax.random.split(key)
        ts = wrap.step(ts, acts[t], k)[0]
        states.append(ts)
    return wrap, states, acts


@pytest.mark.parametrize("start", [0, WARM_STEPS], ids=["post-reset", "in-contact"])
def test_go1gate_step_matches_jax(jax_run, start):
    jwrap, states, acts = jax_run
    ts_j = states[start]
    out_j = jwrap.step(ts_j, acts[start], jax.random.PRNGKey(7))
    ts1_j, obs_j, rew_j, done_j, _ = jax.tree.map(np.asarray, out_j)
    assert not done_j.any(), "an env reset in the compared step"

    twrap, _ = make_torch_env("go1gate", num_envs=NUM_ENVS, seed=0, device="cpu")
    ts_t = env_state_from_numpy(jax.tree.map(np.asarray, ts_j), device="cpu")
    ts1_t, obs_t, rew_t, done_t, _ = twrap.step(ts_t, torch.as_tensor(acts[start]))

    assert not done_t.any()
    ag_j, ag_t = ts1_j.env.phys.agents, ts1_t.env.phys.agents
    pairs = {name: (getattr(ag_j, name), getattr(ag_t, name)) for name in TOLS}
    pairs.update(obs=(obs_j, obs_t), reward=(rew_j, rew_t))
    for name in OTHER_TOLS:
        if name not in pairs:
            pairs[name] = (getattr(ts1_j.env, name), getattr(ts1_t.env, name))
    diffs = {}
    for name, tol in {**TOLS, **OTHER_TOLS}.items():
        a, b = pairs[name]
        assert a.shape == tuple(b.shape), name
        diffs[name] = np.abs(a - b.numpy()).max()
        assert diffs[name] <= tol, f"{name}: max diff {diffs[name]:.3e} > {tol:.0e}"
    print(f"{start}: " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))  # shown with -s
    for k in ts1_j.extra:
        np.testing.assert_allclose(ts1_t.extra[k].numpy(), ts1_j.extra[k], atol=1e-5, err_msg=k)


def test_randomization_options_take_the_given_draws():
    """Every randomized input of a reset and a step (spawn noise, domain
    randomisation, push velocities) is taken from `Draws` when given, and
    the options go1gate leaves off (push, action lag, tanh/delta command
    clipping) act as the JAX package's `_step_pre` has them."""
    from mqe_tpu_torch.envs.tasks import Go1GateCfg
    from mqe_tpu_torch.envs.wrappers import ACTION_SCALE

    class Cfg(Go1GateCfg):
        class domain_rand(Go1GateCfg.domain_rand):
            init_base_pos_range = dict(x=[-0.1, 0.1], y=[-0.1, 0.1])
            randomize_friction = randomize_base_mass = randomize_com = True
            randomize_motor = push_robots = randomize_lag_timesteps = True
            push_interval_s = 0.02  # one control step: push every step
            lag_timesteps = 6

        class normalization(Go1GateCfg.normalization):
            clip_actions_method = "tanh"
            clip_actions_delta = 0.1

    wrap, _ = make_torch_env("go1gate", num_envs=NUM_ENVS, seed=0, device="cpu",
                             custom_cfg=lambda c: Cfg)
    env, E, A = wrap.env, NUM_ENVS, wrap.num_agents
    rng = np.random.RandomState(9)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    given = dict(spawn_x=0.1 * u(E, A), spawn_y=0.1 * u(E, A), dof_ratio=1 + 0.3 * u(E, A, 12),
                 base_vel=0.5 * u(E, A, 6), friction=1 + 0.5 * u(E), payload=1 + u(E, A),
                 com_x=0.05 * u(E, A), com_y=0.05 * u(E, A), com_z=0.05 * u(E, A),
                 motor=1 + 0.1 * u(E, A, 12), push_vel=u(E, A, 2))
    ts, _ = wrap.reset(env.draws(given))
    ag, dr = ts.env.phys.agents, ts.env.dr
    t = torch.from_numpy
    origin = env.agent_origins.clone()
    origin[..., 2] = 0.0
    spawn = torch.stack([t(given["spawn_x"]), t(given["spawn_y"]), torch.zeros(E, A)], -1)
    assert torch.allclose(ag.pos, env.agent_init[:, :3] + spawn + origin)
    assert torch.allclose(ag.q, env.default_q * t(given["dof_ratio"]))
    assert torch.equal(torch.cat([ag.lin_vel, ag.ang_vel], -1), t(given["base_vel"]))
    assert torch.equal(dr.mu_scale, t(given["friction"]))
    assert torch.equal(dr.payload, t(given["payload"]))
    assert torch.equal(dr.com_shift, t(np.stack([given[f"com_{k}"] for k in "xyz"], -1)))
    assert torch.equal(dr.motor_strength, t(given["motor"]))
    assert tuple(ts.env.lag_buffer.shape) == (E, A, 7, 12)

    acts = torch.from_numpy(u(E, A, 3))
    ts1, _, _, done, _ = wrap.step(ts, acts, env.draws({**given, "fresh": env.fresh_state()}))
    assert not done.any()
    cmds = torch.tanh(acts * torch.from_numpy(ACTION_SCALE)) * 10.0
    expect = torch.clamp(torch.clamp(cmds, -0.1, 0.1), -1.0, 1.0)  # previous commands are 0
    assert torch.allclose(ts1.env.commands, expect)
    assert torch.equal(ts1.env.phys.agents.lin_vel[..., :2], t(given["push_vel"]))
    scaled = ts1.env.last_loco_action * env.action_scale * env.hip_scale
    lag = ts1.env.lag_buffer  # 4 substeps shifted the FIFO by 4
    assert torch.equal(lag[..., -1, :], scaled) and torch.equal(lag[..., -4, :], scaled)
    assert not lag[..., :3, :].any()
