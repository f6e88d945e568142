"""The replays and the check of the golden-trajectory tests,
tests/test_golden_traj*.py (the goldens and their bounds: the docstring of
tests/test_golden_traj.py)."""
import os

import jax
import jax.numpy as jnp
import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _replay_drop(steps=60):
    from mqe_tpu.envs.go1_env import Go1Env
    from mqe_tpu.envs.tasks import Go1PlaneCfg

    class DropCfg(Go1PlaneCfg):
        class init_state(Go1PlaneCfg.init_state):
            pos = [0.0, 0.0, 0.62]

        class domain_rand(Go1PlaneCfg.domain_rand):
            init_base_pos_range = dict(x=[0.0, 0.0], y=[0.0, 0.0])
            init_base_vel_range = [0.0, 0.0]
            init_dof_pos_ratio_range = [1.0, 1.0]

        class termination(Go1PlaneCfg.termination):
            termination_terms = []

    env = Go1Env(DropCfg, num_envs=2, seed=0)
    state = env._reset_all(jax.random.PRNGKey(42))
    cmds = jnp.zeros((2, 1, 3))

    def body(carry, _):
        state, key = carry
        key, k = jax.random.split(key)
        state, obs, done, info = env._step(state, cmds, k)
        ag = state.phys.agents
        return (state, key), dict(pos=ag.pos, quat=ag.quat, q=ag.q)

    (_, _), recs = jax.lax.scan(body, (state, jax.random.PRNGKey(1)), None, length=steps)
    return {k: np.asarray(v) for k, v in recs.items()}


def _replay(task, steps, vx, num_envs, record_npc=False):
    from mqe_tpu.envs import make_mqe_env

    wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0)
    key = jax.random.PRNGKey(42)
    ts, _ = wrap.reset(key)
    A = getattr(wrap, "controlled_agents", wrap.num_agents)
    actions = jnp.zeros((num_envs, A, 3)).at[..., 0].set(vx)

    def body(carry, _):
        ts, key = carry
        key, k = jax.random.split(key)
        ts, obs, rew, done, info = wrap._step_impl(ts, actions, k)
        ag = ts.env.phys.agents
        rec = dict(pos=ag.pos, quat=ag.quat, q=ag.q)
        if record_npc:
            rec["npc_pos"] = ts.env.phys.npcs.pos
        return (ts, key), rec

    (ts, _), recs = jax.lax.scan(body, (ts, key), None, length=steps)
    return {k: np.asarray(v) for k, v in recs.items()}


def _check(golden, replay, early=20, pos_tol_early=0.01, pos_tol_late=0.08,
           q_tol_early=0.05, key="pos"):
    g, r = golden[key], replay[key]
    assert g.shape == r.shape
    # early trajectory: tight (pre-chaos)
    np.testing.assert_allclose(r[:early], g[:early], atol=pos_tol_early,
                               err_msg=f"{key} early-trajectory drift")
    # late trajectory: coarse envelope
    np.testing.assert_allclose(r, g, atol=pos_tol_late,
                               err_msg=f"{key} late-trajectory drift")
