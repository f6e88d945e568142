"""Football in the port (go1football-defender, go1football-1vs1,
go1football-2vs2) against the JAX package.

- One control step of each task at 2 envs, from the post-reset state and
  from the state after 25 steps, against JAX's recorded step
  (tests/goldens/torch_<task>_step.npz): agent and ball state, observations,
  reward, done, controller state, extras, and the env's commands, which hold
  the scripted defender's row.
- The defender's script against JAX's (`Go1Env._defender_commands`, run op
  by op) on drawn states, many of them with the defender past the gate,
  where the script's arctan leaves the principal branch.
- The defender wrapper controls 2 of the 3 robots; the game wrapper's goal
  reward against JAX's.
- Wrapper sizes and geometry against the JAX wrappers (built, not run).
- One `scene.substep_batch` of four robots and the ball, one robot's head in
  it, against JAX's (the "football-ball" case of
  tests/goldens/torch_static_substep.npz).
  The ball's NPC launches on the card are cases of tests/test_torch_npc.py.

Tolerances: tests/test_torch_env.py's on the step, 1e-5 on commands;
tests/test_pallas_step.py's and 5e-4 N on the substep.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from test_torch_fixtures import static_golden, static_substep_matches  # noqa: F401
from test_torch_tasks import NUM_ENVS, _compare_step, _diff, _record, wrapper_sizes_match

torch.set_num_threads(1)

TASKS = ("go1football-defender", "go1football-1vs1", "go1football-2vs2")
CMD_TOL = 1e-5
E = NUM_ENVS


@pytest.mark.parametrize("task,case", [(t, c) for t in TASKS for c in ("post-reset", "in-contact")])
def test_step_matches_jax(task, case):
    rec = _record(f"torch_{task}_step.npz")
    assert not rec[f"{case}/done"].any(), "an env reset in the compared step"
    (ts1, *_), ts1_j = _compare_step(rec, case, task)
    _diff("commands", ts1_j.env.commands, ts1.env.commands, CMD_TOL)
    if task == "go1football-defender":  # the script commanded the third robot
        assert tuple(ts1.env.commands.shape) == (E, 3, 3)
        assert float(ts1.env.commands[:, 2].abs().max()) > 0.0


@pytest.mark.parametrize("task", TASKS)
def test_wrapper_sizes_and_geometry_match_jax(task):
    jwrap, twrap = wrapper_sizes_match(task)
    for occ in (0, 1):
        assert twrap._block_x("gate", occurrence=occ) == jwrap._block_x("gate", occurrence=occ)
    assert twrap._block_x("plane", frac=1.0) == jwrap._block_x("plane", frac=1.0)
    assert twrap.env.npc_behavior == jwrap.env.npc_behavior


def _defender_states(num_envs, seed=0):
    """Defender, ball and yaw drawn around the goal: x from 4 m before the
    gate to 3 m past it, yaw over the whole circle."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((num_envs, 3, 3), np.float32)
    pos[:, 2, 0] = 12.0 + rng.uniform(-4.0, 3.0, num_envs)
    pos[:, 2, 1] = rng.uniform(-3.0, 3.0, num_envs)
    pos[:, :, 2] = 0.3
    yaw = rng.uniform(-np.pi, np.pi, num_envs)
    quat = np.tile(np.array([0, 0, 0, 1.0], np.float32), (num_envs, 3, 1))
    quat[:, 2, 2], quat[:, 2, 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    ball = np.stack([rng.uniform(2.0, 14.0, num_envs), rng.uniform(-3.0, 3.0, num_envs),
                     np.full(num_envs, 0.1)], -1)[:, None].astype(np.float32)
    return pos, quat, ball


def test_defender_commands_match_jax():
    """The script's command on drawn states, before and past the gate, port
    against JAX op by op (no jit): within 1e-5. The states are ones where
    an atan2 in place of the script's arctan would give another command."""
    import jax.numpy as jnp

    from mqe_tpu.envs.registry import make_mqe_env as make_jax_env

    n = 64
    jenv = make_jax_env(TASKS[0], num_envs=n, seed=0)[0].env
    tenv = make_torch_env(TASKS[0], num_envs=n, seed=0, device="cpu")[0].env
    np.testing.assert_array_equal(tenv.env_origins.numpy(), np.asarray(jenv.env_origins))
    pos, quat, ball = _defender_states(n)
    pos[..., :2] += tenv.env_origins.numpy()[:, None, :2]
    ball[..., :2] += tenv.env_origins.numpy()[:, None, :2]

    def state(arr):
        return SimpleNamespace(phys=SimpleNamespace(
            agents=SimpleNamespace(pos=arr(pos), quat=arr(quat)),
            npcs=SimpleNamespace(pos=arr(ball))))

    ref = np.asarray(jenv._defender_commands(state(jnp.asarray)))
    out = tenv._defender_commands(state(torch.from_numpy))
    _diff("defender commands", ref, out, CMD_TOL)
    past = pos[:, 2, 0] > tenv.env_origins.numpy()[:, 0] + 12.0
    assert 10 < past.sum() < n - 10
    # an atan2 in the script's place would turn the defender otherwise
    to_gate = tenv.env_origins.numpy() + np.array([12.0, 0.0, 0.0]) - pos[:, 2]
    dyaw = np.arctan2(2 * quat[:, 2, 2] * quat[:, 2, 3], 1 - 2 * quat[:, 2, 2] ** 2)
    atan2_cmd = np.clip(np.arctan2(to_gate[:, 1], to_gate[:, 0]) - dyaw, -0.3, 0.3) / 0.3
    assert (np.abs(atan2_cmd - ref[:, 2]) > 0.1).sum() > 10


def test_defender_wrapper_commands_two_of_three():
    """Actions and reward of the 2 controlled robots, the script's command
    appended for the third, the 3 robots stepped."""
    wrap, _ = make_torch_env(TASKS[0], num_envs=E, seed=0, device="cpu")
    assert (wrap.controlled_agents, wrap.num_agents) == (2, 3)
    ts, obs = wrap.reset()
    assert tuple(obs.shape) == (E, 2, 20)
    acts = torch.as_tensor(np.random.RandomState(1).uniform(-1, 1, (E, 2, 3)), dtype=torch.float32)
    script = wrap.env._defender_commands(ts.env)
    ts1, obs1, rew, done, _ = wrap.step(ts, acts)
    assert tuple(obs1.shape) == (E, 2, 20) and tuple(rew.shape) == (E, 2)
    assert tuple(ts1.env.phys.agents.pos.shape) == (E, 3, 3)
    assert torch.equal(ts1.env.commands[:, :2], torch.clamp(acts * wrap.action_scale, -1, 1))
    assert torch.equal(ts1.env.commands[:, 2], torch.clamp(script, -1, 1))


def test_football_game_goal_reward_matches_jax():
    """Ball past the right goal, past the left one, and in play, for 1vs1
    and 2vs2: the zero-sum team reward and its term, port against JAX's
    `_reward` (op by op)."""
    import jax.numpy as jnp

    from mqe_tpu.envs.registry import make_mqe_env as make_jax_env

    for task in TASKS[1:]:
        jwrap, _ = make_jax_env(task, num_envs=3, seed=0)
        twrap, _ = make_torch_env(task, num_envs=3, seed=0, device="cpu")
        xs = [twrap._block_x("gate", occurrence=1) + 0.5, twrap._block_x("gate") - 0.5, 6.0]
        ball = twrap.env.env_origins.numpy()[:, None, :] + np.array([[x, 0.0, 0.1] for x in xs],
                                                                   np.float32)[:, None]
        outs = []
        for w, arr in ((jwrap, jnp.asarray), (twrap, torch.from_numpy)):
            st = SimpleNamespace(phys=SimpleNamespace(npcs=SimpleNamespace(pos=arr(ball))))
            rew, _, terms = w._reward(st, None, {}, None, {})
            outs.append((np.asarray(rew), np.asarray(terms["goal reward"])))
        (rj, tj), (rt, tt) = outs
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(tt, tj)
        half = twrap.num_agents // 2
        assert (rt[0, :half] == 10).all() and (rt[0, half:] == -10).all()
        assert (rt[1, :half] == -10).all() and (rt[2] == 0).all()


def test_ball_substep_matches_jax(static_golden, monkeypatch):  # noqa: F811
    seen = static_substep_matches(static_golden, "football-ball", monkeypatch)
    (_, (f_sph, wrench)), = seen["_npc_prim_force"]
    # the ball's sphere primitive pushed on a robot, and the robot on the ball, in both envs
    assert bool((f_sph.norm(dim=-1).amax(dim=1) > 1.0).all())
    assert bool((wrench.abs().flatten(1).amax(dim=1) > 1.0).all())
