"""The tasks the port runs beside go1gate (go1plane, go1pushbox, go1seesaw)
and the masked reset, against recorded JAX steps; the base wrapper's parts.

- One control step of go1plane, go1pushbox and go1seesaw at 2 envs, from the
  post-reset state and from the state after 25 steps, against the JAX
  package's step from the same state with the same actions, NPC state
  included (tests/goldens/torch_<task>_step.npz).
- The reset step, for go1gate and go1pushbox: from a state one step short of
  the episode's end, every env times out and takes the masked reset. The
  JAX step's fresh state goes in through `Draws` under "fresh"; the state,
  observations, reward, done and the fresh extras are compared
  (tests/goldens/torch_go1gate_reset_step.npz, and the "reset-step" case of
  torch_go1pushbox_step.npz).
- The base wrapper's geometry helpers, sizes, hooks and observation against
  the JAX package's wrappers, that a camera config it once refused builds
  (the camera is held in tests/test_torch_camera.py, the `policy` backend
  in tests/test_torch_policy.py), and that its registry has the JAX
  package's task names.

tests/test_torch_football.py, tests/test_torch_fixtures.py and
tests/test_torch_sheep.py hold the other ten tasks, with the helpers below.

tools/make_torch_goldens.py writes the records. Tolerances are those of
tests/test_torch_env.py: tests/test_soa_episode.py::TOLS on the agents' state
(and the NPCs'), OTHER_TOLS on observations, reward and controller state.
"""
import os

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs import tasks as T
from mqe_tpu_torch.envs import wrappers as W
from mqe_tpu_torch.envs.go1_env import Go1Env
from mqe_tpu_torch.envs.registry import ENV_DICT
from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.utils.convert import env_state_from_numpy
from test_torch_env import OTHER_TOLS, TOLS, _tree

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
NUM_ENVS = 2
TASKS = ("go1plane", "go1pushbox", "go1seesaw")


def _record(name):
    with np.load(os.path.join(GOLDENS, name)) as f:
        return dict(f)


def _diff(name, a, b, tol):
    a = np.asarray(a)
    assert a.shape == tuple(b.shape), name
    d = float(np.abs(a.astype(np.float64) - b.numpy().astype(np.float64)).max()) if a.size else 0.0
    assert d <= tol, f"{name}: max diff {d:.3e} > {tol:.0e}"
    return d


def _compare_step(rec, case, task, draws=None, selfplay=False, wrap=None):
    """Step the port from the recorded start; compare with the recorded step.
    The sheep script's recorded draw goes in under "npc_noise"; `selfplay`
    turns the wrapper's flag on; `wrap`, where given, is the port's wrapper
    to step (else the task's at NUM_ENVS envs). Returns (port outputs, JAX's
    step)."""
    if wrap is None:
        wrap, _ = make_torch_env(task, num_envs=NUM_ENVS, seed=0, device="cpu")
    wrap.selfplay = selfplay
    ts_t = env_state_from_numpy(_tree(rec, f"{case}/start"), device="cpu")
    given = dict(draws or {})
    if f"{case}/npc_noise" in rec:
        given["npc_noise"] = rec[f"{case}/npc_noise"]
    draws = wrap.env.draws(given) if given else None
    out = wrap.step(ts_t, torch.as_tensor(rec[f"{case}/actions"]), draws)
    ts1_t, obs_t, rew_t, done_t, info_t = out
    ts1_j = _tree(rec, f"{case}/out")
    assert np.array_equal(done_t.numpy(), rec[f"{case}/done"])
    diffs = {}
    for who in ("agents", "npcs"):
        a_j, a_t = getattr(ts1_j.env.phys, who), getattr(ts1_t.env.phys, who)
        for n, tol in TOLS.items():
            diffs[f"{who}.{n}"] = _diff(f"{who}.{n}", getattr(a_j, n), getattr(a_t, n), tol)
    diffs["obs"] = _diff("obs", rec[f"{case}/obs"], obs_t, OTHER_TOLS["obs"])
    diffs["reward"] = _diff("reward", rec[f"{case}/reward"], rew_t, OTHER_TOLS["reward"])
    for n, tol in OTHER_TOLS.items():
        if n not in ("obs", "reward"):
            diffs[n] = _diff(n, getattr(ts1_j.env, n), getattr(ts1_t.env, n), tol)
    extra_j = getattr(ts1_j, "extra", {})  # an empty dict leaves no record
    assert set(ts1_t.extra) == set(extra_j)
    for k in extra_j:
        np.testing.assert_allclose(ts1_t.extra[k].numpy(), extra_j[k], atol=1e-5, err_msg=k)
    print(f"{task} {case}: " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))  # with -s
    return out, ts1_j


@pytest.mark.parametrize("task,case", [(t, c) for t in TASKS for c in ("post-reset", "in-contact")])
def test_step_matches_jax(task, case):
    rec = _record(f"torch_{task}_step.npz")
    assert not rec[f"{case}/done"].any(), "an env reset in the compared step"
    (ts1, *_), _ = _compare_step(rec, case, task)
    if task == "go1pushbox":  # the box moved, as the JAX package moved it (the
        # seesaw's plank, balanced on its hinge, rests until a robot steps on it)
        npc0 = _tree(rec, f"{case}/start").env.phys.npcs
        assert any(not np.array_equal(getattr(ts1.env.phys.npcs, n).numpy(), getattr(npc0, n))
                   for n in TOLS)


@pytest.mark.parametrize("task,name", [("go1gate", "torch_go1gate_reset_step.npz"),
                                       ("go1pushbox", "torch_go1pushbox_step.npz")])
def test_reset_step_matches_jax(task, name):
    """Timeout in every env: the masked reset takes JAX's fresh state, the
    wrapper zeroes its progress terms and starts fresh extras."""
    reset_step_matches(task, name)


def reset_step_matches(task, name):
    """The "reset-step" case of the record `name`, replayed and compared
    field by field. Returns (port outputs, JAX's step, the fresh state)."""
    rec = _record(name)
    case = "reset-step"
    assert rec[f"{case}/done"].all()
    fresh = env_state_from_numpy(_tree(rec, f"{case}/fresh"), device="cpu")
    (ts1, obs, rew, done, info), ts1_j = _compare_step(rec, case, task, {"fresh": fresh})
    assert done.all() and info["time_outs"].all()
    # every field of the env state is the fresh one but the step's flags
    flags = ("done", "collide", "r_term", "p_term")
    j_env = ts1_j.env
    for field in type(ts1.env).__dataclass_fields__:
        if field in ("phys", "dr"):
            continue
        a, b = getattr(j_env, field), getattr(ts1.env, field)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=field)
        if field not in flags:
            np.testing.assert_array_equal(b.numpy(), getattr(fresh, field).numpy(), err_msg=field)
    for k in ("mu_scale", "payload", "com_shift", "motor_strength"):
        np.testing.assert_array_equal(getattr(ts1.env.dr, k).numpy(), getattr(j_env.dr, k), err_msg=k)
    np.testing.assert_array_equal(ts1.env.phys.npcs.pos.numpy(), fresh.phys.npcs.pos.numpy())
    np.testing.assert_array_equal(info["ep_success"].numpy(), np.zeros(NUM_ENVS, bool))
    return (ts1, obs, rew, done, info), ts1_j, fresh


def wrapper_sizes_match(task):
    """The port's wrapper of `task` against the JAX package's, built (not
    run) at 2 envs: sizes, block geometry, NPC init and the scene's NPC
    flags. Returns (JAX wrapper, port wrapper)."""
    from mqe_tpu.envs.registry import make_mqe_env as make_jax_env

    jwrap, _ = make_jax_env(task, num_envs=NUM_ENVS, seed=0)
    twrap, _ = make_torch_env(task, num_envs=NUM_ENVS, seed=0, device="cpu")
    assert type(twrap).__name__ == type(jwrap).__name__
    for attr in ("obs_dim", "action_dim", "num_agents", "num_npcs", "has_success", "selfplay",
                 "selfplay_punishment"):
        assert getattr(twrap, attr) == getattr(jwrap, attr), attr
    assert twrap.controlled_agents == getattr(jwrap, "controlled_agents", jwrap.num_agents)
    options = twrap.bt["options"]
    assert twrap._gate_x(*options) == jwrap._gate_x(*options)
    for name in set(options):
        for frac in (0.0, 0.5):
            assert twrap._block_x(name, frac=frac) == jwrap._block_x(name, frac=frac)
    with pytest.raises(KeyError):
        twrap._block_x(options[0], occurrence=5)
    np.testing.assert_array_equal(twrap.env.npc_init.numpy(), np.asarray(jwrap.env.npc_init))
    np.testing.assert_array_equal(twrap.env.npc_default_q.numpy(),
                                  np.asarray(jwrap.env.npc_default_q))
    assert twrap.env.scene.num_npcs == jwrap.env.scene.num_npcs
    assert twrap.env.scene.npc_root_free == jwrap.env.scene.npc_root_free
    return jwrap, twrap


@pytest.mark.parametrize("task", ("go1gate",) + TASKS)
def test_wrapper_sizes_and_geometry_match_jax(task):
    wrapper_sizes_match(task)


def test_rl_prescale_and_observe():
    import jax.numpy as jnp
    from mqe_tpu.envs.wrappers import TaskWrapper as JaxTaskWrapper

    wrap, _ = make_torch_env("go1pushbox", num_envs=NUM_ENVS, seed=0, device="cpu")
    x = np.linspace(-4, 4, 24, dtype=np.float32).reshape(NUM_ENVS, 2, 6)[..., :3]
    ref = JaxTaskWrapper.rl_prescale(None, jnp.asarray(x))
    np.testing.assert_allclose(wrap.rl_prescale(torch.from_numpy(x.copy())).numpy(),
                               np.asarray(ref), atol=1e-7)
    ts, obs = wrap.reset()
    assert torch.equal(wrap.observe(ts), obs)
    ts1, obs1, *_ = wrap.step(ts, torch.zeros(NUM_ENVS, 2, 3))
    assert torch.equal(wrap.observe(ts1), obs1)


def test_transform_actions_and_selfplay_hooks():
    """A wrapper's `_transform_actions` reaches the commands, before the
    action scale; with `selfplay` on, `_selfplay_reward` replaces the reward,
    read on the pre-reset state."""
    seen = {}

    class Mirrored(W.Go1PushboxWrapper):
        def _transform_actions(self, actions):
            return actions.flip(1)

        def _selfplay_reward(self, pre_state, pre_obs, reward, extra):
            seen["pre_episode_length"] = pre_state.episode_length.clone()
            return -reward - 1.0

    env = Go1Env(T.Go1PushboxCfg, num_envs=NUM_ENVS, seed=0, device="cpu")
    wrap = Mirrored(env)
    ts, _ = wrap.reset()
    acts = torch.as_tensor(np.random.RandomState(1).uniform(-1, 1, (NUM_ENVS, 2, 3)),
                           dtype=torch.float32)
    ts1, _, rew, _, _ = wrap.step(ts, acts)
    assert torch.allclose(ts1.env.commands, torch.clamp(acts.flip(1) * wrap.action_scale, -1, 1))
    plain = W.Go1PushboxWrapper(env)
    _, _, rew_plain, _, _ = plain.step(ts, acts)
    assert torch.equal(rew, rew_plain)          # selfplay is off by default
    wrap.selfplay = True
    _, _, rew_sp, _, _ = wrap.step(ts, acts)
    assert torch.equal(rew_sp, -rew - 1.0)
    assert torch.equal(seen["pre_episode_length"], ts.env.episode_length + 1)


class _Camera(T.Go1GateCfg):
    class obs(T.Go1GateCfg.obs):
        class cfgs(T.Go1GateCfg.obs.cfgs):
            depth_image = True


@pytest.mark.parametrize("cfg,item", [
    (_Camera, "cameras (ROADMAP Queue A item 14)"),
], ids=["camera"])
def test_what_the_port_refuses_names_its_roadmap_item(cfg, item):
    """What the port once refused (`item`) now builds on the CPU: the
    camera env renders its depth image at reset."""
    env = Go1Env(cfg, num_envs=NUM_ENVS, device="cpu")
    assert env.cam_depth and not env.cam_rgb
    _, ob = env.reset()
    assert tuple(ob.depth_image.shape) == (NUM_ENVS, 2) + tuple(env.cam_res)


def test_tasks_not_ported_name_item_11():
    """No task is left to item 11: the port's registry has exactly the JAX
    package's task names, each with the wrapper of the same name (the JAX
    registry is imported, nothing of it run)."""
    from mqe_tpu.envs.registry import ENV_DICT as JAX_ENV_DICT

    assert list(ENV_DICT) == list(JAX_ENV_DICT)
    for name, entry in JAX_ENV_DICT.items():
        assert ENV_DICT[name]["wrapper"].__name__ == entry["wrapper"].__name__, name
        assert ENV_DICT[name]["config"].__name__ == entry["config"].__name__, name
