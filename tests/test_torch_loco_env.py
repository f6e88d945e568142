"""Locomotion training in the port (mqe_tpu_torch/learn/locomotion_env.py,
learn/train_locomotion.py) against the JAX package (mqe_tpu/learn).

The JAX side is recorded by tools/make_torch_goldens.py:
tests/goldens/torch_locomotion_step.npz holds LocomotionEnv at 4 envs, its
reset from PRNGKey(0) with its draws, and one step with its draws and fresh
state in five cases: from the reset state, residual with action lag on
("residual-lag"), the `policy` backend, multi-gait 0.5 with resample_prob
0.5; from the state after 10 steps, where the lagged actions reach the
actuators, the `policy` backend ("policy-warm") and a step in which env 0
times out (masked reset, the command curriculum widens, the gait is
redrawn) and env 1 reaches the 5 s resample ("finish").
tests/goldens/torch_locomotion_ppo_update.npz holds one PPO update of
LocomotionEnv at 2 envs (T = 4, the network at narrow widths) with its draws.
No JAX jit runs here.

Tolerances are the existing ones: the robots' state at
tests/test_soa_episode.py's per-step `TOLS`, reward and controller state at
tests/test_torch_env.py's `OTHER_TOLS`, the 70-dim observation at its
`loco_obs` bound, each reward term and the commands 1e-4; `cmd_scale`,
`done`, `reset_mask` and `time_outs` equal. The PPO update:
tests/test_torch_learn.py's bounds, params after SGD 1e-5. The `slow` twins
compare against a live JAX recording.
"""
import importlib.util
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from mqe_tpu_torch import ASSETS_DIR
from mqe_tpu_torch.envs.go1_env import Go1Env
from mqe_tpu_torch.learn.locomotion_env import LocomotionEnv, LocomotionTrainCfg, locomotion_cfg
from mqe_tpu_torch.learn.ppo import PPOConfig, PPOTrainer
from mqe_tpu_torch.utils.convert import actor_critic_from_numpy, env_state_from_numpy
from test_torch_env import OTHER_TOLS, TOLS, _tree
from test_torch_learn import UPDATE_CFG, _close, _nested, _params, _params_close

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
# case: (backend, multi_gait, resample_prob), as the recorder's LOCO_CASES
CASES = {"residual-lag": ("residual", 0.0, 0.0), "policy": ("policy", 0.0, 0.0),
         "multi-gait": ("residual", 0.5, 0.5), "policy-warm": ("policy", 0.0, 0.0),
         "finish": ("residual", 0.5, 0.5)}
TERM_TOL = 1e-4
# LocomotionEnv's observation is the 70-dim walk-these-ways obs: held at the
# bound the env step tests hold it to (OTHER_TOLS["loco_obs"]); its dims
# 30-41 are qd * 0.05, and qd's own bound is TOLS' 2e-2
OBS_TOL = OTHER_TOLS["loco_obs"]
CONTROLLER = ("gait_indices", "clock_inputs", "last_loco_action", "err_hist", "vel_int")


def _load(name):
    with np.load(os.path.join(GOLDENS, name)) as f:
        return dict(f)


@pytest.fixture(scope="module")
def loco():
    return _load("torch_locomotion_step.npz")


def _env(case, num_envs=4):
    backend, multi_gait, resample_prob = CASES[case]
    return LocomotionEnv(num_envs=num_envs, seed=0, cfg=locomotion_cfg(backend),
                         multi_gait=multi_gait, resample_prob=resample_prob, device="cpu")


def _given(rec, prefix):
    """The named draws recorded under "<prefix>/<name>"."""
    return {k[len(prefix) + 1:]: v for k, v in rec.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("case", list(CASES))
def test_reset_matches_jax(loco, case):
    """The reset from JAX's fresh state and command (and gait) draws gives
    JAX's commands, gait table rows and observation."""
    env = _env(case)
    start = _tree(loco, f"{case}/reset/state")
    given = _given(loco, f"{case}/reset/draws")
    given["fresh"] = env_state_from_numpy(start.env, device="cpu")
    ts, obs = env.reset(env.draws(given))
    _close(ts.commands, start.commands, TERM_TOL, what="commands")
    _close(ts.gait_pob, start.gait_pob, 0.0, what="gait_pob")
    _close(obs, loco[f"{case}/reset/obs"], OBS_TOL, what="obs")
    assert float(ts.cmd_scale) == float(start.cmd_scale) == 1.0


def loco_step_matches(rec, case, env=None):
    """One LocomotionEnv step from JAX's start with JAX's draws, compared.
    Returns (port step outputs, JAX's out state)."""
    env = env or _env(case)
    start = env_state_from_numpy(_tree(rec, f"{case}/start"), device="cpu")
    given = _given(rec, f"{case}/draws")
    given["fresh"] = env_state_from_numpy(_tree(rec, f"{case}/fresh"), device="cpu")
    out = env.step(start, torch.as_tensor(rec[f"{case}/actions"]), env.draws(given))
    ts1, obs, rew, done, info = out
    j = _tree(rec, f"{case}/out")
    for name in ("done", "reset_mask", "time_outs"):
        got = done if name == "done" else info[name]
        assert np.array_equal(got.numpy(), rec[f"{case}/{name}"]), name
    assert float(ts1.cmd_scale) == float(j.cmd_scale), "cmd_scale"
    diffs = {}
    ag_j, ag_t = j.env.phys.agents, ts1.env.phys.agents
    for n, tol in TOLS.items():
        diffs[n] = _close(getattr(ag_t, n), getattr(ag_j, n), tol, what=n)
    diffs["obs"] = _close(obs, rec[f"{case}/obs"], OBS_TOL, what="obs")
    diffs["reward"] = _close(rew, rec[f"{case}/reward"], OTHER_TOLS["reward"], what="reward")
    for n in CONTROLLER:
        diffs[n] = _close(getattr(ts1.env, n), getattr(j.env, n), OTHER_TOLS[n], what=n)
    diffs["lag_buffer"] = _close(ts1.env.lag_buffer, j.env.lag_buffer,
                                 OTHER_TOLS["last_loco_action"], what="lag_buffer")
    terms_j = _given(rec, f"{case}/terms")
    assert set(info["reward_terms"]) == set(terms_j) == set(env.reward_term_names())
    for k, v in terms_j.items():
        diffs[k] = _close(info["reward_terms"][k], v, TERM_TOL, what=k)
    diffs["commands"] = _close(ts1.commands, j.commands, TERM_TOL, what="commands")
    _close(ts1.gait_pob, j.gait_pob, 0.0, what="gait_pob")
    _close(ts1.last_action, j.last_action, 1e-6, what="last_action")
    _close(ts1.last_qd, j.last_qd, TOLS["qd"], what="last_qd")
    _close(ts1.feet_air, j.feet_air, 1e-6, what="feet_air")
    _close(ts1.track_acc, j.track_acc, TERM_TOL, what="track_acc")
    assert np.array_equal(ts1.last_contact.numpy(), j.last_contact), "last_contact"
    print(f"{case}: " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))  # shown with -s
    return out, j


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(loco, case):
    (ts1, _, _, done, _), _ = loco_step_matches(loco, case)
    if case == "finish":
        # env 0 timed out and took the fresh state; the curriculum widened;
        # env 1's command was redrawn at the 5 s mark
        assert done.tolist() == [True, False, False, False]
        assert float(ts1.cmd_scale) == pytest.approx(1.02)
        assert int(ts1.env.episode_length[0]) == 0 and int(ts1.env.episode_length[1]) == 250
        start = _tree(loco, f"{case}/start")
        assert not np.allclose(ts1.commands[1].numpy(), start.commands[1])
    else:
        assert not done.any()


@pytest.fixture(scope="module")
def tool():
    """tools/make_torch_goldens.py, for the `slow` live twins."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_goldens", os.path.join(os.path.dirname(GOLDENS), "..", "tools",
                                           "make_torch_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def live_loco(tool):
    return tool.record_locomotion()


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_live_jax(live_loco, case):
    loco_step_matches(live_loco, case)


def test_locomotion_env_step():
    """Mirrors tests/test_learn_locomotion.py::test_locomotion_env_step."""
    env = LocomotionEnv(num_envs=4, seed=0, device="cpu")
    ts, obs = env.reset()
    assert obs.shape == (4, 1, 70)
    for _ in range(3):
        ts, obs, rew, done, info = env.step(ts, torch.zeros((4, 1, 12)))
    assert torch.isfinite(obs).all() and torch.isfinite(rew).all()
    assert rew.shape == (4, 1)
    assert float(ts.cmd_scale) >= 1.0


def test_lag_buffer_delays_targets():
    """Mirrors tests/test_learn.py::test_lag_buffer_delays_targets: with lag
    on, the actuated joint target is the OLDEST lag entry, so a fresh action
    has no effect until the FIFO fills (ref go1.py:337-339)."""
    env = Go1Env(LocomotionTrainCfg, num_envs=2, seed=0, device="cpu")
    assert env.lag_len == 6
    state = env.fresh_state()
    action = torch.ones((2, 1, 12))
    _, _, _, target = env._torques(state, action)
    np.testing.assert_allclose(target.numpy(), np.broadcast_to(env.default_q_np, (2, 1, 12)),
                               atol=1e-6)
    st = state
    for _ in range(env.lag_len + 1):
        _, _, lagbuf, target = env._torques(st, action)
        st = replace(st, lag_buffer=lagbuf)
    expect = env.default_q_np + env.action_scale * env.hip_scale.numpy()
    np.testing.assert_allclose(target[0, 0].numpy(), expect, atol=1e-5)

    class CfgOff(LocomotionTrainCfg):
        class domain_rand(LocomotionTrainCfg.domain_rand):
            randomize_lag_timesteps = False

    env0 = Go1Env(CfgOff, num_envs=2, seed=0, device="cpu")
    assert env0.lag_len == 0
    _, _, _, target0 = env0._torques(env0.fresh_state(), action)
    np.testing.assert_allclose(target0[0, 0].numpy(), expect, atol=1e-5)


# ---------------------------------------------------------------------------
# one PPO update of LocomotionEnv, train_locomotion
# ---------------------------------------------------------------------------

def loco_update_matches(rec):
    env = LocomotionEnv(num_envs=2, seed=0, device="cpu")
    tr = PPOTrainer(env, PPOConfig(ent_coef=1e-3, lr=3e-4, **UPDATE_CFG))
    tr.net = actor_critic_from_numpy(_nested(rec, "init/params"), device="cpu")
    params = _params(tr.net)
    ts = replace(tr.init_state(), params=params, opt_state=tr.tx.init(params),
                 env_state=env_state_from_numpy(_tree(rec, "start"), device="cpu"))
    given = {"act_noise": rec["noise"], "perm": rec["perm"], **_given(rec, "draws")}
    rollout = tr._rollout(ts, given)
    env_state, traj, final_value, ep_acc, _ = rollout
    diffs = {}
    for name, tol in (("obs", OBS_TOL), ("reward", OTHER_TOLS["reward"]),
                      ("action", 1e-4), ("logp", 1e-4), ("value", 1e-4)):
        diffs[name] = _close(traj[name], rec[f"traj/{name}"], tol, what=name)
    assert torch.equal(traj["done"], torch.as_tensor(rec["traj/done"]))
    diffs["final_value"] = _close(final_value, rec["final_value"], 1e-4, what="final_value")
    out = _tree(rec, "out_env")
    for name, tol in TOLS.items():
        diffs[name] = _close(getattr(env_state.env.phys.agents, name),
                             getattr(out.env.phys.agents, name), tol, what=name)
    for k, v in ep_acc.term_sums.items():
        _close(v, rec[f"ep_acc/term_sums/{k}"], TERM_TOL, what=k)
    after, metrics = tr._learn(ts, rollout, given)
    diffs["params"] = _params_close(tr.net, after.params, _nested(rec, "after/params"), 1e-5)
    assert int(after.opt_state.count) == 16
    for k in ("ret_mean", "ret_var"):
        _close(getattr(after, k), rec[f"after/{k}"], 1e-5, what=k)
    for k, v in metrics.items():
        _close(v, rec[f"after/metrics/{k}"], 1e-5, 1e-5, k)
    print(", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))  # shown with -s


def test_locomotion_ppo_update_matches_jax():
    """One PPO update of LocomotionEnv from JAX's state, params and draws:
    the 4-step rollout, then the 16 minibatch steps."""
    loco_update_matches(_load("torch_locomotion_ppo_update.npz"))


@pytest.mark.slow
def test_locomotion_ppo_update_matches_live_jax(tool):
    loco_update_matches(tool.record_loco_ppo_update())


def test_warm_start_takes_every_leaf():
    """--init-policy: every leaf of the committed body policy goes in."""
    from mqe_tpu_torch.learn.train_locomotion import policy_npz, warm_start

    tr = PPOTrainer(LocomotionEnv(num_envs=2, seed=0, device="cpu"), PPOConfig())
    path = os.path.join(ASSETS_DIR, "body_policy.npz")
    params, missing = warm_start(tr.net, tr.init_params, path)
    assert missing == []
    with np.load(path) as d:
        back = policy_npz(tr.net, params, float(d["meta_prescale"]))
        assert set(back) == set(d.files)
        for k in d.files:
            np.testing.assert_array_equal(back[k], d[k], err_msg=k)


def test_train_locomotion_cli(tmp_path, capsys):
    """The CLI at 2 envs on the CPU, warm-started from the committed body
    policy: its npz gives the same actions through the JAX package's
    load_body_policy as through the port's, and nothing under mqe_tpu/ is
    written."""
    from mqe_tpu.control import nets as jnets

    from mqe_tpu_torch.control.nets import load_body_policy
    from mqe_tpu_torch.learn import train_locomotion

    before = {f: os.stat(os.path.join(ASSETS_DIR, f)).st_mtime_ns for f in os.listdir(ASSETS_DIR)}
    out = str(tmp_path / "bp.npz")
    path = train_locomotion.main([
        "--num-envs", "2", "--rollout-len", "4", "--train-timesteps", "8", "--out", out,
        "--cpu", "--init-policy", os.path.join(ASSETS_DIR, "body_policy.npz")])
    text = capsys.readouterr().out
    assert path == out and os.path.exists(out)
    assert "warm-started from" in text and "fresh:" not in text and '"update": 1' in text
    obs = np.random.RandomState(6).randn(5, 70).astype(np.float32)
    want = np.asarray(jnets.load_body_policy(out)(obs))
    got = load_body_policy(out, device="cpu")(torch.as_tensor(obs))
    _close(got, want, 1e-5, what="actions")
    after = {f: os.stat(os.path.join(ASSETS_DIR, f)).st_mtime_ns for f in os.listdir(ASSETS_DIR)}
    assert after == before
