"""The `policy` locomotion backend of the port's Go1Env, the step options
that locomotion training turns on, the gym adapters and the demo, against the
JAX package.

The JAX sides are recorded by tools/make_torch_goldens.py:
- tests/goldens/torch_policy_step.npz: go1plane with the `policy` backend,
  one step each with the body policy of assets/body_policy.npz and
  policy_pd_augment off ("npz") and on ("npz-pd"), and with the
  walk-these-ways stack ("wtw": the assets without body_policy.npz, so the
  env keeps a 30-step history, and a body MLP drawn from a seed installed by
  load_locomotion_policy); and one `_torques` call with the PD gated off and
  on ("torques/pd0", "torques/pd1");
- tests/goldens/torch_go1gate_events_step.npz: go1gate with push (every
  step), action lag, tanh and delta command clipping on, one step from a
  warmed state ("push-lag-clip") and one from a state where roll, pitch,
  z_low and collide each fire in some env ("terminations").

Tolerances are tests/test_torch_env.py's (`TOLS` on the robots' state,
`OTHER_TOLS` on obs, reward and controller state); flags equal; torques
1e-4 (tests/test_torch_locomotion.py's bound); the nets' outputs 1e-5
(tests/test_torch_learn.py's bound for a network's outputs), relative for
the adaptation module's large latents on drawn input (its loss and gradient
bound, rtol 1e-5).
"""
import importlib.util
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mqe_tpu_torch
from mqe_tpu.control import nets as jnets
from mqe_tpu_torch.control.nets import AdaptationModule, BodyPolicy, WalkTheseWaysBody
from mqe_tpu_torch.envs import tasks as T
from mqe_tpu_torch.envs import wrappers as W
from mqe_tpu_torch.envs.go1_env import Go1Env
from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.utils.convert import env_state_from_numpy, wtw_body_from_numpy
from test_torch_env import OTHER_TOLS, _tree
from test_torch_tasks import NUM_ENVS, _compare_step, _diff, _record

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU_TOL = 1e-4  # torques, as tests/test_torch_locomotion.py bounds them


def policy_cfg(pd_augment=False, base=T.Go1PlaneCfg):
    class Cfg(base):
        class control(base.control):
            locomotion_backend = "policy"
            policy_pd_augment = pd_augment

    return Cfg


@pytest.fixture
def assets_without_npz(tmp_path, monkeypatch):
    """The port's assets directory pointed at a copy without body_policy.npz."""
    for f in os.listdir(mqe_tpu_torch.ASSETS_DIR):
        if f != "body_policy.npz":
            shutil.copy(os.path.join(mqe_tpu_torch.ASSETS_DIR, f), tmp_path)
    monkeypatch.setattr(mqe_tpu_torch, "ASSETS_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture(scope="module")
def policy_rec():
    return _record("torch_policy_step.npz")


@pytest.fixture(scope="module")
def tool():
    """tools/make_torch_goldens.py, for `wtw_params` and the `slow` live twins."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_goldens", os.path.join(REPO, "tools", "make_torch_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wrapper(cfg):
    return W.EmptyWrapper(Go1Env(cfg, num_envs=NUM_ENVS, seed=0, device="cpu"))


# ---------------------------------------------------------------------------
# the policy backend
# ---------------------------------------------------------------------------

def test_policy_config_builds():
    """The `policy` backend runs where the port refused it before: with
    assets/body_policy.npz the env takes the obs70 body policy and keeps no
    history (go1gate's config with the backend switched, as the refusal's
    test built it)."""
    env = Go1Env(policy_cfg(base=T.Go1GateCfg), num_envs=NUM_ENVS, device="cpu")
    assert env.backend == "policy" and env.hist_len == 0
    assert isinstance(env.body_policy, BodyPolicy) and isinstance(env.adaptation, AdaptationModule)
    assert tuple(env.fresh_state().loco_hist.shape) == (NUM_ENVS, 2, 0)


def test_policy_backend_without_npz_keeps_the_history(assets_without_npz):
    env = Go1Env(policy_cfg(), num_envs=NUM_ENVS, device="cpu")
    assert env.hist_len == 30 and env.body_policy is None
    assert tuple(env.fresh_state().loco_hist.shape) == (NUM_ENVS, 1, 2100)


def npz_step_matches(rec, case, pd):
    wrap = _wrapper(policy_cfg(pd))
    assert isinstance(wrap.env.body_policy, BodyPolicy)
    _compare_step(rec, case, "go1plane", wrap=wrap)


@pytest.mark.parametrize("case,pd", [("npz", False), ("npz-pd", True)])
def test_policy_backend_step_matches_jax(policy_rec, case, pd):
    """One go1plane step with the body policy of assets/body_policy.npz as
    the whole locomotion action, policy_pd_augment off and on."""
    npz_step_matches(policy_rec, case, pd)


def wtw_step_matches(rec, params):
    wrap = _wrapper(policy_cfg())
    body = wtw_body_from_numpy(params, device="cpu")
    assert isinstance(body, WalkTheseWaysBody)
    wrap.env.load_locomotion_policy(body)
    (ts1, *_), ts1_j = _compare_step(rec, "wtw", "go1plane", wrap=wrap)
    start = _tree(rec, "wtw/start").env.loco_hist
    assert start.shape == (NUM_ENVS, 1, 2100) and np.abs(start[..., :70]).max() == 0
    _diff("loco_hist", ts1_j.env.loco_hist, ts1.env.loco_hist, OTHER_TOLS["loco_obs"])
    np.testing.assert_array_equal(ts1.env.loco_hist[..., :-70].numpy(), start[..., 70:])


def test_wtw_stack_step_matches_jax(policy_rec, tool, assets_without_npz):
    """One go1plane step of the walk-these-ways stack: the (E, 1, 2100)
    history rolled, adaptation(history) -> latent, body(history || latent),
    with the recorder's seeded body weights installed by
    load_locomotion_policy."""
    wtw_step_matches(policy_rec, tool.wtw_params())


@pytest.fixture(scope="module")
def live_policy(tool):
    return tool.record_policy_backend()


@pytest.mark.slow
@pytest.mark.parametrize("case,pd", [("npz", False), ("npz-pd", True)])
def test_policy_backend_step_matches_live_jax(live_policy, case, pd):
    npz_step_matches(live_policy, case, pd)


@pytest.mark.slow
def test_wtw_stack_step_matches_live_jax(live_policy, tool, assets_without_npz):
    wtw_step_matches(live_policy, tool.wtw_params())


def test_torques_gate_the_pd_as_jax(policy_rec):
    """The repair: the trot controller's joint PD is added for `policy` only
    with policy_pd_augment (mqe_tpu/envs/go1_env.py:650-653). The two JAX
    torques differ by far more than the bound, so a port that added the PD
    always would fail the pd0 case."""
    start = env_state_from_numpy(_tree(policy_rec, "npz/start"), device="cpu").env
    tau = {}
    for pd in (0, 1):
        env = Go1Env(policy_cfg(bool(pd)), num_envs=NUM_ENVS, device="cpu")
        want = policy_rec[f"torques/pd{pd}/tau"]
        with torch.no_grad():
            tau[pd] = env._torques(start, torch.as_tensor(policy_rec[f"torques/pd{pd}/action"]))[0]
        _diff(f"tau pd{pd}", want, tau[pd], TAU_TOL)
    gap = np.abs(policy_rec["torques/pd0/tau"] - policy_rec["torques/pd1/tau"]).max()
    assert gap > 100 * TAU_TOL, gap


def test_adaptation_module_matches_jax():
    x = np.random.RandomState(8).randn(3, 2100).astype(np.float32)
    want = np.asarray(jnets.AdaptationModule()(jnp.asarray(x)))
    got = AdaptationModule(device="cpu")(torch.as_tensor(x)).detach().numpy()
    # latents of |1e3| on this input: float32 sums of 2100 products in
    # another order, held relative
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wtw_body_matches_mlp_apply(tool):
    params = tool.wtw_params()
    x = np.random.RandomState(9).randn(3, 2102).astype(np.float32)
    want = np.asarray(jnets.mlp_apply({k: ([jnp.asarray(a) for a in v] if k != "act" else v)
                                       for k, v in params.items()}, jnp.asarray(x)))
    got = wtw_body_from_numpy(params, device="cpu")(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# push, lag, tanh/delta clipping and firing terminations (go1gate)
# ---------------------------------------------------------------------------

def events_cfg():
    """The recorder's `_events_cfg`."""
    class Cfg(T.Go1GateCfg):
        class domain_rand(T.Go1GateCfg.domain_rand):
            push_robots = randomize_lag_timesteps = True
            push_interval_s = 0.02
            lag_timesteps = 6

        class normalization(T.Go1GateCfg.normalization):
            clip_actions_method = "tanh"
            clip_actions_delta = 0.1

        class termination(T.Go1GateCfg.termination):
            termination_terms = ["roll", "pitch", "z_low"]
            roll_kwargs = dict(threshold=0.8)
            pitch_kwargs = dict(threshold=1.0)
            z_low_kwargs = dict(threshold=0.12)

    return Cfg


EVENT_CASES = ("push-lag-clip", "terminations")


def events_step_matches(rec, case):
    """One go1gate step with push, lag and tanh/delta clipping, from a warmed
    state and from one where each termination term fires; the pre-reset
    flags (done, collide, r_term, p_term) equal JAX's."""
    wrap = W.Go1GateWrapper(Go1Env(events_cfg(), num_envs=4, seed=0, device="cpu"))
    given = {"push_vel": rec[f"{case}/push_vel"],
             "fresh": env_state_from_numpy(_tree(rec, f"{case}/fresh"), device="cpu")}
    (ts1, *_), ts1_j = _compare_step(rec, case, "go1gate", draws=given, wrap=wrap)
    for flag in ("done", "collide", "r_term", "p_term"):
        np.testing.assert_array_equal(getattr(ts1.env, flag).numpy(),
                                      getattr(ts1_j.env, flag), err_msg=flag)
    np.testing.assert_array_equal(ts1.env.lag_buffer.shape, (4, 2, 7, 12))
    _diff("lag_buffer", ts1_j.env.lag_buffer, ts1.env.lag_buffer, OTHER_TOLS["last_loco_action"])
    return ts1


@pytest.mark.parametrize("case", EVENT_CASES)
def test_gate_events_step_matches_jax(case):
    rec = _record("torch_go1gate_events_step.npz")
    ts1 = events_step_matches(rec, case)
    if case == "terminations":
        flags = {k: getattr(ts1.env, k).tolist() for k in ("done", "collide", "r_term", "p_term")}
        # env 0 rolls, env 1 pitches (its trunk touches), env 2 is too low
        # with no flag of its own, env 3 collides
        assert flags == {"done": [True] * 4, "collide": [False, True, False, True],
                         "r_term": [True, False, False, False],
                         "p_term": [False, True, False, False]}, flags
    else:
        start = _tree(rec, f"{case}/start").env
        assert not ts1.env.done.any()
        assert np.abs(ts1.env.commands.numpy() - start.commands).max() <= 0.1 + 1e-6


@pytest.fixture(scope="module")
def live_events(tool):
    return tool.record_events()


@pytest.mark.slow
@pytest.mark.parametrize("case", EVENT_CASES)
def test_gate_events_step_matches_live_jax(live_events, case):
    events_step_matches(live_events, case)


# ---------------------------------------------------------------------------
# the gym adapters and the demo
# ---------------------------------------------------------------------------

def test_gym_adapter():
    """Mirrors tests/test_learn.py::test_gym_adapter: numpy in and out."""
    from mqe_tpu_torch.envs.gym_adapter import GymAdapter, SingleAgentAdapter

    gate, _ = make_torch_env("go1gate", num_envs=2, seed=0, device="cpu")
    ad = GymAdapter(gate, seed=1)
    obs = ad.reset()
    assert isinstance(obs, np.ndarray) and obs.shape == (2, 2, gate.obs_dim)
    assert obs.dtype == np.float32
    o, r, d, info = ad.step(np.zeros((2, 2, 3)))
    assert o.shape == (2, 2, gate.obs_dim) and r.shape == (2, 2) and d.shape == (2, 2)
    assert r.dtype == np.float32 and d.dtype == np.bool_
    assert isinstance(info["reward_terms"], dict) and info["time_outs"].shape == (2,)
    assert all(isinstance(v, float) for v in info["reward_terms"].values())

    sa = SingleAgentAdapter(gate, seed=2)
    o = sa.reset()
    assert o.shape == (4, 1, gate.obs_dim)
    o, r, d, info = sa.step(np.zeros((4, 1, 3)))
    assert o.shape == (4, 1, gate.obs_dim) and r.shape == (4, 1) and d.shape == (4, 1)


def test_demo_main(capsys):
    from mqe_tpu_torch.scripts import demo

    out = demo.main(["--task", "go1gate", "--num-envs", "2", "--seconds", "0.06", "--cpu"])
    assert out["steps"] == 3 and np.isfinite(out["total_reward"])
    text = capsys.readouterr().out
    assert "task=go1gate envs=2 agents=2" in text and "done: 3 steps" in text
