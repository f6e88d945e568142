"""The port's training stack (mqe_tpu_torch/learn, utils/metrics.py,
utils/checkpoint.py) against the JAX package's (mqe_tpu/learn).

The JAX side is recorded by tools/make_torch_goldens.py into
tests/goldens/torch_learn.npz (networks at narrow widths, the two committed
checkpoints' policies at full width, gaussian_logp, GAE, valuenorm, the
losses and their gradients, three optimizer steps, every task's reward-term
names) and tests/goldens/torch_go1gate_ppo_update.npz (one go1gate PPO
update at 2 envs with its draws, and a MAT update from the same rollout).
No JAX runs here; the `slow` twins compare against a live JAX recording.

Tolerances: network outputs 1e-5 (float32 matmuls in another order); loss
and gradients rtol 1e-5 / atol 1e-6; optimizer steps 1e-6; the rollout's
env state at tests/test_soa_episode.py's per-step `TOLS`, its observations
and rewards at tests/test_torch_env.py's `OTHER_TOLS`, its actions,
log-probs and values 1e-4; params after an update's 16 minibatch steps 1e-5.
"""
import importlib.util
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.func import functional_call

from mqe_tpu_torch.envs.registry import ENV_DICT
from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.learn import networks as N
from mqe_tpu_torch.learn.mat import MATTrainer
from mqe_tpu_torch.learn.ppo import AdamState, ClipAdam, PPOConfig, PPOTrainer
from mqe_tpu_torch.utils.convert import (actor_critic_from_numpy, env_state_from_numpy,
                                         mat_from_numpy, params_from_jax_checkpoint)
from mqe_tpu_torch.utils.metrics import EpisodeAccumulator
from mqe_tpu_torch.utils.random import Draws
from test_torch_env import OTHER_TOLS, TOLS, _tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
CHECKPOINTS = {"go1bridge": ("checkpoints/r5b/go1bridge_ppo_best.npz", False),
               "go1gate": ("checkpoints/rec/go1gate_ppo_best.npz", True)}
UPDATE_CFG = dict(rollout_len=4, num_minibatches=4, ppo_epochs=4)
t = torch.as_tensor


def _load(name):
    with np.load(os.path.join(GOLDENS, name)) as f:
        return dict(f)


@pytest.fixture(scope="module")
def learn():
    return _load("torch_learn.npz")


@pytest.fixture(scope="module")
def update_rec():
    return _load("torch_go1gate_ppo_update.npz")


def _nested(rec, prefix):
    """The dict tree recorded under "<prefix>/...", numpy leaves."""
    root = {}
    for key, arr in rec.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = root
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = arr
    return root


def _close(got, want, atol, rtol=0.0, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want), (what, got.shape, np.shape(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)
    return float(np.abs(got - want).max()) if got.size else 0.0


def _params(net):
    return {n: dict(net.named_parameters())[n].detach() for n in N.flax_ordered_names(net)}


def _flax_leaf(net, tree, name):
    leaf = tree["params"]
    for k in N.flax_path(net, name):
        leaf = leaf[k]
    return N.from_flax_leaf(net, name, leaf)


def _params_close(net, got, tree, atol, rtol=0.0):
    worst = 0.0
    for name in N.flax_ordered_names(net):
        worst = max(worst, _close(got[name], _flax_leaf(net, tree, name).numpy(), atol, rtol, name))
    return worst


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "gru", "mat"])
def test_networks_match_flax(learn, kind):
    """Each network, its flax params carried across by the converter, gives
    flax's outputs (the GRU over three steps of its own carry)."""
    params = _nested(learn, f"nets/{kind}/params")
    obs = t(learn[f"nets/{kind}/obs"])
    pre = f"nets/{kind}/out"
    with torch.no_grad():
        if kind == "gru":
            net = actor_critic_from_numpy(params, recurrent=True, device="cpu")
            h = t(learn[f"nets/{kind}/h0"])
            for s in range(3):
                mean, log_std, value, h = net(obs[s], h)
                for name, v in (("mean", mean), ("log_std", log_std), ("value", value), ("h", h)):
                    _close(v, learn[f"{pre}/{s}/{name}"], 1e-5, what=f"step {s} {name}")
            return
        if kind == "mat":
            net = mat_from_numpy(params, device="cpu")
            out = net(obs, t(learn[f"nets/{kind}/prev"]))
        else:
            net = actor_critic_from_numpy(params, device="cpu")
            out = net(obs)
    for name, v in zip(("mean", "log_std", "value"), out):
        _close(v, learn[f"{pre}/{name}"], 1e-5, what=name)


@pytest.mark.parametrize("task", list(CHECKPOINTS))
def test_committed_checkpoints_match_flax(learn, task):
    """The committed TrainStates' policies, read by params_from_jax_checkpoint
    at full width, give the flax forward; a trainer resumes from such a file
    with its params and Adam state."""
    path, recurrent = CHECKPOINTS[task]
    path = os.path.join(REPO, path)
    obs = t(learn[f"ckpt/{task}/obs"])
    cls = N.RecurrentActorCritic if recurrent else N.ActorCritic
    net = cls(obs.shape[-1], 3)
    params = params_from_jax_checkpoint(path, net)
    assert list(params) == N.flax_ordered_names(net) and len(params) == (21 if recurrent else 17)
    with torch.no_grad():
        args = (obs, t(learn[f"ckpt/{task}/h"])) if recurrent else (obs,)
        out = functional_call(net, params, args)
    names = ("mean", "log_std", "value", "h_new")[:len(out)]
    for name, v in zip(names, out):
        _close(v, learn[f"ckpt/{task}/{name}"], 1e-5, what=name)
    if recurrent:
        wrap, _ = make_torch_env(task, num_envs=2, seed=0, device="cpu")
        tr = PPOTrainer(wrap, PPOConfig(recurrent=True))
        ts = tr.restore_checkpoint(path)
        with np.load(path) as data:
            assert int(ts.opt_state.count) == int(data["leaf_00021"])
            mu0 = data["leaf_00022"]                       # Adam mu of actor/Dense_0/bias
        assert all(torch.equal(ts.params[k], params[k]) for k in params)
        np.testing.assert_array_equal(ts.opt_state.mu["actor.Dense_0.bias"].numpy(), mu0)


# ---------------------------------------------------------------------------
# pieces of the update on fixed arrays
# ---------------------------------------------------------------------------

def _trainer_view(cls, cfg, net=None):
    """A trainer that holds only what `_gae`, `_loss` and valuenorm read."""
    tr = cls.__new__(cls)
    tr.cfg, tr.net = cfg, net
    return tr


def test_logp_gae_valuenorm_match_jax(learn):
    """gaussian_logp; valuenorm, GAE with dones mid-trajectory, the return
    statistics and the advantage normalisation (population statistics)."""
    logp = N.gaussian_logp(t(learn["logp/mean"]), t(learn["logp/log_std"]), t(learn["logp/action"]))
    _close(logp, learn["logp/out"], 1e-5, what="logp")

    tr = _trainer_view(PPOTrainer, PPOConfig())
    traj = {k: t(learn[f"gae/in/traj/{k}"]) for k in ("reward", "value", "done")}
    assert traj["done"][1:5].any() and not traj["done"][-1].all()
    stats = SimpleNamespace(ret_mean=t(learn["gae/in/ret_mean"]), ret_var=t(learn["gae/in/ret_var"]))
    vtraj, vfinal = tr._valuenorm(stats, traj, t(learn["gae/in/final_value"]))
    advs, returns = tr._gae(vtraj, vfinal)
    mean, var, norm = tr._valuenorm_update(stats, returns)
    got = dict(value=vtraj["value"], final_value=vfinal, advs=advs, returns=returns,
               ret_mean=mean, ret_var=var, ret_norm=norm(returns),
               adv_norm=tr._normalize_adv(advs))
    for name, v in got.items():
        _close(v, learn[f"gae/out/{name}"], 1e-5, what=name)
    # ddof 0: torch's default (ddof 1) would miss these by far more than 1e-5
    assert abs(float(returns.var()) - float(returns.var(correction=0))) > 1e-3


@pytest.mark.parametrize("algo", ["ppo", "dppo", "mat"])
def test_loss_and_grads_match_jax(learn, algo):
    """`_loss` and every gradient leaf against jax.value_and_grad, on a batch
    whose ratios fall on both sides of the clip and past the dual clip."""
    pre = f"loss/{algo}"
    tree = _nested(learn, f"{pre}/params")
    if algo == "mat":
        net, cls = mat_from_numpy(tree, device="cpu"), MATTrainer
    else:
        net, cls = actor_critic_from_numpy(tree, device="cpu"), PPOTrainer
    tr = _trainer_view(cls, PPOConfig(algo=algo), net)
    batch = {k: t(learn[f"{pre}/batch/{k}"]) for k in ("obs", "action", "logp", "adv", "ret")}
    leaves = {k: v.requires_grad_(True) for k, v in _params(net).items()}
    loss, aux = tr._loss(leaves, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(loss, learn[f"{pre}/out/loss"], 1e-6, 1e-5, "loss")
    for k in ("pg_loss", "v_loss", "entropy"):
        _close(aux[k], learn[f"{pre}/out/{k}"], 1e-6, 1e-5, k)
    _params_close(net, grads, _nested(learn, f"{pre}/grads"), 1e-6, 1e-5)
    if algo == "dppo":  # the dual clip binds somewhere in the batch
        with torch.no_grad():
            ratio = torch.exp(N.gaussian_logp(*tr._apply(_params(net), batch["obs"])[:2],
                                              batch["action"]) - batch["logp"])
        assert bool(((ratio > 3.0) & (batch["adv"] < 0)).any())


def test_clip_adam_matches_optax(learn):
    """Three steps of global-norm clipping then Adam, one step above the
    clip norm, against optax's chain."""
    tree0 = _nested(learn, "optim/params/0")
    net = actor_critic_from_numpy(tree0, device="cpu")
    tx = ClipAdam(PPOConfig().lr, PPOConfig().max_grad_norm)
    params = _params(net)
    state = tx.init(params)
    norms = [float(learn[f"optim/gnorm/{i}"]) for i in range(3)]
    assert norms[1] > 0.5 > max(norms[0], norms[2])
    for i in range(3):
        gtree = _nested(learn, f"optim/grads/{i}")
        grads = {k: _flax_leaf(net, gtree, k) for k in params}
        params, state = tx.step(params, grads, state)
        _params_close(net, params, _nested(learn, f"optim/params/{i + 1}"), 1e-6)
    assert isinstance(state, AdamState) and int(state.count) == 3


# ---------------------------------------------------------------------------
# one update of go1gate at 2 envs, and MAT's from the same rollout
# ---------------------------------------------------------------------------

def _update_trainer(rec, algo="ppo", prefix=""):
    wrap, _ = make_torch_env("go1gate", num_envs=2, seed=0, device="cpu")
    tree = _nested(rec, f"{prefix}init/params")
    if algo == "mat":
        tr = MATTrainer(wrap, PPOConfig(algo="mat", **UPDATE_CFG))
        tr.net = mat_from_numpy(tree, device="cpu")
    else:
        tr = PPOTrainer(wrap, PPOConfig(**UPDATE_CFG))
        tr.net = actor_critic_from_numpy(tree, device="cpu")
    params = _params(tr.net)
    ts = replace(tr.init_state(), params=params, opt_state=tr.tx.init(params))
    return tr, ts


def ppo_update_matches(rec):
    tr, ts = _update_trainer(rec)
    with np.load(os.path.join(GOLDENS, "torch_go1gate_step.npz")) as f:
        start = _tree(dict(f), "in-contact/start")
    ts = replace(ts, env_state=env_state_from_numpy(start, device="cpu"))
    given = {"act_noise": rec["noise"], "perm": rec["perm"]}
    rollout = tr._rollout(ts, given)
    env_state, traj, final_value, ep_acc, _ = rollout
    diffs = {}
    for name, tol in (("obs", OTHER_TOLS["obs"]), ("reward", OTHER_TOLS["reward"]),
                      ("action", 1e-4), ("logp", 1e-4), ("value", 1e-4)):
        diffs[name] = _close(traj[name], rec[f"traj/{name}"], tol, what=name)
    assert torch.equal(traj["done"], t(rec["traj/done"]))
    diffs["final_value"] = _close(final_value, rec["final_value"], 1e-4, what="final_value")
    out = _tree(rec, "out_env")
    for name, tol in TOLS.items():
        diffs[name] = _close(getattr(env_state.env.phys.agents, name),
                             getattr(out.env.phys.agents, name), tol, what=name)
    for name in ("gait_indices", "clock_inputs", "loco_obs", "last_loco_action", "err_hist",
                 "vel_int"):
        diffs[name] = _close(getattr(env_state.env, name), getattr(out.env, name),
                             OTHER_TOLS[name], what=name)
    for k, v in ep_acc.term_sums.items():
        _close(v, rec[f"ep_acc/term_sums/{k}"], 1e-4, what=k)
    _close(ep_acc.ep_len, rec["ep_acc/ep_len"], 0.0, what="ep_len")

    after, metrics = tr._learn(ts, rollout, given)
    diffs["params"] = _params_close(tr.net, after.params, _nested(rec, "after/params"), 1e-5)
    assert int(after.opt_state.count) == 16 and after.update_count == 1
    for k in ("ret_mean", "ret_var"):
        _close(getattr(after, k), rec[f"after/{k}"], 1e-5, what=k)
    for k, v in metrics.items():
        _close(v, rec[f"after/metrics/{k}"], 1e-5, 1e-5, k)
    print(", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))  # shown with -s


def mat_update_matches(rec):
    """MAT's update from the recorded rollout (teacher-forced loss over the
    agent axis, its own permutations)."""
    tr, ts = _update_trainer(rec, "mat", "mat/")
    traj = {k: t(rec[f"traj/{k}"]) for k in ("obs", "action", "logp", "value", "reward", "done")}
    rollout = (ts.env_state, traj, t(rec["final_value"]), ts.ep_acc, None)
    after, metrics = tr._learn(ts, rollout, {"perm": rec["mat/perm"]})
    worst = _params_close(tr.net, after.params, _nested(rec, "mat/after/params"), 1e-5)
    for k, v in metrics.items():
        _close(v, rec[f"mat/after/metrics/{k}"], 1e-5, 1e-5, k)
    print(f"MAT params {worst:.2e}")


def test_go1gate_ppo_update_matches_jax(update_rec):
    """One PPO update from JAX's state, params and draws: the 4-step rollout,
    then the 16 minibatch steps."""
    ppo_update_matches(update_rec)


def test_mat_update_matches_jax(update_rec):
    mat_update_matches(update_rec)


@pytest.fixture(scope="module")
def live_update():
    spec = importlib.util.spec_from_file_location(
        "make_torch_goldens", os.path.join(REPO, "tools", "make_torch_goldens.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.record_ppo_update()


@pytest.mark.slow
def test_go1gate_ppo_update_matches_live_jax(live_update):
    ppo_update_matches(live_update)


@pytest.mark.slow
def test_mat_update_matches_live_jax(live_update):
    mat_update_matches(live_update)


# ---------------------------------------------------------------------------
# metrics, term names, draws, checkpoints, entry points
# ---------------------------------------------------------------------------

def test_episode_accumulator_semantics():
    """Per-term episode sums flush at done; summarize = mean per-episode sum
    (mirrors tests/test_learn.py::test_episode_accumulator_semantics)."""
    acc = EpisodeAccumulator.create(2, ("a",), track_success=True)
    r = t([1.0, 2.0])
    terms = {"a": t([0.5, 0.25])}
    acc = acc.update(r, t([False, False]), terms)
    acc = acc.update(r, t([True, False]), terms, success=t([True, False]))  # env0 ends, len 2
    s = acc.summarize()
    assert s["episodes"] == 1.0
    assert s["mean_episode_return"] == pytest.approx(2.0)
    assert s["mean_episode_length"] == pytest.approx(2.0)
    assert s["rew_a"] == pytest.approx(1.0)
    assert s["success_rate"] == pytest.approx(1.0)
    # the window reset zeroes the aggregates but keeps env1's live sums
    acc = acc.reset_window()
    acc = acc.update(r, t([False, True]), terms, success=t([False, False]))  # env1 ends, len 3
    s = acc.summarize()
    assert s["episodes"] == 1.0
    assert s["mean_episode_return"] == pytest.approx(6.0)
    assert s["rew_a"] == pytest.approx(0.75)
    assert s["success_rate"] == pytest.approx(0.0)


def test_term_names_match_jax(learn):
    """Every task's reward-term names, found without stepping the env, are
    the JAX trainer's."""
    for task in ENV_DICT:
        wrap, _ = make_torch_env(task, num_envs=2, seed=0, device="cpu")
        names = PPOTrainer(wrap, PPOConfig()).term_names
        assert names == tuple(learn[f"terms/{task}"].tolist()), task


def test_draws_permutation_given_and_drawn():
    g = torch.Generator().manual_seed(5)
    d = Draws(g, {"perm": np.array([2, 0, 1], np.int32)})
    assert d.permutation("perm", 3, "cpu").tolist() == [2, 0, 1]
    with pytest.raises(ValueError, match="perm"):
        d.permutation("perm", 4, "cpu")
    p = Draws(g).permutation("perm", 7, "cpu")
    assert sorted(p.tolist()) == list(range(7))
    assert torch.equal(p, torch.randperm(7, generator=torch.Generator().manual_seed(5)))


def test_rollout_options_act_as_the_jax_rollout():
    """jrpo's team-mean reward, the command warmup's scaling of cmd[..., 0]
    (clip(update_count / N, floor, 1)), and the GRU carry: stored before
    each step, zeroed where the step ends an episode (ppo.py:160-197)."""
    wrap, _ = make_torch_env("go1gate", num_envs=2, seed=0, device="cpu")
    tr = PPOTrainer(wrap, PPOConfig(algo="jrpo", recurrent=True, rollout_len=2,
                                    cmd_warmup_updates=4))
    ts = tr.init_state()
    last = wrap.env.max_episode_length - 1  # the first step times out in every env
    ts = replace(ts, update_count=1, env_state=replace(ts.env_state, env=replace(
        ts.env_state.env, episode_length=torch.full((2,), last, dtype=torch.int32))))
    env_state, traj, _, _, h = tr._rollout(ts)
    assert traj["done"][0].all() and not traj["done"][1].any()
    assert torch.equal(traj["reward"][..., 0], traj["reward"][..., 1])  # the team mean
    assert not traj["h"][0].any() and not traj["h"][1].any()  # fresh, then zeroed at done
    with torch.no_grad():
        _, _, _, h_expect = tr._apply(ts.params, traj["obs"][1], traj["h"][1])
    assert torch.equal(h, h_expect) and h.abs().max() > 0
    warm = 0.3  # clip(1 / 4, 0.3, 1)
    cmd0 = torch.clamp(0.5 * torch.tanh(traj["action"][1][..., 0]) * warm * 2.0, -1, 1)
    assert torch.allclose(env_state.env.commands[..., 0], cmd0, atol=1e-6)


def test_checkpoint_kill_and_resume(tmp_path):
    """A run saved after one update and resumed reproduces the uninterrupted
    run bit for bit: params, Adam state, env state, generator, accumulator
    and the GRU carry (mirrors tests/test_learn.py::test_checkpoint_kill_and_resume)."""
    wrap, _ = make_torch_env("go1gate", num_envs=2, seed=0, device="cpu")
    tr = PPOTrainer(wrap, PPOConfig(rollout_len=1, num_minibatches=2, ppo_epochs=1,
                                    recurrent=True))
    ts, _ = tr.update(tr.init_state())
    path = tr.save_checkpoint(ts, str(tmp_path / "ckpt"))
    ref, _ = tr.update(ts)

    back = tr.restore_checkpoint(path)
    assert back.update_count == 1
    got, _ = tr.update(back)
    for k in ref.params:
        assert torch.equal(ref.params[k], got.params[k]), k
        assert torch.equal(ref.opt_state.nu[k], got.opt_state.nu[k]), k
    assert torch.equal(ref.rnn_h, got.rnn_h)
    assert torch.equal(ref.env_state.env.phys.agents.qd, got.env_state.env.phys.agents.qd)
    assert torch.equal(ref.ep_acc.ep_return, got.ep_acc.ep_return)
    assert torch.equal(ref.generator.get_state(), got.generator.get_state())


def test_train_cli_writes_and_resumes(tmp_path, capsys):
    from mqe_tpu_torch.learn import train

    args = ["--task", "go1gate", "--num-envs", "2", "--rollout-len", "1", "--cpu",
            "--checkpoint-dir", str(tmp_path), "--log-every", "1"]
    path = train.main(args + ["--train-timesteps", "4"])
    assert os.path.exists(path)
    out = capsys.readouterr().out
    assert '"update": 1' in out and "mean_episode_return" in out
    assert "trained 4 env steps" in out  # T*E*A of the one update
    # --split is the JAX CLI's; the same update runs
    path2 = train.main(args + ["--train-timesteps", "8", "--resume", path, "--split"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "(update 1)" in out and '"update": 2' in out
    assert "trained 4 env steps" in out  # the resumed run's one update
    wrap, _ = make_torch_env("go1gate", num_envs=2, seed=0, device="cpu")
    tr = PPOTrainer(wrap, PPOConfig(rollout_len=1))
    assert path2 == path and tr.restore_checkpoint(path).update_count == 2


def test_evaluate_cli_runs_a_jax_checkpoint(tmp_path):
    from mqe_tpu_torch.learn import evaluate

    log = tmp_path / "eval.jsonl"
    rec = evaluate.main(["--task", "go1bridge", "--checkpoint",
                         os.path.join(REPO, CHECKPOINTS["go1bridge"][0]), "--num-envs", "2",
                         "--max-steps", "2", "--cpu", "--json", str(log)])
    assert rec["task"] == "go1bridge" and np.isfinite(rec["mean_return"])
    assert log.read_text().count("\n") == 1
    # --video, refused until the top-down renderer was ported: the GIF of
    # env 0, a frame every second step
    gif = tmp_path / "eval.gif"
    evaluate.main(["--task", "go1bridge", "--checkpoint",
                   os.path.join(REPO, CHECKPOINTS["go1bridge"][0]), "--num-envs", "2",
                   "--max-steps", "1", "--cpu", "--video", str(gif)])
    assert gif.stat().st_size > 0
