"""The port's env-axis split over torch.distributed (mqe_tpu_torch/parallel/)
and the data-parallel PPO update, on the CPU with the gloo backend.

As tests/test_parallel.py and tests/test_multihost.py check the JAX
package's mesh: two ranks started with `python -m
mqe_tpu_torch.parallel.worker` (each with a timeout of its own, killed on
timeout) hold one of the 2 envs of tests/goldens/torch_go1gate_step.npz
each. Their gathered step must equal JAX's recorded step within
tests/test_soa_episode.py::TOLS (JAX's own sharded step is bitwise its
unsharded one, test_sharded_matches_single_device); a sharded PPO update
(rollout_len=2, num_minibatches=2, ppo_epochs=1, as tests/test_parallel.py)
must give the single-process update's params within 1e-5, and a sharded
rollout the unsharded mean reward.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs.registry import make_mqe_env
from mqe_tpu_torch.parallel.mesh import EnvMesh, shard_env_axis, shard_wrapper
from mqe_tpu_torch.utils.random import Draws

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_go1gate_step.npz")
TOLS = dict(pos=1e-6, quat=1e-5, lin_vel=3e-4, ang_vel=5e-3, q=2e-4, qd=2e-2)
UPDATE = dict(rollout_len=2, num_minibatches=2, ppo_epochs=1)
ROLLOUT = 2
RANK_TIMEOUT = 120  # seconds, each rank


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args, world=2):
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mqe_tpu_torch.parallel.worker", "--rank", str(r),
         "--world", str(world), "--port", str(port), *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
                stderr += f"\nkilled after {RANK_TIMEOUT} s"
            outs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh") / "out.npz")
    args = ["--device", "cpu", "--threads", "1", "--num-envs", "2", "--steps", "1", "--start", GOLDEN,
            "--case", "in-contact", "--update", "--rollout", str(ROLLOUT), "--out", out]
    for k, v in UPDATE.items():
        args += [f"--{k.replace('_', '-')}", str(v)]
    for r, (rc, stdout, stderr) in enumerate(_launch(args)):
        assert rc == 0, f"rank {r} rc={rc}\n{stderr[-3000:]}"
        assert f"WORKER OK rank={r}" in stdout, stdout
    with np.load(out) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# in one process: the split itself
# ---------------------------------------------------------------------------

def test_shard_and_gather_round_trip():
    """Each rank's shard of a state, concatenated in rank order, is the
    state; tensors without the env axis stay whole."""
    wrap, _ = make_mqe_env("go1gate", num_envs=4, seed=0, device="cpu")
    ts, _ = wrap.reset()
    tree = {"ts": ts, "const": torch.arange(3.0), "scalar": torch.tensor(2.0)}
    parts = [shard_env_axis(tree, EnvMesh(rank=r, world=2), 4) for r in range(2)]
    assert parts[0]["const"] is tree["const"] and parts[1]["scalar"] is tree["scalar"]
    a, b = parts[0]["ts"], parts[1]["ts"]
    assert a.env.phys.agents.pos.shape[0] == 2
    for name in ("pos", "quat", "q", "qd"):
        torch.testing.assert_close(
            torch.cat([getattr(a.env.phys.agents, name), getattr(b.env.phys.agents, name)]),
            getattr(ts.env.phys.agents, name), rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([a.env.dr.mu_scale, b.env.dr.mu_scale]),
                               ts.env.dr.mu_scale, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not split"):
        EnvMesh(rank=0, world=3).env_slice(4)


def test_sharded_draws_are_the_global_draws():
    """A rank's draws are its rows of the global draws, and every rank's
    generator ends where one process's does; given values of the whole env
    axis are sliced; a draw off the env axis is refused."""
    def draw(d, E):
        return [d.uniform("u", (E, 2), -1.0, 1.0, "cpu"), d.normal("n", (E, 3), "cpu"),
                d.integers("i", (E,), 0, 9, "cpu")]

    g = torch.Generator().manual_seed(3)
    full = draw(Draws(g), 6)
    for r in range(3):
        gr = torch.Generator().manual_seed(3)
        part = draw(Draws(gr, env_slice=(2 * r, 2 * r + 2, 6)), 2)
        for x, y in zip(part, full):
            assert torch.equal(x, y[2 * r:2 * r + 2])
        assert torch.equal(gr.get_state(), g.get_state())
    given = Draws(g, {"u": np.arange(12.0).reshape(6, 2)}, env_slice=(4, 6, 6))
    assert given.uniform("u", (2, 2), 0, 1, "cpu").tolist() == [[8.0, 9.0], [10.0, 11.0]]
    with pytest.raises(ValueError, match="env axis"):
        Draws(g, env_slice=(0, 2, 6)).normal("x", (5,), "cpu")


@pytest.mark.parametrize("task", ["go1gate", "go1wrestling", "go1football-defender"])
def test_shard_wrapper_keeps_each_ranks_env_constants(task):
    """The ranks' wrappers hold, in rank order, the global wrapper's per-env
    constants (origins, boxes, static geoms, the defender's gate), and the
    global wrapper is left as it was."""
    wrap, _ = make_mqe_env(task, num_envs=4, seed=0, device="cpu")
    env = wrap.env
    before = env.env_origins.clone()
    locs = [shard_wrapper(wrap, EnvMesh(rank=r, world=2)) for r in range(2)]
    for name in ("env_origins", "agent_origins", "env_boxes", "static_geoms", "defender_gate"):
        if hasattr(env, name):
            torch.testing.assert_close(torch.cat([getattr(w.env, name) for w in locs]),
                                       getattr(env, name), rtol=0, atol=0)
    for k in env.env_info:
        torch.testing.assert_close(torch.cat([w.env.env_info[k] for w in locs]),
                                   env.env_info[k], rtol=0, atol=0)
    for f in ("boxes", "static_boxes", "static_cyls"):
        torch.testing.assert_close(torch.cat([getattr(w.env.terrain, f) for w in locs]),
                                   getattr(env.terrain, f), rtol=0, atol=0)
    assert [w.num_envs for w in locs] == [2, 2] and env.num_envs == 4
    assert locs[1].env.env_slice == (2, 4, 4) and env.env_slice is None
    assert torch.equal(env.env_origins, before)


def test_worker_refuses_cuda_without_a_gpu():
    """No quiet fallback: a rank asked for the card that finds none fails."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    outs = _launch(["--device", "cuda", "--num-envs", "2"], world=1)
    rc, stdout, stderr = outs[0]
    assert rc != 0 and "finds no GPU" in stderr and "WORKER OK" not in stdout


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def test_sharded_step_matches_jax(two_ranks):
    """The 2-rank gathered go1gate step against JAX's recorded step."""
    with np.load(GOLDEN) as f:
        rec = dict(f)
    case = "in-contact"
    for name, tol in TOLS.items():
        want = rec[f"{case}/out/env/phys/agents/{name}"]
        diff = float(np.abs(two_ranks[f"step/end/agents/{name}"] - want).max())
        assert diff <= tol, f"{name}: {diff:.3e} > {tol:.0e}"
    for k, tol in (("obs", 1e-4), ("reward", 1e-4)):
        diff = float(np.abs(two_ranks[f"step/0/{k}"] - rec[f"{case}/{k}"]).max())
        assert diff <= tol, f"{k}: {diff:.3e} > {tol:.0e}"
    assert np.array_equal(two_ranks["step/0/done"], rec[f"{case}/done"])


def test_sharded_step_equals_the_unsharded_port_step(two_ranks):
    """The same step in one process of the port, within the same bounds: a
    batch of one env per rank rounds some sums differently from the batch of
    two (pos parts by a few 1e-6 after a step of contact)."""
    from test_torch_env import _tree

    from mqe_tpu_torch.utils.convert import env_state_from_numpy

    with np.load(GOLDEN) as f:
        rec = dict(f)
    wrap, _ = make_mqe_env("go1gate", num_envs=2, seed=0, device="cpu")
    ts = env_state_from_numpy(_tree(rec, "in-contact/start"), device="cpu")
    out, obs, rew, done, _ = wrap.step(ts, torch.as_tensor(rec["in-contact/actions"]))
    for name, tol in TOLS.items():
        np.testing.assert_allclose(two_ranks[f"step/end/agents/{name}"],
                                   getattr(out.env.phys.agents, name).numpy(), rtol=0, atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(two_ranks["step/0/obs"], obs.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(two_ranks["step/0/reward"], rew.numpy(), rtol=0, atol=1e-4)
    assert np.array_equal(two_ranks["step/0/done"], done.numpy())


@pytest.fixture(scope="module")
def one_process():
    """The single-process update and rollout the ranks split."""
    from mqe_tpu_torch.learn.ppo import PPOConfig, PPOTrainer

    wrap, _ = make_mqe_env("go1gate", num_envs=2, seed=0, device="cpu")
    tr = PPOTrainer(wrap, PPOConfig(**UPDATE), seed=0)
    ts, metrics = tr.update(tr.init_state())
    acts = torch.as_tensor(np.random.RandomState(1).uniform(
        -1, 1, (2, wrap.controlled_agents, 3)).astype(np.float32))
    st, _ = wrap.reset()
    rews = []
    for _ in range(ROLLOUT):
        st, _, rew, _, _ = wrap.step(st, acts)
        rews.append(rew)
    return ts, metrics, tr, float(torch.stack(rews).mean())


def test_sharded_ppo_update_matches_one_process(two_ranks, one_process):
    ts, metrics, tr, _ = one_process
    worst = 0.0
    for k, v in ts.params.items():
        worst = max(worst, float(np.abs(two_ranks[f"update/params/{k}"] - v.numpy()).max()))
    moved = max(float((v - tr.init_params[k]).abs().max()) for k, v in ts.params.items())
    assert worst <= 1e-5, f"params: {worst:.3e} > 1e-5"
    assert moved > 1e-4   # the update did move the params
    for k in ("loss", "reward_mean", "value_mean", "done_frac"):
        np.testing.assert_allclose(two_ranks[f"update/metrics/{k}"], float(metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sharded_rollout_mean_reward_matches(two_ranks, one_process):
    np.testing.assert_allclose(float(two_ranks["rollout/mean_reward"]), one_process[3],
                               rtol=1e-6, atol=1e-7)
