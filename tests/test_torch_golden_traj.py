"""The JAX package's trajectory goldens (tests/goldens/{drop,walk,push}.npz)
replayed by the port's default path (the SoA physics: the kernels' plain
versions on the CPU), held to tests/test_golden_traj.py's own bounds.

Each replay starts from JAX's reset state of PRNGKey(42) and takes JAX's
per-step draws by name through `Draws`, as tools/make_torch_goldens.py
records them in tests/goldens/torch_golden_traj.npz (`record_golden_traj`):
none of the three runs pushes, resets an env or draws a curriculum level,
so the record holds the starts and the done flags, and a replay that would
reset an env fails instead. The goldens themselves stay as they are.

`drop` (60 steps of 2 envs, ~70 s on one thread) runs in Tier-1; `walk`
(100 steps) and `push` (80 steps of go1pushbox with the box) are marked
slow: the three together take over 150 s on one thread.
"""
import os
import sys

import numpy as np
import pytest
import torch

from mqe_tpu_torch.utils.convert import env_state_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
sys.path.insert(0, os.path.join(REPO, "tools"))


@pytest.fixture(scope="module")
def record():
    with np.load(os.path.join(GOLDENS, "torch_golden_traj.npz")) as f:
        return dict(f)


def _golden(name):
    with np.load(os.path.join(GOLDENS, f"{name}.npz")) as f:
        return dict(f)


def _check(golden, replay, early=20, pos_tol_early=0.01, pos_tol_late=0.08, key="pos"):
    """tests/_golden_traj_common.py::_check: tight early, coarse late."""
    g, r = golden[key], replay[key]
    assert g.shape == r.shape
    np.testing.assert_allclose(r[:early], g[:early], atol=pos_tol_early,
                               err_msg=f"{key} early-trajectory drift")
    np.testing.assert_allclose(r, g, atol=pos_tol_late, err_msg=f"{key} late-trajectory drift")


def _given(rec, name, t):
    """The draws JAX's step t took, by the port's names."""
    pre = f"{name}/draw/{t}/"
    return {k[len(pre):]: v for k, v in rec.items() if k.startswith(pre)}


def _drop_env():
    from golden_steps import drop_env

    return drop_env("cpu")


def _replay(rec, name, task, steps, vx, num_envs, record_npc=False):
    from test_torch_env import _tree

    from mqe_tpu_torch.envs.registry import make_mqe_env

    assert not rec[f"{name}/done"].any(), "the record's run reset an env"
    start = env_state_from_numpy(_tree(rec, f"{name}/start"), device="cpu")
    if task == "drop":
        env = _drop_env()
        cmds = torch.zeros((num_envs, env.num_agents, 3))
        step = lambda s, d: env.step(s, cmds, d)          # noqa: E731
        agents = lambda s: s.phys.agents                    # noqa: E731
        npcs = lambda s: s.phys.npcs                        # noqa: E731
    else:
        wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0, device="cpu")
        env = wrap.env
        acts = torch.zeros((num_envs, wrap.controlled_agents, 3))
        acts[..., 0] = vx
        step = lambda s, d: wrap.step(s, acts, d)          # noqa: E731
        agents = lambda s: s.env.phys.agents               # noqa: E731
        npcs = lambda s: s.env.phys.npcs                   # noqa: E731
    st = start
    out = {k: [] for k in ("pos", "quat", "q") + (("npc_pos",) if record_npc else ())}
    for t in range(steps):
        res = step(st, env.draws(_given(rec, name, t)))
        st, done = res[0], res[-2]
        assert not bool(done.any()), f"{name}: an env reset at step {t}"
        ag = agents(st)
        for k in ("pos", "quat", "q"):
            out[k].append(getattr(ag, k).numpy())
        if record_npc:
            out["npc_pos"].append(npcs(st).pos.numpy())
    return {k: np.stack(v) for k, v in out.items()}


def test_drop_golden_trajectory(record):
    """The drop transient: tight everywhere, and the robots settle upright
    near the stand height (tests/test_golden_traj.py's drop case)."""
    golden = _golden("drop")
    replay = _replay(record, "drop", "drop", 60, 0.0, 2)
    _check(golden, replay, early=60, pos_tol_late=0.02)
    _check(golden, replay, early=60, pos_tol_early=0.08, pos_tol_late=0.15, key="q")
    z_end = replay["pos"][-10:, :, :, 2]
    assert 0.2 < z_end.mean() < 0.4
    print("drop: pos max diff", float(np.abs(replay["pos"] - golden["pos"]).max()),
          "q", float(np.abs(replay["q"] - golden["q"]).max()))  # shown with -s


@pytest.mark.slow
def test_walk_golden_trajectory(record):
    """go1plane under a constant 0.5 command: the trajectory and the forward
    progress within 15 % of the golden's."""
    golden = _golden("walk")
    replay = _replay(record, "walk", "go1plane", 100, 0.5, 1)
    _check(golden, replay)
    dx_g = golden["pos"][-1, :, :, 0] - golden["pos"][0, :, :, 0]
    dx_r = replay["pos"][-1, :, :, 0] - replay["pos"][0, :, :, 0]
    np.testing.assert_allclose(dx_r, dx_g, rtol=0.15, atol=0.05)


@pytest.mark.slow
def test_push_golden_trajectory(record):
    """go1pushbox: the robots walk into the box; robots and box positions."""
    golden = _golden("push")
    replay = _replay(record, "push", "go1pushbox", 80, 0.5, 2, record_npc=True)
    _check(golden, replay)
    _check(golden, replay, key="npc_pos", pos_tol_early=0.02, pos_tol_late=0.15)


def test_record_matches_the_goldens_runs(record):
    """The record is of the goldens' runs: its starts are the states the
    goldens' first steps leave from (JAX's reset of PRNGKey(42): the drop's
    robots 0.62 m up, the walk's one robot, the push's box), and no run
    takes a draw the port would have to be given."""
    assert record["drop/start/phys/agents/pos"].shape == (2, 1, 3)
    np.testing.assert_allclose(record["drop/start/phys/agents/pos"][..., 2], 0.62, atol=1e-6)
    assert record["walk/start/env/phys/agents/pos"].shape == (1, 1, 3)
    assert record["push/start/env/phys/npcs/pos"].shape == (2, 1, 3)
    for name, steps in (("drop", 60), ("walk", 100), ("push", 80)):
        assert record[f"{name}/done"].shape[0] == steps
        assert not any(k.startswith(f"{name}/draw/") for k in record)
        # the golden's first step moved less than a step's travel from the start
        first = _golden(name)["pos"][0]
        start = record[f"{name}/start/phys/agents/pos" if name == "drop"
                       else f"{name}/start/env/phys/agents/pos"]
        assert np.abs(first - start).max() < 0.05
