"""The port held to the JAX package's trajectory goldens step by step.

A replay of a golden over tens of steps cannot tell a fault of the port from
rounding: at the drop's landing JAX's own step, nudged by one part in 10^6,
moves qd by more than `TOLS` allow. So each step of the port starts from the
state of the golden's `lax.scan` before it and is held to the scan's state
after it, under one rule (tools/golden_steps.py::judge): within the per-step
bounds `TOLS` (tests/test_torch_env.py), or at a step and quantity where
JAX's own envelope (its jitted step from the nudged state, 16 draws) already
exceeds them. The JAX side is the record tests/goldens/torch_golden_steps.npz
(tools/make_torch_goldens.py `record_golden_steps`); no JAX runs here.

Tier-1 runs the drop's landing, steps 10-25 (~20 s on one thread); all 60
drop steps, the 100 of `walk` and the 80 of `push` are marked slow.
"""
import ast
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_env import TOLS
from test_torch_imports import FORBIDDEN, _imported_roots

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import golden_steps as G  # noqa: E402

torch.set_num_threads(1)

LANDING = range(10, 26)
LANDING_STEP = 16  # from the golden's row 15, the lowest point of the landing (base z 0.168 m)


@pytest.fixture(scope="module")
def rec():
    return G.load()


def _held(rec, name, steps):
    diffs, _ = G.Golden(rec, name).one_steps(steps)
    unexcused, excused = G.judge(rec, name, steps, diffs, TOLS)
    print(f"{name} steps {steps[0]}-{steps[-1]}: excused {G.describe(excused)}; worst "
          + ", ".join(f"{f} {d.max():.3e}" for f, d in diffs.items()))  # shown with -s
    assert not unexcused, (f"{name}: over TOLS where JAX's envelope is not: "
                           + G.describe(unexcused))


def test_record_is_the_goldens_scan(rec):
    """The fixture's steps are the goldens' runs: the robots after each step
    are the goldens' pos, quat and q (and push's box), the first state is
    torch_golden_traj.npz's start, no step takes a draw or resets an env,
    and JAX's envelope is 16 draws at one part in 10^6."""
    with np.load(os.path.join(G.REPO, "tests", "goldens", "torch_golden_traj.npz")) as f:
        starts = dict(f)
    assert int(rec["envelope_draws"]) == 16 and float(rec["envelope_rel"]) == 1e-6
    for name in G.RUNS:
        with np.load(os.path.join(G.REPO, "tests", "goldens", f"{name}.npz")) as f:
            golden = dict(f)
        steps = rec[f"{name}/done"].shape[0]
        assert steps == golden["pos"].shape[0] and not rec[f"{name}/done"].any()
        for f in golden:
            np.testing.assert_array_equal(rec[f"{name}/after/{f}"], golden[f], err_msg=f)
        pre = f"{name}/start/"
        for k, v in starts.items():
            if k.startswith(pre):
                np.testing.assert_array_equal(rec[f"{name}/state/{k[len(pre):]}"][0], v)
        assert not any(k.startswith(f"{name}/draw/") for k in rec)
        for f in G.FIELDS:
            assert rec[f"{name}/envelope/{f}"].shape == (steps,)


def test_drop_landing_breaks_tols_in_jax_itself(rec):
    """The finding: from the state at the bottom of the landing, JAX's own
    step nudged by one part in 10^6 moves qd by more than TOLS allow, and
    from the states one step before and after it it does not."""
    env = rec["drop/envelope/qd"]
    assert env[LANDING_STEP] > TOLS["qd"]
    assert env[LANDING_STEP - 1] < TOLS["qd"] and env[LANDING_STEP + 1] < TOLS["qd"]
    z = rec["drop/state/phys/agents/pos"][LANDING_STEP, ..., 2]
    assert z.min() == pytest.approx(0.168, abs=1e-3)


def test_judge_excuses_only_where_jax_breaks_the_bound():
    """The rule itself: a difference over its bound is excused only at a
    step and quantity whose envelope is over the bound too; the NPC's
    position takes the robots' position bound."""
    rec = {"x/envelope/qd": np.array([0.0, 3e-2, 1e-2]),
           "x/envelope/npc_pos": np.array([0.0, 0.0, 2e-6])}
    diffs = {"qd": np.array([1e-3, 5e-2, 3e-2]), "npc_pos": np.array([2e-6, 0.0, 3e-6])}
    unexcused, excused = G.judge(rec, "x", [0, 1, 2], diffs, TOLS)
    assert [(t, f) for t, f, *_ in unexcused] == [(2, "qd"), (0, "npc_pos")]
    assert [(t, f) for t, f, *_ in excused] == [(1, "qd"), (2, "npc_pos")]


def test_card_side_imports_no_jax():
    """What chip_smoke.py runs of the harness on the card's machine, which
    has no JAX: tools/golden_steps.py, and tools/diag_drop_golden.py but for
    its `--stages` mode (JAX imported inside `stages`)."""
    tools = os.path.join(G.REPO, "tools")
    assert not _imported_roots(os.path.join(tools, "golden_steps.py")) & set(FORBIDDEN)
    with open(os.path.join(tools, "diag_drop_golden.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for top in tree.body:
        if not (isinstance(top, ast.FunctionDef) and top.name == "stages"):
            for node in ast.walk(top):
                if isinstance(node, ast.Import):
                    roots.update(a.name.split(".")[0] for a in node.names)
                elif isinstance(node, ast.ImportFrom) and node.module:
                    roots.add(node.module.split(".")[0])
    assert "golden_steps" in roots and not roots & (set(FORBIDDEN) | {"make_torch_goldens"})


def test_drop_landing_steps_meet_tols(rec):
    """Steps 10-25 of the drop (the landing) from the scan's states."""
    _held(rec, "drop", list(LANDING))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(G.RUNS))
def test_golden_steps_meet_tols(rec, name):
    """Every step of each golden from the scan's states."""
    _held(rec, name, list(range(rec[f"{name}/done"].shape[0])))
