"""Golden-trajectory physics regression anchor: the `push` golden (the
goldens and their bounds: tests/test_golden_traj.py; the replays and the
check: tests/_golden_traj_common.py)."""
import os

import numpy as np
import pytest

from _golden_traj_common import GOLDEN_DIR, _check, _replay, _replay_drop


@pytest.mark.parametrize("name", ["push"])
def test_golden_trajectory(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    assert os.path.exists(path), "run tools/make_goldens.py to record goldens"
    golden = dict(np.load(path))
    if name == "drop":
        replay = _replay_drop()
        # the drop transient is the real anchor: tight everywhere
        _check(golden, replay, early=60, pos_tol_late=0.02)
        _check(golden, replay, early=60, pos_tol_early=0.08,
               pos_tol_late=0.15, key="q")
        # physical sanity pinned forever: settles upright near stand height
        z_end = replay["pos"][-10:, :, :, 2]
        assert 0.2 < z_end.mean() < 0.4
    elif name == "walk":
        replay = _replay("go1plane", 100, 0.5, 1)
        _check(golden, replay)
        # command tracking preserved: forward progress within 10% of golden
        dx_g = golden["pos"][-1, :, :, 0] - golden["pos"][0, :, :, 0]
        dx_r = replay["pos"][-1, :, :, 0] - replay["pos"][0, :, :, 0]
        np.testing.assert_allclose(dx_r, dx_g, rtol=0.15, atol=0.05)
    else:
        replay = _replay("go1pushbox", 80, 0.5, 2, record_npc=True)
        _check(golden, replay)
        _check(golden, replay, key="npc_pos", pos_tol_early=0.02,
               pos_tol_late=0.15)
