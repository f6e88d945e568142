"""Golden-trajectory physics regression anchors (VERDICT r1 #9).

Goldens recorded by tools/make_goldens.py (CPU, f32) pin the full
contact+dynamics stack: any drift in the contact model, integrator, actuator
net, or terrain build beyond tolerance fails here. Contact parameters are the
calibrated penalty-model equivalents of the reference PhysX solver block
(ref mqe/envs/base/legged_robot_config.py:211-229): kn/hc_damping/v_slip in
envs/config.py::Go1Cfg.physx were tuned so the settled stand height and foot
penetration (<5 mm) match the reference's contact_offset=0.01/TGS behavior.

Tolerances are loose enough to survive XLA version-to-version reassociation
but tight enough to catch model changes (chaotic divergence is bounded by
checking the EARLY trajectory tightly and the late trajectory coarsely).

This file holds the `drop` golden; `walk` and `push` are in
tests/test_golden_traj_walk.py and tests/test_golden_traj_push.py, so that
`--dist loadfile` runs them in parallel. The replays and `_check` are in
tests/_golden_traj_common.py.
"""
import os

import numpy as np
import pytest

from _golden_traj_common import GOLDEN_DIR, _check, _replay, _replay_drop


@pytest.mark.parametrize("name", ["drop"])
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
