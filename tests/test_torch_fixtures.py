"""The hinged NPCs and the static fixtures of the port (go1tug, go1wrestling,
go1revolvingdoor, go1bridge, go1door) against the JAX package.

- One control step of each task at 2 envs, from the post-reset state and
  from the state after 25 steps, against JAX's recorded step: agent and NPC
  state, observations, reward, done, controller state and extras
  (tests/goldens/torch_<task>_step.npz, written by
  tools/make_torch_goldens.py).
- The `selfplay` step of the four competitive tasks (tug, wrestling,
  revolving door, bridge): the per-seat reward read on the pre-reset state.
- Wrapper sizes and geometry against the JAX wrappers (built, not run), and
  for wrestling and bridge the per-env static geom rows and the fixture
  specs as loaded.
- One `scene.substep_batch` from hand-placed states: robots on and against
  the wrestling ring (a static cylinder) and the bridge (static boxes),
  against JAX's (tests/goldens/torch_static_substep.npz); each case shows
  that the static rows push on the robots.
  The NPC launches of the cylinder, the revolving door and the door on the
  card are cases of tests/test_torch_npc.py.

Tolerances: the step's are tests/test_torch_env.py's (TOLS of
tests/test_soa_episode.py, OTHER_TOLS); the substep's tests/test_pallas_step.py's
and 5e-4 N on forces, as tests/test_torch_npc.py has.
"""
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.physics import scene
from mqe_tpu_torch.physics.model import load_static_geoms
from test_torch_env import TOLS as STEP_TOLS
from test_torch_npc import F_TOL, NAMES, TOLS, _cmp
from test_torch_tasks import NUM_ENVS, _compare_step, _record, wrapper_sizes_match

torch.set_num_threads(1)

TASKS = ("go1tug", "go1wrestling", "go1revolvingdoor", "go1bridge", "go1door")
SELFPLAY = ("go1tug", "go1wrestling", "go1revolvingdoor", "go1bridge")
STATIC = {"go1wrestling": "wrestling", "go1bridge": "bridge"}
E = NUM_ENVS


@pytest.mark.parametrize("task,case", [(t, c) for t in TASKS for c in ("post-reset", "in-contact")])
def test_step_matches_jax(task, case):
    rec = _record(f"torch_{task}_step.npz")
    assert not rec[f"{case}/done"].any(), "an env reset in the compared step"
    (ts1, *_), _ = _compare_step(rec, case, task)
    if task in STATIC:  # the welded anchor stands where it was
        npcs = ts1.env.phys.npcs
        assert tuple(npcs.pos.shape) == (E, 1, 3)
        for n in STEP_TOLS:
            np.testing.assert_array_equal(getattr(npcs, n).numpy(),
                                          rec[f"{case}/start/env/phys/npcs/{n}"], err_msg=n)


@pytest.mark.parametrize("task", SELFPLAY)
def test_selfplay_step_matches_jax(task):
    """The step with `selfplay` on: the per-seat reward, within 1e-4 of JAX's
    (OTHER_TOLS["reward"]), differs from the task's own reward channel."""
    rec = _record(f"torch_{task}_step.npz")
    case = "selfplay"
    assert not rec[f"{case}/done"].any()
    (ts1, obs, rew, done, info), _ = _compare_step(rec, case, task, selfplay=True)
    assert tuple(rew.shape) == (E, 2)
    np.testing.assert_array_equal(rec[f"{case}/out/env/phys/agents/pos"],
                                  rec["in-contact/out/env/phys/agents/pos"])


@pytest.mark.parametrize("task", TASKS)
def test_wrapper_sizes_and_geometry_match_jax(task):
    jwrap, twrap = wrapper_sizes_match(task)
    assert twrap.env.npc_has_collision == jwrap.env.npc_has_collision == (task not in STATIC)
    sg_j = np.asarray(jwrap.env.static_geoms)
    np.testing.assert_array_equal(twrap.env.static_geoms.numpy(), sg_j)
    # the contact's rows: JAX's table split by kind, in its row order
    terrain, kind = twrap.env.terrain, sg_j[0, :, 0]
    np.testing.assert_array_equal(terrain.static_boxes.numpy(), sg_j[:, kind == scene.SG_BOX, 1:8])
    np.testing.assert_array_equal(terrain.static_cyls.numpy(),
                                  sg_j[:, kind == scene.SG_CYL][..., [1, 2, 3, 4, 5, 7]])
    assert (terrain.static_boxes.shape[1], terrain.static_cyls.shape[1]) == {
        "go1wrestling": (0, 1), "go1bridge": (3, 0)}.get(task, (0, 0))
    if task in STATIC:
        from mqe_tpu.physics.model import load_static_geoms as jax_load

        assert sg_j.shape[1] == {"go1wrestling": 1, "go1bridge": 3}[task]
        a, b = jax_load(STATIC[task]), load_static_geoms(STATIC[task])
        for f in ("boxes_center", "boxes_half", "cyl_center", "cyl_radius", "cyl_half_length"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


# ---------------------------------------------------------------------------
# one substep against the static fixtures
# ---------------------------------------------------------------------------

STATIC_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                             "torch_static_substep.npz")


@pytest.fixture(scope="module")
def static_golden():
    with np.load(STATIC_GOLDEN) as f:
        return dict(f)


def static_substep_matches(rec, case, monkeypatch):
    """Replay one recorded case of torch_static_substep.npz: contact forces at
    5e-4 N, the new state at tests/test_pallas_step.py's bounds. Returns the
    calls seen of `_terrain_and_box_force` and `_npc_prim_force`, each
    (args, result)."""
    twrap, _ = make_torch_env(str(rec[f"{case}/task"]), num_envs=E, seed=0, device="cpu")
    tenv = twrap.env
    t = lambda k: torch.from_numpy(rec[f"{case}/{k}"])
    A = tenv.scene.num_agents
    state = scene.PhysState(agents=scene.ActorState(**{k: t(f"agents/{k}") for k in NAMES}),
                            npcs=scene.ActorState(**{k: t(f"npcs/{k}") for k in NAMES}))
    tdr = scene.DomainRand(mu_scale=t("dr/mu"), payload=t("dr/payload"), com_shift=t("dr/com"),
                           motor_strength=torch.ones((E, A, 12)))
    seen = {}
    for name in ("_terrain_and_box_force", "_npc_prim_force"):
        real = getattr(scene, name)

        def spy(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            seen.setdefault(_name, []).append((a, out))
            return out

        monkeypatch.setattr(scene, name, spy)
    tnew, tcon = scene.substep_batch(tenv.scene, tenv.terrain, state, t("tau"), tdr,
                                     float(rec[f"{case}/dt"]), npc_tau=t("npc_tau"))
    for k in ("sphere_force", "npc_sphere_force", "feet_force"):
        _cmp(rec[f"{case}/contact/{k}"], getattr(tcon, k), F_TOL, k)
    for who in ("agents", "npcs"):
        for n, tol in zip(NAMES, TOLS):
            _cmp(rec[f"{case}/out/{who}/{n}"], getattr(getattr(tnew, who), n), tol, f"{who}.{n}")
    if tenv.scene.num_npcs == 0:  # the anchor passes through the substep
        assert tnew.npcs is state.npcs
    return seen


@pytest.mark.parametrize("case", ["wrestling-ring", "bridge"])
def test_static_substep_matches_jax(static_golden, case, monkeypatch):
    seen = static_substep_matches(static_golden, case, monkeypatch)
    assert "_npc_prim_force" not in seen          # no colliding NPC in these scenes
    (args, force), = seen["_terrain_and_box_force"]
    terrain = args[3]
    assert (terrain.static_boxes.shape[1], terrain.static_cyls.shape[1]) == {
        "wrestling-ring": (0, 1), "bridge": (3, 0)}[case]
    # the static rows push on the robots, in both envs
    no_rows = replace(terrain, static_boxes=terrain.static_boxes[:, :0],
                      static_cyls=terrain.static_cyls[:, :0])
    bare = scene._terrain_and_box_force(*args[:3], no_rows, *args[4:])
    pushed = (force - bare).norm(dim=-1).amax(dim=1)
    assert bool((pushed > 1.0).all()), pushed
