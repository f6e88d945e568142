"""The sheep tasks of the port (go1sheep-easy: 1 sheep, go1sheep-hard: a 3x3
flock) against the JAX package.

- One control step of each task at 2 envs, from the post-reset state and
  from the state after 25 steps, against JAX's recorded step, NPC state
  included (tests/goldens/torch_<task>_step.npz). The sheep script's normal
  draw (`jax.random.normal` of JAX's `k_npc`) goes in through `Draws` under
  "npc_noise": go1sheep-hard's randomness is 0.1, so the draw moves the flock.
- The reset step of go1sheep-hard: every env times out and takes JAX's fresh
  state (the grid init plus the spawn draws) through `Draws` under "fresh";
  every field compared.
- The flee script (`Go1Env._npc_script`) against JAX's, run op by op, on
  drawn dog and sheep positions in and out of the script's range; its
  outputs are contiguous, as the kernels take them.
- Wrapper sizes and geometry, the grid init included, against the JAX
  wrappers (built, not run); `Draws.normal`.
  The sheep's NPC launches on the card (B = 4096, and 36,864 for nine
  sheep) are cases of tests/test_torch_npc.py.

Tolerances: tests/test_torch_env.py's on the step; the script's outputs at
the step's bounds of the NPC state (TOLS of tests/test_soa_episode.py).
"""
import numpy as np
import pytest
import torch

from mqe_tpu_torch.envs.registry import make_mqe_env as make_torch_env
from mqe_tpu_torch.physics.scene import ActorState
from mqe_tpu_torch.utils.random import Draws
from test_torch_env import TOLS as STEP_TOLS
from test_torch_tasks import (NUM_ENVS, _compare_step, _record, reset_step_matches,
                              wrapper_sizes_match)

torch.set_num_threads(1)

TASKS = ("go1sheep-easy", "go1sheep-hard")
E = NUM_ENVS


@pytest.mark.parametrize("task,case", [(t, c) for t in TASKS for c in ("post-reset", "in-contact")])
def test_step_matches_jax(task, case):
    rec = _record(f"torch_{task}_step.npz")
    assert not rec[f"{case}/done"].any(), "an env reset in the compared step"
    assert rec[f"{case}/npc_noise"].shape == (E, int(task == "go1sheep-hard") * 8 + 1, 3)
    (ts1, *_), _ = _compare_step(rec, case, task)
    moved = np.abs(ts1.env.phys.npcs.pos.numpy() - rec[f"{case}/start/env/phys/npcs/pos"])
    assert moved.max() > 1e-4  # the flock moved, as JAX moved it


def test_reset_step_matches_jax():
    (ts1, *_), _, fresh = reset_step_matches("go1sheep-hard", "torch_go1sheep-hard_step.npz")
    # the fresh flock: the grid plus the spawn draws, 9 sheep an env
    assert tuple(fresh.phys.npcs.pos.shape) == (E, 9, 3)
    np.testing.assert_array_equal(ts1.env.phys.npcs.lin_vel.numpy(),
                                  fresh.phys.npcs.lin_vel.numpy())


@pytest.mark.parametrize("task", TASKS)
def test_wrapper_sizes_and_geometry_match_jax(task):
    jwrap, twrap = wrapper_sizes_match(task)
    assert twrap.env.npc_behavior == jwrap.env.npc_behavior == "sheep"
    assert twrap._gate_x("init", "plane", "gate") == jwrap._gate_x("init", "plane", "gate")
    grid = twrap.env.npc_init.numpy()
    assert grid.shape == (twrap.num_npcs, 13) and len(np.unique(grid[:, :2], axis=0)) == len(grid)


def _flock(n_env, task, seed):
    """Dogs and sheep drawn over a 6 m square: some sheep within the
    script's range of a dog, some beyond it."""
    rng = np.random.RandomState(seed)
    N = 9 if task == "go1sheep-hard" else 1
    f = lambda *s: rng.uniform(-3, 3, s).astype(np.float32)
    dog = f(n_env, 2, 3)
    sheep = dict(pos=f(n_env, N, 3), lin_vel=f(n_env, N, 3) * 0.5, ang_vel=f(n_env, N, 3),
                 q=np.zeros((n_env, N, 0), np.float32), qd=np.zeros((n_env, N, 0), np.float32))
    qt = rng.randn(n_env, N, 4).astype(np.float32)
    sheep["quat"] = qt / np.linalg.norm(qt, axis=-1, keepdims=True)
    return dog, sheep


@pytest.mark.parametrize("task", TASKS)
def test_npc_script_matches_jax(task):
    """The flee script, port against JAX op by op (no jit), with JAX's
    normal draw given: velocities, clipped height and level quaternions."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from mqe_tpu.envs.registry import make_mqe_env as make_jax_env
    from mqe_tpu.physics import scene as JS

    n = 16
    jenv = make_jax_env(task, num_envs=n, seed=0)[0].env
    tenv = make_torch_env(task, num_envs=n, seed=0, device="cpu")[0].env
    dog, sheep = _flock(n, task, seed=3)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, sheep["pos"].shape))

    def state(arr, actor):
        return SimpleNamespace(phys=SimpleNamespace(
            agents=SimpleNamespace(pos=arr(dog)),
            npcs=actor(**{k: arr(v) for k, v in sheep.items()})))

    ref = jenv._npc_script(state(jnp.asarray, JS.ActorState), key)
    out = tenv._npc_script(state(torch.from_numpy, ActorState),
                           Draws(tenv.generator, {"npc_noise": noise}))
    rel = sheep["pos"][:, :, None] - dog[:, None]
    in_range = np.linalg.norm(rel ** 2, axis=-1) <= 9.0
    assert in_range.any() and not in_range.all()
    for k, tol in STEP_TOLS.items():
        a, b = np.asarray(getattr(ref, k)), getattr(out, k)
        assert b.is_contiguous(), k
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol, err_msg=k)


def test_draws_normal():
    """A given draw is used as given, at its shape; else the generator's
    N(0, 1), reproducible from the seed."""
    g = torch.Generator().manual_seed(5)
    given = np.arange(6, dtype=np.float32).reshape(2, 1, 3)
    assert torch.equal(Draws(g, {"npc_noise": given}).normal("npc_noise", (2, 1, 3), "cpu"),
                       torch.from_numpy(given))
    with pytest.raises(ValueError, match="npc_noise"):
        Draws(g, {"npc_noise": given}).normal("npc_noise", (2, 9, 3), "cpu")
    a = Draws(torch.Generator().manual_seed(5)).normal("x", (4000,), "cpu")
    b = Draws(torch.Generator().manual_seed(5)).normal("x", (4000,), "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1.0) < 0.1
