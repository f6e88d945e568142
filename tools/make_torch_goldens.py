"""Record the JAX side of the port's step tests (tests/test_torch_env.py,
tests/test_torch_tasks.py): control steps of the JAX package, which the
port's CPU tests replay without compiling JAX.

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py [FILE ...]

With no FILE it writes each file of FILES that is not on disk yet; a FILE
named (e.g. torch_go1pushbox_step.npz) is written again. Each file holds
cases of one task at num_envs=2. The env is reset with PRNGKey(0) and stepped
WARM_STEPS times under actions drawn uniform(-1, 1) from RandomState(3), with
step keys split from PRNGKey(1). The cases start from:
  - "post-reset": the reset state;
  - "in-contact": the state after WARM_STEPS steps (feet on the ground);
  - "reset-step": the in-contact state with episode_length set to
    max_episode_length - 1, so that the step times out in every env and
    takes the masked reset. Its record also holds "fresh", the reset state
    the JAX step drew (`_reset_all` of the third of
    jax.random.split(PRNGKey(7), 4)), which the port takes through `Draws`.
From each start, one step with that start's actions and PRNGKey(7) is
recorded: the start state, the actions, and the step's state, observations,
reward and done. Each pytree is flattened to "<case>/<record>/<path>" keys.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "goldens")
NUM_ENVS = 2
WARM_STEPS = 25
STARTS = {"post-reset": 0, "in-contact": WARM_STEPS, "reset-step": WARM_STEPS}
FILES = {
    "torch_go1gate_step.npz": ("go1gate", ("post-reset", "in-contact")),
    "torch_go1gate_reset_step.npz": ("go1gate", ("reset-step",)),
    "torch_go1plane_step.npz": ("go1plane", ("post-reset", "in-contact")),
    "torch_go1pushbox_step.npz": ("go1pushbox", ("post-reset", "in-contact", "reset-step")),
    "torch_go1seesaw_step.npz": ("go1seesaw", ("post-reset", "in-contact")),
}


def _flat(prefix, tree):
    """{prefix/path: numpy array} of a pytree (dataclass fields and dict keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(k, "name", getattr(k, "key", k))) for k in path]
        out["/".join([prefix] + names)] = np.asarray(leaf)
    return out


def record(task="go1gate", cases=("post-reset", "in-contact")) -> dict:
    """The record of `cases` of `task` as a dict of numpy arrays."""
    import jax.numpy as jnp

    from mqe_tpu.envs.registry import make_mqe_env

    wrap, _ = make_mqe_env(task, num_envs=NUM_ENVS, seed=0)
    ts, _ = wrap.reset(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    acts = rng.uniform(-1, 1, (WARM_STEPS + 1, NUM_ENVS, wrap.num_agents, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    states = [ts]
    for t in range(WARM_STEPS):
        key, k = jax.random.split(key)
        ts = wrap.step(ts, acts[t], k)[0]
        states.append(ts)
    rec = {}
    for case in cases:
        start = STARTS[case]
        ts0 = states[start]
        if case == "reset-step":
            last = wrap.env.max_episode_length - 1
            ts0 = ts0.replace(env=ts0.env.replace(
                episode_length=jnp.full((NUM_ENVS,), last, dtype=jnp.int32)))
            k_reset = jax.random.split(jax.random.PRNGKey(7), 4)[2]
            rec.update(_flat(f"{case}/fresh", wrap.env._reset_all(k_reset)))
        ts1, obs, rew, done, _ = wrap.step(ts0, acts[start], jax.random.PRNGKey(7))
        rec.update(_flat(f"{case}/start", ts0))
        rec.update(_flat(f"{case}/out", ts1))
        rec[f"{case}/actions"] = acts[start]
        rec[f"{case}/obs"] = np.asarray(obs)
        rec[f"{case}/reward"] = np.asarray(rew)
        rec[f"{case}/done"] = np.asarray(done)
    return rec


def main(names):
    for name in names or [n for n in FILES if not os.path.exists(os.path.join(GOLDENS, n))]:
        task, cases = FILES[name]
        rec = record(task, cases)
        out = os.path.normpath(os.path.join(GOLDENS, name))
        np.savez_compressed(out, **rec)
        dones = {c: rec[f"{c}/done"].tolist() for c in cases}
        print(f"wrote {out}: {len(rec)} arrays, {os.path.getsize(out)} bytes; done {dones}")


if __name__ == "__main__":
    main(sys.argv[1:])
