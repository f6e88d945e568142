"""Record the JAX side of tests/test_torch_env.py: one go1gate control step of
the JAX package from two start states, which the port's CPU test replays
without compiling JAX.

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py

At num_envs=2 the env is reset with PRNGKey(0) and stepped WARM_STEPS times
under actions drawn uniform(-1, 1) from RandomState(3), with step keys split
from PRNGKey(1). The two start states are the post-reset one and the one after
WARM_STEPS steps (feet on the ground). From each, one step with that start's
actions and PRNGKey(7) is recorded: the start state, the actions, and the
step's state, observations, reward and done. Each pytree is flattened to
"<case>/<record>/<path>" keys of tests/goldens/torch_go1gate_step.npz.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "goldens",
                   "torch_go1gate_step.npz")
NUM_ENVS = 2
WARM_STEPS = 25
CASES = {"post-reset": 0, "in-contact": WARM_STEPS}


def _flat(prefix, tree):
    """{prefix/path: numpy array} of a pytree (dataclass fields and dict keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(k, "name", getattr(k, "key", k))) for k in path]
        out["/".join([prefix] + names)] = np.asarray(leaf)
    return out


def record() -> dict:
    """The golden record as a dict of numpy arrays."""
    from mqe_tpu.envs.registry import make_mqe_env

    wrap, _ = make_mqe_env("go1gate", num_envs=NUM_ENVS, seed=0)
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
    for case, start in CASES.items():
        ts1, obs, rew, done, _ = wrap.step(states[start], acts[start], jax.random.PRNGKey(7))
        rec.update(_flat(f"{case}/start", states[start]))
        rec.update(_flat(f"{case}/out", ts1))
        rec[f"{case}/actions"] = acts[start]
        rec[f"{case}/obs"] = np.asarray(obs)
        rec[f"{case}/reward"] = np.asarray(rew)
        rec[f"{case}/done"] = np.asarray(done)
    return rec


def main():
    rec = record()
    np.savez_compressed(OUT, **rec)
    print(f"wrote {os.path.normpath(OUT)}: {len(rec)} arrays, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
