"""Where the port's replay of the drop golden parts from it, beside how far
the JAX package's own step parts from it under another compilation.

    JAX_PLATFORMS=cpu python tools/diag_drop_golden.py

tests/goldens/drop.npz is `Go1Env._step` of the drop config (tools/make_goldens.py:
go1plane's robot released 0.62 m up, 2 envs, 60 steps) run under one
`lax.scan`, from `_reset_all(PRNGKey(42))` with step keys split from
PRNGKey(1). tests/test_golden_traj.py holds a replay to it within 0.01 m of
base position over all 60 steps. This tool prints, step by step, the largest
base-position difference from the golden of
  - JAX's scan, run again (the golden's own program);
  - JAX's step jitted alone and called 60 times (the same function, another
    XLA program);
  - the port's `Go1Env.step` (the default SoA path; the kernels' plain
    versions on the CPU) from the same reset state, as
    tests/test_torch_golden_traj.py replays it;
and the one-step ("resynced") differences of the port's step and of the
jitted JAX step, each from every state of the scan, per quantity: how much
each step adds by itself before the touchdown's stiff contact amplifies it.
"""
from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

NAMES = ("pos", "lin_vel", "ang_vel", "q", "qd")


def main():
    import make_torch_goldens as M
    from test_torch_golden_traj import _drop_env

    from mqe_tpu_torch.utils.convert import env_state_from_numpy

    torch.set_num_threads(1)
    gold = dict(np.load(os.path.join(REPO, "tests", "goldens", "drop.npz")))
    env = M._drop_env()
    s0 = env._reset_all(jax.random.PRNGKey(42))
    cmds = jnp.zeros((2, 1, 3))

    def body(carry, _):
        state, key = carry
        key, k = jax.random.split(key)
        state = env._step(state, cmds, k)[0]
        return (state, key), state

    (_, _), scan = jax.lax.scan(body, (s0, jax.random.PRNGKey(1)), None, length=60)
    at = lambda t: jax.tree.map(lambda x: x[t], scan)  # noqa: E731
    jstep = jax.jit(lambda s, k: env._step(s, cmds, k)[0])
    tenv = _drop_env()
    tcmd = torch.zeros((2, 1, 3))

    key = jax.random.PRNGKey(1)
    js, ts = s0, env_state_from_numpy(jax.tree.map(np.asarray, s0), device="cpu")
    prev = s0
    rows, one_jax, one_port = [], {n: 0.0 for n in NAMES}, {n: 0.0 for n in NAMES}
    for t in range(60):
        key, k = jax.random.split(key)
        js = jstep(js, k)
        ts = tenv.step(ts, tcmd)[0]
        g = gold["pos"][t]
        rows.append((t, float(np.abs(np.asarray(scan.phys.agents.pos[t]) - g).max()),
                     float(np.abs(np.asarray(js.phys.agents.pos) - g).max()),
                     float(np.abs(ts.phys.agents.pos.numpy() - g).max())))
        nxt = at(t)
        oj = jstep(prev, k)
        op = tenv.step(env_state_from_numpy(jax.tree.map(np.asarray, prev), device="cpu"),
                       tcmd)[0]
        for n in NAMES:
            want = np.asarray(getattr(nxt.phys.agents, n))
            one_jax[n] = max(one_jax[n], float(np.abs(np.asarray(getattr(oj.phys.agents, n))
                                                      - want).max()))
            one_port[n] = max(one_port[n], float(np.abs(getattr(op.phys.agents, n).numpy()
                                                        - want).max()))
        prev = nxt
    print("step  scan-vs-golden  jitted-JAX-vs-golden  port-vs-golden (max |base pos| diff, m)")
    for t, a, b, c in rows:
        print(f"{t:4d}  {a:.3e}  {b:.3e}  {c:.3e}")
    first = lambda col: next((t for t, *r in rows if r[col] > 0.01), None)  # noqa: E731
    print(f"largest: scan {max(r[1] for r in rows):.4e}, jitted JAX {max(r[2] for r in rows):.4e} "
          f"(first > 0.01 m at step {first(1)}), port {max(r[3] for r in rows):.4e} "
          f"(first > 0.01 m at step {first(2)})")
    print("one step from each scan state, worst over the 60 (jitted JAX / port): "
          + ", ".join(f"{n} {one_jax[n]:.3e} / {one_port[n]:.3e}" for n in NAMES))


if __name__ == "__main__":
    main()
