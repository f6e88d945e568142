"""Every step of a JAX trajectory golden, one step of the port from the
golden's own state beside JAX's envelope there, and the port's whole replay.

    python tools/diag_drop_golden.py [--name drop|walk|push] [--device cpu|cuda]
                                     [--json FILE]
    JAX_PLATFORMS=cpu python tools/diag_drop_golden.py --stages [STEP]

tests/goldens/drop.npz is `Go1Env._step` of the drop config (tools/make_goldens.py:
go1plane's robot released 0.62 m up, 2 envs, 60 steps) run under one
`lax.scan`; tests/test_golden_traj.py holds a replay to it within 0.01 m of
base position over all 60 steps. This tool reads the golden's scan state by
state from tests/goldens/torch_golden_steps.npz (no JAX runs) and prints:
  - per step t, for each quantity, the port's one-step difference from the
    scan's state t+1 (`Go1Env.step`, or the task wrapper's, from the scan's
    state t; the default SoA path, the kernels' plain versions on the CPU),
    with the env, robot and index where it is largest, beside JAX's envelope
    at t: the largest difference of JAX's jitted step from state t with the
    robots' qd and ang_vel nudged by one part in 10^6 (16 draws). "*" marks
    a difference over `TOLS` (tests/test_torch_env.py), "excused" where the
    envelope is over them too;
  - JAX's jitted step from the same states not nudged: it compiles nearly
    the scan's own arithmetic, so it is mostly exactly 0 and measures no
    rounding (not a second opinion on the port);
  - the port's replay from the start, every step from its own last (as
    tests/test_torch_golden_traj.py runs it): the base-position difference
    from the golden after each step.
`--json FILE` writes the rule's breaks and the replay's distances
(chip_smoke.py phase `goldens` reads it).

`--stages [STEP]` (default 16, the landing; needs JAX, on the CPU) splits
drop step STEP into its stages, `_locomotion_action`, then 4 times
`_torques` and `_physics` (2 scene substeps), each jitted alone in JAX and
chained from the scan's state. The port's same stage takes JAX's input of
that stage, and the tool prints the relative difference of their outputs
(largest |port - JAX| over largest |JAX|), and the chain's end against the
scan's next state.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import golden_steps as G  # noqa: E402
from test_torch_env import TOLS  # noqa: E402


def stages(rec, t):
    """The stage split of drop step `t` (see the module docstring)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import make_torch_goldens as M

    from mqe_tpu_torch.utils.convert import env_state_from_numpy

    jenv, port = M._drop_env(), G.drop_env("cpu")
    pre = "drop/state/"
    at_t = {"s/" + k[len(pre):]: v[t] for k, v in rec.items() if k.startswith(pre)}
    js = M._unflat_like(jenv._reset_all(jax.random.PRNGKey(0)), at_t, "s")
    ported = lambda s: env_state_from_numpy(jax.tree.map(np.asarray, s), device="cpu")  # noqa: E731
    tensor = lambda x: torch.as_tensor(np.array(x))  # noqa: E731

    def rel(p, j):
        j = np.asarray(j)
        return float(np.abs(p.numpy() - j).max() / np.abs(j).max())

    cmds = jnp.zeros((2, jenv.num_agents, 3))
    out = jax.jit(jenv._locomotion_action)(js, cmds)
    action = out[0]
    print(f"drop step {t}, each stage of the port from JAX's input of that stage, "
          "relative difference of the outputs:")
    p_action = port._locomotion_action(ported(js), tensor(cmds))[0]
    print(f"  _locomotion_action: action {rel(p_action, action):.2e}")
    js = js.replace(gait_indices=out[1], clock_inputs=out[2], loco_obs=out[3], loco_hist=out[4],
                    last2_loco_action=js.last_loco_action, last_loco_action=action,
                    commands=cmds, vel_int=out[5])
    torques, physics = jax.jit(jenv._torques), jax.jit(jenv._physics)
    for i in range(jenv.decimation):
        tau, err_hist, lag, _ = torques(js, action)
        phys, _ = physics(js, tau)
        p_tau = port._torques(ported(js), tensor(action))[0]
        p_phys = port._physics(ported(js), tensor(tau))[0]
        print(f"  {i}: _torques tau {rel(p_tau, tau):.2e}; _physics "
              + ", ".join(f"{f} {rel(getattr(p_phys.agents, f), getattr(phys.agents, f)):.2e}"
                          for f in G.FIELDS))
        js = js.replace(phys=phys, err_hist=err_hist, lag_buffer=lag)
    end = {f: np.abs(np.asarray(getattr(js.phys.agents, f)) - rec[f"drop/after/{f}"][t]).max()
           for f in G.FIELDS}
    print("JAX's stages chained, against the scan's next state (largest |difference|): "
          + ", ".join(f"{f} {v:.2e}" for f, v in end.items()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--name", default="drop", choices=list(G.RUNS))
    p.add_argument("--device", default="cpu")
    p.add_argument("--json", default=None, help="write the results to this file")
    p.add_argument("--stages", type=int, nargs="?", const=16, default=None, metavar="STEP",
                   help="split drop step STEP into its stages against JAX's (needs JAX)")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    rec = G.load()
    if args.stages is not None:
        with torch.no_grad():
            stages(rec, args.stages)
        return 0
    run = G.Golden(rec, args.name, args.device)
    steps = list(range(run.steps))
    diffs, where = run.one_steps(steps)
    unexcused, excused = G.judge(rec, args.name, steps, diffs, TOLS)
    marks = {(t, f): " excused" for t, f, *_ in excused}
    marks.update({(t, f): " UNEXCUSED" for t, f, *_ in unexcused})
    print(f"{args.name} on {args.device}: the port's one step from each scan state / JAX's "
          "envelope there (worst env, robot, index); * over TOLS")
    for i, t in enumerate(steps):
        cells = []
        for f in run.fields:
            bound = TOLS[G.BOUND_OF.get(f, f)]
            star = "*" if diffs[f][i] > bound else ""
            cells.append(f"{f} {diffs[f][i]:.2e}{star} / {rec[f'{args.name}/envelope/{f}'][t]:.2e}"
                         f" {where[f][i]}{marks.get((t, f), '')}")
        print(f"{t:4d}  " + ", ".join(cells))
    jit = np.stack([rec[f"{args.name}/jit/{f}"] for f in run.fields])
    print("JAX's jitted step from each scan state, not nudged (nearly the scan's own "
          f"arithmetic, so no measure of rounding): all quantities 0 at "
          f"{int((jit.max(axis=0) == 0).sum())} of {run.steps} steps; largest "
          + ", ".join(f"{f} {v.max():.2e} (step {int(v.argmax())})"
                      for f, v in zip(run.fields, jit)))
    print(f"excused: {G.describe(excused)}")
    print(f"unexcused: {G.describe(unexcused)}")
    replay = run.replay()
    over = np.flatnonzero(replay > 0.01)
    print("replay from the start, |base pos - golden| after each step (m): "
          + " ".join(f"{v:.2e}" for v in replay))
    print(f"replay: largest {replay.max():.5f} m at step {int(replay.argmax())}, over 0.01 m "
          f"from step {int(over[0]) if over.size else None}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"unexcused": unexcused, "excused": excused, "replay": replay.tolist()}, f)
    return 1 if unexcused else 0


if __name__ == "__main__":
    sys.exit(main())
