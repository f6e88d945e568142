"""Where a control step on the card and on the CPU part: substep by substep.

    python3 tools/compare_card_cpu_substeps.py [--task go1wrestling] [--draw 2]

Builds the task at 2 envs on the card (kernels) and on the CPU (plain
versions), resets both from the generator's `--draw`-th reset draw (the
earlier draws are taken by `fresh_state()` first; `chip_smoke.py` phase
`check` steps from the first), and takes one control step with the actions
and draws of that phase. Every `scene.substep_batch` call of the step (the
env's `decimation` x `subiters` substeps) is recorded on both devices. For
each substep it prints

  - "carried": the largest card-vs-CPU difference of each quantity of the
    state after the substep (the robots' pos, quat, lin_vel, ang_vel, q, qd,
    and the contact force on their spheres), the two runs each carrying
    their own state;
  - "local": the same after the CPU takes the substep from the card's input
    state (one substep's own difference, without what came before), also
    over the largest magnitude of the quantity in the CPU's state;

and the ratio of qd's carried difference to its first substep's. Noise of
float32 amplified by stiff contact shows as a local difference near 1e-7
relative at every substep, and a carried one that grows; a fault of the
port shows as a local difference well above that at some substep.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mqe_tpu_torch.envs.registry import make_mqe_env  # noqa: E402
from mqe_tpu_torch.physics import scene as S  # noqa: E402
from mqe_tpu_torch.utils.convert import env_state_to  # noqa: E402
from mqe_tpu_torch.utils.tree import tree_map  # noqa: E402

FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")


def _recorder(calls):
    real = S.substep_batch

    def rec(scene, terrain, state, tau, dr, dt, npc_tau=None):
        out, contacts = real(scene, terrain, state, tau, dr, dt, npc_tau)
        calls.append(dict(scene=scene, terrain=terrain, state=state, tau=tau, dr=dr, dt=dt,
                          out=out, force=contacts.sphere_force))
        return out, contacts

    return real, rec


def _diffs(a_state, a_force, b_state, b_force):
    d = {n: float((getattr(a_state.agents, n).cpu() - getattr(b_state.agents, n).cpu())
                  .abs().max()) for n in FIELDS}
    d["sphere_force"] = float((a_force.cpu() - b_force.cpu()).abs().max())
    return d


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="go1wrestling")
    p.add_argument("--draw", type=int, default=2, help="the reset draw to step from (1: first)")
    p.add_argument("--out", default=None, help="write the table as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    wrap_c, _ = make_mqe_env(args.task, num_envs=2, seed=0, device="cuda")
    wrap_h, _ = make_mqe_env(args.task, num_envs=2, seed=0, device="cpu")
    for _ in range(args.draw - 1):
        wrap_c.env.fresh_state()
    ts_c, _ = wrap_c.reset()
    rng = np.random.RandomState(5)   # chip_smoke.py phase_check's actions and draws
    acts = rng.uniform(-1, 1, (2, wrap_c.controlled_agents, 3)).astype(np.float32)
    given_c = {"fresh": wrap_c.env.fresh_state(),
               "npc_noise": torch.as_tensor(rng.randn(2, wrap_c.num_npcs, 3).astype(np.float32),
                                            device="cuda")}
    given_h = {"fresh": env_state_to(given_c["fresh"], "cpu"),
               "npc_noise": given_c["npc_noise"].cpu()}
    ts_h = env_state_to(ts_c, "cpu")

    runs = {}
    for where, wrap, ts, given, dev in (("card", wrap_c, ts_c, given_c, "cuda"),
                                        ("cpu", wrap_h, ts_h, given_h, "cpu")):
        calls = []
        real, rec = _recorder(calls)
        S.substep_batch = rec
        try:
            out = wrap.step(ts, torch.as_tensor(acts, device=dev), wrap.env.draws(given))
        finally:
            S.substep_batch = real
        runs[where] = (calls, out)
    if bool(runs["cpu"][1][3].any()):
        print("note: an env reset in the step")

    rows = []
    first_qd = None
    for k, (c, h) in enumerate(zip(runs["card"][0], runs["cpu"][0])):
        carried = _diffs(c["out"], c["force"], h["out"], h["force"])
        to = lambda x: tree_map(lambda t: t.cpu(), x)  # noqa: E731
        local_out, local_contacts = S.substep_batch(
            c["scene"], h["terrain"], to(c["state"]), c["tau"].cpu(), to(c["dr"]), c["dt"])
        local = _diffs(c["out"], c["force"], local_out, local_contacts.sphere_force)
        scale = {n: float(getattr(h["out"].agents, n).abs().max()) for n in FIELDS}
        scale["sphere_force"] = float(h["force"].abs().max())
        first_qd = first_qd or max(carried["qd"], 1e-30)
        rows.append(dict(substep=k, carried=carried, local=local, scale=scale,
                         qd_growth=carried["qd"] / first_qd))
        print(f"substep {k}: carried " + ", ".join(f"{n} {v:.3e}" for n, v in carried.items())
              + " | local " + ", ".join(f"{n} {v:.3e}" for n, v in local.items())
              + f" | qd x{rows[-1]['qd_growth']:.3g}; local / largest |value|: "
              + ", ".join(f"{n} {local[n] / max(scale[n], 1e-30):.2e}" for n in scale),
              flush=True)
    step_qd = float((runs["card"][1][0].env.phys.agents.qd.cpu()
                     - runs["cpu"][1][0].env.phys.agents.qd).abs().max())
    print(f"{args.task} draw {args.draw}: the step's qd card vs CPU {step_qd:.3e}; "
          f"{len(rows)} substeps", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"task": args.task, "draw": args.draw, "step_qd": step_qd, "rows": rows}, f,
                      indent=1)


if __name__ == "__main__":
    main()
