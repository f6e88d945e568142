"""One control step of the port from each state of the JAX package's
trajectory goldens, held to the golden's next state under JAX's own spread.

tests/goldens/torch_golden_steps.npz (tools/make_torch_goldens.py
`record_golden_steps`) holds, for each golden of `RUNS` (tests/goldens/
drop.npz, walk.npz, push.npz), the state of the golden's `lax.scan` before
every step t (stacked over t), the robots' state after it, and JAX's
envelope at t: the largest difference from that next state of JAX's own
jitted step from state t with the robots' qd and ang_vel nudged by one part
in 10^6, over 16 draws.

The rule (`judge`): at every step and quantity the port's difference from the
scan's next state is within its bound, or JAX's envelope at that step and
quantity already exceeds the bound (then the step is excused: the state is
one where JAX itself turns a rounding-sized difference into more than the
bound). tests/test_torch_golden_steps.py applies it on the CPU,
chip_smoke.py phase `goldens` on the card (the kernels). This module imports
torch, numpy and the port only.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "goldens", "torch_golden_steps.npz")
# name: (task or "drop", the constant forward command), as tools/make_goldens.py runs them
RUNS = {"drop": ("drop", 0.0), "walk": ("go1plane", 0.5), "push": ("go1pushbox", 0.5)}
FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
# the NPC's position is held to the robots' position bound
BOUND_OF = {"npc_pos": "pos"}


def load(path=FIXTURE) -> dict:
    with np.load(path) as f:
        return dict(f)


def tree(rec, prefix):
    """The pytree recorded under "<prefix>/...": namespaces, a dict under
    "extra" (tests/test_torch_env.py::_tree)."""
    root = {}
    for key, arr in rec.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = root
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = arr

    def build(node, name):
        if not isinstance(node, dict):
            return node
        kids = {k: build(v, k) for k, v in node.items()}
        return kids if name == "extra" else SimpleNamespace(**kids)

    return build(root, "")


def drop_env(device):
    """go1plane's robot released 0.62 m up, 2 envs (tools/make_goldens.py)."""
    from mqe_tpu_torch.envs.go1_env import Go1Env
    from mqe_tpu_torch.envs.tasks import Go1PlaneCfg

    class DropCfg(Go1PlaneCfg):
        class init_state(Go1PlaneCfg.init_state):
            pos = [0.0, 0.0, 0.62]

        class domain_rand(Go1PlaneCfg.domain_rand):
            init_base_pos_range = dict(x=[0.0, 0.0], y=[0.0, 0.0])
            init_base_vel_range = [0.0, 0.0]
            init_dof_pos_ratio_range = [1.0, 1.0]

        class termination(Go1PlaneCfg.termination):
            termination_terms = []

    return Go1Env(DropCfg, num_envs=2, seed=0, device=device)


class Golden:
    """The port's env of the golden `name` on `device`, stepping from the
    fixture's states with the draws JAX's steps took."""

    def __init__(self, rec, name, device="cpu"):
        from mqe_tpu_torch.envs.registry import make_mqe_env

        self.rec, self.name, self.device = rec, name, device
        task, vx = RUNS[name]
        self.steps, num_envs = rec[f"{name}/done"].shape
        self.fields = [f for f in FIELDS + ("npc_pos",) if f"{name}/after/{f}" in rec]
        if task == "drop":
            self.env = drop_env(device)
            cmds = torch.zeros((num_envs, self.env.num_agents, 3), device=device)
            self._step = lambda s, d: self.env.step(s, cmds, d)         # noqa: E731
            self._phys = lambda s: s.phys                                # noqa: E731
        else:
            wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0, device=device)
            self.env = wrap.env
            acts = torch.zeros((num_envs, wrap.controlled_agents, 3), device=device)
            acts[..., 0] = vx
            self._step = lambda s, d: wrap.step(s, acts, d)             # noqa: E731
            self._phys = lambda s: s.env.phys                            # noqa: E731

    def state(self, t):
        """The scan's state before step t."""
        from mqe_tpu_torch.utils.convert import env_state_from_numpy

        pre = f"{self.name}/state/"
        at_t = {k: v[t] for k, v in self.rec.items() if k.startswith(pre)}
        return env_state_from_numpy(tree(at_t, pre[:-1]), device=self.device)

    def step(self, state, t):
        """Step t of the port from `state`, with the draws JAX's step t took."""
        pre = f"{self.name}/draw/{t}/"
        given = {k[len(pre):]: torch.as_tensor(v, device=self.device)
                 for k, v in self.rec.items() if k.startswith(pre)}
        out = self._step(state, self.env.draws(given))
        if bool(out[-2].any()):
            raise AssertionError(f"{self.name}: an env reset at step {t}")
        return out[0]

    def values(self, state):
        """{field: numpy array} of the robots (and the NPCs' pos) in `state`."""
        phys = self._phys(state)
        out = {f: getattr(phys.agents, f).cpu().numpy() for f in FIELDS}
        if "npc_pos" in self.fields:
            out["npc_pos"] = phys.npcs.pos.cpu().numpy()
        return out

    def one_steps(self, steps):
        """The port's step t from the scan's state t, for each t of `steps`,
        against the scan's state t+1: ({field: (n,) largest difference},
        {field: [(env, robot, index) of it]})."""
        diffs = {f: np.zeros(len(steps)) for f in self.fields}
        where = {f: [] for f in self.fields}
        for i, t in enumerate(steps):
            got = self.values(self.step(self.state(t), t))
            for f in self.fields:
                d = np.abs(got[f] - self.rec[f"{self.name}/after/{f}"][t])
                diffs[f][i] = d.max()
                where[f].append(tuple(int(j) for j in np.unravel_index(d.argmax(), d.shape)))
        return diffs, where

    def replay(self):
        """(T,) the largest base-position difference from the golden after each
        step of the port's run from the start, every step from its own last."""
        state, out = self.state(0), []
        for t in range(self.steps):
            state = self.step(state, t)
            pos = self._phys(state).agents.pos.cpu().numpy()
            out.append(float(np.abs(pos - self.rec[f"{self.name}/after/pos"][t]).max()))
        return np.array(out)


def judge(rec, name, steps, diffs, tols):
    """The rule at each step t of `steps` and field: (unexcused, excused),
    lists of (t, field, difference, bound, JAX's envelope) where the
    difference exceeds the bound (`tols`, by field; `BOUND_OF` for the NPC's),
    excused where JAX's envelope at (t, field) exceeds the bound too. An
    excused difference is not held to the envelope: at such a state a
    systematic error of rounding size (the actuator-net torque scaled by
    1 + 1e-6) already lands outside the envelope of 16 draws."""
    unexcused, excused = [], []
    for f, d in diffs.items():
        bound = tols[BOUND_OF.get(f, f)]
        for i, t in enumerate(steps):
            if d[i] > bound:
                envelope = float(rec[f"{name}/envelope/{f}"][t])
                (excused if envelope > bound else unexcused).append(
                    (t, f, float(d[i]), bound, envelope))
    return unexcused, excused


def describe(breaks):
    return "; ".join(f"step {t} {f} {d:.3e} (bound {b:.0e}, JAX's envelope {e:.3e})"
                     for t, f, d, b, e in breaks) or "none"
