"""What decides `correct`: the program's answers from the window (gym
cells: checked steps; training cells: an update of the window drawn from
the seed) against the plain reference, `reference/refsim`, which imports nothing of the program.

The reference follows the program step by step from the program's own
state: a step of 8 substeps with contact is chaotic, so two float32 paths
that part by rounding part further with every step, and no reference can
follow the program over a window. So each checked step starts from the
state the program stepped from, with the draws it drew, and its answers are
compared; the start (the reset, from the same draws) is checked the same
way. Training cells check the checked rollout steps so, the policy's
outputs over the whole rollout, and the SGD phase from the program's
rollout and the program's params, Adam state and return statistics from
before the update: the losses of the first three minibatch steps, the
first gradient as Adam holds it after one step, and each leaf's change
after three.

Numbers compared (each with its limit from limits/<cell>.json):
  row_err_p50   over the reset and each checked step, the largest median
                over envs of an env's worst error, each quantity's error
                over the reference's root mean square of that quantity
  row_err_p99   the same at the 99th percentile
  policy_err    the worst error of the rollout's logp, value and action
                over the reference's root mean square
  loss_gap      the worst |loss - loss_ref| / |loss_ref| of the first three
  grad_gap      the worst leaf's gap of gradient norms ((mu_1 - b1 mu_0) /
                (1 - b1): Adam's mu after one step and before it) over
                max(its norm, the median leaf's)
  change_gap    the same for each leaf's change over three steps, leaves
                whose reference gradient is under 1e-3 of the median leaf's
                left out
The control (`candidate="tf32"`) puts the reference, with TF32 matrix
products, in the program's place; the faults in `FAULTS` plant a broken
step in the reference put there. The benchmark's runs compare the program.
"""
from __future__ import annotations

import importlib
import os
import statistics
import sys
from contextlib import contextmanager
from dataclasses import fields, is_dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference")


def refsim():
    if REF_DIR not in sys.path:
        sys.path.insert(0, REF_DIR)
    return importlib.import_module("refsim")


def to_ref(x):
    """The program's state as the reference's classes (matched by module and
    class name), every tensor cloned."""
    if is_dataclass(x) and not isinstance(x, type):
        mod = type(x).__module__.split(".", 1)
        cls = getattr(importlib.import_module("refsim." + mod[1]), type(x).__name__)
        return cls(**{f.name: to_ref(getattr(x, f.name)) for f in fields(x)})
    if isinstance(x, dict):
        return {k: to_ref(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_ref(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return x


def strict_draws(given: dict, device):
    """The reference's Draws that hands out only the recorded draws."""
    from refsim.utils.random import Draws

    class StrictDraws(Draws):
        def _need(self, name):
            if name not in self.given:
                raise KeyError(f"the reference asked for draw {name!r}, which the program "
                               f"did not draw (recorded: {sorted(self.given)})")

        def uniform(self, name, *a, **k):
            self._need(name)
            return super().uniform(name, *a, **k)

        def normal(self, name, *a, **k):
            self._need(name)
            return super().normal(name, *a, **k)

        def integers(self, name, *a, **k):
            self._need(name)
            return super().integers(name, *a, **k)

        def permutation(self, name, *a, **k):
            self._need(name)
            return super().permutation(name, *a, **k)

    one = {}
    for k, v in given.items():
        if len(v) != 1:
            raise ValueError(f"draw {k!r} made {len(v)} times in one step")
        one[k] = v[0]
    return StrictDraws(torch.Generator(device=device), one)


def _tf32_round(x):
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _Tf32Mode(TorchDispatchMode):
    """TF32 matrix products where the device has none (the CPU): the float32
    inputs of every matrix product rounded to TF32, float32 accumulation."""

    OPS = ("mm", "addmm", "bmm", "baddbmm")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            args = tuple(_tf32_round(a) if isinstance(a, torch.Tensor)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **(kwargs or {}))


@contextmanager
def precision(candidate, device):
    """The reference in the program's place at TF32 (the control), or as
    configured (float32, TF32 off)."""
    on_card = torch.device(device).type == "cuda"
    if candidate != "tf32":
        yield
        return
    if on_card:
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    else:
        with _Tf32Mode():
            yield


# ---------------------------------------------------------------------------
# row errors
# ---------------------------------------------------------------------------
def _rows(p, r, E):
    """An env's worst error of one quantity over the quantity's RMS."""
    p = torch.as_tensor(np.asarray(p) if not isinstance(p, torch.Tensor) else p)
    r = torch.as_tensor(np.asarray(r) if not isinstance(r, torch.Tensor) else r)
    p, r = p.to(r.device, torch.float64), r.to(torch.float64)
    d = (p - r).abs().reshape(E, -1)
    scale = torch.sqrt((r * r).mean()).clamp_min(1e-12)
    return d.amax(dim=1) / scale if d.shape[1] else torch.zeros(E, dtype=torch.float64,
                                                                device=r.device)


def state_quantities(ts):
    """name -> (E, ...) tensor of a TaskState's robots and NPCs."""
    out = {}
    phys = ts.env.phys
    for who in ("agents", "npcs"):
        actor = getattr(phys, who)
        for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
            t = getattr(actor, f)
            if t.numel():
                out[f"{who}.{f}"] = t
    return out


def answer_rows(prog: dict, ref: dict, E: int):
    """-> (rows (E,) worst over quantities, {quantity: (median, max)})."""
    per = {k: _rows(prog[k], ref[k], E) for k in ref}
    rows = torch.stack(list(per.values())).amax(dim=0)
    return rows, {k: (float(v.median()), float(v.max())) for k, v in per.items()}


def row_numbers(sets: list) -> dict:
    """sets: (label, rows). -> row_err_p50, row_err_p99 and each set's."""
    p50 = {lab: float(torch.quantile(r.float(), 0.5)) for lab, r in sets}
    p99 = {lab: float(torch.quantile(r.float(), 0.99)) for lab, r in sets}
    return dict(row_err_p50=max(p50.values()), row_err_p99=max(p99.values()),
                per_set={lab: (p50[lab], p99[lab]) for lab, _ in sets})


# ---------------------------------------------------------------------------
# faults planted in the reference put in the program's place
# ---------------------------------------------------------------------------
def _fault_step(fault, wrap, step):
    """A wrapper step with `fault` planted: "unchanged" returns the state it
    was given; "half_batch" steps half the envs and leaves the rest as they
    were; "altered" offsets the first obs feature of every env by 0.5."""
    def broken(ts, actions, draws):
        ts2, obs, rew, done, info = step(ts, actions, draws)
        E = wrap.num_envs
        if fault == "unchanged":
            return ts, obs, rew, done, info
        if fault == "half_batch":
            from refsim.utils.tree import tree_map

            keep = torch.arange(E, device=obs.device) < E // 2

            def sel(new, old):
                if new.ndim == 0 or new.shape[0] != E:
                    return new
                return torch.where(keep.reshape((E,) + (1,) * (new.ndim - 1)), new, old)
            return tree_map(sel, ts2, ts), obs, rew, done, info
        if fault == "altered":
            obs = obs.clone()
            obs[..., 0] += 0.5
            return ts2, obs, rew, done, info
        raise ValueError(fault)
    return broken


FAULTS = ("unchanged", "half_batch", "altered")


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
class Reference:
    """The reference env built as the program's was (task, envs, seed)."""

    def __init__(self, task: str, num_envs: int, env_seed: int, device):
        refsim()
        from refsim.envs.registry import make_mqe_env

        self.device = device
        self.wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=env_seed, device=device)
        self.E = num_envs

    def step(self, ts_in, actions, draws, candidate=None):
        """-> (ts, obs, rew, done) of the reference, or of the candidate put
        in the program's place."""
        step = self.wrap.step
        if candidate in FAULTS:
            step = _fault_step(candidate, self.wrap, step)
        with precision(candidate, self.device), torch.no_grad():
            ts, obs, rew, done, _ = step(to_ref(ts_in), actions, strict_draws(draws, self.device))
        return ts, obs, rew, done

    def reset(self, draws, candidate=None):
        with precision(candidate, self.device), torch.no_grad():
            return self.wrap.reset(strict_draws(draws, self.device))


def gym_check(ref: Reference, start: dict, checks: list, prescale: float, candidate=None):
    """Row errors of the reset and each checked step. -> (numbers, detail)."""
    E = ref.E
    sets, detail = [], {}
    ts_r, obs_r = ref.reset(start["draws"])
    if candidate is None:
        prog = dict(obs=start["obs"], **state_quantities(start["ts"]))
    else:
        ts_c, obs_c = ref.reset(start["draws"], candidate)
        prog = dict(obs=obs_c, **state_quantities(ts_c))
    rows, per = answer_rows(prog, dict(obs=obs_r, **state_quantities(ts_r)), E)
    sets.append(("reset", rows))
    detail["reset"] = per
    for c in checks:
        a = torch.as_tensor(np.asarray(c["actions"], dtype=np.float32), device=ref.device) * prescale
        ts_r, obs_r, rew_r, done_r = ref.step(c["ts_in"], a, c["draws"])
        if candidate is None:
            done_p = np.asarray(c["done"])[:, 0]
            prog = dict(obs=c["obs"], rew=c["rew"], done=done_p.astype(np.float64),
                        **state_quantities(c["ts_out"]))
        else:
            ts_c, obs_c, rew_c, done_c = ref.step(c["ts_in"], a, c["draws"], candidate)
            prog = dict(obs=obs_c, rew=rew_c, done=done_c.double(), **state_quantities(ts_c))
        refq = dict(obs=obs_r, rew=rew_r, done=done_r.double(), **state_quantities(ts_r))
        rows, per = answer_rows(prog, refq, E)
        sets.append((f"step{c['t']}", rows))
        detail[f"step{c['t']}"] = per
    nums = row_numbers(sets)
    detail["sets"] = nums.pop("per_set")
    return nums, detail


def _leaf_norm_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """The worst leaf's |norm_p - norm_r| / max(norm_r, median leaf norm_r)."""
    names = [k for k in ref if keep is None or k in keep]
    nr = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    npg = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in names}
    med = statistics.median(nr.values())
    gaps = {k: abs(npg[k] - nr[k]) / max(nr[k], med, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_check(ref: Reference, tr_kind: str, ppo_fields: dict, seed: int, rec: dict,
                candidate=None):
    """The training cell's numbers from the records of the trainer's reset
    and of the update recorded in the window, which starts from the
    program's params, Adam state and return statistics (`ts_in`)."""
    from refsim.learn.mat import MATTrainer
    from refsim.learn.ppo import PPOConfig, PPOTrainer, TrainState

    dev = ref.device
    if tr_kind == "mat":
        rtr = MATTrainer(ref.wrap, PPOConfig(**{"algo": "mat", **ppo_fields}), seed=seed)
    else:
        rtr = PPOTrainer(ref.wrap, PPOConfig(**ppo_fields), seed=seed)
    ts_in = rec["ts_in"]
    params0 = {k: v.detach().clone() for k, v in ts_in["params"].items()}
    nums, detail = {}, {}

    # the start: the trainer's reset, from the same draws
    start = rec["start"]
    ts_r, obs_r = ref.reset(start["draws"])
    if candidate is None:
        prog = dict(obs=start["obs"], **state_quantities(start["ts"]))
    else:
        ts_c, obs_c = ref.reset(start["draws"], candidate)
        prog = dict(obs=ref.wrap.observe(ts_c), **state_quantities(ts_c))
    rows, per = answer_rows(prog, dict(obs=ref.wrap.observe(ts_r), **state_quantities(ts_r)),
                            ref.E)
    sets = [("reset", rows)]
    detail["reset"] = per

    # the checked rollout steps, from the program's state
    for c in rec["env_steps"]:
        ts_r, obs_r, rew_r, done_r = ref.step(c["ts_in"], c["cmd"], c["draws"])
        if candidate is None:
            prog = dict(obs=c["obs"], rew=c["rew"], done=c["done"].double(),
                        **state_quantities(c["ts_out"]))
        else:
            ts_c, obs_c, rew_c, done_c = ref.step(c["ts_in"], c["cmd"], c["draws"], candidate)
            prog = dict(obs=obs_c, rew=rew_c, done=done_c.double(), **state_quantities(ts_c))
        refq = dict(obs=obs_r, rew=rew_r, done=done_r.double(), **state_quantities(ts_r))
        rows, per = answer_rows(prog, refq, ref.E)
        sets.append((f"step{c['t']}", rows))
        detail[f"step{c['t']}"] = per
    rn = row_numbers(sets)
    detail["sets"] = rn.pop("per_set")
    nums.update(rn)

    # the policy's outputs over the rollout, under the params it ran with
    traj, final_value = rec["rollout"]
    E, A = rtr.E, rtr.A

    def policy_out(cand):
        with precision(cand, dev), torch.no_grad():
            outs = {"logp": [], "value": []}
            for t in range(traj["obs"].shape[0]):
                obs, act = traj["obs"][t], traj["action"][t]
                if tr_kind == "mat":
                    mean, log_std, value = rtr._apply(params0, obs, rtr._shift_actions(act),
                                                      blocks=True)
                else:
                    mean, log_std, value, _ = rtr._apply(params0, obs, blocks=True)
                from refsim.learn.networks import gaussian_logp
                outs["logp"].append(gaussian_logp(mean, log_std, act))
                outs["value"].append(value)
            acts = {}
            for c in rec["env_steps"]:
                t = c["t"]
                obs = traj["obs"][t]
                if tr_kind == "mat":
                    mean, log_std, _ = rtr._apply(params0, obs, rtr._shift_actions(traj["action"][t]),
                                                  blocks=True)
                else:
                    mean, log_std, _, _ = rtr._apply(params0, obs, blocks=True)
                acts[t] = mean + torch.exp(log_std) * c["act_noise"]
            return {k: torch.stack(v) for k, v in outs.items()}, acts

    pol_r, act_r = policy_out(None)
    if candidate is None:
        pol_p = {"logp": traj["logp"], "value": traj["value"]}
        act_p = {c["t"]: traj["action"][c["t"]] for c in rec["env_steps"]}
    else:
        pol_p, act_p = policy_out(candidate)

    def rel(p, r):
        r64 = r.double()
        return float((p.double() - r64).abs().max() / torch.sqrt((r64 * r64).mean()).clamp_min(1e-12))
    perr = {k: rel(pol_p[k], pol_r[k]) for k in pol_r}
    perr.update({f"action{t}": rel(act_p[t], act_r[t]) for t in act_r})
    nums["policy_err"] = max(perr.values())
    detail["policy"] = perr

    # the SGD phase from the program's rollout
    def sgd(cand):
        losses, opt = [], {}
        loss_fn, tx_step = rtr._loss, rtr.tx.step

        def loss_rec(params, batch, rows=None):
            if cand == "half_batch":
                n = batch["adv"].shape[0] // 2
                batch = {k: v[:n] for k, v in batch.items()}
            out = loss_fn(params, batch, rows)
            if len(losses) < 3:
                losses.append(out[0].detach())
            return out

        def tx_rec(params, grads, state):
            if cand == "unchanged":
                new, st = params, tx_step(params, grads, state)[1]
            else:
                new, st = tx_step(params, grads, state)
            opt["n"] = opt.get("n", 0) + 1
            if opt["n"] == 1:
                opt["state_1"] = st
            if opt["n"] == 3:
                opt["params_3"] = new
            return new, st

        ts_r = TrainState(params=dict(params0), opt_state=to_ref(ts_in["opt_state"]),
                          env_state=None, generator=None, update_count=ts_in["update_count"],
                          ret_mean=ts_in["ret_mean"].clone(), ret_var=ts_in["ret_var"].clone(),
                          ep_acc=None)
        rollout = (None, {k: v.clone() for k, v in traj.items()}, final_value.clone(), None, None)
        rtr._loss, rtr.tx.step = loss_rec, tx_rec
        try:
            with precision(cand if cand == "tf32" else None, dev):
                rtr._learn(ts_r, rollout, given={"perm": rec["perm"]})
        finally:
            del rtr._loss, rtr.tx.step
        return losses, opt["state_1"], opt["params_3"]

    loss_r, st_r, p3_r = sgd(None)
    if candidate is None:
        loss_p, st_p, p3_p = rec["losses"], rec["opt_state_1"], rec["params_3"]
    else:
        loss_p, st_p, p3_p = sgd(candidate)
    nums["loss_gap"] = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                           for a, b in zip(loss_p, loss_r))
    b1, mu0 = rtr.tx.b1, ts_in["opt_state"].mu
    g_r = {k: (v - b1 * mu0[k]) / (1 - b1) for k, v in st_r.mu.items()}
    g_p = {k: (v - b1 * mu0[k]) / (1 - b1) for k, v in st_p.mu.items()}
    nums["grad_gap"], detail["grad_worst"] = _leaf_norm_gap(g_p, g_r)
    gn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in g_r.items()}
    med = statistics.median(gn.values())
    keep = {k for k, v in gn.items() if v >= 1e-3 * med}
    detail["left_out"] = sorted(set(gn) - keep)
    d_r = {k: p3_r[k] - params0[k] for k in p3_r}
    d_p = {k: p3_p[k] - params0[k] for k in p3_p}
    nums["change_gap"], detail["change_worst"] = _leaf_norm_gap(d_p, d_r, keep)
    detail["losses"] = ([float(x) for x in loss_p], [float(x) for x in loss_r])
    return nums, detail


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}). A number without a limit is shown
    and does not decide; a missing or non-finite number fails."""
    shown, ok = {}, True
    for name, value in nums.items():
        lim = limits.get(name)
        v = float(value)
        shown[name] = {"value": v, "limit": lim}
        if lim is not None and not (np.isfinite(v) and v <= lim):
            ok = False
    for name in limits:
        if name not in nums:
            shown[name] = {"value": None, "limit": limits[name]}
            ok = False
    return ok, shown
