"""The general traffic generator: one driver for each kind of traffic mix,
driven by the mix's data file (traffic/<mix>.json) and the cell's
configuration file. A driver builds the system under test from the seed
(set-up), runs the measured window, and on a traced run the profiled and
the stage-timed segments, and hands the comparison its records.

kind "gym": a `GymAdapter` loop, numpy actions uniform in [low, high] from
a pool of `action_pool` arrays drawn at set-up and cycled, each step the
next one; `check_steps` steps of the window drawn from the seed among the
first `check_within` are recorded for the reference.

kind "train": `PPOTrainer` or `MATTrainer` updates back to back
(`trainer`: "ppo" or "mat"; `ppo_config`: PPOConfig fields over its
defaults); set-up runs the first update, which builds every shape; the
update of the window drawn from the seed among its first `check_within`
is recorded for the reference: `check_steps` of its env steps, its
rollout, its first three minibatch steps.

What is recorded is cloned as it is handed over. A record that comes out
short (a checked step or update never reached, an env step, loss or Adam
state that did not pass where it is recorded) is listed under `missing`,
and the run is not correct.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.record import (DrawRecorder, LaunchRecorder, StageTimer, clone_tree, labelled,
                              patched)
from portbench.stats import window_rate

MAX_SEED = 2 ** 63 - 1


def sub_seeds(seed: int, n: int) -> list:
    """n independent seeds (each < 2**31) derived from the run's seed."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(n)
    return [int(w) & 0x7FFFFFFF for w in words]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_params(trainer, seed: int, device) -> dict:
    """The trainer's parameters drawn from the seed on the device in one call:
    a weight N(0, 1/fan_in), a LayerNorm gain 1 + N(0, 0.01), a bias
    N(0, 0.01), log_std -0.5 + N(0, 0.01); the trainer's own names and
    shapes."""
    shapes = {k: tuple(v.shape) for k, v in trainer.init_params.items()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        x = flat[at:at + n].reshape(shape)
        at += n
        if name.endswith("log_std"):
            x = -0.5 + 0.1 * x
        elif name.endswith("weight") and len(shape) == 2:
            x = x / float(np.sqrt(shape[1]))
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


class Driver:
    def __init__(self, cell, seed: int, device, num_envs: int | None = None):
        self.cell, self.device = cell, device
        self.mix = cell.traffic
        self.cfg = cell.config
        self.num_envs = int(num_envs or self.cfg["num_envs"])
        self.env_seed, self.run_seed, self.pool_seed, self.check_seed = sub_seeds(seed, 4)

    def build_env(self):
        from mqe_tpu_torch.envs.registry import make_mqe_env

        self.wrap, _ = make_mqe_env(self.cfg["task"], num_envs=self.num_envs,
                                    seed=self.env_seed, device=self.device)
        return self.wrap

    # the stages both kinds time and label, inside the env step
    def env_stages(self):
        from mqe_tpu_torch.physics import scene

        env = self.wrap.env
        st = {"wrapper_step": (self.wrap, "step"),
              "locomotion_action": (env, "_locomotion_action"), "torques": (env, "_torques"),
              "substep_batch": (scene, "substep_batch"),
              "fk_spheres_kernel": (scene, "fk_spheres_kernel"),
              "step_actor_kernel": (scene, "step_actor_kernel"),
              "termination": (env, "_termination"), "step_finish": (env, "_step_finish")}
        if env.num_npcs > 0:
            st["fk_full_kernel"] = (scene, "fk_full_kernel")
            st["npc_script"] = (env, "_npc_script")
        return st

    def profiled(self, body):
        """Run body() under torch.profiler with the stage labels and the
        launch recorder installed, no synchronize inside -> (prof, launches)."""
        from mqe_tpu_torch.physics import fused_step

        launches = LaunchRecorder(fused_step)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sync(self.device)
        with launches.installed(), labelled(self.stages()):
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("pb:window"):
                    body()
                    sync(self.device)
        return prof, launches.launches

    def stage_timed(self, body):
        timer = StageTimer(self.device)
        with timer.installed(self.stages()):
            body()
        return timer


class GymDriver(Driver):
    kind = "gym"

    def setup(self):
        from mqe_tpu_torch.envs.gym_adapter import GymAdapter
        from mqe_tpu_torch.utils import random as prandom

        wrap = self.build_env()
        mix = self.mix
        self.adapter = GymAdapter(wrap, seed=self.run_seed,
                                  action_prescale=float(mix.get("action_prescale", 0.5)))
        E, A = wrap.num_envs, wrap.controlled_agents
        rng = np.random.default_rng(self.pool_seed)
        self.pool = rng.uniform(mix["low"], mix["high"],
                                (int(mix["action_pool"]), E, A, wrap.action_dim)).astype(np.float32)
        self.draws_cls = prandom.Draws
        rec = DrawRecorder(self.draws_cls)
        with rec.installed():
            obs0 = self.adapter.reset()
        self.start = clone_tree(dict(draws=rec.by_tag[None], ts=self.adapter._ts, obs=obs0))
        crng = np.random.default_rng(self.check_seed)
        self.check_at = sorted(crng.choice(int(mix["check_within"]), int(mix["check_steps"]),
                                           replace=False).tolist())
        self.k = 0
        for _ in range(int(mix.get("warm_steps", 2))):
            self._step()
        sync(self.device)

    def _step(self):
        out = self.adapter.step(self.pool[self.k % len(self.pool)])
        self.k += 1
        return out

    def window(self, seconds: float) -> dict:
        checks, times = [], []
        self.k0 = self.k
        want = {self.k0 + i for i in self.check_at}
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            k = self.k
            if k in want:
                rec = DrawRecorder(self.draws_cls)
                ts_in, actions = clone_tree(self.adapter._ts), self.pool[k % len(self.pool)]
                with rec.installed():
                    ts = time.perf_counter()
                    obs, rew, done, info = self._step()
                    t_end = time.perf_counter()
                checks.append(clone_tree(dict(t=k - self.k0, ts_in=ts_in, actions=actions,
                                              draws=rec.by_tag[None], ts_out=self.adapter._ts,
                                              obs=obs, rew=rew, done=done)))
            else:
                ts = time.perf_counter()
                self._step()
                t_end = time.perf_counter()
            times.append(t_end - ts)
        steps = self.k - self.k0
        return dict(steps=steps, seconds=t_end - t0, step_s=times, checks=checks,
                    missing=[i for i in self.check_at if i >= steps],
                    failed=sum(i >= steps for i in self.check_at), work=steps * self.num_envs)

    def e2e(self, w: dict) -> dict:
        return {"env_steps_per_s": window_rate(w["work"], w["seconds"])}

    def records(self, w: dict):
        """What the comparison reads: the reset and the checked steps."""
        return self.start, w["checks"]

    def stages(self):
        st = self.env_stages()
        st["adapter_step"] = (self.adapter, "step")
        return st

    def traced(self, steps: int) -> dict:
        def body():
            for _ in range(steps):
                self._step()
        prof, launches = self.profiled(body)
        timer = self.stage_timed(body)
        return dict(prof=prof, launches=launches, units=steps, timer=timer, steps=steps)

    def release(self):
        del self.adapter, self.wrap


class TrainDriver(Driver):
    kind = "train"

    def setup(self):
        from dataclasses import replace

        from mqe_tpu_torch.learn.mat import MATTrainer
        from mqe_tpu_torch.learn.ppo import PPOConfig, PPOTrainer
        from mqe_tpu_torch.utils import random as prandom

        wrap = self.build_env()
        mix = self.mix
        fields = dict(mix.get("ppo_config", {}))
        if mix["trainer"] == "mat":
            self.trainer = MATTrainer(wrap, PPOConfig(**{"algo": "mat", **fields}),
                                      seed=self.run_seed)
        else:
            self.trainer = PPOTrainer(wrap, PPOConfig(**fields), seed=self.run_seed)
        tr = self.trainer
        self.draws_cls = prandom.Draws
        rec = DrawRecorder(self.draws_cls)
        with rec.installed():
            ts = tr.init_state()
        self.start = clone_tree(dict(draws=rec.by_tag[None], ts=ts.env_state,
                                     obs=tr.w.observe(ts.env_state)))
        params = make_params(tr, self.run_seed, self.device)
        ts = replace(ts, params=params, opt_state=tr.tx.init(params))
        crng = np.random.default_rng(self.check_seed)
        self.check_u = int(crng.integers(int(mix.get("check_within", 1))))
        self.check_t = sorted(crng.choice(tr.cfg.rollout_len, int(mix["check_steps"]),
                                          replace=False).tolist())
        self.ts, _ = tr.update(ts)
        sync(self.device)

    def _recorded_update(self, ts):
        """One update through `update` as the window calls it, with what the
        reference follows recorded: the state it starts from, the draws of
        the checked rollout steps and the epochs' permutations, the checked
        env steps' states, the rollout, the first three minibatch steps'
        losses, the Adam state after the first, the params after the third.
        -> (ts, record, what came out short)."""
        tr = self.trainer
        check_t = self.check_t
        rec = DrawRecorder(self.draws_cls, keep=lambda tag, name: name == "perm" or (
            tag is not None and tag[1] in check_t))
        rec.tag = ("pre", 0)
        env_steps, rollout, losses, opt = [], {}, [], {}
        w_step, roll, loss_fn, tx_step = tr.w.step, tr._rollout, tr._loss, tr.tx.step

        def step(ts_env, cmd, draws=None):
            t = rec.tag[1]
            rec.tag = ("env", t)
            ts_in = clone_tree(ts_env) if t in check_t else None
            out = w_step(ts_env, cmd, draws)
            rec.tag = ("pre", t + 1)
            if t in check_t:
                env_steps.append(dict(t=t, ts_in=ts_in, cmd=clone_tree(cmd),
                                      **clone_tree(dict(ts_out=out[0], obs=out[1], rew=out[2],
                                                        done=out[3]))))
            return out

        def rollout_rec(*a, **k):
            out = roll(*a, **k)
            rollout["out"] = clone_tree(out[1:3])
            rec.tag = ("sgd", -1)
            return out

        def loss_rec(*a, **k):
            out = loss_fn(*a, **k)
            if len(losses) < 3:
                losses.append(out[0].detach().clone())
            return out

        def tx_rec(params, grads, state):
            new, st = tx_step(params, grads, state)
            n = opt.setdefault("n", 0) + 1
            opt["n"] = n
            if n == 1:
                opt["state_1"] = clone_tree(st)
            if n == 3:
                opt["params_3"] = clone_tree(new)
            return new, st

        ts_in = clone_tree(dict(params=ts.params, opt_state=ts.opt_state, ret_mean=ts.ret_mean,
                                ret_var=ts.ret_var, update_count=ts.update_count))
        with rec.installed(), patched([(tr.w, "step", step), (tr, "_rollout", rollout_rec),
                                       (tr, "_loss", loss_rec), (tr.tx, "step", tx_rec)]):
            ts, _ = tr.update(ts)
        for d in env_steps:
            d["draws"] = rec.by_tag[("env", d["t"])]
            d["act_noise"] = rec.by_tag[("pre", d["t"])].get("act_noise", [None])[0]
        record = dict(ts_in=ts_in, env_steps=env_steps, rollout=rollout.get("out"),
                      losses=losses, opt_state_1=opt.get("state_1"),
                      params_3=opt.get("params_3"), perm=rec.by_tag[("sgd", -1)].get("perm"),
                      check_t=check_t)
        short = []
        if [d["t"] for d in env_steps] != check_t:
            short.append(f"env steps {[d['t'] for d in env_steps]} recorded of {check_t}")
        for name, n, want in (("losses", len(losses), 3),
                              ("perm", len(record["perm"] or ()), tr.cfg.ppo_epochs)):
            if n < want:
                short.append(f"{name}: {n} recorded of {want}")
        for name in ("rollout", "opt_state_1", "params_3"):
            if record[name] is None:
                short.append(f"{name} not recorded")
        return ts, record, short

    def window(self, seconds: float) -> dict:
        tr, ts = self.trainer, self.ts
        n, t0 = 0, time.perf_counter()
        t_end, times = t0, []
        record, short = None, [f"update {self.check_u} never reached"]
        while t_end - t0 < seconds:
            ts_ = time.perf_counter()
            if n == self.check_u:
                ts, record, short = self._recorded_update(ts)
            else:
                ts, _ = tr.update(ts)
            sync(self.device)
            t_end = time.perf_counter()
            times.append(t_end - ts_)
            n += 1
        self.ts = ts
        T = tr.cfg.rollout_len
        return dict(updates=n, seconds=t_end - t0, update_s=times, work=T * tr.E * n,
                    record=record, missing=short, failed=int(bool(short)))

    def e2e(self, w: dict) -> dict:
        return {"train_env_steps_per_s": window_rate(w["work"], w["seconds"])}

    def records(self, w: dict):
        """What the comparison reads: the trainer's reset and the recorded
        update; None where the record came out short."""
        if w["missing"]:
            return None
        return dict(w["record"], start=self.start)

    def stages(self):
        st = self.env_stages()
        tr = self.trainer
        st.update({"policy": (tr, "_policy"), "gae": (tr, "_gae"), "sgd": (tr, "_sgd")})
        return st

    def traced(self, updates: int) -> dict:
        tr = self.trainer

        def body():
            for _ in range(updates):
                self.ts, _ = tr.update(self.ts)
        prof, launches = self.profiled(body)
        rollout_s, sgd_s = [], []

        def timed_body():
            for _ in range(updates):
                self.ts, _, r, s = tr.timed_update(self.ts)
                rollout_s.append(r)
                sgd_s.append(s)
        timer = self.stage_timed(timed_body)
        return dict(prof=prof, launches=launches, units=updates,
                    timer=timer, rollout_s=rollout_s, sgd_s=sgd_s,
                    steps=updates * tr.cfg.rollout_len)

    def release(self):
        del self.trainer, self.wrap, self.ts


DRIVERS = {"gym": GymDriver, "train": TrainDriver}


def driver_for(cell, seed, device, num_envs=None) -> Driver:
    kind = cell.traffic["kind"]
    if kind not in DRIVERS:
        raise ValueError(f"traffic kind {kind!r}: no driver (have {sorted(DRIVERS)})")
    return DRIVERS[kind](cell, seed, device, num_envs)
