"""Run one episode of a trained policy in the JAX package and in the port from
the same reset states, and compare them env by env.

Lockstep, both packages on the CPU (needs JAX):

    JAX_PLATFORMS=cpu python tools/replay_episode.py --task go1gate \
        --checkpoint checkpoints/rec/go1gate_ppo_best.npz --recurrent \
        --num-envs 1024 --seed 0 [--threads 3] [--save start.npz] [--json out.json]

The JAX package alone (`--jax-only`: no port step, minutes instead of the
port's half hour on the CPU), to save more start states and JAX's results;
the port alone, from files that such runs saved (no JAX; on the card by
default), each compared with JAX's results and all of them pooled:

    python3 tools/replay_episode.py --replay s0.npz [s1.npz ...] [--cpu] [--json out.json]

The JAX package resets the envs with PRNGKey(seed), as its
`learn/evaluate.py` does. The port starts from that reset state
(`env_state_from_numpy`) on the terrain it builds for the same seed (both
packages draw it from numpy's default_rng(seed); the lockstep run checks that
the two builds are equal). Both act on the policy's mean, as `evaluate` does
by default. Each env's first episode is compared: the step at which it ends,
its success flag and its return. An env's steps after its first done are not
compared, since the two packages draw its next reset from different
generators. `--save` writes the JAX reset state, the run's arguments and
the per-env results of the packages it ran; `--replay` runs the port from
each saved state on its device and compares its results with the saved JAX
ones, then pools the discordant envs of all files: z is (JAX-only minus
port-only) over the square root of their sum, a sign test of the paired
outcomes.

It prints the success rate and mean return of each package over the same
first episodes, the discordant envs (one package succeeds, the other not)
and the envs whose episodes end at different steps. Lockstep runs also give,
per env, the first step at which the robots' base positions differ by more
than each of `THRESHOLDS` and the first at which an observation differs by
more than pi (`base_rpy` wraps at 0 and 2 pi, as the reference's
`get_euler_xyz` does, so a roll near 0 that rounds to the other side jumps by
2 pi), and the largest base position difference every 25 steps. Both modes
reset the port with its own generator (`Draws`) at the same seed and compare,
per component, the mean, spread and range of every reset field with JAX's
reset: the two draw different numbers from the same distributions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# base position differences (m) whose first crossing is reported per env
THRESHOLDS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
RUN_ARGS = ("task", "checkpoint", "recurrent", "num_envs", "seed")


def _components(x):
    """(n, c) float64 of an array whose last axis is its components."""
    x = np.asarray(x, dtype=np.float64)
    return x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(-1, 1)


def reset_stats(jts, tts):
    """Per field and component of two reset states: the mean of each, the
    difference of the means over its standard error, and the min and max of
    each."""
    out = {}
    fields = [("agents/" + f, getattr(jts.env.phys.agents, f), getattr(tts.env.phys.agents, f))
              for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")]
    fields += [("dr/" + f, getattr(jts.env.dr, f), getattr(tts.env.dr, f))
               for f in type(tts.env.dr).__dataclass_fields__]
    fields += [("env/" + f, getattr(jts.env, f), getattr(tts.env, f))
               for f in ("gait_indices", "terrain_levels")]
    fields += [("extra/" + k, jts.extra[k], v) for k, v in sorted(tts.extra.items())]
    for name, j, t in fields:
        j, t = _components(j), _components(t.cpu().numpy())
        se = np.sqrt(j.var(0) / len(j) + t.var(0) / len(t))
        z = np.where(se > 0, (t.mean(0) - j.mean(0)) / np.maximum(se, 1e-30), 0.0)
        out[name] = {"jax_mean": j.mean(0).round(6).tolist(), "port_mean": t.mean(0).round(6).tolist(),
                     "z": z.round(3).tolist(),
                     "jax_min": j.min(0).round(6).tolist(), "port_min": t.min(0).round(6).tolist(),
                     "jax_max": j.max(0).round(6).tolist(), "port_max": t.max(0).round(6).tolist()}
    return out


def _tree(data, prefix):
    """The pytree saved under "<prefix>/...": namespaces, a dict under "extra"."""
    root = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = root
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = data[key]

    def build(node, name):
        if not isinstance(node, dict):
            return node
        kids = {k: build(v, k) for k, v in node.items()}
        return kids if name == "extra" else SimpleNamespace(**kids)

    return build(root, "")


class Tracker:
    """Each env's first episode: the step it ends, its success and return."""

    def __init__(self, E):
        self.end = np.full(E, -1)
        self.succ = np.zeros(E, bool)
        self.ret = np.zeros(E)

    def add(self, t, rew, done, info):
        live = self.end < 0
        self.ret[live] += rew.mean(axis=-1)[live]
        new = live & done
        self.end[new] = t
        if "ep_success" in info:
            self.succ[new] = np.asarray(info["ep_success"])[new]

    def finished(self):
        return bool((self.end >= 0).all())


def compare(jax_t, port_t):
    """Both packages' first episodes over the same envs."""
    se = lambda p, n: float(np.sqrt(max(p * (1 - p), 1e-12) / max(n, 1)))  # noqa: E731
    both = (jax_t.end >= 0) & (port_t.end >= 0)
    out = {"ended_in_both": int(both.sum())}
    for name, tr in (("jax", jax_t), ("port", port_t)):
        m = tr.end >= 0
        rate = float(tr.succ[m].mean()) if m.any() else float("nan")
        out[name] = {"ended": int(m.sum()), "success_rate": rate,
                     "success_se": se(rate, int(m.sum())),
                     "mean_return": float(tr.ret[m].mean()) if m.any() else float("nan"),
                     "mean_end_step": float(tr.end[m].mean()) if m.any() else float("nan")}
    out["jax_only_success"] = a = int((both & jax_t.succ & ~port_t.succ).sum())
    out["port_only_success"] = b = int((both & port_t.succ & ~jax_t.succ).sum())
    out["z"] = (a - b) / max(np.sqrt(a + b), 1.0)
    out["same_end_step"] = int((both & (jax_t.end == port_t.end)).sum())
    out["same_outcome"] = int((both & (jax_t.succ == port_t.succ)).sum())
    return out


def _port(args, device):
    """The port's wrapper, network and params for the run's arguments."""
    from mqe_tpu_torch.envs.registry import make_mqe_env
    from mqe_tpu_torch.learn.networks import ActorCritic, RecurrentActorCritic
    from mqe_tpu_torch.utils.checkpoint import params_from_checkpoint

    wrap, _ = make_mqe_env(args.task, num_envs=args.num_envs, seed=args.seed, device=device)
    net = (RecurrentActorCritic if args.recurrent else ActorCritic)(
        wrap.obs_dim, wrap.action_dim).to(device)
    path = args.checkpoint if os.path.isabs(args.checkpoint) else os.path.join(REPO, args.checkpoint)
    return wrap, net, params_from_checkpoint(path, net)


def _own_reset(wrap, seed, device):
    import torch

    from mqe_tpu_torch.utils.random import Draws

    return wrap.reset(Draws(torch.Generator(device=device).manual_seed(seed)))[0]


def lockstep(args):
    import jax
    import jax.numpy as jnp
    import torch
    from torch.func import functional_call

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)

    from mqe_tpu.envs import make_mqe_env as make_jax_env
    from mqe_tpu.learn.networks import ActorCritic as JaxAC
    from mqe_tpu.learn.networks import RecurrentActorCritic as JaxRAC
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer
    from mqe_tpu.utils.checkpoint import restore_pytree
    from mqe_tpu_torch.utils.convert import env_state_from_numpy

    E, port = args.num_envs, not args.jax_only
    jwrap, _ = make_jax_env(args.task, num_envs=E, seed=args.seed)
    twrap, tnet, tparams = _port(args, "cpu")
    for f in ("height", "boxes", "env_origins", "agent_origins"):
        np.testing.assert_array_equal(np.asarray(getattr(twrap.env.build, f)),
                                      np.asarray(getattr(jwrap.env.build, f)), err_msg=f)
    A = twrap.controlled_agents

    jnet = (JaxRAC if args.recurrent else JaxAC)(action_dim=jwrap.action_dim)
    tr = PPOTrainer(jwrap, PPOConfig(recurrent=args.recurrent), seed=args.seed)
    jparams = restore_pytree(args.checkpoint, tr.init_state()).params

    @jax.jit
    def jact(params, obs, h):
        out = jnet.apply(params, obs, h) if args.recurrent else jnet.apply(params, obs)
        return jwrap.rl_prescale(out[0]), (out[3] if args.recurrent else h)

    @torch.no_grad()
    def tact(obs, h):
        out = functional_call(tnet, tparams, (obs, h) if args.recurrent else (obs,))
        return twrap.rl_prescale(out[0]), (out[3] if args.recurrent else h)

    key = jax.random.PRNGKey(args.seed)
    jts, jobs = jwrap.reset(key)
    start = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jts)[0]:
        names = [str(getattr(k, "name", getattr(k, "key", k))) for k in path]
        start["/".join(["start"] + names)] = np.asarray(leaf)
    stats = reset_stats(jts, _own_reset(twrap, args.seed, "cpu"))
    tts = env_state_from_numpy(jts, device="cpu")
    tobs = torch.as_tensor(np.array(jobs))
    jh = jnet.initial_state((E, A)) if args.recurrent else None
    th = tnet.initial_state((E, A), device="cpu") if args.recurrent else None

    jax_t, port_t = Tracker(E), Tracker(E)
    open_ = np.ones(E, bool)  # still in the first episode, in both packages
    cross = np.full((len(THRESHOLDS), E), -1)
    jump = np.full(E, -1)  # first step an observation differs by more than pi
    max_pos_diff = []
    T = jwrap.env.max_episode_length
    steps = 0
    for t in range(T):
        key, k, _ = jax.random.split(key, 3)
        jaction, jh = jact(jparams, jobs, jh)
        jts, jobs, jrew, jdone, jinfo = jwrap.step(jts, jaction, k)
        steps = t + 1
        jax_t.add(t, np.asarray(jrew), np.asarray(jdone), jinfo)
        if args.recurrent:
            jh = jnp.where(jnp.asarray(jdone)[:, None, None], 0.0, jh)
        if not port:
            if jax_t.finished():
                break
            continue
        taction, th = tact(tobs, th)
        tts, tobs, trew, tdone, tinfo = twrap.step(tts, taction)
        port_t.add(t, trew.numpy(), tdone.numpy(), tinfo)
        open_ &= (jax_t.end < 0) & (port_t.end < 0)  # a reset's state is not compared
        jpos, tpos = np.asarray(jts.env.phys.agents.pos), tts.env.phys.agents.pos.numpy()
        diff = np.abs(jpos - tpos).reshape(E, -1).max(axis=1)
        max_pos_diff.append(float(diff[open_].max()) if open_.any() else 0.0)
        odiff = np.abs(np.asarray(jobs) - tobs.numpy()).reshape(E, -1).max(axis=1)
        jump[open_ & (jump < 0) & (odiff > np.pi)] = t
        for i, thr in enumerate(THRESHOLDS):
            cross[i][open_ & (cross[i] < 0) & (diff > thr)] = t
        if args.recurrent:
            th = torch.where(tdone[:, None, None], 0.0, th)
        if jax_t.finished() and port_t.finished():
            break
        if t % 50 == 0:
            print(f"step {t}: open {int(open_.sum())}, max pos diff {max_pos_diff[-1]:.3e}",
                  flush=True)

    out = {k: getattr(args, k) for k in RUN_ARGS}
    if args.save:
        rec = dict(start)
        rec["args"] = np.array(json.dumps({k: getattr(args, k) for k in RUN_ARGS}))
        for name, tr_ in (("jax", jax_t), ("port_cpu", port_t))[:1 + port]:
            rec.update({f"{name}/end": tr_.end, f"{name}/succ": tr_.succ, f"{name}/ret": tr_.ret})
        np.savez_compressed(args.save, **rec)
    if not port:
        out.update(mode="JAX alone, CPU", steps=steps, jax=compare(jax_t, jax_t)["jax"])
        return out
    out.update(mode="lockstep, CPU", steps=steps, **compare(jax_t, port_t))
    out["pos_diff_first_step_past"] = {
        f"{thr:g}": {"envs": int((cross[i] >= 0).sum()),
                     "median_step": float(np.median(cross[i][cross[i] >= 0]))
                     if (cross[i] >= 0).any() else None}
        for i, thr in enumerate(THRESHOLDS)}
    out["obs_jump_past_pi"] = {"envs": int((jump >= 0).sum()),
                               "median_step": float(np.median(jump[jump >= 0]))
                               if (jump >= 0).any() else None}
    out["max_pos_diff_every_25_steps"] = max_pos_diff[::25]
    out["reset_stats"] = stats
    return out


def replay_one(path, device):
    """The port alone from a saved run's start, on `device` -> (summary,
    JAX's Tracker, the port's)."""
    import torch
    from torch.func import functional_call

    from mqe_tpu_torch.utils.convert import env_state_from_numpy

    with np.load(path) as data:
        run = SimpleNamespace(**json.loads(str(data["args"])))
        jts = _tree(data, "start")
        saved = {}
        for name in ("jax", "port_cpu"):
            if f"{name}/end" in data.files:
                saved[name] = Tracker(run.num_envs)
                saved[name].end, saved[name].succ, saved[name].ret = (
                    data[f"{name}/{f}"] for f in ("end", "succ", "ret"))
    wrap, net, params = _port(run, device)
    E, A = run.num_envs, wrap.controlled_agents
    stats = reset_stats(jts, _own_reset(wrap, run.seed, device))
    ts = env_state_from_numpy(jts, device=device)
    obs = wrap.observe(ts)
    h = net.initial_state((E, A), device=device) if run.recurrent else None
    port_t = Tracker(E)
    T = wrap.env.max_episode_length
    steps = 0
    with torch.no_grad():
        for t in range(T):
            out = functional_call(net, params, (obs, h) if run.recurrent else (obs,))
            ts, obs, rew, done, info = wrap.step(ts, wrap.rl_prescale(out[0]))
            steps = t + 1
            port_t.add(t, rew.cpu().numpy(), done.cpu().numpy(),
                       {k: v.cpu() for k, v in info.items() if k == "ep_success"})
            if run.recurrent:
                h = torch.where(done[:, None, None], 0.0, out[3])
            if port_t.finished():
                break
    out = {k: getattr(run, k) for k in RUN_ARGS}
    out.update(mode=f"replay on {device}", steps=steps, **compare(saved["jax"], port_t))
    if "port_cpu" in saved:
        out["port_cpu_lockstep"] = compare(saved["jax"], saved["port_cpu"])["port"]
        out["this_vs_port_cpu"] = compare(saved["port_cpu"], port_t)
    out["reset_stats_max_abs_z"] = max(max(abs(z) for z in v["z"]) for v in stats.values())
    return out, saved["jax"], port_t


def replay(args):
    """The port alone from each saved file, and the files pooled."""
    from mqe_tpu_torch import default_device

    device = "cpu" if args.cpu else default_device()
    runs, jax_all, port_all = [], [], []
    for path in args.replay:
        out, jax_t, port_t = replay_one(path, device)
        print(json.dumps(out), flush=True)
        runs.append(out)
        jax_all.append(jax_t)
        port_all.append(port_t)

    def cat(trackers):
        t = Tracker(0)
        t.end, t.succ, t.ret = (np.concatenate([getattr(x, f) for x in trackers])
                                for f in ("end", "succ", "ret"))
        return t

    pooled = compare(cat(jax_all), cat(port_all))
    pooled["seeds"] = [r["seed"] for r in runs]
    return {"runs": runs, "pooled": pooled}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="go1gate")
    p.add_argument("--checkpoint", default="checkpoints/rec/go1gate_ppo_best.npz")
    p.add_argument("--recurrent", action="store_true")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=4, help="torch's CPU threads (lockstep)")
    p.add_argument("--save", default=None, help="lockstep: write the start and results here")
    p.add_argument("--jax-only", action="store_true",
                   help="lockstep without the port: JAX's start and results for --save")
    p.add_argument("--replay", nargs="+", default=None,
                   help="run the port alone from these saved files")
    p.add_argument("--cpu", action="store_true", help="replay on the CPU (default: the card)")
    p.add_argument("--json", default=None, help="write the summary here")
    args = p.parse_args(argv)
    out = replay(args) if args.replay else lockstep(args)
    print(json.dumps(out, indent=1))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
