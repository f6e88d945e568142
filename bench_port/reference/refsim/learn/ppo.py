"""PPO-family training (ppo / jrpo / dppo) for the task wrappers, PyTorch.

Counterpart of `mqe_tpu/learn/ppo.py` (ref openrl_ws/train.py:10-74,
cfgs/*.yaml): the same hyperparameter defaults (lr 7e-4, value and advantage
normalisation) and the same algorithms:

  ppo  - independent PPO with parameters shared across agents
  jrpo - joint-reward variant: agents optimise the team-mean reward
  dppo - dual-clip PPO (lower clip c = 3)

An update is the rollout (a Python loop of `rollout_len` wrapper steps), GAE
(a reverse loop) and `ppo_epochs` epochs of `num_minibatches` minibatch steps,
all eager torch ops on the wrapper's device; the env's kernels run inside
every step. The JAX package jits the update as one program, and keeps
`update_split` (rollout and SGD as two programs) for remote compilers; eager
PyTorch has no program to split, so train.py accepts `--split` and runs the
same update.

Data parallelism over envs (`PPOTrainer(wrapper, ..., mesh=EnvMesh)`, with
`wrapper` one rank's slice from parallel/mesh.py::shard_wrapper): every rank
draws the same global "perm", and within each global minibatch computes the
loss over the rows it holds divided by the global minibatch size (the
entropy of the state-independent log_std, which belongs to no row, divided
by the rank count); the gradients are summed with `all_reduce` before
`ClipAdam`, whose clip then sees the global norm; the advantage
normalisation, the value-norm statistics and the metrics use all-reduced
sums. So the ranks' losses sum to the one-process loss and every rank takes
the same Adam step. The episode accumulator stays per rank.

Params live in the TrainState as a dict {name: tensor} in flax's leaf order,
applied to the network module with `torch.func.functional_call`. The
optimizer (`ClipAdam`) is optax's `chain(clip_by_global_norm, adam)` op for
op. Every random draw is named and goes through `utils.random.Draws` on the
TrainState's generator: "act_noise" (E, A, act) at each rollout step, the
env's own draws at each step, "perm" (n,) at each epoch. `update(ts, given)`
takes precomputed draws by name, each indexed by its rollout step or epoch
(the tests hand over the JAX package's).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from refsim.learn.networks import (ActorCritic, RecurrentActorCritic, flax_ordered_names,
                                          gaussian_logp)
from refsim.utils.metrics import EpisodeAccumulator
from refsim.utils.random import Draws


@dataclass(frozen=True)
class PPOConfig:
    algo: str = "ppo"              # ppo | jrpo | dppo
    recurrent: bool = False        # GRU policy (ref ppo.yaml use_recurrent_policy)
    lr: float = 7e-4
    rollout_len: int = 32
    num_minibatches: int = 4
    ppo_epochs: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    dual_clip: float = 3.0
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    normalize_adv: bool = True
    # running return normalisation for the critic (ref ppo.yaml
    # use_valuenorm: true): the critic regresses normalised returns and its
    # outputs are denormalised for GAE
    use_valuenorm: bool = True
    valuenorm_beta: float = 0.995
    # command-envelope warmup: open the forward-speed command linearly from
    # cmd_warmup_floor to 1.0 over the first N updates; 0 = off
    cmd_warmup_updates: int = 0
    cmd_warmup_floor: float = 0.3


@dataclass
class AdamState:
    count: torch.Tensor            # () int32
    mu: dict
    nu: dict


class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, eps=eps)) op for op:
    the gradients are scaled by max_norm / |g| only when |g| >= max_norm (no
    epsilon, unlike `torch.nn.utils.clip_grad_norm_`); eps is added outside
    the square root; the bias corrections are float32 powers of the count."""

    def __init__(self, lr: float, max_norm: float, b1=0.9, b2=0.999, eps=1e-5):
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps

    def init(self, params: dict) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()})

    def step(self, params: dict, grads: dict, state: AdamState):
        """-> (new params, new state)."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        trigger = g_norm < self.max_norm
        grads = {k: torch.where(trigger, g, (g / g_norm) * self.max_norm) for k, g in grads.items()}
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g ** 2) + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
        new = {k: p + (-self.lr) * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
               for k, p in params.items()}
        return new, AdamState(count=count, mu=mu, nu=nu)


@dataclass
class TrainState:
    params: dict                   # name -> tensor, flax leaf order
    opt_state: AdamState
    env_state: object              # the wrapper's TaskState
    generator: torch.Generator     # every draw of the rollout and the epochs
    update_count: int
    ret_mean: torch.Tensor         # running return normalisation
    ret_var: torch.Tensor
    ep_acc: EpisodeAccumulator     # per-term episode means
    rnn_h: torch.Tensor | None = None  # (E, A, H) GRU carry when recurrent


# the rollout evaluates the policy over blocks of ENV_BLOCK envs: a GEMM's
# rounding can depend on its row count (cuBLAS picks its kernel by shape),
# so with fixed blocks an env's actions do not depend on how many envs the
# process holds, and a sharded rollout is the unsharded one bit for bit
# when every rank holds a multiple of ENV_BLOCK envs (up to 4 ranks of 4096
# envs); each block is a few more launches a policy pass
ENV_BLOCK = 1024


class EnvBlocks(nn.Module):
    """`net` applied over blocks of ENV_BLOCK envs (its inputs lead with the
    env axis; None passes through) when the envs split into such blocks:
    one module, so that `functional_call` swaps the params once a pass."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, *args):
        E = args[0].shape[0]
        if E <= ENV_BLOCK or E % ENV_BLOCK:
            return self.net(*args)
        outs = [self.net(*(a if a is None else a[i:i + ENV_BLOCK] for a in args))
                for i in range(0, E, ENV_BLOCK)]

        def join(parts):
            first = parts[0]
            if first is None or first.ndim == 0 or first.shape[0] != ENV_BLOCK:
                return first                          # not per env: log_std
            return torch.cat(parts)

        return tuple(join([o[k] for o in outs]) for k in range(len(outs[0])))


def _given_at(given, i, names):
    """The given draws of occurrence i (a rollout step or an epoch)."""
    return {k: v[i] for k, v in (given or {}).items() if k in names}


class PPOTrainer:
    mesh = None          # parallel.mesh.EnvMesh when the env axis is split
    env_slice = None     # this rank's (start, stop, total) envs then

    def __init__(self, wrapper, config: PPOConfig = PPOConfig(), seed: int = 0, mesh=None):
        self.w = wrapper
        self.cfg = config
        self.device = wrapper.device
        self.E = wrapper.num_envs
        # the env axis split over a process group (parallel/mesh.py): the
        # wrapper holds this rank's (start, stop, total) envs
        self.mesh = mesh
        self.env_slice = getattr(getattr(wrapper, "env", None), "env_slice", None)
        if self.mesh is not None:
            sl = self.env_slice
            if sl is None or sl[2] != self.E * mesh.world or sl[0] != mesh.rank * self.E:
                raise ValueError(f"rank {mesh.rank} of {mesh.world}: the wrapper's envs "
                                 f"{sl} are not this rank's slice (parallel.mesh.shard_wrapper)")
        self.A = wrapper.controlled_agents
        self.obs_dim = wrapper.obs_dim
        self.act_dim = wrapper.action_dim
        self.seed = seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = self._make_net().to(self.device)
        own = dict(self.net.named_parameters())
        self.init_params = {n: own[n].detach() for n in flax_ordered_names(self.net)}
        if self.mesh is not None:
            # every rank starts from rank 0's params (an init factorised on
            # the CPU rounds by its thread count)
            import torch.distributed as dist

            src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
            for p in self.init_params.values():
                dist.broadcast(p, src=src, group=mesh.group)
        self.tx = ClipAdam(config.lr, config.max_grad_norm)
        # the env's reward-term names: per-task constants, found without a step
        self.term_names = tuple(sorted(self.w.reward_term_names()))

    def _make_net(self):
        if self.cfg.recurrent:
            return RecurrentActorCritic(self.obs_dim, self.act_dim)
        return ActorCritic(self.obs_dim, self.act_dim)

    def init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        env_state, _ = self.w.reset(self._draws(gen))
        params = dict(self.init_params)
        return TrainState(
            params=params, opt_state=self.tx.init(params), env_state=env_state,
            generator=gen, update_count=0,
            ret_mean=torch.zeros((), device=self.device),
            ret_var=torch.ones((), device=self.device),
            ep_acc=EpisodeAccumulator.create(self.E, self.term_names,
                                             track_success=self.w.has_success,
                                             device=self.device),
            rnn_h=(self.net.initial_state((self.E, self.A), device=self.device)
                   if self.cfg.recurrent else None),
        )

    # ------------------------------------------------------------------
    def _draws(self, generator, given=None) -> Draws:
        """The env-axis draws of this trainer (as one rank's when sharded)."""
        return Draws(generator, given, env_slice=self.env_slice)

    def _sum(self, t):
        """t summed over the ranks (t itself in one process)."""
        if self.mesh is None:
            return t
        from refsim.parallel.mesh import all_reduce_sum

        return all_reduce_sum(t, self.mesh)

    def _mean(self, x):
        """The mean of x over every rank's elements."""
        if self.mesh is None:
            return x.mean()
        return self._sum(x.sum()) / (x.numel() * self.mesh.world)

    def _var(self, x, mean):
        """The population variance of x over every rank's elements."""
        if self.mesh is None:
            return x.var(correction=0)
        return self._mean((x - mean) ** 2)

    def _forward(self, params, args, blocks=False):
        """The network under `params`; with `blocks`, over blocks of
        ENV_BLOCK envs (the rollout's passes)."""
        if not blocks:
            return functional_call(self.net, params, args)
        return functional_call(EnvBlocks(self.net), {"net." + k: v for k, v in params.items()},
                               args)

    def _apply(self, params, obs, h=None, blocks=False):
        args = (obs, h) if self.cfg.recurrent else (obs,)
        out = self._forward(params, args, blocks)
        return out if self.cfg.recurrent else (*out, None)

    def _policy(self, params, obs, draws: Draws, h=None):
        mean, log_std, value, h = self._apply(params, obs, h, blocks=True)
        noise = draws.normal("act_noise", mean.shape, mean.device)
        action = mean + torch.exp(log_std) * noise
        return action, gaussian_logp(mean, log_std, action), value, h

    def _value(self, params, obs, h=None):
        return self._apply(params, obs, h, blocks=True)[2]

    @torch.no_grad()
    def _rollout(self, ts: TrainState, given=None):
        """rollout_len steps -> (env_state, traj, final_value, ep_acc, rnn_h);
        traj holds (T, E, A, ...) stacks of obs, action, logp, value,
        reward, done (T, E) and, when recurrent, the pre-step hidden state h."""
        cfg, A = self.cfg, self.A
        warm = None
        if cfg.cmd_warmup_updates > 0:
            warm = torch.clamp(torch.tensor(ts.update_count, dtype=torch.float32)
                               / cfg.cmd_warmup_updates, cfg.cmd_warmup_floor, 1.0)
        env_state, acc, h = ts.env_state, ts.ep_acc, ts.rnn_h
        obs = self.w.observe(env_state)
        names = set(given or ()) - {"perm"}
        keys = ("obs", "action", "logp", "value", "reward", "done") + (("h",) if cfg.recurrent else ())
        traj = {k: [] for k in keys}
        for t in range(cfg.rollout_len):
            draws = self._draws(ts.generator, _given_at(given, t, names))
            action, logp, value, h_next = self._policy(ts.params, obs, draws, h)
            cmd = self.w.rl_prescale(action)
            if warm is not None:
                cmd = torch.cat([cmd[..., :1] * warm.to(cmd.device), cmd[..., 1:]], dim=-1)
            env_state, next_obs, reward, done, info = self.w.step(env_state, cmd, draws)
            acc = acc.update(reward[:, :A].mean(-1), done, info.get("reward_terms"),
                             success=info.get("ep_success"))
            if cfg.algo == "jrpo":
                reward = reward.mean(dim=-1, keepdim=True).expand_as(reward)
            step = dict(obs=obs, action=action, logp=logp, value=value,
                        reward=reward[:, :A], done=done)
            if cfg.recurrent:
                step["h"] = h  # the pre-step state, aligned with obs
                # episode boundary: new episodes start with a fresh memory
                h_next = torch.where(done[:, None, None], 0.0, h_next)
            for k in keys:
                traj[k].append(step[k])
            obs, h = next_obs, h_next
        final_value = self._value(ts.params, obs, h)
        return env_state, {k: torch.stack(v) for k, v in traj.items()}, final_value, acc, h

    def _gae(self, traj, final_value):
        cfg = self.cfg
        gae, next_value = torch.zeros_like(final_value), final_value
        advs = [None] * traj["reward"].shape[0]
        for t in reversed(range(len(advs))):
            notdone = 1.0 - traj["done"][t][:, None].to(torch.float32)
            delta = traj["reward"][t] + cfg.gamma * next_value * notdone - traj["value"][t]
            gae = delta + cfg.gamma * cfg.gae_lambda * notdone * gae
            advs[t], next_value = gae, traj["value"][t]
        advs = torch.stack(advs)
        return advs, advs + traj["value"]

    def _loss(self, params, batch, rows=None):
        cfg = self.cfg
        mean, log_std, value, _ = self._apply(params, batch["obs"], batch.get("h"))
        logp = gaussian_logp(mean, log_std, batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg = torch.minimum(surr1, surr2)
        if cfg.algo == "dppo":
            # dual clip: bound how negative the objective can get for adv < 0
            pg = torch.where(adv < 0, torch.maximum(pg, cfg.dual_clip * adv), pg)
        return self._total(pg, value, log_std, batch, rows)

    def _total(self, pg, value, log_std, batch, rows=None):
        """The loss of a minibatch. `rows`: sharded, the global minibatch's
        row count, over which this rank's rows' terms are summed; the
        entropy term, which belongs to no row, is divided by the ranks."""
        cfg = self.cfg
        entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum()
        if rows is None:
            pg_loss = -pg.mean()
            v_loss = 0.5 * ((value - batch["ret"]) ** 2).mean()
        else:
            pg_loss = -pg.sum() / (rows * math.prod(pg.shape[1:]))
            v_loss = 0.5 * ((value - batch["ret"]) ** 2).sum() / (rows * math.prod(value.shape[1:]))
            entropy = entropy / self.mesh.world
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        return loss, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=entropy)

    def _valuenorm(self, ts, traj, final_value):
        """The critic predicts normalised returns; denormalise its outputs
        with the running stats before GAE (ref ppo.yaml use_valuenorm)."""
        std = torch.sqrt(ts.ret_var + 1e-8)
        traj = dict(traj)
        traj["value"] = traj["value"] * std + ts.ret_mean
        return traj, final_value * std + ts.ret_mean

    def _valuenorm_update(self, ts, returns):
        """EMA-refresh the return stats (population variance, as jnp.var);
        returns (mean, var, normaliser)."""
        b = self.cfg.valuenorm_beta
        mean = self._mean(returns)
        new_mean = b * ts.ret_mean + (1 - b) * mean
        new_var = b * ts.ret_var + (1 - b) * self._var(returns, mean)
        return new_mean, new_var, lambda r: (r - new_mean) / torch.sqrt(new_var + 1e-8)

    def _normalize_adv(self, advs):
        """Zero mean, unit population standard deviation (as jnp.std)."""
        mean = self._mean(advs)
        return (advs - mean) / (torch.sqrt(self._var(advs, mean)) + 1e-8)

    def _local_rows(self, idx, n_local):
        """This rank's rows, in local indices, of the global row indices idx.
        Rows lie (T, E, k) in order (k rows an env-step: the agents, or 1
        for MAT's); this rank holds envs [start, stop) of the E."""
        start, stop, total = self.env_slice
        k = n_local // (self.cfg.rollout_len * self.E)
        t, rem = idx // (total * k), idx % (total * k)
        e, j = rem // k, rem % k
        mine = (e >= start) & (e < stop)
        return (t * (self.E * k) + (e - start) * k + j)[mine]

    def _batch(self, traj, advs, ret):
        """Minibatch rows (T*E*A, ...) of the controlled agents."""
        A = self.A
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[3:]))  # noqa: E731
        batch = dict(obs=flat(traj["obs"][:, :, :A]), action=flat(traj["action"][:, :, :A]),
                     logp=flat(traj["logp"][:, :, :A]), adv=flat(advs), ret=flat(ret))
        if self.cfg.recurrent:
            batch["h"] = flat(traj["h"][:, :, :A])
        return batch

    def _sgd(self, params, opt_state, batch, generator, given=None):
        """ppo_epochs epochs of num_minibatches clipped Adam steps, each epoch
        over a fresh permutation ("perm"). -> (params, opt_state, mean loss)."""
        cfg = self.cfg
        n_local = batch["adv"].shape[0]
        n = n_local * (self.mesh.world if self.mesh else 1)   # global rows
        mb = n // cfg.num_minibatches
        epoch_losses = []
        for e in range(cfg.ppo_epochs):
            perm = Draws(generator, _given_at(given, e, {"perm"})).permutation(
                "perm", n, batch["adv"].device)
            losses = []
            for i in range(cfg.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                if self.mesh is not None:
                    idx = self._local_rows(idx, n_local)
                sub = {k: v[idx] for k, v in batch.items()}
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss, _ = self._loss(leaves, sub, rows=mb if self.mesh else None)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                if self.mesh is not None:
                    grads = self._sum_grads(grads)
                params, opt_state = self.tx.step(params, dict(zip(leaves, grads)), opt_state)
                losses.append(loss.detach())
            epoch_losses.append(torch.stack(losses).mean())
        return params, opt_state, self._sum(torch.stack(epoch_losses).mean())

    def _sum_grads(self, grads):
        """The gradients summed over the ranks: one all-reduce of them all."""
        flat = self._sum(torch.cat([g.reshape(-1) for g in grads]))
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return out

    def _learn(self, ts: TrainState, rollout, given=None):
        """The update's second half, from a rollout's
        (env_state, traj, final_value, ep_acc, rnn_h) -> (ts, metrics)."""
        cfg = self.cfg
        env_state, traj, final_value, ep_acc, rnn_h = rollout
        if cfg.use_valuenorm:
            traj, final_value = self._valuenorm(ts, traj, final_value)
        advs, returns = self._gae(traj, final_value)
        if cfg.use_valuenorm:
            ret_mean, ret_var, norm = self._valuenorm_update(ts, returns)
            ret_for_loss = norm(returns)
        else:
            ret_mean, ret_var, ret_for_loss = ts.ret_mean, ts.ret_var, returns
        if cfg.normalize_adv:
            advs = self._normalize_adv(advs)
        params, opt_state, loss = self._sgd(ts.params, ts.opt_state,
                                            self._batch(traj, advs, ret_for_loss),
                                            ts.generator, given)
        metrics = dict(loss=loss, reward_mean=self._mean(traj["reward"]),
                       value_mean=self._mean(traj["value"]),
                       done_frac=self._mean(traj["done"].to(torch.float32)))
        ts = replace(ts, params=params, opt_state=opt_state, env_state=env_state,
                     update_count=ts.update_count + 1, ep_acc=ep_acc, rnn_h=rnn_h,
                     ret_mean=ret_mean, ret_var=ret_var)
        return ts, metrics

    def update(self, ts: TrainState, given=None):
        """One PPO update -> (ts, metrics of 0-d tensors). `given`: draws by
        name, each a sequence over rollout steps ("act_noise", the env's) or
        epochs ("perm")."""
        return self._learn(ts, self._rollout(ts, given), given)

    def timed_update(self, ts: TrainState):
        """One update with its rollout and its second half (GAE, SGD) timed
        apart on the host clock, the device synchronized at both ends of each
        -> (ts, metrics, rollout seconds, SGD seconds)."""
        on_card = torch.device(self.device).type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        t0 = time.perf_counter()
        rollout = self._rollout(ts)
        sync()
        t1 = time.perf_counter()
        ts, metrics = self._learn(ts, rollout)
        sync()
        return ts, metrics, t1 - t0, time.perf_counter() - t1

    def update_many(self, ts: TrainState, n: int):
        """n updates; the metrics averaged over them."""
        ms = []
        for _ in range(n):
            ts, m = self.update(ts)
            ms.append(m)
        return ts, {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    # ---- full checkpoint / resume ----
    def save_checkpoint(self, ts: TrainState, path: str):
        from refsim.utils.checkpoint import save_state

        return save_state(path, ts)

    def restore_checkpoint(self, path: str) -> TrainState:
        """A TrainState from this package's checkpoint, or params and Adam
        state from a JAX package TrainState file (its env state is the JAX
        package's layout and is not read: the env starts from a reset)."""
        from refsim.utils.checkpoint import is_port_checkpoint, restore_state
        from refsim.utils.convert import params_from_jax_checkpoint

        ts = self.init_state()
        if is_port_checkpoint(path):
            return restore_state(path, ts)
        params, (count, mu, nu) = params_from_jax_checkpoint(path, self.net, with_optimizer=True)
        return replace(ts, params=params, opt_state=AdamState(count=count, mu=mu, nu=nu))

    def train(self, total_env_steps: int, log_every: int = 10, callback=None,
              updates_per_call: int = 1,
              resume_state: TrainState | None = None,
              checkpoint_path: str | None = None, checkpoint_every: int = 0):
        ts = resume_state if resume_state is not None else self.init_state()
        steps_per_update = self.cfg.rollout_len * self.E * self.A
        n_updates = max(1, total_env_steps // steps_per_update)
        history = []
        i = ts.update_count
        calls = 0
        while i < n_updates:
            if updates_per_call > 1:
                k = min(updates_per_call, n_updates - i)
                ts, metrics = self.update_many(ts, k)
                i += k
            else:
                ts, metrics = self.update(ts)
                i += 1
            calls += 1
            if checkpoint_every and checkpoint_path and calls % checkpoint_every == 0:
                self.save_checkpoint(ts, checkpoint_path)
            if calls % log_every == 0 or i >= n_updates:
                m = {k_: float(v) for k_, v in metrics.items()}
                m["update"] = i
                m["env_steps"] = i * steps_per_update
                # per-term episode means over the episodes completed this window
                m.update(ts.ep_acc.summarize())
                ts = replace(ts, ep_acc=ts.ep_acc.reset_window())
                # best-by-episode-return snapshot: PPO can collapse after its peak
                if checkpoint_path and m.get("episodes", 0) > 0 and (
                        m["mean_episode_return"] > getattr(self, "_best_ret", -np.inf)):
                    self._best_ret = m["mean_episode_return"]
                    self.save_checkpoint(ts, checkpoint_path + "_best")
                # best-by-window-success snapshot: return and success can peak
                # at different updates
                if checkpoint_path and m.get("episodes", 0) > 0 and (
                        m.get("success_rate") is not None
                        and m["success_rate"] > getattr(self, "_best_succ", -1.0)):
                    self._best_succ = m["success_rate"]
                    self.save_checkpoint(ts, checkpoint_path + "_bestsucc")
                history.append(m)
                if callback:
                    callback(m)
                else:
                    print(f"update {i}/{n_updates} steps={m['env_steps']} "
                          f"reward={m['reward_mean']:.4f} loss={m['loss']:.4f} "
                          f"done_frac={m['done_frac']:.3f}", flush=True)
        if checkpoint_path:
            self.save_checkpoint(ts, checkpoint_path)
        return ts, history
