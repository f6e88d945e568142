"""Multi-Agent Transformer (MAT) training, PyTorch.

Counterpart of `mqe_tpu/learn/mat.py` (the MAT paper, Wen et al. 2022):

  encoder: per-agent obs embeddings -> self-attention across the agent axis
           -> per-agent representations and a value head
  decoder: autoregressive across agents; agent i's action mean attends to
           the encoded obs and the actions of agents < i (teacher forcing in
           the loss, sequential sampling in the rollout: A + 1 forward
           passes a step)

Trained with learn/ppo.py's clipped objective and GAE (no dual clip);
batches keep the agent axis. Attention is plain torch ops, as the JAX
package leaves it to XLA. flax's defaults are kept: LayerNorm eps 1e-6, the
tanh-approximate GELU, attention as `MultiHeadDotProductAttention` computes
it (the query scaled by 1/sqrt(head_dim), masked logits set to the float32
minimum), Dense kernels lecun normal and the mean head's orthogonal(0.01).
A query/key/value `DenseGeneral` (in, heads, head_dim) is here a Linear to
heads * head_dim, the out one (heads, head_dim, out) a Linear from it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from refsim.learn.networks import dense, gaussian_logp
from refsim.learn.ppo import PPOConfig, PPOTrainer

LN_EPS = 1e-6  # flax nn.LayerNorm


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        for name in ("query", "key", "value"):
            self.add_module(name, dense(dim, dim))
        self.out = dense(dim, dim)

    def forward(self, x, mask=None):
        shape = x.shape[:-1] + (self.heads, self.head_dim)
        q, k, v = (getattr(self, n)(x).reshape(shape) for n in ("query", "key", "value"))
        q = q / math.sqrt(self.head_dim)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("...hqk,...khd->...qhd", w, v)
        return self.out(out.reshape(x.shape[:-1] + (-1,)))


class SelfAttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 2):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = dense(dim, dim * 2)
        self.Dense_1 = dense(dim * 2, dim)

    def forward(self, x, mask=None):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask)
        return x + self.Dense_1(_gelu(self.Dense_0(self.LayerNorm_1(x))))


class MATNetwork(nn.Module):
    """Submodules named as flax names them in `MATNetwork.__call__`: Dense_0
    obs embedding, SelfAttnBlock_0.. encoder, Dense_2 then Dense_1 the value
    head, Dense_3 the previous-action embedding, the decoder blocks, Dense_4
    the action mean."""

    def __init__(self, obs_dim: int, action_dim: int, embed: int = 128, enc_blocks: int = 2,
                 dec_blocks: int = 2, heads: int = 2):
        super().__init__()
        self.action_dim = action_dim
        self.enc_blocks, self.dec_blocks = enc_blocks, dec_blocks
        self.Dense_0 = dense(obs_dim, embed)
        self.Dense_1 = dense(embed, 1)
        self.Dense_2 = dense(embed, embed)
        self.Dense_3 = dense(action_dim, embed)
        self.Dense_4 = dense(embed, action_dim, scale=0.01)
        for i in range(enc_blocks + dec_blocks):
            self.add_module(f"SelfAttnBlock_{i}", SelfAttnBlock(embed, heads))
        self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))

    def forward(self, obs, prev_actions):
        """obs (..., A, obs_dim); prev_actions (..., A, act), row i the action
        of agent i - 1 (row 0 zeros) -> mean (..., A, act), log_std (act,),
        value (..., A)."""
        A = obs.shape[-2]
        blocks = [getattr(self, f"SelfAttnBlock_{i}") for i in range(self.enc_blocks + self.dec_blocks)]
        e = self.Dense_0(obs)
        for blk in blocks[:self.enc_blocks]:
            e = blk(e)
        value = self.Dense_1(_gelu(self.Dense_2(e)))[..., 0]
        d = self.Dense_3(prev_actions) + e
        causal = torch.tril(torch.ones((A, A), dtype=torch.bool, device=obs.device))
        for blk in blocks[self.enc_blocks:]:
            d = blk(d, causal)
        return self.Dense_4(d), self.log_std, value


class MATTrainer(PPOTrainer):
    """PPO machinery with the MAT joint policy: batches keep the agent axis,
    actions are sampled agent by agent."""

    def __init__(self, wrapper, config: PPOConfig = PPOConfig(algo="mat"), seed: int = 0,
                 mesh=None):
        if config.recurrent:
            raise ValueError("MAT is a transformer; the recurrent policy is PPO's")
        super().__init__(wrapper, config, seed, mesh=mesh)

    def _make_net(self):
        return MATNetwork(self.obs_dim, self.act_dim)

    def _apply(self, params, obs, prev, blocks=False):
        return self._forward(params, (obs, prev), blocks)

    def _policy(self, params, obs, draws, h=None):
        """Autoregressive sampling across agents ("act_noise" (E, A, act),
        agent i takes row i); h is unused."""
        A = self.A
        prev = torch.zeros(obs.shape[:-1] + (self.act_dim,), device=obs.device)
        actions = torch.zeros_like(prev)
        noise = draws.normal("act_noise", prev.shape, obs.device)
        for i in range(A):
            mean, log_std, _ = self._apply(params, obs, prev, blocks=True)
            a_i = mean[..., i, :] + torch.exp(log_std) * noise[..., i, :]
            actions[..., i, :] = a_i
            if i + 1 < A:
                prev[..., i + 1, :] = a_i
        mean, log_std, value = self._apply(params, obs, prev, blocks=True)
        return actions, gaussian_logp(mean, log_std, actions), value, None

    def _value(self, params, obs, h=None):
        prev = torch.zeros(obs.shape[:-1] + (self.act_dim,), device=obs.device)
        return self._apply(params, obs, prev, blocks=True)[2]

    @staticmethod
    def _shift_actions(actions):
        """actions (..., A, act) -> the teacher-forcing previous-action input."""
        return F.pad(actions[..., :-1, :], (0, 0, 1, 0))

    def _loss(self, params, batch, rows=None):
        cfg = self.cfg
        mean, log_std, value = self._apply(params, batch["obs"], self._shift_actions(batch["action"]))
        logp = gaussian_logp(mean, log_std, batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        pg = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv)
        return self._total(pg, value, log_std, batch, rows)

    def _batch(self, traj, advs, ret):
        """Minibatch rows (T*E, A, ...): the agent axis kept."""
        A = self.A
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
        return dict(obs=flat(traj["obs"][:, :, :A]), action=flat(traj["action"][:, :, :A]),
                    logp=flat(traj["logp"][:, :, :A]), adv=flat(advs), ret=flat(ret))
