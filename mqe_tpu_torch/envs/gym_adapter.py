"""Stateful gym-style adapter over the task wrappers, PyTorch.

Counterpart of `mqe_tpu/envs/gym_adapter.py` (ref openrl_ws/utils.py:40-155):
`GymAdapter` is the framework boundary with numpy in and out and the done
flag broadcast per agent, `SingleAgentAdapter` folds the agents into the env
batch, and actions take the reference's 0.5 pre-scale. Use it to plug
external trainers or scripts that expect the classic gym API; training in
this package (learn/) stays on tensors. The draws of every reset and step
come from a `torch.Generator` seeded with `seed`.
"""
from __future__ import annotations

import numpy as np
import torch

from mqe_tpu_torch.utils.random import Draws


class GymAdapter:
    """reset() -> obs; step(actions) -> (obs, rew, done, info). numpy arrays.

    obs: (E, A, obs_dim); actions in [-1, 1]^(E, A, 3); done broadcast per
    agent (E, A) like the reference (ref openrl_ws/utils.py:63-74).
    """

    def __init__(self, wrapper, seed: int = 0, action_prescale: float = 0.5):
        self.w = wrapper
        self.action_prescale = action_prescale
        self.generator = torch.Generator(device=wrapper.device).manual_seed(seed)
        self._ts = None
        self.agent_num = wrapper.controlled_agents
        self.parallel_env_num = wrapper.num_envs
        self.observation_shape = (wrapper.num_envs, self.agent_num, wrapper.obs_dim)

    def reset(self):
        self._ts, obs = self.w.reset(Draws(self.generator))
        return obs.cpu().numpy()

    def step(self, actions):
        a = torch.as_tensor(np.asarray(actions, dtype=np.float32), device=self.w.device)
        self._ts, obs, rew, done, info = self.w.step(self._ts, a * self.action_prescale,
                                                     Draws(self.generator))
        rew = rew.cpu().numpy()
        done_b = np.broadcast_to(done.cpu().numpy()[:, None], rew.shape)
        host_info = {
            "time_outs": info["time_outs"].cpu().numpy(),
            # batch totals, mirroring the reference's drained reward_buffer sums
            "reward_terms": {k: float(v.sum()) for k, v in info["reward_terms"].items()},
        }
        return obs.cpu().numpy(), rew, done_b.copy(), host_info


class SingleAgentAdapter(GymAdapter):
    """Folds the agent axis into the env batch for single-agent trainers
    (ref SingleAgentWrapper openrl_ws/utils.py:131-155)."""

    def __init__(self, wrapper, seed: int = 0, reward_scale: float = 1.0):
        super().__init__(wrapper, seed)
        self.reward_scale = reward_scale
        self.parallel_env_num = wrapper.num_envs * self.agent_num
        self.agent_num = 1

    def reset(self):
        obs = super().reset()
        return obs.reshape(self.parallel_env_num, 1, -1)

    def step(self, actions):
        E, A = self.w.num_envs, self.w.controlled_agents
        obs, rew, done, info = super().step(np.asarray(actions).reshape(E, A, -1))
        return (
            obs.reshape(self.parallel_env_num, 1, -1),
            rew.reshape(self.parallel_env_num, 1) * self.reward_scale,
            done.reshape(self.parallel_env_num, 1),
            info,
        )
