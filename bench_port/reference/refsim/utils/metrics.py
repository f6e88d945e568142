"""Episode metrics: device-side accumulators of the reward terms, a host
throughput counter and a profiler context.

Counterpart of `mqe_tpu/utils/metrics.py` (the reference's `extras["episode"]`
per-term episode means, ref legged_robot.py:1063-1076). Accumulation stays on
the device; `summarize` pulls host scalars.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, replace

import torch


@dataclass
class EpisodeAccumulator:
    """Per-env running episode sums, flushed into completed-episode aggregates
    at done. `acc = acc.update(reward, done, terms)` returns a new
    accumulator; `summarize()` gives the per-term mean episode sum over the
    episodes completed since the last `reset_window()`."""

    term_sums: dict                 # name -> (E,) running sums of live episodes
    ep_return: torch.Tensor         # (E,) running reward sum
    ep_len: torch.Tensor            # (E,)
    done_count: torch.Tensor        # () completed episodes in this window
    done_return_sum: torch.Tensor
    done_len_sum: torch.Tensor
    done_term_sums: dict            # name -> () flushed sums of completed episodes
    done_succ_sum: torch.Tensor     # () completed episodes that ever hit success
    track_success: bool = False

    @staticmethod
    def create(num_envs: int, term_names, track_success: bool = False, device=None):
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        return EpisodeAccumulator(
            term_sums={k: z(num_envs) for k in term_names},
            ep_return=z(num_envs), ep_len=z(num_envs),
            done_count=z(), done_return_sum=z(), done_len_sum=z(),
            done_term_sums={k: z() for k in term_names},
            done_succ_sum=z(), track_success=track_success,
        )

    def update(self, reward_env, done, term_values=None, success=None):
        """reward_env: (E,) reward this step; done: (E,) bool; term_values:
        name -> scalar or (E,) term values this step; success: (E,) bool, the
        episode's ever-succeeded flag (the wrapper's info["ep_success"]),
        flushed at done into success_rate."""
        ep_return = self.ep_return + reward_env
        ep_len = self.ep_len + 1.0
        d = done.to(torch.float32)
        acc = replace(
            self,
            ep_return=ep_return * (1 - d),
            ep_len=ep_len * (1 - d),
            done_count=self.done_count + d.sum(),
            done_return_sum=self.done_return_sum + (ep_return * d).sum(),
            done_len_sum=self.done_len_sum + (ep_len * d).sum(),
        )
        if success is not None:
            acc = replace(acc, done_succ_sum=self.done_succ_sum
                          + (success.to(torch.float32) * d).sum())
        if term_values:
            sums, flushed = dict(self.term_sums), dict(self.done_term_sums)
            for k in self.term_sums:
                if k not in term_values:
                    continue
                run = sums[k] + torch.broadcast_to(
                    torch.as_tensor(term_values[k], device=sums[k].device), sums[k].shape)
                flushed[k] = flushed[k] + (run * d).sum()
                sums[k] = run * (1 - d)
            acc = replace(acc, term_sums=sums, done_term_sums=flushed)
        return acc

    def reset_window(self):
        """Zero the completed-episode aggregates (live-episode sums persist)."""
        z = torch.zeros_like(self.done_count)
        return replace(
            self, done_count=z, done_return_sum=z.clone(), done_len_sum=z.clone(),
            done_term_sums={k: z.clone() for k in self.done_term_sums},
            done_succ_sum=z.clone(),
        )

    def summarize(self) -> dict:
        n = float(self.done_count)
        d = max(n, 1e-9)
        out = {
            "episodes": n,
            "mean_episode_return": float(self.done_return_sum) / d,
            "mean_episode_length": float(self.done_len_sum) / d,
        }
        for k, v in self.done_term_sums.items():
            out[f"rew_{k}"] = float(v) / d
        if self.track_success:
            out["success_rate"] = float(self.done_succ_sum) / d
        return out


class Throughput:
    """Wall-clock env-steps/s counter (host side)."""

    def __init__(self):
        self.t0 = time.time()
        self.steps = 0

    def add(self, n):
        self.steps += n

    def seconds(self):
        return time.time() - self.t0

    def rate(self):
        return self.steps / max(self.seconds(), 1e-9)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager: a torch.profiler trace of the host and, where there is
    a card, the device, written to `log_dir/trace.json` (Chrome trace format,
    viewable in Perfetto) when the context exits."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
