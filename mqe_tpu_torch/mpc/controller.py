"""Receding-horizon command MPC over the vectorized env, PyTorch.

Counterpart of `mqe_tpu/mpc/controller.py`. CommandMPC plans a horizon of
(vx, vy, yaw-rate) commands per agent with batched multi-agent iLQR (one
joint solve per env, all envs in one batch) and executes the first knot
for `steps_per_knot` env steps (`Go1Env.step`), warm-starting the next solve
with the shifted plan.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mqe_tpu_torch.mpc import costs as task_costs
from mqe_tpu_torch.mpc.command_model import CommandModel, joint_dynamics
from mqe_tpu_torch.mpc.ilqr import ILQRConfig, make_ilqr
from mqe_tpu_torch.ops import quat as quat_ops
from mqe_tpu_torch.utils.random import Draws


@dataclass
class MPCState:
    """Warm-start plan carried across control steps."""

    us: torch.Tensor  # (E, H, A*3) previous solution, shifted


def planner_state(env, state):
    """EnvState -> (E, A, 6) planner state in env-local coordinates:
    (px, py, yaw, vx, vy, wz) with vx/vy in the yaw frame.

    Origins follow state.terrain_levels when the runtime terrain curriculum
    is on (env._origins_for gathers the level's rows; static otherwise).
    """
    ag = state.phys.agents
    env_origins, _ = env._origins_for(state.terrain_levels)
    pos = ag.pos - env_origins[:, None, :]
    v = quat_ops.quat_rotate_inverse(quat_ops.yaw_quat(ag.quat), ag.lin_vel)
    _, _, yaw = quat_ops.get_euler_xyz(ag.quat)
    return torch.cat([pos[..., :2], yaw[..., None], v[..., :2], ag.ang_vel[..., 2:3]], dim=-1)


class CommandMPC:
    """Batched multi-agent command-space MPC for one task.

    task: 'waypoint' | 'gate' | 'pushbox'. args for each solve are built
    from the env's terrain oracle (env_info) or given targets.
    """

    def __init__(
        self,
        env,
        task: str = "waypoint",
        model: CommandModel | None = None,
        ilqr_cfg: ILQRConfig | None = None,
        weights: task_costs.CostWeights | None = None,
    ):
        env = env.env if hasattr(env, "env") else env
        self.env = env
        A = env.num_agents
        self.model = model or CommandModel(dt=0.1, num_agents=A)
        assert self.model.num_agents == A
        self.cfg = ilqr_cfg or ILQRConfig(horizon=20, n_iters=8)
        if self.cfg.u_min == -1.0 and self.cfg.u_max == 1.0:
            # default to the RL action envelope per channel (wrapper
            # ACTION_SCALE [2, .5, .5] x the 0.5 RL prescale, env clip at 1):
            # full forward authority, half lateral/yaw — commands outside
            # this envelope destabilize the gait
            env_lim = tuple([1.0, 0.5, 0.5] * A)
            self.cfg = ILQRConfig(
                horizon=self.cfg.horizon, n_iters=self.cfg.n_iters,
                reg_init=self.cfg.reg_init, reg_min=self.cfg.reg_min,
                reg_max=self.cfg.reg_max, alphas=self.cfg.alphas,
                u_min=tuple(-v for v in env_lim), u_max=env_lim,
            )
        w = weights or task_costs.CostWeights()
        self.task = task
        if task == "waypoint":
            stage, final = task_costs.waypoint_cost(A, w)
        elif task == "gate":
            stage, final = task_costs.gate_cost(A, w)
        elif task == "pushbox":
            stage, final = task_costs.pushbox_cost(A, w)
        else:
            raise ValueError(f"unknown MPC task: {task}")
        self.solve = make_ilqr(joint_dynamics(self.model), stage, final, self.cfg)
        # env control steps per planner knot (execute the first knot only)
        self.steps_per_knot = max(int(round(self.model.dt / env.dt)), 1)

    # ------------------------------------------------------------------
    def init_mpc_state(self) -> MPCState:
        E, H = self.env.num_envs, self.cfg.horizon
        return MPCState(us=torch.zeros((E, H, self.model.nu), device=self.env.device))

    def default_args(self, state):
        """Per-env cost args from the terrain oracle / env geometry."""
        env = self.env
        E, A, dev = env.num_envs, env.num_agents, env.device
        if self.task == "gate":
            bt = env.cfg.terrain.BarrierTrack_kwargs
            gate_x = bt["init"]["block_length"] + bt["gate"]["block_length"] / 2
            # the level's oracle rows under the runtime terrain curriculum
            # (static env_info would go stale as terrain_levels move)
            dev_xy = (
                env.grid_env_info["gate_deviation"][
                    state.terrain_levels.to(torch.int64), env.env_cols_j]
                if env.curriculum else env.env_info["gate_deviation"]
            )  # (E, 2)
            gate = torch.stack([dev_xy[:, 0] + gate_x, dev_xy[:, 1]], dim=-1)
            goal_x = torch.full(
                (E,),
                bt["init"]["block_length"] + bt["gate"]["block_length"]
                + bt["plane"]["block_length"] / 2,
                device=dev,
            )
            return {"gate": gate, "goal_x": goal_x}
        if self.task == "pushbox":
            env_origins, _ = env._origins_for(state.terrain_levels)
            box = state.phys.npcs.pos[:, 0, :2] - env_origins[:, :2]
            push_dir = torch.tensor([1.0, 0.0], device=dev).expand(E, 2)
            return {"box": box, "push_dir": push_dir}
        # waypoint: 3 m straight ahead of each agent's current position
        x = planner_state(env, state)
        ahead = torch.tensor([3.0, 0.0], device=dev).expand(E, A, 2)
        return {"targets": x[..., :2] + ahead}

    # ------------------------------------------------------------------
    def plan_step(self, state, mpc: MPCState, draws: Draws | None = None, args=None):
        """One planner cycle: solve, apply the first knot for
        steps_per_knot env steps (with `draws`, else the env's own), shift
        the plan. Returns (state, mpc, done, cost)."""
        env = self.env
        E, A = env.num_envs, env.num_agents
        if args is None:
            args = self.default_args(state)
        x0 = planner_state(env, state).reshape(E, -1)
        sol = self.solve(x0, mpc.us, args)
        u0 = sol.us[:, 0].reshape(E, A, 3)
        done = torch.zeros(E, dtype=torch.bool, device=env.device)
        for _ in range(self.steps_per_knot):
            state, _, done, _ = env.step(state, u0, draws or env.draws())
        # warm start: shift one knot, repeat the last
        us_next = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
        return state, MPCState(us=us_next), done, sol.cost

    # ------------------------------------------------------------------
    def run(self, n_cycles: int = 50, seed: int = 0, verbose: bool = False):
        """Closed-loop MPC rollout from a reset drawn with `seed`. Returns
        (state, mean final x)."""
        env = self.env
        gen = torch.Generator(device=env.device).manual_seed(seed)
        state, _ = env.reset(Draws(gen))
        mpc = self.init_mpc_state()
        args = self.default_args(state)
        for i in range(n_cycles):
            state, mpc, done, cost = self.plan_step(state, mpc, Draws(gen), args)
            if verbose and (i % 10 == 0 or i == n_cycles - 1):
                x = planner_state(env, state)
                print(f"cycle {i:3d}  mean x={float(x[..., 0].mean()):.3f} m  "
                      f"cost={float(cost.mean()):.2f}")
        x = planner_state(env, state)
        return state, float(x[..., 0].mean())
