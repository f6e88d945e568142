"""Training CLI (ref openrl_ws/train.py), the port's counterpart of
`mqe_tpu/learn/train.py`, with the same flags:

  python -m mqe_tpu_torch.learn.train --task go1gate --algo ppo --num-envs 4096 \
      --train-timesteps 40000000 --checkpoint-dir ./checkpoints [--recurrent] [--cpu]

Algorithms: ppo, jrpo, dppo, mat, sppo (OpenRL's simple PPO, the same as
shared-parameter ppo here). It runs on the card unless `--cpu` is passed.
Checkpoints are this package's `.npz` snapshots of the whole TrainState
(params, Adam state, env state, generator, counters), saved every
`--checkpoint-every` updates; `--resume` continues such a run where it left
off, or starts from the params and Adam state of a JAX package TrainState
file. `--updates-per-call` runs that many updates between logs' checks;
`--split` is accepted and runs the same update (learn/ppo.py).

Logging sinks: JSON lines (stdout and `--log-file`), TensorBoard
(`--use-tensorboard`) and wandb (`--use-wandb`), each imported only when asked
for: a missing package raises. `--profile-dir` writes a torch.profiler trace.
Per-term episode means (the reference's extras["episode"]) are in every
record.
"""
from __future__ import annotations

import argparse
import json
import os

from mqe_tpu_torch import default_device


def gait_cfg(gait):
    """custom_cfg for make_mqe_env that overrides the default command's gait
    (None: no override)."""
    if not gait:
        return None

    def custom_cfg(cfg, _g=gait):
        class Cfg(cfg):
            class control(cfg.control):
                class default_command(cfg.control.default_command):
                    pass
        Cfg.control.default_command.gait = _g
        return Cfg

    return custom_cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="go1gate")
    p.add_argument("--algo", default="ppo", choices=["ppo", "jrpo", "dppo", "mat", "sppo"])
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--train-timesteps", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=7e-4)
    p.add_argument("--ent-coef", type=float, default=0.0,
                   help="entropy bonus (default matches the reference's ppo.yaml)")
    p.add_argument("--recurrent", action="store_true",
                   help="GRU policy (ref ppo.yaml use_recurrent_policy: true)")
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--gait", default=None,
                   choices=[None, "trotting", "pacing", "bounding", "pronking"],
                   help="override the task's default-command gait")
    p.add_argument("--selfplay", action="store_true",
                   help="competitive tasks: per-seat zero-sum reward for shared-policy self-play")
    p.add_argument("--selfplay-punishment", type=float, default=None,
                   help="override the own-fall penalty scale in self-play")
    p.add_argument("--cmd-warmup", type=int, default=0,
                   help="open the vx command envelope linearly over the first N updates; 0 = off")
    p.add_argument("--checkpoint-dir", default="./checkpoints")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="save the full TrainState every N update calls (0 = end only)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--log-file", default=None)
    p.add_argument("--use-tensorboard", action="store_true")
    p.add_argument("--tb-dir", default="./tb")
    p.add_argument("--use-wandb", action="store_true")
    p.add_argument("--wandb-project", default="mqe_tpu")
    p.add_argument("--resume", default=None,
                   help="checkpoint path: this package's full TrainState, or a JAX "
                        "package TrainState file (params and Adam state)")
    p.add_argument("--profile-dir", default=None, help="write a torch.profiler trace here")
    p.add_argument("--updates-per-call", type=int, default=1,
                   help="updates per training-loop call (metrics averaged over them)")
    p.add_argument("--split", action="store_true",
                   help="accepted for the JAX CLI's sake; the same update runs")
    p.add_argument("--log-every", type=int, default=10,
                   help="emit a log record every N update calls")
    args = p.parse_args(argv)

    from mqe_tpu_torch.envs.registry import make_mqe_env
    from mqe_tpu_torch.learn.ppo import PPOConfig, PPOTrainer
    from mqe_tpu_torch.utils.metrics import Throughput

    device = "cpu" if args.cpu else default_device()
    wrap, _ = make_mqe_env(args.task, num_envs=args.num_envs, seed=args.seed,
                           custom_cfg=gait_cfg(args.gait), device=device)
    if args.selfplay:
        wrap.selfplay = True
        wrap.selfplay_punishment = args.selfplay_punishment
    algo = "ppo" if args.algo == "sppo" else args.algo
    pcfg = PPOConfig(algo=algo, lr=args.lr, rollout_len=args.rollout_len,
                     ent_coef=args.ent_coef, cmd_warmup_updates=args.cmd_warmup,
                     recurrent=args.recurrent and args.algo != "mat")
    if args.algo == "mat":
        from mqe_tpu_torch.learn.mat import MATTrainer

        trainer = MATTrainer(wrap, pcfg, seed=args.seed)
    else:
        trainer = PPOTrainer(wrap, pcfg, seed=args.seed)
    print(f"task={args.task} algo={args.algo} envs={trainer.E} agents={trainer.A} "
          f"obs_dim={trainer.obs_dim} device={device}", flush=True)

    tb = None
    if args.use_tensorboard:
        from torch.utils.tensorboard import SummaryWriter

        tb = SummaryWriter(os.path.join(args.tb_dir, f"{args.task}_{args.algo}"))
    wb = None
    if args.use_wandb:
        import wandb as wb

        wb.init(project=args.wandb_project, config=vars(args))

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    ckpt_path = os.path.abspath(os.path.join(args.checkpoint_dir, f"{args.task}_{args.algo}"))
    resume_state = None
    if args.resume:
        resume_state = trainer.restore_checkpoint(args.resume)
        print(f"resumed from {args.resume} (update {resume_state.update_count})", flush=True)

    logf = open(args.log_file, "a") if args.log_file else None
    try:
        def cb(m):
            line = json.dumps({"task": args.task, "algo": args.algo, **m})
            print(line, flush=True)
            if logf:
                logf.write(line + "\n")
                logf.flush()
            if tb is not None:
                for k, v in m.items():
                    if isinstance(v, (int, float)) and k != "env_steps":
                        tb.add_scalar(k, v, m.get("env_steps", 0))
            if wb is not None:
                wb.log(m)

        kwargs = dict(callback=cb, resume_state=resume_state, checkpoint_path=ckpt_path,
                      checkpoint_every=args.checkpoint_every,
                      updates_per_call=args.updates_per_call, log_every=args.log_every)
        start = resume_state.update_count if resume_state is not None else 0
        throughput = Throughput()
        if args.profile_dir:
            from mqe_tpu_torch.utils.metrics import profile_trace

            with profile_trace(args.profile_dir):
                ts, _ = trainer.train(args.train_timesteps, **kwargs)
        else:
            ts, _ = trainer.train(args.train_timesteps, **kwargs)
        steps_per_update = trainer.cfg.rollout_len * trainer.E * trainer.A
        throughput.add((int(ts.update_count) - start) * steps_per_update)
    finally:
        if logf:
            logf.close()
        if tb is not None:
            tb.close()
    print(f"trained {throughput.steps} env steps in {throughput.seconds():.0f}s "
          f"({throughput.rate():.0f} steps/s)", flush=True)
    print(f"saved checkpoint to {ckpt_path}.npz", flush=True)
    return ckpt_path + ".npz"


if __name__ == "__main__":
    main()
