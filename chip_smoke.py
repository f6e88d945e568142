"""Smoke run of the PyTorch/CUDA port (mqe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. device  - the card's name and power limit;
  2. build   - nvcc builds csrc/fused_step.cu (all three entry points) into
               build/mqe_tpu_torch/, with ptxas' registers, stack and spills
               of each kernel (the step kernel must have no stack or spills);
  3. kernel  - the CUDA substep kernel against its plain PyTorch version
               (physics/soa.py::step_actor) on the card at the tolerances of
               tests/test_pallas_step.py: go1 at each B of the robots'
               launches of the slices (`ROBOT_B`: 4096 for locomotion
               training's one robot, 8192, 12,288, 16,384) and at 37, two
               small NPC cases, and every NPC launch of the slices at its
               shape
               (`NPC_LAUNCHES`: box, seesaw, ball, cylinder, revolving door,
               door at B = 4096, the sheep at 4096 and 36,864); then its
               device time per launch at each of those shapes
               (`device_ms`: a CUDA graph of 200 launches), beside the plain version's time and the
               bound of the card;
  4. fk      - the sphere-FK kernel against soa.fk_spheres at the slices'
               shapes, go1 at each B of `ROBOT_B`, and at B = 37 and 1 (and two NPC
               models at 37 and 1), at the tolerance of
               tests/test_torch_soa.py::test_fk_matches_jax; its time and
               bound likewise, and its floor: the device time at B = 1;
  5. fk_full - the full-FK kernel against soa.fk_full for every NPC launch
               of the slices at its shape, and for the box and the seesaw
               also at 4095, 37 and 1 (the ball at 37 and 1), at the same
               tolerance; its time and bound at each launch's shape, and the
               B = 1 floor for the box and the seesaw;
  6. check   - one control step at 2 envs of each of the 14 tasks on the card
               (kernels) and on the CPU (plain versions) from the same state,
               with the same draws, compared, NPCs included; and go1wrestling
               from the generator's second reset draw, measured and printed
               (not held to CHECK_TOLS: float32 noise the ring contact
               amplifies, PERF.md §6);
  7. slice   - every task but go1plane at 4096 envs through make_mqe_env ->
               reset -> step: 1 warm step and the timed steps of `SLICES`.
               Every kernel's count is set to 0 just before a task's run and
               read just after: a task without a colliding NPC (go1gate,
               go1wrestling, go1bridge) launches the step kernel and the
               sphere FK 8 times a step; an NPC task launches the step kernel
               16 times (robots, then NPCs), the sphere FK 8 and the full FK 8.
  8. train   - task training on the card (learn/): go1gate at SLICE_ENVS
               envs with PPOConfig's defaults (T = 32, 4 minibatches, 4
               epochs): `TRAIN_RUNS` (3 updates of the MLP policy's PPO, 1 of
               the GRU policy's, 1 of MAT), each update's rollout and SGD
               timed apart (`update` is `_learn(ts, _rollout(ts))`), env-steps
               a second counted as T*E*A (the JAX package's count) and T*E; a
               finite loss, params that moved, and every kernel's count set
               to 0 before an update and read after it: 8*T launches of the
               step kernel and of the sphere FK, none of the full FK. Then one
               SGD phase (16 minibatch steps) from a batch drawn with numpy,
               with the same permutations, on the card and on the CPU (TF32
               off), params compared at 1e-5; and `learn.evaluate` on the card
               with the two committed JAX checkpoints of `EVAL_CHECKPOINTS` at
               4 envs for one episode, mean return and success rate printed.
  9. locomotion - locomotion training and the `policy` backend: one step
               card vs CPU with the same draws, at `CHECK_TOLS`, of
               LocomotionEnv (residual, action lag on) and of go1plane with
               the `policy` backend, with the body policy of
               assets/body_policy.npz and with the walk-these-ways stack
               (assets without that file, a body MLP drawn from a seed);
               `LOCO_UPDATES` PPO updates of train_locomotion's
               configuration at LOCO_ENVS envs (T = 32), each update's
               rollout and SGD timed apart and its launches asserted (8*T of
               the step kernel and of the sphere FK, none of the full FK);
               then `learn.train_locomotion.main` for one update into a
               temporary directory, its npz read back with
               `load_body_policy` and compared with the trained actor; and a
               few GymAdapter / SingleAgentAdapter steps on go1gate.
 10. curriculum - the runtime terrain curriculum on a Legacy heightfield
               (`CurrCfg`: LegacyTerrainBuilder's 10 rows x 20 columns of 8 m
               tiles at 0.025 m cells, a 3280 x 6480 table on the card), one
               robot an env, the depth camera on (the heightfield march):
               one step card vs CPU at 4 envs on level 0 with the same draws
               (the state at CHECK_TOLS, the levels equal, the depth images
               at DEPTH_TOL); then at SLICE_ENVS envs a build, a reset, 1
               warm and CURR_STEPS timed steps, and a step with the robots
               moved past curr_up_dist and every episode at its end: the
               levels rise (a random level past the last). 8 launches of the
               step kernel and of the sphere FK a step.
 11. camera  - the onboard depth and RGB camera: the images of go1gate and
               go1sheep-easy (the NPC impostors) card vs CPU at 2 envs from
               the same state (DEPTH_TOL, RGB_TOL); at SLICE_ENVS envs go1gate
               (8192 cameras of 256 rays) with 1 warm and 20 timed steps and
               go1sheep-easy with 5, each beside the same task without the
               camera timed in this process; the launches a step as in
               `slice`.
 12. mpc     - the command-space MPC: `fit_command_model` on go1gate at
               SLICE_ENVS envs (80 steps, as `run_mpc --fit`); CommandMPC
               (task "gate", H = 20, 8 iterations) with that model, 1 warm
               and MPC_CYCLES timed cycles of 5 env steps: ms a cycle, ms a
               solve (MPC_SOLVES solves timed alone), solves/s, and the mean
               x progress, which must pass 0.1 m; go1pushbox (task
               "pushbox") for 5 cycles; one solve card vs CPU at 2 envs from
               the same x0, warm start and args (cost at MPC_COST_REL); and
               `run_mpc.main` at SLICE_ENVS envs for 5 cycles. The launches a
               step as in `slice`, the solves launching none.
 13. aos     - the AoS reference path (`use_soa=False`: scene.substep's
               per-tree 6x6 dynamics, no kernel) at SLICE_ENVS envs
               against the default path (the kernels), resynced each step
               as tests/test_soa_episode.py does (`AOS_TASKS`: go1gate 5
               steps, go1pushbox and go1seesaw 2): the worst difference per
               quantity printed beside CHECK_TOLS (measured: the JAX
               package's own SoA-vs-AoS drop fails that bound on the CPU),
               the kernels' counts 0 over every AoS step (asserted), the
               ms and CUDA kernels of an AoS step and of a default one;
               then an AoS step card vs CPU at 2 envs of each of the three
               tasks, held to CHECK_TOLS, no kernel launched.
 14. mesh    - the env axis split over 2 ranks of
               `python -m mqe_tpu_torch.parallel.worker` on the one card
               (gloo over CUDA tensors; each rank killed after RANK_TIMEOUT
               s): go1gate at SLICE_ENVS global envs, MESH_STEPS steps
               gathered and held to the unsharded run in this process (obs
               and reward at 1e-4, dones equal, the end state at
               CHECK_TOLS), each rank's launches equal to the unsharded
               run's (each launch over half the robots); one PPO update
               (PPOConfig's defaults) held at SGD_TOL to this process's
               update of the same rollout summed in the ranks' order
               (`ranks_order_update`), its distance from the update summed
               in one process's order printed beside that order's own
               effect; then a one-rank NCCL group's update (gradients
               all-reduced through NCCL) at SGD_TOL.
 15. goldens - every step of the JAX package's drop golden (60 steps of
               go1plane's robot released 0.62 m up, 2 envs) taken once on the
               card from the golden's own scan state before it
               (tests/goldens/torch_golden_steps.npz), held to the scan's
               state after it within CHECK_TOLS, except where JAX's own step
               nudged by one part in 10^6 breaks them too (tools/
               golden_steps.py::judge, tests/test_torch_golden_steps.py's
               rule), 480 + 480 launches asserted; then the 60-step replay
               from the start, as many launches asserted, its distance from
               the golden printed (not gated: the landing is chaotic). The
               same on the CPU (tools/diag_drop_golden.py, one thread) runs
               in the background from the start of the script: its replay
               distance is printed beside the card's, and a step excused on
               the card but not on the CPU is named.
Then the kernels' JSON line (`launches`: the sum over the slices', the
training updates' and the new phases' runs, by task, "train",
"locomotion", "curriculum", "camera", "mpc", "aos" (none), "mesh" (the
ranks'), "mesh_reference" (the unsharded runs) and "goldens" under
`launches_by_task`), the
card's name and power limit, and the result line `{"ok": true, "device":
{...}}`. Any failed phase raises (exit code 1); with no CUDA device it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import mqe_tpu_torch  # noqa: E402
from mqe_tpu_torch.control.nets import load_body_policy  # noqa: E402
from mqe_tpu_torch.envs import tasks as T  # noqa: E402
from mqe_tpu_torch.envs.config import Go1Cfg  # noqa: E402
from mqe_tpu_torch.envs import wrappers as W  # noqa: E402
from mqe_tpu_torch.envs.go1_env import Go1Env  # noqa: E402
from mqe_tpu_torch.envs.gym_adapter import GymAdapter, SingleAgentAdapter  # noqa: E402
from mqe_tpu_torch.envs.registry import ENV_DICT, make_mqe_env  # noqa: E402
from mqe_tpu_torch.learn import evaluate, train_locomotion  # noqa: E402
from mqe_tpu_torch.learn.locomotion_env import LocomotionEnv  # noqa: E402
from mqe_tpu_torch.learn.mat import MATTrainer  # noqa: E402
from mqe_tpu_torch.learn.networks import gaussian_logp  # noqa: E402
from mqe_tpu_torch.learn.ppo import ENV_BLOCK, PPOConfig, PPOTrainer  # noqa: E402
from mqe_tpu_torch.mpc import CommandMPC, fit_command_model, run_mpc  # noqa: E402
from mqe_tpu_torch.mpc.controller import planner_state  # noqa: E402
from mqe_tpu_torch.physics import fused_step, soa  # noqa: E402
from mqe_tpu_torch.physics.model import go1_model, load_model  # noqa: E402
from mqe_tpu_torch.utils.convert import env_state_to, wtw_body_from_numpy  # noqa: E402
from mqe_tpu_torch.utils.opcount import count_ops  # noqa: E402
from mqe_tpu_torch.utils.random import Draws  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "tools"))
import golden_steps  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# without tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# tolerances of tests/test_pallas_step.py (pos, quat, lin_vel, ang_vel, q, qd)
NAMES = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
TOLS = (1e-6, 1e-6, 1e-5, 1e-5, 1e-6, 1e-4)
FK_TOL = 1e-6  # tests/test_torch_soa.py::test_fk_matches_jax
# a control step card vs CPU: the per-step bounds of tests/test_soa_episode.py
# between two paths
CHECK_TOLS = dict(pos=1e-6, quat=1e-5, lin_vel=3e-4, ang_vel=5e-3, q=2e-4, qd=2e-2)

KERNELS = {"fused_step_kernel": fused_step.step_actor_kernel,
           "fk_spheres_kernel": fused_step.fk_spheres_kernel,
           "fk_full_kernel": fused_step.fk_full_kernel}
# task: timed steps. 20 for the earlier slices' tasks and for one task of
# each new shape (4 robots, static geoms, 9 NPCs), 5 for the others
SLICES = {"go1gate": 20, "go1pushbox": 20, "go1seesaw": 20, "go1football-2vs2": 20,
          "go1wrestling": 20, "go1sheep-hard": 20, "go1football-defender": 5,
          "go1football-1vs1": 5, "go1tug": 5, "go1revolvingdoor": 5, "go1bridge": 5,
          "go1door": 5, "go1sheep-easy": 5}
SLICE_ENVS = 4096
# phase locomotion: LocomotionEnv's envs (one robot each) and its updates
LOCO_ENVS = 4096
LOCO_UPDATES = 2
# the robots' launches of the slices: B = envs x robots of each task SLICES
# drives (8192 for two robots, 12,288 for football-defender's three, 16,384
# for football-2vs2's four) and locomotion training's 4096; the JSON entries
# carry go1gate's (GATE_B), "robots" the others
GATE_B = SLICE_ENVS * ENV_DICT["go1gate"]["config"].env.num_agents
ROBOT_B = sorted({SLICE_ENVS * ENV_DICT[t]["config"].env.num_agents for t in SLICES}
                 | {LOCO_ENVS})

# phase train: (label, trainer class, config, updates) on go1gate
TRAIN_TASK = "go1gate"
TRAIN_RUNS = (("ppo", PPOTrainer, PPOConfig(), 3),
              ("gru", PPOTrainer, PPOConfig(recurrent=True), 1),
              ("mat", MATTrainer, PPOConfig(algo="mat"), 1))
# the committed JAX TrainStates that phase train evaluates: (task, path, recurrent)
EVAL_CHECKPOINTS = (("go1bridge", "checkpoints/r5b/go1bridge_ppo_best.npz", False),
                    ("go1gate", "checkpoints/rec/go1gate_ppo_best.npz", True))
SGD_TOL = 1e-5  # params after one SGD phase, card vs CPU
# phases curriculum, camera, mpc: the image bounds of tests/test_torch_camera.py,
# the timed steps, the MPC's timed cycles and solves, and the solve's cost
# card vs CPU at the bound tests/test_torch_mpc.py holds a solve to against JAX
DEPTH_TOL, RGB_TOL = 1e-4, 1e-4
CURR_STEPS = 20
CAMERA_TASKS = {"go1gate": 20, "go1sheep-easy": 5}
MPC_CYCLES, MPC_SOLVES, PUSHBOX_CYCLES = 20, 5, 5
MPC_COST_REL = 1e-3

T0 = time.perf_counter()


def say(phase, msg):
    print(f"[{time.perf_counter() - T0:8.2f} s] {phase}: {msg}", flush=True)


def ptxas_usage(log):
    """{kernel: registers, stack, spill stores and loads in bytes} from the
    `-Xptxas -v` report of the build: "Compiling entry function '<mangled
    name>'", then "Function properties for" it with its stack and spills,
    then "Used N registers"."""
    usage, entry, props = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in KERNELS if k in line), None)
            if entry:
                usage[entry] = {}
        elif "Function properties for" in line:
            props = entry if entry and entry in line else None
        elif props and "stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            usage[props].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif entry and "Used" in line and "registers" in line:
            usage[entry]["registers"] = int(line.split("Used")[1].split()[0])
    return usage


def smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def rand_state(m, B, seed, z=0.35, q_sd=0.2, qd_sd=0.5, tau_sd=2.0, f_sd=5.0, dev="cuda"):
    """Inputs drawn as tests/test_pallas_step.py::_rand_state draws them."""
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)
    pos = t(rng.randn(B, 3) * 0.1 + np.array([0, 0, z]))
    qt = rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0])
    quat = t(qt / np.linalg.norm(qt, axis=1, keepdims=True))
    lv = t(rng.randn(B, 3) * 0.3)
    av = t(rng.randn(B, 3) * 0.3)
    q = t(rng.randn(B, m.nq) * q_sd)
    qd = t(rng.randn(B, m.nq) * qd_sd)
    tau = t(rng.randn(B, m.nq) * tau_sd)
    sx, _ = soa.fk_spheres(m, pos, quat, lv, av, q, qd)
    sf = t(rng.randn(B, len(m.sph_tags), 3) * f_sd)
    payload = t(rng.rand(B) * 2)
    cshift = t(rng.randn(B, 3) * 0.01)
    return (pos, quat, lv, av, q, qd, tau, sf, sx), payload, cshift


def compare(phase, case, ref, out, names=NAMES, tols=TOLS):
    worst = 0.0
    parts = []
    for n, a, b, tol in zip(names, ref, out, tols):
        if tuple(a.shape) != tuple(b.shape):
            raise AssertionError(f"{case} {n}: shape {tuple(b.shape)} vs {tuple(a.shape)}")
        if a.numel() == 0:
            continue
        if not torch.isfinite(b).all():
            raise AssertionError(f"{case} {n}: non-finite kernel output")
        diff = float((a - b).abs().max())
        parts.append(f"{n} {diff:.3e}")
        if diff > tol:
            raise AssertionError(f"{case} {n}: max diff {diff:.3e} > {tol:.0e}")
        worst = max(worst, diff)
    say(phase, f"{case}: " + ", ".join(parts))
    return worst


def cuda_ms(fn, n):
    """Mean milliseconds of fn() over n back-to-back calls, CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n=200, reps=5):
    """Mean device milliseconds of one launch of fn(): n launches captured in
    a CUDA graph, the graph replayed `reps` times between CUDA events. The
    launches run back to back, without the host's launch overhead, which
    exceeds a small launch's time. (torch.profiler's kernel records are not
    used: in one run on the H100 they held 83 of 200 launches.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps) / n


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(tensors_in, tensors_out, ops):
    """(bound ms, 'bytes' or 'operations', bytes, bytes ms, ops ms) of work that
    reads each input once, writes each output once and does `ops` float ops."""
    nb = nbytes(tensors_in) + nbytes(tensors_out)
    bytes_ms = nb / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            nb, bytes_ms, ops_ms)


def timing(phase, label, launch, call, plain, ins, outs, smi, floor=None):
    """Time one kernel at one shape: its device time per launch into
    preallocated outputs (`launch`), the wrapper's time per call (checks,
    allocation, launch), the plain version's, and the card's bound for the
    work. Inputs stay in L2 between launches, as they do on the main path,
    where the stage before just wrote them. `floor`, where given, launches
    the same kernel at B = 1: its device time is the least a launch of it
    takes. Returns the JSON fields."""
    ms = device_ms(launch)
    wrapper_ms = cuda_ms(call, 50)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    b_ms, b_by, nb, bytes_ms, ops_ms = bound(ins, outs, count_ops(plain))
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, wrapper_ms=wrapper_ms)
    floor_txt = ""
    if floor is not None:
        out["floor_ms"] = device_ms(floor)
        floor_txt = f", floor (B = 1) {out['floor_ms']:.4f} ms/launch"
    say(phase, f"{label}: kernel {ms:.4f} ms/launch on the device (wrapper {wrapper_ms:.4f} "
        f"ms/call){floor_txt}, plain {plain_ms:.3f} ms/call; bound {b_ms:.4f} ms by {b_by} "
        f"(bytes {nb} -> {bytes_ms:.4f} ms, ops -> {ops_ms:.4f} ms); on {smi}")
    return out


def npc_step_inputs(name, root_free, B, seed):
    """An NPC launch as the scene makes it: the model loaded with the
    scene's root flag, a reaction wrench, no payload or com shift."""
    m = load_model(name, root_free=root_free)
    args, _, _ = rand_state(m, B, seed, z=1.0, q_sd=0.1, qd_sd=0.3, tau_sd=0.0, f_sd=2.0)
    wrench = torch.as_tensor(
        np.random.RandomState(seed + 1).randn(B, m.nb, 6).astype(np.float32) * 1.5, device="cuda")
    return m, args, wrench


# the NPC launches of the slices: (label, model, root_free, B); the sheep's
# second is go1sheep-hard's 9 sheep in each of 4096 envs
NPC_LAUNCHES = (("box", "box", True, 4096), ("seesaw", "seesaw", False, 4096),
                ("ball", "ball", True, 4096), ("cylinder", "cylinder", False, 4096),
                ("rotation_door", "rotation_door", False, 4096), ("door", "door", False, 4096),
                ("sheep", "sheep", True, 4096), ("sheep x9", "sheep", True, 36864))


def phase_kernel(smi):
    go1 = go1_model()
    # case 1: the robots' launches of the slices, go1 at each B of ROBOT_B
    # with payload and com shift
    robots = {B: rand_state(go1, B, seed=0) for B in ROBOT_B}
    max_err = 0.0
    for B, (args, payload, cshift) in robots.items():
        ref = soa.step_actor(go1, *args, payload=payload, com_shift=cshift)
        out = fused_step.step_actor_kernel(go1, *args, payload=payload, com_shift=cshift)
        torch.cuda.synchronize()
        max_err = max(max_err, compare("kernel", f"go1 B={B} payload+com_shift", ref, out))

    # case 2: go1 at B = 37 with a per-body world wrench
    args2, _, _ = rand_state(go1, 37, seed=3)
    rng = np.random.RandomState(7)
    wrench = torch.as_tensor(rng.randn(37, go1.nb, 6).astype(np.float32) * 3.0, device="cuda")
    compare("kernel", "go1 B=37 extra_wrench",
            soa.step_actor(go1, *args2, extra_wrench=wrench),
            fused_step.step_actor_kernel(go1, *args2, extra_wrench=wrench))

    # cases 3-4: NPC models as the scene loads them (root-free), ball (nq 0)
    # and seesaw with a welded base
    for name, root_free in (("ball", True), ("seesaw", False)):
        m = load_model(name, root_free=True)
        a3, _, _ = rand_state(m, 13, seed=11, z=1.0, q_sd=0.1, qd_sd=0.3, tau_sd=0.0, f_sd=2.0)
        w3 = torch.as_tensor(
            np.random.RandomState(12).randn(13, m.nb, 6).astype(np.float32) * 1.5, device="cuda")
        compare("kernel", f"{name} root_free={root_free}",
                soa.step_actor(m, *a3, extra_wrench=w3, root_free=root_free),
                fused_step.step_actor_kernel(m, *a3, extra_wrench=w3, root_free=root_free))

    # the NPC launches of the slices at their shape, each model loaded with
    # the scene's root flag and launched with it
    npc_cases = {label: npc_step_inputs(name, rf, b, seed=21)
                 for label, name, rf, b in NPC_LAUNCHES}
    for name, (m, a, w) in npc_cases.items():
        rf = m.root_free
        max_err = max(max_err, compare(
            "kernel", f"{name} B={a[0].shape[0]} NPC launch (root_free={rf})",
            soa.step_actor(m, *a, extra_wrench=w, root_free=rf),
            fused_step.step_actor_kernel(m, *a, extra_wrench=w, root_free=rf)))

    # time at the slices' shapes: the JSON entry carries go1gate's robots'
    # launch, "robots" the others, "npc" the NPC launches
    def robot_timing(B):
        args, payload, cshift = robots[B]
        out = fused_step.step_actor_kernel(go1, *args, payload=payload, com_shift=cshift)
        return timing(
            "kernel", f"go1 B={B}",
            lambda: fused_step.launch_step(go1, *args, payload, cshift, None, out, 0.0025, True),
            lambda: fused_step.step_actor_kernel(go1, *args, payload=payload, com_shift=cshift),
            lambda: soa.step_actor(go1, *args, payload=payload, com_shift=cshift),
            (*args, payload, cshift), out, smi)

    entry = dict(
        name="fused_step_kernel", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/pallas_step.py:141", max_abs_err=max_err, library_ms=None,
        **robot_timing(GATE_B))
    entry["robots"] = {str(B): robot_timing(B) for B in ROBOT_B if B != GATE_B}
    entry["npc"] = {}
    for name, (m, a, w) in npc_cases.items():
        rf = m.root_free
        nout = fused_step.step_actor_kernel(m, *a, extra_wrench=w, root_free=rf)
        entry["npc"][name] = timing(
            "kernel", f"{name} B={a[0].shape[0]} NPC launch",
            lambda: fused_step.launch_step(m, *a, None, None, w, nout, 0.0025, rf),
            lambda: fused_step.step_actor_kernel(m, *a, extra_wrench=w, root_free=rf),
            lambda: soa.step_actor(m, *a, extra_wrench=w, root_free=rf),
            (*a, w), nout, smi)
    return entry


def fk_state(m, B, seed):
    """Inputs drawn as tests/test_torch_soa.py::test_fk_matches_jax draws them."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, 3) * 0.1, rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0]),
            rng.randn(B, 3) * 0.3, rng.randn(B, 3) * 0.3, rng.randn(B, m.nq) * 0.2,
            rng.randn(B, m.nq) * 0.5]
    arrs[1] /= np.linalg.norm(arrs[1], axis=1, keepdims=True)
    return [torch.as_tensor(a.astype(np.float32), device="cuda") for a in arrs]


def fk_geometry_txt(m, B):
    ns = len(m.sph_tags)
    R = fused_step.fk_robots_per_block(fused_step.lanes_log2(m), ns, B)
    return f"{R} robots a block, {-(-B // R)} blocks, {fused_step.fk_shared_bytes(R, ns)} B shared"


def phase_fk(smi):
    go1 = go1_model()
    names, tols = ("sph_x", "sph_v"), (FK_TOL, FK_TOL)
    max_err = 0.0
    for name, sizes in (("go1", (*ROBOT_B, 37, 1)), ("seesaw", (37, 1)), ("ball", (37, 1))):
        m = go1 if name == "go1" else load_model(name, root_free=True)
        for b in sizes:
            a = fk_state(m, b, seed=5 if b in ROBOT_B else 6)
            out = fused_step.fk_spheres_kernel(m, *a)
            torch.cuda.synchronize()
            max_err = max(max_err, compare("fk", f"{name} B={b} ({fk_geometry_txt(m, b)})",
                                           soa.fk_spheres(m, *a), out, names, tols))
    one = fk_state(go1, 1, seed=6)
    one_out = fused_step.fk_spheres_kernel(go1, *one)

    # the JSON entry carries go1gate's robots' launch and the floor,
    # "robots" the robots' launches at the other B
    def robot_timing(B, floor=None):
        args = fk_state(go1, B, seed=5)
        out = fused_step.fk_spheres_kernel(go1, *args)
        return timing("fk", f"go1 B={B}", lambda: fused_step.launch_fk(go1, *args, *out),
                      lambda: fused_step.fk_spheres_kernel(go1, *args),
                      lambda: soa.fk_spheres(go1, *args), args, out, smi, floor=floor)

    entry = dict(
        name="fk_spheres_kernel", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/soa.py:546", max_abs_err=max_err, library_ms=None,
        **robot_timing(GATE_B, floor=lambda: fused_step.launch_fk(go1, *one, *one_out)))
    entry["robots"] = {str(B): robot_timing(B) for B in ROBOT_B if B != GATE_B}
    return entry


FK_FULL_NAMES = ("Rw", "pw", "vw", "sph_x", "sph_v")


def phase_fk_full(smi):
    """The full FK of every NPC launch of the slices at its shape, and of the
    box and the seesaw at ragged and small B too; the ball at 37 and 1 as
    well. The JSON entry carries the box's numbers, the go1pushbox slice's;
    every other launch's are under its label."""
    entry, worst = {}, 0.0
    extra_sizes = {"box": (4095, 37, 1), "seesaw": (4095, 37, 1), "ball": (37, 1)}
    for label, name, root_free, B in NPC_LAUNCHES:
        m = load_model(name, root_free=root_free)
        for b in (B,) + extra_sizes.get(label, ()):
            a = fk_state(m, b, seed=5)
            out = fused_step.fk_full_kernel(m, *a)
            torch.cuda.synchronize()
            worst = max(worst, compare("fk_full", f"{label} B={b} ({fk_geometry_txt(m, b)})",
                                       soa.fk_full(m, *a), out, FK_FULL_NAMES, (FK_TOL,) * 5))
        args = fk_state(m, B, seed=5)
        out = fused_step.fk_full_kernel(m, *args)
        floor = None
        if label in ("box", "seesaw"):
            one = fk_state(m, 1, seed=5)
            one_out = fused_step.fk_full_kernel(m, *one)
            floor = lambda: fused_step.launch_fk_full(m, *one, one_out)  # noqa: E731
        t = timing("fk_full", f"{label} B={B}",
                   lambda: fused_step.launch_fk_full(m, *args, out),
                   lambda: fused_step.fk_full_kernel(m, *args),
                   lambda: soa.fk_full(m, *args), args, out, smi, floor=floor)
        if label == "box":
            entry.update(t)
        else:
            entry[label] = t
    return dict(
        name="fk_full_kernel", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/soa.py:556", max_abs_err=worst, library_ms=None, **entry,
    )


def compare_step(label, wrap_c, wrap_h, ts_c, acts, given, terms=False, gate=True):
    """One step of the state `ts_c` on the card (kernels) and of its copy on
    the CPU (plain versions) with the same actions and draws (`given`: numpy
    arrays and the "fresh" state on the card), compared at CHECK_TOLS, obs
    and reward (and with `terms` every reward term) at 1e-4, commands at
    1e-5. The step must end no episode. `wrap_c`/`wrap_h` are task wrappers
    or LocomotionEnvs. With `gate` off the differences are printed and not
    held to the bounds (a measurement, not a check)."""
    ts_h = env_state_to(ts_c, "cpu")
    on = lambda d, dev: {k: (env_state_to(v, dev) if k == "fresh"  # noqa: E731
                             else torch.as_tensor(v, device=dev)) for k, v in d.items()}
    out_c = wrap_c.step(ts_c, torch.as_tensor(acts, device="cuda"),
                        wrap_c.env.draws(on(given, "cuda")))
    out_h = wrap_h.step(ts_h, torch.as_tensor(acts), wrap_h.env.draws(on(given, "cpu")))
    if bool(out_h[3].any()):
        raise AssertionError(f"check {label}: an env reset in the check step; the comparison "
                             "needs none")
    worst = {}
    for who in ("agents", "npcs"):
        for n in NAMES:
            a = getattr(getattr(out_c[0].env.phys, who), n).cpu()
            b = getattr(getattr(out_h[0].env.phys, who), n)
            worst[f"{who}.{n}"] = float((a - b).abs().max()) if a.numel() else 0.0
    for n, v in worst.items():
        tol = CHECK_TOLS[n.split(".")[1]]
        if gate and not v <= tol:
            raise AssertionError(f"check {label} {n}: card vs CPU {v:.3e} > {tol:.0e}")
    if not gate:
        say("check", f"{label}, card vs CPU after one step (measured, not gated): "
            + ", ".join(f"{n} {v:.3e}" for n, v in worst.items()))
        return
    other = {"obs": (out_c[1], out_h[1]), "reward": (out_c[2], out_h[2])}
    for k, v in (out_h[4]["reward_terms"].items() if terms else ()):
        other[f"term {k}"] = (out_c[4]["reward_terms"][k], v)
    for n, (a, b) in other.items():
        worst[n] = float((a.cpu() - b).abs().max())
        if not worst[n] <= 1e-4:
            raise AssertionError(f"check {label} {n}: card vs CPU {worst[n]:.3e} > 1e-4")
    cmd = lambda ts: ts.commands if hasattr(ts, "cmd_scale") else ts.env.commands  # noqa: E731
    worst["commands"] = float((cmd(out_c[0]).cpu() - cmd(out_h[0])).abs().max())
    if not worst["commands"] <= 1e-5:
        raise AssertionError(f"check {label} commands: card vs CPU {worst['commands']:.3e} > 1e-5")
    say("check", f"{label}, card vs CPU after one step: "
        + ", ".join(f"{n} {v:.3e}" for n, v in worst.items()))


def phase_check(task, draw=1):
    """One step at 2 envs: kernels on the card vs plain on the CPU, with the
    same draws (the reset state, the sheep script's noise), from the
    generator's `draw`-th reset draw. The first draw is the gate; a later
    one is measured and printed: from go1wrestling's second the two part by
    qd 3.956e-2, float32 noise that the ring contact amplifies substep by
    substep (PERF.md §6; tools/compare_card_cpu_substeps.py)."""
    wrap_c, _ = make_mqe_env(task, num_envs=2, seed=0, device="cuda")
    wrap_h, _ = make_mqe_env(task, num_envs=2, seed=0, device="cpu")
    for _ in range(draw - 1):
        wrap_c.env.fresh_state()
    ts_c, _ = wrap_c.reset()
    rng = np.random.RandomState(5)
    acts = rng.uniform(-1, 1, (2, wrap_c.controlled_agents, 3)).astype(np.float32)
    given = {"fresh": wrap_c.env.fresh_state(),  # the reset state, should an env reset
             "npc_noise": rng.randn(2, wrap_c.num_npcs, 3).astype(np.float32)}
    compare_step(f"{task} 2 envs, reset draw {draw}", wrap_c, wrap_h, ts_c, acts, given,
                 gate=draw == 1)


def reset_counts():
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def read_counts():
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


def check_counts(label, launches, env, steps):
    """`launches` of `steps` env steps of `env` (a Go1Env): 8 of the step
    kernel and of the sphere FK a step, twice the step kernel and the full FK
    as well with colliding NPCs."""
    substeps = env.decimation * env.subiters
    npc = env.scene.num_npcs > 0
    expect = {"fused_step_kernel": substeps * (2 if npc else 1) * steps,
              "fk_spheres_kernel": substeps * steps, "fk_full_kernel": substeps * steps if npc else 0}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} in {steps} steps, expected {expect}")


def add_counts(total, launches):
    for name, c in launches.items():
        total[name] += c


def phase_slice(smi, task, num_envs=SLICE_ENVS, steps=20):
    reset_counts()
    wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0, device="cuda")
    ts, obs = wrap.reset()
    torch.cuda.synchronize()
    say("slice", f"{task} {num_envs} envs built and reset, obs {tuple(obs.shape)}")
    nact = wrap.controlled_agents
    cmds = torch.as_tensor(
        np.random.RandomState(1).uniform(-1, 1, (num_envs, nact, 3)).astype(np.float32),
        device="cuda")
    ts, obs, rew, done, info = wrap.step(ts, cmds)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ts, obs, rew, done, info = wrap.step(ts, cmds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    check_counts(f"{task} {steps + 1} steps", launches, wrap.env, steps + 1)
    npcs = ts.env.phys.npcs
    for name, t, shape in (("obs", obs, (num_envs, nact, wrap.obs_dim)),
                           ("reward", rew, (num_envs, nact)),
                           ("npc pos", npcs.pos, (num_envs, wrap.num_npcs, 3)),
                           ("npc q", npcs.q, tuple(npcs.qd.shape))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{task} {name}: shape {tuple(t.shape)} (expected {shape}) "
                                 "or non-finite")
    sps = num_envs * steps / dt
    say("slice", f"{task}: {steps} steps in {dt:.3f} s: {sps:.1f} env-steps/s, "
        f"{dt / steps * 1e3:.2f} ms/step, kernel launches {launches} in {steps + 1} steps, "
        f"resets {int(done.sum())} in the last step; on {smi}")
    return launches


def train_update(tr, ts, smi, label, u):
    """One training update, its rollout and SGD timed apart; the kernels'
    counts set to 0 before it and read after it."""
    reset_counts()
    ts, m, rollout_s, sgd_s = tr.timed_update(ts)
    launches = read_counts()
    T, E, A = tr.cfg.rollout_len, tr.E, tr.A
    check_counts(f"train {label} update {u}", launches, tr.w.env, T)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"train {label} update {u}: loss {loss}")
    upd = rollout_s + sgd_s
    say("train", f"{label} update {u}: rollout {rollout_s * 1e3:.1f} ms, SGD "
        f"{sgd_s * 1e3:.1f} ms, update {upd * 1e3:.1f} ms; "
        f"{T * E * A / upd:.1f} env-steps/s (T*E*A = {T * E * A}), "
        f"{T * E / upd:.1f} (T*E); loss {loss:.4f}, reward {float(m['reward_mean']):.5f}; "
        f"launches {launches}; on {smi}")
    return ts, launches


def sgd_card_vs_cpu(tr, smi):
    """One SGD phase from a batch drawn with numpy, with the same
    permutations, on the card and on the CPU; params compared."""
    cfg = tr.cfg
    n = cfg.rollout_len * tr.E * tr.A
    rng = np.random.RandomState(11)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    batch = dict(obs=f32(n, tr.obs_dim), action=f32(n, tr.act_dim), adv=f32(n), ret=f32(n))
    with torch.no_grad():  # old log-probs near the policy's own: ratios of a PPO batch
        mean, log_std, _, _ = tr._apply({k: v.cpu() for k, v in tr.init_params.items()},
                                        torch.as_tensor(batch["obs"]))
        logp = gaussian_logp(mean, log_std, torch.as_tensor(batch["action"])).numpy()
    batch["logp"] = logp - 0.3 * f32(n)
    perms = np.stack([rng.permutation(n) for _ in range(cfg.ppo_epochs)])
    out, ms = {}, {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        params = {k: v.to(dev) for k, v in tr.init_params.items()}
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[where] = tr._sgd(params, tr.tx.init(params), b, None, {"perm": perms})
        torch.cuda.synchronize()
        ms[where] = (time.perf_counter() - t0) * 1e3
    worst = max(float((out["card"][0][k].cpu() - v).abs().max()) for k, v in out["cpu"][0].items())
    moved = max(float((out["cpu"][0][k] - v.cpu()).abs().max()) for k, v in tr.init_params.items())
    say("train", f"SGD phase card vs CPU ({n} rows, {cfg.ppo_epochs * cfg.num_minibatches} "
        f"minibatch steps): params max diff {worst:.3e} (bound {SGD_TOL:.0e}), moved {moved:.3e}; "
        f"loss {float(out['card'][2]):.6f} / {float(out['cpu'][2]):.6f}; card {ms['card']:.1f} ms, "
        f"CPU {ms['cpu']:.1f} ms; on {smi}")
    if not worst <= SGD_TOL:
        raise AssertionError(f"SGD card vs CPU: params differ by {worst:.3e} > {SGD_TOL:.0e}")


def policy_blocks_ms(tr, ts, smi, reps=50):
    """The rollout's policy pass over the envs in blocks of ENV_BLOCK (what
    makes a sharded rollout the unsharded one bit for bit) against one pass
    over all of them, timed apart in this process."""
    obs = tr.w.observe(ts.env_state)
    ms = {}
    with torch.no_grad():
        blocks = lambda p, o: tr._apply(p, o, blocks=True)  # noqa: E731
        for label, fn in (("blocks", blocks), ("whole", tr._apply), ("blocks again", blocks)):
            fn(ts.params, obs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(ts.params, obs)
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) / reps * 1e3
    say("train", f"policy pass over {tr.E} envs: in blocks of {ENV_BLOCK} "
        f"{ms['blocks']:.3f} / {ms['blocks again']:.3f} ms, in one {ms['whole']:.3f} ms "
        f"(x {tr.cfg.rollout_len} an update's rollout); on {smi}")


def phase_train(smi):
    """Training updates on the card, the SGD check and the evaluations.
    Returns the launches summed over the updates."""
    wrap, _ = make_mqe_env(TRAIN_TASK, num_envs=SLICE_ENVS, seed=0, device="cuda")
    total = {name: 0 for name in KERNELS}
    for label, cls, cfg, n in TRAIN_RUNS:
        tr = cls(wrap, cfg, seed=0)
        ts = tr.init_state()
        for u in range(n):
            ts, launches = train_update(tr, ts, smi, label, u)
            for name, c in launches.items():
                total[name] += c
        moved = max(float((ts.params[k] - v).abs().max()) for k, v in tr.init_params.items())
        if not moved > 0:
            raise AssertionError(f"train {label}: params did not move")
        if label == "ppo":
            sgd_card_vs_cpu(tr, smi)
            policy_blocks_ms(tr, ts, smi)
    for task, path, recurrent in EVAL_CHECKPOINTS:
        t0 = time.perf_counter()
        rec = evaluate.main(["--task", task, "--checkpoint", os.path.join(REPO, path),
                             "--num-envs", "4", "--episodes", "1"]
                            + (["--recurrent"] if recurrent else []))
        if not np.isfinite(rec["mean_return"]) or rec["episodes"] < 4:
            raise AssertionError(f"evaluate {task}: {rec}")
        say("train", f"evaluate {task} ({path}) on the card, 4 envs, one episode: "
            f"{rec['episodes']} episodes, mean return {rec['mean_return']}, success rate "
            f"{rec.get('success_rate')} in {time.perf_counter() - t0:.1f} s; on {smi}")
    return total


def wtw_params(seed=5):
    """A walk-these-ways body MLP's params in the JAX package's `mlp_apply`
    layout, drawn from RandomState(seed) (as tools/make_torch_goldens.py
    draws them: the reference's weights are not in the repo)."""
    sizes = (2100 + 2, 512, 256, 128, 12)
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.randn(b)).astype(np.float32) for b in sizes[1:]]
    return {"w": ws, "b": bs, "act": "elu"}


def policy_cfg():
    class Cfg(T.Go1PlaneCfg):
        class control(T.Go1PlaneCfg.control):
            locomotion_backend = "policy"

    return Cfg


def loco_checks():
    """One step card vs CPU of LocomotionEnv (residual, lag on) and of
    go1plane's `policy` backend with the body-policy npz and with the
    walk-these-ways stack."""
    E = 4
    rng = np.random.RandomState(5)
    env_c = LocomotionEnv(num_envs=E, seed=0, device="cuda")
    env_h = LocomotionEnv(num_envs=E, seed=0, device="cpu")
    ts_c, _ = env_c.reset()
    acts = np.asarray(np.tanh(rng.randn(E, 1, 12)), dtype=np.float32)  # rl_prescale, residual
    given = {"fresh": env_c.env.fresh_state(),
             "cmd_vx": rng.uniform(-1, 1, E), "cmd_vy": rng.uniform(-0.6, 0.6, E),
             "cmd_wz": rng.uniform(-1, 1, E)}
    compare_step(f"LocomotionEnv {E} envs (residual, lag {env_c.env.lag_len})",
                 env_c, env_h, ts_c, acts, given, terms=True)

    acts = rng.uniform(-1, 1, (2, 1, 3)).astype(np.float32)
    wraps = [W.EmptyWrapper(Go1Env(policy_cfg(), num_envs=2, seed=0, device=d))
             for d in ("cuda", "cpu")]
    ts_c, _ = wraps[0].reset()
    compare_step("go1plane policy backend (assets/body_policy.npz)", *wraps, ts_c, acts,
                 {"fresh": wraps[0].env.fresh_state()})
    # the walk-these-ways stack: the assets without body_policy.npz
    old = mqe_tpu_torch.ASSETS_DIR
    tmp = tempfile.mkdtemp()
    try:
        for f in os.listdir(old):
            if f != "body_policy.npz":
                shutil.copy(os.path.join(old, f), tmp)
        mqe_tpu_torch.ASSETS_DIR = tmp
        wraps = [W.EmptyWrapper(Go1Env(policy_cfg(), num_envs=2, seed=0, device=d))
                 for d in ("cuda", "cpu")]
    finally:
        mqe_tpu_torch.ASSETS_DIR = old
        shutil.rmtree(tmp)
    for w in wraps:
        if w.env.hist_len != 30:
            raise AssertionError(f"the WTW stack's history: hist_len {w.env.hist_len}")
        w.env.load_locomotion_policy(wtw_body_from_numpy(wtw_params(), device=w.device))
    ts_c, _ = wraps[0].reset()
    compare_step("go1plane policy backend (walk-these-ways stack, 30-step history)", *wraps,
                 ts_c, acts, {"fresh": wraps[0].env.fresh_state()})


def adapter_steps(smi, num_envs=64, steps=3):
    """A few GymAdapter and SingleAgentAdapter steps on go1gate on the card."""
    wrap, _ = make_mqe_env("go1gate", num_envs=num_envs, seed=0, device="cuda")
    A, D = wrap.controlled_agents, wrap.obs_dim
    rng = np.random.RandomState(2)
    for cls, shape in ((GymAdapter, (num_envs, A)), (SingleAgentAdapter, (num_envs * A, 1))):
        ad = cls(wrap, seed=1)
        obs = ad.reset()
        for _ in range(steps):
            obs, rew, done, info = ad.step(rng.uniform(-1, 1, shape + (3,)))
        ok = (obs.shape == shape + (D,) and rew.shape == shape == done.shape
              and isinstance(obs, np.ndarray) and np.isfinite(obs).all() and np.isfinite(rew).all())
        if not ok:
            raise AssertionError(f"{cls.__name__}: obs {obs.shape}, rew {rew.shape}, "
                                 f"done {done.shape}, expected {shape}")
        say("locomotion", f"{cls.__name__} on go1gate, {num_envs} envs, {steps} steps: obs "
            f"{obs.shape}, reward {rew.shape} (mean {rew.mean():.5f}), done {done.shape}, "
            f"{len(info['reward_terms'])} reward terms; on {smi}")


def phase_locomotion(smi):
    """Locomotion training and the `policy` backend on the card. Returns the
    launches summed over the training updates and the CLI's update."""
    loco_checks()
    env = LocomotionEnv(num_envs=LOCO_ENVS, seed=0, device="cuda")
    cfg = PPOConfig(lr=3e-4, rollout_len=32, ent_coef=1e-3)  # train_locomotion's
    tr = PPOTrainer(env, cfg, seed=0)
    ts = tr.init_state()
    total = {name: 0 for name in KERNELS}
    for u in range(LOCO_UPDATES):
        ts, launches = train_update(tr, ts, smi, "locomotion", u)
        for name, c in launches.items():
            total[name] += c
    moved = max(float((ts.params[k] - v).abs().max()) for k, v in tr.init_params.items())
    if not moved > 0:
        raise AssertionError("locomotion: params did not move")
    with tempfile.TemporaryDirectory() as d:
        # the trained params through the CLI's npz writer and load_body_policy
        path = os.path.join(d, "body_policy.npz")
        np.savez(path, **train_locomotion.policy_npz(tr.net, ts.params, env.prescale))
        obs = torch.as_tensor(np.random.RandomState(4).randn(64, 70).astype(np.float32),
                              device="cuda")
        with torch.no_grad():
            want = env.prescale * torch.tanh(tr._apply(ts.params, obs)[0])
            err = float((load_body_policy(path, device="cuda")(obs) - want).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"locomotion: body policy npz read back differs by {err:.3e}")
        # the entry point: one update of train_locomotion's own run
        reset_counts()
        t0 = time.perf_counter()
        out = train_locomotion.main(["--num-envs", str(LOCO_ENVS), "--rollout-len",
                                     str(cfg.rollout_len), "--train-timesteps",
                                     str(cfg.rollout_len * LOCO_ENVS), "--out",
                                     os.path.join(d, "cli.npz")])
        cli_s = time.perf_counter() - t0
        launches = read_counts()
        check_counts("train_locomotion", launches, env.env, cfg.rollout_len)
        cli_policy = load_body_policy(out, device="cuda")
        with torch.no_grad():
            act = cli_policy(obs)
        if tuple(act.shape) != (64, 12) or not bool(torch.isfinite(act).all()):
            raise AssertionError(f"train_locomotion's npz: actions {tuple(act.shape)}")
        for name, c in launches.items():
            total[name] += c
    say("locomotion", f"body policy npz read back: actions within {err:.3e} of the trained "
        f"actor (bound 1e-5); train_locomotion.main, {LOCO_ENVS} envs, one update: "
        f"{cli_s:.2f} s with the env's build and reset, launches {launches}; on {smi}")
    adapter_steps(smi)
    return total


def with_camera(base):
    """A task's config with the depth and RGB camera on."""
    class Cfg(base):
        class obs(base.obs):
            class cfgs(base.obs.cfgs):
                depth_image = True
                rgb_image = True

    return Cfg


class CurrCfg(Go1Cfg):
    """One robot an env on LegacyTerrainBuilder's own grid (10 rows x 20
    columns of 8 m tiles) at Go1Cfg's 0.025 m cells, the curriculum on, the
    depth camera on."""

    class env(Go1Cfg.env):
        num_agents = 1
        num_npcs = 0

    class terrain(Go1Cfg.terrain):
        mesh_type = "heightfield"
        selected = "Legacy"
        curriculum = True
        num_rows = 10
        num_cols = 20
        terrain_length = 8.0
        terrain_width = 8.0

    class obs(Go1Cfg.obs):
        class cfgs(Go1Cfg.obs.cfgs):
            depth_image = True


def compare_images(label, ob_c, ob_h):
    parts = []
    for name, a, b, tol in (("depth", ob_c.depth_image, ob_h.depth_image, DEPTH_TOL),
                            ("rgb", ob_c.rgb_image, ob_h.rgb_image, RGB_TOL)):
        if b is None:
            continue
        if tuple(a.shape) != tuple(b.shape) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)} "
                                 "or non-finite")
        d = float((a.cpu() - b).abs().max())
        parts.append(f"{name} {tuple(a.shape)} max diff {d:.3e} (bound {tol:.0e})")
        if not d <= tol:
            raise AssertionError(f"{label} {name}: card vs CPU {d:.3e} > {tol:.0e}")
    say("camera", f"{label}, images card vs CPU: " + "; ".join(parts))


def timed_steps(env, state, cmds, steps):
    """1 warm and `steps` timed Go1Env steps; the kernels' counts set to 0
    before the warm step. Returns (state, obs, done, seconds, launches)."""
    reset_counts()
    state, obs, done, _ = env.step(state, cmds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, obs, done, _ = env.step(state, cmds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    check_counts(f"{type(env).__name__} {steps + 1} steps", launches, env, steps + 1)
    return state, obs, done, dt, launches


def phase_curriculum(smi):
    """The curriculum on a Legacy heightfield with the depth camera. Returns
    the launches of its runs at SLICE_ENVS envs."""
    from dataclasses import replace

    # card vs CPU at 4 envs on level 0 (flat and rough tiles of the first
    # four columns), the same draws
    E = 4
    env_c = Go1Env(CurrCfg, num_envs=E, seed=0, device="cuda")
    env_h = Go1Env(CurrCfg, num_envs=E, seed=0, device="cpu")
    zeros = torch.zeros(E, dtype=torch.int32, device="cuda")
    st_c = env_c._reset_all(env_c.draws(), zeros)
    st_h = env_state_to(st_c, "cpu")
    cmds = np.random.RandomState(5).uniform(-1, 1, (E, 1, 3)).astype(np.float32)
    fresh = env_c._reset_all(env_c.draws(), zeros)
    lv = np.zeros(E, dtype=np.int64)
    out_c, ob_c, done_c, _ = env_c.step(st_c, torch.as_tensor(cmds, device="cuda"),
                                         env_c.draws({"fresh": fresh, "curr_level": lv}))
    out_h, ob_h, done_h, _ = env_h.step(st_h, torch.as_tensor(cmds), env_h.draws(
        {"fresh": env_state_to(fresh, "cpu"), "curr_level": lv}))
    if bool(done_h.any()) or not torch.equal(out_c.terrain_levels.cpu(), out_h.terrain_levels):
        raise AssertionError(f"curriculum check: done {done_h.tolist()}, levels "
                             f"{out_c.terrain_levels.tolist()} / {out_h.terrain_levels.tolist()}")
    worst = {}
    for n in NAMES:
        worst[n] = float((getattr(out_c.phys.agents, n).cpu() - getattr(out_h.phys.agents, n))
                         .abs().max())
        if not worst[n] <= CHECK_TOLS[n]:
            raise AssertionError(f"curriculum check {n}: card vs CPU {worst[n]:.3e} > "
                                 f"{CHECK_TOLS[n]:.0e}")
    say("curriculum", f"Legacy heightfield {E} envs on level 0, card vs CPU after one step: "
        + ", ".join(f"{n} {v:.3e}" for n, v in worst.items()))
    compare_images(f"curriculum {E} envs", ob_c, ob_h)

    t0 = time.perf_counter()
    env = Go1Env(CurrCfg, num_envs=SLICE_ENVS, seed=0, device="cuda")
    state, obs = env.reset()
    torch.cuda.synchronize()
    hf = env.terrain.height
    say("curriculum", f"{SLICE_ENVS} envs built and reset in {time.perf_counter() - t0:.2f} s: "
        f"heightfield {tuple(hf.shape)} ({hf.numel() * hf.element_size() / 1e6:.1f} MB on the "
        f"card), {env.num_levels} levels, curr_up_dist {env.curr_up_dist} m, depth "
        f"{tuple(obs.depth_image.shape)}")
    cmds = torch.as_tensor(np.random.RandomState(1).uniform(-1, 1, (SLICE_ENVS, 1, 3))
                           .astype(np.float32), device="cuda")
    state, obs, done, dt, launches = timed_steps(env, state, cmds, CURR_STEPS)
    d = obs.depth_image
    if not bool(torch.isfinite(d).all()) or tuple(d.shape) != (SLICE_ENVS, 1, 16, 16):
        raise AssertionError(f"curriculum depth: shape {tuple(d.shape)} or non-finite")
    say("curriculum", f"{CURR_STEPS} steps in {dt:.3f} s: {dt / CURR_STEPS * 1e3:.2f} ms/step, "
        f"{SLICE_ENVS * CURR_STEPS / dt:.1f} env-steps/s, launches {launches} in "
        f"{CURR_STEPS + 1} steps, resets {int(done.sum())} in the last step; on {smi}")
    total = dict(launches)
    # promotion: the robots past half the track, every episode at its end
    lv0 = state.terrain_levels.clone()
    ag = state.phys.agents
    pos = ag.pos.clone()
    pos[..., 0] += env.curr_up_dist + 1.0
    state = replace(state, phys=replace(state.phys, agents=replace(ag, pos=pos)),
                    episode_length=torch.full_like(state.episode_length, env.max_episode_length))
    reset_counts()
    state, _, done, _ = env.step(state, torch.zeros_like(cmds))
    launches = read_counts()
    check_counts("curriculum promotion step", launches, env, 1)
    add_counts(total, launches)
    lv1 = state.terrain_levels
    top = lv0 == env.num_levels - 1
    rose = bool(done.all()) and bool((lv1[~top] == lv0[~top] + 1).all())
    if not rose or not bool(((lv1 >= 0) & (lv1 < env.num_levels)).all()):
        raise AssertionError("curriculum: the levels did not rise")
    say("curriculum", f"promotion step: mean level {float(lv0.float().mean()):.3f} -> "
        f"{float(lv1.float().mean()):.3f}, {int(top.sum())} envs past the last level took a random "
        f"level; on {smi}")
    return total


def phase_camera(smi):
    """The onboard cameras. Returns the launches of the timed runs with the
    camera."""
    for task in CAMERA_TASKS:
        cfg = with_camera(ENV_DICT[task]["config"])
        wrap_c, _ = make_mqe_env(task, num_envs=2, seed=0, device="cuda", custom_cfg=lambda c: cfg)
        wrap_h, _ = make_mqe_env(task, num_envs=2, seed=0, device="cpu", custom_cfg=lambda c: cfg)
        ts_c, _ = wrap_c.reset()
        compare_images(f"{task} 2 envs", wrap_c.env._observations(ts_c.env),
                       wrap_h.env._observations(env_state_to(ts_c.env, "cpu")))
    total = {name: 0 for name in KERNELS}
    for task, steps in CAMERA_TASKS.items():
        ms = {}
        for label, cfg in (("camera", with_camera(ENV_DICT[task]["config"])),
                           ("no camera", ENV_DICT[task]["config"])):
            env = Go1Env(cfg, num_envs=SLICE_ENVS, seed=0, device="cuda")
            state, _ = env.reset()
            cmds = torch.as_tensor(np.random.RandomState(1).uniform(
                -1, 1, (SLICE_ENVS, env.num_agents, 3)).astype(np.float32), device="cuda")
            state, obs, _, dt, launches = timed_steps(env, state, cmds, steps)
            ms[label] = dt / steps * 1e3
            if label == "camera":
                add_counts(total, launches)
                cams, rays = SLICE_ENVS * env.num_agents, env.cam_rays.shape[0]
                for name, img in (("depth", obs.depth_image), ("rgb", obs.rgb_image)):
                    if (not bool(torch.isfinite(img).all())
                            or tuple(img.shape[:2]) != (SLICE_ENVS, env.num_agents)):
                        raise AssertionError(f"camera {task} {name}: {tuple(img.shape)}")
                seen = float((obs.depth_image < env.cam_far).float().mean())
        say("camera", f"{task} {SLICE_ENVS} envs ({cams} cameras of {rays} rays): "
            f"{ms['camera']:.2f} ms/step with depth + RGB, {ms['no camera']:.2f} ms/step without "
            f"(+{ms['camera'] - ms['no camera']:.2f} ms), {steps} timed steps each, "
            f"{100 * seen:.1f} % of pixels nearer than far; on {smi}")
    return total


def mpc_cycles(mpc, state, ms, cycles, gen):
    """1 warm and `cycles` timed MPC cycles; the kernels' counts set to 0
    before the warm cycle and checked after. Returns (state, ms, seconds,
    launches)."""
    reset_counts()
    state, ms, _, _ = mpc.plan_step(state, ms, Draws(gen))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cycles):
        state, ms, done, cost = mpc.plan_step(state, ms, Draws(gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    check_counts(f"MPC {mpc.task} {cycles + 1} cycles", launches, mpc.env,
                 (cycles + 1) * mpc.steps_per_knot)
    if not bool(torch.isfinite(cost).all()):
        raise AssertionError(f"MPC {mpc.task}: non-finite cost")
    return state, ms, dt, launches


def phase_mpc(smi):
    """Command-space MPC on the card. Returns the launches of its env steps."""
    total = {name: 0 for name in KERNELS}
    # card vs CPU: one solve at 2 envs from the same x0, warm start and args
    sols = {}
    rng = np.random.RandomState(3)
    for dev in ("cuda", "cpu"):
        wrap, _ = make_mqe_env("go1gate", num_envs=2, seed=0, device=dev)
        if dev == "cuda":
            ts, _ = wrap.reset()
            st = ts.env
            us0 = rng.uniform(-0.3, 0.3, (2, 20, 6)).astype(np.float32)
        mpc = CommandMPC(wrap, task="gate")
        s = st if dev == "cuda" else env_state_to(st, "cpu")
        sol = mpc.solve(planner_state(mpc.env, s).reshape(2, -1), torch.as_tensor(us0, device=dev),
                        mpc.default_args(s))
        sols[dev] = sol
    rel = float((sols["cuda"].cost.cpu() - sols["cpu"].cost).abs().max()
                / sols["cpu"].cost.abs().max())
    dus = float((sols["cuda"].us.cpu() - sols["cpu"].us).abs().max())
    say("mpc", f"one gate solve at 2 envs card vs CPU: cost {sols['cuda'].cost.tolist()} / "
        f"{sols['cpu'].cost.tolist()}, rel {rel:.3e} (bound {MPC_COST_REL:.0e}), plans' max diff "
        f"{dus:.3e}")
    if not rel <= MPC_COST_REL:
        raise AssertionError(f"MPC solve card vs CPU: cost rel {rel:.3e} > {MPC_COST_REL:.0e}")

    wrap, _ = make_mqe_env("go1gate", num_envs=SLICE_ENVS, seed=0, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    model = fit_command_model(wrap, n_steps=80)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    check_counts("fit_command_model 80 steps", launches, wrap.env, 80)
    add_counts(total, launches)
    say("mpc", f"fit_command_model on go1gate, {SLICE_ENVS} envs, 80 steps: {fit_s:.2f} s, "
        f"tau_v {model.tau_v:.4f} s, tau_w {model.tau_w:.4f} s, gain_v {model.gain_v:.4f}, "
        f"gain_w {model.gain_w:.4f}; launches {launches}; on {smi}")
    for task, mtask, cycles, mdl in (("go1gate", "gate", MPC_CYCLES, model),
                                     ("go1pushbox", "pushbox", PUSHBOX_CYCLES, None)):
        w = wrap if task == "go1gate" else make_mqe_env(task, num_envs=SLICE_ENVS, seed=0,
                                                         device="cuda")[0]
        mpc = CommandMPC(w, task=mtask, model=mdl)
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, _ = mpc.env.reset(Draws(gen))
        x0 = float(planner_state(mpc.env, state)[..., 0].mean())
        ms = mpc.init_mpc_state()
        state, ms, dt, launches = mpc_cycles(mpc, state, ms, cycles, gen)
        add_counts(total, launches)
        x1 = float(planner_state(mpc.env, state)[..., 0].mean())
        # the solve alone, from the last state and warm start
        args = mpc.default_args(state)
        xs0 = planner_state(mpc.env, state).reshape(SLICE_ENVS, -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MPC_SOLVES):
            sol = mpc.solve(xs0, ms.us, args)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) / MPC_SOLVES * 1e3
        cycle_ms = dt / cycles * 1e3
        say("mpc", f"CommandMPC {mtask} on {task}, {SLICE_ENVS} envs (H {mpc.cfg.horizon}, "
            f"{mpc.cfg.n_iters} iterations, {mpc.steps_per_knot} env steps a cycle): "
            f"{cycle_ms:.2f} ms/cycle over {cycles} cycles, {solve_ms:.2f} ms/solve "
            f"({MPC_SOLVES} alone), {SLICE_ENVS * cycles / dt:.1f} solves/s, mean x progress "
            f"{x1 - x0:.4f} m, mean cost {float(sol.cost.mean()):.3f}; launches {launches}; "
            f"on {smi}")
        if task == "go1gate" and not x1 - x0 > 0.1:
            raise AssertionError(f"MPC gate: mean x progress {x1 - x0:.4f} m after {cycles} cycles")
    reset_counts()
    t0 = time.perf_counter()
    out = run_mpc.main(["--task", "go1gate", "--num-envs", str(SLICE_ENVS), "--cycles", "5"])
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    check_counts("run_mpc.main", launches, wrap.env, 6 * 5)
    add_counts(total, launches)
    if not (np.isfinite(out["mean_x_progress_m"]) and out["solves_per_s"] > 0):
        raise AssertionError(f"run_mpc: {out}")
    say("mpc", f"run_mpc.main --num-envs {SLICE_ENVS} --cycles 5: {out} in {cli_s:.2f} s with "
        f"the build; launches {launches}; on {smi}")
    return total


# phase aos: (task, resynced control steps) at SLICE_ENVS envs, the AoS path
# (use_soa=False) against the default path; the card-vs-CPU AoS steps
AOS_TASKS = (("go1gate", 5), ("go1pushbox", 2), ("go1seesaw", 2))
AOS_CHECK_TASKS = ("go1gate", "go1pushbox", "go1seesaw")
# phase mesh: 2 ranks of parallel/worker.py on the one card, go1gate at
# SLICE_ENVS global envs, MESH_STEPS steps and one PPO update (PPOConfig's
# defaults); each rank's process is killed after RANK_TIMEOUT s
MESH_WORLD, MESH_STEPS, RANK_TIMEOUT = 2, 3, 600


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def kernels_per_step(step, dev):
    """CUDA kernels one call of `step` launches (torch.profiler's count)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        sync(dev)
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA)


def aos_vs_soa(smi, task, steps, num_envs=SLICE_ENVS, dev="cuda"):
    """`steps` control steps of `task`: from each AoS state one step of the
    default path (the kernels) and one of the AoS path with the same draws,
    resynced to the AoS state (tests/test_soa_episode.py's scheme). The
    worst difference per quantity is printed beside CHECK_TOLS, not held to
    it (the JAX package's own SoA-vs-AoS drop fails that bound on the CPU:
    touchdown transients; tests/test_torch_aos.py holds the AoS path to
    JAX's AoS instead). The kernels' counts must read 0 over every AoS step
    and 8 (16 with NPCs) over every default one. Returns the AoS launches
    and the AoS ms a step (after the first)."""
    from dataclasses import replace

    wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0, device=dev)
    env = wrap.env
    soa_scene = env.scene
    aos_scene = replace(soa_scene, use_soa=False)
    ts, _ = wrap.reset()
    cmds = torch.as_tensor(np.random.RandomState(1).uniform(
        -1, 1, (num_envs, wrap.controlled_agents, 3)).astype(np.float32), device=dev)
    worst = {f"{who}.{n}": 0.0 for who in ("agents", "npcs") for n in NAMES}
    over = {n: 0 for n in worst}
    aos_ms, soa_ms, aos_total = [], [], {name: 0 for name in KERNELS}
    for t in range(steps):
        given = {"fresh": env.fresh_state()}
        out = {}
        for label, sc in (("soa", soa_scene), ("aos", aos_scene)):
            env.scene = sc
            reset_counts()
            sync(dev)
            t0 = time.perf_counter()
            out[label] = wrap.step(ts, cmds, env.draws(given))[0]
            sync(dev)
            (aos_ms if label == "aos" else soa_ms).append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            if label == "aos":
                if any(counts.values()):
                    raise AssertionError(f"aos {task}: the AoS step launched kernels {counts}")
                add_counts(aos_total, counts)
            elif torch.device(dev).type == "cuda":
                check_counts(f"aos {task} default step", counts, env, 1)
        for who in ("agents", "npcs"):
            for n in NAMES:
                a = getattr(getattr(out["aos"].env.phys, who), n)
                b = getattr(getattr(out["soa"].env.phys, who), n)
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"aos {task}: non-finite {who}.{n}")
                if a.numel():
                    d = (a - b).abs().flatten(1).amax(dim=1)       # per env
                    worst[f"{who}.{n}"] = max(worst[f"{who}.{n}"], float(d.max()))
                    over[f"{who}.{n}"] += int((d > CHECK_TOLS[n]).sum())
        ts = out["aos"]                                            # resync
    env.scene = aos_scene
    n_k = kernels_per_step(lambda: wrap.step(ts, cmds), dev) if dev == "cuda" else 0
    env.scene = soa_scene
    n_k_soa = kernels_per_step(lambda: wrap.step(ts, cmds), dev) if dev == "cuda" else 0
    later, soa_later = aos_ms[1:] or aos_ms, soa_ms[1:] or soa_ms
    say("aos", f"{task} {num_envs} envs, {steps} resynced steps, AoS vs default (kernels) "
        "worst per quantity (measured, not gated; bound CHECK_TOLS, envs over it of "
        f"{num_envs * steps}): " + ", ".join(
            f"{n} {v:.3e} ({CHECK_TOLS[n.split('.')[1]]:.0e}, {over[n]})"
            for n, v in worst.items() if not (n.startswith("npcs") and env.scene.num_npcs == 0)))
    say("aos", f"{task}: AoS step {min(later):.2f}-{max(later):.2f} ms (first {aos_ms[0]:.2f}), "
        f"{n_k} CUDA kernels a step; default step {min(soa_later):.2f}-{max(soa_later):.2f} ms "
        f"(first {soa_ms[0]:.2f}), "
        f"{n_k_soa} kernels a step; hand-written kernels over the AoS steps {aos_total}; on {smi}")
    return aos_total, later, n_k


def phase_aos(smi, num_envs=SLICE_ENVS, dev="cuda"):
    """The AoS reference path (use_soa=False): against the default path on
    `AOS_TASKS` at full width, and one step card vs CPU at 2 envs (held to
    CHECK_TOLS) of `AOS_CHECK_TASKS`. Returns the hand-written kernels'
    launches over the AoS steps (all 0)."""
    from dataclasses import replace

    total = {name: 0 for name in KERNELS}
    for task, steps in AOS_TASKS:
        add_counts(total, aos_vs_soa(smi, task, steps, num_envs, dev)[0])
    if torch.device(dev).type != "cuda":
        return total
    for task in AOS_CHECK_TASKS:
        wrap_c, _ = make_mqe_env(task, num_envs=2, seed=0, device="cuda")
        wrap_h, _ = make_mqe_env(task, num_envs=2, seed=0, device="cpu")
        for w in (wrap_c, wrap_h):
            w.env.scene = replace(w.env.scene, use_soa=False)
        ts_c, _ = wrap_c.reset()
        acts = np.random.RandomState(5).uniform(
            -1, 1, (2, wrap_c.controlled_agents, 3)).astype(np.float32)
        reset_counts()
        compare_step(f"{task} AoS path, 2 envs", wrap_c, wrap_h, ts_c, acts,
                     {"fresh": wrap_c.env.fresh_state()})
        if any(read_counts().values()):
            raise AssertionError(f"aos {task}: the AoS card-vs-CPU step launched kernels")
        say("aos", f"{task} AoS path card vs CPU at CHECK_TOLS: ok, no kernel launched")
    return total


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world, args, backend="gloo", dev="cuda"):
    """`world` ranks of `python -m mqe_tpu_torch.parallel.worker` with `args`;
    each is waited for at most RANK_TIMEOUT s and killed after it. Any rank
    that fails fails the phase. Returns the ranks' printed results."""
    port = _free_port()
    env = dict(os.environ)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mqe_tpu_torch.parallel.worker", "--rank", str(r),
         "--world", str(world), "--port", str(port), "--backend", backend, "--device", dev,
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
                raise AssertionError(f"mesh: rank {r} of {world} timed out after "
                                     f"{RANK_TIMEOUT} s:\n{stderr[-3000:]}")
            if p.returncode != 0 or f"WORKER OK rank={r}" not in stdout:
                raise AssertionError(f"mesh: rank {r} of {world} ({backend}) failed, rc "
                                     f"{p.returncode}:\n{stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1].split(f"world={world} ")[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def ranks_order_update(tr, ts0, rollout, world, perm_state):
    """The one-process update of `rollout` with the ranks' summation order:
    rank r of `world` holds the envs' r-th contiguous block; every sum
    (return and advantage statistics, each minibatch's loss and gradient) is
    taken over each block's rows, as that rank takes it, and the blocks'
    sums added in rank order, as the all-reduce adds them. The same
    function as `tr._learn`, summed in another order; `perm_state` is the
    generator's state after the rollout. Returns the params."""
    from copy import copy

    from mqe_tpu_torch.parallel.mesh import EnvMesh

    cfg, E = tr.cfg, tr.E
    El = E // world
    blocks = [slice(r * El, (r + 1) * El) for r in range(world)]

    def gsum(x):                                   # x (T, E, ...)
        tot = None
        for b in blocks:
            s_ = x[:, b].contiguous().sum()
            tot = s_ if tot is None else tot + s_
        return tot

    def gmean(x):
        return gsum(x) / x.numel()

    _, traj, final_value, _, _ = rollout
    traj, final_value = tr._valuenorm(ts0, traj, final_value)
    advs, returns = tr._gae(traj, final_value)
    b_ = cfg.valuenorm_beta
    mean = gmean(returns)
    new_mean = b_ * ts0.ret_mean + (1 - b_) * mean
    new_var = b_ * ts0.ret_var + (1 - b_) * gmean((returns - mean) ** 2)
    ret = (returns - new_mean) / torch.sqrt(new_var + 1e-8)
    amean = gmean(advs)
    advs = (advs - amean) / (torch.sqrt(gmean((advs - amean) ** 2)) + 1e-8)
    local = [tr._batch({k: v[:, b].contiguous() for k, v in traj.items()},
                       advs[:, b].contiguous(), ret[:, b].contiguous()) for b in blocks]
    n_local = local[0]["adv"].shape[0]
    n = n_local * world
    mb = n // cfg.num_minibatches
    rank_view = copy(tr)
    rank_view.mesh = EnvMesh(rank=0, world=world)  # _loss reads the rank count only
    gen = torch.Generator(device=ts0.generator.device)
    gen.set_state(perm_state)
    params, opt = dict(ts0.params), ts0.opt_state
    A = tr.A
    for _ in range(cfg.ppo_epochs):
        perm = Draws(gen).permutation("perm", n, local[0]["adv"].device)
        for i in range(cfg.num_minibatches):
            idx = perm[i * mb:(i + 1) * mb]
            t_, rem = idx // (E * A), idx % (E * A)
            e_, j_ = rem // A, rem % A
            grads = None
            for r in range(world):
                mine = (e_ >= r * El) & (e_ < (r + 1) * El)
                rows = (t_ * (El * A) + (e_ - r * El) * A + j_)[mine]
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss, _ = rank_view._loss(leaves, {k: v[rows] for k, v in local[r].items()},
                                          rows=mb)
                g = torch.cat([x.reshape(-1) for x in
                               torch.autograd.grad(loss, list(leaves.values()))])
                grads = g if grads is None else grads + g
            out, at = {}, 0
            for k, v in params.items():
                out[k] = grads[at:at + v.numel()].view_as(v)
                at += v.numel()
            params, opt = tr.tx.step(params, out, opt)
    return params


def phase_mesh(smi, num_envs=SLICE_ENVS, dev="cuda", steps=MESH_STEPS, cfg=PPOConfig()):
    """The env axis split over MESH_WORLD ranks on the one card (gloo over
    CUDA tensors): go1gate's steps and one PPO update, gathered and held to
    the unsharded run in this process (obs and reward at 1e-4, dones equal,
    the end state at CHECK_TOLS, params at SGD_TOL); each rank's kernel
    launches equal the unsharded run's, each launch over half the robots.
    Then a one-rank NCCL group runs the same update (its gradients
    all-reduced through NCCL), params at SGD_TOL. Returns the launches of
    the ranks and of the unsharded runs."""
    nccl = torch.device(dev).type == "cuda"
    # the unsharded reference
    wrap, _ = make_mqe_env("go1gate", num_envs=num_envs, seed=0, device=dev)
    ts, _ = wrap.reset()
    acts = torch.as_tensor(np.random.RandomState(1).uniform(
        -1, 1, (num_envs, wrap.controlled_agents, 3)).astype(np.float32), device=dev)
    reset_counts()
    ref = []
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        ts, obs, rew, done, _ = wrap.step(ts, acts)
        ref.append((obs, rew, done))
    sync(dev)
    ref_steps_s = time.perf_counter() - t0
    ref_counts = read_counts()
    wrap_u, _ = make_mqe_env("go1gate", num_envs=num_envs, seed=0, device=dev)
    tr = PPOTrainer(wrap_u, cfg, seed=0)
    ts0 = tr.init_state()
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    rollout = tr._rollout(ts0)                     # update = _learn(ts, _rollout(ts))
    perm_state = ts0.generator.get_state()         # where the epochs' "perm" draws start
    ts_u, m_u = tr._learn(ts0, rollout)
    sync(dev)
    ref_update_s = time.perf_counter() - t0
    ref_upd_counts = read_counts()
    split_params = ranks_order_update(tr, ts0, rollout, MESH_WORLD, perm_state)
    order_diff = max(float((split_params[k] - v).abs().max()) for k, v in ts_u.params.items())
    total = {"mesh": {n: 0 for n in KERNELS}, "reference": dict(ref_counts)}
    add_counts(total["reference"], ref_upd_counts)

    upd = ["--rollout-len", str(cfg.rollout_len), "--num-minibatches", str(cfg.num_minibatches),
           "--ppo-epochs", str(cfg.ppo_epochs)]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh.npz")
        t0 = time.perf_counter()
        res = run_ranks(MESH_WORLD, ["--num-envs", str(num_envs), "--steps", str(steps),
                                     "--update", "--out", out] + upd, dev=dev)
        wall = time.perf_counter() - t0
        with np.load(out) as f:
            rec = dict(f)
        say("mesh", f"the ranks' TF32 default (turned off there): {bool(rec['tf32_default'])}")
        worst = {}
        for t, (obs, rew, done) in enumerate(ref):
            worst["obs"] = max(worst.get("obs", 0.0),
                               float(np.abs(rec[f"step/{t}/obs"] - obs.cpu().numpy()).max()))
            worst["reward"] = max(worst.get("reward", 0.0),
                                  float(np.abs(rec[f"step/{t}/reward"] - rew.cpu().numpy()).max()))
            if not np.array_equal(rec[f"step/{t}/done"], done.cpu().numpy()):
                raise AssertionError(f"mesh: step {t} dones differ from the unsharded run")
        for k in ("obs", "reward"):
            if not worst[k] <= 1e-4:
                raise AssertionError(f"mesh: {k} differs from the unsharded run by "
                                     f"{worst[k]:.3e} > 1e-4")
        for n in NAMES:
            d = float(np.abs(rec[f"step/end/agents/{n}"]
                             - getattr(ts.env.phys.agents, n).cpu().numpy()).max())
            worst[n] = d
            if not d <= CHECK_TOLS[n]:
                raise AssertionError(f"mesh: end state {n} differs by {d:.3e} > "
                                     f"{CHECK_TOLS[n]:.0e}")
        # the gate: the ranks' update against this process's update of the
        # same rollout summed in the ranks' order; beside it, measured, the
        # distance of both from the update summed in one process's order
        p_worst = max(float(np.abs(rec[f"update/params/{k}"] - v.cpu().numpy()).max())
                      for k, v in split_params.items())
        plain = {k: float(np.abs(rec[f"update/params/{k}"] - v.cpu().numpy()).max())
                 for k, v in ts_u.params.items()}
        if not p_worst <= SGD_TOL:
            top = sorted(plain.items(), key=lambda kv: -kv[1])[:5]
            raise AssertionError(f"mesh: sharded update params differ by {p_worst:.3e} > "
                                 f"{SGD_TOL:.0e} from the one-process update in the ranks' "
                                 f"order (from the one-process order: {top}); metrics "
                                 f"{ {k: float(v) for k, v in m_u.items()} } unsharded, "
                                 f"{ {k[15:]: float(v) for k, v in rec.items() if k.startswith('update/metrics')} } "
                                 "sharded")
        per_rank = {}
        for r in range(MESH_WORLD):
            per_rank[r] = {n: int(rec[f"launches/steps/{r}/{n}"]) for n in KERNELS}
            upd_r = {n: int(rec[f"launches/update/{r}/{n}"]) for n in KERNELS}
            if per_rank[r] != ref_counts or (nccl and upd_r != ref_upd_counts):
                raise AssertionError(f"mesh: rank {r} launched {per_rank[r]} over the steps "
                                     f"and {upd_r} over the update; the unsharded run "
                                     f"{ref_counts} and {ref_upd_counts}")
            add_counts(total["mesh"], per_rank[r])
            add_counts(total["mesh"], upd_r)
        steps_s, upd_s = rec["timing/steps_s"], rec["timing/update_s"]
        say("mesh", f"{MESH_WORLD} ranks (gloo, {dev}) x {num_envs // MESH_WORLD} envs of go1gate's "
            f"{num_envs}: {steps} steps gathered vs unsharded: " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items())
            + f"; PPO update params max diff {p_worst:.3e} from the one-process update "
            f"summed in the ranks' order (bound {SGD_TOL:.0e}); from it summed in one "
            f"process's order {max(plain.values()):.3e}, and the two orders in this "
            f"process {order_diff:.3e} apart (measured, not gated); reward mean "
            f"{float(rec['update/metrics/reward_mean']):.9f} vs {float(m_u['reward_mean']):.9f}, "
            f"loss {float(rec['update/metrics/loss']):.6f} vs {float(m_u['loss']):.6f}")
        say("mesh", f"kernel launches a rank over the {steps} steps {per_rank} (unsharded "
            f"{ref_counts}; each launch over {num_envs // MESH_WORLD * wrap.num_agents} robots, unsharded "
            f"{num_envs * wrap.num_agents}); over the update rank 0 "
            f"{ {n: int(rec[f'launches/update/0/{n}']) for n in KERNELS} } (unsharded "
            f"{ref_upd_counts}); ranks' steps {np.round(steps_s, 3).tolist()} s, updates "
            f"{np.round(upd_s, 3).tolist()} s (unsharded in this process {ref_steps_s:.3f} / "
            f"{ref_update_s:.3f} s); {wall:.1f} s for the ranks' processes; on {smi}")
        if nccl:
            out1 = os.path.join(tmp, "nccl.npz")
            run_ranks(1, ["--num-envs", str(num_envs), "--steps", "1", "--update",
                          "--out", out1] + upd, backend="nccl", dev=dev)
            with np.load(out1) as f:
                rec1 = dict(f)
            p1 = max(float(np.abs(rec1[f"update/params/{k}"] - v.cpu().numpy()).max())
                     for k, v in ts_u.params.items())
            if not p1 <= SGD_TOL:
                raise AssertionError(f"mesh: the NCCL one-rank update differs by {p1:.3e}")
            add_counts(total["mesh"], {n: int(rec1[f"launches/update/0/{n}"]) +
                                       int(rec1[f"launches/steps/0/{n}"]) for n in KERNELS})
            say("mesh", f"one rank, NCCL: the update's gradients all-reduced through NCCL, "
                f"params max diff {p1:.3e} from the unsharded update (bound {SGD_TOL:.0e})")
    return total


# phase goldens: the trajectory golden whose every step is checked on the card,
# and how long the CPU side, started at the beginning, may still take at its end
GOLDEN, GOLDEN_CPU_TIMEOUT = "drop", 600


def start_cpu_goldens(tmp):
    """The CPU side of phase goldens: tools/diag_drop_golden.py on the CPU
    (one thread, ~3 min), started in the background at the beginning so
    that the card's phases run meanwhile, at the lowest scheduling priority
    so that it takes no core the card's phases want; its results go to tmp."""
    log = open(os.path.join(tmp, "goldens_cpu.log"), "w")
    try:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "diag_drop_golden.py"), "--name", GOLDEN,
             "--device", "cpu", "--json", os.path.join(tmp, "goldens_cpu.json")],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    finally:
        log.close()
    os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
    return proc


def phase_goldens(smi, cpu, tmp):
    """Every step of the golden `GOLDEN` (tests/goldens/torch_golden_steps.npz)
    taken once by the port on the card (the kernels) from the golden's scan
    state before it, held to the scan's state after it under
    tests/test_torch_golden_steps.py's rule: within CHECK_TOLS (the values
    of tests/test_torch_env.py::TOLS), or at a step and quantity where JAX's
    own envelope is over them too (`golden_steps.judge`). The launches of
    the one-steps and of the replay are asserted as in `slice`. The replay
    from the start (every step from its own last) is printed, not gated: the
    landing is chaotic. The CPU side (`start_cpu_goldens`) is waited for:
    its replay is printed beside the card's, and a step excused on the card
    but not on the CPU is named."""
    rec = golden_steps.load()
    run = golden_steps.Golden(rec, GOLDEN, "cuda")
    steps = list(range(run.steps))
    reset_counts()
    t0 = time.perf_counter()
    diffs, _ = run.one_steps(steps)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_counts(f"goldens {GOLDEN} {run.steps} one-steps", launches, run.env, run.steps)
    unexcused, excused = golden_steps.judge(rec, GOLDEN, steps, diffs, CHECK_TOLS)
    if unexcused:
        raise AssertionError(f"goldens {GOLDEN}: over CHECK_TOLS where JAX's envelope is not: "
                             + golden_steps.describe(unexcused))
    held = {}  # field: (difference, step), the worst where JAX's envelope is within the bound
    for f, d in diffs.items():
        bound = CHECK_TOLS[golden_steps.BOUND_OF.get(f, f)]
        held[f] = max([(d[i], t) for i, t in enumerate(steps)
                       if rec[f"{GOLDEN}/envelope/{f}"][t] <= bound], default=(0.0, None))
    say("goldens", f"{GOLDEN}: {run.steps} one-steps on the card from the golden's scan states "
        f"in {seconds:.2f} s, launches {launches}; every step within CHECK_TOLS or excused by "
        f"JAX's envelope; excused: {golden_steps.describe(excused)}; worst where JAX's envelope "
        "is within CHECK_TOLS: " + ", ".join(
            f"{f} {v:.3e} at step {t} ({CHECK_TOLS[golden_steps.BOUND_OF.get(f, f)]:.0e})"
            for f, (v, t) in held.items()) + f"; on {smi}")
    reset_counts()
    replay = run.replay()
    replayed = read_counts()
    check_counts(f"goldens {GOLDEN} replay", replayed, run.env, run.steps)
    add_counts(launches, replayed)
    try:
        cpu.wait(timeout=GOLDEN_CPU_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"goldens: the CPU side still ran {GOLDEN_CPU_TIMEOUT} s after the "
                             "card's phases") from None
    out = os.path.join(tmp, "goldens_cpu.json")
    if not os.path.exists(out):
        with open(os.path.join(tmp, "goldens_cpu.log")) as f:
            raise AssertionError(f"goldens: the CPU side failed (rc {cpu.returncode}):\n"
                                 + f.read()[-3000:])
    with open(out) as f:
        host = json.load(f)
    host_breaks = {(t, f) for t, f, *_ in host["excused"] + host["unexcused"]}
    card_only = [(t, f) for t, f, *_ in excused if (t, f) not in host_breaks]
    say("goldens", f"{GOLDEN}: excused on the card but within TOLS on the CPU: "
        + (", ".join(f"step {t} {f}" for t, f in card_only) or "none")
        + f"; the CPU's breaks (tools/diag_drop_golden.py): excused "
        f"{golden_steps.describe(host['excused'])}, unexcused "
        f"{golden_steps.describe(host['unexcused'])}")
    say("goldens", f"{GOLDEN}: the replay from the start (measured, not gated), largest "
        f"|base pos - golden| over the {run.steps} steps: card {replay.max():.5f} m (step "
        f"{int(replay.argmax())}), CPU {max(host['replay']):.5f} m (step "
        f"{int(np.argmax(host['replay']))}); replay launches {replayed}; on {smi}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    say("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        cpu = start_cpu_goldens(tmp)
        try:
            run_phases(kind, smi, cpu, tmp)
        finally:
            if cpu.poll() is None:
                cpu.kill()
                cpu.wait()


def run_phases(kind, smi, cpu, tmp):
    """Every phase after `device`, then the kernels' JSON line and the result."""
    built = fused_step.library()
    say("build", f"fused_step in {built.seconds:.2f} s ({'from the cache' if built.from_cache else 'built'}): "
        f"{built.path}")
    ptxas = ptxas_usage(built.ptxas_log)
    for name, use in ptxas.items():
        say("build", f"ptxas {name}: {use['registers']} registers, {use['stack']} B stack, "
            f"{use['spill_stores']} B spill stores, {use['spill_loads']} B spill loads")
    if set(ptxas) != set(KERNELS):
        raise AssertionError(f"ptxas reported {sorted(ptxas)}, expected {sorted(KERNELS)}")
    step = ptxas["fused_step_kernel"]
    if step["stack"] or step["spill_stores"] or step["spill_loads"]:
        raise AssertionError(f"fused_step_kernel has a stack frame or spills: {step}")

    entries = [phase_kernel(smi), phase_fk(smi), phase_fk_full(smi)]
    for entry in entries:
        entry["ptxas"] = ptxas[entry["name"]]
    for task in ENV_DICT:
        phase_check(task)
    phase_check("go1wrestling", draw=2)
    by_task = {task: phase_slice(smi, task, steps=steps) for task, steps in SLICES.items()}
    by_task["train"] = phase_train(smi)
    by_task["locomotion"] = phase_locomotion(smi)
    by_task["curriculum"] = phase_curriculum(smi)
    by_task["camera"] = phase_camera(smi)
    by_task["mpc"] = phase_mpc(smi)
    by_task["aos"] = phase_aos(smi)
    mesh = phase_mesh(smi)
    by_task["mesh"], by_task["mesh_reference"] = mesh["mesh"], mesh["reference"]
    by_task["goldens"] = phase_goldens(smi, cpu, tmp)
    for entry in entries:
        entry["launches"] = sum(counts[entry["name"]] for counts in by_task.values())
        entry["launches_by_task"] = {t: counts[entry["name"]] for t, counts in by_task.items()}
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
