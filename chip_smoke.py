"""Smoke run of the PyTorch/CUDA port (mqe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. device  - the card's name and power limit;
  2. build   - nvcc builds csrc/fused_step.cu (all three entry points) into
               build/mqe_tpu_torch/, with ptxas' registers, stack and spills
               of each kernel (the step kernel must have no stack or spills);
  3. kernel  - the CUDA substep kernel against its plain PyTorch version
               (physics/soa.py::step_actor) on the card, six cases, at the
               tolerances of tests/test_pallas_step.py; then its device time
               per launch at the shapes of the slices (torch.profiler): the
               robots' launch (B = 8192) and the NPCs' (B = 4096 boxes, and
               welded seesaws), each beside the plain version's time and the
               bound of the card;
  4. fk      - the sphere-FK kernel against soa.fk_spheres at the slice's
               shape, go1 at B = 8192, and at B = 37 and 1 (and two NPC
               models at 37 and 1), at the tolerance of
               tests/test_torch_soa.py::test_fk_matches_jax; its time and
               bound likewise, and its floor: the device time at B = 1;
  5. fk_full - the full-FK kernel against soa.fk_full for the box and the
               seesaw at B = 4096, the NPC shapes of the slices, and at
               4095, 37 and 1 (the ball at 37 and 1), at the same tolerance;
               its time, bound and B = 1 floor for both;
  6. check   - one control step at 2 envs of go1gate, go1plane, go1pushbox
               and go1seesaw on the card (kernels) and on the CPU (plain
               versions) from the same state, compared, NPCs included;
  7. slice   - go1gate, then go1pushbox and go1seesaw, at 4096 envs through
               make_mqe_env -> reset -> step: 1 warm step and 20 timed steps
               each. Every kernel's count is set to 0 just before a task's
               run and read just after: go1gate launches the step kernel and
               the sphere FK 8 times a step; an NPC task launches the step
               kernel 16 times (robots, then NPCs), the sphere FK 8 and the
               full FK 8.
Then the kernels' JSON line (`launches`: the sum over the three runs, by task
under `launches_by_task`), the card's name and power limit, and the result
line `{"ok": true, "device": {...}}`. Any failed phase raises (exit code 1);
with no CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mqe_tpu_torch.envs.registry import make_mqe_env  # noqa: E402
from mqe_tpu_torch.physics import fused_step, soa  # noqa: E402
from mqe_tpu_torch.physics.model import go1_model, load_model  # noqa: E402
from mqe_tpu_torch.utils.convert import env_state_to  # noqa: E402
from mqe_tpu_torch.utils.opcount import count_ops  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# without tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# tolerances of tests/test_pallas_step.py (pos, quat, lin_vel, ang_vel, q, qd)
NAMES = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
TOLS = (1e-6, 1e-6, 1e-5, 1e-5, 1e-6, 1e-4)
FK_TOL = 1e-6  # tests/test_torch_soa.py::test_fk_matches_jax

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


def device_ms(fn, kernel, n):
    """Mean device milliseconds of the kernel named `kernel` over n calls of
    fn(), from torch.profiler: the kernel's own time, without the host's
    launch overhead, which exceeds it. The mean is over the launches the
    profiler recorded, which may miss one of many."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if kernel in ev.key]
    count = sum(ev.count for ev in evs)
    if not n // 2 <= count <= n:
        raise AssertionError(f"the profiler saw {count} launches of {kernel}, made {n}")
    return sum(ev.self_device_time_total for ev in evs) / count / 1e3


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


def timing(phase, label, launch, kernel, call, plain, ins, outs, smi, floor=None):
    """Time one kernel at one shape: its device time per launch into
    preallocated outputs (`launch`), the wrapper's time per call (checks,
    allocation, launch), the plain version's, and the card's bound for the
    work. Inputs stay in L2 between launches, as they do on the main path,
    where the stage before just wrote them. `floor`, where given, launches
    the same kernel at B = 1: its device time is the least a launch of it
    takes. Returns the JSON fields."""
    ms = device_ms(launch, kernel, 200)
    wrapper_ms = cuda_ms(call, 50)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    b_ms, b_by, nb, bytes_ms, ops_ms = bound(ins, outs, count_ops(plain))
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, wrapper_ms=wrapper_ms)
    floor_txt = ""
    if floor is not None:
        out["floor_ms"] = device_ms(floor, kernel, 200)
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


def phase_kernel(smi):
    go1 = go1_model()
    # case 1: the slice's shape, go1 at B = 8192 with payload and com shift
    B = 8192
    args, payload, cshift = rand_state(go1, B, seed=0)
    ref = soa.step_actor(go1, *args, payload=payload, com_shift=cshift)
    out = fused_step.step_actor_kernel(go1, *args, payload=payload, com_shift=cshift)
    torch.cuda.synchronize()
    max_err = compare("kernel", "go1 B=8192 payload+com_shift", ref, out)

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

    # cases 5-6: the NPC launches of the slices at their shape, B = 4096: the
    # free box, and the seesaw welded in both flags (model and argument)
    npc_cases = {name: npc_step_inputs(name, rf, 4096, seed=21)
                 for name, rf in (("box", True), ("seesaw", False))}
    for name, (m, a, w) in npc_cases.items():
        rf = m.root_free
        max_err = max(max_err, compare(
            "kernel", f"{name} B=4096 NPC launch (root_free={rf})",
            soa.step_actor(m, *a, extra_wrench=w, root_free=rf),
            fused_step.step_actor_kernel(m, *a, extra_wrench=w, root_free=rf)))

    # time at the slices' shapes
    entry = dict(
        name="fused_step_kernel", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/pallas_step.py:141", max_abs_err=max_err, library_ms=None,
        **timing("kernel", f"go1 B={B}",
                 lambda: fused_step.launch_step(go1, *args, payload, cshift, None, out, 0.0025,
                                                True),
                 "fused_step_kernel",
                 lambda: fused_step.step_actor_kernel(go1, *args, payload=payload,
                                                      com_shift=cshift),
                 lambda: soa.step_actor(go1, *args, payload=payload, com_shift=cshift),
                 (*args, payload, cshift), out, smi),
    )
    entry["npc"] = {}
    for name, (m, a, w) in npc_cases.items():
        rf = m.root_free
        nout = fused_step.step_actor_kernel(m, *a, extra_wrench=w, root_free=rf)
        entry["npc"][name] = timing(
            "kernel", f"{name} B=4096 NPC launch",
            lambda: fused_step.launch_step(m, *a, None, None, w, nout, 0.0025, rf),
            "fused_step_kernel",
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
    B = 8192
    names, tols = ("sph_x", "sph_v"), (FK_TOL, FK_TOL)
    max_err = 0.0
    for name, sizes in (("go1", (B, 37, 1)), ("seesaw", (37, 1)), ("ball", (37, 1))):
        m = go1 if name == "go1" else load_model(name, root_free=True)
        for b in sizes:
            a = fk_state(m, b, seed=5 if b == B else 6)
            out = fused_step.fk_spheres_kernel(m, *a)
            torch.cuda.synchronize()
            max_err = max(max_err, compare("fk", f"{name} B={b} ({fk_geometry_txt(m, b)})",
                                           soa.fk_spheres(m, *a), out, names, tols))
    args = fk_state(go1, B, seed=5)
    out = fused_step.fk_spheres_kernel(go1, *args)
    one = fk_state(go1, 1, seed=6)
    one_out = fused_step.fk_spheres_kernel(go1, *one)
    return dict(
        name="fk_spheres_kernel", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/soa.py:546", max_abs_err=max_err, library_ms=None,
        **timing("fk", f"go1 B={B}", lambda: fused_step.launch_fk(go1, *args, *out),
                 "fk_spheres_kernel", lambda: fused_step.fk_spheres_kernel(go1, *args),
                 lambda: soa.fk_spheres(go1, *args), args, out, smi,
                 floor=lambda: fused_step.launch_fk(go1, *one, *one_out)),
    )


FK_FULL_NAMES = ("Rw", "pw", "vw", "sph_x", "sph_v")


def phase_fk_full(smi):
    """The full FK of the NPCs at the slices' shape, B = 4096 boxes (free)
    and welded seesaws, and at ragged and small B; the ball at 37 and 1.
    The JSON entry carries the box's numbers, the go1pushbox slice's; the
    seesaw's are under "seesaw"."""
    B = 4096
    entry, worst = {}, 0.0
    for name, root_free, sizes in (("box", True, (B, 4095, 37, 1)),
                                   ("seesaw", False, (B, 4095, 37, 1)), ("ball", True, (37, 1))):
        m = load_model(name, root_free=root_free)
        for b in sizes:
            a = fk_state(m, b, seed=5)
            out = fused_step.fk_full_kernel(m, *a)
            torch.cuda.synchronize()
            worst = max(worst, compare("fk_full", f"{name} B={b} ({fk_geometry_txt(m, b)})",
                                       soa.fk_full(m, *a), out, FK_FULL_NAMES, (FK_TOL,) * 5))
        if name == "ball":
            continue
        args = fk_state(m, B, seed=5)
        out = fused_step.fk_full_kernel(m, *args)
        one = fk_state(m, 1, seed=5)
        one_out = fused_step.fk_full_kernel(m, *one)
        t = timing("fk_full", f"{name} B={B}",
                   lambda: fused_step.launch_fk_full(m, *args, out), "fk_full_kernel",
                   lambda: fused_step.fk_full_kernel(m, *args),
                   lambda: soa.fk_full(m, *args), args, out, smi,
                   floor=lambda: fused_step.launch_fk_full(m, *one, one_out))
        if name == "box":
            entry.update(t)
        else:
            entry["seesaw"] = t
    return dict(
        name="fk_full_kernel", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/soa.py:556", max_abs_err=worst, library_ms=None, **entry,
    )


def phase_check(task):
    """One step at 2 envs: kernels on the card vs plain on the CPU."""
    wrap_c, _ = make_mqe_env(task, num_envs=2, seed=0, device="cuda")
    wrap_h, _ = make_mqe_env(task, num_envs=2, seed=0, device="cpu")
    ts_c, _ = wrap_c.reset()
    ts_h = env_state_to(ts_c, "cpu")
    acts = np.random.RandomState(5).uniform(-1, 1, (2, wrap_c.num_agents, 3)).astype(np.float32)
    fresh = wrap_c.env.fresh_state()  # the reset state, should an env reset
    out_c = wrap_c.step(ts_c, torch.as_tensor(acts, device="cuda"),
                        draws=wrap_c.env.draws({"fresh": fresh}))
    out_h = wrap_h.step(ts_h, torch.as_tensor(acts),
                        draws=wrap_h.env.draws({"fresh": env_state_to(fresh, "cpu")}))
    worst = {}
    for who in ("agents", "npcs"):
        for n in NAMES:
            a = getattr(getattr(out_c[0].env.phys, who), n).cpu()
            b = getattr(getattr(out_h[0].env.phys, who), n)
            worst[f"{who}.{n}"] = float((a - b).abs().max()) if a.numel() else 0.0
    obs_d = float((out_c[1].cpu() - out_h[1]).abs().max())
    rew_d = float((out_c[2].cpu() - out_h[2]).abs().max())
    if bool(out_h[3].any()):
        raise AssertionError("an env reset in the check step; the comparison needs none")
    # the per-step bounds of tests/test_soa_episode.py between two paths
    tols = dict(pos=1e-6, quat=1e-5, lin_vel=3e-4, ang_vel=5e-3, q=2e-4, qd=2e-2)
    for n, v in worst.items():
        tol = tols[n.split(".")[1]]
        if not v <= tol:
            raise AssertionError(f"check {task} {n}: card vs CPU {v:.3e} > {tol:.0e}")
    if not (obs_d <= 1e-4 and rew_d <= 1e-4):
        raise AssertionError(f"check {task} obs {obs_d:.3e} / reward {rew_d:.3e} > 1e-4")
    say("check", f"{task} 2 envs, card vs CPU after one step: "
        + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
        + f", obs {obs_d:.3e}, reward {rew_d:.3e}")


KERNELS = {"fused_step_kernel": fused_step.step_actor_kernel,
           "fk_spheres_kernel": fused_step.fk_spheres_kernel,
           "fk_full_kernel": fused_step.fk_full_kernel}
SLICES = ("go1gate", "go1pushbox", "go1seesaw")


def phase_slice(smi, task, num_envs=4096, steps=20):
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    wrap, _ = make_mqe_env(task, num_envs=num_envs, seed=0, device="cuda")
    ts, obs = wrap.reset()
    torch.cuda.synchronize()
    say("slice", f"{task} {num_envs} envs built and reset, obs {tuple(obs.shape)}")
    cmds = torch.as_tensor(
        np.random.RandomState(1).uniform(-1, 1, (num_envs, wrap.num_agents, 3)).astype(np.float32),
        device="cuda")
    ts, obs, rew, done, info = wrap.step(ts, cmds)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ts, obs, rew, done, info = wrap.step(ts, cmds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, wrapper in KERNELS.items()}
    substeps = wrap.env.decimation * wrap.env.subiters
    npc = wrap.env.scene.num_npcs > 0
    expect = {"fused_step_kernel": substeps * (2 if npc else 1), "fk_spheres_kernel": substeps,
              "fk_full_kernel": substeps if npc else 0}
    for name, n in launches.items():
        if n != expect[name] * (steps + 1):
            raise AssertionError(f"{task}: {name} launched {n} times in {steps + 1} steps, "
                                 f"expected {expect[name]} a step")
    npcs = ts.env.phys.npcs
    for name, t, shape in (("obs", obs, (num_envs, wrap.num_agents, wrap.obs_dim)),
                           ("reward", rew, (num_envs, wrap.num_agents)),
                           ("npc pos", npcs.pos, (num_envs, wrap.num_npcs, 3)),
                           ("npc q", npcs.q, tuple(npcs.qd.shape))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{task} {name}: shape {tuple(t.shape)} (expected {shape}) "
                                 "or non-finite")
    sps = num_envs * steps / dt
    say("slice", f"{task}: {steps} steps in {dt:.3f} s: {sps:.1f} env-steps/s, "
        f"{dt / steps * 1e3:.2f} ms/step, kernel launches {launches} in {steps + 1} steps "
        f"({expect} a step), resets {int(done.sum())} in the last step; on {smi}")
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
    for task in ("go1gate", "go1plane", "go1pushbox", "go1seesaw"):
        phase_check(task)
    by_task = {task: phase_slice(smi, task) for task in SLICES}
    for entry in entries:
        entry["launches"] = sum(counts[entry["name"]] for counts in by_task.values())
        entry["launches_by_task"] = {t: counts[entry["name"]] for t, counts in by_task.items()}
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
