"""Smoke run of the PyTorch/CUDA port (mqe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. device  - the card's name and power limit;
  2. build   - nvcc builds csrc/fused_step.cu (both entry points) into
               build/mqe_tpu_torch/, with ptxas' registers, stack and spills;
  3. kernel  - the CUDA substep kernel against its plain PyTorch version
               (physics/soa.py::step_actor) on the card, four cases, at the
               tolerances of tests/test_pallas_step.py; then its device time
               per launch at the slice's shape (torch.profiler) beside the
               plain version's time and the bound of the card;
  4. fk      - the sphere-FK kernel against soa.fk_spheres at the slice's
               shape (and two NPC models), at the tolerance of
               tests/test_torch_soa.py::test_fk_matches_jax; its time and
               bound likewise;
  5. check   - one go1gate control step at 2 envs on the card (kernels) and
               on the CPU (plain versions) from the same state, compared;
  6. slice   - go1gate at 4096 envs through make_mqe_env -> reset -> step:
               1 warm step and 20 timed steps, each kernel launched 8 times
               a step.
Then the kernels' JSON line, the card's name and power limit, and the result
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

    # time at the slice's shape: the kernel's device time into preallocated
    # outputs, the wrapper's time per call (checks, allocation, launch), and
    # the plain version; inputs stay in L2 between launches (10.8 MB < 50 MB),
    # as they do on the main path, where the contact stage just wrote them
    launch = lambda: fused_step.launch_step(go1, *args, payload, cshift, None, out, 0.0025, True)
    ms = device_ms(launch, "fused_step_kernel", 200)
    wrapper_ms = cuda_ms(
        lambda: fused_step.step_actor_kernel(go1, *args, payload=payload, com_shift=cshift), 50)
    plain = lambda: soa.step_actor(go1, *args, payload=payload, com_shift=cshift)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    b_ms, b_by, nb, bytes_ms, ops_ms = bound((*args, payload, cshift), out, count_ops(plain))
    say("kernel", f"B={B}: kernel {ms:.4f} ms/launch on the device (wrapper {wrapper_ms:.4f} "
        f"ms/call), plain {plain_ms:.3f} ms/call; bound {b_ms:.4f} ms by {b_by} "
        f"(bytes {nb} -> {bytes_ms:.4f} ms, ops -> {ops_ms:.4f} ms); on {smi}")
    return dict(
        name="fused_step", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/pallas_step.py:141", max_abs_err=max_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def fk_state(m, B, seed):
    """Inputs drawn as tests/test_torch_soa.py::test_fk_matches_jax draws them."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, 3) * 0.1, rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0]),
            rng.randn(B, 3) * 0.3, rng.randn(B, 3) * 0.3, rng.randn(B, m.nq) * 0.2,
            rng.randn(B, m.nq) * 0.5]
    arrs[1] /= np.linalg.norm(arrs[1], axis=1, keepdims=True)
    return [torch.as_tensor(a.astype(np.float32), device="cuda") for a in arrs]


def phase_fk(smi):
    go1 = go1_model()
    B = 8192
    args = fk_state(go1, B, seed=5)
    ref = soa.fk_spheres(go1, *args)
    out = fused_step.fk_spheres_kernel(go1, *args)
    torch.cuda.synchronize()
    names, tols = ("sph_x", "sph_v"), (FK_TOL, FK_TOL)
    max_err = compare("fk", f"go1 B={B}", ref, out, names, tols)
    for name in ("seesaw", "ball"):
        m = load_model(name, root_free=True)
        a = fk_state(m, 37, seed=6)
        compare("fk", f"{name} B=37", soa.fk_spheres(m, *a), fused_step.fk_spheres_kernel(m, *a),
                names, tols)

    launch = lambda: fused_step.launch_fk(go1, *args, *out)
    ms = device_ms(launch, "fk_spheres_kernel", 200)
    wrapper_ms = cuda_ms(lambda: fused_step.fk_spheres_kernel(go1, *args), 50)
    plain = lambda: soa.fk_spheres(go1, *args)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    b_ms, b_by, nb, bytes_ms, ops_ms = bound(args, out, count_ops(plain))
    say("fk", f"B={B}: kernel {ms:.4f} ms/launch on the device (wrapper {wrapper_ms:.4f} "
        f"ms/call), plain {plain_ms:.3f} ms/call; bound {b_ms:.4f} ms by {b_by} "
        f"(bytes {nb} -> {bytes_ms:.4f} ms, ops -> {ops_ms:.4f} ms); on {smi}")
    return dict(
        name="fk_spheres", route="cuda", source="mqe_tpu_torch/csrc/fused_step.cu",
        replaces="mqe_tpu/physics/soa.py:546",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
    )


def phase_check():
    """One go1gate step at 2 envs: kernel on the card vs plain on the CPU."""
    wrap_c, _ = make_mqe_env("go1gate", num_envs=2, seed=0, device="cuda")
    wrap_h, _ = make_mqe_env("go1gate", num_envs=2, seed=0, device="cpu")
    ts_c, _ = wrap_c.reset()
    ts_h = env_state_to(ts_c, "cpu")
    acts = np.random.RandomState(5).uniform(-1, 1, (2, 2, 3)).astype(np.float32)
    fresh = wrap_c.env.fresh_state()  # the reset state, should an env reset
    out_c = wrap_c.step(ts_c, torch.as_tensor(acts, device="cuda"),
                        draws=wrap_c.env.draws({"fresh": fresh}))
    out_h = wrap_h.step(ts_h, torch.as_tensor(acts),
                        draws=wrap_h.env.draws({"fresh": env_state_to(fresh, "cpu")}))
    worst = {}
    for n in NAMES:
        a = getattr(out_c[0].env.phys.agents, n).cpu()
        b = getattr(out_h[0].env.phys.agents, n)
        worst[n] = float((a - b).abs().max())
    obs_d = float((out_c[1].cpu() - out_h[1]).abs().max())
    rew_d = float((out_c[2].cpu() - out_h[2]).abs().max())
    if bool(out_h[3].any()):
        raise AssertionError("an env reset in the check step; the comparison needs none")
    # the per-step bounds of tests/test_soa_episode.py between two paths
    tols = dict(pos=1e-6, quat=1e-5, lin_vel=3e-4, ang_vel=5e-3, q=2e-4, qd=2e-2)
    for n, tol in tols.items():
        if not worst[n] <= tol:
            raise AssertionError(f"check {n}: card vs CPU {worst[n]:.3e} > {tol:.0e}")
    if not (obs_d <= 1e-4 and rew_d <= 1e-4):
        raise AssertionError(f"check obs {obs_d:.3e} / reward {rew_d:.3e} > 1e-4")
    say("check", "go1gate 2 envs, card vs CPU after one step: "
        + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
        + f", obs {obs_d:.3e}, reward {rew_d:.3e}")


KERNELS = {"fused_step": fused_step.step_actor_kernel, "fk_spheres": fused_step.fk_spheres_kernel}


def phase_slice(smi, num_envs=4096, steps=20):
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    wrap, _ = make_mqe_env("go1gate", num_envs=num_envs, seed=0, device="cuda")
    ts, obs = wrap.reset()
    torch.cuda.synchronize()
    say("slice", f"go1gate {num_envs} envs built and reset, obs {tuple(obs.shape)}")
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
    per_step = wrap.env.decimation * wrap.env.subiters
    for name, n in launches.items():
        if n != per_step * (steps + 1):
            raise AssertionError(
                f"{name} launched {n} times in {steps + 1} steps, expected {per_step} a step")
    for name, t, shape in (("obs", obs, (num_envs, wrap.num_agents, wrap.obs_dim)),
                           ("reward", rew, (num_envs, wrap.num_agents))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (expected {shape}) or non-finite")
    sps = num_envs * steps / dt
    say("slice", f"{steps} steps in {dt:.3f} s: {sps:.1f} env-steps/s, {dt / steps * 1e3:.2f} ms/step, "
        f"kernel launches {launches} ({per_step} a step each), resets {int(done.sum())} in the last "
        f"step; on {smi}")
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
    for line in built.ptxas_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "stack frame")):
            say("build", "ptxas " + line.strip())

    entries = [phase_kernel(smi), phase_fk(smi)]
    phase_check()
    launches = phase_slice(smi)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
