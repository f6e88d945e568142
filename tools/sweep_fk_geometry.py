"""Device time of the FK kernels against the robots a block takes, on one GPU.

    python3 tools/sweep_fk_geometry.py [--out FILE]

At the main path's launches (go1's 8192 robots through `fk_spheres_kernel`,
4096 boxes and 4096 welded seesaws through `fk_full_kernel`), and at go1's
launch with no spheres (the tree walk alone), it launches
each kernel at several robots a block (`robots_per_block` of
`physics/fused_step.py::launch_fk` and `launch_fk_full`) and prints the
device ms a launch (torch.profiler, as chip_smoke.py times), the blocks and
the shared memory of each, marking the robots a block that
`fk_robots_per_block` picks.
Outputs are checked against the plain versions at every geometry. With
--out the table is also written as JSON.
"""
import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import FK_TOL, device_ms, fk_state, smi_name_power  # noqa: E402
from mqe_tpu_torch.physics import fused_step, soa  # noqa: E402
from mqe_tpu_torch.physics.model import load_model  # noqa: E402

# (kernel, model, root_free, B); "go1-no-spheres" is go1 with its spheres
# taken away: the kernel then runs only its tree walk (phase 1)
LAUNCHES = (("fk_spheres", "go1", True, 8192), ("fk_spheres", "go1-no-spheres", True, 8192),
            ("fk_full", "box", True, 4096), ("fk_full", "seesaw", False, 4096))


def model(name, root_free):
    if name == "go1-no-spheres":
        m = load_model("go1", root_free=root_free)
        return dataclasses.replace(m, sph_body=m.sph_body[:0], sph_pos=m.sph_pos[:0],
                                   sph_radius=m.sph_radius[:0], sph_tags=())
    return load_model(name, root_free=root_free)


ROBOTS = (1, 2, 4, 6, 7, 8, 10, 12, 15, 16, 32, 64, 128)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep_fk_geometry: no CUDA device")
    smi = smi_name_power()
    rows = []
    for kernel, name, root_free, B in LAUNCHES:
        m = model(name, root_free)
        ll, ns = fused_step.lanes_log2(m), len(m.sph_tags)
        picked = fused_step.fk_robots_per_block(ll, ns, B)
        a = fk_state(m, B, seed=5)
        # soa.fk_spheres takes no model without spheres: nothing to compare there
        ref = getattr(soa, kernel)(m, *a) if ns else (torch.empty((B, 0, 3)),) * 2
        out = tuple(torch.empty_like(t, device="cuda") for t in ref)
        launch = fused_step.launch_fk if kernel == "fk_spheres" else fused_step.launch_fk_full
        for R in ROBOTS:
            if (R << ll) > fused_step.THREADS or fused_step.fk_shared_bytes(R, ns) > fused_step.SHARED_LIMIT:
                continue
            go = (lambda: launch(m, *a, *out, robots_per_block=R)) if kernel == "fk_spheres" \
                else (lambda: launch(m, *a, out, robots_per_block=R))
            go()
            torch.cuda.synchronize()
            err = max((float((x - y).abs().max()) for x, y in zip(ref, out) if x.numel()),
                      default=0.0)
            if err > FK_TOL:
                raise AssertionError(f"{kernel} {name} R={R}: max diff {err:.3e} > {FK_TOL:.0e}")
            ms = device_ms(go, f"{kernel}_kernel", 200)
            row = dict(kernel=kernel, model=name, B=B, robots_per_block=R, blocks=-(-B // R),
                       shared_bytes=fused_step.fk_shared_bytes(R, ns), ms=ms, max_abs_err=err,
                       picked=R == picked)
            rows.append(row)
            print(f"{kernel} {name} B={B}: {R:3d} robots a block, {row['blocks']:5d} blocks, "
                  f"{row['shared_bytes']:5d} B shared: {ms:.4f} ms/launch"
                  f"{'  <- fk_robots_per_block' if row['picked'] else ''}", flush=True)
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
