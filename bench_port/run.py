#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, mqe_tpu_torch: one run of one
cell of BENCHMARK.json, its result as the last line of standard output.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The
program's kernel library is built by nvcc into build/ of the checkout at its
first run there; torch's and Triton's caches are kept in build/bench_port/.
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_port", sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

from portbench.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
