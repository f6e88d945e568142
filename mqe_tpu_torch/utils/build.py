"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers), so a
build is one `nvcc` call of a few seconds. The shared library goes to
`<repo>/build/mqe_tpu_torch/lib<name>_<hash>.so`, where the hash covers the
source and the flags: an unchanged source is built once and then loaded from
that file. Nothing is built when a module is imported; the first launch
builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

from mqe_tpu_torch import REPO_ROOT

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "mqe_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: str
    from_cache: bool
    seconds: float       # time to build (or find) and load
    ptxas_log: str       # `-Xptxas -v` report: registers, spill stores/loads


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of mqe_tpu_torch are built from source at first use"
    )


def load_library(name: str) -> Built:
    """Build `csrc/<name>.cu` if its library is not on disk yet, and load it."""
    t0 = time.perf_counter()
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    log_path = path[:-3] + ".ptxas.txt"
    from_cache = os.path.exists(path)
    if not from_cache:
        nvcc = find_nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    return Built(
        lib=ctypes.CDLL(path), path=path, from_cache=from_cache,
        seconds=time.perf_counter() - t0, ptxas_log=log,
    )
