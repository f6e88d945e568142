"""mqe_tpu_torch: the PyTorch + CUDA port of mqe_tpu.

The JAX package `mqe_tpu` beside this one is the reference; this package
imports nothing of it (nor `jax`), and reads its asset data files in place by
path. Entry points run on the CUDA device unless the caller passes
`device="cpu"`; hand-written CUDA kernels live in `csrc/` and are built at
first use (utils/build.py).
"""
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS_DIR = os.path.join(REPO_ROOT, "mqe_tpu", "assets")

__version__ = "0.1.0"


def default_device() -> str:
    """Device an entry point uses when the caller names none."""
    return "cuda"
