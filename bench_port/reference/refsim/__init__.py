"""refsim: the benchmark's plain reference of the port's step and update.

A frozen copy of the plain PyTorch path of `mqe_tpu_torch` (physics with the
plain versions of the three kernels, contact, locomotion chain, env, task
wrappers, PPO and MAT), taken when the benchmark was written and not
updated with the program. It imports nothing of the program: every module
here imports only `refsim`, torch and numpy. Asset data files are read in
place by path from `mqe_tpu/assets/` of the checkout, as the program reads
them.
"""
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ASSETS_DIR = os.path.join(REPO_ROOT, "mqe_tpu", "assets")


def default_device() -> str:
    return "cuda"
