from setuptools import find_packages, setup

setup(
    name="mqe-tpu",
    version="0.1.0",
    description=(
        "TPU-native multi-agent quadruped RL environment suite "
        "(JAX/XLA/Pallas re-design of ziyanx02/multiagent-quadruped-environment)"
    ),
    # "mqe_tpu.*" does not match mqe_tpu_torch: the PyTorch/CUDA port is
    # named on its own, with its CUDA sources (built with nvcc at first use)
    packages=find_packages(
        include=["mqe_tpu", "mqe_tpu.*", "mqe_tpu_torch", "mqe_tpu_torch.*"]
    ),
    package_data={"mqe_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
)
