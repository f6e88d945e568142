"""The `gate` fixture of the training-stack tests, tests/test_learn*.py: each
file that takes it builds its own go1gate wrapper (4 envs)."""
import pytest

from mqe_tpu.envs import make_mqe_env


@pytest.fixture(scope="module")
def gate():
    wrap, _ = make_mqe_env("go1gate", num_envs=4, seed=0)
    return wrap
