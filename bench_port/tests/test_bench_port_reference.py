"""The reference agrees with mqe_tpu_torch for one step of each
configuration at 2 envs on the CPU (where the program's kernel wrappers run
the plain versions the reference copies), from the program's state and
draws, as the benchmark compares them; and the start (the reset) too."""
import pytest
import torch

from bench_port_helpers import small_cell
from portbench import check
from portbench.drivers import driver_for


@pytest.mark.parametrize("cell", ["go1gate.gym", "go1sheep-hard.gym"])
def test_one_step_of_each_configuration_agrees(cell):
    torch.set_num_threads(1)
    c = small_cell(cell, check_within=1)
    drv = driver_for(c, 2**31 + 11, "cpu", 2)
    drv.setup()
    w = drv.window(0.01)
    assert w["steps"] >= 1 and not w["missing"] and len(w["checks"]) == 1
    ref = check.Reference(c.config["task"], 2, drv.env_seed, "cpu")
    nums, detail = check.gym_check(ref, drv.start, w["checks"], 0.5)
    assert set(detail["sets"]) == {"reset", "step0"}
    assert nums["row_err_p50"] <= 1e-6 and nums["row_err_p99"] <= 1e-6, detail


def test_the_reference_refuses_a_draw_the_program_did_not_make():
    check.refsim()
    draws = check.strict_draws({"spawn_x": [torch.zeros(2, 2)]}, "cpu")
    with pytest.raises(KeyError):
        draws.uniform("spawn_y", (2, 2), 0.0, 1.0, "cpu")
    assert draws.uniform("spawn_x", (2, 2), 0.0, 1.0, "cpu").shape == (2, 2)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, 3.0])
    r = check._tf32_round(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0, 1.0, 3.0]
