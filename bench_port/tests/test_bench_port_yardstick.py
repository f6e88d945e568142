"""The frozen bound reproduces the kernel table's bytes bounds (PERF.md §6):
0.0032 ms for the dynamics substep and 0.0027 ms for the sphere FK at
B = 8192 go1 robots; the op count scales linearly in B."""
import pytest
import torch

import bench_port_helpers  # noqa: F401
from portbench import check, trace, yardstick


def go1():
    check.refsim()
    from refsim.physics.model import load_model

    return load_model("go1")


def test_step_kernel_bytes_bound_at_8192():
    m, B = go1(), 8192
    ns = len(m.sph_tags)
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    ins = [z(B, 3), z(B, 4), z(B, 3), z(B, 3), z(B, m.nq), z(B, m.nq), z(B, m.nq),
           z(B, ns, 3), z(B, ns, 3), z(B), z(B, 3)]
    outs = [z(B, 3), z(B, 4), z(B, 3), z(B, 3), z(B, m.nq), z(B, m.nq)]
    ops = trace.ops_per_launch([("fused_step_kernel", (m.nb, m.nq, ns),
                                 (True, True, False, True))], {(m.nb, m.nq, ns): m})
    a, b = ops[("fused_step_kernel", (m.nb, m.nq, ns), (True, True, False, True))]
    s, by = yardstick.bound_s(yardstick.nbytes(ins) + yardstick.nbytes(outs), a + b * B)
    assert by == "bytes" and round(s * 1e3, 4) == 0.0032


def test_sphere_fk_bytes_bound_at_8192():
    m, B = go1(), 8192
    ns = len(m.sph_tags)
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    ins = [z(B, 3), z(B, 4), z(B, 3), z(B, 3), z(B, m.nq), z(B, m.nq)]
    outs = [z(B, ns, 3), z(B, ns, 3)]
    s, by = yardstick.bound_s(yardstick.nbytes(ins) + yardstick.nbytes(outs), 0)
    assert by == "bytes" and round(s * 1e3, 4) == 0.0027


def test_op_count_is_linear_in_the_batch():
    m = go1()
    from refsim.physics import soa

    key = (m.nb, m.nq, len(m.sph_tags))
    a, b = trace.ops_per_launch([("fk_spheres_kernel", key, ())], {key: m})[
        ("fk_spheres_kernel", key, ())]
    st = lambda B: (torch.zeros(B, 3), torch.tensor([[1.0, 0, 0, 0]]).repeat(B, 1),  # noqa: E731
                    torch.zeros(B, 3), torch.zeros(B, 3), torch.zeros(B, m.nq),
                    torch.zeros(B, m.nq))
    assert yardstick.count_ops(soa.fk_spheres, m, *st(8)) == pytest.approx(a + 8 * b)
    assert b > 0


def test_bound_takes_the_larger_of_bytes_and_operations():
    s, by = yardstick.bound_s(3.35e12, 0)
    assert (s, by) == (1.0, "bytes")
    s, by = yardstick.bound_s(0, 67e12 * 2)
    assert (s, by) == (2.0, "operations")
