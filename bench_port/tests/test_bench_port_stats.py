"""The metric arithmetic: a whole-window rate, and the idle share as a
union of synthetic kernel intervals with the gaps put to the host's stage."""
import pytest

import bench_port_helpers  # noqa: F401
from portbench import stats, trace


def test_window_rate_is_work_over_the_whole_window():
    assert stats.window_rate(16384 * 150, 10.0) == pytest.approx(245760.0)
    with pytest.raises(ValueError):
        stats.window_rate(1, 0.0)


def test_union_of_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.union_length([]) == 0.0
    assert stats.gaps(iv, 0, 8) == [(3, 5), (6, 8)]


def test_idle_share_from_a_synthetic_trace():
    """Kernels overlap on two streams; each gap goes to the innermost stage
    the host was in when it began."""
    tr = dict(window=(0.0, 100.0),
              kernels=[("a", 0.0, 20.0), ("b", 10.0, 30.0), ("a", 50.0, 60.0),
                       ("c", 95.0, 120.0)],
              labels=[("substep_batch", 25.0, 70.0), ("contact", 28.0, 45.0),
                      ("locomotion", 70.0, 99.0)])
    s = trace.summarize(tr)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)          # 0-30, 50-60, 95-100
    assert s["idle_share"] == pytest.approx(0.55)
    assert s["kernels"] == 4 and s["kernel_n"] == {"a": 2, "b": 1, "c": 1}
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["contact"] == pytest.approx(20e-6)       # 30-50 starts in contact
    assert gaps["substep_batch"] == pytest.approx(35e-6)  # 60-95 starts in substep_batch
    assert "locomotion" not in gaps
    assert dict(s["breakdown"]["device_ops"])["a"] == pytest.approx(30e-6)


def test_kernel_names_lose_their_signature():
    assert trace.base_name("fused_step_kernel(float const*, int)") == "fused_step_kernel"
