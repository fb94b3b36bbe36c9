"""The trace's reductions on hand-made spans."""
import pytest

from portbench.harness import trace


def test_union_merges_overlapping_and_touching_intervals():
    got = trace.union([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (3.0, 4.0),
                       (5.5, 5.7)])
    assert got == [(0.0, 4.0), (5.0, 6.0)]


def make():
    host = [
        (trace.LABEL, 0.0, 10.0),
        ("aten::item", 4.0, 7.0),        # the host waits at 4..7
        ("aten::add", 8.5, 9.5),
    ]
    device = [
        ("kernel_a", 1.0, 3.0),
        ("census_tile_kernel", 2.0, 4.0),  # overlaps kernel_a
        ("Memcpy DtoH", 7.0, 8.0),
        ("kernel_b", 12.0, 13.0),          # outside the window
    ]
    return trace.Trace(device, host)


def test_busy_and_idle_share_count_overlap_once():
    tr = make()
    assert tr.window_s == 10.0
    assert tr.busy_s == pytest.approx(4.0)   # 1..4 and 7..8
    assert tr.device_s() == pytest.approx(5.0)
    assert tr.device_s("census") == pytest.approx(2.0)
    assert tr.count() == 2                   # kernels, not copies
    assert tr.count("census") == 1


def test_idle_gaps_are_named_by_the_host_op():
    gaps = dict(tr_gap for tr_gap in make().idle_gaps())
    assert gaps["aten::item"] == pytest.approx(3.0)   # 4..7
    assert gaps["aten::add"] == pytest.approx(2.0)    # 8..10
    assert gaps["host"] == pytest.approx(1.0)         # 0..1


def test_a_trace_without_an_experiment_is_refused():
    with pytest.raises(ValueError):
        trace.Trace([], [("aten::add", 0.0, 1.0)])
