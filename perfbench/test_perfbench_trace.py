"""The trace reduction on a hand-made Chrome trace: the window, the union
of device intervals, and idle gaps named by label and host operation."""
import pytest

from perfbench import trace


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    _x("bench.window", "user_annotation", 1000, 100),
    _x("bench.step", "user_annotation", 1000, 100),
    _x("bench.decode", "user_annotation", 1010, 80),
    _x("aten::mm", "cpu_op", 1040, 20),
    # device: two overlapping kernels, a copy, one kernel outside the window
    _x("k_a", "kernel", 1020, 10, tid=7),
    _x("k_b", "kernel", 1025, 10, tid=8),
    _x("Memcpy HtoD", "gpu_memcpy", 1070, 5, tid=7),
    _x("k_late", "kernel", 1200, 50, tid=7),
]


def test_busy_and_window():
    s = trace.summarise(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(20e-6)          # [1020, 1035] + [1070, 1075]
    assert s.kernel_seconds("k_") == (2, pytest.approx(20e-6))


def test_idle_gaps_by_label_and_operation():
    s = trace.summarise(EVENTS)
    # gaps: [1000, 1020] mid 1010 (decode, which starts there), [1035,
    # 1070] mid 1052.5 (decode, in aten::mm), [1075, 1100] mid 1087.5
    assert s.idle_by["decode:aten::mm"] == pytest.approx(35e-6)
    assert s.idle_by["decode:python"] == pytest.approx(45e-6)
    top = s.breakdown()
    assert top["device_ops"][0][0] in ("k_a", "k_b")
    assert top["idle_gaps"][0] == ["decode:python", pytest.approx(45e-6)]


def test_one_window_only():
    with pytest.raises(RuntimeError, match="windows"):
        trace.summarise(EVENTS[1:])
