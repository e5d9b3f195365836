"""The benchmark's arithmetic: a rate over the whole window, busy time as
the union of intervals, the steady stretch between hand-overs, and the
split of the time between training steps."""

import pytest

from benchlib import stats


def test_rate_is_over_the_whole_window():
    # three items of 10 s of audio in a window of 6 s: 5 audio_s/s, whatever the items' own times
    assert stats.rate(30.0, 6.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_union_counts_overlap_once():
    # two overlapping kernels, 0-3 and 2-5, and one apart, 7-8: 6 s busy, not 7
    assert stats.union_length([(0, 3), (2, 5), (7, 8)]) == 6
    assert stats.union_length([(0, 10), (1, 2), (3, 4)]) == 10
    assert stats.union_length([]) == 0


def test_gaps_are_the_uncovered_stretches():
    assert stats.gaps([(1, 3), (2, 4), (6, 7)], 0, 10) == [(0, 1), (4, 6), (7, 10)]
    assert stats.gaps([(0, 10)], 0, 10) == []


class _Dev:
    def __init__(self, name):
        self.name = name


class _Ev:
    def __init__(self, name, a, b, card=False, annotation=False):
        self.name, self.is_user_annotation = name, annotation
        self.device_type = _Dev("CUDA" if card else "CPU")
        self.time_range = type("R", (), {"start": a * 1e6, "end": b * 1e6})()


def test_trace_summary_counts_kernels_once_and_names_gaps():
    from benchlib import trace

    events = [
        _Ev(trace.STRETCH, 0.0, 10.0), _Ev(trace.STRETCH, 0.0, 10.0, card=True, annotation=True),
        _Ev("dispatch", 0.0, 4.0), _Ev("dispatch", 0.0, 4.0, card=True, annotation=True),
        _Ev("finish", 6.0, 9.5),
        _Ev("gemm", 1.0, 3.0, card=True), _Ev("gemm", 2.0, 5.0, card=True), _Ev("walk", 7.0, 8.0, card=True),
    ]
    s = trace.summarize(events)
    assert s.window_s == 10.0 and s.busy_s == 5.0  # 1-5 and 7-8; the annotations are no device work
    assert s.by_name == {"gemm": (2, 5.0), "walk": (1, 1.0)}
    # idle 0-1 in dispatch, 5-7 in no span, 8-10 in finish (by where each gap starts)
    assert sorted(s.gaps) == [("dispatch", 1.0), ("finish", 2.0), ("other", 2.0)]
    assert s.kernel_time(["walk"]) == (1, 1.0)


def test_trace_without_device_time_fails():
    from benchlib import trace

    with pytest.raises(RuntimeError):
        trace.summarize([_Ev(trace.STRETCH, 0.0, 1.0), _Ev("x", 0.1, 0.2, card=True, annotation=True)])


def test_trace_summary_keeps_to_the_hand_overs():
    from benchlib import trace

    events = [
        _Ev(trace.STRETCH, 0.0, 10.0),
        _Ev(trace.MARK, 1.0, 1.0), _Ev(trace.MARK, 3.0, 3.0), _Ev(trace.MARK, 6.0, 6.0),
        _Ev("finish", 6.5, 10.0),
        _Ev("gemm", 0.5, 2.0, card=True), _Ev("gemm", 2.5, 5.0, card=True), _Ev("walk", 5.5, 7.0, card=True),
    ]
    s = trace.summarize(events)
    # the drain after the last hand-over (6-10) is left out: 5 s, 4 of them busy
    assert s.window_s == 5.0 and s.traced_s == 10.0 and s.busy_s == 4.0
    # whole launches that start in the stretch; the one begun before it is not counted
    assert s.by_name == {"gemm": (1, 2.5), "walk": (1, 1.5)}
    assert sorted(s.gaps) == [("other", 0.5), ("other", 0.5)]


class _Run:
    def __init__(self, counters):
        self.counters = counters


def test_input_route_and_fetch_waits_are_apart():
    from benchlib import manifest

    counters = {"steps": 10, "input_s": [0.002, 0.004], "loop_s": [0.050, 0.030]}
    route = manifest.load_module("metrics", "input_ms_per_step").read(_Run(counters))
    rest = manifest.load_module("metrics", "fetch_stats_ms_per_step").read(_Run(counters))
    assert route == pytest.approx(3.0)
    # 80 ms between the steps that fetched, less two input routes of 3 ms, over 10 steps
    assert rest == pytest.approx(7.4)
    assert manifest.load_module("metrics", "fetch_stats_ms_per_step").read(_Run({"input_s": [0.1]})) is None
