"""The readers of the program's spans and counters: their arithmetic on
synthetic totals, the launches over segments and steps, the note of kernel
builds in the window, the idle gaps named by program spans, and nothing
from a program without the recorder."""

import sys
import types

import pytest

from benchlib import manifest, spans, trace


class _Run:
    def __init__(self, counters=None, summary=None, t0=0.0, setup_s=None):
        self.counters = dict(counters or {})
        self.summary = summary
        self.t0, self.setup_s = t0, setup_s
        self.notes = {}

    def counter(self, name):
        return manifest.load_module("counters", name)


def _read(metric, run):
    return manifest.load_module("metrics", metric).read(run)


PIECES = {"totals": {"transkun.prepare": (3, 0.30), "transkun.pin": (3, 0.12), "transkun.upload": (3, 0.03),
                     "transkun.wait": (3, 0.015), "transkun.dispatch": (3, 4.5)},
          "counters": {"pieces": 3, "segments": 150, "groups": 39}}
TRAIN = {"totals": {"transkun.step": (10, 3.1), "transkun.clip": (10, 0.2), "transkun.optimizer": (10, 0.4),
                    "transkun.input": (10, 0.05), "transkun.fetch": (2, 0.02), "transkun.stats": (1, 0.5)},
         "counters": {"steps": 10, "fetches": 2, "stats_passes": 1}}


def test_span_readers_divide_by_the_programs_counters():
    pieces = _Run({"segments": 140, "spans": PIECES})
    # 0.45 s of prepare, pin and upload over 150 segments recorded (not the window's 140 completed)
    assert _read("upload_ms_per_seg", pieces) == pytest.approx(3.0)
    assert _read("host_wait_ms_per_seg", pieces) == pytest.approx(0.1)
    train = _Run({"steps": 120, "spans": TRAIN})
    assert _read("step_host_ms_per_step", train) == pytest.approx(310.0)
    assert _read("optimizer_ms_per_step", train) == pytest.approx(60.0)
    assert _read("input_host_ms_per_step", train) == pytest.approx(5.0)
    # 20 ms over the 2 fetches recorded; the stats pass is not the fetch's
    assert _read("fetch_host_ms_per_fetch", train) == pytest.approx(10.0)
    # each cell's readers find nothing in the other's counters
    assert _read("step_host_ms_per_step", pieces) is None and _read("upload_ms_per_seg", train) is None


def test_launches_over_viterbi_launches_and_steps():
    summary = trace.Summary(5.0, 4.0, {"viterbi_bwd_kernel(...)": (40, 0.02), "gemm": (50000, 2.0),
                                       "elementwise": (30000, 1.0)})
    assert _read("launches_per_seg", _Run({"segments": 99}, summary)) == pytest.approx(80040 / 40)
    assert _read("launches_per_seg", _Run({"segments": 99}, trace.Summary(1.0, 1.0, {"gemm": (5, 1.0)}))) is None
    train = _Run({"steps": 120, "spans": TRAIN}, summary)
    assert _read("launches_per_step", train) == pytest.approx(80040 / 10)
    assert _read("launches_per_step", _Run({"steps": 120, "spans": TRAIN})) is None


def test_builds_in_the_window_are_noted(monkeypatch):
    from transkun_tpu_torch.ops import _build
    from transkun_tpu_torch.utils import profiling

    profiling.reset()
    monkeypatch.setattr(_build, "BUILDS", [("viterbi_bwd", 10.0, 4.0), ("semicrf_alpha", 13.0, 3.0)])
    run = _Run({"segments": 1}, t0=1.0, setup_s=11.5)  # the window opens at 12.5
    got = spans.read(run)
    assert run.notes == {"kernel_builds_in_window": 1}
    assert got == {"totals": {}, "counters": {}} and spans.read(run) is got


def test_gaps_are_named_by_the_innermost_program_span():
    """As ``trace.summarize`` finds the gaps (between the hand-overs, the
    card's annotations no work), each named by the harness span and the
    innermost ``transkun.*`` span that hold its start."""
    from test_bp_arithmetic import _Ev

    events = [
        _Ev(trace.STRETCH, 0.0, 12.0), _Ev(trace.STRETCH, 0.0, 12.0, card=True, annotation=True),
        _Ev(trace.MARK, 0.5, 0.5), _Ev(trace.MARK, 11.0, 11.0),
        _Ev("dispatch", 0.0, 4.0), _Ev("transkun.dispatch", 0.1, 3.9),
        _Ev("transkun.prepare", 0.2, 1.2), _Ev("transkun.group", 2.0, 3.8), _Ev("transkun.segment", 2.1, 3.0),
        _Ev("transkun.segment", 2.1, 3.0, card=True, annotation=True),
        _Ev("finish", 6.0, 9.5), _Ev("transkun.finish", 6.0, 9.5), _Ev("transkun.assemble", 6.1, 9.0),
        _Ev("gemm", 1.5, 2.5, card=True), _Ev("gemm", 3.5, 5.0, card=True), _Ev("walk", 7.0, 8.0, card=True),
        _Ev("copy", 9.2, 10.0, card=True),
    ]
    got = spans.name_gaps(events)
    # 0.5-1.5 prepare, 2.5-3.5 in group's segment, 5-7 outside every span, 8-9.2 assemble, 10-11 outside
    want = [("other", 2.0), ("finish/transkun.assemble", 1.2), ("dispatch/transkun.prepare", 1.0),
            ("dispatch/transkun.segment", 1.0), ("other", 1.0)]
    assert [n for n, _ in got[:2]] == ["other", "finish/transkun.assemble"]  # the longest first
    assert sorted(n for n, _ in got) == sorted(n for n, _ in want)
    assert sorted(t for _, t in got) == pytest.approx(sorted(t for _, t in want))
    # the same gaps as the summary's, by harness span
    assert sorted(t for _, t in trace.summarize(events).gaps) == pytest.approx(sorted(t for _, t in got))
    with pytest.raises(RuntimeError, match="no stretch"):
        spans.name_gaps([_Ev("gemm", 0.0, 1.0, card=True)])


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    import transkun_tpu_torch.utils

    old = types.ModuleType("transkun_tpu_torch.utils.profiling")  # the module before the recorder
    monkeypatch.setitem(sys.modules, "transkun_tpu_torch.utils.profiling", old)
    monkeypatch.setattr(transkun_tpu_torch.utils, "profiling", old, raising=False)
    run = _Run({"segments": 10, "steps": 10}, setup_s=1.0)
    for metric in ("upload_ms_per_seg", "host_wait_ms_per_seg", "step_host_ms_per_step", "optimizer_ms_per_step",
                   "input_host_ms_per_step", "fetch_host_ms_per_fetch", "launches_per_step"):
        assert _read(metric, run) is None, metric
    assert run.notes == {}
