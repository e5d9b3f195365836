"""The port's span-and-counter recorder (``utils/profiling.py``) and the
spans of a transcription, on the CPU at a tiny size: off, a span site
reads no clock and calls no ``record_function``; on, spans nest, take their
root's key and add up; a kernel build is listed whether or not the recorder
is on; under ``torch.profiler`` every dispatch and finish span stands in the
profiler's events inside its root, in order."""

import threading

import numpy as np
import pytest
import torch

from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun
from transkun_tpu_torch.utils import profiling

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0, "segmentHopSizeInSecond": 1.0,
}
DISPATCH = ["transkun.prepare", "transkun.upload", "transkun.group"]
GROUP = ["transkun.segment", "transkun.walk", "transkun.heads", "transkun.to_host"]
FINISH = ["transkun.wait", "transkun.assemble", "transkun.merge"]


@pytest.fixture
def counted(monkeypatch):
    """Calls of the host clock and of ``record_function``, counted."""
    calls = {"clock": 0, "record_function": 0}
    clock, record_function = profiling.time.perf_counter, torch.profiler.record_function

    def counting_clock():
        calls["clock"] += 1
        return clock()

    def counting_record_function(*a, **k):
        calls["record_function"] += 1
        return record_function(*a, **k)

    monkeypatch.setattr(profiling.time, "perf_counter", counting_clock)
    monkeypatch.setattr(torch.profiler, "record_function", counting_record_function)
    return calls


def _work(rec):
    with rec.root("transkun.a", 7) as a:
        with rec.span("transkun.b"):
            with rec.span("transkun.c", 9):
                rec.count("items", 2)
        with rec.span("transkun.b"):
            rec.count("items")
    return a


def test_off_reads_no_clock_and_records_nothing(monkeypatch, counted):
    monkeypatch.delenv(profiling.ENV, raising=False)
    rec = profiling.Recorder()
    a = _work(rec)
    assert a is profiling.NOOP and rec.span("transkun.d") is profiling.NOOP
    assert counted == {"clock": 0, "record_function": 0}
    assert rec.totals() == {} and rec.counters() == {} and rec.last() == []


def test_on_nests_keys_and_totals(monkeypatch, counted):
    monkeypatch.setenv(profiling.ENV, "silent")
    rec = profiling.Recorder()
    a = _work(rec)
    assert counted["record_function"] == 4 and counted["clock"] == 8
    assert [(s.name, s.key, s.parent) for s in a.records] == [
        ("transkun.c", 9, "transkun.b"), ("transkun.b", 7, "transkun.a"),
        ("transkun.b", 7, "transkun.a"), ("transkun.a", 7, None)]
    c, b0, b1, top = a.records
    assert top.t0 <= b0.t0 <= c.t0 <= c.t1 <= b0.t1 <= b1.t0 <= b1.t1 <= top.t1
    assert rec.last() == a.records
    totals = rec.totals()
    assert {k: n for k, (n, _) in totals.items()} == {"transkun.a": 1, "transkun.b": 2, "transkun.c": 1}
    assert totals["transkun.b"][1] == pytest.approx((b0.t1 - b0.t0) + (b1.t1 - b1.t0))
    assert rec.counters() == {"items": 3}
    # after the root, a span outside any root records nothing
    assert rec.span("transkun.d") is profiling.NOOP
    rec.reset()
    assert rec.totals() == {} and rec.counters() == {} and rec.last() == []


def test_nesting_is_per_thread_and_a_root_decides_once(monkeypatch):
    monkeypatch.setenv(profiling.ENV, "1")
    rec = profiling.Recorder()
    seen = []

    def other():
        with rec.root("transkun.other", 2) as o:
            seen.append(o.parent)

    with rec.root("transkun.a", 1):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        monkeypatch.delenv(profiling.ENV)
        with rec.span("transkun.b"):  # the open root records, the variable read as it opened
            rec.count("items")
    assert not t.is_alive() and seen == [None]
    with rec.root("transkun.a", 3):
        with rec.span("transkun.b"):
            rec.count("items")
    assert rec.counters() == {"items": 1}
    assert {k: n for k, (n, _) in rec.totals().items()} == {"transkun.a": 1, "transkun.b": 1, "transkun.other": 1}


def _model():
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", seed=0)
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] = -4.0
    return model


def _inside(ev, name):
    while ev is not None:
        if ev.name == name:
            return True
        ev = ev.cpu_parent
    return False


def _piece():
    return (np.random.default_rng(8).normal(size=(int(5.5 * FS), 1)) * 0.1).astype(np.float32)


def test_transcription_spans_stand_in_the_profiler(monkeypatch):
    """No ``TRANSKUN_TPU_TIMING``: a profiler alone turns the spans on.
    Each dispatch span lies in ``transkun.dispatch`` and each finish span
    in ``transkun.finish``, in the order the phases run."""
    monkeypatch.delenv(profiling.ENV, raising=False)
    model = _model()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.transcribe(_piece(), segment_batch=2)
    by_name = {}
    for e in prof.events():
        if e.name.startswith("transkun."):
            by_name.setdefault(e.name, []).append(e)
    n_groups = len(model.last_transcribe_group_counts)
    segments = 8  # ceil((5.5 s + 2 x 1 s of padding) / 1 s hop)
    assert len(by_name["transkun.dispatch"]) == len(by_name["transkun.finish"]) == 1
    assert len(by_name["transkun.group"]) == n_groups == 4 and len(by_name["transkun.segment"]) == segments
    for name in DISPATCH + GROUP:
        assert all(_inside(e, "transkun.dispatch") for e in by_name[name]), name
    for name in GROUP:
        assert all(_inside(e, "transkun.group") for e in by_name[name]), name
    for name in FINISH:
        assert len(by_name[name]) == 1 and _inside(by_name[name][0], "transkun.finish"), name
    assert "transkun.pin" not in by_name and "transkun.host_walk" not in by_name  # the CPU pins nothing

    def start(name, i=0):
        return by_name[name][i].time_range.start

    assert start("transkun.prepare") <= start("transkun.upload") <= start("transkun.group")
    assert all(start("transkun.group", g) <= start("transkun.group", g + 1) for g in range(n_groups - 1))
    assert start("transkun.wait") <= start("transkun.assemble") <= start("transkun.merge")
    assert profiling.counters() == {"pieces": 1, "groups": n_groups, "segments": segments}
    assert model.last_transcribe_marks == []  # marks are the variable's alone
    # the last root is the finish, its spans keyed by the piece's serial number
    assert profiling.last()[-1].name == "transkun.finish" and {s.key for s in profiling.last()} == {0}
    profiling.reset()


def test_host_walk_resumes_inside_the_finish(monkeypatch):
    """With a budget of one event the host-walk route resumes from group
    0 inside ``transkun.finish``, enqueueing every segment's tables again,
    and the marks name it."""
    monkeypatch.setenv(profiling.ENV, "silent")
    model = _model()
    model.decode_k_budget = 1
    profiling.reset()
    model.transcribe(_piece(), segment_batch=2)
    finish = profiling.last()
    assert model.last_transcribe_fallback_from == 0 and profiling.counters()["host_walk_resumes"] == 1
    assert [s.name for s in finish if s.parent == "transkun.finish"] == [
        "transkun.wait", "transkun.assemble", "transkun.host_walk", "transkun.merge"]
    assert sum(s.name == "transkun.segment" and s.parent == "transkun.host_walk" for s in finish) == 8
    assert [label for label, _ in model.last_transcribe_marks][-3:] == [
        "assembled", "host-walk route from group 0", "merged"]
    profiling.reset()


def test_a_kernel_build_is_recorded_without_the_variable(monkeypatch, tmp_path):
    """``ops._build.build`` lists each compile in ``BUILDS`` (the kernel's
    name, its start on ``time.perf_counter``, its seconds) with the recorder
    off, a current library adds nothing, and inside a recording root the
    compile is also a ``transkun.build`` span keyed by the kernel."""
    import subprocess

    from transkun_tpu_torch.ops import _build

    monkeypatch.delenv(profiling.ENV, raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILDS", [])
    monkeypatch.setattr(_build, "library_path", lambda name: str(tmp_path / f"lib{name}.so"))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def nvcc(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("built")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    profiling.reset()
    before = profiling.time.perf_counter()
    for _ in range(2):
        _build.build("viterbi_bwd")
    assert [name for name, *_ in _build.BUILDS] == ["viterbi_bwd"]
    (_, t0, seconds), = _build.BUILDS
    assert before <= t0 and 0 <= seconds < 60
    assert profiling.totals() == {} and profiling.counters() == {}
    monkeypatch.setenv(profiling.ENV, "silent")
    with profiling.root("transkun.dispatch", 5):
        _build.build("semicrf_alpha")
    assert [(s.name, s.key, s.parent) for s in profiling.last()][0] == (
        "transkun.build", "semicrf_alpha", "transkun.dispatch")
    assert [name for name, *_ in _build.BUILDS] == ["viterbi_bwd", "semicrf_alpha"]
    profiling.reset()
