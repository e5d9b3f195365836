"""The program's own spans and counters (``transkun_tpu_torch.utils.profiling``)
as the per-layer readers take them: read once, after the run, into
``run.counters["spans"]``; and the traced stretch's idle gaps named by the
program span the host was in (``name_gaps``, which ``named_gaps.py`` prints).

The program records while ``TRANSKUN_TPU_TIMING`` is set, which the pieces
driver does for the window and the traced stretch of a ``--trace 1`` run,
or while a ``torch.profiler`` records, which covers the traced stretch of
either cell.  Nothing else in a run turns it on, so its totals are those
of what it recorded: in the pieces cell the window and the traced stretch,
in the training cell the traced stretch alone, under the profiler.  A
program without the recorder gives nothing, and the readers of its spans
return ``None``.

The first read also notes ``kernel_builds_in_window``: the program's nvcc
compiles (``transkun_tpu_torch.ops._build.BUILDS``, listed whatever the
variable says) that began after the window opened."""

from __future__ import annotations

from typing import List, Tuple

from . import stats, trace

PREFIX = "transkun."  # the program's span names


def read(run):
    """{"totals": span name -> (count, host seconds), "counters": name ->
    count}, or None where the program has no recorder."""
    if "spans" not in run.counters:
        run.counters["spans"] = _take(run)
    return run.counters["spans"]


def _take(run):
    from transkun_tpu_torch.ops import _build
    from transkun_tpu_torch.utils import profiling

    if not hasattr(profiling, "totals"):
        return None
    builds = getattr(_build, "BUILDS", None)
    if builds is not None and run.setup_s is not None:
        opened = run.t0 + run.setup_s  # the window's start on the same clock
        run.notes["kernel_builds_in_window"] = sum(t0 >= opened for _, t0, _ in builds)
    return {"totals": profiling.totals(), "counters": profiling.counters()}


def ms_per(run, names, per: str):
    """Host milliseconds of the spans ``names``, summed, over the program's
    counter ``per``; None where it counted none."""
    got = read(run)
    if not got or not got["counters"].get(per):
        return None
    seconds = sum(got["totals"].get(name, (0, 0.0))[1] for name in names)
    return 1e3 * seconds / got["counters"][per]


def name_gaps(events) -> List[Tuple[str, float]]:
    """The idle gaps that ``trace.summarize`` finds in the same events,
    longest first, each named ``<harness span>/<innermost program span>``
    where a ``transkun.*`` span holds the gap's start, else by the harness
    span alone (``other`` outside every one), as ``summarize`` names them."""
    window, marks, ops, harness, program = None, [], [], [], []
    for ev in events:
        if trace._is_device(ev):
            ops.append(trace._interval(ev))
        elif trace._on_card(ev):
            continue
        elif ev.name == trace.STRETCH:
            window = trace._interval(ev)
        elif ev.name == trace.MARK:
            marks.append(trace._interval(ev)[0])
        elif ev.name in trace.SPANS:
            harness.append((ev.name,) + trace._interval(ev))
        elif ev.name.startswith(PREFIX):
            program.append((ev.name,) + trace._interval(ev))
    if window is None:
        raise RuntimeError("the trace holds no stretch span")
    lo, hi = window
    if len(marks) >= 2:
        lo, hi = max(lo, min(marks)), min(hi, max(marks))
    ops = [(max(a, lo), min(b, hi)) for a, b in ops if b > lo and a < hi]
    named = []
    for g0, g1 in stats.gaps(ops, lo, hi):
        name = _innermost(harness, g0) or "other"
        inner = _innermost(program, g0)
        named.append((f"{name}/{inner}" if inner else name, g1 - g0))
    named.sort(key=lambda x: -x[1])
    return named


def _innermost(spans, t):
    inside = [s for s in spans if s[1] <= t < s[2]]
    return min(inside, key=lambda s: s[2] - s[1])[0] if inside else None
