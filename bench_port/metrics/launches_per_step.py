"""Device operations a training step in the traced stretch: every
operation that started on the card in it (input route, step, fetches and
stats passes), over the program's ``transkun.step`` spans there (its
``steps`` counter, which only the profiler turns on in this cell)."""

from benchlib import spans


def read(run):
    got = spans.read(run)
    if run.summary is None or not got or not got["counters"].get("steps"):
        return None
    return sum(n for n, _ in run.summary.by_name.values()) / got["counters"]["steps"]
