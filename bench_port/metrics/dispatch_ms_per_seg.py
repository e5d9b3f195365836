"""Host milliseconds of ``_transcribe_dispatch`` a segment: the program's
``TRANSKUN_TPU_TIMING`` marks of every item of the window (begin to the
last group enqueued), summed, over the window's segments."""


def read(run):
    marks = run.counters.get("marks")
    if not marks:
        return None
    return 1e3 * sum(m["dispatch"] for m in marks) / run.counters["segments"]
