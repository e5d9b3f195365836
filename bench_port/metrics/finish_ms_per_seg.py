"""Host milliseconds of ``_transcribe_finish`` after its wait a segment:
the program's marks of every item of the window (the event waited for to
the merge's end), summed, over the window's segments."""


def read(run):
    marks = run.counters.get("marks")
    if not marks:
        return None
    return 1e3 * sum(m["finish"] for m in marks) / run.counters["segments"]
