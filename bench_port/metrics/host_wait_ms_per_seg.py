"""Host milliseconds a segment that the finish waits for a piece's event
(``transkun.wait``: the card still working on that piece when the host
comes to it), over every piece the program recorded, over its
``segments`` counter."""

from benchlib import spans


def read(run):
    return spans.ms_per(run, ("transkun.wait",), "segments")
