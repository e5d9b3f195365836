"""Host milliseconds of one metric fetch of the training loop (every
``--logEvery`` steps: the copy to the host, a wait for the card's queue),
as the program times it: its ``transkun.fetch`` spans over its ``fetches``
counter, in the traced stretch.  Over fetches, not steps, so that the
reading does not hang on how many fetches a stretch of a few seconds
happens to hold; the stats passes (one every 40 steps) are left out, as
such a stretch holds one only now and then."""

from benchlib import spans


def read(run):
    return spans.ms_per(run, ("transkun.fetch",), "fetches")
