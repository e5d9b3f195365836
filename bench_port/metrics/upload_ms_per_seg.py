"""Host milliseconds of a piece's upload a segment: the program's
``transkun.prepare`` (int16 to float32, transpose, pad), ``transkun.pin``
and ``transkun.upload`` (the copy's enqueue) spans of every piece it
recorded (the window and the traced stretch), over its ``segments``
counter."""

from benchlib import spans


def read(run):
    return spans.ms_per(run, ("transkun.prepare", "transkun.pin", "transkun.upload"), "segments")
