"""Host milliseconds of the training input route a step, as the program
times it: its ``transkun.input`` spans (the loader's next batch, the
slice, frames, labels and the step's generator) over its ``steps``
counter, in the traced stretch."""

from benchlib import spans


def read(run):
    return spans.ms_per(run, ("transkun.input",), "steps")
