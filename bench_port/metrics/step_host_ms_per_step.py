"""Host milliseconds of the step function a step: the program's
``transkun.step`` spans (forward, backward, clip and optimizer enqueued)
over its ``steps`` counter, in the traced stretch, where the profiler
turns the program's recorder on."""

from benchlib import spans


def read(run):
    return spans.ms_per(run, ("transkun.step",), "steps")
