"""Host milliseconds a step of the gradient clip and the optimizer: the
program's ``transkun.clip`` (``QuantileClip``) and ``transkun.optimizer``
(AdaBelief's update, the clip ring's push, the buffers' guard) spans over
its ``steps`` counter, in the traced stretch."""

from benchlib import spans


def read(run):
    return spans.ms_per(run, ("transkun.clip", "transkun.optimizer"), "steps")
