"""Faults planted under the timed path, for the check's own tests and for
reading a fault's numbers at a cell's size (``control.py --fault``).  Each
takes a ``setattr(obj, name, value)`` and patches the program through it,
so a test's ``monkeypatch.setattr`` undoes it."""

from __future__ import annotations


def answer_altered(setattr):
    """Every note of every transcription comes back 50 ms longer."""
    from transkun_tpu_torch.models.transkun import TransKun

    real = TransKun._transcribe_finish

    def finish(self, plan, merge_incomplete_event=True):
        notes = real(self, plan, merge_incomplete_event)
        for n in notes:
            n.end += 0.05
        return notes

    setattr(TransKun, "_transcribe_finish", finish)


def half_the_segments(setattr):
    """The walk drops the events of the second half of each group's
    segments."""
    from transkun_tpu_torch.ops import walk

    real = walk.walk_group

    def walk_group(ptr, *a, **k):
        begins, ends, cnt, ovf, start_next = real(ptr, *a, **k)
        cnt = cnt.clone()
        cnt[cnt.shape[0] // 2:] = 0
        return begins, ends, cnt, ovf, start_next

    setattr(walk, "walk_group", walk_group)


def state_unchanged(setattr):
    """The optimizer's step does nothing."""
    from transkun_tpu_torch.train.optim import AdaBelief

    setattr(AdaBelief, "step", lambda self, grads, finite: None)


def half_the_batch(setattr):
    """The loss is taken over the first half of the batch (its mean over
    the rest)."""
    from transkun_tpu_torch.models.transkun import TransKun

    real = TransKun.make_train_loss

    def make_train_loss(self, group=None):
        loss_fn = real(self, group)

        def half(frames, labels, generator):
            n = frames.shape[0] // 2
            return loss_fn(frames[:n], tuple(x[:n] for x in labels), generator)

        return half

    setattr(TransKun, "make_train_loss", make_train_loss)


TRANSCRIPTION = ("answer_altered", "half_the_segments")
TRAINING = ("state_unchanged", "half_the_batch")
