"""Device operations a segment in the traced stretch: the operations that
started on the card between the first and the last hand-over, over the
segments whose tables were made there, counted by the Viterbi kernel's
launches (``_segment_tables`` launches it once a segment)."""


def read(run):
    if run.summary is None or "segments" not in run.counters:
        return None
    n_seg, _ = run.summary.kernel_time(run.counter("semicrf").VITERBI_KERNELS)
    if n_seg == 0:
        return None
    return sum(n for n, _ in run.summary.by_name.values()) / n_seg
