"""Kernel 1's share of its roofline in the traced stretch: the least time
of every launch (the strict-triangle byte bound at one segment's frames and
90 tracks) over the launches' device time, by kernel name."""


def read(run):
    if run.summary is None:
        return None
    c = run.counter("semicrf")
    n, secs = run.summary.kernel_time(c.VITERBI_KERNELS)
    if n == 0:
        return None
    least, _ = c.table_bound_s(run.counters["frames"], 90, c.VITERBI_OPS_PER_TERM)
    return 100.0 * n * least / secs
