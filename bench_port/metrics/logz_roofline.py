"""Kernels 2-3's share of their roofline in the traced stretch: the least
time of every alpha and beta launch (the strict-triangle byte bound at the
batch's frames and tracks) over their device time, by kernel name."""


def read(run):
    if run.summary is None:
        return None
    c = run.counter("semicrf")
    n, secs = run.summary.kernel_time(c.LOGZ_KERNELS)
    if n == 0:
        return None
    least, _ = c.table_bound_s(run.counters["frames"], 90 * run.counters["batch"], c.LOGZ_OPS_PER_TERM)
    return 100.0 * n * least / secs
