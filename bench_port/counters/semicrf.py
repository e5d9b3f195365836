"""The least time of the semi-CRF table kernels (kernel 1, the Viterbi
backward table; kernels 2-3, the logZ alpha and beta tables), copied from
``chip_smoke.py``'s ``bound`` and ``table_bound``.

Counts what the recurrence needs at the real sizes (``t`` frames, ``lanes``
tracks times batch), not the program's padding: the strict lower triangle
of scores, t(t-1)/2 a lane, read once, two float32 [t, lanes] inputs read
and one 4-byte [t, lanes] table written once; operations ``ops_per_term``
a triangle entry.  Leaves out the diagonal's softplus and the few [t,
lanes] passes around the kernels."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import h100  # noqa: E402

VITERBI_KERNELS = ("viterbi_bwd_kernel",)
LOGZ_KERNELS = ("alpha_tma_kernel", "lse_cluster_kernel")
VITERBI_OPS_PER_TERM = 2  # add, max
LOGZ_OPS_PER_TERM = 4  # add, subtract the running max, exp, accumulate


def bound_s(n_bytes: float, flops: float, peak: float = h100.FP32_FLOPS):
    """(least seconds, "bytes" or "operations"): every byte once at the
    memory rate, or the operations at ``peak``, whichever is larger."""
    by_bytes, by_ops = n_bytes / h100.HBM_BYTES_PER_S, flops / peak
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def table_bound_s(t: int, lanes: int, ops_per_term: int, score_bytes: int = 4):
    terms = t * (t - 1) // 2 * lanes
    return bound_s(score_bytes * terms + 3 * 4 * t * lanes, ops_per_term * terms)
