"""Launch plans of the blocked semi-CRF kernels that run as thread-block
clusters (``csrc/cluster_dp.cuh``: the Viterbi, alpha and beta kernels).

A CTA owns one lane group (``row_bytes`` of each score row; a 32-byte
sector holds 8 fp32 or 16 bf16 lanes) and the earlier positions
``m = rank (mod C)`` of the cluster of C CTAs that share the group.  The
alpha kernel's far scores arrive by TMA: a ring of stages, each one box of
8 ends x ``rows`` owned begins.  The plan is made here, on the host, so
that the CPU tests can check it; the C functions take the cluster size and
derive the rest.  The constants mirror the kernels'.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence

import torch

BLOCK = 8  # positions a block, one warp each
THREADS = BLOCK * 32  # threads a CTA
SECTOR = 32  # bytes of a score row one CTA owns (Viterbi, beta)
CLUSTER_SIZES = tuple(range(1, 17))  # above 8 needs the non-portable attribute
PORTABLE_CLUSTER = 8
# the alpha kernel (csrc/semicrf_lse_cluster.cuh): bytes of a score row a CTA
# owns by score dtype, stages of the TMA ring, and its cluster sizes: the TMA
# unit strides at most 8 elements, and a box traverses at most 256
ALPHA_ROW_BYTES = {torch.float32: 32, torch.bfloat16: 32}
ALPHA_STAGES = 16
ALPHA_CLUSTER_SIZES = tuple(range(1, 9))
TMA_MAX_STRIDE, TMA_MAX_BOX = 8, 256


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """``lanes`` a CTA (``row_bytes`` of each score row), ``groups`` of them,
    ``cluster`` CTAs sharing a group, ``smem`` bytes of dynamic shared memory
    a CTA of ``threads``; with a TMA ring (the alpha kernel, whose producer
    and corner have warps of their own), its ``stages``, each ``rows`` owned
    begins of the block's 8 ends."""

    lanes: int
    groups: int
    cluster: int
    smem: int
    row_bytes: int = SECTOR
    stages: int = 0
    rows: int = 0
    threads: int = THREADS

    @property
    def ctas(self) -> int:
        return self.groups * self.cluster

    @property
    def portable(self) -> bool:
        return self.cluster <= PORTABLE_CLUSTER

    @property
    def slots(self) -> int:
        """Slots of earlier positions a warp: 32 threads, 16 bytes of a row each."""
        return 32 // (self.row_bytes // 16)

    @property
    def box(self) -> tuple:
        """The TMA box, innermost first: lanes, begins traversed, ends."""
        return (self.lanes, self.rows * self.cluster, BLOCK)

    @property
    def element_strides(self) -> tuple:
        """The TMA box's step along each dimension: every C-th begin."""
        return (1, self.cluster, 1)


def lanes_per_cta(dtype: torch.dtype, row_bytes: int = SECTOR) -> int:
    """Lanes of ``row_bytes`` of ``dtype`` scores: 8 fp32 or 16 bf16 in a
    32-byte sector."""
    return row_bytes // torch.empty((), dtype=dtype).element_size()


def model_max_clusters(n_sm: int) -> Dict[int, int]:
    """How many clusters of each size a card of ``n_sm`` SMs holds at once,
    one CTA an SM, when the card cannot be asked: a cluster lies within one
    GPC, modelled as 8 GPCs sharing the SMs evenly (pairs fit anywhere).
    On an H100 SXM (132 SMs) this gives 66, 32 (the card says 30), 16 (15)
    and 8 (7) clusters of 2, 4, 8 and 16; the wrappers ask the card
    (``cudaOccupancyMaxActiveClusters``)."""
    gpc = n_sm // 8
    return {c: n_sm // c if c <= 2 else 8 * (gpc // c) for c in CLUSTER_SIZES}


def cluster_size(tp: int, groups: int, max_clusters: Mapping[int, int],
                 sizes: Sequence[int] = CLUSTER_SIZES) -> int:
    """The largest cluster (at most one CTA a block of 8 positions) of which
    the card holds all ``groups`` at once: a grid that does not fit runs as a
    second wave, which costs more than a smaller cluster (at [696,696,128]
    fp32 on an H100, 16 clusters of 8 took 0.85 ms, 16 of 6 0.49 ms:
    ``scripts/study_cluster_dp.py --sweep``).  Any of ``sizes`` may be
    taken, not only powers of two."""
    blocks = -(-tp // BLOCK)
    best = 1
    for c in sizes:
        if c <= blocks and groups <= max_clusters.get(c, 0):
            best = c
    return best


def card_max_clusters(query, tp: int, dtype: torch.dtype, index: int) -> Dict[int, int]:
    """The card's own count of co-resident clusters of each size for a
    kernel at ``tp`` positions, from its library's ``<name>_max_clusters``
    (``query``, a ctypes function: tp, cluster, bf16, device, int* count);
    0 for a size the card refuses.  Asked once for each argument set."""
    key = (id(query), tp, dtype, index)
    if key not in _CARD_MAX_CLUSTERS:
        counts = {}
        for c in CLUSTER_SIZES:
            n = ctypes.c_int(0)
            err = query(tp, c, int(dtype == torch.bfloat16), index, ctypes.byref(n))
            counts[c] = n.value if err == 0 else 0
        _CARD_MAX_CLUSTERS[key] = counts
    return _CARD_MAX_CLUSTERS[key]


_CARD_MAX_CLUSTERS: Dict[tuple, Dict[int, int]] = {}


def launch_plan(tp: int, nbp: int, dtype: torch.dtype, n_sm: int, cluster: Optional[int] = None,
         max_clusters: Optional[Mapping[int, int]] = None) -> LaunchPlan:
    """The grid of either kernel for scores [tp, tp, nbp] of ``dtype`` on a
    card of ``n_sm`` SMs: a CTA a 32-byte lane sector and a share of the
    earlier positions, the CTAs of a lane group one cluster of ``cluster``
    CTAs, or of the largest size of which the card holds all groups at once
    (``max_clusters``: the card's counts, or ``model_max_clusters``).
    Shared memory, the same layout in both kernels: two buffers of the
    cluster's 8-byte partials [cluster, 8, lanes] (a packed key, or a (max,
    sum) pair), the merged partials [8, lanes] and the CTA's ceil(tp /
    cluster) rows of the table."""
    lanes = lanes_per_cta(dtype)
    groups = nbp // lanes
    if cluster is None:
        cluster = cluster_size(tp, groups, max_clusters or model_max_clusters(n_sm))
    elif cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster} is not one of {CLUSTER_SIZES}")
    smem = (2 * cluster + 1) * BLOCK * lanes * 8 + -(-tp // cluster) * lanes * 4
    return LaunchPlan(lanes, groups, cluster, smem)


def alpha_launch_plan(tp: int, nbp: int, dtype: torch.dtype, n_sm: int,
                      cluster: Optional[int] = None,
                      max_clusters: Optional[Mapping[int, int]] = None) -> LaunchPlan:
    """The alpha kernel's grid, as ``launch_plan`` with a row of
    ``ALPHA_ROW_BYTES`` a CTA and a cluster of at most 8 CTAs (the TMA unit's
    largest element stride), and its ring: ``ALPHA_STAGES`` stages, each a
    box of 8 ends x ``rows`` owned begins (2 a slot of a warp; the box
    traverses rows x C <= 256 begins).  Shared memory: the ring, the two
    buffers of partials and the table rows as ``launch_plan``'s (each corner
    thread merges its own partials, so there is no merged buffer), and the
    ring's two 8-byte mbarriers a stage.  A CTA is the 8 warps of
    ``launch_plan``'s, a corner thread a (position, lane) and a producer
    warp."""
    row_bytes = ALPHA_ROW_BYTES[dtype]
    lanes = lanes_per_cta(dtype, row_bytes)
    groups = nbp // lanes
    if cluster is None:
        cluster = cluster_size(tp, groups, max_clusters or model_max_clusters(n_sm),
                               ALPHA_CLUSTER_SIZES)
    elif cluster not in ALPHA_CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster} is not one of {ALPHA_CLUSTER_SIZES}")
    rows = 2 * (32 // (row_bytes // 16))
    ring = ALPHA_STAGES * BLOCK * rows * row_bytes
    smem = (ring + 2 * cluster * BLOCK * lanes * 8 + -(-tp // cluster) * lanes * 4
            + 2 * ALPHA_STAGES * 8)
    return LaunchPlan(lanes, groups, cluster, smem, row_bytes, ALPHA_STAGES, rows,
                      THREADS + BLOCK * lanes + 32)


def card_plan(s: torch.Tensor, query, cluster: Optional[int] = None, plan=launch_plan) -> LaunchPlan:
    """The plan a wrapper launches the CUDA scores ``s`` with: ``plan``
    (``launch_plan`` or ``alpha_launch_plan``) with its card's SM count and
    the card's own count of co-resident clusters (``query``: the kernel
    library's ``<name>_max_clusters``)."""
    tp, _, nbp = s.shape
    index = s.device.index
    return plan(tp, nbp, s.dtype, sm_count(index), cluster,
                card_max_clusters(query, tp, s.dtype, index))


def lanes_of_cta(plan: LaunchPlan, cta: int) -> range:
    """The lanes CTA ``cta`` of the grid reads (clusters are consecutive
    CTAs along x)."""
    group = cta // plan.cluster
    return range(group * plan.lanes, (group + 1) * plan.lanes)


def others_of_thread(plan: LaunchPlan, rank: int, slot: int, k0: int) -> List[int]:
    """The earlier positions m < k0 (processing order) whose scores the
    threads of ``slot`` in CTA ``rank`` reduce for the block starting at
    ``k0``: m = rank + C*u, u = slot, slot + slots, ... (``owned_below`` and
    ``pieces_of_slot`` in the kernels; in the alpha kernel row u of the ring
    is row u % rows of stage u // rows, and a stage holds 2 rows a slot)."""
    c, slots = plan.cluster, plan.slots
    count = (owned_below(plan, rank, k0) - slot + slots - 1) // slots
    return [rank + c * (slot + slots * t) for t in range(max(count, 0))]


def owned_below(plan: LaunchPlan, rank: int, k0: int) -> int:
    """How many earlier positions m < k0 CTA ``rank`` owns (m = rank mod C)."""
    c = plan.cluster
    return (k0 - rank + c - 1) // c if k0 > rank else 0


def boxes_of_block(plan: LaunchPlan, rank: int, k0: int) -> List[List[int]]:
    """The begins each TMA box of the alpha kernel loads for CTA ``rank`` and
    the block starting at ``k0``: box j starts at begin rank + C*rows*j and
    takes every C-th of the ``box[1]`` begins it traverses (``stages_of``
    and ``issue`` in the kernel)."""
    c = plan.cluster
    first = [rank + c * plan.rows * j for j in range(-(-owned_below(plan, rank, k0) // plan.rows))]
    return [list(range(m, m + plan.box[1], plan.element_strides[1])) for m in first]


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
