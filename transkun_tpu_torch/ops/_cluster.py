"""Launch plans of the blocked semi-CRF kernels that run as thread-block
clusters (``csrc/cluster_dp.cuh``: the Viterbi kernel and the beta kernel).

A CTA owns one lane group, a 32-byte sector of each score row (8 fp32 or 16
bf16 lanes), and the earlier positions ``m = rank (mod C)`` of the cluster
of C CTAs that share the group.  The plan is made here, on the host, so that
the CPU tests can check it; the C functions take the cluster size and derive
the rest.  The constants mirror the kernels'.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Mapping, Optional

import torch

BLOCK = 8  # positions a block, one warp each
THREADS = BLOCK * 32  # threads a CTA
SLOTS = 16  # slots of earlier positions a warp: 16 slots x 2 halves of a sector
SECTOR = 32  # bytes of a score row one CTA owns
CLUSTER_SIZES = tuple(range(1, 17))  # above 8 needs the non-portable attribute
PORTABLE_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """``lanes`` a CTA, ``groups`` of them, ``cluster`` CTAs sharing a group,
    ``smem`` bytes of dynamic shared memory a CTA."""

    lanes: int
    groups: int
    cluster: int
    smem: int

    @property
    def ctas(self) -> int:
        return self.groups * self.cluster

    @property
    def threads(self) -> int:
        return THREADS

    @property
    def portable(self) -> bool:
        return self.cluster <= PORTABLE_CLUSTER


def lanes_per_cta(dtype: torch.dtype) -> int:
    """Lanes of one 32-byte sector of ``dtype`` scores: 8 fp32, 16 bf16."""
    return SECTOR // torch.empty((), dtype=dtype).element_size()


def model_max_clusters(n_sm: int) -> Dict[int, int]:
    """How many clusters of each size a card of ``n_sm`` SMs holds at once,
    one CTA an SM, when the card cannot be asked: a cluster lies within one
    GPC, modelled as 8 GPCs sharing the SMs evenly (pairs fit anywhere).
    On an H100 SXM (132 SMs) this gives 66, 32 (the card says 30), 16 (15)
    and 8 (7) clusters of 2, 4, 8 and 16; the wrappers ask the card
    (``cudaOccupancyMaxActiveClusters``)."""
    gpc = n_sm // 8
    return {c: n_sm // c if c <= 2 else 8 * (gpc // c) for c in CLUSTER_SIZES}


def cluster_size(tp: int, groups: int, max_clusters: Mapping[int, int]) -> int:
    """The largest cluster (at most one CTA a block of 8 positions) of which
    the card holds all ``groups`` at once: a grid that does not fit runs as a
    second wave, which costs more than a smaller cluster (at [696,696,128]
    fp32 on an H100, 16 clusters of 8 took 0.85 ms, 16 of 6 0.49 ms:
    ``scripts/study_cluster_dp.py --sweep``).  Any
    size from 1 to 16 may be taken, not only powers of two."""
    blocks = -(-tp // BLOCK)
    best = 1
    for c in CLUSTER_SIZES:
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


def card_plan(s: torch.Tensor, query, cluster: Optional[int] = None) -> LaunchPlan:
    """The plan a wrapper launches the CUDA scores ``s`` with: ``launch_plan`` with
    its card's SM count and the card's own count of co-resident clusters
    (``query``: the kernel library's ``<name>_max_clusters``)."""
    tp, _, nbp = s.shape
    index = s.device.index
    return launch_plan(tp, nbp, s.dtype, sm_count(index), cluster,
                card_max_clusters(query, tp, s.dtype, index))


def lanes_of_cta(plan: LaunchPlan, cta: int) -> range:
    """The lanes CTA ``cta`` of the grid reads (clusters are consecutive
    CTAs along x)."""
    group = cta // plan.cluster
    return range(group * plan.lanes, (group + 1) * plan.lanes)


def others_of_thread(plan: LaunchPlan, rank: int, slot: int, k0: int) -> List[int]:
    """The earlier positions m < k0 (processing order) whose scores the
    threads of ``slot`` in CTA ``rank`` reduce for the block starting at
    ``k0``: m = rank + C*u, u = slot, slot + 16, ... (``owned_below`` and
    ``pieces_of_slot`` in the kernels)."""
    c = plan.cluster
    u_hi = (k0 - rank + c - 1) // c if k0 > rank else 0
    count = (u_hi - slot + SLOTS - 1) // SLOTS if u_hi > slot else 0
    return [rank + c * (slot + SLOTS * t) for t in range(count)]


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
