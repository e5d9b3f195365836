"""Validation pass (counterpart of ``doValidation``,
``TrainUtil.py:231-272``): mean NLL per audio second and note-with-offset
precision, recall and F1 over a validation loader.

Port of ``transkun_tpu/train/validate.py`` without the per-device threads
(one process drives one device here): under data parallelism each rank
validates its own loader shard and the 5-vector is summed over the ranks
(``aggregate_across_processes``) before the metrics are derived.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.dist import all_reduce_sum, process_info

AGG_KEYS = ("logProb", "length", "nGT", "nEst", "nCorrect")


@torch.no_grad()
def compute_metrics(model, audio_batch, notes_batch) -> Dict[str, float]:
    logp = float(model.log_prob(audio_batch, notes_batch).sum(-1).mean())
    stats = model.compute_stats_mireval(audio_batch, notes_batch)
    return {
        "logProb": logp,
        "length": audio_batch.shape[1],
        "nGT": stats["nGT"],
        "nEst": stats["nEst"],
        "nCorrect": stats["nCorrect"],
    }


def _metrics_from_agg(agg: Dict[str, float]) -> Dict[str, float]:
    precision = agg["nCorrect"] / max(agg["nEst"], 1e-8)
    recall = agg["nCorrect"] / max(agg["nGT"], 1e-8)
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    return {
        "meanNLL": -agg["logProb"] / max(agg["length"], 1e-8),
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def validation_counts(model, loader, fs: int) -> Dict[str, float]:
    """The raw 5-vector (summed log-probability, seconds of audio, nGT,
    nEst, nCorrect) over the loader's batches, in batch order."""
    agg = dict.fromkeys(AGG_KEYS, 0.0)
    for b in loader:
        r = compute_metrics(model, b["audioSlices"], b["notes"])
        agg["logProb"] += r["logProb"]
        agg["length"] += r["length"] / fs
        for k in ("nGT", "nEst", "nCorrect"):
            agg[k] += r[k]
    return agg


def aggregate_across_processes(agg: Dict[str, float], group=None) -> Dict[str, float]:
    """The 5-vector summed over the group's ranks in float64 (the
    reference's ``dist.all_reduce``, ``TrainUtil.py:257-258``); ``agg``
    itself in one process."""
    if process_info(group)[1] == 1:
        return agg
    vec = torch.tensor([agg[k] for k in AGG_KEYS], dtype=torch.float64)
    return dict(zip(AGG_KEYS, all_reduce_sum(vec, group).tolist()))


def do_validation(model, loader, fs: int, group=None) -> Dict[str, float]:
    """Validate the loader (this rank's shard under data parallelism),
    sum the counts over ``group``'s ranks and derive the metrics."""
    return _metrics_from_agg(aggregate_across_processes(validation_counts(model, loader, fs), group))
