"""Evaluation CLI of the port (counterpart of ``transkunEval`` =
``transkun/computeMetrics.py``, and of ``transkun_tpu/cli/compute_metrics.py``):
note, pedal and frame metrics of estimated against ground-truth MIDI
directory trees, from numpy, scipy and the port's own ``data`` and ``eval``
modules.

    python -m transkun_tpu_torch.cli.compute_metrics estDIR gtDIR --outputJSON out.json
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import random
import multiprocessing
import statistics

import numpy as np


def evaluate_one(task):
    (
        path, est_path, gt_path, extend_pedal, compute_deviations, pedal_offset,
        align_onset, dither, extend_pedal_est, onset_tolerance,
    ) = task
    from ..data.dataset import parse_midi_file
    from ..data.note import resolve_overlapping
    from ..eval.evaluation import compare_transcription

    audio_name = str(path.relative_to(est_path))
    target_path = gt_path / path.relative_to(est_path)
    notes_est = parse_midi_file(str(path), extend_sustain_pedal=extend_pedal_est)
    notes_gt = parse_midi_file(
        str(target_path), extend_sustain_pedal=extend_pedal,
        pedal_ext_offset=pedal_offset,
    )

    metrics = compare_transcription(
        notes_est, notes_gt, split_pedal=True,
        compute_deviations=compute_deviations, onset_tolerance=onset_tolerance,
    )

    # optional realignment by the median matched-onset deviation
    # (ref ``computeMetrics.py:42-61``)
    onset_dev = [d[1] for d in metrics["deviations"]]
    if align_onset and onset_dev:
        median_onset = statistics.median(onset_dev)
        max_dev = max(max(onset_dev), -min(onset_dev))
        for n in notes_gt:
            n.start += max_dev - median_onset
            n.end += max_dev - median_onset
        for n in notes_est:
            n.start += max_dev
            n.end += max_dev
    if dither != 0.0:
        for n in notes_gt:
            n.start += dither
            n.end += dither
        for n in notes_est:
            r = (random.random() * 2 - 1) * dither
            n.start += dither + r
            n.end += dither + r
        notes_est = resolve_overlapping(notes_est)
    if align_onset or dither != 0.0:
        metrics = compare_transcription(
            notes_est, notes_gt, split_pedal=True,
            compute_deviations=compute_deviations,
        )
    return metrics, audio_name


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=(
            "compute metrics directly from MIDI files.\n"
            "estDIR should mirror the folder structure of groundTruthDIR.\n"
            "Metrics are ordered precision, recall, f1, overlap."
        ),
        formatter_class=argparse.RawTextHelpFormatter,
    )
    parser.add_argument("estDIR")
    parser.add_argument("groundTruthDIR")
    parser.add_argument("--outputJSON", help="save detailed per-file metrics")
    parser.add_argument("--noPedalExtension", action="store_true",
                        help="no sustain-pedal note extension on the ground truth")
    parser.add_argument("--applyPedalExtensionOnEstimated", action="store_true")
    parser.add_argument("--nProcess", nargs="?", type=int, default=1)
    parser.add_argument("--alignOnset", action="store_true")
    parser.add_argument("--dither", default=0.0, type=float)
    parser.add_argument("--pedalOffset", default=0.0, type=float)
    parser.add_argument("--onsetTolerance", default=0.05, type=float)
    args = parser.parse_args(argv)

    est_path = pathlib.Path(args.estDIR)
    gt_path = pathlib.Path(args.groundTruthDIR)

    filenames = list(est_path.glob(os.path.join("**", "*.midi"))) + list(
        est_path.glob(os.path.join("**", "*.mid"))
    )
    filenames = [
        f for f in filenames if (gt_path / f.relative_to(est_path)).exists()
    ]

    tasks = [
        (
            f, est_path, gt_path, not args.noPedalExtension, True,
            args.pedalOffset, args.alignOnset, args.dither,
            args.applyPedalExtensionOnEstimated, args.onsetTolerance,
        )
        for f in filenames
    ]
    if args.nProcess > 1:
        with multiprocessing.get_context("spawn").Pool(args.nProcess) as pool:
            metrics_all = list(pool.imap_unordered(evaluate_one, tasks))
    else:
        metrics_all = [evaluate_one(t) for t in tasks]

    agg = collections.defaultdict(list)
    for m, _ in metrics_all:
        for key in m:
            agg[key].append(m[key])

    result_agg = {}
    for key, vals in agg.items():
        if key == "deviations":
            dev_all = [d for v in vals for d in v]
            if dev_all:
                import scipy.stats

                dev_onset = np.array([d[1] for d in dev_all])
                dev_offset = np.array([d[2] for d in dev_all])
                result_agg["deviation_onset_normality"] = float(
                    scipy.stats.anderson(dev_onset).statistic
                )
                result_agg["deviation_offset_normality"] = float(
                    scipy.stats.anderson(dev_offset).statistic
                )
        else:
            result_agg[key] = np.mean(np.array(vals), axis=0).tolist()

    for key in result_agg:
        print(f"{key}: {result_agg[key]}")

    if args.outputJSON is not None:
        detailed = [{"name": name, "metrics": m} for m, name in metrics_all]
        with open(args.outputJSON, "w") as f:
            json.dump({"aggregated": result_agg, "detailed": detailed}, f, indent="\t")


if __name__ == "__main__":
    main()
