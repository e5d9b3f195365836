"""Deviation plotting CLI of the port (counterpart of
``transkun/plotDeviation.py`` and ``transkun_tpu/cli/plot_deviation.py``):
ECDF / KDE curves of onset or offset deviations from ``compute_metrics``
JSONs.  ``matplotlib`` and ``seaborn`` (the ``plot`` extra) are imported
when it runs.

    python -m transkun_tpu_torch.cli.plot_deviation eval1.json --cumulative --output p.png
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="plot the distribution of onset/offset deviations"
    )
    parser.add_argument("evalJsons", nargs="+",
                        help="output jsons from compute_metrics (with deviations)")
    parser.add_argument("--labels", nargs="*", default=[])
    parser.add_argument("--offset", action="store_true",
                        help="plot offset deviations (default: onset)")
    parser.add_argument("--T", default=50, type=float, help="time limit (ms)")
    parser.add_argument("--output", nargs="?", help="filename to save")
    parser.add_argument("--noDisplay", action="store_true")
    parser.add_argument("--cumulative", action="store_true")
    parser.add_argument("--absolute", action="store_true")
    parser.add_argument("--targetPitch", required=False, type=int)
    args = parser.parse_args(argv)

    import matplotlib

    if args.noDisplay or args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    import seaborn as sns

    legends = args.labels if args.labels else args.evalJsons
    if len(legends) != len(args.evalJsons):
        raise SystemExit("number of labels must match the number of evalJsons")

    t = args.T
    plt.yticks(np.arange(0, 1, 0.05))
    plt.xticks(np.arange(-t, t, t / 10))
    plt.xlim(-t, t)
    plt.grid()
    plt.xlabel(("Offset" if args.offset else "Onset") + " Deviation (ms)")
    plt.ylabel("Cumulative Probability" if args.cumulative else "Probability Density")

    for json_file in args.evalJsons:
        with open(json_file) as f:
            details = json.load(f)["detailed"]
        devs = np.array(
            [d for e in details for d in e["metrics"].get("deviations", [])]
        )
        pitch = devs[:, 0]
        devs = devs[:, 2] if args.offset else devs[:, 1]
        if args.targetPitch is not None:
            devs = devs[pitch == args.targetPitch]
        if args.absolute:
            devs = np.abs(devs)
        if args.cumulative:
            sns.ecdfplot(1000 * devs)
        else:
            sns.kdeplot(1000 * devs, gridsize=8000)

    plt.legend(title="", loc="upper left", labels=legends)
    if args.output is not None:
        plt.savefig(args.output, dpi=300)
    if not args.noDisplay:
        plt.show()


if __name__ == "__main__":
    main()
