"""Dataset-build CLI (counterpart of ``python3 -m transkun.createDatasetMaestro``):
MAESTRO metadata -> {train,val,test}.pickle annotation files.

    python -m transkun_tpu_torch.cli.create_dataset_maestro maestroDIR meta.csv  outDIR
    python -m transkun_tpu_torch.cli.create_dataset_maestro maestroDIR meta.json outDIR

A ``.json`` metadata file is parsed as the MAESTRO v3 layout (column-major
``maestro-v3.0.0.json``; row-major lists also accepted), anything else as the
v1/v2 csv (ref ``createDatasetMaestro.py:9-51`` reads csv only — v3 json
support is an extension so the shipped v3 tree works unconverted).

The port's own copy of ``transkun_tpu/cli/create_dataset_maestro.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("datasetPath", help="folder path of the maestro dataset")
    parser.add_argument("metadataCSVPath",
                        help="path to the maestro metadata file (csv, or the "
                        "v3 json — dispatched on the .json extension)")
    parser.add_argument("outputPath", help="output folder for the pickles")
    parser.add_argument(
        "--noPedalExtension", action="store_true",
        help="do not extend notes to the sustain-pedal release",
    )
    args = parser.parse_args(argv)

    from ..data.dataset import (
        create_dataset_maestro_csv,
        create_dataset_maestro_json,
    )

    build = (
        create_dataset_maestro_json
        if args.metadataCSVPath.lower().endswith(".json")
        else create_dataset_maestro_csv
    )
    dataset = build(
        args.datasetPath, args.metadataCSVPath,
        extend_sustain_pedal=not args.noPedalExtension,
    )

    splits = {"train": [], "validation": [], "test": []}
    for e in dataset:
        if e["split"] in splits:
            splits[e["split"]].append(e)

    os.makedirs(args.outputPath, exist_ok=True)
    for name, key in [("train", "train"), ("val", "validation"), ("test", "test")]:
        with open(os.path.join(args.outputPath, f"{name}.pickle"), "wb") as f:
            pickle.dump(splits[key], f, pickle.HIGHEST_PROTOCOL)
        print(f"{name}: {len(splits[key])} pieces")


if __name__ == "__main__":
    main()
