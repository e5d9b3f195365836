"""Conf-template generator of the port (plays the role of ``python3 -m
moduleconf.generate`` in the reference workflow; ``transkun_tpu/cli/gen_conf.py``):

    python -m transkun_tpu_torch.cli.gen_conf transkun_tpu_torch.models.transkun > model.conf

The file loads with ``models.config.parse_conf_file``.
"""

import argparse
import importlib
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "module", nargs="?", default="transkun_tpu_torch.models.transkun",
        help="model module exposing Config (default: the V2 transformer)",
    )
    args = parser.parse_args(argv)

    module = importlib.import_module(args.module)
    conf = module.Config()
    d = conf.to_dict() if hasattr(conf, "to_dict") else dict(conf.__dict__)
    json.dump(
        {
            "Model": {
                "module": args.module,
                "configClassName": "Config",
                "config": d,
            }
        },
        sys.stdout,
        indent=2,
    )
    print()


if __name__ == "__main__":
    main()
