"""The control of the benchmark's correctness check, for setting its limits
(not part of the benchmark's runs):

    python bench_port/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

With ``--fault <name>`` a fault of ``benchlib/faults.py`` is planted under
the timed path first, and the program's numbers alone are read.

For each seed, in one process: the cell's driver runs its set-up and a
window of ``--seconds``, the program's numbers are read against the plain
reference as a benchmark run reads them, and then the control, the same
reference computed with its float32 products in TF32, is read against the
float32 reference in the same way.  One JSON line a seed: the program's
readings, the control's, and the end-to-end values.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, type=int, nargs="+")
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--fault", default=None,
                        help="plant a fault of benchlib/faults.py under the timed path and read the program "
                        "alone")
    args = parser.parse_args(argv)

    from benchlib import env, manifest, runner

    env.prepare(ROOT)
    cell = manifest.load_cell(ROOT, args.workload)
    env.require_devices(cell.chips)
    driver = manifest.load_module("drivers", cell.params["driver"])
    if args.fault:
        from benchlib import faults

        getattr(faults, args.fault)(setattr)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = runner.Run(argparse.Namespace(seed=seed, seconds=args.seconds, trace=0), cell, t0, ROOT)
        run.control = not args.fault
        try:
            driver.measure(run)
            driver.check(run)
        finally:
            run.cleanup()
            run.free()
        print(json.dumps({"seed": seed, "program": {k: v for k, (v, _) in run.checks.items()},
                          "control": run.control_readings, "e2e": run.e2e, "setup_s": run.setup_s,
                          "notes": {k: v for k, v in run.notes.items() if not isinstance(v, list)},
                          "leaf_gaps": getattr(run, "leaf_gaps", None)}),
              flush=True)


if __name__ == "__main__":
    main()
