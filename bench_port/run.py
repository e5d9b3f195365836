"""The benchmark of transkun_tpu_torch on the card:

    python bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Reads the cell from ``BENCHMARK.json`` and
the files it names under ``bench_port/``, runs the cell's driver (set-up
and warm-up, then ``--seconds`` of its traffic; with ``--trace 1`` also a
profiled stretch), checks what the timed path produced against the plain
reference in ``bench_port/reference``, and prints one JSON result as the
last line of standard output.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
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
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = parser.parse_args(argv)

    from benchlib import env, manifest, runner

    env.prepare(ROOT)
    cell = manifest.load_cell(ROOT, args.workload)
    kind = env.require_devices(cell.chips)
    import transkun_tpu_torch  # noqa: F401  (the program: absent in a checkout of the benchmark alone)

    driver = manifest.load_module("drivers", cell.params["driver"])
    run = runner.Run(args, cell, T0, ROOT)
    try:
        driver.measure(run)
        driver.check(run)
    finally:
        run.cleanup()
    runner.emit(run, kind)


if __name__ == "__main__":
    main()
