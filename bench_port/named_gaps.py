"""A cell's traced run with its idle gaps named by the program's spans (not
part of the benchmark's runs):

    python bench_port/named_gaps.py --workload <name> --seed <n> --seconds <s>

Runs the cell as ``run.py --trace 1`` does and prints its result line; then
one more JSON line: the traced stretch's idle gaps, each named
``<harness span>/<innermost transkun.* span>`` (``benchlib.spans.name_gaps``),
the longest first, and their seconds summed by name.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

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
    parser.add_argument("--top", default=20, type=int, help="gaps listed one by one")
    args = parser.parse_args(argv)

    import run
    from benchlib import spans, trace

    run.T0 = T0
    found = []
    summarize = trace.summarize

    def summarize_and_name(events):
        events = list(events)
        found.append(spans.name_gaps(events))
        return summarize(events)

    trace.summarize = summarize_and_name
    run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
              "--trace", "1"])
    gaps = found[-1]
    by_name = defaultdict(float)
    for name, s in gaps:
        by_name[name] += s
    print(json.dumps({"named_gaps": gaps[:args.top],
                      "idle_s_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]))}), flush=True)


if __name__ == "__main__":
    main()
