"""Time the port's reader of the JAX package's orbax checkpoints on the host.

    JAX_PLATFORMS=cpu taskset -c 0 python scripts/time_orbax_read.py DIR [--runs 3]

If ``DIR`` holds no checkpoint yet, the JAX package (on the CPU) first
writes one there with ``save_checkpoint``: a flagship V2 (``2.0.conf``)
state of seeded float32 weights (13,615,503 values, 54.5 MB a copy), its
``best_params`` another seeded copy.  Then, with the port alone, it times
(median and range of ``--runs``):

- ``load_params(DIR, conf)``: ``best_params`` alone, decoded and turned
  into the V2 state_dict (what ``cli.transcribe --weight DIR`` does);
- the zstd decode of those chunks alone (``utils.zstd.decompress_many``);
- ``load_orbax_checkpoint(DIR)``: the whole tree (params, both AdaBelief
  moments, best params, clip state).

It prints the CPU's model name and the number of cores the process may
use, beside the times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_flagship(path: str) -> None:
    """A flagship V2 train state with seeded weights, through the JAX
    package's ``save_checkpoint`` (runs JAX on the CPU)."""
    import jax

    from transkun_tpu.models import TransKun
    from transkun_tpu.models.config import load_default_conf
    from transkun_tpu.train import init_train_state, make_optimizer
    from transkun_tpu.train.checkpoint import save_checkpoint

    _, conf = load_default_conf()
    shapes = jax.eval_shape(lambda k: TransKun(conf).init(k, n_frames=33), jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    best = jax.tree.map(lambda a: a + np.float32(0.01), params)
    state = init_train_state(params, make_optimizer(params["params"]))
    save_checkpoint(path, state, best_params=best, extra={"epoch": 1})


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not os.path.isdir(args.path):
        t0 = time.perf_counter()
        write_flagship(args.path)
        print(f"wrote {args.path} with the JAX package in {time.perf_counter() - t0:.1f} s")

    from transkun_tpu_torch.models.config import load_default_conf
    from transkun_tpu_torch.train.checkpoint import load_orbax_checkpoint, load_params
    from transkun_tpu_torch.utils.orbax_read import OrbaxCheckpoint
    from transkun_tpu_torch.utils.zstd import decompress_many

    _, conf = load_default_conf()
    ckpt = OrbaxCheckpoint(args.path)
    store = ckpt.store
    chunks = [store.read(k) for k in store.list()
              if k.startswith(b"best_params.") and not k.endswith(b"/.zarray")]

    def timed(fn):
        out = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            result = fn()
            out.append(time.perf_counter() - t0)
        return out, result

    params_s, sd = timed(lambda: load_params(args.path, conf))
    decode_s, raw = timed(lambda: decompress_many(chunks))
    tree_s, _ = timed(lambda: load_orbax_checkpoint(args.path))
    n_values = sum(v.numel() for v in sd.values())
    report = {
        "cpu": cpu_name(), "cores_usable": len(os.sched_getaffinity(0)),
        "best_params_values": n_values, "best_params_chunks": len(chunks),
        "compressed_bytes": sum(map(len, chunks)), "decoded_bytes": sum(map(len, raw)),
        "load_params_s": params_s, "decode_s": decode_s, "whole_tree_s": tree_s,
    }
    for name in ("load_params_s", "decode_s", "whole_tree_s"):
        print(f"{name}: median {float(np.median(report[name])):.3f} s, "
              f"{min(report[name]):.3f}-{max(report[name]):.3f}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
