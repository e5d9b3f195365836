"""Where the time of one flagship transcription goes, in the PyTorch port.

    python scripts/profile_torch_transcribe.py [--seconds 64] [--seed 0] [--bf16]
        [--budget N]

Needs a CUDA device.  Random flagship weights from ``--seed`` (scorer
diagonal bias -8), a synthetic piece from ``chip_smoke.synth_piece``.  After
one warm-up run it times one run with the program's spans on
(``TRANSKUN_TPU_TIMING=silent``; ``utils.profiling``: the dispatch with its
prepare, pin, upload and groups, the finish with its wait, assembly, merge
and any host-walk route) and reports each span's host seconds and the
counters, and in a second run under ``torch.profiler`` sums the device time
of every CUDA kernel and counts the launches.  Prints one JSON object.
``--budget`` sets ``decode_k_budget`` (1: the host-walk route from the first
group).  The device's busy and idle share over a steady stretch of many
pieces, with its idle gaps named, is the benchmark's
(``bench_port/run.py --workload v2-pieces-fp32 --trace 1``).

With ``TRANSKUN_TPU_FUSED_ATTN=1`` and ``TRANSKUN_TPU_FUSED_MLP=1`` in the
environment it profiles the fused-backbone route; the breakdown names the
port's own kernels (Viterbi, attention forward, fused MLP) beside the
library GEMMs either way.  ``--bf16`` profiles the bf16 configuration
(``compute_dtype=torch.bfloat16``).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=64.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--budget", type=int, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    import transkun_tpu_torch.models.transkun as tk
    from transkun_tpu_torch.models.config import load_default_conf
    from transkun_tpu_torch.ops import attention, mlp
    from transkun_tpu_torch.utils import profiling

    _, conf = load_default_conf()
    model = tk.TransKun(conf, device="cuda", seed=args.seed,
                        compute_dtype=torch.bfloat16 if args.bf16 else None)
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] = -8.0
    model.decode_k_budget = args.budget
    audio = chip_smoke.synth_piece(conf.fs, args.seconds, args.seed)
    model.transcribe(audio)
    torch.cuda.synchronize()

    os.environ[profiling.ENV] = "silent"
    profiling.reset()
    t0 = time.perf_counter()
    notes = model.transcribe(audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {name: seconds for name, (_, seconds) in sorted(profiling.totals().items())}
    counters = profiling.counters()
    del os.environ[profiling.ENV]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.transcribe(audio)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    # device-side events only: the aten ops that launched them carry the
    # same time again, and so do the program's spans' device rows
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not e.key.startswith("transkun.")
    ]
    kernels.sort(key=lambda k: -k[1])

    def ms_of(*parts):
        return sum(ms for name, ms, _ in kernels if any(p in name.lower() for p in parts))

    print(json.dumps({
        "card": chip_smoke.card_line(),
        "fused_attention": attention.use_fused_attention(),
        "fused_mlp": mlp.use_fused_mlp(),
        "bf16": args.bf16,
        "seconds": args.seconds,
        "notes": len(notes),
        "decode_k_budget": args.budget,
        "fallback_from": model.last_transcribe_fallback_from,
        "group_counts": model.last_transcribe_group_counts,
        "wall_s": wall,
        "rtf": args.seconds / wall,
        "spans_s": spans,
        "counters": counters,
        "profiled_wall_s": profiled_wall,
        "launches_profiled_run": sum(n for _, _, n in kernels),
        # attention_fwd_mma or attention_fwd_general, whichever the shape took
        "own_kernels_ms": {name: ms_of(name + ("_" if name == "attention_fwd" else "_kernel"))
                           for name in ("viterbi_bwd", "decode_walk", "attention_fwd", "fused_mlp")},
        "gemm_ms": ms_of("gemm", "sm90_xmma", "cutlass"),
        "top_kernels_ms": [[k[:90], round(ms, 3), n] for k, ms, n in kernels[:12]],
    }, indent=1))


if __name__ == "__main__":
    main()
