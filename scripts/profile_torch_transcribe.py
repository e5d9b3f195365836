"""Where the time of one flagship transcription goes, in the PyTorch port.

    python scripts/profile_torch_transcribe.py [--seconds 64] [--seed 0] [--bf16]
        [--budget N]

Needs a CUDA device.  Random flagship weights from ``--seed`` (scorer
diagonal bias -8), a synthetic piece from ``chip_smoke.synth_piece``.  After
one warm-up run it times one run with host-clock spans around the stages of
``TransKun.transcribe`` (the dispatch, and in it the segments' enqueue; the
finish, and in it the wait for the piece's event, the assembly, the merge
and any host-walk route) and, in a second run under ``torch.profiler``, sums
the device time of every CUDA kernel.  Prints one JSON object.
``--budget`` sets ``decode_k_budget`` (1: the host-walk route from the first
group).

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
from collections import defaultdict

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
    from transkun_tpu_torch.ops import attention, mlp, semicrf, walk

    _, conf = load_default_conf()
    model = tk.TransKun(conf, device="cuda", seed=args.seed,
                        compute_dtype=torch.bfloat16 if args.bf16 else None)
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] = -8.0
    model.decode_k_budget = args.budget
    audio = chip_smoke.synth_piece(conf.fs, args.seconds, args.seed)
    model.transcribe(audio)
    torch.cuda.synchronize()

    # host-clock spans: each wrapped stage adds its own duration
    spans = defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans[name] += time.perf_counter() - t0
        return wrapper

    # "a.b" spans lie inside span "a"
    stages = [
        (tk.TransKun, "_transcribe_dispatch", "dispatch"),
        (tk.TransKun, "_segment_tables", "dispatch.enqueue_segments"),
        (walk, "walk_group", "dispatch.enqueue_walk"),
        (tk.TransKun, "_transcribe_finish", "finish"),
        (torch.cuda.Event, "synchronize", "finish.wait_for_device"),
        (tk.TransKun, "_assemble_from_arrays", "finish.assembly"),
        (tk.TransKun, "_transcribe_host_walk", "finish.host_walk_route"),
        (semicrf, "backtrack_backward", "finish.host_walk_route.walk"),
        (tk, "_merge_segments", "finish.merge"),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for obj, attr, name in stages:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        t0 = time.perf_counter()
        notes = model.transcribe(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    spans["rest"] = wall - spans["dispatch"] - spans["finish"]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.transcribe(audio)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    # device-side events only: the aten ops that launched them carry the
    # same time again
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)

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
        "spans_s": dict(spans),
        "profiled_wall_s": profiled_wall,
        "device_kernel_ms_profiled_run": device_ms,
        "device_busy_share_profiled_run": device_ms / 1e3 / profiled_wall,
        # attention_fwd_mma or attention_fwd_general, whichever the shape took
        "own_kernels_ms": {name: ms_of(name + ("_" if name == "attention_fwd" else "_kernel"))
                           for name in ("viterbi_bwd", "decode_walk", "attention_fwd", "fused_mlp")},
        "gemm_ms": ms_of("gemm", "sm90_xmma", "cutlass"),
        "top_kernels_ms": [[k[:90], round(ms, 3), n] for k, ms, n in kernels[:12]],
    }, indent=1))


if __name__ == "__main__":
    main()
