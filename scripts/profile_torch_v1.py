"""Where the time of the V1 model goes, in the PyTorch port: one
transcription and one training step at full width (``AblationConfig()``).

    python scripts/profile_torch_v1.py [--seconds 64] [--batch 2] [--steps 3]

Needs a CUDA device.  The model of ``chip_smoke.v1_model`` (random weights
from chip_smoke's seed, the scorer's last bias shifted), the synthetic piece
of ``chip_smoke.synth_piece``.  Transcription: after a warm-up run, one run
with host-clock spans around the device work of each segment (ending in a
synchronize), the pointer walk and the rest (attributes and note assembly),
then one run under ``torch.profiler``.  Training: ``--steps`` steps of
``make_train_step`` on ``--batch`` 16 s slices of the piece with its notes
left empty (the step's cost does not depend on them), the first a warm-up,
then one step under ``torch.profiler``.  Kernels are summed by kind (by
name): the port's semi-CRF kernels, convolutions, the GRU, dense products,
concatenations and the rest.
Prints one JSON object.
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = (  # name fragments of each kind, lower case, first match wins
    ("viterbi_bwd", ("viterbi_bwd",)),
    ("semicrf_alpha", ("alpha_tma",)),
    ("semicrf_beta", ("lse_cluster",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "winograd", "implicit")),
    # the GRU's cell kernels and its per-step products (cuBLAS gemv and
    # small batched products, a launch a step and direction)
    ("gru", ("rnn", "gru", "gemvx", "gemmsn")),
    ("gemm", ("gemm", "cutlass", "gemv")),
    ("concatenation", ("catarray",)),
)


def kernel_breakdown(prof):
    """(kernels [(name, ms, count)] sorted by time, ms by kind)."""
    import torch

    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    by_kind = defaultdict(float)
    for name, ms, _ in kernels:
        kind = next((k for k, parts in KINDS if any(p in name.lower() for p in parts)), "other")
        by_kind[kind] += ms
    return kernels, dict(by_kind)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=64.0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    import transkun_tpu_torch.models.ablation as ab
    from transkun_tpu_torch.ops import semicrf
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda")
    audio = chip_smoke.synth_piece(44100, args.seconds, chip_smoke.SEED)
    model, _ = chip_smoke.v1_model(dev, audio)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {"card": chip_smoke.card_line(), "seconds": args.seconds}

    # -- transcription ---------------------------------------------------------
    model.transcribe(audio)
    torch.cuda.synchronize()
    spans = defaultdict(float)

    def timed(name, fn, sync=False):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                result = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                return result
            finally:
                spans[name] += time.perf_counter() - t0
        return wrapper

    stages = [(ab.TransKunAblation, "_decode", "device_work", True),
              (semicrf, "backtrack_backward", "host_walk", False),
              (ab.TransKunAblation, "transcribe_frames", "transcribe_frames", False)]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _, _ in stages]
    for obj, attr, name, sync in stages:
        setattr(obj, attr, timed(name, getattr(obj, attr), sync))
    try:
        t0 = time.perf_counter()
        notes = model.transcribe(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    spans["attributes_and_assembly"] = spans.pop("transcribe_frames") - spans["device_work"] - spans["host_walk"]
    spans["rest"] = wall - sum(spans.values())
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.transcribe(audio)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels, by_kind = kernel_breakdown(prof)
    device_ms = sum(k[1] for k in kernels)
    out["transcribe"] = {
        "notes": len(notes), "wall_s": wall, "rtf": args.seconds / wall, "spans_s": dict(spans),
        "profiled_wall_s": profiled_wall, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / profiled_wall, "kernel_ms_by_kind": by_kind,
        "top_kernels_ms": [[k[:90], round(ms, 3), n] for k, ms, n in kernels[:12]],
    }

    # -- training step ---------------------------------------------------------
    n = int(16.0 * 44100)
    x = np.stack([audio[i * n // 2 : i * n // 2 + n] for i in range(args.batch)])
    frames, labels = model.frames(x), model.labels([[] for _ in range(args.batch)])
    state = TrainState(model, AdaBelief(model.module.named_parameters()))
    step_fn = make_train_step(model)
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = []
    for k in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step_fn(state, frames, labels, torch.Generator(device=dev).manual_seed(k))["loss"])
        step_s.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step_fn(state, frames, labels, torch.Generator(device=dev).manual_seed(args.steps))["loss"])
        profiled_step = time.perf_counter() - t0
    kernels, by_kind = kernel_breakdown(prof)
    device_ms = sum(k[1] for k in kernels)
    out["train_step"] = {
        "batch": args.batch, "t": frames.shape[-2], "step_s": step_s, "peak_gb": peak_gb,
        "profiled_step_s": profiled_step, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / profiled_step, "kernel_ms_by_kind": by_kind,
        "launches": sum(k[2] for k in kernels),
        "top_kernels_ms": [[k[:90], round(ms, 3), n] for k, ms, n in kernels[:12]],
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
