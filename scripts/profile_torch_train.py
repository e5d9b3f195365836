"""Where the time of one flagship training step goes, in the PyTorch port.

    python scripts/profile_torch_train.py [--batch 4] [--steps 3] [--seed 0] [--bf16]

Needs a CUDA device.  Random flagship weights from ``--seed``, a batch of
16 s synthetic pieces from ``chip_smoke.synth_piece`` with sine-note labels.
After two warm-up steps it times ``--steps`` steps of ``make_train_step``
with the host clock and the program's spans on (``TRANSKUN_TPU_TIMING=silent``;
``utils.profiling``: forward, backward, clip and optimizer inside the step,
host milliseconds a step), and in a last run under ``torch.profiler`` sums
the device time of every CUDA kernel and counts the launches.  Prints one
JSON object: step wall time, peak memory, the spans' host time a step, the
alpha and beta kernels' share of the device time, the top kernels and the
launches, also a step's launches by the program's span (the runtime's
launch and copy calls made inside each).  The device's busy and idle share over a steady stretch of the
training loop, with its idle gaps named, is the benchmark's
(``bench_port/run.py --workload v2-train-b4-fp32 --trace 1``).

With ``TRANSKUN_TPU_FUSED_ATTN=1`` and ``TRANSKUN_TPU_FUSED_MLP=1`` in the
environment it profiles the fused-backbone route; the breakdown names the
attention forward and backward kernels and the fused MLP either way.
``--bf16`` profiles the bf16 configuration (``compute_dtype=torch.bfloat16``).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    from transkun_tpu_torch.data.note import Note
    from transkun_tpu_torch.models.config import load_default_conf
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.ops import attention, mlp
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, make_train_step
    from transkun_tpu_torch.utils import profiling

    _, conf = load_default_conf()
    dev = torch.device("cuda")
    model = TransKun(conf, device=dev, seed=args.seed,
                     compute_dtype=torch.bfloat16 if args.bf16 else None)
    state = TrainState(model, AdaBelief(model.module.named_parameters()))
    step_fn = make_train_step(model)
    seconds = conf.segmentSizeInSecond
    audio = np.stack([
        chip_smoke.synth_piece(conf.fs, seconds, args.seed + i) for i in range(args.batch)
    ])
    rng = np.random.default_rng(args.seed)
    notes = []
    for _ in range(args.batch):
        starts = np.sort(rng.uniform(0, seconds - 1, size=60))
        notes.append([Note(float(s), float(s) + 0.3, 21 + i % 88, 64)
                      for i, s in enumerate(starts)])
    frames = model.frames(audio)
    labels = model.labels(notes)

    def gen(i):
        return torch.Generator(device=dev).manual_seed(i)

    for i in range(2):
        step_fn(state, frames, labels, gen(i))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    os.environ[profiling.ENV] = "silent"
    profiling.reset()
    t0 = time.perf_counter()
    for i in range(args.steps):
        m = step_fn(state, frames, labels, gen(i))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.steps
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    spans_ms = {name: 1e3 * s / args.steps for name, (_, s) in sorted(profiling.totals().items())}
    del os.environ[profiling.ENV]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step_fn(state, frames, labels, gen(0))
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    # device-side events only, the program's spans' device rows left out
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not e.key.startswith("transkun.")
    ]
    kernels.sort(key=lambda k: -k[1])
    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                    "cudaMemcpyAsync", "cudaMemsetAsync")

    def launches(e):
        return sum((c.name in launch_calls) + launches(c) for c in e.cpu_children)

    launches_by_span = {}
    for e in prof.events():
        if e.name.startswith("transkun.") and e.device_type == torch.autograd.DeviceType.CPU:
            launches_by_span[e.name] = launches_by_span.get(e.name, 0) + launches(e)
    device_ms = sum(k[1] for k in kernels)

    def ms_of(pred):
        return sum(ms for name, ms, _ in kernels if pred(name))

    alpha_ms = ms_of(lambda n: "alpha_tma_kernel" in n)
    beta_ms = ms_of(lambda n: "lse_cluster_kernel<false" in n)
    gemm_ms = ms_of(lambda n: "gemm" in n.lower() or "sm90_xmma" in n or "cutlass" in n.lower())
    print(json.dumps({
        "card": chip_smoke.card_line(),
        "fused_attention": attention.use_fused_attention(),
        "fused_mlp": mlp.use_fused_mlp(),
        "bf16": args.bf16,
        "batch": args.batch,
        "loss": loss,
        "step_s": step_s,
        "peak_memory_gb": peak_gb,
        "spans_host_ms_a_step": spans_ms,
        "profiled_wall_s": profiled_wall,
        "device_kernel_ms_profiled_step": device_ms,
        "alpha_ms": alpha_ms,
        "beta_ms": beta_ms,
        "alpha_beta_share_of_device_time": (alpha_ms + beta_ms) / max(device_ms, 1e-9),
        "attention_fwd_ms": ms_of(lambda n: "attention_fwd_" in n),
        "attention_bwd_ms": ms_of(lambda n: "attention_bwd_" in n),
        "fused_mlp_ms": ms_of(lambda n: "fused_mlp_kernel" in n),
        "gemm_ms": gemm_ms,
        "kernel_launches_profiled_step": sum(n for _, _, n in kernels),
        "launches_by_span_profiled_step": launches_by_span,
        "top_kernels_ms": [[k[:90], round(ms, 3), n] for k, ms, n in kernels[:15]],
    }, indent=1))


if __name__ == "__main__":
    main()
