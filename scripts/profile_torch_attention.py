#!/usr/bin/env python3
"""Check and time the port's two attention kernels on one CUDA card.

    python3 scripts/profile_torch_attention.py [--runs 5] [--launches 1] [--no-times] [--only-variants]
    python3 scripts/profile_torch_attention.py --stream [--parent DIR] [--blocks-an-sm 1,2,3]

Builds ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` (printing what
``-Xptxas -v`` says about the flagship instances: registers, spills), then for
fp32 and bf16 inputs:

* holds both kernels against ``attention_plain`` / ``attention_bwd_plain`` at
  the flagship shapes, a ragged cross-attention shape, a shape with head_dim
  40 and two long ones, as the library picks them and as the general and
  (head_dim <= 64) streaming variants; fp32 within 2e-5
  (forward) and 1e-4 (dq, dk, dv), bf16 within one bf16 spacing of each
  output's largest value; the backward run twice must give the same bits;
* times, at ``[89, 149, 256]`` and ``[356, 149, 256]`` with 8 heads, the
  tensor-core kernel, the general kernel (the first version of the port's
  kernel, forced with ``variant="general"``), the plain version and
  ``F.scaled_dot_product_attention`` with its backward: CUDA events, median
  of ``--runs``.  With ``--launches 1`` a run is one launch on an idle card,
  as ``chip_smoke.py`` times it, so it includes the wrapper's host work; with
  ``--launches 20`` a run is 20 launches between the two events, and the
  time per launch is the device's;
* times the general and the streaming variants against each other past
  the tensor-core variant's 160 keys, as far as the general one's shared
  memory goes (about 780 keys forward and 340 backward at head_dim 32):
  ``[356, 200]``, ``[356, 320]`` (the F attention with ``downsampleF=False``,
  4 segments) and ``[89, 700]`` (forward only), 8 heads of 32.
  ``--only-variants`` times only these.

``--stream`` checks and times only the streaming kernels, at the shapes
path 7 of ``chip_smoke.py`` gives them (``STREAM_SHAPES``), with that
script's functions; ``--parent DIR`` adds a checkout whose streaming kernels
are the first version, in turns; ``--blocks-an-sm`` times the plan with
other targets of blocks an SM (``ops.attention.STREAM_BLOCKS_AN_SM``, which
sets how many splits the keys take) beside the default's (device time by
launch, ``torch.profiler``).

Prints the card's name and power limit first; exits 1 without a CUDA device.
"""

import argparse
import math
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [  # b, sq, skv, heads, head_dim
    (89, 149, 149, 8, 32), (149, 89, 89, 8, 32), (356, 149, 149, 8, 32),
    (596, 89, 89, 8, 32), (5, 37, 61, 3, 8), (3, 7, 13, 2, 40), (4, 160, 160, 2, 64),
    (2, 300, 200, 2, 32), (2, 33, 21, 2, 80), (2, 100, 180, 2, 80),
]
TIMED = [(89, 149, 149, 8, 32), (356, 149, 149, 8, 32)]
VARIANT_TIMED = [(356, 200, 200, 8, 32), (356, 320, 320, 8, 32), (89, 700, 700, 8, 32)]
FWD_ATOL, BWD_ATOL = 2e-5, 1e-4


def cuda_ms(fn, runs, launches=1):
    """Median milliseconds a launch over ``runs`` runs of ``launches``
    launches each, after one warm-up launch."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def bf16_spacing(x):
    """The bf16 spacing at the largest |value| of ``x``."""
    return 2.0 ** (math.frexp(float(x.float().abs().max()))[1] - 8)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--launches", type=int, default=1)
    ap.add_argument("--no-times", action="store_true")
    ap.add_argument("--only-variants", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="only the streaming kernels at chip_smoke.py's STREAM_SHAPES")
    ap.add_argument("--parent", help="with --stream: a checkout whose streaming kernels are the "
                                     "first version, timed beside these in turns")
    ap.add_argument("--blocks-an-sm", help="with --stream: values of STREAM_BLOCKS_AN_SM to plan "
                                           "with, comma-separated, each timed by device time beside "
                                           "the default's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from transkun_tpu_torch.ops import _build, attention

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    for name, (_, seconds, log) in _build.build_all(("attention_fwd", "attention_bwd")).items():
        print(f"build {name}: {seconds:.1f} s")
        lines = log.splitlines()
        for i, line in enumerate(lines):  # the flagship instances: 12 or 20 key tiles, head_dim 32
            if "Compiling entry function" in line and "_mma" in line and (
                    "Li20ELi4E" in line or "Li12ELi4E" in line):
                print("  " + line.split("'")[1], "|", " ".join(lines[i + 2 : i + 4]).strip())

    rng = np.random.default_rng(0)
    if args.stream:
        return stream(args, card, dev, rng)
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, heads, dh in SHAPES:
            d = heads * dh
            q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev).to(dtype)
                           for s in ((b, sq, d), (b, skv, d), (b, skv, d), (b, sq, d)))
            scale = 1.0 / math.sqrt(dh)
            want = attention.attention_plain(q, k, v, heads, scale)
            want_grads = attention.attention_bwd_plain(q, k, v, want, do, heads, scale)
            picked = attention.kernel_variant("attention_fwd", sq, skv, dh)
            assert picked == attention.kernel_variant("attention_bwd", sq, skv, dh)
            for variant in dict.fromkeys((picked, "general") + (("stream",) if dh <= 64 else ())):
                o = attention.attention_fwd_cuda(q, k, v, heads, scale, variant=variant)
                grads = attention.attention_bwd_cuda(q, k, v, want, do, heads, scale, variant=variant)
                again = attention.attention_bwd_cuda(q, k, v, want, do, heads, scale, variant=variant)
                torch.cuda.synchronize()
                pairs = [("o", o, want, FWD_ATOL)] + [
                    (n, g, w, BWD_ATOL) for n, g, w in zip(("dq", "dk", "dv"), grads, want_grads)]
                report = []
                for name, got, ref, atol in pairs:
                    err = float((got.float() - ref.float()).abs().max())
                    allowed = atol if dtype == torch.float32 else bf16_spacing(ref)
                    report.append(f"{name} {err:.3g}")
                    if got.dtype != dtype or not bool(torch.isfinite(got).all()) or err > allowed:
                        raise AssertionError(
                            f"{variant} {dtype} q {[b, sq, d]} k {[b, skv, d]} {heads} heads: "
                            f"{name} max |diff| {err} > {allowed}")
                if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                    raise AssertionError(f"{variant} backward: two runs differ at {[b, sq, skv, d]}")
                print(f"{str(dtype)[6:]} q [{b},{sq},{d}] k [{b},{skv},{d}] {heads} heads, "
                      f"{variant}: max |diff| " + ", ".join(report))
    if args.no_times:
        return 0

    def timed(fn):
        return cuda_ms(fn, args.runs, args.launches)

    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, heads, dh in VARIANT_TIMED:
            d = heads * dh
            q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev).to(dtype)
                           for s in ((b, sq, d), (b, skv, d), (b, skv, d), (b, sq, d)))
            scale = 1.0 / math.sqrt(dh)
            picked = attention.kernel_variant("attention_fwd", sq, skv, dh)
            o = attention.attention_fwd_cuda(q, k, v, heads, scale)
            calls = {
                "fwd": lambda variant: attention.attention_fwd_cuda(q, k, v, heads, scale, variant=variant),
                "bwd": lambda variant: attention.attention_bwd_cuda(q, k, v, o, do, heads, scale,
                                                                    variant=variant)}
            ms = {}
            for direction, call in calls.items():
                for variant in ("general", "stream"):
                    smem = getattr(attention._library("attention_" + direction),
                                   f"attention_{direction}_smem_bytes")(sq, skv, dh, attention.VARIANTS[variant])
                    if variant == "stream" or smem <= _build.SMEM_LIMIT:  # the general kernels' k and v fit
                        ms[f"{direction} {variant}"] = timed(lambda: call(variant))
            print(f"{str(dtype)[6:]} [{b},{sq},{d}] x {skv} keys, {heads} heads ({card}), library "
                  f"picks {picked}, {args.launches} launches a run, ms: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()))
    if args.only_variants:
        return 0

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, heads, dh in TIMED:
            d = heads * dh
            q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev).to(dtype)
                           for s in ((b, sq, d), (b, skv, d), (b, skv, d), (b, sq, d)))
            scale = 1.0 / math.sqrt(dh)
            o = attention.attention_fwd_cuda(q, k, v, heads, scale)
            qh, kh, vh = (t.view(b, -1, heads, dh).transpose(1, 2).requires_grad_() for t in (q, k, v))
            o_lib = sdpa(qh, kh, vh, scale=scale)
            do_h = do.view(b, sq, heads, dh).transpose(1, 2)
            ms = {
                "fwd mma": timed(lambda: attention.attention_fwd_cuda(q, k, v, heads, scale)),
                "fwd general": timed(lambda: attention.attention_fwd_cuda(
                    q, k, v, heads, scale, variant="general")),
                "fwd plain": timed(lambda: attention.attention_plain(q, k, v, heads, scale)),
                "fwd SDPA": timed(lambda: sdpa(qh.detach(), kh.detach(), vh.detach(), scale=scale)),
                "bwd mma": timed(lambda: attention.attention_bwd_cuda(q, k, v, o, do, heads, scale)),
                "bwd general": timed(lambda: attention.attention_bwd_cuda(
                    q, k, v, o, do, heads, scale, variant="general")),
                "bwd plain": timed(lambda: attention.attention_bwd_plain(q, k, v, o, do, heads, scale)),
                "bwd SDPA": timed(lambda: torch.autograd.grad(o_lib, (qh, kh, vh), do_h,
                                                              retain_graph=True)),
            }
            print(f"{str(dtype)[6:]} [{b},{sq},{d}] {heads} heads ({card}), {args.launches} launches a run, ms: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()))
    return 0


def kernel_ms(fn, calls=5):
    """Device milliseconds a call of ``fn`` spends in each kernel it
    launches (``torch.profiler``), by the kernel's name with its
    templates' namespace cut away."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^.*?(attention_\w+?)(<|\(|$).*", r"\1", e.key)
            out[name] = round(out.get(name, 0.0) + e.self_device_time_total / calls / 1e3, 4)
    return out


def stream(args, card, dev, rng) -> int:
    """The streaming kernels at ``chip_smoke.STREAM_SHAPES``, fp32 and bf16:
    ``chip_smoke.check_attention`` and ``check_stream_bits``, the plan, and
    ``chip_smoke.time_stream`` (kernel, plain, SDPA, bound, exp floor); with
    ``--parent``, ``chip_smoke.parent_turns`` beside that checkout's."""
    import tempfile

    import torch

    import chip_smoke
    from transkun_tpu_torch.ops import attention

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = chip_smoke.max_sm_clock_mhz()
    heads = chip_smoke.ATTN_HEADS
    with tempfile.TemporaryDirectory() as tmp:
        parent = chip_smoke.parent_attention(args.parent, tmp, dev) if args.parent else None
        for dtype in (torch.float32, torch.bfloat16):
            for tag, ((b, sq, d), skv) in chip_smoke.STREAM_SHAPES.items():
                q, k, v, do = chip_smoke.attention_inputs(rng, b, sq, skv, d, dev, dtype)
                fwd_err, bwd_err, _ = chip_smoke.check_attention(attention, q, k, v, do, heads, "stream")
                chip_smoke.check_stream_bits(attention, q, k, v, do, heads)
                plan = attention.stream_plan(b, heads, sq, skv, d // heads, dtype, n_sm)
                timed = chip_smoke.time_stream(attention, q, k, v, do, heads, n_sm, mhz, runs=args.runs)
                turns = parent and chip_smoke.parent_turns(attention, *parent, q, k, v, do, heads)
                print(f"{tag} {str(dtype)[6:]} ({card}): max |diff| forward {fwd_err:.3g}, backward "
                      f"{bwd_err:.3g}; plan {plan}")
                scale = 1.0 / math.sqrt(d // heads)
                o, stats = attention.attention_fwd_cuda(q, k, v, heads, scale, with_stats=True)
                launches = {
                    "fwd": kernel_ms(lambda: attention.attention_fwd_cuda(q, k, v, heads, scale)),
                    "bwd": kernel_ms(lambda: attention.attention_bwd_cuda(q, k, v, o, do, heads, scale,
                                                                          stats=stats))}
                for side, (k_ms, p_ms, lib_ms, bnd, _, floor, dev_ms) in timed.items():
                    print(f"  {side}: kernel {k_ms:.4f} ms (device {dev_ms:.4f}, queued), plain "
                          f"{p_ms:.4f}, SDPA {lib_ms:.4f}, bound {bnd[0]:.4f} ({bnd[1]}), exp floor "
                          f"{floor:.4f}; device ms by launch {launches[side]}"
                          + (f"; in turns parent {turns[side]['parent']}, this {turns[side]['this']}"
                             if turns else ""))
                default = attention.STREAM_BLOCKS_AN_SM
                for blocks in ([int(x) for x in args.blocks_an_sm.split(",")] if args.blocks_an_sm else []):
                    attention.STREAM_BLOCKS_AN_SM = blocks
                    attention.stream_plan.cache_clear()
                    splits = attention.stream_plan(b, heads, sq, skv, d // heads, dtype, n_sm).splits
                    other = {
                        "fwd": kernel_ms(lambda: attention.attention_fwd_cuda(q, k, v, heads, scale)),
                        "bwd": kernel_ms(lambda: attention.attention_bwd_cuda(
                            q, k, v, o, do, heads, scale, stats=stats))}
                    print(f"  {blocks} blocks an SM ({splits} splits): device ms by launch {other}")
                attention.STREAM_BLOCKS_AN_SM = default
                attention.stream_plan.cache_clear()
                del o, stats, q, k, v, do
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
