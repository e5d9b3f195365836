#!/usr/bin/env python3
"""Check and time the port's fused MLP kernel, and the row-softmax kernels,
on one CUDA card.

    python3 scripts/profile_torch_mlp.py [--runs 5] [--launches 20] [--no-times]
                                         [--softmax] [--no-mlp] [--root DIR] [--first-version]

Builds ``csrc/fused_mlp.cu`` (printing what ``-Xptxas -v`` says about each
instance: registers, spills), then for fp32 and bf16 inputs:

* holds the kernel against ``mlp_plain`` at the flagship shapes
  ``[13261, 256] -> 1024 -> 256`` and ``[53044, 256]``, the ragged
  ``[1000, 128] -> 192`` and a single row, once with row-major ``[in, out]``
  weights and once with ``.t()`` views of row-major ``[out, in]`` weights
  (``nn.Linear``'s layout), which must give the same bits; fp32 within 2e-5;
  bf16 within one bf16 spacing of the output's largest value of an fp64
  reference and within two of ``mlp_plain`` (the kernel adds ``b1`` in fp32
  and rounds ``g`` once, where the plain version rounds ``h`` and its sum
  with ``b1`` to bf16 first and so lies up to 1.3 spacings from the reference
  itself); beside each, both distances from the fp64 reference;
* times, at the two flagship shapes, the kernel in both layouts and
  ``mlp_plain`` (two cuBLAS products and the GELU: what the default route
  runs): CUDA events, median of ``--runs``.  With ``--launches 1`` a run is
  one launch on an idle card, so it includes the wrapper's host work; with
  ``--launches 20`` (the default) a run is 20 launches between the two events
  and the time per launch is the device's.

``--softmax`` does the same for ``csrc/softmax_rows.cu``: both kernels
against their plain versions at aligned and unaligned base pointers and with
a ragged last block, then the device time at ``[106088, 149]`` and
``[106088, 89]`` beside ``torch.softmax`` and its autograd backward;
``--no-mlp`` leaves the MLP out.

``--root DIR`` takes the package from another checkout (an earlier commit
unpacked there), to compare two versions on one card in one call;
``--first-version`` with it keeps to what the first version of the MLP kernel
took (fp32, row-major weights).

Prints the card's name and power limit first; exits 1 without a CUDA device.
"""

import argparse
import math
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(13261, 256, 1024), (53044, 256, 1024), (1000, 128, 192), (1, 256, 64)]  # m, d, hidden
TIMED = SHAPES[:2]
FWD_ATOL = 2e-5
SOFTMAX_SHAPES = [(106088, 149), (106088, 89), (1003, 149), (1003, 33), (1003, 300), (1000, 1)]
SOFTMAX_TIMED = SOFTMAX_SHAPES[:2]


def cuda_ms(fn, runs, launches):
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


def ptxas_summary(log):
    """(kernel name, registers, spill bytes) of every kernel in an nvcc log."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            text = " ".join(lines[i : i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            out.append((line.split("'")[1], int(regs.group(1)) if regs else -1,
                        int(spill.group(1)) if spill else -1))
    return out


def mlp_inputs(rng, m, d, hidden, dev, dtype):
    """Unit-normal x; weights [in, out] scaled by 1/sqrt(fan in), small biases."""
    import torch

    arrays = (rng.normal(size=(m, d)), rng.normal(size=(d, hidden)) / math.sqrt(d),
              rng.normal(size=hidden) * 0.1, rng.normal(size=(hidden, d)) / math.sqrt(hidden),
              rng.normal(size=d) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype) for a in arrays]


def as_linear_stores(w):
    """The same [in, out] weight as the ``.t()`` view of a row-major
    [out, in] tensor, which is how ``nn.Linear`` holds it."""
    return w.t().contiguous().t()


def profile_mlp(args, card, dev):
    import torch

    from transkun_tpu_torch.ops import _build, mlp

    for name, (_, seconds, log) in _build.build_all(("fused_mlp",)).items():
        print(f"build {name}: {seconds:.1f} s")
        for kernel, regs, spill in ptxas_summary(log):
            print(f"  {kernel}: {regs} registers, {spill} bytes of spill stores")
    dtypes = (torch.float32,) if args.first_version else (torch.float32, torch.bfloat16)
    rng = np.random.default_rng(0)
    for dtype in dtypes:
        for m, d, hidden in SHAPES:
            x, w1, b1, w2, b2 = mlp_inputs(rng, m, d, hidden, dev, dtype)
            want = mlp.mlp_plain(x, w1, b1, w2, b2)
            exact = (torch.nn.functional.gelu(x.double() @ w1.double() + b1.double())
                     @ w2.double() + b2.double())
            got = mlp.mlp_fwd_cuda(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            err_exact = float((got.double() - exact).abs().max())
            allowed = FWD_ATOL if dtype == torch.float32 else 2 * bf16_spacing(want)
            allowed_exact = FWD_ATOL if dtype == torch.float32 else bf16_spacing(want)
            if got.dtype != dtype or not bool(torch.isfinite(got).all()) or err > allowed \
                    or err_exact > allowed_exact:
                raise AssertionError(f"{dtype} {[m, d, hidden]}: max |kernel - plain| {err} (allowed "
                                     f"{allowed}), |kernel - fp64| {err_exact} (allowed {allowed_exact})")
            line = (f"{str(dtype)[6:]} [{m},{d}] -> {hidden}: max |kernel - plain| {err:.3g} "
                    f"(allowed {allowed:.3g}), |kernel - fp64| {err_exact:.3g} (allowed "
                    f"{allowed_exact:.3g}), |plain - fp64| "
                    f"{float((want.double() - exact).abs().max()):.3g}")
            if not args.first_version:
                views = mlp.mlp_fwd_cuda(x, as_linear_stores(w1), b1, as_linear_stores(w2), b2)
                torch.cuda.synchronize()
                if not torch.equal(views, got):
                    raise AssertionError(f"{dtype} {[m, d, hidden]}: the two weight layouts differ")
                blocks, warps = mlp.launch_plan(m, dev)
                line += f"; both layouts bit for bit; {blocks} blocks of {warps} warps"
            print(line)
    if args.no_times:
        return
    for dtype in dtypes:
        for m, d, hidden in TIMED:
            x, w1, b1, w2, b2 = mlp_inputs(rng, m, d, hidden, dev, dtype)
            w1t, w2t = as_linear_stores(w1), as_linear_stores(w2)
            ms = {"kernel, row-major weights": lambda: mlp.mlp_fwd_cuda(x, w1, b1, w2, b2),
                  "plain": lambda: mlp.mlp_plain(x, w1, b1, w2, b2)}
            if not args.first_version:
                ms = {"kernel, nn.Linear layout": lambda: mlp.mlp_fwd_cuda(x, w1t, b1, w2t, b2),
                      **ms, "plain, nn.Linear layout": lambda: mlp.mlp_plain(x, w1t, b1, w2t, b2)}
            print(f"{str(dtype)[6:]} [{m},{d}] -> {hidden} ({card}), {args.launches} launches a run, ms: "
                  + ", ".join(f"{n} {cuda_ms(fn, args.runs, args.launches):.4f}" for n, fn in ms.items()))


def profile_softmax(args, card, dev):
    import torch

    from transkun_tpu_torch.ops import _build, softmax

    for name, (_, seconds, log) in _build.build_all(("softmax_rows",)).items():
        print(f"build {name}: {seconds:.1f} s")
        kernels = ptxas_summary(log)
        if kernels:
            print(f"  {len(kernels)} kernels, {min(k[1] for k in kernels)}-{max(k[1] for k in kernels)} "
                  f"registers, {sum(k[2] for k in kernels)} bytes of spill stores in all")

    def inputs(r, c, dtype, offset):
        """Logits of spread 3 and a unit-normal cotangent whose first value
        lies ``offset`` values past a 16-byte boundary."""
        gen = torch.Generator(device=dev).manual_seed(r * 1000 + c)
        out = []
        for scale in (3.0, 1.0):
            buf = torch.empty(r * c + 16, dtype=dtype, device=dev)
            view = buf[offset : offset + r * c].view(r, c)
            view.copy_(torch.randn(r, c, generator=gen, device=dev) * scale)
            out.append(view)
        return out

    for dtype in (torch.float32, torch.bfloat16):
        for r, c in SOFTMAX_SHAPES:
            for offset in (0, 1):
                l, do = inputs(r, c, dtype, offset)
                p, dl = softmax.softmax_fwd_cuda(l), softmax.softmax_bwd_cuda(l, do)
                torch.cuda.synchronize()
                bwd_atol = 1e-6 * max(1.0, float(do.float().abs().max()))
                errs = []
                for got, want, atol, extra in ((p, softmax.softmax_plain(l), 1e-6, 0.0),
                                               (dl, softmax.softmax_bwd_plain(l, do), bwd_atol, bwd_atol)):
                    diff = (got.float() - want.float()).abs()
                    if dtype == torch.float32:
                        allowed = torch.full_like(diff, atol)
                    else:  # one bf16 unit of the plain result
                        exponent = torch.frexp(want.float()).exponent
                        allowed = torch.ldexp(torch.ones_like(diff), (exponent - 8).clamp(min=-133)) + extra
                    if got.dtype != dtype or bool((diff > allowed).any()):
                        raise AssertionError(f"softmax {dtype} {[r, c]} offset {offset}: max |diff| "
                                             f"{float(diff.max())}")
                    errs.append(float(diff.max()))
                print(f"softmax {str(dtype)[6:]} [{r},{c}], first value {offset} past a 16-byte "
                      f"boundary: max |diff| forward {errs[0]:.3g}, backward {errs[1]:.3g}")
    if args.no_times:
        return
    for dtype in (torch.float32, torch.bfloat16):
        for r, c in SOFTMAX_TIMED:
            l, do = inputs(r, c, dtype, 0)
            l_lib = l.clone().requires_grad_()
            p_lib = torch.softmax(l_lib, -1)
            ms = {"fwd kernel": lambda: softmax.softmax_fwd_cuda(l),
                  "fwd torch.softmax": lambda: torch.softmax(l, -1),
                  "fwd plain": lambda: softmax.softmax_plain(l),
                  "bwd kernel": lambda: softmax.softmax_bwd_cuda(l, do),
                  "bwd torch.softmax": lambda: torch.autograd.grad(p_lib, l_lib, do, retain_graph=True)}
            print(f"softmax {str(dtype)[6:]} [{r},{c}] ({card}), {args.launches} launches a run, ms: "
                  + ", ".join(f"{n} {cuda_ms(fn, args.runs, args.launches):.4f}" for n, fn in ms.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--no-times", action="store_true")
    ap.add_argument("--softmax", action="store_true")
    ap.add_argument("--no-mlp", action="store_true")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--first-version", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"package from {os.path.abspath(args.root)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    if not args.no_mlp:
        profile_mlp(args, card, dev)
    if args.softmax:
        profile_softmax(args, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
