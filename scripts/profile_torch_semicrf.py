#!/usr/bin/env python3
"""Check and time the port's semi-CRF kernels (1 Viterbi, 2 alpha, 3 beta)
on one CUDA card.

    python3 scripts/profile_torch_semicrf.py [--runs 5] [--launches 20] [--no-times]
                                             [--root DIR] [--first-version]

Builds ``csrc/viterbi_bwd.cu``, ``csrc/semicrf_alpha.cu`` and
``csrc/semicrf_beta.cu`` (printing what ``-Xptxas -v`` says about each
kernel: registers, spills), then for fp32 and bf16 scores:

* holds each kernel against its plain version: the Viterbi tables bit for
  bit at the decode shape ``[696,696,128]``, the stats pass's
  ``[696,696,384]`` and the ragged ``[128,128,256]`` (t = 123), on
  unit-normal and on small-integer (tie-heavy) scores, each run twice for
  the same bits; alpha and beta within ``1e-5 * max(1, |plain|)`` at the
  training shape ``[696,696,384]`` (360 real lanes) and ``[128,128,256]``;
* times each kernel at its path shape (kernel 1 at ``[696,696,128]`` and
  ``[696,696,384]``, kernels 2-3 at ``[696,696,384]``): CUDA events, median
  of ``--runs``, a lone launch (with the wrapper's host work) and the
  device's time a launch over ``--launches`` launches, beside the plain
  version and the bound (each score of the strict triangle read once, the
  two fp32 [Tp, NBp] inputs read and the table written once, over 3.35
  TB/s).

``--root DIR`` takes the package from another checkout (an earlier commit
unpacked there), to compare two versions on one card in one call, in turns
(parent, change, change, parent); ``--first-version`` with it keeps to what
the first version of the kernels took (no launch plan, no cluster size).

Prints the card's name and power limit first; exits 1 without a CUDA device.
"""

import argparse
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = -1e30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TABLE_RTOL = 1e-5
# (t, NBp): Tp is t rounded up to a multiple of 8
VITERBI_CHECKED = [(691, 128), (691, 384), (123, 256)]
VITERBI_TIES = [(691, 128), (123, 256)]
VITERBI_TIMED = [(691, 128), (691, 384)]
TABLES_CHECKED = [(691, 384, 360), (123, 256, 200)]  # t, NBp, real lanes
TABLES_TIMED = (691, 384, 360)


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


def table_bound_ms(tp, nbp, score_bytes):
    """Each score of the strict triangle (Tp(Tp-1)/2 a lane) read once, two
    fp32 [Tp, NBp] inputs read and one 4-byte [Tp, NBp] table written once."""
    n_bytes = score_bytes * tp * (tp - 1) // 2 * nbp + 3 * 4 * tp * nbp
    return n_bytes / HBM_BYTES_PER_S * 1e3


def decode_inputs(rng, t, nbp, dev, ties=False):
    """NEG-padded decode-layout inputs ([begin, end, lane]), every lane real;
    small integers with ``ties``."""
    import torch

    tp = -(-t // 8) * 8
    s_t = np.full((tp, tp, nbp), NEG, np.float32)
    noise = np.zeros((tp, nbp), np.float32)
    if ties:
        s_t[:t, :t] = rng.integers(-3, 3, size=(t, t, nbp))
        noise[: t - 1] = rng.integers(-1, 2, size=(t - 1, nbp))
    else:
        s_t[:t, :t] = rng.normal(size=(t, t, nbp))
        noise[: t - 1] = rng.normal(size=(t - 1, nbp)) * 0.1
    diag = np.zeros((tp, nbp), np.float32)
    diag[:t] = np.einsum("iin->in", s_t[:t, :t])
    return [torch.from_numpy(a).to(dev) for a in (s_t, noise, diag * (diag > 0))]


def table_inputs(rng, t, nbp, nb_real, dev):
    """NEG-padded alpha-layout scores, lanes past ``nb_real`` padded; the
    shifted noise, the noise and softplus of the diagonal."""
    import torch

    tp = -(-t // 8) * 8
    s = np.full((tp, tp, nbp), NEG, np.float32)
    s[:t, :t, :nb_real] = rng.normal(size=(t, t, nb_real))
    noise = np.zeros((tp, nbp), np.float32)
    noise[: t - 1, :nb_real] = rng.normal(size=(t - 1, nb_real)) * 0.1
    spdiag = np.logaddexp(np.einsum("iin->in", s), 0.0).astype(np.float32)
    shift = np.concatenate([np.zeros_like(noise[:1]), noise[:-1]])
    return [torch.from_numpy(a).to(dev) for a in (s, shift, noise, spdiag)]


def as_bf16_decode(s_t, noise, _gate):
    """Scores rounded to bf16, the gate from the rounded diagonal."""
    import torch

    s_b = s_t.bfloat16()
    diag = torch.diagonal(s_b).t().float().contiguous()
    return [s_b, noise, diag * (diag > 0)]


def as_bf16_tables(s, shift, noise, _spdiag):
    import torch

    s_b = s.bfloat16()
    return [s_b, shift, noise, torch.nn.functional.softplus(torch.diagonal(s_b).t().float()).contiguous()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--no-times", action="store_true")
    ap.add_argument("--root", default=HERE, help="checkout to take the package from")
    ap.add_argument("--first-version", action="store_true",
                    help="the kernels' first version: no launch plan, no cluster size")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_semicrf: no CUDA device", file=sys.stderr)
        return 1
    from transkun_tpu_torch.ops import _build, logz, viterbi

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"package from {os.path.abspath(args.root)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda:0")
    for name, (_, seconds, log) in _build.build_all(("viterbi_bwd", "semicrf_alpha", "semicrf_beta")).items():
        print(f"build {name}: {seconds:.1f} s")
        for kernel, regs, spill in ptxas_summary(log):
            print(f"  {kernel}: {regs} registers, {spill} bytes of spill stores")

    def plan_line(module, s):
        if args.first_version:
            return "first version (no launch plan)"
        p = module.card_plan(s) if module is viterbi else module.beta_card_plan(s)
        return (f"{p.groups} lane groups of {p.lanes} x cluster {p.cluster} = {p.ctas} CTAs of "
                f"{p.threads} threads, {p.smem} B shared memory")

    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        # -- kernel 1: bit for bit, random and tie-heavy, twice
        for t, nbp in VITERBI_CHECKED:
            ties = (t, nbp) in VITERBI_TIES
            for tie in ((False, True) if ties else (False,)):
                inputs = decode_inputs(rng, t, nbp, dev, tie)
                if dtype == torch.bfloat16:
                    inputs = as_bf16_decode(*inputs)
                got = viterbi.viterbi_backward_tables_cuda(*inputs)
                again = viterbi.viterbi_backward_tables_cuda(*inputs)
                want = viterbi.viterbi_backward_tables_plain(*inputs)
                torch.cuda.synchronize()
                if not torch.equal(got, want) or not torch.equal(got, again):
                    raise AssertionError(f"viterbi != plain at {tuple(inputs[0].shape)} {tag}"
                                         f"{' ties' if tie else ''}: {int((got != want).sum())} "
                                         f"entries differ, runs equal {torch.equal(got, again)}")
            print(f"viterbi {tag} [{-(-t // 8) * 8},{-(-t // 8) * 8},{nbp}]: equal to plain bit for "
                  f"bit{' (random and tie-heavy)' if ties else ''}, two runs equal; plan: "
                  f"{plan_line(viterbi, inputs[0])}")
        # -- kernels 2-3 within the table tolerance
        for t, nbp, nb_real in TABLES_CHECKED:
            s, shift, noise, spdiag = table_inputs(rng, t, nbp, nb_real, dev)
            if dtype == torch.bfloat16:
                s, shift, noise, spdiag = as_bf16_tables(s, shift, noise, spdiag)
            for name, kernel, plain, rows in (
                    ("semicrf_alpha", logz.alpha_table_padded_cuda, logz.alpha_table_padded_plain, shift),
                    ("semicrf_beta", logz.beta_table_padded_cuda, logz.beta_table_padded_plain, noise)):
                got, again, want = kernel(s, rows, spdiag), kernel(s, rows, spdiag), plain(s, rows, spdiag)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                if bool((diff > TABLE_RTOL * want.abs().clamp(min=1.0)).any()) or not torch.equal(got, again):
                    raise AssertionError(f"{name} != plain at {tuple(s.shape)} {tag}: max |diff| "
                                         f"{float(diff.max())}, runs equal {torch.equal(got, again)}")
                plan = plan_line(logz, s) if name == "semicrf_beta" else "the first port's"
                print(f"{name} {tag} {list(s.shape)}: max |diff| {float(diff.max()):.3g}, two runs "
                      f"equal; plan: {plan}")
        if args.no_times:
            continue
        # -- times at the paths' shapes
        for t, nbp in VITERBI_TIMED:
            inputs = decode_inputs(rng, t, nbp, dev)
            if dtype == torch.bfloat16:
                inputs = as_bf16_decode(*inputs)

            def k1():
                return viterbi.viterbi_backward_tables_cuda(*inputs)

            lone, device = cuda_ms(k1, args.runs, 1), cuda_ms(k1, args.runs, args.launches)
            plain = cuda_ms(lambda: viterbi.viterbi_backward_tables_plain(*inputs), 3, 1)
            tp = inputs[0].shape[0]
            print(f"viterbi_bwd {tag} [{tp},{tp},{nbp}] ({card}): lone launch {lone:.4f} ms, device "
                  f"{device:.4f} ms over {args.launches} launches, plain {plain:.3f} ms, bound "
                  f"{table_bound_ms(tp, nbp, inputs[0].element_size()):.4f} ms (bytes)")
            del inputs
        s, shift, noise, spdiag = table_inputs(rng, *TABLES_TIMED, dev)
        if dtype == torch.bfloat16:
            s, shift, noise, spdiag = as_bf16_tables(s, shift, noise, spdiag)
        for name, kernel, plain, rows in (
                ("semicrf_alpha", logz.alpha_table_padded_cuda, logz.alpha_table_padded_plain, shift),
                ("semicrf_beta", logz.beta_table_padded_cuda, logz.beta_table_padded_plain, noise)):
            lone = cuda_ms(lambda: kernel(s, rows, spdiag), args.runs, 1)
            device = cuda_ms(lambda: kernel(s, rows, spdiag), args.runs, args.launches)
            plain_ms = cuda_ms(lambda: plain(s, rows, spdiag), 3, 1)
            tp, _, nbp = s.shape
            print(f"{name} {tag} {list(s.shape)} ({card}): lone launch {lone:.4f} ms, device "
                  f"{device:.4f} ms over {args.launches} launches, plain {plain_ms:.3f} ms, bound "
                  f"{table_bound_ms(tp, nbp, s.element_size()):.4f} ms (bytes)")
        del s, shift, noise, spdiag
    return 0


if __name__ == "__main__":
    sys.exit(main())
