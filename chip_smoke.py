#!/usr/bin/env python3
"""Drive the PyTorch port (``transkun_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the eight CUDA kernels from the seven sources of
   ``transkun_tpu_torch/csrc`` (nvcc, sm_90a), one ``nvcc`` per source, all
   at once.
2. Holds the Viterbi kernel (kernel 1, a blocked recurrence over a
   thread-block cluster) against its plain PyTorch version, with fp32 and
   with bf16 scores, at every shape the paths give it: the decode shape
   [696, 696, 128], the stats pass's [696, 696, 384] and the ragged
   [128, 128, 256] (t = 123), on unit-normal and on small-integer
   (tie-heavy) scores, and at the cluster edges (one lane group; more lane
   groups than SMs): the pointer tables must be equal bit for bit, and two
   runs must give the same bits.  Prints each launch plan (CTAs, cluster
   size, shared memory, registers from ``-Xptxas -v``).
3. Holds the alpha and beta kernels against their plain versions at the
   flagship training shape [696, 696, 384] (t = 691, 360 real lanes) and
   at a ragged shape (t = 123, Tp = 128, NBp = 256), and the beta kernel
   (kernel 3, the same design as kernel 1) also at the cluster edges and at
   Tp = 125: |kernel - plain| <= 1e-5 * max(1, |plain|), the sums being
   taken in another order, two runs the same bits; with fp32 and bf16
   scores.  Then the logZ gradient through the kernels against autograd of
   the plain ``log_z_slow`` at a small ragged shape.  Kernels 1-3 are timed
   with CUDA events (median of several runs): a lone launch, the device's
   time a launch over 20 launches, the plain version, and the bound (the
   strict triangle of the score tensor read once).
   The attention forward and backward kernels against their plain versions,
   with fp32 and with bf16 inputs, at the flagship shapes of one segment
   ([89, 149, 256] and [149, 89, 256], 8 heads), of a training batch of 4
   ([356, 149, 256] and [596, 89, 256]), at a ragged shape (cross-attention,
   odd lengths, 3 heads of 8) and at a long one (300 queries x 200 keys),
   which only the general kernels take where the others run on the tensor
   cores.  fp32: forward within 2e-5, dq/dk/dv within 1e-4 on unit-normal
   inputs.  bf16: within one bf16 spacing of each output's largest value.
   The backward runs twice and must give the same bits.  The fused MLP, with
   fp32 and with bf16 tensors, at [13261, 256] -> 1024 -> 256, at the training
   batch's [53044, 256] and at [1000, 128] -> 192 -> 128, each with row-major
   [in, out] weights and with ``.t()`` views of row-major [out, in] weights
   (``nn.Linear``'s layout), which must give the same bits: fp32 within 2e-5;
   bf16 within two bf16 spacings of the output's largest value, and within
   one of the same function in fp64 (the plain version rounds h and its sum
   with b1 to bf16 where the kernel keeps fp32, and is itself 1.3 spacings
   from the fp64 result).  It is timed at both types and both path shapes
   beside ``mlp_plain`` (two cuBLAS products and a GELU, which is what the
   default route runs, so the plain time is the library's here), on a lone
   launch and over 20 launches; its bound is the tensor cores' (TF32 rate
   with three ``mma`` a product at fp32, bf16 rate at bf16).  The attention kernels are timed
   at both types at the segment's shape and at the batch's, beside the
   general kernels (the port's first version of them, which must be the
   slower at fp32), the plain versions and
   ``F.scaled_dot_product_attention`` with its backward, the library's
   yardstick, which the port never calls; the kernels line carries the
   forward at the segment's shape and the backward at the batch's, the only
   one the paths launch it at.  A kernel time under its bound is a wrong
   count and fails the run.
   The row softmax kernels, forward and backward, against their plain
   versions at the attention logits of one segment ([106088, 149] and
   [106088, 89]), of a training batch of 4 (four times the rows) and at
   ragged shapes (1003 rows of 1, 9, 33, 149 and 300 columns: a last block
   that is part full), fp32 and bf16.  fp32: the forward within 1e-6 absolute, the backward within 1e-6
   times the largest cotangent (dl is linear in do).  bf16: within one bf16
   unit in the last place of the plain result; in the backward, where
   ``do - delta`` cancels, plus that fp32 bound.  Timed with the L2 cache flushed
   before each run, beside ``torch.softmax`` and its autograd backward, and
   over 20 launches a run for the device's time without the wrapper's host
   work.
4. Transcription: a 64 s synthetic piece with the flagship V2
   configuration (``transkun_tpu_torch/pretrained/2.0.conf``) and random weights
   from a seeded ``torch.Generator``.  Checks that the Viterbi kernel ran
   once per segment, that the notes are valid, and that on one segment's
   real scores the kernel's table equals the plain version's.  Then the same
   piece nine times over (9.6 minutes) with the default ``segment_batch``:
   its peak device memory must be within 10% of the 64 s piece's.
5. Training through the entry point ``transkun_tpu_torch.cli.train.main``
   at flagship width and depth, ``--batchSize 4``: a synthetic
   MAESTRO-layout corpus of 40 s pieces (MIDI from the port's
   ``data.midi``, pickles from its ``cli.create_dataset_maestro``) in a temp
   dir; one epoch of steps with stats decodes, checkpoints and validation;
   a resume for two more steps; ``best_state_dict`` loaded into
   ``TransKun`` to transcribe a piece.  Every loss must be finite and the
   alpha, beta and Viterbi launch counts must equal the calls made.
6. The fused-backbone configuration (``TRANSKUN_TPU_FUSED_ATTN=1`` and
   ``TRANSKUN_TPU_FUSED_MLP=1``) at full width and depth: the same piece,
   weights and seed as in 4 are transcribed, then ``cli.train.main`` takes a
   few steps on the corpus of 5 with the seed of 5.  The attention and MLP
   launch counts must equal the calls made; on one segment the backbone ctx
   of the fused route must agree with the default route's within
   1e-4 * max(1, max |ctx|); every training loss must agree with the
   default route's at the same step within 1e-5 relative (the losses after
   the first depend on the gradients, so on the attention backward kernel);
   the shapes the path gave the kernels must be the ones they were held
   against their plain versions at; notes valid.
   The notes that differ between the two routes (pitch, velocity, times to
   the millisecond) are counted, not refused.  Then the same steps with
   ``TRANSKUN_TPU_FUSED_ATTN=1`` alone, held to the same bounds, and the two
   step times printed side by side.

7. The bf16 configuration (``compute_dtype=torch.bfloat16``, the CLIs'
   ``--bf16``) at full width and depth on the default route: the piece,
   weights and seed of 4 are transcribed, then ``cli.train.main --bf16``
   takes a few steps on the corpus of 5 with the seed of 5.  The score
   tensors handed to the Viterbi, alpha and beta wrappers must be bf16 and
   of the shapes the kernels were held against their plain versions at; the
   launch counts must equal the calls made; every loss must be finite and
   within 1e-3 relative of the fp32 route's at the same step, and one
   segment's ctx within 5e-2 * max |ctx| of the fp32 route's (bf16 carries
   8 significant bits through six layers).  Notes that differ from the fp32
   route's are counted, not refused.  Then the same configuration with
   ``TRANSKUN_TPU_FUSED_ATTN=1`` alone and with both fused flags: the piece
   transcribed and two steps of ``cli.train.main --bf16`` each; the attention
   and MLP launch counts must equal the calls made, q at the attention
   wrappers and x at the MLP wrapper must be bf16 and of the shapes the
   kernels were held against their plain versions at, ctx and losses within
   the same bounds of the fp32 route's.
8. The softmax study path (``TRANSKUN_TPU_FUSED_SOFTMAX=1``): the
   explicit-softmax attention core, ``q k^T * scale`` by ``torch.matmul``,
   ``ops.softmax.softmax_last``, ``p v``, forward and backward at
   [89, 8, 149, 32] and [149, 8, 89, 32], fp32 and bf16, held against
   ``attention_plain`` / ``attention_bwd_plain`` (fp32: 2e-5 forward, 1e-4
   backward; bf16, whose logits and probabilities are rounded where the
   plain version keeps fp32: 4e-2 and 6e-2 on unit-normal inputs); the
   softmax launch counts must equal the calls made.

Prints the card, build times, kernel times, each transcription's wall time,
RTF and peak memory, each training step time and peak memory, then one JSON
line with the kernels (launches on the five paths, largest error, kernel,
plain and library ms, and the bound: bytes moved once over 3.35 TB/s or
fp32 operations over 67 TFLOP/s, whichever is larger, for the fused MLP the
operations of its three TF32 ``mma`` a product over 495 TFLOP/s; under
``bf16`` the times with bf16 input, the attention and MLP kernels' bound
there being 2 bytes a value against the operations at 989 TFLOP/s) and, as the last
line, ``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and
convolutions.  Any failed check raises, so the script exits non-zero without
that line; it exits 1 at once when no CUDA device is present.
"""

import gc
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

NEG = -1e30
SEED = 0
PIECE_SECONDS = 64.0
LONG_PIECE_TILES = 9  # the long piece is the 64 s piece this many times over: 9.6 minutes
PEAK_RTOL = 0.10  # the long piece's peak memory against the short one's
KERNELS = ("viterbi_bwd", "semicrf_alpha", "semicrf_beta",
           "attention_fwd", "attention_bwd", "fused_mlp", "softmax_fwd", "softmax_bwd")
# the sources to build: softmax_rows.cu holds both softmax kernels
SOURCES = KERNELS[:6] + ("softmax_rows",)
TABLE_RTOL = 1e-5  # |kernel - plain| <= TABLE_RTOL * max(1, |plain|)
FWD_ATOL = 2e-5  # attention forward and MLP: |kernel - plain|, unit-normal inputs
BWD_ATOL = 1e-4  # attention dq, dk, dv
MLP_BF16_SPACINGS = 2  # fused MLP at bf16 against mlp_plain, in bf16 spacings of max |out|
CTX_RTOL = 1e-4  # fused vs default backbone ctx: * max(1, max |ctx|)
LOSS_RTOL = 1e-5  # fused vs default training loss, step by step
FUSED_TRAIN_STEPS = 4
BF16_FUSED_TRAIN_STEPS = 2  # --bf16 with TRANSKUN_TPU_FUSED_ATTN, and with both fused flags
BF16_TRAIN_STEPS = 4
BF16_LOSS_RTOL = 1e-3  # bf16 vs fp32 training loss, step by step
BF16_CTX_RTOL = 5e-2  # bf16 vs fp32 backbone ctx: * max |ctx|
SOFTMAX_ATOL = 1e-6  # softmax kernels at fp32: forward; backward * max(1, max |do|)
# the explicit-softmax attention core against attention_plain, by dtype:
# (forward, backward) absolute on unit-normal inputs
CORE_ATOL = {"float32": (FWD_ATOL, BWD_ATOL), "bfloat16": (4e-2, 6e-2)}
TRAIN_BATCH = 4
# the flagship shapes of one 16 s segment: F- and T-attention [B, S, D] with
# ATTN_HEADS heads, and the FFN's [tokens, D] -> MLP_HIDDEN -> D
ATTN_SHAPES, ATTN_HEADS = ((89, 149, 256), (149, 89, 256)), 8
MLP_SHAPE, MLP_HIDDEN = (13261, 256), 1024
# cross-attention, odd lengths, 3 heads of 8: (q shape, Skv, heads); and a shape
# with more keys than a thread's registers hold, which the general kernels take
RAGGED_ATTN = ((5, 37, 24), 61, 3)
LONG_ATTN = ((2, 300, 64), 200, 2)
# the same at --batchSize TRAIN_BATCH: the batch is folded into B and the tokens
TRAIN_ATTN_SHAPES = tuple((TRAIN_BATCH * b, s, d) for b, s, d in ATTN_SHAPES)
TRAIN_MLP_SHAPE = (TRAIN_BATCH * MLP_SHAPE[0], MLP_SHAPE[1])
FUSED_FLAGS = ("TRANSKUN_TPU_FUSED_ATTN", "TRANSKUN_TPU_FUSED_MLP")
SOFTMAX_FLAG = "TRANSKUN_TPU_FUSED_SOFTMAX"
# attention logits of one segment as softmax rows: [B * heads * Sq, Skv]
SOFTMAX_SHAPES = tuple((b * ATTN_HEADS * s, s) for b, s, _ in ATTN_SHAPES)
TRAIN_SOFTMAX_SHAPES = tuple((TRAIN_BATCH * r, c) for r, c in SOFTMAX_SHAPES)
RAGGED_SOFTMAX_SHAPES = tuple((1003, c) for c in (1, 9, 33, 149, 300))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
TF32_FLOPS = 495e12  # H100 SXM data sheet, dense TF32 on the tensor cores
DEVICE_LAUNCHES = 20  # launches between two events where the device's time is wanted
TRAIN_PIECES, VAL_PIECES, CORPUS_PIECE_SECONDS = 3, 1, 40.0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=5, before=None, launches=1):
    """Median milliseconds of ``fn()`` over ``runs`` timed runs (CUDA
    events), after one warm-up run.  ``before()`` runs ahead of each timed
    run, outside the events (an L2 flush).  With ``launches`` above 1 a run
    is that many calls between the two events and the time is the device's
    per call, without the wrapper's host work before a lone launch."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def decode_inputs(rng, t, nbp, dev, ties=False):
    """Random NEG-padded decode-layout inputs ([begin, end, lane]); with
    ``ties`` small-integer scores and noise, so that equal candidates abound."""
    import torch

    tp = -(-t // 8) * 8
    s_t = torch.full((tp, tp, nbp), NEG, device=dev)
    scores = rng.integers(-3, 3, size=(t, t, nbp)) if ties else rng.normal(size=(t, t, nbp))
    s_t[:t, :t] = torch.from_numpy(scores.astype(np.float32)).to(dev)
    noise = torch.zeros(tp, nbp, device=dev)
    if ties:
        noise[: t - 1] = torch.from_numpy(rng.integers(-1, 2, size=(t - 1, nbp)).astype(np.float32)).to(dev)
    diag = torch.zeros(tp, nbp, device=dev)
    diag[:t] = torch.diagonal(s_t[:t, :t]).t()
    return s_t, noise, diag * (diag > 0)


def check_kernel(viterbi, s_t, noise, diag_gate):
    """Kernel table vs plain table on the same card inputs, the kernel run
    twice for the same bits; returns the largest absolute difference, which
    must be 0."""
    import torch

    got = viterbi.viterbi_backward_tables_cuda(s_t, noise, diag_gate)
    again = viterbi.viterbi_backward_tables_cuda(s_t, noise, diag_gate)
    want = viterbi.viterbi_backward_tables_plain(s_t, noise, diag_gate)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or not torch.equal(got, again):
        raise AssertionError(f"Viterbi kernel != plain at {tuple(s_t.shape)} {s_t.dtype}: max |diff| "
                             f"{err}, two runs equal {torch.equal(got, again)}")
    return err


def table_inputs(rng, t, nbp, nb_real, dev):
    """NEG-padded alpha-layout scores [Tp, Tp, NBp] with lanes past
    ``nb_real`` padded, and (shifted noise, noise, softplus(diag))."""
    import torch

    tp = -(-t // 8) * 8
    s = torch.full((tp, tp, nbp), NEG, device=dev)
    s[:t, :t, :nb_real] = torch.from_numpy(
        rng.normal(size=(t, t, nb_real)).astype(np.float32)
    ).to(dev)
    noise = torch.zeros(tp, nbp, device=dev)
    noise[: t - 1, :nb_real] = torch.from_numpy(
        (rng.normal(size=(t - 1, nb_real)) * 0.1).astype(np.float32)
    ).to(dev)
    spdiag = torch.nn.functional.softplus(torch.diagonal(s).t()).contiguous()
    shift = torch.nn.functional.pad(noise[:-1], (0, 0, 1, 0)).contiguous()
    return s, shift, noise, spdiag


def check_tables(logz, s, shift, noise, spdiag):
    """Alpha and beta kernel tables vs the plain versions on the same card
    inputs; returns each kernel's largest absolute difference."""
    import torch

    err = {}
    for name, kernel, plain, rows in (
        ("semicrf_alpha", logz.alpha_table_padded_cuda, logz.alpha_table_padded_plain, shift),
        ("semicrf_beta", logz.beta_table_padded_cuda, logz.beta_table_padded_plain, noise),
    ):
        got = kernel(s, rows, spdiag)
        again = kernel(s, rows, spdiag)
        want = plain(s, rows, spdiag)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool(
            (diff > TABLE_RTOL * torch.clamp(want.abs(), min=1.0)).any()
        ) or not torch.equal(got, again):
            raise AssertionError(
                f"{name} != plain at {tuple(s.shape)} {s.dtype}: max |diff| {float(diff.max())}, "
                f"two runs equal {torch.equal(got, again)}"
            )
        err[name] = float(diff.max())
    return err


def check_logz_grad(logz, semicrf, dev):
    """logZ and its score cotangent through the kernels (``log_z_padded``)
    against autograd of the plain ``log_z_slow``, at a small ragged shape
    with padded lanes; returns the largest absolute difference."""
    import torch

    rng = np.random.default_rng(SEED + 7)
    t, nb, tp, nbp = 45, 5, 48, 128
    s = torch.from_numpy(rng.normal(size=(t, t, nb)).astype(np.float32)).to(dev)
    n = torch.from_numpy((rng.normal(size=(t - 1, nb)) * 0.5).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=nb).astype(np.float32)).to(dev)
    s_pad = torch.full((tp, tp, nbp), NEG, device=dev)
    s_pad[:t, :t, :nb] = s
    noise_pad = torch.zeros(tp, nbp, device=dev)
    noise_pad[: t - 1, :nb] = n
    s_pad.requires_grad_()
    lz = logz.log_z_padded(t, s_pad, noise_pad)
    (lz[:nb] * w).sum().backward()
    s_ref = s.clone().requires_grad_()
    lz_ref = semicrf.log_z_slow(s_ref, n)
    (lz_ref * w).sum().backward()
    lz, lz_ref = lz.detach(), lz_ref.detach()
    torch.cuda.synchronize()
    err = max(float((lz[:nb] - lz_ref).abs().max()),
              float((s_pad.grad[:t, :t, :nb] - s_ref.grad).abs().max()))
    if err > 1e-4 or float(lz[nb:].abs().max()) != 0.0 or bool((s_pad.grad[:, :, nb:] != 0).any()):
        raise AssertionError(f"logZ gradient through the kernels: max |diff| {err}")
    return err


def ptxas_registers(log):
    """Registers a thread of each kernel instance (mangled name) in what
    ``nvcc -Xptxas -v`` printed."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def bound(n_bytes, flops, peak=FP32_FLOPS):
    """The least milliseconds the card could take: every input read and every
    output written once at the memory rate, or the operations at ``peak``
    (the CUDA cores' fp32 rate unless given), whichever is larger; and which
    of the two."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def table_bound(tp, nbp, ops_per_term, score_bytes=4):
    """Bound of one table over a [Tp, Tp, NBp] score tensor of ``score_bytes``
    a value: the strict triangle that the recurrence reads (Tp(Tp-1)/2 terms
    a lane) read once, two fp32 [Tp, NBp] inputs read and one 4-byte
    [Tp, NBp] table written once."""
    terms = tp * (tp - 1) // 2 * nbp
    n_bytes = score_bytes * terms + 3 * 4 * tp * nbp
    return bound(n_bytes, ops_per_term * terms)


def attention_inputs(rng, b, sq, skv, d, dev, dtype=None):
    """Unit-normal q, k, v and cotangent do, flat [B, S, D], fp32 unless
    ``dtype`` is given."""
    import torch

    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev).to(dtype or torch.float32)
            for s in ((b, sq, d), (b, skv, d), (b, skv, d), (b, sq, d))]


def bf16_spacing_at_max(x) -> float:
    """The bf16 spacing at the largest |value| of ``x``: |max| = m * 2**e
    with m in [0.5, 1), and bf16 keeps 8 bits of m."""
    return 2.0 ** (math.frexp(float(x.float().abs().max()))[1] - 8)


def check_attention(attention, q, k, v, do, heads, variant):
    """Both attention kernels against their plain versions on the same card
    inputs, which must run as ``variant``; returns (forward error, backward
    error, o).  fp32: FWD_ATOL and BWD_ATOL.  bf16: one bf16 spacing of each
    output's largest value.  The backward runs twice and must give the same
    bits."""
    import torch

    dh = q.shape[-1] // heads
    scale = 1.0 / math.sqrt(dh)
    picked = {attention.kernel_variant(name, q.shape[1], k.shape[1], dh)
              for name in ("attention_fwd", "attention_bwd")}
    if picked != {variant}:
        raise AssertionError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, {heads} heads runs as "
                             f"{picked}, not as {variant}")
    o = attention.attention_fwd_cuda(q, k, v, heads, scale)
    want = attention.attention_plain(q, k, v, heads, scale)
    got_grads = attention.attention_bwd_cuda(q, k, v, o, do, heads, scale)
    again = attention.attention_bwd_cuda(q, k, v, o, do, heads, scale)
    want_grads = attention.attention_bwd_plain(q, k, v, want, do, heads, scale)
    torch.cuda.synchronize()
    where = f"q {tuple(q.shape)}, k {tuple(k.shape)}, {heads} heads, {q.dtype}, {variant}"
    if not all(torch.equal(a, b) for a, b in zip(got_grads, again)):
        raise AssertionError(f"attention backward: two runs differ at {where}")
    errs = []
    for name, got, ref, atol in [("o", o, want, FWD_ATOL)] + [
            (n, g, w, BWD_ATOL) for n, g, w in zip(("dq", "dk", "dv"), got_grads, want_grads)]:
        e = float((got.float() - ref.float()).abs().max())
        allowed = atol if q.dtype == torch.float32 else bf16_spacing_at_max(ref)
        if got.dtype != q.dtype or not bool(torch.isfinite(got).all()) or not e <= allowed:
            raise AssertionError(f"attention kernels != plain at {where}: {name} max |diff| {e}, "
                                 f"allowed {allowed}")
        errs.append(e)
    return errs[0], max(errs[1:]), o


def mlp_inputs(rng, m, d, hidden, dev, dtype):
    """Unit-normal x; row-major weights [in, out] scaled by 1/sqrt(fan in),
    small biases; rounded to ``dtype``."""
    import torch

    arrays = (rng.normal(size=(m, d)), rng.normal(size=(d, hidden)) / math.sqrt(d),
              rng.normal(size=hidden) * 0.1, rng.normal(size=(hidden, d)) / math.sqrt(hidden),
              rng.normal(size=d) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype) for a in arrays]


def as_linear_stores(args):
    """The same MLP operands with each [in, out] weight as the ``.t()`` view
    of a row-major [out, in] tensor, which is how ``nn.Linear`` holds it."""
    x, w1, b1, w2, b2 = args
    return [x, w1.t().contiguous().t(), b1, w2.t().contiguous().t(), b2]


def check_mlp(mlp, args):
    """The fused MLP kernel against its plain version, with row-major
    weights and with ``nn.Linear``'s layout, which must give the same bits;
    returns the largest absolute difference from the plain version.  fp32:
    FWD_ATOL.  bf16: MLP_BF16_SPACINGS bf16 spacings of the output's largest
    value, and one spacing from the same function in fp64: the kernel adds b1
    in fp32 and rounds g once, the plain version rounds h, and its sum with
    b1, to bf16 before the GELU and so lies more than a spacing from the fp64
    result itself (1.3 at the flagship shape)."""
    import torch

    x, w1, b1, w2, b2 = args
    got = mlp.mlp_fwd_cuda(*args)
    views = mlp.mlp_fwd_cuda(*as_linear_stores(args))
    want = mlp.mlp_plain(*args)
    exact = (torch.nn.functional.gelu(x.double() @ w1.double() + b1.double())
             @ w2.double() + b2.double())
    torch.cuda.synchronize()
    where = f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, {x.dtype}"
    if not torch.equal(got, views):
        raise AssertionError(f"fused_mlp: the two weight layouts give different bits at {where}")
    err = float((got.float() - want.float()).abs().max())
    err_exact = float((got.double() - exact).abs().max())
    spacing = bf16_spacing_at_max(want)
    allowed, allowed_exact = (FWD_ATOL, FWD_ATOL) if got.dtype == torch.float32 else (
        MLP_BF16_SPACINGS * spacing, spacing)
    if got.dtype != x.dtype or not bool(torch.isfinite(got).all()) or not err <= allowed \
            or not err_exact <= allowed_exact:
        raise AssertionError(f"fused_mlp != plain at {where}: max |diff| {err}, allowed {allowed}; "
                             f"from the fp64 result {err_exact}, allowed {allowed_exact}")
    return err


def softmax_inputs(rng, rows, cols, dtype, dev):
    """Logits of spread 3 and a unit-normal cotangent, made on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    l = torch.randn(rows, cols, generator=gen, device=dev) * 3
    do = torch.randn(rows, cols, generator=gen, device=dev)
    return l.to(dtype), do.to(dtype)


def check_softmax(softmax, l, do):
    """Both softmax kernels against their plain versions on the same card
    inputs; returns the largest absolute differences (forward, backward).
    fp32: SOFTMAX_ATOL forward, times the largest cotangent backward.  bf16:
    one bf16 unit in the last place of the plain result, plus that fp32
    bound in the backward."""
    import torch

    bwd_atol = SOFTMAX_ATOL * max(1.0, float(do.float().abs().max()))
    pairs = ((softmax.softmax_fwd_cuda(l), softmax.softmax_plain(l), SOFTMAX_ATOL, 0.0),
             (softmax.softmax_bwd_cuda(l, do), softmax.softmax_bwd_plain(l, do), bwd_atol, bwd_atol))
    torch.cuda.synchronize()
    errs = []
    for got, want, atol, extra in pairs:
        diff = (got.float() - want.float()).abs()
        if l.dtype == torch.float32:
            allowed = torch.full_like(diff, atol)
        else:  # |want| = m * 2**e with m in [0.5, 1): the spacing there is 2**(e - 8)
            exponent = torch.frexp(want.float()).exponent
            allowed = torch.ldexp(torch.ones_like(diff), (exponent - 8).clamp(min=-133)) + extra
        if got.dtype != l.dtype or not bool(torch.isfinite(got).all()) or bool((diff > allowed).any()):
            raise AssertionError(f"softmax kernel != plain at {tuple(l.shape)} {l.dtype}: "
                                 f"max |diff| {float(diff.max())}")
        errs.append(float(diff.max()))
    return errs


class CallCounter:
    """Counts the calls of ``module.name`` while installed, so that a run's
    kernel launches can be held against the calls made."""

    def __init__(self, module, name):
        self.module, self.name, self.calls, self.shapes = module, name, 0, set()
        self.dtypes = set()
        self.fn = getattr(module, name)

    def __enter__(self):
        def counted(*args, **kwargs):
            self.calls += 1
            self.shapes.add(tuple(args[0].shape))  # the first operand's shape
            self.dtypes.add(args[0].dtype)
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def synth_piece(fs, seconds, seed):
    """Sine notes at ~8 notes/s over low noise, int16-exact like decoded
    audio; [nSample, 1] float32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    tt = np.arange(n) / fs
    x = rng.normal(size=n) * 0.005
    t = 0.2
    while t < seconds - 1.0:
        f0 = 440 * 2 ** ((int(rng.integers(21, 109)) - 69) / 12)
        dur = float(rng.uniform(0.1, 0.8))
        on = (tt >= t) & (tt < t + dur)
        x[on] += 0.1 * np.sin(2 * np.pi * f0 * tt[on]) * np.exp(-3 * (tt[on] - t))
        t += float(rng.uniform(0.05, 0.25))
    x = np.clip(np.round(x * 32768), -32768, 32767) / 32768
    return x.astype(np.float32)[:, None]


def build_corpus(root, fs, seed):
    """A MAESTRO-layout corpus of sine-note pieces (wav at ``fs`` + MIDI +
    meta csv) and its pickles; returns the pickle directory."""
    import csv

    from scipy.io import wavfile

    from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset
    from transkun_tpu_torch.data.midi import write_midi
    from transkun_tpu_torch.data.note import Note as MidiNote

    rng = np.random.default_rng(seed)
    rows = []
    splits = ["train"] * TRAIN_PIECES + ["validation"] * VAL_PIECES
    os.makedirs(os.path.join(root, "2020"))
    n = int(CORPUS_PIECE_SECONDS * fs)
    for i, split in enumerate(splits):
        notes, x, t, last_end = [], rng.normal(size=n) * 0.003, 0.3, {}
        while t < CORPUS_PIECE_SECONDS - 1.0:
            pitch, dur = int(rng.integers(36, 96)), float(rng.uniform(0.15, 0.6))
            if t < last_end.get(pitch, 0.0):  # notes of one pitch must not overlap
                t += 0.05
                continue
            last_end[pitch] = t + dur
            notes.append(MidiNote(t, t + dur, pitch, int(rng.integers(30, 110))))
            a, b = int(t * fs), int((t + dur) * fs)
            tt = np.arange(b - a) / fs
            x[a:b] += 0.1 * np.sin(2 * np.pi * 440 * 2 ** ((pitch - 69) / 12) * tt) * np.exp(-2 * tt)
            t += float(rng.uniform(0.1, 0.3))
        wav, mid = f"2020/piece{i}.wav", f"2020/piece{i}.midi"
        write_midi(notes, os.path.join(root, mid))
        wavfile.write(os.path.join(root, wav), fs, (np.clip(x, -1, 1) * 32767).astype(np.int16))
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"piece{i}",
                     "split": split, "year": "2020", "midi_filename": mid,
                     "audio_filename": wav, "duration": CORPUS_PIECE_SECONDS})
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    out = os.path.join(root, "pickles")
    create_dataset([root, meta, out])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from transkun_tpu_torch.cli import train as train_cli
    from transkun_tpu_torch.data.note import validate_notes
    from transkun_tpu_torch.models import layers
    from transkun_tpu_torch.models.config import default_conf_path, load_default_conf
    from transkun_tpu_torch.models.transkun import TransKun
    import transkun_tpu_torch.models.transkun as transkun_module
    from transkun_tpu_torch.ops import (
        _build, attention, frontend, logz, mlp, semicrf, softmax, viterbi,
    )
    from transkun_tpu_torch.utils.convert import load_reference_checkpoint

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    for flag in (*FUSED_FLAGS, SOFTMAX_FLAG, "TRANSKUN_TPU_NO_PALLAS"):
        os.environ.pop(flag, None)  # paths 1 and 2 are the default route

    def counts():
        return {"viterbi_bwd": viterbi.launches, "semicrf_alpha": logz.alpha_launches,
                "semicrf_beta": logz.beta_launches, "attention_fwd": attention.fwd_launches,
                "attention_bwd": attention.bwd_launches, "fused_mlp": mlp.launches,
                "softmax_fwd": softmax.fwd_launches, "softmax_bwd": softmax.bwd_launches}

    def reset_counts():
        viterbi.launches = logz.alpha_launches = logz.beta_launches = 0
        attention.fwd_launches = attention.bwd_launches = mlp.launches = 0
        softmax.fwd_launches = softmax.bwd_launches = 0

    by_path = {}  # launches of each kernel on paths 1 to 5

    # -- build, one nvcc per source, all at once -------------------------------
    t0 = time.perf_counter()
    registers = {}  # kernel instance (mangled name) -> registers a thread
    for name, (_, build_s, log) in _build.build_all(SOURCES).items():
        print(f"build {name}: {build_s:.2f} s")
        registers.update(ptxas_registers(log))
        if log:
            print(log.strip())
            # what -Xptxas -v says, in one line: a spill is memory traffic the source does not show
            regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
            print(f"build {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, "
                  f"{sum(x > 0 for x in spills)} of them spill ({sum(spills)} bytes of spill stores in all)")
    print(f"build wall: {time.perf_counter() - t0:.2f} s")

    # -- each kernel against its plain version ---------------------------------
    # kernels 1 and 3 (the blocked cluster kernels) at every shape the paths
    # give them, fp32 and bf16 scores: Viterbi [696,696,128] (decode) and
    # [696,696,384] (stats pass and validation), beta and alpha [696,696,384]
    # (training), the ragged [128,128,256] (t = 123), tie-heavy scores for
    # the Viterbi, and the cluster edges: one lane group, and more lane
    # groups than SMs; every kernel run twice for the same bits
    rng = np.random.default_rng(SEED)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {"viterbi_bwd": 0, "semicrf_alpha": 0.0, "semicrf_beta": 0.0}
    ms, plain_ms, device_ms, bounds = {}, {}, {}, {}
    library_ms = dict.fromkeys(KERNELS)  # no single PyTorch call computes kernels 1-3 or 6
    bf16 = {}  # per kernel: the times and the bound with bf16 input

    def decode_bf16(s_t, noise, _gate):
        """The same inputs with the scores rounded to bf16 and the gate
        taken from the rounded diagonal, as the scorer emits them."""
        s_b = s_t.bfloat16()
        diag = torch.diagonal(s_b).t().float().contiguous()
        return s_b, noise, diag * (diag > 0)

    def table_bf16(s, shift, noise, _spdiag):
        """The same inputs with the scores rounded to bf16 and spdiag taken
        from the rounded diagonal, as ``logz._fb_padded`` takes it."""
        s_b = s.bfloat16()
        spdiag = torch.nn.functional.softplus(torch.diagonal(s_b).t().float()).contiguous()
        return s_b, shift, noise, spdiag

    def plan_line(name, plan, s):
        """The launch plan of a cluster kernel on this card, as it launched."""
        kind = "f" if s.dtype == torch.float32 else "13__nv_bfloat16"
        pattern = {"viterbi_bwd": f"viterbi_bwd_kernelI{kind}E",
                   "semicrf_beta": f"lse_cluster_kernelILb0E{kind}E"}[name]
        regs = [r for k, r in registers.items() if pattern in k]
        print(f"launch plan {name} {list(s.shape)} {str(s.dtype)[6:]} ({card}): {plan.groups} lane groups "
              f"of {plan.lanes} lanes x clusters of {plan.cluster} = {plan.ctas} CTAs of {plan.threads} "
              f"threads ({n_sm} SMs), {plan.smem} B shared memory, {regs[0] if regs else '?'} registers "
              f"a thread (ptxas)")

    def lone_device_plain(fn, plain_fn):
        """(lone launch ms, device ms over DEVICE_LAUNCHES launches, plain ms)."""
        return (cuda_ms(fn), cuda_ms(fn, launches=DEVICE_LAUNCHES), cuda_ms(plain_fn, runs=3))

    for dtype in (torch.float32, torch.bfloat16):
        tag, fp32 = str(dtype)[6:], dtype == torch.float32
        lanes = viterbi.launch_plan(696, 128, dtype, n_sm).lanes
        into = err if fp32 else bf16.setdefault("viterbi_bwd", {"max_abs_err": 0})
        key = "viterbi_bwd" if fp32 else "max_abs_err"
        cases = [(691, 128, False), (691, 128, True), (691, 384, False), (123, 256, False),
                 (123, 256, True), (123, lanes, False), (123, lanes, True), (61, 2 * n_sm * lanes, False)]
        for t, nbp, ties in cases:
            args = decode_inputs(rng, t, nbp, dev, ties)
            args = args if fp32 else decode_bf16(*args)
            into[key] = max(into[key], check_kernel(viterbi, *args))
            if (t, nbp, ties) in ((691, 128, False), (691, 384, False), (123, lanes, False),
                                  (61, 2 * n_sm * lanes, False)):
                plan_line("viterbi_bwd", viterbi.card_plan(args[0]), args[0])
            if (t, nbp, ties) == (691, 128, False):
                k_ms, dev_ms, p_ms = lone_device_plain(
                    lambda: viterbi.viterbi_backward_tables_cuda(*args),
                    lambda: viterbi.viterbi_backward_tables_plain(*args))
                bnd = table_bound(696, 128, 2, score_bytes=args[0].element_size())
                if fp32:
                    ms["viterbi_bwd"], device_ms["viterbi_bwd"], plain_ms["viterbi_bwd"] = k_ms, dev_ms, p_ms
                    bounds["viterbi_bwd"] = bnd
                else:
                    bf16["viterbi_bwd"].update(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, bound=bnd)
                print(f"viterbi [696,696,128] {tag} ({card}): lone launch {k_ms:.4f} ms, device "
                      f"{dev_ms:.4f} ms over {DEVICE_LAUNCHES} launches, plain {p_ms:.3f} ms, bound "
                      f"{bnd[0]:.4f} ms ({bnd[1]})")
            if (t, nbp, ties) == (691, 384, False):
                k_ms, dev_ms = (cuda_ms(lambda: viterbi.viterbi_backward_tables_cuda(*args)),
                                cuda_ms(lambda: viterbi.viterbi_backward_tables_cuda(*args),
                                        launches=DEVICE_LAUNCHES))
                print(f"viterbi [696,696,384] {tag} ({card}): lone launch {k_ms:.4f} ms, device "
                      f"{dev_ms:.4f} ms over {DEVICE_LAUNCHES} launches, bound "
                      f"{table_bound(696, 384, 2, score_bytes=args[0].element_size())[0]:.4f} ms")
            del args
        print(f"viterbi {tag}: ptr equal to plain bit for bit, two runs the same bits, at "
              f"{[[-(-t // 8) * 8, -(-t // 8) * 8, n] + (['ties'] if ties else []) for t, n, ties in cases]}")

        # alpha and beta: the training batch, the ragged shape; beta also at
        # the cluster edges and at a Tp that is not a multiple of 8
        table_cases = [(691, 384, 360), (123, 256, 200)]
        for t, nbp, nb_real in table_cases:
            args = table_inputs(rng, t, nbp, nb_real, dev)
            args = args if fp32 else table_bf16(*args)
            errs = check_tables(logz, *args)
            for name in ("semicrf_alpha", "semicrf_beta"):
                if fp32:
                    err[name] = max(err[name], errs[name])
                else:
                    bf16.setdefault(name, {"max_abs_err": 0.0})
                    bf16[name]["max_abs_err"] = max(bf16[name]["max_abs_err"], errs[name])
            if (t, nbp) != (691, 384):
                continue
            s, shift, noise, spdiag = args
            plan_line("semicrf_beta", logz.beta_card_plan(s), s)
            for name, kernel, plain, rows in (
                ("semicrf_alpha", logz.alpha_table_padded_cuda, logz.alpha_table_padded_plain, shift),
                ("semicrf_beta", logz.beta_table_padded_cuda, logz.beta_table_padded_plain, noise),
            ):
                k_ms, dev_ms, p_ms = lone_device_plain(lambda: kernel(s, rows, spdiag),
                                                       lambda: plain(s, rows, spdiag))
                bnd = table_bound(696, 384, 4, score_bytes=s.element_size())
                if fp32:
                    ms[name], device_ms[name], plain_ms[name], bounds[name] = k_ms, dev_ms, p_ms, bnd
                else:
                    bf16[name].update(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, bound=bnd)
                print(f"{name} [696,696,384] {tag} ({card}): lone launch {k_ms:.4f} ms, device "
                      f"{dev_ms:.4f} ms over {DEVICE_LAUNCHES} launches, plain {p_ms:.3f} ms, bound "
                      f"{bnd[0]:.4f} ms ({bnd[1]})")
            del s, shift, noise, spdiag, args
        lanes = logz.launch_plan(696, 384, dtype, n_sm).lanes
        for t, nbp in ((123, lanes), (61, 2 * n_sm * lanes), (125, 256)):
            s, _, noise, spdiag = table_inputs(rng, t, nbp, nbp, dev)
            if t == 125:  # Tp = 125: the last block (t = 0 .. 4) is part full
                s, noise, spdiag = (s[:125, :125].contiguous(), noise[:125].contiguous(),
                                    spdiag[:125].contiguous())
            s, _, noise, spdiag = (s, None, noise, spdiag) if fp32 else table_bf16(s, None, noise, spdiag)
            got = logz.beta_table_padded_cuda(s, noise, spdiag)
            again = logz.beta_table_padded_cuda(s, noise, spdiag)
            want = logz.beta_table_padded_plain(s, noise, spdiag)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if bool((diff > TABLE_RTOL * want.abs().clamp(min=1.0)).any()) or not torch.equal(got, again):
                raise AssertionError(f"semicrf_beta != plain at {list(s.shape)} {tag}: max |diff| "
                                     f"{float(diff.max())}, two runs equal {torch.equal(got, again)}")
            if fp32:
                err["semicrf_beta"] = max(err["semicrf_beta"], float(diff.max()))
            else:
                bf16["semicrf_beta"]["max_abs_err"] = max(bf16["semicrf_beta"]["max_abs_err"], float(diff.max()))
            if t != 125:
                plan_line("semicrf_beta", logz.beta_card_plan(s), s)
            del s, noise, spdiag, got, again, want
        a_err, b_err = ((err["semicrf_alpha"], err["semicrf_beta"]) if fp32 else
                        (bf16["semicrf_alpha"]["max_abs_err"], bf16["semicrf_beta"]["max_abs_err"]))
        print(f"alpha/beta {tag} within {TABLE_RTOL}*max(1,|plain|) of plain, two runs the same bits, at "
              f"[696,696,384] and [128,128,256] (beta also at [128,128,{lanes}], "
              f"[64,64,{2 * n_sm * lanes}] and [125,125,256]): max |diff| alpha {a_err:.3g}, beta {b_err:.3g}")
    grad_err = check_logz_grad(logz, semicrf, dev)
    print(f"logZ + score cotangent via kernels vs autograd of log_z_slow [45,45,5]: "
          f"max |diff| {grad_err:.3g}")

    # attention: the segment's and the training batch's shapes, a ragged one
    # and one only the general kernels take, at fp32 and at bf16
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def time_attention(q, k, v, do, o, heads):
        """For the forward ("fwd") and the backward ("bwd") on these inputs:
        (kernel ms, plain ms, library ms, bound, general-kernel ms, byte
        bound ms), and the library's distance from the kernel's output.  The
        bound of fp32 inputs is ``bound``'s (fp32 operations at the CUDA
        cores' rate); of bf16 inputs, 2 bytes a value against the operations
        at the tensor cores' bf16 rate."""
        b, sq, d = q.shape
        dh = d // heads
        scale = 1.0 / math.sqrt(dh)
        # the library's call on the same inputs, heads as strided views
        qh, kh, vh = (t.view(b, -1, heads, dh).transpose(1, 2).requires_grad_() for t in (q, k, v))
        o_lib = sdpa(qh, kh, vh, scale=scale)
        do_h = do.view(b, sq, heads, dh).transpose(1, 2)
        lib_err = float((o_lib.detach().transpose(1, 2).reshape(b, sq, d).float() - o.float()).abs().max())
        # 2 products forward, 5 backward, 2 operations a multiply-add;
        # 4 tensors moved forward, 5 read and 3 written backward
        products = 2 * b * heads * sq * k.shape[1] * dh
        peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
        fwd_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        bwd_bytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
        timed = {
            "fwd": (cuda_ms(lambda: attention.attention_fwd_cuda(q, k, v, heads, scale)),
                    cuda_ms(lambda: attention.attention_plain(q, k, v, heads, scale)),
                    cuda_ms(lambda: sdpa(qh.detach(), kh.detach(), vh.detach(), scale=scale)),
                    bound(fwd_bytes, 2 * products, peak),
                    cuda_ms(lambda: attention.attention_fwd_cuda(q, k, v, heads, scale, variant="general")),
                    bound(fwd_bytes, 0)[0]),
            "bwd": (cuda_ms(lambda: attention.attention_bwd_cuda(q, k, v, o, do, heads, scale)),
                    cuda_ms(lambda: attention.attention_bwd_plain(q, k, v, o, do, heads, scale)),
                    cuda_ms(lambda: torch.autograd.grad(o_lib, (qh, kh, vh), do_h, retain_graph=True)),
                    bound(bwd_bytes, 5 * products, peak),
                    cuda_ms(lambda: attention.attention_bwd_cuda(q, k, v, o, do, heads, scale,
                                                                 variant="general")),
                    bound(bwd_bytes, 0)[0]),
        }
        for side, (k_ms, _, _, bnd, general_ms, _) in timed.items():
            if bnd[0] > k_ms:
                raise AssertionError(f"attention {side} at {tuple(q.shape)} {q.dtype}: {k_ms} ms is "
                                     f"under its bound of {bnd[0]} ms: a wrong count")
            if q.dtype == torch.float32 and not k_ms < general_ms:
                raise AssertionError(f"attention {side} at {tuple(q.shape)}: the tensor-core kernel "
                                     f"({k_ms} ms) is no faster than the general one ({general_ms} ms)")
        return timed, lib_err

    err["attention_fwd"] = err["attention_bwd"] = 0.0
    bf16["attention_fwd"], bf16["attention_bwd"] = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    attn_checked = [(s, s[1], ATTN_HEADS, "mma") for s in ATTN_SHAPES + TRAIN_ATTN_SHAPES] + [
        (*RAGGED_ATTN, "mma"), (*LONG_ATTN, "general")]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, skv, heads, variant in attn_checked:
            b, sq, d = shape
            q, k, v, do = attention_inputs(rng, b, sq, skv, d, dev, dtype)
            fwd_err, bwd_err, o = check_attention(attention, q, k, v, do, heads, variant)
            for name, e in (("attention_fwd", fwd_err), ("attention_bwd", bwd_err)):
                into, at = (err, name) if dtype == torch.float32 else (bf16[name], "max_abs_err")
                into[at] = max(into[at], e)
            if shape not in (ATTN_SHAPES[0], TRAIN_ATTN_SHAPES[0]):
                continue
            timed, lib_err = time_attention(q, k, v, do, o, heads)
            # the kernels line: the forward at the segment's shape; the backward
            # at the batch's, the only one the paths launch it at
            name, side = ("attention_fwd", "fwd") if shape == ATTN_SHAPES[0] else ("attention_bwd", "bwd")
            if dtype == torch.float32:
                ms[name], plain_ms[name], library_ms[name], bounds[name] = timed[side][:4]
            else:
                bf16[name].update(zip(("ms", "plain_ms", "library_ms", "bound"), timed[side][:4]))
            for side, what, lib in (("fwd", "forward", "SDPA"), ("bwd", "backward", "SDPA backward")):
                k_ms, p_ms, lib_ms, bnd, general_ms, byte_ms = timed[side]
                print(f"attention {what} {list(shape)}, {heads} heads, {str(dtype)[6:]} ({card}): kernel "
                      f"{k_ms:.4f} ms, general kernel {general_ms:.4f} ms, plain {p_ms:.4f} ms, {lib} "
                      f"{lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; by bytes {byte_ms:.4f} ms), "
                      f"share {bnd[0] / k_ms:.1%}" + (f", |SDPA - kernel| {lib_err:.3g}" if side == "fwd" else ""))
    print(f"attention vs plain at {[list(s) for s in ATTN_SHAPES + TRAIN_ATTN_SHAPES]}, q "
          f"{list(RAGGED_ATTN[0])} x {RAGGED_ATTN[1]} keys with {RAGGED_ATTN[2]} heads, and q "
          f"{list(LONG_ATTN[0])} x {LONG_ATTN[1]} keys with {LONG_ATTN[2]} heads (the general kernels): "
          f"fp32 within {FWD_ATOL} (forward) and {BWD_ATOL} (dq, dk, dv), max |diff| "
          f"{err['attention_fwd']:.3g} and {err['attention_bwd']:.3g}; bf16 within one bf16 spacing of "
          f"each output's largest value, max |diff| {bf16['attention_fwd']['max_abs_err']:.3g} and "
          f"{bf16['attention_bwd']['max_abs_err']:.3g}; the backward's two runs equal bit for bit")
    del q, k, v, do, o

    # fused MLP, fp32 and bf16: the segment's and the training batch's shapes
    # and a ragged one (D = 128, last row tile part full), each with row-major
    # weights and with nn.Linear's layout; timed with the latter, the one the
    # path hands it.  The kernels line carries the segment's shape.  Bound:
    # the tensor cores' rate, TF32 at fp32 with the three `mma` a product that
    # the high/low split takes, bf16 at bf16.  The plain version is two cuBLAS
    # products and a GELU: what the default route runs in the kernel's place.
    err["fused_mlp"], bf16["fused_mlp"] = 0.0, {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        for shape, hidden in (((1000, 128), 192), (TRAIN_MLP_SHAPE, MLP_HIDDEN), (MLP_SHAPE, MLP_HIDDEN)):
            args = mlp_inputs(rng, *shape, hidden, dev, dtype)
            e = check_mlp(mlp, args)
            if fp32:
                err["fused_mlp"] = max(err["fused_mlp"], e)
            else:
                bf16["fused_mlp"]["max_abs_err"] = max(bf16["fused_mlp"]["max_abs_err"], e)
            if shape not in (MLP_SHAPE, TRAIN_MLP_SHAPE):
                continue
            views = as_linear_stores(args)
            k_ms = cuda_ms(lambda: mlp.mlp_fwd_cuda(*views))
            p_ms = cuda_ms(lambda: mlp.mlp_plain(*views))
            k_dev = cuda_ms(lambda: mlp.mlp_fwd_cuda(*views), launches=DEVICE_LAUNCHES)
            p_dev = cuda_ms(lambda: mlp.mlp_plain(*views), launches=DEVICE_LAUNCHES)
            rowmajor_dev = cuda_ms(lambda: mlp.mlp_fwd_cuda(*args), launches=DEVICE_LAUNCHES)
            m_rows, d = shape
            n_bytes = args[0].element_size() * (2 * m_rows * d + 2 * d * hidden + hidden + d)
            flops = 4 * m_rows * d * hidden  # two products, 2 operations a multiply-add
            bnd = bound(n_bytes, 3 * flops, TF32_FLOPS) if fp32 else bound(n_bytes, flops, BF16_FLOPS)
            if bnd[0] > min(k_ms, k_dev):
                raise AssertionError(f"fused_mlp at {shape} {dtype}: {min(k_ms, k_dev)} ms is under "
                                     f"its bound of {bnd[0]} ms: a wrong count")
            blocks, warps = mlp.launch_plan(m_rows, dev)
            print(f"fused_mlp {list(shape)} -> {hidden} -> {d} {str(dtype)[6:]} ({card}): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]} on the tensor "
                  f"cores), share {bnd[0] / k_ms:.1%}; device time over {DEVICE_LAUNCHES} launches: "
                  f"kernel {k_dev:.4f} ms, with row-major weights {rowmajor_dev:.4f} ms, plain "
                  f"{p_dev:.4f} ms; {blocks} blocks of {warps} warps")
            if shape == MLP_SHAPE and fp32:
                ms["fused_mlp"], plain_ms["fused_mlp"], bounds["fused_mlp"] = k_ms, p_ms, bnd
            elif shape == MLP_SHAPE:
                bf16["fused_mlp"].update(ms=k_ms, plain_ms=p_ms, bound=bnd)
    print(f"fused_mlp vs plain at {list(MLP_SHAPE)}, {list(TRAIN_MLP_SHAPE)} and [1000,128] -> 192, "
          f"row-major weights and nn.Linear's layout (equal bit for bit): fp32 within {FWD_ATOL}, "
          f"max |diff| {err['fused_mlp']:.3g}; bf16 within {MLP_BF16_SPACINGS} bf16 spacings of the "
          f"output's largest value (and one of the fp64 result), max |diff| "
          f"{bf16['fused_mlp']['max_abs_err']:.3g}")
    del args, views

    # row softmax: the segment's and the training batch's logits and ragged
    # shapes, fp32 and bf16; timed at the segment's F-attention logits with
    # the L2 cache flushed before each run (the bf16 tensors would fit it)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    err["softmax_fwd"] = err["softmax_bwd"] = 0.0
    bf16["softmax_fwd"], bf16["softmax_bwd"] = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SOFTMAX_SHAPES + TRAIN_SOFTMAX_SHAPES + RAGGED_SOFTMAX_SHAPES:
            l, do = softmax_inputs(rng, *shape, dtype, dev)
            errs = check_softmax(softmax, l, do)
            for name, e in zip(("softmax_fwd", "softmax_bwd"), errs):
                into = err if dtype == torch.float32 else bf16[name]
                key = name if dtype == torch.float32 else "max_abs_err"
                into[key] = max(into[key], e)
        l, do = softmax_inputs(rng, *SOFTMAX_SHAPES[0], dtype, dev)
        l_lib = l.clone().requires_grad_()
        p_lib = torch.softmax(l_lib, -1)
        n_bytes = l.numel() * l.element_size()
        timed = {
            "softmax_fwd": (cuda_ms(lambda: softmax.softmax_fwd_cuda(l), before=flush_buf.zero_),
                            cuda_ms(lambda: softmax.softmax_plain(l), before=flush_buf.zero_),
                            cuda_ms(lambda: torch.softmax(l, -1), before=flush_buf.zero_),
                            bound(2 * n_bytes, 5 * l.numel())),
            "softmax_bwd": (cuda_ms(lambda: softmax.softmax_bwd_cuda(l, do), before=flush_buf.zero_),
                            cuda_ms(lambda: softmax.softmax_bwd_plain(l, do), before=flush_buf.zero_),
                            cuda_ms(lambda: torch.autograd.grad(p_lib, l_lib, do, retain_graph=True),
                                    before=flush_buf.zero_),
                            bound(3 * n_bytes, 8 * l.numel())),
        }
        # the device's time a launch, without the wrapper's host work (about
        # the size of the kernel here): DEVICE_LAUNCHES launches a run, no flush
        device = {
            "softmax_fwd": (cuda_ms(lambda: softmax.softmax_fwd_cuda(l), launches=DEVICE_LAUNCHES),
                            cuda_ms(lambda: torch.softmax(l, -1), launches=DEVICE_LAUNCHES)),
            "softmax_bwd": (cuda_ms(lambda: softmax.softmax_bwd_cuda(l, do), launches=DEVICE_LAUNCHES),
                            cuda_ms(lambda: torch.autograd.grad(p_lib, l_lib, do, retain_graph=True),
                                    launches=DEVICE_LAUNCHES)),
        }
        for name, (k_ms, p_ms, lib_ms, bnd) in timed.items():
            if dtype == torch.float32:
                ms[name], plain_ms[name], library_ms[name], bounds[name] = k_ms, p_ms, lib_ms, bnd
            else:
                bf16[name].update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound=bnd)
            if bnd[0] > k_ms:  # the flushed run: the unflushed ones may find l in the L2 cache
                raise AssertionError(f"{name} {dtype}: {k_ms} ms is under its bound of {bnd[0]} ms: "
                                     f"a wrong count")
            lib = f"torch.softmax{' backward' if name.endswith('bwd') else ''}"
            print(f"{name} {list(SOFTMAX_SHAPES[0])} {str(dtype)[6:]} ({card}): kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, {lib} {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
                  f"device time over {DEVICE_LAUNCHES} launches: kernel {device[name][0]:.4f} ms, "
                  f"{lib} {device[name][1]:.4f} ms")
        del l, do, l_lib, p_lib
    del flush_buf
    print(f"softmax kernels vs plain at {[list(s) for s in SOFTMAX_SHAPES + TRAIN_SOFTMAX_SHAPES]} and "
          f"{[list(s) for s in RAGGED_SOFTMAX_SHAPES]}: fp32 within {SOFTMAX_ATOL} forward and "
          f"{SOFTMAX_ATOL} * max |do| backward (max |diff| forward "
          f"{err['softmax_fwd']:.3g}, backward {err['softmax_bwd']:.3g}); bf16 within one bf16 unit "
          f"of the plain result, + the fp32 bound backward (max |diff| forward "
          f"{bf16['softmax_fwd']['max_abs_err']:.3g}, backward {bf16['softmax_bwd']['max_abs_err']:.3g})")

    # -- path 1: flagship transcription on the card ----------------------------
    _, conf = load_default_conf()
    model = TransKun(conf, device=dev, seed=SEED)
    with torch.no_grad():
        # random weights fire singletons everywhere; bias the diagonal
        # negative so decoded event counts stay realistic
        model.module.scorer.map[0].bias[-1] = -8.0
    audio = synth_piece(conf.fs, PIECE_SECONDS, SEED)
    pad = math.ceil((conf.segmentSizeInSecond - conf.segmentHopSizeInSecond) * conf.fs)
    step = math.ceil(conf.segmentHopSizeInSecond * conf.fs / conf.hopSize) * conf.hopSize
    seg_size = math.ceil(conf.segmentSizeInSecond * conf.fs)

    def n_segments(n_samples):
        return math.ceil((n_samples + 2 * pad) / step)

    def timed_transcription(model):
        """(notes, wall seconds, peak GB, launches) of one transcription of
        the piece, after a warm-up one (cuBLAS handles, allocator pools)."""
        model.transcribe(audio)
        torch.cuda.synchronize()
        gc.collect()  # a full collection inside a timed run read as 0.2-0.3 s of it
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        notes = model.transcribe(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return notes, wall, torch.cuda.max_memory_allocated(dev) / 1e9, counts()

    def key(n):  # times to the millisecond: the refined ends move in their last bits
        return (round(n.start * 1e3), round(n.end * 1e3), n.pitch, n.velocity)

    def check_notes(notes, n_seg):
        if not notes:
            raise AssertionError("no notes decoded")
        validate_notes(notes)
        times = np.array([[n.start, n.end] for n in notes])
        # no note starts before 0 or ends after the last segment's last frame
        last_end = ((n_seg - 1) * step / conf.fs - pad / conf.fs
                    + frontend.num_frames(seg_size, conf.hopSize) * conf.hopSize / conf.fs)
        if not (np.isfinite(times).all() and times.min() >= 0 and times.max() <= last_end):
            raise AssertionError(f"note times out of range: {times.min()} .. {times.max()}")

    n_seg = n_segments(audio.shape[0])
    notes, wall, peak_gb, by_path["transcribe"] = timed_transcription(model)
    if by_path["transcribe"] != {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": n_seg}:
        raise AssertionError(f"transcription launches {by_path['transcribe']} for {n_seg} segments")
    check_notes(notes, n_seg)
    print(f"transcribe {PIECE_SECONDS:.0f} s, {n_seg} segments ({card}): wall {wall:.3f} s, "
          f"RTF {PIECE_SECONDS / wall:.1f}x, peak memory {peak_gb:.2f} GB, "
          f"{len(notes)} notes, launches {by_path['transcribe']}")

    # the same piece several times over, with the default segment_batch: device
    # memory must not grow with the piece (both pieces are longer than two groups)
    long_audio = np.tile(audio, (LONG_PIECE_TILES, 1))
    long_seconds, n_long = LONG_PIECE_TILES * PIECE_SECONDS, n_segments(long_audio.shape[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    long_notes = model.transcribe(long_audio)
    torch.cuda.synchronize()
    long_wall, long_peak_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 1e9
    if counts() != {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": n_long}:
        raise AssertionError(f"long transcription launches {counts()} for {n_long} segments")
    by_path["transcribe"]["viterbi_bwd"] += n_long
    check_notes(long_notes, n_long)
    group = transkun_module.DEFAULT_SEGMENT_BATCH
    print(f"transcribe {long_seconds:.0f} s, {n_long} segments in groups of {group} ({card}): wall "
          f"{long_wall:.3f} s, RTF {long_seconds / long_wall:.1f}x, peak memory {long_peak_gb:.3f} GB "
          f"against {peak_gb:.3f} GB for {PIECE_SECONDS:.0f} s ({n_seg} segments), {len(long_notes)} notes")
    if min(n_seg, n_long) <= 2 * group or abs(long_peak_gb - peak_gb) > PEAK_RTOL * peak_gb:
        raise AssertionError(f"peak memory {long_peak_gb} GB for {n_long} segments against {peak_gb} GB "
                             f"for {n_seg}: it grows with the piece (groups of {group})")
    del long_audio, long_notes

    # one segment's real scores: kernel table == plain table
    padded = np.pad(audio.T, ((0, 0), (pad, pad + seg_size)))
    seg = torch.from_numpy(padded[:, 3 * step : 3 * step + seg_size]).to(dev)
    with torch.no_grad():
        frames = frontend.make_frame(seg[None], conf.hopSize, conf.windowSize)
        t = frames.shape[-2]
        s_t, noise, diag, ctx = model.module.process_frames_decode(frames, -(-t // 8) * 8, 128)
        err["viterbi_bwd"] = max(err["viterbi_bwd"], check_kernel(viterbi, s_t, noise, diag * (diag > 0)))
    print(f"segment 3 real scores {tuple(s_t.shape)}: kernel ptr == plain ptr")
    del s_t, noise, diag

    # -- path 2: flagship training through the entry point ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pickles = build_corpus(os.path.join(tmp, "corpus"), conf.fs, SEED)
        print(f"corpus: {TRAIN_PIECES} train + {VAL_PIECES} validation pieces of "
              f"{CORPUS_PIECE_SECONDS:.0f} s in {time.perf_counter() - t0:.1f} s")
        ckpt = os.path.join(tmp, "ckpt.pt")
        args = ["--datasetPath", os.path.join(tmp, "corpus"),
                "--datasetMetaFile_train", os.path.join(pickles, "train.pickle"),
                "--datasetMetaFile_val", os.path.join(pickles, "val.pickle"),
                "--modelConf", default_conf_path(), "--batchSize", str(TRAIN_BATCH),
                "--ckptEvery", "3", "--logEvery", "1", "--seed", str(SEED), "--device", "cuda"]
        reset_counts()
        t0 = time.perf_counter()
        first = train_cli.main([ckpt, *args, "--statsEvery", "4", "--maxEpoch", "1"])
        second = train_cli.main([ckpt, *args, "--statsEvery", "4", "--maxEpoch", "2",
                                 "--stopAtStep", str(first["steps"] + 2)])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        by_path["train"] = counts()
        runs = (first, second)
        steps = sum(r["steps"] for r in runs)
        val_batches = sum(r["val_batches"] for r in runs)
        want = {**dict.fromkeys(KERNELS, 0),
                "semicrf_alpha": steps + val_batches, "semicrf_beta": steps + val_batches,
                "viterbi_bwd": sum(2 * r["stats_passes"] for r in runs) + val_batches}
        losses = [x for r in runs for x in r["losses"]]
        if by_path["train"] != want:
            raise AssertionError(f"training launches {by_path['train']}, calls made {want}")
        if second["steps"] != 2 or first["val_batches"] == 0 or first["stats_passes"] == 0:
            raise AssertionError(f"training runs {first} / {second}")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses}")
        step_s = first["step_seconds"][1:] + second["step_seconds"][1:]
        train_peak_gb = max(r["step_peak_bytes"] for r in runs) / 1e9
        print(f"train flagship V2 --batchSize {TRAIN_BATCH} ({card}): {steps} steps "
              f"({first['steps']} + resume {second['steps']}), {val_batches} validation "
              f"batches, {first['stats_passes'] + second['stats_passes']} stats passes, "
              f"wall {train_wall:.1f} s")
        print(f"train step: median {float(np.median(step_s)):.4f} s over {len(step_s)} steps "
              f"after each run's first (all: {[round(x, 4) for x in first['step_seconds'] + second['step_seconds']]}), "
              f"peak memory {train_peak_gb:.2f} GB")
        stats_s = first["stats_seconds"] + second["stats_seconds"]
        print(f"stats pass (two decodes of the batch, [696,696,384] Viterbi tables each) ({card}): "
              f"{[round(x, 4) for x in stats_s]} s")
        print(f"train losses: {[round(x, 3) for x in losses]}")
        print(f"validation: {first['val_results']}")
        print(f"training launches {by_path['train']} (= steps + validation batches; "
              f"2 per stats pass + 1 per validation batch)")

        # the trained best weights, loaded as a user would, transcribe a piece
        trained = TransKun(conf, device=dev)
        trained.load_state_dict(load_reference_checkpoint(ckpt))
        with open(os.path.join(pickles, "val.pickle"), "rb") as f:
            piece = pickle.load(f)[0]
        from scipy.io import wavfile

        _, x = wavfile.read(os.path.join(tmp, "corpus", piece["audio_filename"]))
        x = (x.astype(np.float32) / 32768.0)[:, None]
        reset_counts()
        trained_notes = trained.transcribe(x)
        torch.cuda.synchronize()
        validate_notes(trained_notes)
        if counts() != {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": n_segments(x.shape[0])}:
            raise AssertionError(f"launches {counts()} for {n_segments(x.shape[0])} segments")
        by_path["train"]["viterbi_bwd"] += viterbi.launches
        print(f"trained best_state_dict transcribes {CORPUS_PIECE_SECONDS:.0f} s: "
              f"{len(trained_notes)} notes, {viterbi.launches} Viterbi launches")
        del trained

        # -- path 3: the fused-backbone configuration, serving then training -----
        n_attn = sum(isinstance(m, layers.MultiHeadAttention) for m in model.module.modules())
        n_ffn = sum(isinstance(m, layers.FFNResBlock) for m in model.module.modules())
        for flag in FUSED_FLAGS:
            os.environ[flag] = "1"
        with CallCounter(attention, "fused_attention") as attn_calls, \
                CallCounter(mlp, "fused_mlp") as mlp_calls:
            fused_notes, fused_wall, fused_peak_gb, by_path["fused"] = timed_transcription(model)
            # the timed run only: the warm-up one made as many calls again
            calls = {"attention_fwd": attn_calls.calls // 2, "attention_bwd": 0,
                     "fused_mlp": mlp_calls.calls // 2}
            want = {**dict.fromkeys(KERNELS, 0), **calls, "viterbi_bwd": n_seg}
            if by_path["fused"] != want or calls["attention_fwd"] != n_seg * n_attn \
                    or calls["fused_mlp"] != n_seg * n_ffn:
                raise AssertionError(
                    f"fused transcription launches {by_path['fused']}, calls made {want} "
                    f"({n_seg} segments, {n_attn} attention and {n_ffn} FFN blocks)")
            if attn_calls.shapes != set(ATTN_SHAPES) or mlp_calls.shapes != {MLP_SHAPE}:
                raise AssertionError(f"the kernels were held against their plain versions at "
                                     f"{ATTN_SHAPES} and {MLP_SHAPE}; the path gave "
                                     f"{attn_calls.shapes} and {mlp_calls.shapes}")
            check_notes(fused_notes, n_seg)
            with torch.no_grad():
                ctx_fused = model.module.process_frames_decode(frames, -(-t // 8) * 8, 128)[3]
            ctx_err, ctx_max = float((ctx_fused - ctx).abs().max()), float(ctx.abs().max())
            if not bool(torch.isfinite(ctx_fused).all()) or ctx_err > CTX_RTOL * max(1.0, ctx_max):
                raise AssertionError(f"fused ctx differs from the default route's by {ctx_err} "
                                     f"(max |ctx| {ctx_max})")

            differing = len({key(n) for n in notes} ^ {key(n) for n in fused_notes})
            print(f"fused transcribe {PIECE_SECONDS:.0f} s ({card}): wall {fused_wall:.3f} s "
                  f"(default route {wall:.3f} s), RTF {PIECE_SECONDS / fused_wall:.1f}x "
                  f"({PIECE_SECONDS / wall:.1f}x), peak memory {fused_peak_gb:.2f} GB "
                  f"({peak_gb:.2f} GB), {len(fused_notes)} notes ({len(notes)}), "
                  f"{differing} notes differ between the routes; launches {by_path['fused']}")
            print(f"segment 3 ctx {tuple(ctx.shape)}: fused vs default max |diff| {ctx_err:.3g} "
                  f"(max |ctx| {ctx_max:.3g}, allowed {CTX_RTOL} * max(1, max |ctx|))")
            del model, ctx_fused

            attn_calls.calls = mlp_calls.calls = 0
            attn_calls.shapes.clear()
            mlp_calls.shapes.clear()
            reset_counts()
            fused = train_cli.main([os.path.join(tmp, "ckpt_fused.pt"), *args, "--statsEvery", "0",
                                    "--maxEpoch", "1", "--stopAtStep", str(FUSED_TRAIN_STEPS)])
            torch.cuda.synchronize()
            fused_launches = counts()
        for flag in FUSED_FLAGS:
            del os.environ[flag]
        n = fused["steps"]
        recompute = 2 if conf.useGradientCheckpoint else 1  # checkpointed layers run twice
        want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": n, "semicrf_beta": n,
                "attention_fwd": attn_calls.calls, "attention_bwd": n * n_attn,
                "fused_mlp": mlp_calls.calls}
        if fused_launches != want or n != FUSED_TRAIN_STEPS \
                or attn_calls.calls != n * n_attn * recompute or mlp_calls.calls != n * n_ffn * recompute:
            raise AssertionError(f"fused training launches {fused_launches}, calls made {want} "
                                 f"({n} steps, {n_attn} attention and {n_ffn} FFN blocks, "
                                 f"x{recompute} forwards)")
        if attn_calls.shapes != set(TRAIN_ATTN_SHAPES) or mlp_calls.shapes != {TRAIN_MLP_SHAPE}:
            raise AssertionError(f"the kernels were held against their plain versions at "
                                 f"{TRAIN_ATTN_SHAPES} and {TRAIN_MLP_SHAPE}; training gave "
                                 f"{attn_calls.shapes} and {mlp_calls.shapes}")
        # same seed, same corpus: the default route's run took these steps too
        default_losses = first["losses"][:n]
        if len(fused["losses"]) != n or len(default_losses) != n \
                or not np.isfinite(fused["losses"]).all():
            raise AssertionError(f"fused losses {fused['losses']}, default {default_losses}")
        loss_err = max(abs(f - d) / abs(d) for f, d in zip(fused["losses"], default_losses))
        if loss_err > LOSS_RTOL:
            raise AssertionError(f"losses: fused {fused['losses']}, default {default_losses}, "
                                 f"largest relative difference {loss_err}")
        for name in KERNELS:
            by_path["fused"][name] += fused_launches[name]
        print(f"fused train flagship V2 --batchSize {TRAIN_BATCH} ({card}): {n} steps, step median "
              f"{float(np.median(fused['step_seconds'][1:])):.4f} s after the first (all: "
              f"{[round(x, 4) for x in fused['step_seconds']]}; default route "
              f"{float(np.median(step_s)):.4f} s), peak memory "
              f"{fused['step_peak_bytes'] / 1e9:.2f} GB ({train_peak_gb:.2f} GB)")
        print(f"fused train losses: {[round(x, 3) for x in fused['losses']]}; against the default "
              f"route's, step by step: largest relative difference {loss_err:.3g} (allowed {LOSS_RTOL})")
        print(f"fused training launches {fused_launches}; attention shapes "
              f"{sorted(attn_calls.shapes)}, MLP shapes {sorted(mlp_calls.shapes)}")

        # the attention flag alone, same steps in the same run: the step that
        # the both-flags step is read beside
        os.environ[FUSED_FLAGS[0]] = "1"
        reset_counts()
        with CallCounter(attention, "fused_attention") as attn_calls:
            attn_only = train_cli.main([os.path.join(tmp, "ckpt_attn.pt"), *args, "--statsEvery", "0",
                                        "--maxEpoch", "1", "--stopAtStep", str(FUSED_TRAIN_STEPS)])
            torch.cuda.synchronize()
        del os.environ[FUSED_FLAGS[0]]
        attn_only_launches = counts()
        n = attn_only["steps"]
        want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": n, "semicrf_beta": n,
                "attention_fwd": attn_calls.calls, "attention_bwd": n * n_attn}
        if attn_only_launches != want or n != FUSED_TRAIN_STEPS \
                or attn_calls.calls != n * n_attn * recompute or attn_calls.shapes != set(TRAIN_ATTN_SHAPES):
            raise AssertionError(f"attention-flag training launches {attn_only_launches}, calls made "
                                 f"{want} ({n} steps), shapes {attn_calls.shapes}")
        loss_err = max(abs(f - d) / abs(d) for f, d in zip(attn_only["losses"], default_losses))
        if len(attn_only["losses"]) != n or not loss_err <= LOSS_RTOL:
            raise AssertionError(f"losses: attention flag {attn_only['losses']}, default "
                                 f"{default_losses}, largest relative difference {loss_err}")
        for name in KERNELS:
            by_path["fused"][name] += attn_only_launches[name]
        print(f"train step, fp32, --batchSize {TRAIN_BATCH} ({card}), median after the first of "
              f"{FUSED_TRAIN_STEPS}: both fused flags {float(np.median(fused['step_seconds'][1:])):.4f} s "
              f"(all: {[round(x, 4) for x in fused['step_seconds']]}), {FUSED_FLAGS[0]} alone "
              f"{float(np.median(attn_only['step_seconds'][1:])):.4f} s (all: "
              f"{[round(x, 4) for x in attn_only['step_seconds']]}), default route "
              f"{float(np.median(step_s)):.4f} s; losses with the attention flag alone against the "
              f"default route's: largest relative difference {loss_err:.3g}")

        # -- path 4: the bf16 configuration, serving then training ------------------
        model_b = TransKun(conf, device=dev, seed=SEED, compute_dtype=torch.bfloat16)
        with torch.no_grad():
            model_b.module.scorer.map[0].bias[-1] = -8.0
        with CallCounter(transkun_module, "viterbi_backward_tables_padded") as vit_calls, \
                CallCounter(logz, "alpha_table_padded") as alpha_calls, \
                CallCounter(logz, "beta_table_padded") as beta_calls:
            bf16_notes, bf16_wall, bf16_peak_gb, by_path["bf16"] = timed_transcription(model_b)
            want = {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": n_seg}
            if by_path["bf16"] != want or vit_calls.calls != 2 * n_seg:  # warm-up + timed run
                raise AssertionError(f"bf16 transcription launches {by_path['bf16']}, calls made "
                                     f"{vit_calls.calls} over two runs of {n_seg} segments")
            if vit_calls.shapes != {(696, 696, 128)} or vit_calls.dtypes != {torch.bfloat16}:
                raise AssertionError(f"the Viterbi kernel was held against its plain version at "
                                     f"[696,696,128] bf16; the path gave {vit_calls.shapes} {vit_calls.dtypes}")
            check_notes(bf16_notes, n_seg)
            with torch.no_grad():
                ctx_b = model_b.module.process_frames_decode(frames, -(-t // 8) * 8, 128)[3]
            ctx_err, ctx_max = float((ctx_b - ctx).abs().max()), float(ctx.abs().max())
            if ctx_b.dtype != torch.float32 or not bool(torch.isfinite(ctx_b).all()) \
                    or ctx_err > BF16_CTX_RTOL * ctx_max:
                raise AssertionError(f"bf16 ctx differs from the fp32 route's by {ctx_err} "
                                     f"(max |ctx| {ctx_max})")
            differing = len({key(n) for n in notes} ^ {key(n) for n in bf16_notes})
            print(f"bf16 transcribe {PIECE_SECONDS:.0f} s ({card}): wall {bf16_wall:.3f} s "
                  f"(fp32 route {wall:.3f} s), RTF {PIECE_SECONDS / bf16_wall:.1f}x "
                  f"({PIECE_SECONDS / wall:.1f}x), peak memory {bf16_peak_gb:.2f} GB "
                  f"({peak_gb:.2f} GB), {len(bf16_notes)} notes ({len(notes)}), "
                  f"{differing} notes differ from the fp32 route's; launches {by_path['bf16']}")
            print(f"segment 3 ctx {tuple(ctx.shape)}: bf16 vs fp32 max |diff| {ctx_err:.3g} "
                  f"(max |ctx| {ctx_max:.3g}, allowed {BF16_CTX_RTOL} * max |ctx|)")

            # the same with TRANSKUN_TPU_FUSED_ATTN alone, then with both fused
            # flags: bf16 q, k, v at the attention kernel, bf16 x at the MLP kernel
            for flags in (FUSED_FLAGS[:1], FUSED_FLAGS):
                with_mlp = int(FUSED_FLAGS[1] in flags)
                label = " + ".join(flags)
                for flag in flags:
                    os.environ[flag] = "1"
                with CallCounter(attention, "fused_attention") as attn_calls, \
                        CallCounter(mlp, "fused_mlp") as mlp_calls:
                    fa_notes, fa_wall, fa_peak_gb, fa_launches = timed_transcription(model_b)
                    with torch.no_grad():
                        ctx_fa = model_b.module.process_frames_decode(frames, -(-t // 8) * 8, 128)[3]
                for flag in flags:
                    del os.environ[flag]
                # the warm-up run, the timed run, and one segment more for ctx
                want = {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": n_seg,
                        "attention_fwd": n_seg * n_attn, "fused_mlp": n_seg * n_ffn * with_mlp}
                if fa_launches != want or attn_calls.calls != (2 * n_seg + 1) * n_attn \
                        or mlp_calls.calls != (2 * n_seg + 1) * n_ffn * with_mlp:
                    raise AssertionError(f"bf16 {label} transcription launches {fa_launches}, calls "
                                         f"made {attn_calls.calls} and {mlp_calls.calls} over two runs "
                                         f"of {n_seg} segments and one segment, {n_attn} attention and "
                                         f"{n_ffn} FFN blocks")
                if attn_calls.shapes != set(ATTN_SHAPES) or attn_calls.dtypes != {torch.bfloat16}:
                    raise AssertionError(f"the attention kernel was held against its plain version at "
                                         f"{ATTN_SHAPES} bf16; the path gave {attn_calls.shapes} "
                                         f"{attn_calls.dtypes}")
                if with_mlp and (mlp_calls.shapes != {MLP_SHAPE} or mlp_calls.dtypes != {torch.bfloat16}):
                    raise AssertionError(f"the MLP kernel was held against its plain version at "
                                         f"{MLP_SHAPE} bf16; the path gave {mlp_calls.shapes} "
                                         f"{mlp_calls.dtypes}")
                check_notes(fa_notes, n_seg)
                ctx_err = float((ctx_fa - ctx).abs().max())
                if ctx_fa.dtype != torch.float32 or not bool(torch.isfinite(ctx_fa).all()) \
                        or ctx_err > BF16_CTX_RTOL * ctx_max:
                    raise AssertionError(f"bf16 {label} ctx differs from the fp32 route's by "
                                         f"{ctx_err} (max |ctx| {ctx_max})")
                for name in KERNELS:
                    by_path["bf16"][name] += fa_launches[name]
                differing = len({key(n) for n in notes} ^ {key(n) for n in fa_notes})
                print(f"bf16 + {label} transcribe {PIECE_SECONDS:.0f} s ({card}): wall "
                      f"{fa_wall:.3f} s (bf16 default route {bf16_wall:.3f} s, fp32 {wall:.3f} s), peak "
                      f"memory {fa_peak_gb:.2f} GB ({bf16_peak_gb:.2f} GB, {peak_gb:.2f} GB), "
                      f"{len(fa_notes)} notes, {differing} differ from the fp32 route's; launches "
                      f"{fa_launches}; q at the attention kernel {sorted(attn_calls.shapes)} bf16"
                      + (f", x at the MLP kernel {sorted(mlp_calls.shapes)} bf16" if with_mlp else "")
                      + f"; segment 3 ctx vs fp32 max |diff| {ctx_err:.3g} (allowed {BF16_CTX_RTOL} * "
                      f"max |ctx| {ctx_max:.3g})")
            del model_b, ctx, ctx_b, ctx_fa, frames

            reset_counts()
            bf16_run = train_cli.main([os.path.join(tmp, "ckpt_bf16.pt"), *args, "--statsEvery", "0",
                                       "--maxEpoch", "1", "--stopAtStep", str(BF16_TRAIN_STEPS),
                                       "--bf16"])
            torch.cuda.synchronize()
            bf16_launches = counts()
        n = bf16_run["steps"]
        want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": n, "semicrf_beta": n}
        if bf16_launches != want or n != BF16_TRAIN_STEPS \
                or (alpha_calls.calls, beta_calls.calls) != (n, n):
            raise AssertionError(f"bf16 training launches {bf16_launches}, calls made "
                                 f"alpha {alpha_calls.calls}, beta {beta_calls.calls} in {n} steps")
        for calls in (alpha_calls, beta_calls):
            if calls.shapes != {(696, 696, 384)} or calls.dtypes != {torch.bfloat16}:
                raise AssertionError(f"{calls.name} was held against its plain version at "
                                     f"[696,696,384] bf16; training gave {calls.shapes} {calls.dtypes}")
        fp32_losses = first["losses"][:n]  # same seed, same corpus
        if len(bf16_run["losses"]) != n or len(fp32_losses) != n \
                or not np.isfinite(bf16_run["losses"]).all():
            raise AssertionError(f"bf16 losses {bf16_run['losses']}, fp32 {fp32_losses}")
        loss_err = max(abs(b - d) / abs(d) for b, d in zip(bf16_run["losses"], fp32_losses))
        if loss_err > BF16_LOSS_RTOL:
            raise AssertionError(f"losses: bf16 {bf16_run['losses']}, fp32 {fp32_losses}, "
                                 f"largest relative difference {loss_err}")
        for name in KERNELS:
            by_path["bf16"][name] += bf16_launches[name]
        print(f"bf16 train flagship V2 --batchSize {TRAIN_BATCH} --bf16 ({card}): {n} steps, step "
              f"median {float(np.median(bf16_run['step_seconds'][1:])):.4f} s after the first (all: "
              f"{[round(x, 4) for x in bf16_run['step_seconds']]}; fp32 route "
              f"{float(np.median(step_s)):.4f} s), peak memory "
              f"{bf16_run['step_peak_bytes'] / 1e9:.2f} GB ({train_peak_gb:.2f} GB)")
        print(f"bf16 train losses: {[round(x, 3) for x in bf16_run['losses']]}; against the fp32 "
              f"route's, step by step: largest relative difference {loss_err:.3g} "
              f"(allowed {BF16_LOSS_RTOL}); launches {bf16_launches}")

        # --bf16 with TRANSKUN_TPU_FUSED_ATTN alone, then with both fused flags:
        # both attention kernels, and the MLP kernel, at bf16
        for flags in (FUSED_FLAGS[:1], FUSED_FLAGS):
            with_mlp = int(FUSED_FLAGS[1] in flags)
            label = " + ".join(flags)
            for flag in flags:
                os.environ[flag] = "1"
            reset_counts()
            with CallCounter(attention, "fused_attention") as attn_calls, \
                    CallCounter(mlp, "fused_mlp") as mlp_calls:
                fa_run = train_cli.main([os.path.join(tmp, f"ckpt_bf16_{len(flags)}.pt"), *args,
                                         "--statsEvery", "0", "--maxEpoch", "1", "--stopAtStep",
                                         str(BF16_FUSED_TRAIN_STEPS), "--bf16"])
                torch.cuda.synchronize()
            for flag in flags:
                del os.environ[flag]
            fa_launches = counts()
            n = fa_run["steps"]
            want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": n, "semicrf_beta": n,
                    "attention_fwd": attn_calls.calls, "attention_bwd": n * n_attn,
                    "fused_mlp": mlp_calls.calls}
            if fa_launches != want or n != BF16_FUSED_TRAIN_STEPS \
                    or attn_calls.calls != n * n_attn * recompute \
                    or mlp_calls.calls != n * n_ffn * recompute * with_mlp:
                raise AssertionError(f"bf16 {label} training launches {fa_launches}, calls made {want} "
                                     f"({n} steps, {n_attn} attention and {n_ffn} FFN blocks, "
                                     f"x{recompute} forwards)")
            if attn_calls.shapes != set(TRAIN_ATTN_SHAPES) or attn_calls.dtypes != {torch.bfloat16}:
                raise AssertionError(f"the attention kernels were held against their plain versions at "
                                     f"{TRAIN_ATTN_SHAPES} bf16; training gave {attn_calls.shapes} "
                                     f"{attn_calls.dtypes}")
            if with_mlp and (mlp_calls.shapes != {TRAIN_MLP_SHAPE} or mlp_calls.dtypes != {torch.bfloat16}):
                raise AssertionError(f"the MLP kernel was held against its plain version at "
                                     f"{TRAIN_MLP_SHAPE} bf16; training gave {mlp_calls.shapes} "
                                     f"{mlp_calls.dtypes}")
            fp32_losses = first["losses"][:n]
            if len(fa_run["losses"]) != n or not np.isfinite(fa_run["losses"]).all():
                raise AssertionError(f"bf16 {label} losses {fa_run['losses']}")
            loss_err = max(abs(b - d) / abs(d) for b, d in zip(fa_run["losses"], fp32_losses))
            if loss_err > BF16_LOSS_RTOL:
                raise AssertionError(f"losses: bf16 {label} {fa_run['losses']}, fp32 {fp32_losses}, "
                                     f"largest relative difference {loss_err}")
            for name in KERNELS:
                by_path["bf16"][name] += fa_launches[name]
            print(f"bf16 + {label} train --batchSize {TRAIN_BATCH} --bf16 ({card}): {n} steps, "
                  f"step seconds {[round(x, 4) for x in fa_run['step_seconds']]} (bf16 default route "
                  f"{float(np.median(bf16_run['step_seconds'][1:])):.4f} s), peak memory "
                  f"{fa_run['step_peak_bytes'] / 1e9:.2f} GB; losses {[round(x, 3) for x in fa_run['losses']]}, "
                  f"against the fp32 route's: largest relative difference {loss_err:.3g} (allowed "
                  f"{BF16_LOSS_RTOL}); launches {fa_launches}; q at the attention kernels "
                  f"{sorted(attn_calls.shapes)} bf16"
                  + (f", x at the MLP kernel {sorted(mlp_calls.shapes)} bf16" if with_mlp else ""))

    # -- path 5: the softmax study, the explicit-softmax attention core -----------
    os.environ[SOFTMAX_FLAG] = "1"
    reset_counts()
    core_calls = 0
    for b, sq, d in ATTN_SHAPES:
        dh = d // ATTN_HEADS
        scale = 1.0 / math.sqrt(dh)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (a.to(dtype) for a in attention_inputs(rng, b, sq, sq, d, dev))

            def heads(a):  # flat [B, S, H*dh] -> [B, H, S, dh]
                return a.view(b, sq, ATTN_HEADS, dh).transpose(1, 2)

            qh, kh, vh = (heads(a).detach().requires_grad_() for a in (q, k, v))
            logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
            o = torch.matmul(softmax.softmax_last(logits), vh)
            o.backward(heads(do))
            core_calls += 1
            want = attention.attention_plain(q, k, v, ATTN_HEADS, scale)
            want_grads = attention.attention_bwd_plain(q, k, v, want, do, ATTN_HEADS, scale)
            torch.cuda.synchronize()

            def flat(a):
                return a.transpose(1, 2).reshape(b, sq, d).float()

            fwd_err = float((flat(o.detach()) - want.float()).abs().max())
            bwd_err = max(float((flat(g.grad) - w.float()).abs().max())
                          for g, w in zip((qh, kh, vh), want_grads))
            fwd_tol, bwd_tol = CORE_ATOL[str(dtype)[6:]]
            if tuple(logits.shape) != (b, ATTN_HEADS, sq, sq) or o.dtype != dtype \
                    or not (fwd_err <= fwd_tol and bwd_err <= bwd_tol):
                raise AssertionError(f"explicit-softmax core at {[b, ATTN_HEADS, sq, dh]} {dtype}: "
                                     f"forward max |diff| {fwd_err}, backward {bwd_err}")
            print(f"softmax study core {[b, ATTN_HEADS, sq, dh]} {str(dtype)[6:]}: vs attention_plain "
                  f"forward max |diff| {fwd_err:.3g} (allowed {fwd_tol}), dq/dk/dv {bwd_err:.3g} "
                  f"(allowed {bwd_tol})")
    del os.environ[SOFTMAX_FLAG]
    by_path["softmax"] = counts()
    want = {**dict.fromkeys(KERNELS, 0), "softmax_fwd": core_calls, "softmax_bwd": core_calls}
    if by_path["softmax"] != want:
        raise AssertionError(f"softmax study launches {by_path['softmax']}, calls made {want}")
    print(f"softmax study launches {by_path['softmax']}: rows {[list(s) for s in SOFTMAX_SHAPES]}, "
          f"the shapes the kernels were held against their plain versions at")

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "transkun_tpu")]
    if bad:
        raise AssertionError(f"JAX code was imported: {bad[:5]}")

    pallas = "transkun_tpu/ops/"
    sources = {"viterbi_bwd": ("viterbi_bwd.cu", pallas + "semicrf_pallas.py:67"),
               "semicrf_alpha": ("semicrf_alpha.cu", pallas + "semicrf_pallas.py:224"),
               "semicrf_beta": ("semicrf_beta.cu", pallas + "semicrf_pallas.py:321"),
               "attention_fwd": ("attention_fwd.cu", pallas + "attention_pallas.py:78"),
               "attention_bwd": ("attention_bwd.cu", pallas + "attention_pallas.py:127"),
               "fused_mlp": ("fused_mlp.cu", pallas + "mlp_pallas.py:86"),
               "softmax_fwd": ("softmax_rows.cu", pallas + "softmax_pallas.py:54"),
               "softmax_bwd": ("softmax_rows.cu", pallas + "softmax_pallas.py:62")}

    def bf16_entry(name):
        """The same numbers with bf16 input (kernels 1-5, 7 and 8)."""
        if name not in bf16:
            return None
        e = bf16[name]
        return {"max_abs_err": e["max_abs_err"], "ms": e["ms"], "device_ms": e.get("device_ms"),
                "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0], "bound_by": e["bound"][1],
                "library_ms": e.get("library_ms")}

    for name in KERNELS:
        if sum(by_path[path][name] for path in by_path) == 0:
            raise AssertionError(f"no path launched {name}")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "transkun_tpu_torch/csrc/" + sources[name][0],
        "replaces": sources[name][1],
        "launches": sum(by_path[path][name] for path in by_path),
        "launches_by_path": {path: by_path[path][name] for path in by_path},
        "max_abs_err": err[name],
        "ms": ms[name],
        "device_ms": device_ms.get(name),
        "plain_ms": plain_ms[name],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": library_ms[name],
        "bf16": bf16_entry(name),
    } for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
