#!/usr/bin/env python3
"""Drive the PyTorch port (``transkun_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

1. Builds the CUDA kernels (eleven in the kernels line, the streaming
   attention variants apart) from the eight sources of
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
3. Holds the alpha and beta kernels (kernels 2 and 3, blocked as kernel 1;
   alpha's far scores arrive by TMA) against their plain versions at the
   flagship training shape [696, 696, 384] (t = 691, 360 real lanes) and
   at a ragged shape (t = 123, Tp = 128, NBp = 256), and both also at the
   cluster edges (one lane group; more lane groups than SMs) and at
   Tp = 125, and alpha at every cluster size its plan allows (1-8) at
   [696, 696, 384]: |kernel - plain| <= 1e-5 * max(1, |plain|), the sums
   being taken in another order, two runs the same bits, one launch counted
   for each call; with fp32 and bf16 scores.  Each kernel's launch plan
   (lanes, cluster, CTAs, shared memory; alpha's TMA ring) goes into the
   kernels line.  Then the logZ gradient through the kernels against
   autograd of the plain ``log_z_slow`` at a small ragged shape.  Kernels 1-3 are timed
   with CUDA events (median of several runs): a lone launch, the device's
   time a launch over 20 launches, the plain version, and the bound (the
   strict triangle of the score tensor read once).
   The attention forward and backward kernels against their plain versions,
   with fp32 and with bf16 inputs, at the flagship shapes of one segment
   ([89, 149, 256] and [149, 89, 256], 8 heads), of a training batch of 4
   ([356, 149, 256] and [596, 89, 256]), at a ragged shape (cross-attention,
   odd lengths, 3 heads of 8) and at a long one (100 queries x 180 keys,
   2 heads of 80), which only the general kernels take.  fp32: forward within 2e-5, dq/dk/dv within 1e-4 on unit-normal
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
   from a seeded ``torch.Generator``, on the default route (each group's
   pointer walk and stitching chain on the card, the walk kernel
   ``decode_walk``).  The piece and the long one below first run at the
   default event budget; if either overflows it (the host-walk route taken
   from a group on), the timed runs set ``decode_k_budget`` to the next power
   of two above the largest group count, and say so.  The timed run must not
   fall back; it launches the Viterbi kernel once per segment and the walk
   kernel once per group.  The same piece on the host-walk route
   (``decode_k_budget = 1``): the same notes (pitch, velocity, flags, times
   within 1e-6 s).  Then the same piece nine times over (9.6 minutes) with
   the default ``segment_batch``: its peak device memory must be within 10%
   of the 64 s piece's.  The mid-piece fallback, at the default budget if it
   overflowed, else at a budget that the first group fits and a later one
   does not (on the first piece whose counts allow one): the notes of the
   route without it.  A dispatch under
   ``torch.cuda.set_sync_debug_mode("warn")`` must make no synchronizing
   call, and ``transcribe_many`` over 4 copies of the piece must give the
   notes of 4 ``transcribe`` calls, in order (walls printed in turns).  The
   walk kernel against ``walk_group_plain`` (on the CPU), every output equal
   as integers and two launches the same bits, each launch's begins and ends
   on memory that held a sentinel (the kernel writes every slot), on every
   group of the piece's real tables (the last group of 2 segments) with the
   starts carried group to group, from random forced starts, with an onset
   bound and with a k_max of 2 that overflows; the next starts also against
   the host walk's; then on the first group's tables cut to 89 tracks and
   to one segment, and at a k_max whose buffer does not fit (events to
   global memory; the plain version on the card), each case's launch plan
   printed.  One call runs one operation on the card (``torch.profiler``):
   the kernel, no memset.  It is timed on the first group (4 segments, t = 691) beside the
   plain version on the card and the CPU and the host walk; its bound is the
   bytes the visited positions need, and the ns a chain step is printed.
   Then on one segment's real scores the Viterbi
   kernel's table equals the plain version's.
5. Training through the entry point ``transkun_tpu_torch.cli.train.main``
   at flagship width and depth, ``--batchSize 4``: a synthetic
   MAESTRO-layout corpus of 40 s pieces (MIDI from the port's
   ``data.midi``, pickles from its ``cli.create_dataset_maestro``) in a temp
   dir; one epoch of steps with stats decodes, checkpoints and validation;
   a resume for two more steps; ``best_state_dict`` loaded into
   ``TransKun`` to transcribe a piece.  Every loss must be finite and the
   alpha, beta and Viterbi launch counts must equal the calls made.  This
   and the later paths' trainer runs take the default ``--deviceData
   auto``: the corpus packed on the card (path 9 holds it to the other
   routes).
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

9. The V1 model (``transkun_tpu_torch.models.ablation``, the CNN + BiGRU +
   pairwise scorer of ``AblationConfig()``: mel 229, conv blocks of
   48/64/92/128 channels, a 2-layer BiGRU of 256, 90 tracks) at full width,
   fp32, random weights from a seeded ``torch.Generator`` (the scorer's last
   bias shifted so that 0.1% of one segment's singletons fire):
   ``TransKunAblation.transcribe`` on the piece of 4 (20 s segments every
   10 s, the last two shorter, not padded): one Viterbi launch a segment,
   valid notes, and on every segment length's real scores and learned skip
   score the kernel's table equal to the plain version's bit for bit; then
   ``V1_TRAIN_STEPS`` steps of ``make_train_step`` at ``--batchSize``
   ``V1_TRAIN_BATCH`` on 16 s segments of the corpus of 5: every loss
   finite, one alpha and one beta launch a step, the BatchNorm running
   statistics moved; at the step's shape [691, 691, 180] on its real scores
   and learned noise, the alpha and beta tables against their plain
   versions (1e-5 * max(1, |plain|)), and logZ with its score and noise
   cotangents through the kernels (``log_z_best``) against autograd of
   ``log_z_slow`` (logZ 1e-5 relative, cotangents 1e-4, or the fp32
   rounding of t chained steps at logZ's size where that is larger:
   ``cotangent_tolerance``).  Kernels 1-3 are
   timed at the path's shapes ([864, 864, 128] and [696, 696, 256]).

10. The non-flagship V2 branches (path 7, ``branch_path``), each
   ``2.0.conf`` with the changes of ``BRANCHES``, at full width and depth:
   (a) the aggregation tracks (``enabledAttn`` F, T, All0, 0All) and (b) the
   full attention (FT) transcribe the piece of 4 and train on the corpus of
   5 (``cli.train.main --modelConf``) on the default route and with
   ``TRANSKUN_TPU_FUSED_ATTN=1``, where the 0All and FT keys (the whole
   89 x 149 lattice, 13261 keys) take the streaming variants of the
   attention kernels; (b)'s default route transcribes one segment a group
   and both its routes train at ``--batchSize 1`` (its plain logits are
   5.6 GB a segment and layer; an out-of-memory step on the default route
   is written down, not failed); (c) the pairwise scorer with the full
   upsample stack and ``downsampleF=False`` transcribes the piece, through
   ``transcribe_many`` over 2 copies too, and trains at ``--batchSize 2``.
   Notes equal between the routes of a configuration (pitch, velocity and
   flags, times within 1e-6 s), losses within LOSS_RTOL; launches equal to
   the calls made (the streaming variants' to the calls whose keys are the
   lattice), no call of the plain attention on the fused route; the
   streaming kernels on the path's real activations against an fp64
   evaluation within a first-order bound of their rounding
   (``check_attention_fp64``), and on the same tensors rounded to bf16
   against the plain versions at bf16 (``check_attention``'s bf16 rule).
   Before the paths, the streaming kernels are held against their plain
   versions (``check_attention``'s rules, the library picking the variant
   by itself) at 0All's shapes ([1, 89, 256] and [4, 89, 256] against 13261
   keys) and FT's ([1, 13261, 256]), fp32 and bf16; each shape's plan
   (``ops.attention.stream_plan``: warps, splits of the keys, grids,
   shared memory) is printed, 0All's keys must be split across blocks; two
   forward runs must give the same bits, and so must the backward handed
   the forward's row statistics and the backward that fetches them
   (``check_stream_bits``); each is timed beside the plain versions and
   SDPA (``time_stream``: a lone call; the backward handed the statistics,
   as the path hands them), its fp32 bound the tensor cores' (three TF32
   ``mma`` a product), and beside it the exp floor: one exponential an
   element at 16 an SM a clock at the card's largest SM clock
   (``nvidia-smi``'s clocks.max.sm), and by its device time a call
   (``queued_ms``: 20 calls queued behind a sleeping kernel, so that they
   run back to back whatever the host's enqueue costs).  With ``--parent DIR`` (a checkout whose streaming
   kernels are the first version: no plan in their C interface), that
   checkout's ``attention_fwd.cu`` and ``attention_bwd.cu`` are built
   beside this one's, held to the same bounds at every shape and timed in
   turns (parent, this, this, parent; ``parent_turns``); a checkout with a
   later C interface is said and skipped.

11. Multi-process training and the remaining entry points (path 8,
   ``dist_path``).  (a) Two ranks on the one card over gloo (NCCL takes one
   rank a card, so NCCL across cards is not run here), each a process
   (``dist_rank``) under the launcher's environment: the flagship model from
   the seed rank 0 broadcasts, ``DIST_STEPS`` steps of
   ``make_train_step(..., group=...)`` at ``--batchSize`` ``DIST_BATCH`` a
   rank on path 2's corpus, the optimizer's count starting at
   ``DIST_OPT_COUNT``, past its rectification gate: after each step the
   parameters moved and equal on both ranks bit for bit, one alpha and one
   beta launch a rank, and the step's
   summed gradient before the clip within ``DIST_GRAD_RTOL`` of each
   tensor's largest value of the sum of the two halves' gradients computed
   in one process; then one V1 step (``AblationConfig()``, 16 s segments,
   ``DIST_V1_BATCH`` a rank) whose BatchNorm running statistics equal one
   process's on the concatenated batch (rtol 1e-4, 1e-6 absolute); on
   rank 0, each model's logZ route at the step's own lane count (the
   flagship's ``log_z_padded`` on its padded lanes, V1's ``log_z_best``)
   against autograd of ``log_z_slow`` on that rank's scores
   (``logz_against_slow``: logZ within ``TABLE_RTOL``, the cotangents
   within ``cotangent_tolerance``); each step's wall time and peak memory
   printed.  (b) ``cli.train.main
   --nDevices 2`` must refuse, naming the one card found; ``--nDevices 1``
   takes 2 steps.  (c) ``crf_minimal_example`` on the card: ``logProb``
   within 1e-5 relative of ``eval_path - log_z_slow``, both decodes equal
   to the plain tables' walk.  (d) The piece of 4 through
   ``transcribe_many(devices=[cuda:0, cuda:0])`` over 2 copies: path 1's
   notes.  (e) ``cli.compute_metrics`` on path 1's MIDI against itself:
   note F1 1.0.  (f) ``TRANSKUN_TPU_TIMING=silent``: path 1's
   ``last_transcribe_marks`` printed as phases.  Every launch count must
   equal the calls made.

12. The training input routes (path 9, ``input_path``).  (a)
   ``dequantize_int16`` on the card over all 65536 int16 values: equal to
   ``np.divide(v, 32767, dtype=float32)`` bit for bit (and how many values
   a division by the CPU scalar 32767.0 gets wrong there, printed).  (b)
   Path 2's corpus packed on the card (``DeviceDataset``): for every batch
   of one epoch at ``--batchSize 4``, overhanging chunks included, the
   device slice equal to the host loader's floats bit for bit, and the
   frames of the slice, of the int16 link and of the host floats equal.
   (c) ``INPUT_STEPS`` flagship steps of ``cli.train.main`` at
   ``--batchSize 4`` on each route from one seed: ``--deviceData on``,
   ``--deviceData off --linkInt16 force`` and ``--linkInt16 off``; the
   first step's loss equal bit for bit, alpha and beta launches equal to
   the steps, Viterbi's to two a stats pass; each route's iteration and
   step seconds, peak memory and corpus bytes printed.  (d) A seeded
   one-hour mono corpus packed and uploaded (timed), and ``slice_batch`` of
   a batch of 4 against the packed rows and timed.  (e) Two gloo ranks on
   the card (``input_rank``), each with its own packed corpus: one step of
   ``cli.train.main --deviceData on`` at ``INPUT_RANK_BATCH`` a rank, then
   one on the host route: the step's frames and loss equal bit for bit, the
   parameters after it equal on both ranks and on both routes.

13. The JAX package's orbax checkpoint into the port (path 10,
   ``orbax_path``).  With no orbax, tensorstore, zstandard or JAX module
   loaded, ``load_orbax_checkpoint`` reads the committed fixture
   ``tests/golden/orbax_v2_narrow`` (a narrow V2 written by JAX
   ``save_checkpoint``) through the port's zstd decoder, OCDBT reader and
   zarr assembly, and every leaf its ``.npz`` holds must be equal bit for
   bit; then ``cli.transcribe.main --weight DIR --conf ...`` transcribes a
   seeded 30 s piece on the card, whose MIDI notes must equal those of
   ``TransKun.transcribe`` on the card with ``state_dict_from_flax`` of the
   ``.npz``'s best params, with the same launches (Viterbi and walk).  The
   read time (the card's host), the notes and the launches are printed.
   (c) The JAX run continued on the card (``orbax_resume``): the fixture is
   a train state at step 1000 (seeded moments, a clip ring of 1000 pushes,
   the ``extra`` of a save before validation).  A copy of it and a seeded
   corpus at its conf's ``fs``: ``cli.train.main`` on ``cuda`` resumes the
   copy to step 1002 with a stats pass a step.  Before the first step every
   restored leaf on the card equals the ``.npz`` bit for bit; the resume
   lines are printed, the losses finite, the ``.pt`` beside the directory at
   step 1002 with both counts +2 and ``extra`` carried over, and every file
   of the copy keeps its hash; a second run resumes from the ``.pt`` for one
   step, and ``cli.transcribe --weight <copy>.pt`` writes (b)'s notes for
   (b)'s piece.  The read and restore times (the card's host) and the
   steps' times are printed.  Cut: the narrow width (no JAX or orbax on the card's
   machine to write a flagship checkpoint; the flagship's restore is held
   bit for bit on the CPU, ``tests/test_torch_resume.py``).

Prints the card, build times, kernel times, each transcription's wall time,
RTF and peak memory, each training step time and peak memory, the V1 path's,
path 7's, path 8's, path 9's and path 10's figures as JSON lines, then one JSON
line with the kernels (launches on each path, largest error, kernel,
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
import types

import numpy as np

NEG = -1e30
SEED = 0
PIECE_SECONDS = 64.0
LONG_PIECE_TILES = 9  # the long piece is the 64 s piece this many times over: 9.6 minutes
PEAK_RTOL = 0.10  # the long piece's peak memory against the short one's
KERNELS = ("viterbi_bwd", "semicrf_alpha", "semicrf_beta",
           "attention_fwd", "attention_bwd", "fused_mlp", "softmax_fwd", "softmax_bwd",
           "decode_walk", "attention_fwd_stream", "attention_bwd_stream")
# the sources to build: softmax_rows.cu holds both softmax kernels, the
# attention sources their streaming variants
SOURCES = KERNELS[:6] + ("softmax_rows", "decode_walk")
WALK_SMALL_K = 2  # a per-track event capacity that the real tables overflow
WALK_GLOBAL_K = 16384  # past the walk kernel's shared-memory buffer: events to global memory
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
# the streaming kernels on path 7's real activations, whose logits reach far
# beyond unit-normal inputs', are held against an fp64 evaluation within a
# first-order bound of their rounding (``attention_fp64``): every product
# from TF32 operands split high/low has a relative error of at most
# SPLIT_U (three `mma`, the a_lo*b_lo term dropped and each low part cut to
# 11 bits: 3 x 2**-22, rounded up), plus REAL_PLAIN_FACTOR times the plain
# fp32 version's own distance from fp64 for the fp32 sums, which both run
# over 13261 keys in other orders
SPLIT_U = 2.0 ** -20
REAL_PLAIN_FACTOR = 4
# ... and each output's largest distance from fp64 within REAL_PLAIN_RATIO
# times the plain fp32 version's (or, were that below it, the fp32 rounding
# of the output's largest value), because the first-order bound is loose for
# dq and dk (up to 10% of |dk| on FT's training activations).  Readings on
# the four real-activation checks of path 7 (H100): kernel / plain at most
# 0.26 (o), 0.25 (dq), 0.47 (dk) and 1.89 (dv, 0All's training step); the
# first build's drifting accumulator read 16 (o)
REAL_PLAIN_RATIO = 4
TRAIN_BATCH = 4
# the flagship shapes of one 16 s segment: F- and T-attention [B, S, D] with
# ATTN_HEADS heads, and the FFN's [tokens, D] -> MLP_HIDDEN -> D
ATTN_SHAPES, ATTN_HEADS = ((89, 149, 256), (149, 89, 256)), 8
MLP_SHAPE, MLP_HIDDEN = (13261, 256), 1024
# cross-attention, odd lengths, 3 heads of 8: (q shape, Skv, heads); and a shape
# with more keys than a thread's registers hold and a head_dim (80) past the
# other variants' 64, which only the general kernels take
RAGGED_ATTN = ((5, 37, 24), 61, 3)
LONG_ATTN = ((2, 100, 160), 180, 2)
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
SFU_EXPS_A_CLOCK = 16  # exponentials an SM a clock (CUDA Programming Guide, compute capability 9.0)
QUEUE_SLEEP_MS = 50  # queued_ms: the card sleeps this long while the host enqueues the calls
TRAIN_PIECES, VAL_PIECES, CORPUS_PIECE_SECONDS = 3, 1, 40.0
# the V1 path: 3 steps at --batchSize 2 on 16 s segments cut every 12 s from
# the first two training pieces; decode singletons on 0.1% of one segment's
# (frame, pitch) entries
V1_TRAIN_BATCH, V1_TRAIN_STEPS, V1_SEGMENT_SECONDS, V1_SEGMENT_HOP = 2, 3, 16.0, 12.0
V1_SINGLETON_QUANTILE = 0.999
V1_STEP_SECONDS, V1_SEGMENT_SECONDS_DECODE = 10.0, 20.0  # TransKunAblation.transcribe's defaults
# path 8: two gloo ranks on the one card, --batchSize 2 a rank (a global batch
# of 4, path 2's) for DIST_STEPS flagship steps, then one V1 step at 1 a rank
# (a global batch of 2, path 6's) on 16 s segments
DIST_BATCH, DIST_STEPS, DIST_V1_BATCH = 2, 2, 1
# the optimizer's count at the start of path 8's steps: past the rectification
# gate, which holds the parameters still for the first steps (a resumed run)
DIST_OPT_COUNT = 10
DIST_GRAD_RTOL = 1e-3  # tests/test_torch_train.py's gradient bound: of each tensor's largest value
DIST_STATS_RTOL, DIST_STATS_ATOL = 1e-4, 1e-6  # the JAX package's SyncBN test's bounds
# path 9: steps of cli.train.main on each training input route (path 2's
# batch), the batch a rank of its two gloo ranks, and the one-hour corpus's
# pieces (ten minutes each)
INPUT_STEPS, INPUT_RANK_BATCH, HOUR_PIECES = 3, 2, 6
# path 10: the JAX package's orbax checkpoint committed as a test fixture (a
# narrow V2, tests/golden/orbax_v2_narrow), and the seconds of the piece its
# best weights transcribe through cli.transcribe --weight DIR
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "orbax_v2_narrow")
ORBAX_PIECE_SECONDS = 30.0
# path 10's files in the run's directory: the piece, (b)'s CLI and reference MIDI, (c)'s MIDI
ORBAX_FILES = ("orbax_piece.wav", "orbax_cli.mid", "orbax_ref.mid", "orbax_resumed.mid")
# path 10 (c): the steps the trainer takes past the fixture's step, and the
# batch (the fixture conf's 16 s chunks)
ORBAX_RESUME_STEPS, ORBAX_RESUME_BATCH = 2, 4
FOREIGN_PACKAGES = ("jax", "jaxlib", "flax", "transkun_tpu", "orbax", "tensorstore", "zstandard")
# path 7: the non-flagship V2 branches, each the flagship conf with these changes
BRANCHES = {
    "aggregation": {"enabledAttn": ["F", "T", "All0", "0All"]},
    "full": {"enabledAttn": ["FT"]},
    "pairwise": {"useInnerProductScorer": False, "upsampleProjOnly": False,
                 "scoringExpansionFactor": 1, "downsampleF": False},
}
# training: steps and --batchSize of each configuration on each route
BRANCH_TRAIN = {"aggregation": (2, TRAIN_BATCH), "full": (1, 1), "pairwise": (2, 2)}
# the streaming kernels' shapes on path 7 ([B, Sq, D] and Skv, ATTN_HEADS
# heads): "0All", track 0 over the whole 89 x 149 lattice of a segment, in
# transcription (one segment at a time) and at --batchSize 4; "FT", the
# lattice against itself, one segment (transcription and --batchSize 1)
LATTICE = 89 * 149
STREAM_SHAPES = {"0All": ((1, 89, 256), LATTICE), "0All, batch 4": ((TRAIN_BATCH, 89, 256), LATTICE),
                 "FT": ((1, LATTICE, 256), LATTICE)}
PAIRWISE_SINGLETON_QUANTILE = 0.999


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


def max_sm_clock_mhz() -> float:
    """The card's largest SM clock in MHz (``nvidia-smi``'s clocks.max.sm)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])


def exp_floor_ms(exps, n_sm, mhz):
    """The least milliseconds ``exps`` exponentials take on ``n_sm`` SMs at
    ``mhz``: SFU_EXPS_A_CLOCK an SM a clock."""
    return exps / (n_sm * SFU_EXPS_A_CLOCK * mhz * 1e6) * 1e3


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


def cotangent_tolerance(log_z, t):
    """Bound on |exact-marginal cotangent - autograd of log_z_slow| over t
    positions: ``check_logz_grad``'s 1e-4, or 2 * 2**-24 * sqrt(t) *
    max |logZ| where that is larger.  The marginal exp(v[b] + q[e] + S -
    logZ) adds table entries of logZ's size, and each entry carries the
    fp32 roundings of its chain of up to t steps, which add as a random
    walk: on the V1 model's scores the plain tables' route on the CPU is
    2.4e-4 from an fp64 scan at t = 251 (logZ 387), the kernels' 1.6e-3
    from log_z_slow at t = 691 (logZ 1048) on an H100."""
    return max(1e-4, 2 * 2**-24 * math.sqrt(t) * float(log_z.abs().max()))


def logz_against_slow(semicrf, through_kernels, s, noise):
    """logZ and its score and noise cotangents through the kernels
    (``through_kernels(s, noise)`` -> logZ [N], on leaves ``s [T, T, N]``
    and ``noise [T-1, N]``) against autograd of the plain ``log_z_slow``,
    each lane's logZ weighted alike on both sides.  Returns (logZ's largest
    difference relative to max(1, |logZ|), the cotangents' largest absolute
    difference, its bound ``cotangent_tolerance``, the largest |logZ|, the
    largest noise cotangent)."""
    import torch

    t, _, nb = s.shape
    w = torch.linspace(0.5, 1.5, nb, device=s.device)
    grads = []
    for fn in (through_kernels, semicrf.log_z_slow):
        s_g, n_g = s.detach().clone().requires_grad_(), noise.detach().clone().requires_grad_()
        lz = fn(s_g, n_g)
        (lz * w).sum().backward()
        grads.append((lz.detach(), s_g.grad, n_g.grad))
    (lz, gs, gn), (lz_ref, gs_ref, gn_ref) = grads
    lz_err = float(((lz - lz_ref).abs() / lz_ref.abs().clamp(min=1.0)).max())
    g_err = max(float((gs - gs_ref).abs().max()), float((gn - gn_ref).abs().max()))
    return (lz_err, g_err, cotangent_tolerance(lz_ref, t), float(lz_ref.abs().max()),
            float(gn_ref.abs().max()))


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


def attention_fp64(q, k, v, do, heads, scale, rows=1024):
    """(o, dq, dk, dv) of softmax((q k^T) * scale) v per head, evaluated in
    fp64 over chunks of ``rows`` query rows (dk and dv summed over the
    chunks), flat [B, S, D]; and for each the first-order bound, by element,
    on the distance of a computation whose every product has a relative
    error of SPLIT_U.  With a_i = scale * sum_d |q_id| max_j |k_jd| (a bound
    on row i's logits' magnitude, so on their error over SPLIT_U) and
    b_i = sum_d |do_id| max_j |v_jd| (the same for dp): p_ij is off by
    2 a_i SPLIT_U relative, so o_i by SPLIT_U (2 a_i + 1) max|v|, dl_ij by
    SPLIT_U p_ij b_i (4 a_i + 2), dq_i by SPLIT_U scale max|k| b_i
    (4 a_i + 3), dk_j by SPLIT_U scale max|q| sum_i p_ij b_i (4 a_i + 3) and
    dv_j by SPLIT_U max|do| sum_i p_ij (2 a_i + 1), max over the head."""
    import torch

    b, sq, d = q.shape
    dh = d // heads

    def split(x):
        return x.double().reshape(b, x.shape[1], heads, dh).transpose(1, 2)

    def top(x, dim):  # max |x| over ``dim``, kept
        return x.abs().amax(dim=dim, keepdim=True)

    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    out = [torch.empty_like(qh), torch.empty_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)]
    bounds = [torch.empty_like(qh[..., :1]), torch.empty_like(qh[..., :1]),
              torch.zeros_like(kh[..., :1]), torch.zeros_like(vh[..., :1])]
    k_col, v_col = top(kh, 2), top(vh, 2)  # [B, H, 1, dh]
    for r in range(0, sq, rows):
        qc, doc = qh[:, :, r: r + rows], doh[:, :, r: r + rows]
        p = torch.softmax(torch.matmul(qc, kh.transpose(-1, -2)) * scale, dim=-1)
        oc = torch.matmul(p, vh)
        dl = p * (torch.matmul(doc, vh.transpose(-1, -2)) - (doc * oc).sum(-1, keepdim=True))
        out[0][:, :, r: r + rows] = oc
        out[1][:, :, r: r + rows] = torch.matmul(dl, kh) * scale
        out[2] += torch.matmul(dl.transpose(-1, -2), qc) * scale
        out[3] += torch.matmul(p.transpose(-1, -2), doc)
        a = scale * (qc.abs() * k_col).sum(-1, keepdim=True)  # [B, H, rows, 1]
        bb = (doc.abs() * v_col).sum(-1, keepdim=True)
        bounds[0][:, :, r: r + rows] = (2 * a + 1) * top(vh, (2, 3))
        bounds[1][:, :, r: r + rows] = scale * top(kh, (2, 3)) * bb * (4 * a + 3)
        bounds[2] += scale * top(qh, (2, 3)) * torch.matmul(p.transpose(-1, -2), bb * (4 * a + 3))
        bounds[3] += top(doh, (2, 3)) * torch.matmul(p.transpose(-1, -2), 2 * a + 1)
        del p, dl
    flat = [x.transpose(1, 2).reshape(b, -1, d) for x in out]
    bound = [(SPLIT_U * x).expand(*x.shape[:-1], dh).transpose(1, 2).reshape(b, -1, d) for x in bounds]
    return flat, bound


def check_attention_fp64(attention, q, k, v, do, heads):
    """The streaming kernels against ``attention_fp64`` on fp32 inputs that
    the library runs as "stream", beside the plain versions: each output's
    distance from the fp64 result within its first-order rounding bound, by
    element, plus REAL_PLAIN_FACTOR times the plain version's largest
    distance, and its largest distance within REAL_PLAIN_RATIO times the
    plain version's; the backward twice the same bits.  Returns rows of (name, the
    kernel's largest distance, the plain version's, the largest bound, the
    largest |value|)."""
    import torch

    dh = q.shape[-1] // heads
    scale = 1.0 / math.sqrt(dh)
    picked = {attention.kernel_variant(name, q.shape[1], k.shape[1], dh)
              for name in ("attention_fwd", "attention_bwd")}
    if picked != {"stream"}:
        raise AssertionError(f"q {tuple(q.shape)}, k {tuple(k.shape)} runs as {picked}, not as stream")
    o = attention.attention_fwd_cuda(q, k, v, heads, scale)
    got = [o, *attention.attention_bwd_cuda(q, k, v, o, do, heads, scale)]
    again = attention.attention_bwd_cuda(q, k, v, o, do, heads, scale)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got[1:], again)):
        raise AssertionError(f"streaming backward: two runs differ at q {tuple(q.shape)}")
    del again
    want = attention.attention_plain(q, k, v, heads, scale)
    plain = [want, *attention.attention_bwd_plain(q, k, v, want, do, heads, scale)]
    ref, bound = attention_fp64(q, k, v, do, heads, scale)
    rows, bad = [], []
    for name, g, p, r, bnd in zip(("o", "dq", "dk", "dv"), got, plain, ref, bound):
        e_p = float((p.double() - r).abs().max())
        dist = (g.double() - r).abs()
        over = float((dist - bnd).max())
        top = float(r.abs().max())
        rows.append((name, float(dist.max()), e_p, float(bnd.max()), top))
        if not bool(torch.isfinite(g).all()) or over > REAL_PLAIN_FACTOR * e_p \
                or float(dist.max()) > REAL_PLAIN_RATIO * max(e_p, 2.0 ** -24 * top):
            bad.append(f"{name}: {float(dist.max())} from fp64 (plain {e_p}), {over} past its bound")
    if bad:
        raise AssertionError(f"streaming kernels at q {tuple(q.shape)}, k {tuple(k.shape)}: {bad}; rows {rows}")
    return rows


def check_stream_bits(attention, q, k, v, do, heads):
    """The streaming kernels give the same bits run after run: two forward
    runs (o and the row statistics), and the backward with the forward's
    statistics handed to it and without them (fetched by a forward launch).
    Returns the statistics."""
    import torch

    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    o, stats = attention.attention_fwd_cuda(q, k, v, heads, scale, with_stats=True)
    o2, stats2 = attention.attention_fwd_cuda(q, k, v, heads, scale, with_stats=True)
    handed = attention.attention_bwd_cuda(q, k, v, o, do, heads, scale, stats=stats)
    fetched = attention.attention_bwd_cuda(q, k, v, o, do, heads, scale)
    torch.cuda.synchronize()
    where = f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}"
    if stats is None or not (torch.equal(o, o2) and torch.equal(stats, stats2)):
        raise AssertionError(f"streaming forward: two runs differ (or gave no statistics) at {where}")
    if not all(torch.equal(a, b) for a, b in zip(handed, fetched)):
        raise AssertionError(f"streaming backward: handed and fetched statistics differ at {where}")
    return stats


def time_stream(attention, q, k, v, do, heads, n_sm, mhz, runs=3):
    """The streaming kernels on these inputs, the backward handed the
    forward's statistics as the path hands them.  For "fwd" and "bwd":
    (kernel ms, plain ms, SDPA ms, bound, the CUDA cores' fp32 bound ms, the
    exp floor ms, the kernel's device ms): kernel, plain and SDPA ms a lone
    call's (CUDA events, the wrapper's host work included), device ms a
    call's launches alone (``queued_ms``).  Bound at fp32: the products
    fp32-grade on the tensor cores (three TF32 `mma` a product, the fused
    MLP's bound), below the CUDA cores' one; at bf16 2 bytes a value
    against the operations at the bf16 rate.  Exp floor: one exponential an element of the [Sq, Skv]
    softmax of each head (what the function needs, forward and backward:
    the backward kernels evaluate two) at SFU_EXPS_A_CLOCK an SM a clock
    at ``mhz``.  A kernel time under the larger of the bound and the floor
    fails: the floor held at every shape on an H100, so a time below it is a
    wrong count or a kernel that skipped work."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, sq, d = q.shape
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)
    o, stats = attention.attention_fwd_cuda(q, k, v, heads, scale, with_stats=True)
    qh, kh, vh = (t.view(b, -1, heads, dh).transpose(1, 2).requires_grad_() for t in (q, k, v))
    o_lib = sdpa(qh, kh, vh, scale=scale)
    do_h = do.view(b, sq, heads, dh).transpose(1, 2)
    products = 2 * b * heads * sq * k.shape[1] * dh
    floor = exp_floor_ms(b * heads * sq * k.shape[1], n_sm, mhz)
    fp32 = q.dtype == torch.float32
    peak = TF32_FLOPS / 3 if fp32 else BF16_FLOPS
    fwd_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    bwd_bytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
    def fwd():
        return attention.attention_fwd_cuda(q, k, v, heads, scale)

    def bwd():
        return attention.attention_bwd_cuda(q, k, v, o, do, heads, scale, stats=stats)

    timed = {
        "fwd": (cuda_ms(fwd, runs=runs),
                cuda_ms(lambda: attention.attention_plain(q, k, v, heads, scale), runs=runs),
                cuda_ms(lambda: sdpa(qh.detach(), kh.detach(), vh.detach(), scale=scale), runs=runs),
                bound(fwd_bytes, 2 * products, peak), bound(fwd_bytes, 2 * products)[0], floor,
                queued_ms(fwd, mhz)),
        "bwd": (cuda_ms(bwd, runs=runs),
                cuda_ms(lambda: attention.attention_bwd_plain(q, k, v, o, do, heads, scale), runs=runs),
                cuda_ms(lambda: torch.autograd.grad(o_lib, (qh, kh, vh), do_h, retain_graph=True),
                        runs=runs),
                bound(bwd_bytes, 5 * products, peak), bound(bwd_bytes, 5 * products)[0], floor,
                queued_ms(bwd, mhz)),
    }
    for side, (k_ms, _, _, bnd, _, _, _) in timed.items():
        if max(bnd[0], floor) > k_ms:
            raise AssertionError(f"streaming attention {side} at {tuple(q.shape)} x {k.shape[1]} keys "
                                 f"{q.dtype}: {k_ms} ms is under its bound of {bnd[0]} ms or its exp "
                                 f"floor of {floor} ms")
    return timed


def queued_ms(fn, mhz, calls=DEVICE_LAUNCHES, runs=3):
    """Device milliseconds a call of ``fn`` without the host's work: each run
    enqueues ``calls`` calls behind a kernel that sleeps QUEUE_SLEEP_MS
    (``torch.cuda._sleep``), so that they run back to back on the card, and
    takes the time between two CUDA events around them; the median of
    ``runs``.  Fails if the host took longer to enqueue them than the sleep
    lasts.  (No profiler session: path 1 checks the walk with one, and on
    this card a run's later profiler sessions saw no device time once
    several had run.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(QUEUE_SLEEP_MS * mhz * 1e3))
        t0 = time.perf_counter()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms >= QUEUE_SLEEP_MS:
            raise AssertionError(f"the host took {enqueue_ms} ms to enqueue {calls} calls, past the "
                                 f"{QUEUE_SLEEP_MS} ms sleep ahead of them")
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def parent_attention(root, tmp, dev):
    """The first streaming attention kernels (one block a 64-row tile, fp32
    tiles loaded synchronously, the backward sweeping the keys twice for
    its statistics; their C interface takes no plan and the backward a
    [3, B*H, Sq] scratch), from another checkout ``root``'s
    ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``, built into
    ``tmp``, one ``nvcc`` each at once.  Returns a forward (q, k, v, heads,
    scale) -> o and a backward (q, k, v, o, do, heads, scale) -> (dq, dk,
    dv) that launch that checkout's streaming variant; None, said, for a
    later version, whose C interface takes a plan."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from transkun_tpu_torch.ops import _build

    def built(name):
        path = os.path.join(tmp, f"lib{name}_parent.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", path,
                               os.path.join(root, "transkun_tpu_torch", "csrc", name + ".cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{proc.stdout}{proc.stderr}")
        return ctypes.CDLL(path)

    with ThreadPoolExecutor(max_workers=2) as pool:
        fwd_lib, bwd_lib = pool.map(built, ("attention_fwd", "attention_bwd"))
    if hasattr(fwd_lib, "attention_fwd_stream_smem_bytes"):
        print(f"--parent: {root}'s streaming attention kernels take a plan: not the first version, "
              f"not compared")
        return None
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib, name, n in ((fwd_lib, "attention_fwd", 4), (bwd_lib, "attention_bwd", 9)):
        for suffix in ("", "_bf16"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = [ptr] * n + [i32] * 5 + [ctypes.c_float, i32, i32, ptr, ctypes.POINTER(i32)]
            fn.restype = i32

    def call(lib, name, tensors, q, k, heads, scale):
        b, sq, d = q.shape
        ran = i32(-1)
        err = getattr(lib, name + ("" if q.dtype == torch.float32 else "_bf16"))(
            *[t.data_ptr() for t in tensors], b, sq, k.shape[1], heads, d // heads, float(scale), 2,
            dev.index, torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(ran))
        if err or ran.value != 2:
            raise RuntimeError(f"the parent's {name} launch failed ({err}) or ran variant {ran.value}")

    def fwd(q, k, v, heads, scale):
        o = torch.empty_like(q)
        call(fwd_lib, "attention_fwd", (q, k, v, o), q, k, heads, scale)
        return o

    def bwd(q, k, v, o, do, heads, scale):
        grads = [torch.empty_like(a) for a in (q, k, v)]
        stats = torch.empty(3 * q.shape[0] * heads * q.shape[1], dtype=torch.float32, device=dev)
        call(bwd_lib, "attention_bwd", (q, k, v, o, do, *grads, stats), q, k, heads, scale)
        return tuple(grads)

    return fwd, bwd


def parent_turns(attention, parent_fwd, parent_bwd, q, k, v, do, heads):
    """Another checkout's streaming kernels (``parent_attention``) held to
    ``check_attention``'s bounds against the plain versions, then timed
    with this checkout's in turns: parent, this, this, parent (this
    backward handed the forward's statistics, as the path hands them).
    Returns, for "fwd" and "bwd", {"parent": [ms, ms], "this": [ms, ms]}."""
    import torch

    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    o = parent_fwd(q, k, v, heads, scale)
    grads = parent_bwd(q, k, v, o, do, heads, scale)
    want = attention.attention_plain(q, k, v, heads, scale)
    want_grads = attention.attention_bwd_plain(q, k, v, want, do, heads, scale)
    torch.cuda.synchronize()
    for name, got, ref, atol in [("o", o, want, FWD_ATOL)] + [
            (n, g, w, BWD_ATOL) for n, g, w in zip(("dq", "dk", "dv"), grads, want_grads)]:
        e = float((got.float() - ref.float()).abs().max())
        allowed = atol if q.dtype == torch.float32 else bf16_spacing_at_max(ref)
        if not bool(torch.isfinite(got).all()) or not e <= allowed:
            raise AssertionError(f"the parent's streaming kernels != plain at q {tuple(q.shape)}, k "
                                 f"{tuple(k.shape)}, {q.dtype}: {name} max |diff| {e}, allowed {allowed}")
    del o, grads, want, want_grads
    o, stats = attention.attention_fwd_cuda(q, k, v, heads, scale, with_stats=True)
    calls = {"fwd": {"parent": lambda: parent_fwd(q, k, v, heads, scale),
                     "this": lambda: attention.attention_fwd_cuda(q, k, v, heads, scale)},
             "bwd": {"parent": lambda: parent_bwd(q, k, v, o, do, heads, scale),
                     "this": lambda: attention.attention_bwd_cuda(q, k, v, o, do, heads, scale,
                                                                  stats=stats)}}
    turns = {side: {"parent": [], "this": []} for side in calls}
    for who in ("parent", "this", "this", "parent"):
        for side in calls:
            turns[side][who].append(round(cuda_ms(calls[side][who], runs=3), 4))
    return turns


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


def walk_visits(ptr, diag, start):
    """Positions the pointer walk visits on each track of one segment (one
    load of ptr and diag each): ptr [t-1, P], diag [t, P], start [P]."""
    t = diag.shape[0]
    visits = np.zeros(ptr.shape[1], np.int64)
    for b in range(ptr.shape[1]):
        j = int(start[b])
        while j < t - 1:
            visits[b] += 1
            sel = int(ptr[j, b])
            j = j + 1 if sel < 0 else j + 1 + sel
        visits[b] += j == t - 1  # the last position's singleton bit
    return visits


def profiled_ms(fn, calls=DEVICE_LAUNCHES, sessions=3):
    """Device milliseconds a call of ``fn``: every operation it ran on the
    card (kernels and memsets) under ``torch.profiler`` over ``calls``
    calls, summed and divided by ``calls``.  Unlike CUDA events around calls
    made back to back, this leaves out the host's enqueue where it is the
    slower.  On this card a run's later profiler sessions have at times seen
    no device time at all: then up to ``sessions`` sessions are tried, and
    None is returned if none saw any, for the caller to time with CUDA
    events instead or to report the figure as not measured."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / calls
    print(f"the profiler saw no device time in {sessions} sessions", file=sys.stderr)
    return None


def walk_on_sentinel(walk, ptr, diag, bpres, start, k_max, *geometry):
    """``walk.walk_group`` (the dispatcher, which takes CUDA tensors to the
    kernel) with begins and ends on memory that held -7 in every slot: the
    caching allocator hands the outputs the blocks of two freed tensors of
    their size, so a slot the kernel does not write shows."""
    import torch

    n, _, p = diag.shape
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sentinel = [torch.full((n, p, k_max), -7, dtype=torch.int32, device=ptr.device) for _ in range(2)]
    where = {a.data_ptr() for a in sentinel}
    del sentinel
    got = walk.walk_group(ptr, diag, bpres, start, k_max, *geometry)
    if {got[0].data_ptr(), got[1].data_ptr()} != where:
        raise AssertionError("the walk's outputs did not land on the sentinel's memory")
    return got


def same_notes(got, want):
    """(equal, largest time difference): pitch, velocity and flags equal
    and times within 1e-6 s, pitch by pitch in time order (the two routes'
    heads run on batches of other shapes, so their refined times may differ
    in the last bits)."""
    if len(got) != len(want):
        return False, float("inf")
    key = lambda n: (n.pitch, n.start)
    worst = 0.0
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        if (a.pitch, a.velocity, a.hasOnset, a.hasOffset) != (b.pitch, b.velocity, b.hasOnset, b.hasOffset):
            return False, float("inf")
        worst = max(worst, abs(a.start - b.start), abs(a.end - b.end))
    return worst <= 1e-6, worst


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


def v1_model(dev, audio):
    """The V1 model at full width (``AblationConfig()``) with random weights
    from ``SEED``, and the shift of its scorer's last bias: random weights
    fire singletons everywhere, so the bias is lowered until 0.1% of the
    diagonal entries of one segment of ``audio`` (the fourth) are positive.
    Returns (model, shift)."""
    import torch

    from transkun_tpu_torch.models.ablation import AblationConfig, TransKunAblation
    from transkun_tpu_torch.ops import frontend

    conf = AblationConfig()
    model = TransKunAblation(conf, device=dev, seed=SEED)
    pad = math.ceil((V1_SEGMENT_SECONDS_DECODE - V1_STEP_SECONDS) * conf.fs)
    step = math.ceil(V1_STEP_SECONDS * conf.fs / conf.hopSize) * conf.hopSize
    x = np.pad(audio.T, ((0, 0), (pad, pad)))[:, 3 * step : 3 * step + math.ceil(V1_SEGMENT_SECONDS_DECODE * conf.fs)]
    with torch.no_grad():
        frames = frontend.make_frame(torch.from_numpy(np.ascontiguousarray(x)).to(dev), conf.hopSize,
                                     conf.windowSize)[None]
        s = model.module.process_frames(frames)[0]
        shift = float(torch.quantile(torch.diagonal(s).flatten(), V1_SINGLETON_QUANTILE))
        model.module.pairwiseScore.post.map[3].bias -= shift
    return model, shift


def v1_path(dev, card, audio, corpus, pickles, counts, reset_counts):
    """Path 6, the V1 model at full width (``AblationConfig()``), fp32,
    random weights from a seeded ``torch.Generator``: the 64 s piece
    transcribed, then ``V1_TRAIN_STEPS`` steps of ``make_train_step``.
    Returns (launches of each kernel on the path, the largest difference of
    each kernel from its plain version at the path's shapes, the kernels'
    times at those shapes, the path's figures)."""
    import torch

    from transkun_tpu_torch.data import dataset as D
    from transkun_tpu_torch.data.note import validate_notes
    from transkun_tpu_torch.ops import frontend, logz, semicrf, viterbi
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, make_train_step

    model, shift = v1_model(dev, audio)
    conf = model.conf
    step_in, seg_in = V1_STEP_SECONDS, V1_SEGMENT_SECONDS_DECODE
    pad = math.ceil((seg_in - step_in) * conf.fs)
    step = math.ceil(step_in * conf.fs / conf.hopSize) * conf.hopSize
    padded = torch.from_numpy(np.pad(audio.T, ((0, 0), (pad, pad)))).to(dev)
    starts = list(range(0, padded.shape[-1], step))
    seg_len = sorted({min(i + math.ceil(seg_in * conf.fs), padded.shape[-1]) - i for i in starts}, reverse=True)

    def scores(segment):
        with torch.no_grad():
            frames = frontend.make_frame(segment, conf.hopSize, conf.windowSize)[None]
            s, s_skip, _ = model.module.process_frames(frames)
        return s, s_skip

    err = {"viterbi_bwd": 0, "semicrf_alpha": 0.0, "semicrf_beta": 0.0}
    times, figures = {}, {"v1_bias_shift": -shift}

    # (a) transcription: a warm-up, then the timed run
    model.transcribe(audio)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with CallCounter(semicrf, "viterbi_backward_tables_padded") as vit_calls:
        t0 = time.perf_counter()
        notes = model.transcribe(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = counts()
    want = {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": len(starts)}
    if launches != want or vit_calls.calls != len(starts):
        raise AssertionError(f"V1 transcription launches {launches}, calls {vit_calls.calls}, "
                             f"for {len(starts)} segments")
    if not notes:
        raise AssertionError("V1: no notes decoded")
    validate_notes(notes)
    seconds = audio.shape[0] / conf.fs
    times_of_notes = np.array([[n.start, n.end] for n in notes])
    if not (np.isfinite(times_of_notes).all() and times_of_notes.min() >= 0
            and times_of_notes.max() <= seconds + seg_in):
        raise AssertionError(f"V1 note times out of range: {times_of_notes.min()} .. {times_of_notes.max()}")
    print(f"V1 transcribe {seconds:.0f} s, {len(starts)} segments of {seg_in:.0f} s every {step_in:.0f} s, "
          f"the last {[round(n / conf.fs, 2) for n in seg_len[1:]]} s ({card}): wall {wall:.3f} s, RTF "
          f"{seconds / wall:.1f}x, peak memory {peak_gb:.2f} GB, {len(notes)} notes, launches {launches}")
    figures.update(v1_transcribe_wall_s=wall, v1_rtf=seconds / wall, v1_transcribe_peak_gb=peak_gb,
                   v1_notes=len(notes), v1_segments=len(starts))

    # every segment length of the piece: on its real scores and learned skip
    # score, the kernel's table equals the plain version's bit for bit
    checked = set()
    for n in seg_len:
        i = next(i for i in starts if min(i + math.ceil(seg_in * conf.fs), padded.shape[-1]) - i == n)
        s_t, noise, gate = semicrf.decode_layout(*scores(padded[:, i : i + n]))
        err["viterbi_bwd"] = max(err["viterbi_bwd"], check_kernel(viterbi, s_t, noise, gate))
        checked.add(tuple(s_t.shape))
        if n == seg_len[0]:
            k_ms, dev_ms, p_ms = (cuda_ms(lambda: viterbi.viterbi_backward_tables_cuda(s_t, noise, gate)),
                                  cuda_ms(lambda: viterbi.viterbi_backward_tables_cuda(s_t, noise, gate),
                                          launches=DEVICE_LAUNCHES),
                                  cuda_ms(lambda: viterbi.viterbi_backward_tables_plain(s_t, noise, gate), runs=3))
            bnd = table_bound(s_t.shape[0], s_t.shape[2], 2)
            times["viterbi_bwd"] = {"shape": list(s_t.shape), "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
                                    "bound_ms": bnd[0], "bound_by": bnd[1]}
            plan = viterbi.card_plan(s_t)
            print(f"V1 viterbi {list(s_t.shape)} real scores ({card}): lone launch {k_ms:.4f} ms, device "
                  f"{dev_ms:.4f} ms over {DEVICE_LAUNCHES} launches, plain {p_ms:.3f} ms, bound {bnd[0]:.4f} ms "
                  f"({bnd[1]}), share {bnd[0] / dev_ms:.1%} on device time; plan: clusters of {plan.cluster}, "
                  f"{plan.ctas} CTAs")
        del s_t, noise, gate
    if checked != vit_calls.shapes:
        raise AssertionError(f"V1 decode shapes {vit_calls.shapes}, checked {checked}")
    print(f"V1 viterbi: kernel ptr == plain ptr bit for bit, two runs the same bits, on each segment "
          f"length's real scores and learned skip score {sorted(checked, reverse=True)}")

    # (b) training: 16 s segments of the corpus's first two pieces
    dataset = D.DatasetMaestro(corpus, os.path.join(pickles, "train.pickle"))
    batches = []
    for k in range(V1_TRAIN_STEPS):
        begin = k * V1_SEGMENT_HOP
        got = [dataset.fetch_data(idx, begin, begin + V1_SEGMENT_SECONDS, True, False)
               for idx in range(V1_TRAIN_BATCH)]
        batches.append((np.stack([a for _, a, _ in got]), [nt for nt, _, _ in got]))
    optimizer = AdaBelief(model.module.named_parameters())
    state = TrainState(model, optimizer)
    step_fn = make_train_step(model)
    stats_before = {k: v.clone() for k, v in model.module.state_dict().items() if "running" in k}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, step_s = [], []
    for k, (x, nts) in enumerate(batches):
        frames, labels = model.frames(x), model.labels(nts)
        t0 = time.perf_counter()
        metrics = step_fn(state, frames, labels, torch.Generator(device=dev).manual_seed(SEED + k))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if not bool(metrics["finite"]):
            raise AssertionError(f"V1 step {k}: not finite {metrics}")
    train_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    train_launches = counts()
    want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": V1_TRAIN_STEPS, "semicrf_beta": V1_TRAIN_STEPS}
    if train_launches != want or not np.isfinite(losses).all():
        raise AssertionError(f"V1 training launches {train_launches}, calls made {want}; losses {losses}")
    moved = [k for k, v in stats_before.items() if not torch.equal(v, model.module.state_dict()[k])]
    if len(moved) != len(stats_before):
        raise AssertionError(f"V1 BatchNorm running statistics moved: {len(moved)} of {len(stats_before)}")
    t = frames.shape[-2]
    print(f"V1 train --batchSize {V1_TRAIN_BATCH}, {V1_SEGMENT_SECONDS:.0f} s segments (t = {t}), "
          f"{V1_TRAIN_STEPS} steps of make_train_step ({card}): step seconds {[round(x, 4) for x in step_s]}, "
          f"peak memory {train_peak_gb:.2f} GB, losses {[round(x, 3) for x in losses]}, launches "
          f"{train_launches}, BatchNorm running statistics moved ({len(moved)} buffers)")
    figures.update(v1_step_s=step_s, v1_train_peak_gb=train_peak_gb, v1_losses=losses)
    for name, n in train_launches.items():
        launches[name] += n

    # at the step's shape, on its scores and learned noise: the alpha and
    # beta tables against their plain versions, and logZ with its score and
    # noise cotangents through the kernels against autograd of log_z_slow
    model.module.eval()
    with torch.no_grad():
        s, s_skip = model.module.process_frames(frames)[:2]
    nb = s.shape[2]
    tp, nbp = -(-t // 8) * 8, -(-nb // 128) * 128
    s_pad = torch.full((tp, tp, nbp), NEG, device=dev)
    s_pad[:t, :t, :nb] = s
    noise = torch.zeros(tp, nbp, device=dev)
    noise[: t - 1, :nb] = s_skip
    spdiag = torch.nn.functional.softplus(torch.diagonal(s_pad).t()).contiguous()
    shift_rows = torch.nn.functional.pad(noise[:-1], (0, 0, 1, 0)).contiguous()
    err.update(check_tables(logz, s_pad, shift_rows, noise, spdiag))
    for name, kernel, plain, rows in (
            ("semicrf_alpha", logz.alpha_table_padded_cuda, logz.alpha_table_padded_plain, shift_rows),
            ("semicrf_beta", logz.beta_table_padded_cuda, logz.beta_table_padded_plain, noise)):
        k_ms, dev_ms, p_ms = (cuda_ms(lambda: kernel(s_pad, rows, spdiag)),
                              cuda_ms(lambda: kernel(s_pad, rows, spdiag), launches=DEVICE_LAUNCHES),
                              cuda_ms(lambda: plain(s_pad, rows, spdiag), runs=3))
        bnd = table_bound(tp, nbp, 4)
        times[name] = {"shape": [tp, tp, nbp], "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
                       "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"V1 {name} [{tp},{tp},{nbp}] real scores ({card}): lone launch {k_ms:.4f} ms, device "
              f"{dev_ms:.4f} ms over {DEVICE_LAUNCHES} launches, plain {p_ms:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), share {bnd[0] / dev_ms:.1%} on device time")
    del s_pad, noise, spdiag, shift_rows
    lz_err, g_err, g_tol, lz_max, gn_max = logz_against_slow(semicrf, semicrf.log_z_best, s, s_skip)
    if lz_err > TABLE_RTOL or g_err > g_tol or gn_max == 0.0:
        raise AssertionError(f"V1 logZ through the kernels vs log_z_slow at {list(s.shape)}: logZ relative "
                             f"{lz_err}, score and noise cotangents max |diff| {g_err} (allowed {g_tol})")
    print(f"V1 logZ via log_z_best (kernels) vs autograd of log_z_slow at {list(s.shape)} with the learned "
          f"noise: logZ up to {lz_max:.1f}, within {lz_err:.3g} relative (allowed "
          f"{TABLE_RTOL}), score and noise cotangents max |diff| {g_err:.3g} (allowed {g_tol:.3g}), largest "
          f"noise cotangent {gn_max:.3g}")
    return launches, err, times, figures


class AttentionRecorder:
    """While installed: the (q shape, k shape) of every ``fused_attention``
    call, the first real q, k and v at each query shape whose keys are the
    whole lattice (for the streaming kernels' check), and the calls of the
    plain versions, which no CUDA tensor may reach."""

    def __init__(self, attention):
        self.attention, self.calls, self.captured, self.plain_calls = attention, [], {}, 0
        self.saved = {name: getattr(attention, name)
                      for name in ("fused_attention", "attention_plain", "attention_bwd_plain")}

    def __enter__(self):
        fused, plain, bwd_plain = (self.saved[n] for n in ("fused_attention", "attention_plain",
                                                           "attention_bwd_plain"))

        def recorded(q, k, v, *args):
            self.calls.append((tuple(q.shape), tuple(k.shape)))
            if k.shape[1] == LATTICE and tuple(q.shape) not in self.captured:
                self.captured[tuple(q.shape)] = tuple(a.detach().clone() for a in (q, k, v))
            return fused(q, k, v, *args)

        def counted(fn):
            def call(*args, **kwargs):
                self.plain_calls += 1
                return fn(*args, **kwargs)
            return call

        self.attention.fused_attention = recorded
        self.attention.attention_plain = counted(plain)
        self.attention.attention_bwd_plain = counted(bwd_plain)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.attention, name, fn)

    def stream_calls(self):
        return sum(k[1] == LATTICE for _, k in self.calls)


def branch_path(dev, card, audio, corpus, pickles, budget, counts, reset_counts):
    """Path 7, the non-flagship V2 branches at full width and depth, each
    the flagship conf with the changes of ``BRANCHES``, random weights from
    ``SEED``: (a) the aggregation tracks ("F", "T", "All0", "0All") and (b)
    the full "FT" attention, each transcribed and trained on the default
    route and with ``TRANSKUN_TPU_FUSED_ATTN=1`` (the streaming kernels for
    the 0All and FT keys); (c) V2 with the pairwise scorer, the full upsample
    stack and ``downsampleF=False``, transcribed, through ``transcribe_many``
    and trained.  Notes equal between the routes of a configuration
    (``same_notes``: pitch, velocity and flags, times within 1e-6 s),
    losses within LOSS_RTOL; launches
    equal to the calls made, the streaming variants' to the calls with the
    lattice as keys, and no call of the plain attention on the fused route;
    the streaming kernels held against an fp64 evaluation, beside the plain
    versions, on the real activations (``check_attention_fp64``).  Every
    check runs before the first failure is raised.
    Returns (launches of each kernel on the path, the path's figures)."""
    import copy

    import torch

    from transkun_tpu_torch.cli import train as train_cli
    from transkun_tpu_torch.data.note import validate_notes
    from transkun_tpu_torch.models.config import default_conf_path, parse_conf_file
    from transkun_tpu_torch.models.transkun import DEFAULT_SEGMENT_BATCH, TransKun
    from transkun_tpu_torch.ops import attention, frontend

    with open(default_conf_path()) as f:
        flagship = json.load(f)
    launches = dict.fromkeys(KERNELS, 0)
    figures, failures = {}, []
    attn_flag = "TRANSKUN_TPU_FUSED_ATTN"

    def expect(ok, what):
        if not ok:
            failures.append(what)
            print(f"path 7 FAILED: {what}")

    def add(got):
        for name in KERNELS:
            launches[name] += got[name]

    def conf_file(name):
        d = copy.deepcopy(flagship)
        d["Model"]["config"].update(BRANCHES[name])
        path = os.path.join(corpus, f"{name}.conf")
        with open(path, "w") as f:
            json.dump(d, f)
        return path

    def key(n):
        return (round(n.start * 1e3), round(n.end * 1e3), n.pitch, n.velocity)

    def transcribed(model, segment_batch=None):
        """(notes, wall s, peak GB, launches, recorder, busy share) of one
        transcription of the piece after a warm-up one; the busy share is the
        profiler's device time of another run over the wall time, None (not
        measured) where the profiler saw no device time."""
        model.transcribe(audio, segment_batch=segment_batch)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with AttentionRecorder(attention) as rec:
            t0 = time.perf_counter()
            notes = model.transcribe(audio, segment_batch=segment_batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got, peak = counts(), torch.cuda.max_memory_allocated(dev) / 1e9
        busy_ms = profiled_ms(lambda: model.transcribe(audio, segment_batch=segment_batch), calls=1)
        busy = None if busy_ms is None else busy_ms / 1e3 / wall
        validate_notes(notes)
        return notes, wall, peak, got, rec, busy

    def want_transcription(model, n_seg, group):
        fallback = model.last_transcribe_fallback_from
        redone = 0 if fallback is None else n_seg - fallback * group
        return {"viterbi_bwd": n_seg + redone, "decode_walk": -(-n_seg // group)}

    def check_real(rec, what):
        """The streaming kernels on the real q, k, v that reached them, with
        a unit-normal cotangent, against an fp64 evaluation beside the plain
        versions (``check_attention_fp64``), and on the same tensors rounded
        to bf16 against the plain versions at bf16 (``check_attention``)."""
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for shape, (q, k, v) in rec.captured.items():
            do = torch.randn(q.shape, generator=gen, device=dev, dtype=q.dtype)
            rows = check_attention_fp64(attention, q, k, v, do, ATTN_HEADS)
            real = fig.setdefault("real_activations", {})
            real[f"{what} {list(shape)}"] = {
                n: {"kernel": e_k, "plain": e_p, "bound": bnd, "max_abs": top} for n, e_k, e_p, bnd, top in rows}
            print(f"streaming kernels on {what}'s real activations q {list(shape)} x {k.shape[1]} keys "
                  f"(max |q| {float(q.abs().max()):.3g}, |k| {float(k.abs().max()):.3g}): distance from fp64, "
                  f"kernel / plain fp32 / largest bound (largest |value|): "
                  + ", ".join(f"{n} {e_k:.3g} / {e_p:.3g} / {bnd:.3g} ({top:.3g})" for n, e_k, e_p, bnd, top in rows))
            # the same activations rounded to bf16, by check_attention's bf16 rule
            fwd_e, bwd_e, _ = check_attention(attention, *(a.bfloat16() for a in (q, k, v, do)), ATTN_HEADS,
                                              "stream")
            real[f"{what} {list(shape)} bf16"] = {"o": fwd_e, "dq_dk_dv": bwd_e}
            print(f"streaming kernels on {what}'s real activations q {list(shape)} rounded to bf16: within one "
                  f"bf16 spacing of each output's largest value of the plain versions at bf16: max |diff| "
                  f"o {fwd_e:.3g}, dq/dk/dv {bwd_e:.3g}")
            del do
        rec.captured.clear()

    def train(name, conf, fused, steps, batch):
        """``cli.train.main`` for ``steps`` steps at ``batch``: (result,
        launches, recorder)."""
        args = [os.path.join(corpus, f"ckpt_{name}_{'fused' if fused else 'default'}.pt"),
                "--datasetPath", corpus,
                "--datasetMetaFile_train", os.path.join(pickles, "train.pickle"),
                "--datasetMetaFile_val", os.path.join(pickles, "val.pickle"),
                "--modelConf", conf, "--batchSize", str(batch), "--ckptEvery", "1000",
                "--logEvery", "1", "--seed", str(SEED), "--device", "cuda", "--statsEvery", "0",
                "--maxEpoch", "1", "--stopAtStep", str(steps)]
        if fused:
            os.environ[attn_flag] = "1"
        reset_counts()
        try:
            with AttentionRecorder(attention) as rec:
                result = train_cli.main(args)
                torch.cuda.synchronize()
        finally:
            os.environ.pop(attn_flag, None)
        return result, counts(), rec

    for name in ("aggregation", "full", "pairwise"):
        conf_path = conf_file(name)
        _, conf = parse_conf_file(conf_path)
        pad = math.ceil((conf.segmentSizeInSecond - conf.segmentHopSizeInSecond) * conf.fs)
        step = math.ceil(conf.segmentHopSizeInSecond * conf.fs / conf.hopSize) * conf.hopSize
        n_seg = math.ceil((audio.shape[0] + 2 * pad) / step)
        model = TransKun(conf, device=dev, seed=SEED)
        model.decode_k_budget = budget  # path 1's
        with torch.no_grad():
            if conf.useInnerProductScorer:
                model.module.scorer.map[0].bias[-1] = -8.0
            else:  # as the V1 path: 0.1% of the fourth segment's singletons fire
                seg = torch.from_numpy(np.ascontiguousarray(
                    np.pad(audio.T, ((0, 0), (pad, pad)))[:, 3 * step: 3 * step + math.ceil(
                        conf.segmentSizeInSecond * conf.fs)])).to(dev)
                s = model.module.process_frames(frontend.make_frame(seg, conf.hopSize, conf.windowSize)[None])[0]
                shift = float(torch.quantile(torch.diagonal(s).flatten(), PAIRWISE_SINGLETON_QUANTILE))
                model.module.scorer.post.map[3].bias -= shift
                del s, seg
        fig = figures[name] = {"changes": BRANCHES[name], "segments": n_seg}
        steps, batch = BRANCH_TRAIN[name]
        routes = [("default", False, None)]
        if name == "full":  # the plain route's logits: 5.6 GB a segment and layer
            routes = [("fused", True, None), ("default", False, 1)]
        elif name == "aggregation":
            routes.append(("fused", True, None))
        notes_by_route = {}
        for route, fused, segment_batch in routes:
            if fused:
                os.environ[attn_flag] = "1"
            try:
                notes, wall, peak, got, rec, busy = transcribed(model, segment_batch)
            finally:
                os.environ.pop(attn_flag, None)
            group = segment_batch or DEFAULT_SEGMENT_BATCH
            want = {**dict.fromkeys(KERNELS, 0), **want_transcription(model, n_seg, group)}
            if fused:
                n_stream = rec.stream_calls()
                want.update(attention_fwd=len(rec.calls) - n_stream, attention_fwd_stream=n_stream)
                expect(n_stream == conf.nLayers * want["viterbi_bwd"] and rec.plain_calls == 0,
                       f"{name} fused transcription: {n_stream} calls with the lattice's keys for "
                       f"{want['viterbi_bwd']} segments of {conf.nLayers} layers, {rec.plain_calls} "
                       f"calls of the plain attention")
            expect(got == want, f"{name} {route} transcription launches {got}, calls made {want}")
            add(got)
            notes_by_route[route] = notes
            fig[f"transcribe_{route}"] = {"wall_s": wall, "rtf": PIECE_SECONDS / wall, "peak_gb": peak,
                                          "busy": busy, "notes": len(notes), "segment_batch": group,
                                          "fallback_from": model.last_transcribe_fallback_from}
            print(f"path 7 {name} transcribe {PIECE_SECONDS:.0f} s, {route} route, segment_batch {group} "
                  f"({card}): wall {wall:.3f} s, RTF {PIECE_SECONDS / wall:.1f}x, peak memory "
                  f"{peak:.2f} GB, device busy {'not measured' if busy is None else f'{busy:.1%}'}, "
                  f"{len(notes)} notes, launches "
                  f"{ {k: v for k, v in got.items() if v} }; fallback from "
                  f"{model.last_transcribe_fallback_from}; attention shapes "
                  f"{sorted(set(rec.calls))}")
            if fused:
                check_real(rec, f"{name} transcription")
            torch.cuda.empty_cache()
        if len(notes_by_route) == 2:  # same_notes: times within 1e-6 s (ctx differs in rounding)
            (ra, na), (rb, nb) = notes_by_route.items()
            equal, worst = same_notes(na, nb)
            fig["largest_time_difference_between_routes_s"] = worst
            a, b = {key(n) for n in na}, {key(n) for n in nb}
            print(f"path 7 {name}: notes of the {ra} and {rb} routes equal: {equal}, largest time "
                  f"difference {worst:.3g} s; {len(a ^ b)} differ at the millisecond: "
                  f"{[(n.pitch, n.start, n.end, n.velocity) for n in na + nb if key(n) not in a & b][:6]}")
            expect(equal, f"{name}: the notes differ between the routes (largest time difference {worst} s)")
        if name == "pairwise":  # transcribe_many over two copies: the notes of transcribe
            reset_counts()
            t0 = time.perf_counter()
            many = list(model.transcribe_many([audio, audio]))
            torch.cuda.synchronize()
            many_wall = time.perf_counter() - t0
            got = counts()
            add(got)
            expect(len(many) == 2 and all(same_notes(m, notes_by_route["default"])[0] for m in many),
                   "pairwise: transcribe_many's notes differ from transcribe's")
            expect(got["viterbi_bwd"] >= 2 * n_seg and got["decode_walk"] == 2 * -(-n_seg // DEFAULT_SEGMENT_BATCH),
                   f"pairwise transcribe_many launches {got}")
            fig["transcribe_many_2_wall_s"] = many_wall
            print(f"path 7 pairwise transcribe_many over 2 copies ({card}): wall {many_wall:.3f} s, "
                  f"notes equal to transcribe's; launches { {k: v for k, v in got.items() if v} }")
        del model
        torch.cuda.empty_cache()

        # training: the default route, and the fused one beside it for (a) and (b)
        losses = {}
        for route in (["default", "fused"] if name != "pairwise" else ["default"]):
            fused = route == "fused"
            try:
                result, got, rec = train(name, conf_path, fused, steps, batch)
            except torch.cuda.OutOfMemoryError as e:
                # only the plain FT attention may run out: at --batchSize 1 it keeps
                # [8, 13261, 13261] fp32 tensors for its backward ("where memory allows")
                if (name, route) != ("full", "default"):
                    raise
                fig[f"train_{route}"] = {"out_of_memory": str(e).splitlines()[0]}
                print(f"path 7 {name} train {route} route --batchSize {batch} ({card}): out of memory: "
                      f"{str(e).splitlines()[0]}")
                gc.collect()
                torch.cuda.empty_cache()
                continue
            n = result["steps"]
            recompute = 2 if conf.useGradientCheckpoint else 1
            want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": n, "semicrf_beta": n}
            if fused:
                n_stream = rec.stream_calls()
                want.update(attention_fwd=len(rec.calls) - n_stream, attention_fwd_stream=n_stream,
                            attention_bwd=(len(rec.calls) - n_stream) // recompute,
                            attention_bwd_stream=n_stream // recompute)
                expect(n_stream > 0 and rec.plain_calls == 0,
                       f"{name} fused training: {n_stream} lattice calls, {rec.plain_calls} plain calls")
            expect(got == want and n == steps and np.isfinite(result["losses"]).all(),
                   f"{name} {route} training: {n} steps, launches {got}, calls made {want}, "
                   f"losses {result['losses']}")
            add(got)
            losses[route] = result["losses"]
            fig[f"train_{route}"] = {"batch": batch, "steps": n, "losses": result["losses"],
                                     "step_s": result["step_seconds"],
                                     "peak_gb": result["step_peak_bytes"] / 1e9}
            print(f"path 7 {name} train {route} route --batchSize {batch} ({card}): {n} steps "
                  f"{[round(x, 4) for x in result['step_seconds']]} s, peak memory "
                  f"{result['step_peak_bytes'] / 1e9:.2f} GB, losses {result['losses']}, launches "
                  f"{ {k: v for k, v in got.items() if v} }")
            if fused:
                check_real(rec, f"{name} training")
            del rec
            gc.collect()
            torch.cuda.empty_cache()
        if len(losses) == 2:
            rel = max(abs(f - d) / abs(d) for f, d in zip(losses["fused"], losses["default"]))
            fig["loss_rel_diff"] = rel
            expect(rel <= LOSS_RTOL, f"{name}: losses fused {losses['fused']} against default "
                                     f"{losses['default']}, largest relative difference {rel}")
            print(f"path 7 {name}: losses fused vs default, largest relative difference {rel:.3g} "
                  f"(allowed {LOSS_RTOL})")
    if failures:
        raise AssertionError(f"path 7: {len(failures)} checks failed: {failures}")
    return launches, figures


def dist_rank(in_path, out_path):
    """One rank of path 8 (a), started by ``dist_path`` under the launcher's
    environment with both ranks on ``cuda:0`` over gloo: the flagship model
    from the seed rank 0 broadcasts, DIST_STEPS steps of ``make_train_step``
    with the group on the rank's rows of each global batch, then one V1 step.
    Rank 0 also computes the references in one process: the two halves'
    gradients of each step, and the V1 running statistics of the
    concatenated batch.  Writes its figures as JSON to ``out_path``."""
    import torch

    from transkun_tpu_torch.models.ablation import AblationConfig, TransKunAblation
    from transkun_tpu_torch.models.config import load_default_conf
    import transkun_tpu_torch.models.transkun as transkun_module
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.ops import logz, semicrf
    from transkun_tpu_torch.parallel import (
        all_reduce_max, broadcast_from_0, broadcast_module_, init_distributed, process_info,
    )
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, dropout_seed, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed("cuda", backend="gloo"):
        raise RuntimeError("path 8: no group joined")
    rank, world = process_info()
    group = torch.distributed.group.WORLD
    dev = torch.device("cuda", torch.cuda.current_device())
    with open(in_path, "rb") as f:
        data = pickle.load(f)
    out = {"rank": rank, "steps": [], "v1": {}}

    def same_on_ranks(tensors):
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        differs = torch.tensor(int(not torch.equal(flat, broadcast_from_0(flat, group))))
        return int(all_reduce_max(differs, group)) == 0

    # each rank proposes its own seed: rank 0's is the one every rank takes
    seed = int(broadcast_from_0(torch.tensor(SEED + rank), group))
    _, conf = load_default_conf()
    model = TransKun(conf, device=dev, seed=seed)
    broadcast_module_(model.module, group)
    ref = TransKun(conf, device=dev, seed=seed) if rank == 0 else None

    class Recording:
        """The clip, recording the gradients it is handed (the summed ones,
        the all-reduce's flat buffer) as the parameters' views of a copy."""

        def __init__(self, clip, optimizer):
            self.clip, self.optimizer, self.grads = clip, optimizer, None

        def __call__(self, grads, q):
            self.grads = self.optimizer.views(grads.clone())
            return self.clip(grads, q)

        def push(self, norm, finite):
            self.clip.push(norm, finite)

    state = TrainState(model, AdaBelief(model.module.named_parameters()))
    state.optimizer.count.fill_(DIST_OPT_COUNT)
    state.clip = Recording(state.clip, state.optimizer)
    step_fn = make_train_step(model, group=group)

    def flat_params(module):
        return torch.cat([p.detach().reshape(-1) for p in module.parameters()])

    def flagship_logz(model, frames):
        """The step's logZ route (``logz.log_z_padded`` on the scorer's
        padded lanes, the kernels at the rank's own shape) against
        ``log_z_slow`` on the real lanes of this rank's scores."""
        n, t, p = frames.shape[0], frames.shape[2], len(model.targetMIDIPitch)
        t_pad, p_pad = transkun_module._pad_to(t, semicrf.PALLAS_KP), transkun_module._track_pad(n, p)
        model.module.eval()
        with torch.no_grad():
            s_pad, noise_pad, _ = model.module.process_frames_train(frames, t_pad, p_pad)
        lanes = torch.arange(n * p_pad, device=dev).view(n, p_pad)[:, :p].reshape(-1)

        def through_kernels(s_g, n_g):
            sp, npad = s_pad.clone(), noise_pad.clone()
            sp[:t, :t, lanes] = s_g
            npad[: t - 1, lanes] = n_g
            return logz.log_z_padded(t, sp, npad)[lanes]

        got = logz_against_slow(semicrf, through_kernels, s_pad[:t, :t, lanes], noise_pad[: t - 1, lanes])
        return dict(zip(("lz_err", "g_err", "g_tol", "lz_max"), got[:4]), shape=list(s_pad.shape))

    def k_sync(densest):
        return int(all_reduce_max(torch.tensor(densest), group))

    for k, (audio, notes) in enumerate(data["batches"]):
        rows = slice(DIST_BATCH * rank, DIST_BATCH * (rank + 1))
        frames, labels = model.frames(audio[rows]), model.labels(notes[rows], k_sync=k_sync)
        if ref is not None:
            ref.module.load_state_dict(model.module.state_dict())
        generator = torch.Generator(device=dev).manual_seed(dropout_seed(SEED, k, rank))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        launches = (logz.alpha_launches, logz.beta_launches)
        before = flat_params(model.module)
        t0 = time.perf_counter()
        metrics = step_fn(state, frames, labels, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = int((flat_params(model.module) != before).sum())
        del before
        step = {"wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "moved": moved,
                "alpha": logz.alpha_launches - launches[0], "beta": logz.beta_launches - launches[1],
                "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "finite": bool(metrics["finite"]), "k": labels[0].shape[-1],
                "params_equal": same_on_ranks(model.module.parameters())}
        if ref is not None:
            # the two halves' gradients in one process, each of its half's mean
            # loss with its rank's dropout stream, summed
            loss_fn, summed = ref.make_train_loss(), None
            for r in range(world):
                part = slice(DIST_BATCH * r, DIST_BATCH * (r + 1))
                ref.module.zero_grad(set_to_none=True)
                logp = loss_fn(ref.frames(audio[part]), ref.labels(notes[part], step["k"]),
                               torch.Generator(device=dev).manual_seed(dropout_seed(SEED, k, r)))
                (-logp.sum(-1).mean() / 50.0).backward()
                grads = [p.grad.detach().clone() for p in ref.module.parameters()]
                summed = grads if summed is None else [a + b for a, b in zip(summed, grads)]
            ratio = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                        for g, w in zip(state.clip.grads, summed))
            step["grad_vs_halves"] = ratio
            ref.module.zero_grad(set_to_none=True)
            if k == 0:
                out["logz"] = flagship_logz(ref, frames)
        out["steps"].append(step)
    del model, ref, state, step_fn, frames, labels
    gc.collect()
    torch.cuda.empty_cache()

    # the V1 model: one step, its BatchNorm statistics summed over the ranks
    v1 = TransKunAblation(AblationConfig(), device=dev, seed=seed)
    broadcast_module_(v1.module, group)
    audio, notes = data["v1"]
    if rank == 0:
        # the running statistics of one train-mode forward on the whole batch
        ref1 = TransKunAblation(AblationConfig(), device=dev, seed=seed)
        with torch.no_grad():
            ref1.make_train_loss()(ref1.frames(audio), ref1.labels(notes), None)
        want = {k: v for k, v in ref1.module.state_dict().items() if "running" in k}
        del ref1
    before = {k: v.clone() for k, v in v1.module.state_dict().items() if "running" in k}
    state = TrainState(v1, AdaBelief(v1.module.named_parameters()))
    state.optimizer.count.fill_(DIST_OPT_COUNT)
    params_before = flat_params(v1.module)
    rows = slice(DIST_V1_BATCH * rank, DIST_V1_BATCH * (rank + 1))
    frames, labels = v1.frames(audio[rows]), v1.labels(notes[rows], k_sync=k_sync)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    launches = (logz.alpha_launches, logz.beta_launches)
    t0 = time.perf_counter()
    metrics = make_train_step(v1, group=group)(
        state, frames, labels, torch.Generator(device=dev).manual_seed(dropout_seed(SEED, 0, rank)))
    torch.cuda.synchronize()
    got = {k: v for k, v in v1.module.state_dict().items() if "running" in k}
    out["v1"] = {"wall_s": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                 "alpha": logz.alpha_launches - launches[0], "beta": logz.beta_launches - launches[1],
                 "loss": float(metrics["loss"]), "finite": bool(metrics["finite"]),
                 "moved": sum(not torch.equal(before[k], v) for k, v in got.items()), "buffers": len(got),
                 "params_moved": int((flat_params(v1.module) != params_before).sum()),
                 "params_equal": same_on_ranks(list(v1.module.parameters()) + list(got.values()))}
    if rank == 0:
        out["v1"]["stats_err"] = max(
            float(((g - want[k]).abs() - DIST_STATS_RTOL * want[k].abs()).max()) for k, g in got.items())
        # the step's logZ route (log_z_best: the kernels at this rank's lane
        # count) on this rank's scores, against log_z_slow
        v1.module.eval()
        with torch.no_grad():
            s, s_skip = v1.module.process_frames(frames)[:2]
        checked = logz_against_slow(semicrf, semicrf.log_z_best, s, s_skip)
        out["v1"]["logz"] = dict(zip(("lz_err", "g_err", "g_tol", "lz_max", "gn_max"), checked),
                                 shape=list(s.shape))
    torch.distributed.destroy_process_group()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "transkun_tpu")]
    if bad:
        raise AssertionError(f"JAX code was imported: {bad[:5]}")
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def dist_path(dev, card, corpus, pickles, train_args, tmp, conf, audio, notes, budget, counts,
              reset_counts):
    """Path 8: multi-process training and the remaining entry points.
    (a) two gloo ranks on the one card (``dist_rank``); (b) ``cli.train
    --nDevices``; (c) ``crf_minimal_example`` on the card; (d) path 1's
    piece through ``transcribe_many(devices=[cuda:0, cuda:0])``; (e)
    ``cli.compute_metrics`` on path 1's MIDI against itself; (f) path 1's
    timing marks.  Returns the launches of each kernel on the path and its
    figures."""
    import contextlib
    import io

    import torch

    from transkun_tpu_torch import crf_minimal_example
    from transkun_tpu_torch.cli import compute_metrics as metrics_cli
    from transkun_tpu_torch.cli import train as train_cli
    from transkun_tpu_torch.data import dataset as D
    from transkun_tpu_torch.data.midi import write_midi
    import transkun_tpu_torch.models.transkun as transkun_module
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.ops import semicrf, viterbi
    from transkun_tpu_torch.parallel import launch_ranks

    launches = dict.fromkeys(KERNELS, 0)
    figures = {}

    def add(got):
        for name in KERNELS:
            launches[name] += got[name]

    # (a) two ranks on the one card over gloo (NCCL takes one rank a card)
    dataset = D.DatasetMaestro(corpus, os.path.join(pickles, "train.pickle"))
    n_chunk = int(conf.segmentSizeInSecond * conf.fs)
    loader = D.BatchLoader(
        D.DatasetMaestroIterator(dataset, conf.segmentHopSizeInSecond, conf.segmentSizeInSecond,
                                 seed=SEED, notes_strictly_contained=False),
        2 * DIST_BATCH, shuffle=True, seed=0, drop_last=True, num_workers=0)
    batches = []
    for batch in loader:
        batches.append((batch["audioSlices"][:, :n_chunk], batch["notes"]))
        if len(batches) == DIST_STEPS:
            break
    got = [dataset.fetch_data(idx, 0.0, V1_SEGMENT_SECONDS, True, False) for idx in range(2 * DIST_V1_BATCH)]
    v1_batch = (np.stack([a for _, a, _ in got]), [nt for nt, _, _ in got])
    in_path = os.path.join(tmp, "dist_in.pkl")
    with open(in_path, "wb") as f:
        pickle.dump({"batches": batches, "v1": v1_batch}, f)
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        launch_ranks(lambda rank: [sys.executable, "-c",
                                   "import sys, chip_smoke; sys.exit(chip_smoke.dist_rank(*sys.argv[1:]))",
                                   in_path, os.path.join(tmp, f"rank{rank}.json")],
                     2, local_rank=lambda rank: 0, cwd=here, timeout=600)
    except RuntimeError as e:
        raise AssertionError(f"path 8 ranks: {e}")
    wall = time.perf_counter() - t0
    ranks = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    for r in ranks:
        for k, step in enumerate(r["steps"]):
            if not (step["finite"] and step["params_equal"] and step["moved"] > 0
                    and step["alpha"] == 1 and step["beta"] == 1):
                raise AssertionError(f"path 8 rank {r['rank']} step {k}: {step}")
            print(f"path 8 (a) rank {r['rank']} flagship V2 step {k}, --batchSize {DIST_BATCH} a rank, gloo on "
                  f"one card ({card}): wall {step['wall_s']:.4f} s, peak memory {step['peak_gb']:.2f} GB, "
                  f"loss {step['loss']:.3f}, grad norm {step['grad_norm']:.3f}, launches alpha "
                  f"{step['alpha']} beta {step['beta']}; {step['moved']} parameters moved, all equal on "
                  f"both ranks bit for bit")
        v1 = r["v1"]
        if not (v1["finite"] and v1["params_equal"] and v1["params_moved"] > 0 and v1["alpha"] == 1
                and v1["beta"] == 1 and v1["moved"] == v1["buffers"] > 0):
            raise AssertionError(f"path 8 rank {r['rank']} V1 step: {v1}")
        print(f"path 8 (a) rank {r['rank']} V1 step, --batchSize {DIST_V1_BATCH} a rank ({card}): wall "
              f"{v1['wall_s']:.4f} s, peak memory {v1['peak_gb']:.2f} GB, launches alpha {v1['alpha']} "
              f"beta {v1['beta']}; parameters and running statistics equal on both ranks")
        launches["semicrf_alpha"] += sum(st["alpha"] for st in r["steps"]) + v1["alpha"]
        launches["semicrf_beta"] += sum(st["beta"] for st in r["steps"]) + v1["beta"]
    if [st["loss"] for st in ranks[0]["steps"]] != [st["loss"] for st in ranks[1]["steps"]]:
        raise AssertionError("path 8: the ranks report different losses")
    grad_err = max(st["grad_vs_halves"] for st in ranks[0]["steps"])
    if grad_err > DIST_GRAD_RTOL:
        raise AssertionError(f"path 8: summed gradient against the two halves' sum: {grad_err}")
    stats_err = ranks[0]["v1"]["stats_err"]
    if stats_err > DIST_STATS_ATOL:
        raise AssertionError(f"path 8: V1 running statistics exceed the concatenated batch's by "
                             f"{stats_err} beyond rtol {DIST_STATS_RTOL}")
    for what, lz in (("flagship V2 step", ranks[0]["logz"]), ("V1 step", ranks[0]["v1"]["logz"])):
        if lz["lz_err"] > TABLE_RTOL or lz["g_err"] > lz["g_tol"]:
            raise AssertionError(f"path 8 {what}: logZ through the kernels vs log_z_slow at {lz['shape']}: {lz}")
        print(f"path 8 (a) rank 0 {what}: logZ through the kernels at the step's shape {lz['shape']} vs "
              f"autograd of log_z_slow on the real lanes: logZ up to {lz['lz_max']:.1f}, within "
              f"{lz['lz_err']:.3g} relative (allowed {TABLE_RTOL}), score and noise cotangents max |diff| "
              f"{lz['g_err']:.3g} (allowed {lz['g_tol']:.3g})")
    print(f"path 8 (a): the step's summed gradient before the clip against the sum of the two halves' "
          f"gradients in one process: largest difference {grad_err:.3g} of each tensor's largest value "
          f"(allowed {DIST_GRAD_RTOL}); V1 running statistics against one process's on the "
          f"concatenated batch: within rtol {DIST_STATS_RTOL} and {stats_err:.3g} (allowed "
          f"{DIST_STATS_ATOL}); ranks' wall {wall:.1f} s")
    figures["dist"] = {"ranks": ranks, "wall_s": wall, "grad_vs_halves": grad_err,
                       "v1_stats_err": stats_err, "logz": ranks[0]["logz"], "v1_logz": ranks[0]["v1"]["logz"]}

    # (b) the CLI: two ranks need two cards; one rank trains
    try:
        train_cli.main([os.path.join(tmp, "ckpt_dist.pt"), *train_args, "--nDevices", "2"])
    except SystemExit as e:
        if f"{torch.cuda.device_count()} found" not in str(e):
            raise AssertionError(f"--nDevices 2 said {e}")
        print(f"path 8 (b): --nDevices 2 on this machine: {e}")
    else:
        raise AssertionError("--nDevices 2 ran on one card")
    reset_counts()
    run = train_cli.main([os.path.join(tmp, "ckpt_dist.pt"), *train_args, "--nDevices", "1",
                          "--statsEvery", "0", "--maxEpoch", "1", "--stopAtStep", "2"])
    torch.cuda.synchronize()
    got = counts()
    want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": 2, "semicrf_beta": 2}
    if run["steps"] != 2 or got != want or not np.isfinite(run["losses"]).all():
        raise AssertionError(f"--nDevices 1: {run['steps']} steps, losses {run['losses']}, launches {got}")
    add(got)
    print(f"path 8 (b): --nDevices 1 took {run['steps']} steps ({card}): step seconds "
          f"{[round(x, 4) for x in run['step_seconds']]}, launches {got}")

    # (c) the semi-CRF example on the card against its plain version
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = crf_minimal_example.main(["--device", "cuda"])
    torch.cuda.synchronize()
    got = counts()
    want = {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": 2, "semicrf_alpha": 1, "semicrf_beta": 1}
    if got != want:
        raise AssertionError(f"crf_minimal_example launches {got}, calls made {want}")
    add(got)
    score, noise = out["score"], out["noise_score"]
    plain = semicrf.eval_path(out["intervals"], score, noise) - semicrf.log_z_slow(score, noise)
    lp_err = float(((out["log_prob"] - plain).abs() / plain.abs()).max())
    s_t, noise_pad, gate = semicrf.decode_layout(score, noise)
    t, n = score.shape[0], score.shape[2]
    ptr = viterbi.viterbi_backward_tables_plain(s_t, noise_pad, gate)[: t - 1, :n].cpu().numpy()
    diag = (gate[:t, :n] > 0).cpu().numpy()
    if lp_err > 1e-5 or out["decoded"] != semicrf.backtrack_backward(ptr, diag, None) \
            or out["decoded_forced"] != semicrf.backtrack_backward(ptr, diag, [100] * n):
        raise AssertionError(f"crf_minimal_example: logProb {lp_err} off the plain version's, or a decode differs")
    print(f"path 8 (c) crf_minimal_example on the card: logProb within {lp_err:.3g} relative of "
          f"eval_path - log_z_slow (allowed 1e-5), both decodes equal the plain tables' walk "
          f"({sum(map(len, out['decoded']))} intervals), launches {got}; {len(printed.getvalue())} "
          f"bytes printed")

    # (d) path 1's piece on two "devices", both the card
    model = TransKun(conf, device=dev, seed=SEED)
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] = -8.0
    model.decode_k_budget = budget
    reset_counts()
    t0 = time.perf_counter()
    many = list(model.transcribe_many([audio, audio], devices=[dev, dev]))
    torch.cuda.synchronize()
    many_wall = time.perf_counter() - t0
    got = counts()
    pad = math.ceil((conf.segmentSizeInSecond - conf.segmentHopSizeInSecond) * conf.fs)
    hop = math.ceil(conf.segmentHopSizeInSecond * conf.fs / conf.hopSize) * conf.hopSize
    n_seg = math.ceil((audio.shape[0] + 2 * pad) / hop)
    group = transkun_module.DEFAULT_SEGMENT_BATCH
    want = {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": 2 * n_seg, "decode_walk": 2 * -(-n_seg // group)}
    if got != want or model.last_transcribe_fallback_from is not None:
        raise AssertionError(f"transcribe_many(devices=...) launches {got}, calls made {want}")
    for notes_i in many:
        equal, worst = same_notes(notes_i, notes)
        if not equal:
            raise AssertionError(f"transcribe_many(devices=[cuda:0, cuda:0]): notes differ from path 1's "
                                 f"({len(notes_i)} against {len(notes)}, {worst} s)")
    add(got)
    print(f"path 8 (d) transcribe_many(devices=[cuda:0, cuda:0]) over 2 copies ({card}): wall "
          f"{many_wall:.3f} s, notes equal path 1's ({len(notes)}), launches {got}")

    # (e) the evaluation CLI on path 1's MIDI against itself
    for sub in ("est", "gt"):
        os.makedirs(os.path.join(tmp, "metrics", sub))
        write_midi(notes, os.path.join(tmp, "metrics", sub, "piece.mid"))
    with contextlib.redirect_stdout(io.StringIO()):
        metrics_cli.main([os.path.join(tmp, "metrics", "est"), os.path.join(tmp, "metrics", "gt"),
                          "--outputJSON", os.path.join(tmp, "metrics.json")])
    with open(os.path.join(tmp, "metrics.json")) as f:
        note_f1 = json.load(f)["aggregated"]["note"][2]
    if note_f1 != 1.0:
        raise AssertionError(f"compute_metrics of path 1's MIDI against itself: note F1 {note_f1}")
    print(f"path 8 (e) compute_metrics on path 1's MIDI against itself: note F1 {note_f1}")

    # (f) the timing marks of path 1's piece
    os.environ["TRANSKUN_TPU_TIMING"] = "silent"
    try:
        reset_counts()
        marked = model.transcribe(audio)
        torch.cuda.synchronize()
        add(counts())
    finally:
        del os.environ["TRANSKUN_TPU_TIMING"]
    marks = model.last_transcribe_marks
    if not same_notes(marked, notes)[0] or [m[0] for m in marks[-3:]] != ["event waited for", "assembled", "merged"]:
        raise AssertionError(f"timing marks {marks}")
    phases = [(label, round((at - before) * 1e3, 2)) for (_, before), (label, at) in zip(marks, marks[1:])]
    print(f"path 8 (f) TRANSKUN_TPU_TIMING=silent, path 1's piece ({card}), ms since the mark before: {phases}")
    figures["marks_ms"] = phases
    del model
    return launches, figures


def input_rank(in_path, out_path):
    """One rank of path 9 (e), started by ``input_path`` under the
    launcher's environment with both ranks on ``cuda:0`` over gloo (joined
    here, so that ``cli.train.main`` finds the group and does not start
    NCCL): one step of ``cli.train.main --deviceData on`` at
    ``INPUT_RANK_BATCH`` a rank, then one on the host route (``--deviceData
    off --linkInt16 off``) from the same seed.  The step's frames and the
    parameters after it are recorded by wrapping ``make_train_step``.
    Writes its figures as JSON to ``out_path``."""
    import torch

    import transkun_tpu_torch.train.step as step_module
    from transkun_tpu_torch.cli import train as train_cli
    from transkun_tpu_torch.ops import logz
    from transkun_tpu_torch.parallel import all_reduce_max, broadcast_from_0, init_distributed, process_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed("cuda", backend="gloo"):
        raise RuntimeError("path 9: no group joined")
    rank, _ = process_info()
    group = torch.distributed.group.WORLD
    with open(in_path) as f:
        given = json.load(f)
    make_step, seen = step_module.make_train_step, {}

    def recording(model, *a, **kw):
        step_fn = make_step(model, *a, **kw)

        def step(state, frames, labels, generator):
            seen.setdefault("frames", frames.detach().cpu())
            metrics = step_fn(state, frames, labels, generator)
            seen["params"] = torch.cat([p.detach().reshape(-1) for p in model.module.parameters()])
            return metrics

        return step

    def same_on_ranks(flat):
        differs = torch.tensor(int(not torch.equal(flat, broadcast_from_0(flat, group))))
        return int(all_reduce_max(differs, group)) == 0

    step_module.make_train_step = recording
    out = {"rank": rank, "routes": {}}
    frames, params = {}, {}
    try:
        for name, route in (("device", ["--deviceData", "on"]),
                            ("host", ["--deviceData", "off", "--linkInt16", "off"])):
            seen.clear()
            before = (logz.alpha_launches, logz.beta_launches)
            t0 = time.perf_counter()
            run = train_cli.main([os.path.join(given["tmp"], f"ckpt_input_{name}.pt"), *given["args"],
                                  "--batchSize", str(INPUT_RANK_BATCH), "--statsEvery", "0",
                                  "--maxEpoch", "1", "--stopAtStep", "1", *route])
            torch.cuda.synchronize()
            frames[name], params[name] = seen["frames"], seen["params"]
            out["routes"][name] = {
                "wall_s": time.perf_counter() - t0, "losses": run["losses"],
                "iter_seconds": run["iter_seconds"], "step_seconds": run["step_seconds"],
                "peak_gb": run["step_peak_bytes"] / 1e9, "device_data": run["device_data"],
                "device_data_bytes": run["device_data_bytes"], "link_dtype": run["link_dtype"],
                "alpha": logz.alpha_launches - before[0], "beta": logz.beta_launches - before[1],
                "frames_shape": list(seen["frames"].shape),
                "params_equal_on_ranks": same_on_ranks(seen["params"]),
            }
    finally:
        step_module.make_train_step = make_step
    out["frames_equal"] = torch.equal(frames["device"], frames["host"])
    out["params_equal_across_routes"] = torch.equal(params["device"], params["host"])
    torch.distributed.destroy_process_group()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "transkun_tpu")]
    if bad:
        raise AssertionError(f"JAX code was imported: {bad[:5]}")
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def input_path(dev, card, corpus, pickles, train_args, tmp, conf, counts, reset_counts):
    """Path 9: the training input routes.  (a) ``dequantize_int16`` on the
    card over every int16 value against ``np.divide``; (b) path 2's corpus
    packed on the card (``DeviceDataset``): every batch of one epoch at
    ``--batchSize 4`` sliced there against the host loader's floats, and the
    frames of the device slice, of the int16 link and of the host floats;
    (c) ``INPUT_STEPS`` flagship steps of ``cli.train.main`` on each route
    from one seed; (d) a one-hour corpus packed, and ``slice_batch`` timed;
    (e) two gloo ranks on the card (``input_rank``).  Returns the launches
    of each kernel on the path and its figures."""
    import torch

    from transkun_tpu_torch.cli import train as train_cli
    from transkun_tpu_torch.data import dataset as D
    from transkun_tpu_torch.data.device_dataset import INT16_SCALE, DeviceDataset, dequantize_int16
    from transkun_tpu_torch.models.transkun import TransKun, quantize_link
    from transkun_tpu_torch.parallel import launch_ranks

    launches = dict.fromkeys(KERNELS, 0)
    figures = {}

    # (a) the dequantize over every int16 value, on the card
    v = np.arange(-32768, 32768).astype(np.int16)
    want = np.divide(v, 32767, dtype=np.float32)
    on_card = torch.from_numpy(v).to(dev)
    got = dequantize_int16(on_card).cpu().numpy()
    wrong = int((got.view(np.int32) != want.view(np.int32)).sum())
    by_cpu_scalar = int(((on_card.float() / 32767.0).cpu().numpy().view(np.int32) != want.view(np.int32)).sum())
    if got.dtype != np.float32 or wrong:
        raise AssertionError(f"path 9 (a): dequantize_int16 on the card differs from np.divide on {wrong} "
                             f"of 65536 int16 values")
    print(f"path 9 (a) dequantize_int16 on the card ({card}): all 65536 int16 values equal "
          f"np.divide(v, 32767, dtype=float32) bit for bit; x / 32767.0 (a CPU scalar, ATen's "
          f"reciprocal product) differs on {by_cpu_scalar}")
    figures["dequantize"] = {"wrong": wrong, "cpu_scalar_wrong": by_cpu_scalar}

    # (b) every batch of one epoch: the device slice against the host loader
    dataset = D.DatasetMaestro(corpus, os.path.join(pickles, "train.pickle"))
    n_chunk = int(conf.segmentSizeInSecond * conf.fs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus_dd = DeviceDataset(dataset, n_chunk, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0

    def epoch(skip_audio):
        it = D.DatasetMaestroIterator(dataset, conf.segmentHopSizeInSecond, conf.segmentSizeInSecond,
                                      seed=SEED, notes_strictly_contained=False, skip_audio=skip_audio)
        return it.chunksAll, D.BatchLoader(it, TRAIN_BATCH, shuffle=True, seed=0, drop_last=True, num_workers=0,
                                           collate=D.collate_fn_device if skip_audio else D.collate_fn_batching)

    chunks, host = epoch(False)
    dev_chunks, on_dev = epoch(True)
    duration = CORPUS_PIECE_SECONDS
    if chunks != dev_chunks or not (any(b < 0 for _, b, _ in chunks) and any(e > duration for *_, e in chunks)):
        raise AssertionError("path 9 (b): the two loaders' chunks differ, or none overhangs a piece")
    model = TransKun(conf, device=dev)
    n_batches = overhanging = 0
    for hb, db in zip(host, on_dev):
        ref = hb["audioSlices"][:, :n_chunk]
        got = corpus_dd.slice_batch(corpus_dd.starts_for(db["pieceIdx"], db["begins"]))
        link = quantize_link(ref, None, INT16_SCALE)
        slice_equal = np.array_equal(got.cpu().numpy()[:, : ref.shape[1]].view(np.int32), ref.view(np.int32))
        frames = model.frames(got[:, : ref.shape[1]])
        if not (slice_equal and link.dtype == np.int16 and torch.equal(model.frames(link), frames)
                and torch.equal(model.frames(ref), frames)):
            raise AssertionError(f"path 9 (b) batch {n_batches}: slice equal to the host floats {slice_equal}, "
                                 f"link {link.dtype}, or the frames differ")
        n_batches += 1
        overhanging += int(sum(b < 0 or b + conf.segmentSizeInSecond > duration for b in db["begins"]))
    if n_batches == 0:
        raise AssertionError("path 9 (b): no batch")
    print(f"path 9 (b) path 2's corpus on the card ({card}): {corpus_dd.nbytes} bytes int16 packed and "
          f"uploaded in {pack_s:.3f} s; {n_batches} batches of {TRAIN_BATCH} ({overhanging} chunks overhanging "
          f"a piece): the device slice equals the host loader's floats bit for bit, and the frames of the "
          f"slice, of the int16 link and of the host floats are equal")
    figures["slices"] = {"batches": n_batches, "overhanging": overhanging, "bytes": corpus_dd.nbytes,
                         "pack_s": pack_s}
    del model, corpus_dd

    # (c) the trainer on each route, one seed
    routes = {"device corpus": ["--deviceData", "on"],
              "int16 link": ["--deviceData", "off", "--linkInt16", "force"],
              "float32 link": ["--deviceData", "off", "--linkInt16", "off"]}
    runs = {}
    for name, route in routes.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        run = train_cli.main([os.path.join(tmp, f"ckpt_{name.replace(' ', '_')}.pt"), *train_args,
                              "--statsEvery", "4", "--ckptEvery", "1000", "--maxEpoch", "1",
                              "--stopAtStep", str(INPUT_STEPS), *route])
        torch.cuda.synchronize()
        got = counts()
        want = {**dict.fromkeys(KERNELS, 0), "semicrf_alpha": run["steps"] + run["val_batches"],
                "semicrf_beta": run["steps"] + run["val_batches"],
                "viterbi_bwd": 2 * run["stats_passes"] + run["val_batches"]}
        if run["steps"] != INPUT_STEPS or got != want or not np.isfinite(run["losses"]).all() \
                or run["device_data"] != (name == "device corpus"):
            raise AssertionError(f"path 9 (c) {name}: {run['steps']} steps, losses {run['losses']}, "
                                 f"device corpus {run['device_data']}, launches {got}, calls made {want}")
        for k in KERNELS:
            launches[k] += got[k]
        runs[name] = run
        print(f"path 9 (c) {name}, flagship V2 --batchSize {TRAIN_BATCH} ({card}): {run['steps']} steps, median "
              f"after the first: iteration {float(np.median(run['iter_seconds'][1:])):.4f} s, step "
              f"{float(np.median(run['step_seconds'][1:])):.4f} s (all: iteration "
              f"{[round(x, 4) for x in run['iter_seconds']]}, step {[round(x, 4) for x in run['step_seconds']]}); "
              f"peak memory {run['step_peak_bytes'] / 1e9:.4f} GB; corpus on the card "
              f"{run['device_data_bytes']} bytes; link {run['link_dtype']}; losses {run['losses']}; launches {got}")
    firsts = {name: run["losses"][0] for name, run in runs.items()}
    if len(set(firsts.values())) != 1:
        raise AssertionError(f"path 9 (c): the first step's loss differs between the routes: {firsts}")
    all_equal = len({tuple(run["losses"]) for run in runs.values()}) == 1
    print(f"path 9 (c): the first step's loss equal on the three routes bit for bit ({firsts['device corpus']!r}); "
          f"all {INPUT_STEPS} losses equal: {all_equal}")
    figures["train"] = {name: {k: run[k] for k in ("losses", "iter_seconds", "step_seconds", "step_peak_bytes",
                                                   "device_data_bytes", "link_dtype", "stats_seconds")}
                        for name, run in runs.items()}

    # (d) a one-hour corpus: packed, uploaded and sliced on the card
    rng = np.random.default_rng(SEED)
    hour = os.path.join(tmp, "hour")
    os.makedirs(hour)
    from scipy.io import wavfile

    paths = []
    for i in range(HOUR_PIECES):
        paths.append(os.path.join(hour, f"piece{i}.wav"))
        n = int(3600 / HOUR_PIECES * conf.fs)
        wavfile.write(paths[-1], conf.fs, rng.integers(-32768, 32768, size=n, dtype=np.int16))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the two things DeviceDataset reads of a dataset
    hour_dd = DeviceDataset(types.SimpleNamespace(data=paths, get_path=paths.__getitem__), n_chunk, device=dev)
    torch.cuda.synchronize()
    hour_s = time.perf_counter() - t0
    piece_idx = rng.integers(0, HOUR_PIECES, size=TRAIN_BATCH)
    begins = rng.uniform(-conf.segmentSizeInSecond, 3600 / HOUR_PIECES, size=TRAIN_BATCH)
    starts = hour_dd.starts_for(piece_idx, begins)
    sliced = hour_dd.slice_batch(starts)
    rows = hour_dd._data[:, 0].cpu().numpy()
    want = np.stack([rows[s: s + n_chunk] for s in starts])[..., None]
    if not torch.equal(sliced.cpu(), dequantize_int16(torch.from_numpy(want))):
        raise AssertionError("path 9 (d): slice_batch differs from the packed rows on the one-hour corpus")
    slice_ms = cuda_ms(lambda: hour_dd.slice_batch(starts), runs=20)
    slice_bound = bound(TRAIN_BATCH * n_chunk * (2 + 4), 0)
    print(f"path 9 (d) a one-hour mono corpus ({HOUR_PIECES} pieces, seeded) ({card}): {hour_dd.nbytes} bytes int16, "
          f"read, packed and uploaded in {hour_s:.3f} s ({hour_dd.nbytes / hour_s / 1e9:.2f} GB/s); slice_batch "
          f"of {TRAIN_BATCH} chunks of {n_chunk} samples {slice_ms:.4f} ms (CUDA events, median of 20, the "
          f"starts' upload included; bound {slice_bound[0]:.4f} ms by {slice_bound[1]})")
    figures["hour"] = {"bytes": hour_dd.nbytes, "pack_upload_s": hour_s, "slice_ms": slice_ms,
                       "slice_bound_ms": slice_bound[0]}
    del hour_dd, sliced, rows, want
    gc.collect()
    torch.cuda.empty_cache()

    # (e) two gloo ranks on the card, each with its own copy of the corpus
    in_path = os.path.join(tmp, "input_in.json")
    with open(in_path, "w") as f:
        json.dump({"tmp": tmp, "args": train_args}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        launch_ranks(lambda rank: [sys.executable, "-c",
                                   "import sys, chip_smoke; sys.exit(chip_smoke.input_rank(*sys.argv[1:]))",
                                   in_path, os.path.join(tmp, f"input_rank{rank}.json")],
                     2, local_rank=lambda rank: 0, cwd=here, timeout=300)
    except RuntimeError as e:
        raise AssertionError(f"path 9 ranks: {e}")
    wall = time.perf_counter() - t0
    ranks = []
    for rank in range(2):
        with open(os.path.join(tmp, f"input_rank{rank}.json")) as f:
            ranks.append(json.load(f))
    for r in ranks:
        dev_run, host_run = r["routes"]["device"], r["routes"]["host"]
        if not (r["frames_equal"] and r["params_equal_across_routes"] and dev_run["device_data"]
                and not host_run["device_data"] and dev_run["losses"] == host_run["losses"]
                and len(dev_run["losses"]) == 1 and np.isfinite(dev_run["losses"]).all()
                and all(x["params_equal_on_ranks"] and x["alpha"] == 1 and x["beta"] == 1
                        for x in (dev_run, host_run))):
            raise AssertionError(f"path 9 (e) rank {r['rank']}: {r}")
        for k in ("alpha", "beta"):
            launches["semicrf_" + k] += dev_run[k] + host_run[k]
        print(f"path 9 (e) rank {r['rank']}, --deviceData on, --batchSize {INPUT_RANK_BATCH} a rank, gloo on one "
              f"card ({card}): frames {dev_run['frames_shape']} equal the host route's bit for bit, loss "
              f"{dev_run['losses'][0]!r} equal, parameters after the step equal on both ranks and to the host "
              f"route's; step {dev_run['step_seconds'][0]:.4f} s (host route {host_run['step_seconds'][0]:.4f} s), "
              f"peak memory {dev_run['peak_gb']:.2f} GB (host route {host_run['peak_gb']:.2f}), corpus "
              f"{dev_run['device_data_bytes']} bytes a rank")
    if ranks[0]["routes"]["device"]["losses"] != ranks[1]["routes"]["device"]["losses"]:
        raise AssertionError("path 9 (e): the ranks report different losses")
    print(f"path 9 (e): ranks' wall {wall:.1f} s")
    figures["ranks"] = {"ranks": ranks, "wall_s": wall}
    return launches, figures


def orbax_path(dev, card, tmp, counts, reset_counts):
    """Path 10: the JAX package's orbax checkpoint into the port.  With no
    orbax, tensorstore, zstandard or JAX module loaded, the committed
    fixture is read by ``load_orbax_checkpoint`` (the port's zstd decoder,
    OCDBT reader and zarr assembly) and every leaf its ``.npz`` holds is
    held bit for bit; then ``cli.transcribe.main --weight DIR`` transcribes
    a seeded piece on the card, and the MIDI's notes must equal those of
    ``TransKun.transcribe`` on the card with ``state_dict_from_flax`` of the
    ``.npz``'s best params loaded, and the CLI run's launches the reference
    run's.  Returns the launches of each kernel on the path (the CLI run's)
    and its figures."""
    import torch
    from scipy.io import wavfile

    from transkun_tpu_torch.cli import transcribe as transcribe_cli
    from transkun_tpu_torch.data.audio import read_audio
    from transkun_tpu_torch.data.midi import read_midi, write_midi
    from transkun_tpu_torch.models.config import parse_conf_file
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.train.checkpoint import load_orbax_checkpoint, load_params
    from transkun_tpu_torch.utils.convert import state_dict_from_flax

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN_PACKAGES)
    if loaded:
        raise AssertionError(f"path 10: modules the port must not need are loaded: {loaded[:5]}")
    want = np.load(ORBAX_FIXTURE + ".npz")
    t0 = time.perf_counter()
    tree = load_orbax_checkpoint(ORBAX_FIXTURE)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_params(ORBAX_FIXTURE)
    params_s = time.perf_counter() - t0

    def flat(t, prefix=""):
        items = t.items() if isinstance(t, dict) else enumerate(t) if isinstance(t, list) else None
        if items is None:
            return [] if t is None else [(prefix, t)]
        return [x for k, v in items for x in flat(v, f"{prefix}/{k}" if prefix else str(k))]

    got = {k: np.asarray(v) for k, v in flat(tree)}
    n_bytes = sum(v.nbytes for v in got.values())
    if sorted(got) != sorted(want.files):
        raise AssertionError(f"path 10: the fixture's leaves {len(got)} and the .npz's {len(want.files)} differ")
    for key in want.files:
        if got[key].dtype != want[key].dtype or got[key].shape != want[key].shape \
                or got[key].tobytes() != want[key].tobytes():
            raise AssertionError(f"path 10: leaf {key} differs from the .npz")
    print(f"path 10 read: load_orbax_checkpoint of the fixture in {read_s:.3f} s ({len(got)} leaves, "
          f"{n_bytes} bytes; every one of the .npz's {len(want.files)} leaves equal bit for bit), "
          f"load_params (best_params alone) in {params_s:.3f} s; host of {card}")

    _, conf = parse_conf_file(ORBAX_FIXTURE + ".conf")
    wav, mid, ref_mid = (os.path.join(tmp, n) for n in ORBAX_FILES[:3])
    x = synth_piece(conf.fs, ORBAX_PIECE_SECONDS, SEED + 10)
    wavfile.write(wav, conf.fs, np.round(x[:, 0] * 32768).astype(np.int16))
    reset_counts()
    t0 = time.perf_counter()
    transcribe_cli.main([wav, mid, "--weight", ORBAX_FIXTURE, "--conf", ORBAX_FIXTURE + ".conf"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = counts()

    model = TransKun(conf, device=dev)
    model.load_state_dict(state_dict_from_flax(npz_subtree(want, "best_params"), conf))
    _, audio = read_audio(wav)
    reset_counts()
    ref_notes = model.transcribe(audio)
    torch.cuda.synchronize()
    ref_launches = counts()
    write_midi(ref_notes, ref_mid)
    notes = [(n.start, n.end, n.pitch, n.velocity) for n in read_midi(mid).notes]
    ref = [(n.start, n.end, n.pitch, n.velocity) for n in read_midi(ref_mid).notes]
    if notes != ref or not notes:
        raise AssertionError(f"path 10: the CLI's MIDI has {len(notes)} notes, the reference's {len(ref)}; "
                             f"equal: {notes == ref}")
    if launches != ref_launches or launches["viterbi_bwd"] == 0 or launches["decode_walk"] == 0:
        raise AssertionError(f"path 10: CLI launches {launches}, the reference run's {ref_launches}")
    print(f"path 10 notes: cli.transcribe --weight {os.path.basename(ORBAX_FIXTURE)} on a "
          f"{ORBAX_PIECE_SECONDS:.0f} s piece ({card}) in {cli_s:.2f} s: {len(notes)} notes, equal to "
          f"TransKun.transcribe with state_dict_from_flax of the .npz")
    print(f"path 10 launches: {launches}")
    figures = {"read_s": read_s, "load_params_s": params_s, "leaves": len(got), "bytes": n_bytes,
               "cli_s": cli_s, "notes": len(notes), "launches": launches}
    return launches, figures


def npz_subtree(npz, prefix):
    """The nested dict of the ``.npz`` leaves under ``prefix`` (keys joined
    by '/')."""
    tree = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            node = tree
            *parents, leaf = key[len(prefix) + 1:].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]
    return tree


def file_hashes(root):
    """sha256 of every file under ``root``, by path."""
    import hashlib

    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def orbax_resume(dev, card, tmp, counts, reset_counts):
    """Path 10 (c): the JAX run of the fixture continued on the card by
    ``cli.train.main``.  Before the first step the restored state on the card
    (params, AdaBelief's moments and count, the clip ring and count, the
    step) and the best params equal the ``.npz`` bit for bit; the run prints
    the resume lines, takes ``ORBAX_RESUME_STEPS`` finite steps with a stats
    pass each and saves ``<copy>.pt`` (step and both counts advanced,
    ``extra`` carried over), and no file of the copied directory changes; a
    second run resumes from the ``.pt``, and ``cli.transcribe --weight
    <copy>.pt`` writes (b)'s notes for (b)'s piece (the best params went
    through unchanged).  Returns the launches of the three runs and the
    figures."""
    import contextlib
    import io
    import shutil

    import torch

    from transkun_tpu_torch.cli import train as train_cli
    from transkun_tpu_torch.cli import transcribe as transcribe_cli
    from transkun_tpu_torch.data.midi import read_midi
    from transkun_tpu_torch.models.config import parse_conf_file
    from transkun_tpu_torch.train import checkpoint as ckpt_mod
    from transkun_tpu_torch.utils.convert import state_dict_from_flax

    want = np.load(ORBAX_FIXTURE + ".npz")
    _, conf = parse_conf_file(ORBAX_FIXTURE + ".conf")
    run = os.path.join(tmp, "orbax_run")
    shutil.copytree(ORBAX_FIXTURE, run)
    corpus = os.path.join(tmp, "orbax_corpus")
    pickles = build_corpus(corpus, int(conf.fs), SEED + 11)
    step0 = int(want["step"])
    before = file_hashes(run)

    expected = {name: state_dict_from_flax(npz_subtree(want, prefix), conf) for name, prefix in
                (("params", "params"), ("best", "best_params"), ("mu", "opt_state/0/mu"),
                 ("nu", "opt_state/0/nu"))}
    figures = {}
    read, restore = ckpt_mod.load_orbax_checkpoint, ckpt_mod.restore_train_state_from_orbax

    def timed_read(path, *a, **kw):
        t0 = time.perf_counter()
        tree = read(path, *a, **kw)
        figures["read_s"] = time.perf_counter() - t0
        return tree

    def checked_restore(state, tree, conf_):
        t0 = time.perf_counter()
        ckpt = restore(state, tree, conf_)
        torch.cuda.synchronize()
        figures["restore_s"] = time.perf_counter() - t0
        # the state the first step starts from, on the card, against the .npz
        live = {"params": dict(state.model.module.named_parameters()), "mu": state.optimizer.mu,
                "nu": state.optimizer.nu, "best": ckpt["best_state_dict"]}
        n = 0
        for name, tensors in live.items():
            if sorted(tensors) != sorted(expected[name]):
                raise AssertionError(f"path 10 (c): the restored {name} has other keys than the .npz's")
            for key, value in tensors.items():
                ref = expected[name][key]
                if name != "best" and value.device.type != "cuda":
                    raise AssertionError(f"path 10 (c): restored {name} {key} is on {value.device}")
                if value.dtype != torch.float32 or value.shape != ref.shape or not torch.equal(
                        value.detach().view(torch.int32), ref.to(value.device).view(torch.int32)):
                    raise AssertionError(f"path 10 (c): restored {name} {key} differs from the .npz")
                n += 1
        scalars = {"opt_state/0/count": state.optimizer.count, "opt_state/2/count": state.optimizer.count,
                   "clip_count": state.clip.count}
        for key, value in scalars.items():
            if value.device.type != "cuda" or value.dtype != torch.int32 or int(value) != int(want[key]):
                raise AssertionError(f"path 10 (c): restored {key} {value} against the .npz's {want[key]}")
        if not torch.equal(state.clip.buffer, torch.from_numpy(want["clip_buffer"]).to(dev)) \
                or state.clip.buffer.device.type != "cuda" or state.step != step0:
            raise AssertionError("path 10 (c): the restored clip ring or step differs from the .npz")
        figures["leaves_checked"] = n + len(scalars) + 2
        return ckpt

    args = [run, "--datasetPath", corpus,
            "--datasetMetaFile_train", os.path.join(pickles, "train.pickle"),
            "--datasetMetaFile_val", os.path.join(pickles, "val.pickle"),
            "--modelConf", ORBAX_FIXTURE + ".conf", "--batchSize", str(ORBAX_RESUME_BATCH),
            "--statsEvery", "1", "--logEvery", "1", "--dataLoaderWorkers", "0", "--seed", "7"]
    ckpt_mod.load_orbax_checkpoint, ckpt_mod.restore_train_state_from_orbax = timed_read, checked_restore
    out = io.StringIO()
    try:
        reset_counts()
        with contextlib.redirect_stdout(out):
            record = train_cli.main(args + ["--stopAtStep", str(step0 + ORBAX_RESUME_STEPS)])
        torch.cuda.synchronize()
        launches = counts()
    finally:
        ckpt_mod.load_orbax_checkpoint, ckpt_mod.restore_train_state_from_orbax = read, restore
    text = out.getvalue()
    print(text, end="")
    lines = ["resuming from checkpoint...",
             f"resuming from the JAX package's orbax checkpoint {run}; saving to {run}.pt"]
    if any(line not in text.splitlines() for line in lines) or "leaves_checked" not in figures:
        raise AssertionError("path 10 (c): the run did not resume from the copied fixture")
    losses = record["losses"]
    if record["steps"] != ORBAX_RESUME_STEPS or not np.isfinite(losses).all() \
            or record["stats_passes"] != ORBAX_RESUME_STEPS:
        raise AssertionError(f"path 10 (c): {record['steps']} steps, {record['stats_passes']} stats passes, "
                             f"losses {losses}")
    saved = ckpt_mod.load_checkpoint(run + ".pt")
    train_losses = [float(want[k]) for k in sorted(want.files) if k.startswith("extra/loss_tracker/train/")]
    carried = {"loss_tracker": {"train": train_losses, "val": []}, "epoch": int(want["extra/epoch"]),
               "run_seed": int(want["extra/run_seed"]), "warmstart_from": str(want["extra/warmstart_from"])}
    if saved["step"] != step0 + ORBAX_RESUME_STEPS \
            or int(saved["optimizer"]["count"]) != int(want["opt_state/0/count"]) + ORBAX_RESUME_STEPS \
            or int(saved["clip_count"]) != int(want["clip_count"]) + ORBAX_RESUME_STEPS \
            or saved["extra"] != carried:
        raise AssertionError(f"path 10 (c): the .pt holds step {saved['step']}, count "
                             f"{int(saved['optimizer']['count'])}, clip count {int(saved['clip_count'])}, "
                             f"extra {saved['extra']}")
    # the stats pass decodes through kernel 1 and walks on the host, as the JAX trainer's
    if launches["semicrf_alpha"] != ORBAX_RESUME_STEPS or launches["semicrf_beta"] != ORBAX_RESUME_STEPS \
            or launches["viterbi_bwd"] == 0:
        raise AssertionError(f"path 10 (c): launches {launches}")
    print(f"path 10 (c) restore: load_orbax_checkpoint of the fixture {figures['read_s']:.3f} s, "
          f"restore_train_state_from_orbax onto the card {figures['restore_s']:.3f} s (host of {card}); "
          f"{figures['leaves_checked']} restored leaves equal to the .npz bit for bit before the first step")
    print(f"path 10 (c) steps {step0}-{step0 + ORBAX_RESUME_STEPS - 1} at batch {ORBAX_RESUME_BATCH} ({card}): "
          f"losses {losses}, step s {record['step_seconds']}, iteration s {record['iter_seconds']}, "
          f"stats pass s {record['stats_seconds']}, peak {record['step_peak_bytes'] / 2**30:.2f} GB")

    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        again = train_cli.main(args + ["--stopAtStep", str(step0 + ORBAX_RESUME_STEPS + 1)])
    torch.cuda.synchronize()
    second = counts()
    text = out.getvalue()
    print(text, end="")
    if f"resuming from checkpoint {run}.pt; saving to {run}.pt" not in text.splitlines() \
            or again["steps"] != 1 or ckpt_mod.load_checkpoint(run + ".pt")["step"] != step0 + 3:
        raise AssertionError("path 10 (c): the second run did not resume from the .pt")
    after = file_hashes(run)
    changed = sorted(k for k in set(before) | set(after) if after.get(k) != before.get(k))
    if changed or os.path.lexists(run + ".new") or os.path.lexists(run + ".old"):
        raise AssertionError(f"path 10 (c): the copied JAX checkpoint changed: {changed[:5]}")
    print(f"path 10 (c): the second run resumed from {os.path.basename(run)}.pt for one step; "
          f"the {len(before)} files of the copied directory kept their hashes")

    wav, cli_mid, _, resumed_mid = (os.path.join(tmp, n) for n in ORBAX_FILES)
    reset_counts()
    t0 = time.perf_counter()
    transcribe_cli.main([wav, resumed_mid, "--weight", run + ".pt", "--conf", ORBAX_FIXTURE + ".conf"])
    torch.cuda.synchronize()
    figures["transcribe_s"] = time.perf_counter() - t0
    third = counts()
    notes, want_notes = ([(n.start, n.end, n.pitch, n.velocity) for n in read_midi(m).notes]
                         for m in (resumed_mid, cli_mid))
    if notes != want_notes or not notes or third["viterbi_bwd"] == 0 or third["decode_walk"] == 0:
        raise AssertionError(f"path 10 (c): --weight {os.path.basename(run)}.pt gave {len(notes)} notes, "
                             f"(b) {len(want_notes)}; launches {third}")
    print(f"path 10 (c): cli.transcribe --weight {os.path.basename(run)}.pt on (b)'s piece ({card}) in "
          f"{figures['transcribe_s']:.2f} s: {len(notes)} notes, equal to (b)'s")
    print(f"path 10 (c) launches: {launches}, then {second}, then {third}")
    figures.update(steps=record["steps"], losses=losses, step_seconds=record["step_seconds"],
                   iter_seconds=record["iter_seconds"], stats_seconds=record["stats_seconds"],
                   launches=launches, second_launches=second, transcribe_launches=third)
    return {k: launches[k] + second[k] + third[k] for k in launches}, figures


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose streaming attention kernels "
                                     "are the first version (no plan in their C interface), timed beside "
                                     "these in turns; with a later interface they are said and skipped")
    parent = ap.parse_args().parent
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
        _build, attention, frontend, logz, mlp, semicrf, softmax, viterbi, walk,
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
        """Launches since the last reset; the attention kernels' tensor-core
        and general variants under their names, the streaming variants
        apart."""
        fwd, bwd = attention.fwd_launches_by_variant, attention.bwd_launches_by_variant
        return {"viterbi_bwd": viterbi.launches, "semicrf_alpha": logz.alpha_launches,
                "semicrf_beta": logz.beta_launches,
                "attention_fwd": fwd["mma"] + fwd["general"],
                "attention_bwd": bwd["mma"] + bwd["general"], "fused_mlp": mlp.launches,
                "softmax_fwd": softmax.fwd_launches, "softmax_bwd": softmax.bwd_launches,
                "decode_walk": walk.launches, "attention_fwd_stream": fwd["stream"],
                "attention_bwd_stream": bwd["stream"]}

    def reset_counts():
        viterbi.launches = logz.alpha_launches = logz.beta_launches = 0
        mlp.launches = softmax.fwd_launches = softmax.bwd_launches = walk.launches = 0
        attention.reset_launches()

    by_path = {}  # launches of each kernel on each path

    # -- build, one nvcc per source, all at once -------------------------------
    t0 = time.perf_counter()
    parent_stream = None  # the parent's streaming attention kernels, built beside ours
    if parent is not None:
        from concurrent.futures import ThreadPoolExecutor

        parent_tmp = tempfile.TemporaryDirectory()
        pool = ThreadPoolExecutor(max_workers=1)
        parent_stream = pool.submit(parent_attention, parent, parent_tmp.name, dev)
        pool.shutdown(wait=False)  # the build runs on beside ours; its result is taken below
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
    plans = dict.fromkeys(KERNELS)  # kernels 1-3: the plan at the main path's shape, by dtype
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
                   "semicrf_alpha": f"alpha_tma_kernelI{kind}E",
                   "semicrf_beta": f"lse_cluster_kernelILb0E{kind}E"}[name]
        regs = [r for k, r in registers.items() if pattern in k]
        ring = (f", a TMA ring of {plan.stages} stages of 8 ends x {plan.rows} begins (box "
                f"{list(plan.box)}, element strides {list(plan.element_strides)})") if plan.stages else ""
        print(f"launch plan {name} {list(s.shape)} {str(s.dtype)[6:]} ({card}): {plan.groups} lane groups "
              f"of {plan.lanes} lanes x clusters of {plan.cluster} = {plan.ctas} CTAs of {plan.threads} "
              f"threads ({n_sm} SMs), {plan.smem} B shared memory, {regs[0] if regs else '?'} registers "
              f"a thread (ptxas){ring}")
        return {"lanes": plan.lanes, "row_bytes": plan.row_bytes, "cluster": plan.cluster,
                "ctas": plan.ctas, "smem": plan.smem, "tma_stages": plan.stages}

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
                plan = plan_line("viterbi_bwd", viterbi.card_plan(args[0]), args[0])
                if (t, nbp) == (691, 128):
                    plans["viterbi_bwd"] = {**(plans["viterbi_bwd"] or {}), tag: plan}
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
            for name, plan_of in (("semicrf_alpha", logz.alpha_card_plan), ("semicrf_beta", logz.beta_card_plan)):
                plans[name] = {**(plans[name] or {}), tag: plan_line(name, plan_of(s), s)}
            # alpha at every cluster size its plan allows (a box traverses 32 * C <= 256 begins)
            want = logz.alpha_table_padded_plain(s, shift, spdiag)
            for c in range(1, 9):
                before = logz.alpha_launches
                got, again = (logz.alpha_table_padded_cuda(s, shift, spdiag, cluster=c) for _ in range(2))
                torch.cuda.synchronize()
                diff = (got - want).abs()
                if logz.alpha_launches != before + 2 or not torch.equal(got, again) or bool(
                        (diff > TABLE_RTOL * want.abs().clamp(min=1.0)).any()):
                    raise AssertionError(f"semicrf_alpha != plain at {list(s.shape)} {tag} cluster {c}: "
                                         f"max |diff| {float(diff.max())}, two runs equal "
                                         f"{torch.equal(got, again)}, launches {logz.alpha_launches - before}")
                into = err if fp32 else bf16["semicrf_alpha"]
                key = "semicrf_alpha" if fp32 else "max_abs_err"
                into[key] = max(into[key], float(diff.max()))
            print(f"semicrf_alpha [696,696,384] {tag}: within {TABLE_RTOL}*max(1,|plain|) of plain at "
                  f"every cluster size 1-8, two runs the same bits")
            del want, got, again, diff
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
        # the cluster edges of each kernel's plan (one lane group, more lane
        # groups than SMs) and Tp = 125: the last block (t = 0 .. 4) part full
        edges = []
        for name, plan_of, kernel, plain in (
                ("semicrf_alpha", logz.alpha_launch_plan, logz.alpha_table_padded_cuda,
                 logz.alpha_table_padded_plain),
                ("semicrf_beta", logz.launch_plan, logz.beta_table_padded_cuda, logz.beta_table_padded_plain)):
            lanes = plan_of(696, 384, dtype, n_sm).lanes
            for t, nbp in ((123, lanes), (61, 2 * n_sm * lanes), (125, 256)):
                s, shift, noise, spdiag = table_inputs(rng, t, nbp, nbp, dev)
                if t == 125:
                    s, shift, noise, spdiag = (a[:125].contiguous() if a.dim() == 2 else a[:125, :125].contiguous()
                                               for a in (s, shift, noise, spdiag))
                s, shift, noise, spdiag = (s, shift, noise, spdiag) if fp32 else table_bf16(s, shift, noise, spdiag)
                rows = shift if name == "semicrf_alpha" else noise
                got, again, want = kernel(s, rows, spdiag), kernel(s, rows, spdiag), plain(s, rows, spdiag)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                if bool((diff > TABLE_RTOL * want.abs().clamp(min=1.0)).any()) or not torch.equal(got, again):
                    raise AssertionError(f"{name} != plain at {list(s.shape)} {tag}: max |diff| "
                                         f"{float(diff.max())}, two runs equal {torch.equal(got, again)}")
                into, key = (err, name) if fp32 else (bf16[name], "max_abs_err")
                into[key] = max(into[key], float(diff.max()))
                if t != 125:
                    plan_line(name, (logz.alpha_card_plan if name == "semicrf_alpha" else logz.beta_card_plan)(s), s)
                edges.append(list(s.shape))
                del s, shift, noise, spdiag, got, again, want
        a_err, b_err = ((err["semicrf_alpha"], err["semicrf_beta"]) if fp32 else
                        (bf16["semicrf_alpha"]["max_abs_err"], bf16["semicrf_beta"]["max_abs_err"]))
        print(f"alpha/beta {tag} within {TABLE_RTOL}*max(1,|plain|) of plain, two runs the same bits, at "
              f"[696,696,384] and [128,128,256], and at the edges {edges} (alpha, then beta): "
              f"max |diff| alpha {a_err:.3g}, beta {b_err:.3g}")
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

    # the streaming kernels (kernels 4s and 5s, for the 0All and FT branches'
    # 13261 keys, past the general kernels' shared memory) at every shape
    # path 7 gives them, fp32 and bf16: check_attention's rules (the library
    # must pick them by itself), the plan printed (0All's keys split across
    # more than one block), the same bits (two forward runs; the backward
    # with and without the forward's statistics), and timed beside the
    # plain versions and SDPA with the exp floor; with --parent, beside that
    # checkout's streaming kernels in turns (parent, this, this, parent)
    # after they are held to the same bounds.  The kernels line carries FT's.
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = max_sm_clock_mhz()
    parent_fwd, parent_bwd = (parent_stream and parent_stream.result()) or (None, None)
    stream_extra = {"attention_fwd_stream": {}, "attention_bwd_stream": {}}  # times at each shape
    exp_floors = {}  # the FT fp32 exp floor of each, beside its bound in the kernels line
    for name in stream_extra:
        err[name] = 0.0
        bf16[name] = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for tag, ((b, sq, d), skv) in STREAM_SHAPES.items():
            q, k, v, do = attention_inputs(rng, b, sq, skv, d, dev, dtype)
            fwd_err, bwd_err, o = check_attention(attention, q, k, v, do, ATTN_HEADS, "stream")
            for name, e in (("attention_fwd_stream", fwd_err), ("attention_bwd_stream", bwd_err)):
                into, at = (err, name) if dtype == torch.float32 else (bf16[name], "max_abs_err")
                into[at] = max(into[at], e)
            check_stream_bits(attention, q, k, v, do, ATTN_HEADS)
            dh = d // ATTN_HEADS
            plan = attention.stream_plan(b, ATTN_HEADS, sq, skv, dh, dtype, n_sm)
            if tag.startswith("0All") and plan.splits < 2:
                raise AssertionError(f"{tag}: the keys are not split across blocks: {plan}")
            plan_fig = {f: getattr(plan, f) for f in ("warps", "q_tiles", "splits", "per_split", "grid",
                                                      "keys_grid", "combine_grid", "fwd_smem",
                                                      "rows_smem", "keys_smem")}
            timed = time_stream(attention, q, k, v, do, ATTN_HEADS, n_sm, mhz)
            turns = None
            if parent_fwd is not None:
                turns = parent_turns(attention, parent_fwd, parent_bwd, q, k, v, do, ATTN_HEADS)
            for name, side in (("attention_fwd_stream", "fwd"), ("attention_bwd_stream", "bwd")):
                k_ms, p_ms, lib_ms, bnd, core_ms, floor, dev_ms = timed[side]
                stream_extra[name][f"{tag} {str(dtype)[6:]}"] = {
                    "q": [b, sq, d], "skv": skv, "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
                    "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                    "cuda_core_bound_ms": core_ms, "exp_floor_ms": floor, "plan": plan_fig,
                    **({"turns": turns[side]} if turns else {})}
                if tag == "FT":  # the kernels line
                    plans[name] = {**(plans[name] or {}), str(dtype)[6:]: plan_fig}
                    if dtype == torch.float32:
                        ms[name], plain_ms[name], library_ms[name], bounds[name] = timed[side][:4]
                        device_ms[name], exp_floors[name] = dev_ms, floor
                    else:
                        bf16[name].update(zip(("ms", "plain_ms", "library_ms", "bound", "device_ms",
                                               "exp_floor_ms"), (k_ms, p_ms, lib_ms, bnd, dev_ms, floor)))
                print(f"streaming attention {'forward' if side == 'fwd' else 'backward'} {tag} "
                      f"q {[b, sq, d]} x {skv} keys, {ATTN_HEADS} heads, {str(dtype)[6:]} ({card}): "
                      f"kernel {k_ms:.4f} ms (device {dev_ms:.4f} ms a call over {DEVICE_LAUNCHES} queued "
                      f"calls), plain {p_ms:.4f} ms, "
                      f"SDPA{'' if side == 'fwd' else ' backward'} "
                      f"{lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; the CUDA cores' fp32 rate "
                      f"{core_ms:.4f} ms), share {bnd[0] / k_ms:.1%}; exp floor {floor:.4f} ms "
                      f"({n_sm} SMs x {SFU_EXPS_A_CLOCK} a clock at {mhz:.0f} MHz), share of the "
                      f"larger {max(bnd[0], floor) / k_ms:.1%}"
                      + (f"; in turns parent {turns[side]['parent']} ms, this {turns[side]['this']} ms"
                         if turns else ""))
            print(f"streaming plan {tag} {str(dtype)[6:]}: {plan_fig}")
            del q, k, v, do, o
            torch.cuda.empty_cache()
    print(f"streaming attention vs plain at {dict(STREAM_SHAPES)} ({ATTN_HEADS} heads): fp32 max |diff| "
          f"{err['attention_fwd_stream']:.3g} (forward, allowed {FWD_ATOL}) and "
          f"{err['attention_bwd_stream']:.3g} (dq, dk, dv, allowed {BWD_ATOL}); bf16 "
          f"{bf16['attention_fwd_stream']['max_abs_err']:.3g} and "
          f"{bf16['attention_bwd_stream']['max_abs_err']:.3g} (one bf16 spacing of each output's "
          f"largest value); the backward's two runs equal bit for bit, two forward runs equal, the "
          f"backward with and without the forward's statistics equal"
          + ("; the parent's streaming kernels within the same bounds" if parent_fwd else ""))

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
    group = transkun_module.DEFAULT_SEGMENT_BATCH
    default_budget = transkun_module.DECODE_EVENTS_PER_SEGMENT * group

    def n_segments(n_samples):
        return math.ceil((n_samples + 2 * pad) / step)

    def want_launches(model, n_seg):
        """One transcription's launches: a Viterbi launch a segment and a walk
        launch a group on the default route, and a Viterbi launch more for
        each segment that the host-walk route redid, from the group it
        resumed from."""
        fallback = model.last_transcribe_fallback_from
        redone = 0 if fallback is None else n_seg - fallback * group
        return {**dict.fromkeys(KERNELS, 0), "viterbi_bwd": n_seg + redone,
                "decode_walk": -(-n_seg // group)}

    def route_line(model):
        fallback = model.last_transcribe_fallback_from
        budget = model.decode_k_budget or default_budget
        return (f"group counts {model.last_transcribe_group_counts} against the budget {budget}, "
                + ("no fallback" if fallback is None else
                   f"the host-walk route taken from group {fallback} on (overflow flag)"))

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

    def check_same_notes(got, want, what):
        equal, worst = same_notes(got, want)
        if not equal:
            raise AssertionError(f"{what}: {len(got)} notes against {len(want)}, largest time "
                                 f"difference {worst} s")
        return worst

    n_seg = n_segments(audio.shape[0])
    long_audio = np.tile(audio, (LONG_PIECE_TILES, 1))
    long_seconds, n_long = LONG_PIECE_TILES * PIECE_SECONDS, n_segments(long_audio.shape[0])

    # the default budget first: the dense synthetic piece may overflow it; the
    # timed runs then take the next power of two above the largest group count
    # of both pieces
    model.transcribe(audio)
    default_from, short_counts = model.last_transcribe_fallback_from, model.last_transcribe_group_counts
    model.transcribe(long_audio)
    long_counts = model.last_transcribe_group_counts
    top = max(short_counts + long_counts)
    if default_from is not None or model.last_transcribe_fallback_from is not None:
        model.decode_k_budget = 1 << top.bit_length()
        print(f"default budget {default_budget} ({transkun_module.DECODE_EVENTS_PER_SEGMENT} a "
              f"segment x {group}): group counts {short_counts} ({PIECE_SECONDS:.0f} s), largest "
              f"{max(long_counts)} ({long_seconds:.0f} s); the host-walk route was taken from group "
              f"{default_from} ({PIECE_SECONDS:.0f} s) and {model.last_transcribe_fallback_from} "
              f"({long_seconds:.0f} s): the timed runs set decode_k_budget = {model.decode_k_budget}, "
              f"the next power of two above the largest count")
    budget = model.decode_k_budget

    # the default route, timed: it must not fall back
    notes, wall, peak_gb, by_path["transcribe"] = timed_transcription(model)
    if model.last_transcribe_fallback_from is not None \
            or by_path["transcribe"] != want_launches(model, n_seg):
        raise AssertionError(f"transcription launches {by_path['transcribe']} for {n_seg} segments; "
                             + route_line(model))
    check_notes(notes, n_seg)
    print(f"transcribe {PIECE_SECONDS:.0f} s, {n_seg} segments in groups of {group}, default route "
          f"({card}): wall {wall:.3f} s, RTF {PIECE_SECONDS / wall:.1f}x, peak memory {peak_gb:.2f} GB, "
          f"{len(notes)} notes, launches {by_path['transcribe']}; {route_line(model)}")

    # the host-walk route from the first group (a budget of 1): the same notes
    model.decode_k_budget = 1
    host_notes, host_wall, host_peak_gb, host_launches = timed_transcription(model)
    if model.last_transcribe_fallback_from != 0 or host_launches != want_launches(model, n_seg):
        raise AssertionError(f"host-walk route launches {host_launches}; " + route_line(model))
    worst = check_same_notes(notes, host_notes, "default route against the host-walk route")
    for name in KERNELS:
        by_path["transcribe"][name] += host_launches[name]
    print(f"transcribe {PIECE_SECONDS:.0f} s, host-walk route (decode_k_budget = 1) ({card}): wall "
          f"{host_wall:.3f} s, RTF {PIECE_SECONDS / host_wall:.1f}x, peak memory {host_peak_gb:.2f} GB "
          f"(default route {wall:.3f} s, {peak_gb:.2f} GB); notes equal the default route's "
          f"(largest time difference {worst:.3g} s); launches {host_launches}")
    model.decode_k_budget = budget

    # the same piece several times over: device memory must not grow with the
    # piece (both pieces are longer than two groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    long_notes = model.transcribe(long_audio)
    torch.cuda.synchronize()
    long_wall, long_peak_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 1e9
    long_launches = counts()
    if model.last_transcribe_fallback_from is not None or long_launches != want_launches(model, n_long):
        raise AssertionError(f"long transcription launches {long_launches} for {n_long} segments; "
                             + route_line(model))
    for name in KERNELS:
        by_path["transcribe"][name] += long_launches[name]
    check_notes(long_notes, n_long)
    print(f"transcribe {long_seconds:.0f} s, {n_long} segments in groups of {group} ({card}): wall "
          f"{long_wall:.3f} s, RTF {long_seconds / long_wall:.1f}x, peak memory {long_peak_gb:.3f} GB "
          f"against {peak_gb:.3f} GB for {PIECE_SECONDS:.0f} s ({n_seg} segments), {len(long_notes)} notes")
    if min(n_seg, n_long) <= 2 * group or abs(long_peak_gb - peak_gb) > PEAK_RTOL * peak_gb:
        raise AssertionError(f"peak memory {long_peak_gb} GB for {n_long} segments against {peak_gb} GB "
                             f"for {n_seg}: it grows with the piece (groups of {group})")

    # the mid-piece fallback: the default budget again if it overflowed, else
    # a budget that the first group fits and a later one does not, on the first
    # piece whose counts allow one; the notes must equal the route's above
    for label, x, n, counts_, ref in ((f"{PIECE_SECONDS:.0f} s", audio, n_seg, short_counts, notes),
                                      (f"{long_seconds:.0f} s", long_audio, n_long, long_counts, long_notes)):
        if default_from is None and max(counts_[1:]) <= counts_[0]:
            continue
        model.decode_k_budget = None if default_from is not None else max(counts_[1:]) - 1
        reset_counts()
        mid_notes = model.transcribe(x)
        torch.cuda.synchronize()
        mid_launches = counts()
        fallback = model.last_transcribe_fallback_from
        if fallback is None or mid_launches != want_launches(model, n):
            raise AssertionError(f"mid-piece fallback launches {mid_launches}; " + route_line(model))
        worst = check_same_notes(mid_notes, ref, "mid-piece fallback against the route without one")
        for name in KERNELS:
            by_path["transcribe"][name] += mid_launches[name]
        how = "the default budget" if default_from is not None else "a budget the first group fits"
        print(f"transcribe {label}, mid-piece fallback ({how}): {route_line(model)}; notes equal those without the fallback (largest time difference "
              f"{worst:.3g} s); launches {mid_launches}")
        break
    else:
        print("no piece's group counts allow a mid-piece fallback: not shown on the card")
    model.decode_k_budget = budget
    del long_audio, long_notes

    # the dispatch waits for nothing: no synchronizing call while a piece is enqueued
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            plan = model._transcribe_dispatch(audio, None, None, False, "hamming", None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    if syncs:
        raise AssertionError(f"the dispatch synchronized {len(syncs)} times: {syncs[:3]}")
    model._transcribe_finish(plan)
    del plan
    print("dispatch of the piece under torch.cuda.set_sync_debug_mode('warn'): no synchronizing call")

    # transcribe_many over copies of the piece against as many transcribe calls,
    # in turns: the same notes in order
    n_many = 4
    walls = {"sequential": [], "transcribe_many": []}
    for kind in ("sequential", "transcribe_many", "transcribe_many", "sequential"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if kind == "sequential":
            results = [model.transcribe(audio) for _ in range(n_many)]
        else:
            results = list(model.transcribe_many(audio for _ in range(n_many)))
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
        if len(results) != n_many or counts() != {k: n_many * v for k, v in want_launches(model, n_seg).items()}:
            raise AssertionError(f"{kind}: {len(results)} results, launches {counts()}")
        for got in results:
            check_same_notes(got, notes, f"{kind} against transcribe")
        if kind == "transcribe_many":
            for name in KERNELS:
                by_path["transcribe"][name] += counts()[name]
    print(f"transcribe_many over {n_many} copies of the {PIECE_SECONDS:.0f} s piece ({card}): wall "
          f"{[round(x, 4) for x in walls['transcribe_many']]} s against {n_many} transcribe calls "
          f"{[round(x, 4) for x in walls['sequential']]} s (in turns: sequential, many, many, "
          f"sequential); every piece's notes equal transcribe's, in order")

    # -- the walk kernel against its plain version: path 1's real tables ------
    lfi = round(seg_size / conf.hopSize)
    step_frames = step // conf.hopSize
    start0 = math.floor((conf.segmentSizeInSecond - conf.segmentHopSizeInSecond) * conf.fs / conf.hopSize)
    audio_dev = torch.from_numpy(np.pad(audio.T, ((0, 0), (pad, pad + seg_size)))).to(dev)
    seg_starts = list(range(0, audio.shape[0] + 2 * pad, step))
    groups = [seg_starts[g : g + group] for g in range(0, len(seg_starts), group)]
    err["decode_walk"] = 0
    walk_cases, overflowed, plain_cpu_s, host_walk_s, walk_plans = 0, False, [], [], {}

    def check_walk(tables, start, k_max, onset_bound=-1, plain_on_card=False, timed=True):
        """Kernel (twice, begins and ends each time on memory that held a
        sentinel in every slot) against the plain version on the CPU (on
        the card where its one-hot is too large for the host; ``timed``
        keeps the CPU's time): every output equal as integers.  Returns the
        kernel's outputs."""
        nonlocal walk_cases
        geometry = (k_max, lfi, step_frames, onset_bound)
        n_w, t_w, p_w = tables[1].shape
        n_edge = tables[2].shape[-1]
        plan = walk.launch_plan(n_w, t_w, p_w, k_max, n_edge)
        if walk._library().decode_walk_smem_bytes(t_w, plan.tile, plan.slots, plan.buffered, k_max,
                                                  n_edge) != plan.smem:
            raise AssertionError(f"decode_walk shared memory: the kernel's count differs from {plan}")
        walk_plans[f"n={n_w} t={t_w} P={p_w} k_max={k_max}"] = (
            f"{plan.blocks} CTAs of {plan.tile} tracks, {plan.slots} segments staged, events "
            f"{'buffered' if plan.buffered else 'to global memory'}, {plan.smem} bytes")
        before = walk.launches
        got, again = (walk_on_sentinel(walk, *tables, start, *geometry) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plain_on_card:
            want = walk.walk_group_plain(*tables, start, *geometry)
        else:
            want = walk.walk_group_plain(*(a.cpu() for a in tables), start.cpu(), *geometry)
            if timed:
                plain_cpu_s.append(time.perf_counter() - t0)
        for g, a, w in zip(got, again, want):
            if walk.launches != before + 2 or g.dtype != w.dtype or not torch.equal(g, a) \
                    or not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"decode_walk != plain at n={n_w}, P={p_w}, k_max {k_max}, "
                                     f"onset_bound {onset_bound}: max |diff| "
                                     f"{int((g.cpu().long() - w.cpu().long()).abs().max())}, two runs equal "
                                     f"{torch.equal(g, a)}")
        walk_cases += 1
        return got

    real_tables, carried = [], torch.full((90,), start0, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for g, grp in enumerate(groups):
            ptr, diag, bpres, ctx = model._group_tables(audio_dev, grp, seg_size, lfi)
            del ctx
            tables = (ptr, diag, bpres)
            if g == 0:
                real_tables = tables
            start_in = carried
            carried = check_walk(tables, start_in, model.decode_k_max)[4]
            # random forced starts, an onset bound, and a capacity the tables overflow
            t = diag.shape[1]
            rand = torch.from_numpy(rng.integers(0, t, size=90).astype(np.int32)).to(dev)
            check_walk(tables, rand, model.decode_k_max)
            check_walk(tables, start_in, model.decode_k_max, onset_bound=step_frames)
            overflowed |= bool(check_walk(tables, start_in, WALK_SMALL_K)[3].any())
            # the host route's chain from the same start ends where the kernel's does
            t0 = time.perf_counter()
            np_tables = [a.cpu().numpy() for a in tables]
            _, host_next = transkun_module.host_chain(*np_tables, start_in.tolist(), lfi, step_frames)
            host_walk_s.append(time.perf_counter() - t0)
            if host_next != carried.tolist():
                raise AssertionError(f"group {g}: the kernel's next start differs from the host walk's")
    if not overflowed:
        raise AssertionError(f"k_max {WALK_SMALL_K} did not overflow on the real tables")
    del audio_dev
    # group 0's real tables cut to the plan's edges: 89 tracks (the last tile
    # holds one); one segment; and a k_max whose buffer does not fit (events
    # to global memory)
    start_dev = torch.full((90,), start0, dtype=torch.int32, device=dev)
    ptr0, diag0, bpres0 = real_tables
    ragged = (ptr0[..., :89].contiguous(), diag0[..., :89].contiguous(), bpres0[:, :89].contiguous())
    check_walk(ragged, start_dev[:89].contiguous(), model.decode_k_max, timed=False)
    check_walk(tuple(a[:1] for a in real_tables), start_dev, model.decode_k_max, timed=False)
    check_walk(real_tables, start_dev, WALK_GLOBAL_K, plain_on_card=True, timed=False)
    n_g, t_g = diag0.shape[:2]
    routes = [walk.launch_plan(n_g, t_g, p_r, k_r, bpres0.shape[-1])
              for p_r, k_r in ((89, model.decode_k_max), (90, WALK_GLOBAL_K))]
    if [(r.blocks, r.slots, r.buffered) for r in routes] != [(-(-89 // walk.TILE), n_g, True),
                                                            (-(-90 // walk.TILE), n_g, False)]:
        raise AssertionError(f"the walk's edge cases did not reach the plan's routes: {routes}")

    # one launch a group and nothing beside it: no memset, no other kernel
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = walk.launches
    with torch.profiler.profile(activities=acts) as prof:
        walk.walk_group(*real_tables, start_dev, model.decode_k_max, lfi, step_frames)
        torch.cuda.synchronize()
    launches_a_group = walk.launches - before
    device_ops = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
    if launches_a_group != 1 or len(device_ops) != 1 or "decode_walk_kernel" not in device_ops[0]:
        raise AssertionError(f"a walk_group call made {launches_a_group} launches and ran {device_ops} on "
                             f"the card, not one walk launch")
    print(f"decode_walk: one call, {launches_a_group} launch, {len(device_ops)} operation on the card "
          f"({device_ops[0][:60]}); no memset")

    # time the kernel on group 0's real tables (4 segments, t = 691) from the piece's start
    walk_args = (*real_tables, start_dev, model.decode_k_max, lfi, step_frames)
    ms["decode_walk"], back_to_back, plain_ms["decode_walk"] = lone_device_plain(
        lambda: walk.walk_group_cuda(*walk_args), lambda: walk.walk_group_plain(*walk_args))
    device_ms["decode_walk"] = profiled_ms(lambda: walk.walk_group_cuda(*walk_args))
    walk_timer = "profiler"
    if device_ms["decode_walk"] is None:
        device_ms["decode_walk"] = queued_ms(lambda: walk.walk_group_cuda(*walk_args), max_sm_clock_mhz())
        walk_timer = "CUDA events, queued"
    out = walk.walk_group_cuda(*walk_args)
    np_tables = [a.cpu().numpy() for a in real_tables]
    cur, visits = [start0] * 90, np.zeros(90, np.int64)
    for gi in range(np_tables[0].shape[0]):  # each segment's start, from the host chain
        visits += walk_visits(np_tables[0][gi], np_tables[1][gi], cur)
        cur = transkun_module.host_chain(*(a[gi : gi + 1] for a in np_tables), cur, lfi, step_frames)[1]
    n_g, t = real_tables[1].shape[:2]
    edge_events = int(((out[1] >= lfi) & (torch.arange(model.decode_k_max, device=dev) < out[2][..., None]))
                      .sum())
    # bytes this run's data needs: a ptr and a diag load at each visited
    # position, a presence byte for each edge event, the starts; every output written once
    walk_bytes = (int(visits.sum()) * 5 + edge_events + 90 * 4
                  + sum(a.numel() * a.element_size() for a in out))
    bounds["decode_walk"] = bound(walk_bytes, 0)
    longest = int(visits.max())
    walk_extras = {"device_ms": device_ms["decode_walk"], "back_to_back_ms": back_to_back,
                   "plain_cpu_ms": float(np.median(plain_cpu_s)) * 1e3,
                   "host_walk_ms": float(np.median(host_walk_s)) * 1e3,
                   "visited_positions": int(visits.sum()), "longest_chain": longest,
                   "ns_per_chain_step": device_ms["decode_walk"] * 1e6 / longest, "cases": walk_cases,
                   "plans": walk_plans, "launches_a_group": launches_a_group,
                   "device_ops_a_group": len(device_ops)}
    print(f"decode_walk: equal to walk_group_plain as integers, two runs the same bits, every slot of "
          f"begins and ends written, in {walk_cases} cases on path 1's real tables (groups of "
          f"{[len(g) for g in groups]} segments, t = {t}, the starts carried group to group; random "
          f"forced starts; onset bound {step_frames}; k_max {WALK_SMALL_K}, which overflowed; 89 tracks; "
          f"one segment; k_max {WALK_GLOBAL_K}); the next starts equal the host walk's; plans: "
          f"{walk_plans}")

    walk_ms = device_ms["decode_walk"]
    print(f"decode_walk [{n_g},{t - 1},90] ({card}): this kernel: lone launch {ms['decode_walk']:.4f} ms, "
          f"device {walk_ms:.4f} ms a call ({walk_timer}, {DEVICE_LAUNCHES} calls), {back_to_back:.4f} ms a "
          f"call back to back, {walk_ms * 1e6 / longest:.0f} ns a chain step, bound "
          f"{bounds['decode_walk'][0]:.5f} ms ({walk_bytes} bytes), share "
          f"{bounds['decode_walk'][0] / walk_ms:.2%}; plain on the card {plain_ms['decode_walk']:.1f} ms, "
          f"on the CPU {walk_extras['plain_cpu_ms']:.1f} ms, host walk {walk_extras['host_walk_ms']:.1f} "
          f"ms; {int(visits.sum())} visited positions, longest chain {longest}")

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
        if counts() != want_launches(trained, n_segments(x.shape[0])):
            raise AssertionError(f"launches {counts()} for {n_segments(x.shape[0])} segments; "
                                 + route_line(trained))
        by_path["train"]["viterbi_bwd"] += viterbi.launches
        by_path["train"]["decode_walk"] += walk.launches
        print(f"trained best_state_dict transcribes {CORPUS_PIECE_SECONDS:.0f} s: "
              f"{len(trained_notes)} notes, {viterbi.launches} Viterbi and {walk.launches} walk "
              f"launches; {route_line(trained)}")
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
            want = {**want_launches(model, n_seg), **calls}
            n_run = want["viterbi_bwd"]  # segments run, the host-walk route's included
            if by_path["fused"] != want or calls["attention_fwd"] != n_run * n_attn \
                    or calls["fused_mlp"] != n_run * n_ffn:
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
                  f"{differing} notes differ between the routes; launches {by_path['fused']}; "
                  f"{route_line(model)}")
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
        model_b.decode_k_budget = budget  # path 1's
        with torch.no_grad():
            model_b.module.scorer.map[0].bias[-1] = -8.0
        with CallCounter(transkun_module, "viterbi_backward_tables_padded") as vit_calls, \
                CallCounter(logz, "alpha_table_padded") as alpha_calls, \
                CallCounter(logz, "beta_table_padded") as beta_calls:
            bf16_notes, bf16_wall, bf16_peak_gb, by_path["bf16"] = timed_transcription(model_b)
            want = want_launches(model_b, n_seg)
            if by_path["bf16"] != want or vit_calls.calls != 2 * want["viterbi_bwd"]:  # warm-up + timed run
                raise AssertionError(f"bf16 transcription launches {by_path['bf16']}, calls made "
                                     f"{vit_calls.calls} over two runs of {n_seg} segments; "
                                     + route_line(model_b))
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
                  f"{differing} notes differ from the fp32 route's; launches {by_path['bf16']}; "
                  f"{route_line(model_b)}")
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
                want = want_launches(model_b, n_seg)
                n_run = want["viterbi_bwd"]  # segments run, the host-walk route's included
                want.update(attention_fwd=n_run * n_attn, fused_mlp=n_run * n_ffn * with_mlp)
                if fa_launches != want or attn_calls.calls != (2 * n_run + 1) * n_attn \
                        or mlp_calls.calls != (2 * n_run + 1) * n_ffn * with_mlp:
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
                      f"{fa_launches}; {route_line(model_b)}; q at the attention kernel "
                      f"{sorted(attn_calls.shapes)} bf16"
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

        # -- path 6: the V1 model at full width, serving then training -----------
        by_path["v1"], v1_err, v1_times, v1_figures = v1_path(
            dev, card, audio, os.path.join(tmp, "corpus"), pickles, counts, reset_counts)
        for name, e in v1_err.items():
            err[name] = max(err[name], e)

        # -- path 7: the non-flagship V2 branches, serving then training ---------
        t0 = time.perf_counter()
        by_path["branches"], branch_figures = branch_path(
            dev, card, audio, os.path.join(tmp, "corpus"), pickles, budget, counts, reset_counts)
        print(f"path 7 wall {time.perf_counter() - t0:.1f} s")

        # -- path 8: multi-process training and the remaining entry points -------
        t0 = time.perf_counter()
        by_path["dist"], dist_figures = dist_path(
            dev, card, os.path.join(tmp, "corpus"), pickles, args, tmp, conf, audio, notes, budget,
            counts, reset_counts)
        print(f"path 8 wall {time.perf_counter() - t0:.1f} s")

        # -- path 9: the training input routes ------------------------------------
        t0 = time.perf_counter()
        by_path["input"], input_figures = input_path(
            dev, card, os.path.join(tmp, "corpus"), pickles, args, tmp, conf, counts, reset_counts)
        print(f"path 9 wall {time.perf_counter() - t0:.1f} s")

        # -- path 10: the JAX package's orbax checkpoint into the port -------------
        t0 = time.perf_counter()
        by_path["orbax"], orbax_figures = orbax_path(dev, card, tmp, counts, reset_counts)
        by_path["orbax_resume"], orbax_figures["resume"] = orbax_resume(dev, card, tmp, counts, reset_counts)
        orbax_figures["wall_s"] = time.perf_counter() - t0
        print(f"path 10 wall {orbax_figures['wall_s']:.1f} s")

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

    bad = [m for m in sys.modules if m.split(".")[0] in FOREIGN_PACKAGES]
    if bad:
        raise AssertionError(f"JAX code or a checkpoint package was imported: {bad[:5]}")

    pallas = "transkun_tpu/ops/"
    sources = {"viterbi_bwd": ("viterbi_bwd.cu", pallas + "semicrf_pallas.py:67"),
               "semicrf_alpha": ("semicrf_alpha.cu", pallas + "semicrf_pallas.py:224"),
               "semicrf_beta": ("semicrf_beta.cu", pallas + "semicrf_pallas.py:321"),
               "attention_fwd": ("attention_fwd.cu", pallas + "attention_pallas.py:78"),
               "attention_bwd": ("attention_bwd.cu", pallas + "attention_pallas.py:127"),
               "fused_mlp": ("fused_mlp.cu", pallas + "mlp_pallas.py:86"),
               "softmax_fwd": ("softmax_rows.cu", pallas + "softmax_pallas.py:54"),
               "softmax_bwd": ("softmax_rows.cu", pallas + "softmax_pallas.py:62"),
               # not a TPU kernel: the XLA scan of the decode's walk and its chain
               "decode_walk": ("decode_walk.cu", pallas + "semicrf.py:450"),
               # the streaming variants of kernels 4 and 5, in the same sources
               "attention_fwd_stream": ("attention_fwd.cu", pallas + "attention_pallas.py:78"),
               "attention_bwd_stream": ("attention_bwd.cu", pallas + "attention_pallas.py:127")}

    def bf16_entry(name):
        """The same numbers with bf16 input (kernels 1-5, 7 and 8)."""
        if name not in bf16:
            return None
        e = bf16[name]
        return {"max_abs_err": e["max_abs_err"], "ms": e["ms"], "device_ms": e.get("device_ms"),
                "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0], "bound_by": e["bound"][1],
                "library_ms": e.get("library_ms"),
                **({"exp_floor_ms": e["exp_floor_ms"]} if "exp_floor_ms" in e else {})}

    for name in KERNELS:
        if sum(by_path[path][name] for path in by_path) == 0:
            raise AssertionError(f"no path launched {name}")
    print(json.dumps({"v1": v1_figures}))
    print(json.dumps({"branches": branch_figures}))
    print(json.dumps({"dist": dist_figures}))
    print(json.dumps({"input": input_figures}))
    print(json.dumps({"orbax": orbax_figures}))
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
        "plan": plans[name],
        "bf16": bf16_entry(name),
        "v1": v1_times.get(name),
        **({"chain": walk_extras} if name == "decode_walk" else {}),
        **({"exp_floor_ms": exp_floors[name], "timed": stream_extra[name]}
           if name in stream_extra else {}),
    } for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
