#!/usr/bin/env python3
"""Drive the PyTorch port (``transkun_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``transkun_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds the Viterbi kernel against its plain PyTorch version at the
   flagship decode shape [696, 696, 128] and at a ragged shape (t = 123,
   Tp = 128, two segments' lanes): the pointer tables must be equal.  Times
   both with CUDA events (median of several runs).
3. Transcribes a 64 s synthetic piece with the flagship V2 configuration
   (``transkun_tpu/pretrained/2.0.conf``) and random weights from a seeded
   ``torch.Generator``, on ``cuda:0``.  Checks that the Viterbi kernel ran
   once per segment, that the notes are valid, and that on one segment's
   real scores the kernel's table equals the plain version's.

Prints the card, the build time, both Viterbi times, the transcription's
wall time, RTF and peak memory, then one JSON line with the kernels and, as
the last line, ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero without that line; it exits 1 at once when no
CUDA device is present.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

NEG = -1e30
SEED = 0
PIECE_SECONDS = 64.0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=5):
    """Median milliseconds of ``fn()`` over ``runs`` timed runs (CUDA
    events), after one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def decode_inputs(rng, t, nbp, dev):
    """Random NEG-padded decode-layout inputs ([begin, end, lane])."""
    import torch

    tp = -(-t // 8) * 8
    s_t = torch.full((tp, tp, nbp), NEG, device=dev)
    s_t[:t, :t] = torch.from_numpy(rng.normal(size=(t, t, nbp)).astype(np.float32)).to(dev)
    noise = torch.zeros(tp, nbp, device=dev)
    diag = torch.zeros(tp, nbp, device=dev)
    diag[:t] = torch.diagonal(s_t[:t, :t]).t()
    return s_t, noise, diag * (diag > 0)


def check_kernel(viterbi, s_t, noise, diag_gate):
    """Kernel table vs plain table on the same card inputs; returns the
    largest absolute difference, which must be 0."""
    import torch

    got = viterbi.viterbi_backward_tables_cuda(s_t, noise, diag_gate)
    want = viterbi.viterbi_backward_tables_plain(s_t, noise, diag_gate)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"Viterbi kernel != plain at {tuple(s_t.shape)}: max |diff| {err}")
    return err


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from transkun_tpu_torch.data.note import validate_notes
    from transkun_tpu_torch.models.config import load_default_conf
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.ops import _build, frontend, viterbi

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # -- build ---------------------------------------------------------------
    _, build_s, log = _build.build("viterbi_bwd")
    print(f"build viterbi_bwd: {build_s:.2f} s")
    if log:
        print(log.strip())

    # -- the kernel against its plain version ---------------------------------
    rng = np.random.default_rng(SEED)
    max_err = 0
    flagship = decode_inputs(rng, 691, 128, dev)  # Tp = 696
    max_err = max(max_err, check_kernel(viterbi, *flagship))
    max_err = max(max_err, check_kernel(viterbi, *decode_inputs(rng, 123, 256, dev)))
    kernel_ms = cuda_ms(lambda: viterbi.viterbi_backward_tables_cuda(*flagship))
    plain_ms = cuda_ms(lambda: viterbi.viterbi_backward_tables_plain(*flagship), runs=3)
    print(f"viterbi [696,696,128] ({card}): kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"ptr equal at [696,696,128] and [128,128,256]")
    del flagship

    # -- the slice: flagship transcription on the card ------------------------
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
    n_segments = math.ceil((audio.shape[0] + 2 * pad) / step)

    model.transcribe(audio)  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    viterbi.launches = 0
    t0 = time.perf_counter()
    notes = model.transcribe(audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = viterbi.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    if launches != n_segments:
        raise AssertionError(f"Viterbi kernel launched {launches} times for {n_segments} segments")
    if not notes:
        raise AssertionError("no notes decoded")
    validate_notes(notes)
    times = np.array([[n.start, n.end] for n in notes])
    # no note starts before 0 or ends after the last segment's last frame
    last_end = ((n_segments - 1) * step / conf.fs - pad / conf.fs
                + frontend.num_frames(seg_size, conf.hopSize) * conf.hopSize / conf.fs)
    if not (np.isfinite(times).all() and times.min() >= 0 and times.max() <= last_end):
        raise AssertionError(f"note times out of range: {times.min()} .. {times.max()}")
    print(f"transcribe {PIECE_SECONDS:.0f} s, {n_segments} segments ({card}): wall {wall:.3f} s, "
          f"RTF {PIECE_SECONDS / wall:.1f}x, peak memory {peak_gb:.2f} GB, "
          f"{len(notes)} notes, {launches} Viterbi kernel launches")

    # one segment's real scores: kernel table == plain table
    padded = np.pad(audio.T, ((0, 0), (pad, pad + seg_size)))
    seg = torch.from_numpy(padded[:, 3 * step : 3 * step + seg_size]).to(dev)
    with torch.no_grad():
        frames = frontend.make_frame(seg[None], conf.hopSize, conf.windowSize)
        t = frames.shape[-2]
        s_t, noise, diag, _ = model.module.process_frames_decode(frames, -(-t // 8) * 8, 128)
        max_err = max(max_err, check_kernel(viterbi, s_t, noise, diag * (diag > 0)))
    print(f"segment 3 real scores {tuple(s_t.shape)}: kernel ptr == plain ptr")

    print(json.dumps({"kernels": [{
        "name": "viterbi_bwd",
        "route": "cuda",
        "source": "transkun_tpu_torch/csrc/viterbi_bwd.cu",
        "replaces": "transkun_tpu/ops/semicrf_pallas.py:67",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
