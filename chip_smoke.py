#!/usr/bin/env python3
"""Drive the PyTorch port (``transkun_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``transkun_tpu_torch/csrc`` (nvcc, sm_90a),
   one ``nvcc`` per source, all at once.
2. Holds the Viterbi kernel against its plain PyTorch version at the
   flagship decode shape [696, 696, 128] and at a ragged shape (t = 123,
   Tp = 128, two segments' lanes): the pointer tables must be equal.
3. Holds the alpha and beta kernels against their plain versions at the
   flagship training shape [696, 696, 384] (t = 691, 360 real lanes) and
   at a ragged shape (t = 123, Tp = 128, NBp = 256): |kernel - plain| <=
   1e-5 * max(1, |plain|), the sums being taken in another order.  Then the
   logZ gradient through the kernels against autograd of the plain
   ``log_z_slow`` at a small ragged shape.  Every kernel and plain version
   is timed with CUDA events (median of several runs).
4. Transcription: a 64 s synthetic piece with the flagship V2
   configuration (``transkun_tpu/pretrained/2.0.conf``) and random weights
   from a seeded ``torch.Generator``.  Checks that the Viterbi kernel ran
   once per segment, that the notes are valid, and that on one segment's
   real scores the kernel's table equals the plain version's.
5. Training through the entry point ``transkun_tpu_torch.cli.train.main``
   at flagship width and depth, ``--batchSize 4``: a synthetic
   MAESTRO-layout corpus of 40 s pieces (MIDI from
   ``transkun_tpu.data.midi``, pickles from
   ``transkun_tpu.cli.create_dataset_maestro``, both JAX-free) in a temp
   dir; one epoch of steps with stats decodes, checkpoints and validation;
   a resume for two more steps; ``best_state_dict`` loaded into
   ``TransKun`` to transcribe a piece.  Every loss must be finite and the
   alpha, beta and Viterbi launch counts must equal the calls made.

Prints the card, build times, kernel times, the transcription's wall time,
RTF and peak memory, the training step time and peak memory, then one JSON
line with the kernels and, as the last line, ``{"ok": true, "device":
{...}}``.  TF32 is off for matmuls and convolutions.  Any failed check
raises, so the script exits non-zero without that line; it exits 1 at once
when no CUDA device is present.
"""

import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

NEG = -1e30
SEED = 0
PIECE_SECONDS = 64.0
KERNELS = ("viterbi_bwd", "semicrf_alpha", "semicrf_beta")
TABLE_RTOL = 1e-5  # |kernel - plain| <= TABLE_RTOL * max(1, |plain|)
TRAIN_PIECES, VAL_PIECES, CORPUS_PIECE_SECONDS = 3, 1, 40.0


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
        want = plain(s, rows, spdiag)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool(
            (diff > TABLE_RTOL * torch.clamp(want.abs(), min=1.0)).any()
        ):
            raise AssertionError(
                f"{name} != plain at {tuple(s.shape)}: max |diff| {float(diff.max())}"
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

    from transkun_tpu.cli.create_dataset_maestro import main as create_dataset
    from transkun_tpu.data.midi import write_midi
    from transkun_tpu.data.note import Note as MidiNote

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
    from transkun_tpu_torch.models.config import default_conf_path, load_default_conf
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.ops import _build, frontend, logz, semicrf, viterbi
    from transkun_tpu_torch.utils.convert import load_reference_checkpoint

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # -- build, one nvcc per source, all at once -------------------------------
    t0 = time.perf_counter()
    for name, (_, build_s, log) in _build.build_all(KERNELS).items():
        print(f"build {name}: {build_s:.2f} s")
        if log:
            print(log.strip())
    print(f"build wall: {time.perf_counter() - t0:.2f} s")

    # -- each kernel against its plain version ---------------------------------
    rng = np.random.default_rng(SEED)
    err = {}
    flagship = decode_inputs(rng, 691, 128, dev)  # Tp = 696
    err["viterbi_bwd"] = max(check_kernel(viterbi, *flagship),
                             check_kernel(viterbi, *decode_inputs(rng, 123, 256, dev)))
    ms = {"viterbi_bwd": cuda_ms(lambda: viterbi.viterbi_backward_tables_cuda(*flagship))}
    plain_ms = {"viterbi_bwd": cuda_ms(lambda: viterbi.viterbi_backward_tables_plain(*flagship), runs=3)}
    print(f"viterbi [696,696,128] ({card}): kernel {ms['viterbi_bwd']:.3f} ms, "
          f"plain {plain_ms['viterbi_bwd']:.3f} ms, ptr equal at [696,696,128] and [128,128,256]")
    del flagship

    s, shift, noise, spdiag = table_inputs(rng, 691, 384, 360, dev)  # the training shape
    errs = [check_tables(logz, s, shift, noise, spdiag),
            check_tables(logz, *table_inputs(rng, 123, 256, 200, dev))]
    for name, kernel, plain, rows in (
        ("semicrf_alpha", logz.alpha_table_padded_cuda, logz.alpha_table_padded_plain, shift),
        ("semicrf_beta", logz.beta_table_padded_cuda, logz.beta_table_padded_plain, noise),
    ):
        err[name] = max(e[name] for e in errs)
        ms[name] = cuda_ms(lambda: kernel(s, rows, spdiag))
        plain_ms[name] = cuda_ms(lambda: plain(s, rows, spdiag), runs=3)
        print(f"{name} [696,696,384] ({card}): kernel {ms[name]:.3f} ms, plain {plain_ms[name]:.3f} ms")
    print(f"alpha/beta within {TABLE_RTOL}*max(1,|plain|) of plain at [696,696,384] and "
          f"[128,128,256]: max |diff| alpha {err['semicrf_alpha']:.3g}, beta {err['semicrf_beta']:.3g}")
    del s, shift, noise, spdiag
    grad_err = check_logz_grad(logz, semicrf, dev)
    print(f"logZ + score cotangent via kernels vs autograd of log_z_slow [45,45,5]: "
          f"max |diff| {grad_err:.3g}")

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

    model.transcribe(audio)  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    viterbi.launches = logz.alpha_launches = logz.beta_launches = 0
    t0 = time.perf_counter()
    notes = model.transcribe(audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"viterbi_bwd": viterbi.launches, "semicrf_alpha": logz.alpha_launches,
                "semicrf_beta": logz.beta_launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    n_seg = n_segments(audio.shape[0])
    if launches != {"viterbi_bwd": n_seg, "semicrf_alpha": 0, "semicrf_beta": 0}:
        raise AssertionError(f"transcription launches {launches} for {n_seg} segments")
    if not notes:
        raise AssertionError("no notes decoded")
    validate_notes(notes)
    times = np.array([[n.start, n.end] for n in notes])
    # no note starts before 0 or ends after the last segment's last frame
    last_end = ((n_seg - 1) * step / conf.fs - pad / conf.fs
                + frontend.num_frames(seg_size, conf.hopSize) * conf.hopSize / conf.fs)
    if not (np.isfinite(times).all() and times.min() >= 0 and times.max() <= last_end):
        raise AssertionError(f"note times out of range: {times.min()} .. {times.max()}")
    print(f"transcribe {PIECE_SECONDS:.0f} s, {n_seg} segments ({card}): wall {wall:.3f} s, "
          f"RTF {PIECE_SECONDS / wall:.1f}x, peak memory {peak_gb:.2f} GB, "
          f"{len(notes)} notes, launches {launches}")

    # one segment's real scores: kernel table == plain table
    padded = np.pad(audio.T, ((0, 0), (pad, pad + seg_size)))
    seg = torch.from_numpy(padded[:, 3 * step : 3 * step + seg_size]).to(dev)
    with torch.no_grad():
        frames = frontend.make_frame(seg[None], conf.hopSize, conf.windowSize)
        t = frames.shape[-2]
        s_t, noise, diag, _ = model.module.process_frames_decode(frames, -(-t // 8) * 8, 128)
        err["viterbi_bwd"] = max(err["viterbi_bwd"], check_kernel(viterbi, s_t, noise, diag * (diag > 0)))
    print(f"segment 3 real scores {tuple(s_t.shape)}: kernel ptr == plain ptr")
    del model, s_t, noise, diag, frames

    # -- path 2: flagship training through the entry point ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pickles = build_corpus(os.path.join(tmp, "corpus"), conf.fs, SEED)
        print(f"corpus: {TRAIN_PIECES} train + {VAL_PIECES} validation pieces of "
              f"{CORPUS_PIECE_SECONDS:.0f} s in {time.perf_counter() - t0:.1f} s")
        ckpt = os.path.join(tmp, "ckpt.pt")
        args = [ckpt, "--datasetPath", os.path.join(tmp, "corpus"),
                "--datasetMetaFile_train", os.path.join(pickles, "train.pickle"),
                "--datasetMetaFile_val", os.path.join(pickles, "val.pickle"),
                "--modelConf", default_conf_path(), "--batchSize", "4",
                "--statsEvery", "4", "--ckptEvery", "3", "--logEvery", "1",
                "--seed", str(SEED), "--device", "cuda"]
        viterbi.launches = logz.alpha_launches = logz.beta_launches = 0
        t0 = time.perf_counter()
        first = train_cli.main(args + ["--maxEpoch", "1"])
        second = train_cli.main(args + ["--maxEpoch", "2", "--stopAtStep", str(first["steps"] + 2)])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = {"viterbi_bwd": viterbi.launches, "semicrf_alpha": logz.alpha_launches,
                          "semicrf_beta": logz.beta_launches}
        runs = (first, second)
        steps = sum(r["steps"] for r in runs)
        val_batches = sum(r["val_batches"] for r in runs)
        want = {"semicrf_alpha": steps + val_batches, "semicrf_beta": steps + val_batches,
                "viterbi_bwd": sum(2 * r["stats_passes"] for r in runs) + val_batches}
        losses = [x for r in runs for x in r["losses"]]
        if train_launches != want:
            raise AssertionError(f"training launches {train_launches}, calls made {want}")
        if second["steps"] != 2 or first["val_batches"] == 0 or first["stats_passes"] == 0:
            raise AssertionError(f"training runs {first} / {second}")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses}")
        step_s = first["step_seconds"][1:] + second["step_seconds"][1:]
        print(f"train flagship V2 --batchSize 4 ({card}): {steps} steps "
              f"({first['steps']} + resume {second['steps']}), {val_batches} validation "
              f"batches, {first['stats_passes'] + second['stats_passes']} stats passes, "
              f"wall {train_wall:.1f} s")
        print(f"train step: median {float(np.median(step_s)):.4f} s over {len(step_s)} steps "
              f"after each run's first (all: {[round(x, 4) for x in first['step_seconds'] + second['step_seconds']]}), "
              f"peak memory {max(r['step_peak_bytes'] for r in runs) / 1e9:.2f} GB")
        print(f"train losses: {[round(x, 3) for x in losses]}")
        print(f"validation: {first['val_results']}")
        print(f"training launches {train_launches} (= steps + validation batches; "
              f"2 per stats pass + 1 per validation batch)")

        # the trained best weights, loaded as a user would, transcribe a piece
        trained = TransKun(conf, device=dev)
        trained.load_state_dict(load_reference_checkpoint(ckpt))
        with open(os.path.join(pickles, "val.pickle"), "rb") as f:
            piece = pickle.load(f)[0]
        from scipy.io import wavfile

        _, x = wavfile.read(os.path.join(tmp, "corpus", piece["audio_filename"]))
        x = (x.astype(np.float32) / 32768.0)[:, None]
        viterbi.launches = 0
        notes = trained.transcribe(x)
        torch.cuda.synchronize()
        validate_notes(notes)
        if viterbi.launches != n_segments(x.shape[0]):
            raise AssertionError(f"{viterbi.launches} Viterbi launches for {n_segments(x.shape[0])} segments")
        launches["viterbi_bwd"] += train_launches["viterbi_bwd"] + viterbi.launches
        launches["semicrf_alpha"] += train_launches["semicrf_alpha"]
        launches["semicrf_beta"] += train_launches["semicrf_beta"]
        print(f"trained best_state_dict transcribes {CORPUS_PIECE_SECONDS:.0f} s: "
              f"{len(notes)} notes, {viterbi.launches} Viterbi launches")

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
           or m.split(".")[:2] in [["transkun_tpu", x] for x in ("models", "ops", "utils", "train", "parallel")]]
    if bad:
        raise AssertionError(f"JAX code was imported: {bad[:5]}")

    sources = {"viterbi_bwd": ("transkun_tpu_torch/csrc/viterbi_bwd.cu", 67),
               "semicrf_alpha": ("transkun_tpu_torch/csrc/semicrf_alpha.cu", 224),
               "semicrf_beta": ("transkun_tpu_torch/csrc/semicrf_beta.cu", 321)}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": sources[name][0],
        "replaces": f"transkun_tpu/ops/semicrf_pallas.py:{sources[name][1]}",
        "launches": launches[name],
        "max_abs_err": err[name],
        "ms": ms[name],
        "plain_ms": plain_ms[name],
    } for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
