"""Inference CLI of the port: audio file in, MIDI file out.

    python -m transkun_tpu_torch.cli.transcribe input.wav output.mid \
        [--weight ckpt_dir_or_pt] [--conf model.conf] [--device cuda|cpu] [--bf16]

The default device is ``cuda``, and the command fails when CUDA is absent;
``--device cpu`` runs the plain PyTorch versions of the kernels.
``--weight`` takes the JAX package's orbax checkpoint directory (its best
params, read by the port's own reader) or a ``.pt`` file.  A
directory input transcribes every audio file in it, mirroring the tree,
through ``TransKun.transcribe_many``: the next file is read and dispatched
before the current one's notes are assembled; with ``--allDevices`` the
files go round-robin over every visible card (multi-card serving).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Transcribe audio to MIDI (PyTorch port)")
    parser.add_argument(
        "audioPath",
        help="input audio file, or a directory whose audio files are all "
        "transcribed, mirroring the tree into outPath",
    )
    parser.add_argument("outPath", help="output MIDI file or directory")
    parser.add_argument("--weight", default=None, help="checkpoint (orbax dir or torch .pt)")
    parser.add_argument("--conf", default=None, help="model conf JSON (default: the flagship 2.0.conf)")
    parser.add_argument("--segmentHopSize", type=float, default=None, help="segment hop (s)")
    parser.add_argument("--segmentSize", type=float, default=None, help="segment size (s)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument(
        "--allDevices", action="store_true",
        help="directory mode: round-robin the files over every visible card",
    )
    args = parser.parse_args(argv)

    import torch

    from ..data.audio import read_audio, resample
    from ..data.midi import write_midi
    from ..models.config import load_default_conf, parse_conf_file
    from ..models.transkun import TransKun
    from ..train.checkpoint import load_params

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    if args.device == "cuda":  # as the trainer: bf16 is the only approximation on offer
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _, conf = parse_conf_file(args.conf) if args.conf else load_default_conf()

    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.weight is not None:
        model = TransKun(conf, device=args.device, compute_dtype=compute_dtype)
        model.load_state_dict(load_params(args.weight, conf))
    else:
        print("warning: no --weight given, using random weights (seed 0)")
        model = TransKun(conf, device=args.device, seed=0, compute_dtype=compute_dtype)

    def read(audio_path: str):
        fs, audio = read_audio(audio_path)
        if fs != model.fs:
            audio = resample(audio, fs, model.fs)
        return audio

    if not os.path.isdir(args.audioPath):
        notes = model.transcribe(
            read(args.audioPath),
            step_in_second=args.segmentHopSize,
            segment_size_in_second=args.segmentSize,
        )
        write_midi(notes, args.outPath)
        print(f"wrote {len(notes)} events to {args.outPath}")
        return
    root = pathlib.Path(args.audioPath)
    files = sorted(p for ext in ("*.wav", "*.mp3", "*.flac") for p in root.rglob(ext))
    print(f"{len(files)} audio files")
    t0 = time.perf_counter()
    durations = []

    def read_all():
        # lazy: piece i+1 is read and resampled on the host while piece i's
        # groups run on the card (transcribe_many dispatches it first)
        for p in files:
            audio = read(str(p))
            durations.append(audio.shape[0] / model.fs)
            yield audio

    devices = None
    if args.allDevices:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if args.device == "cuda" else [torch.device("cpu")])
    results = model.transcribe_many(
        read_all(),
        step_in_second=args.segmentHopSize,
        segment_size_in_second=args.segmentSize,
        devices=devices,
    )
    for p, notes in zip(files, results):
        out = pathlib.Path(args.outPath) / p.relative_to(root).with_suffix(".midi")
        out.parent.mkdir(parents=True, exist_ok=True)
        write_midi(notes, str(out))
        print(f"wrote {len(notes)} events to {out}")
    dt = time.perf_counter() - t0
    total_audio = sum(durations)
    print(f"RTF: {total_audio / max(dt, 1e-9):.1f}x ({total_audio:.0f}s audio in {dt:.0f}s)")


if __name__ == "__main__":
    main()
