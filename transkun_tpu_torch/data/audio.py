"""Host-side audio IO: wav slicing, decoding, resampling.

All of this is input-pipeline work that stays off the device (the reference
leans on scipy mmap / pydub+ffmpeg / soxr for the same roles,
``Data.py:380-424``, ``transcribe.py:10-17,75-81``).

The port's own copy of ``transkun_tpu/data/audio.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import math
import shutil
import subprocess
from typing import Tuple

import numpy as np


def read_audio_slice(
    audio_path: str, begin: float, end: float, normalize: bool = True
) -> Tuple[np.ndarray, int]:
    """Memory-mapped read of [begin, end] seconds from a wav file; pads with
    zeros outside the valid range (ref ``readAudioSlice``)."""
    from scipy.io import wavfile

    fs, data = wavfile.read(audio_path, mmap=True)
    b = math.floor(begin * fs)
    e = b + (math.floor(end * fs) - b)
    n = data.shape[0]
    if data.ndim == 1:
        data = data[:, np.newaxis]
    result = data[max(b, 0) : min(e, n), :]
    if normalize:
        t_max = np.iinfo(result.dtype).max
        result = np.divide(result, t_max, dtype=np.float32)
    l_pad = max(-b, 0)
    r_pad = max(e - n, 0)
    if l_pad > 0 or r_pad > 0:
        result = np.pad(result, ((l_pad, r_pad), (0, 0)), "constant")
    return result, fs


def read_audio(path: str, normalize: bool = True) -> Tuple[int, np.ndarray]:
    """Decode any audio file -> (fs, float32 [nSample, nChannel]).

    wav handled natively; other formats through the ffmpeg binary when
    available (the reference shells out to ffmpeg via pydub)."""
    if path.lower().endswith(".wav"):
        from scipy.io import wavfile

        fs, data = wavfile.read(path)
        if data.ndim == 1:
            data = data[:, np.newaxis]
        if normalize and np.issubdtype(data.dtype, np.integer):
            # divide by 2^(bits-1), matching the reference CLI's pydub
            # convention (``transcribe.py:15``, /2**15 for int16) — NOT by
            # iinfo.max; this also keeps int16 wavs int16-exact so
            # ``transcribe`` ships them over the device link as int16
            bits = np.iinfo(data.dtype).bits
            data = np.divide(data, 2 ** (bits - 1), dtype=np.float32)
        return fs, data.astype(np.float32)

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path}: not a wav and no ffmpeg binary available"
        )
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-show_entries", "stream=sample_rate,channels",
         "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True,
    )
    fs, channels = (int(x) for x in probe.stdout.strip().split("\n")[0].split(","))
    raw = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "s16le", "-acodec",
         "pcm_s16le", "-"],
        capture_output=True, check=True,
    ).stdout
    data = np.frombuffer(raw, np.int16).reshape(-1, channels)
    y = data.astype(np.float32) / 2**15 if normalize else data.astype(np.float32)
    return fs, y


def resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Polyphase resampling along axis 0 (replaces the soxr dependency)."""
    if fs_in == fs_out:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(fs_in, fs_out)
    return resample_poly(x, fs_out // g, fs_in // g, axis=0).astype(np.float32)
