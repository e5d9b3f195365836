"""Training-time audio augmentation (host-side, numpy/scipy).

Replicates the augmentation pipeline the reference trains its "Aug" models
with (``transkun/Data.py:748-843``): random channel downmix, pitch shift
within ±0.2 semitones (phase-vocoder), seven-band parametric EQ within ±3 dB,
optional impulse-response reverb with a random wet/dry mix, optional
background noise, and Gaussian noise at a random SNR in [3, 40] dB — each
applied with probability 0.5.

The port's own copy of ``transkun_tpu/data/augment.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import math
import os
import random
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def _stft(x, n_fft, hop):
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n_frames = 1 + max(0, (len(x) - n_fft)) // hop
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop][:n_frames]
    return np.fft.rfft(frames * win, axis=-1), win


def _istft(spec, win, hop, length):
    n_fft = len(win)
    frames = np.fft.irfft(spec, n=n_fft, axis=-1) * win
    n = len(frames)
    out = np.zeros(hop * (n - 1) + n_fft, np.float32)
    norm = np.zeros_like(out)
    w2 = win * win
    # vectorized overlap-add: frame i, sub-block k covers (i+k)*hop+[0,hop),
    # so each k-th column block scatters as one contiguous strided add; the
    # final partial block (hop not dividing n_fft) pads its columns to a
    # full hop so the same ravel-add applies
    for k in range(-(-n_fft // hop)):
        w = min(hop, n_fft - k * hop)
        blk = frames[:, k * hop : k * hop + w]
        wb = w2[k * hop : k * hop + w]
        if w < hop:
            blk = np.pad(blk, ((0, 0), (0, hop - w)))
            wb = np.pad(wb, (0, hop - w))
        out[k * hop : k * hop + n * hop] += np.ascontiguousarray(blk).ravel()
        norm[k * hop : k * hop + n * hop] += np.tile(wb, n)
    out /= np.maximum(norm, 1e-8)
    return out[:length]


def time_stretch(x: np.ndarray, rate: float, n_fft: int = 2048, hop: int = 512):
    """Phase-vocoder time stretch of a mono signal by ``rate`` (>1 = faster)."""
    if len(x) < n_fft * 2:
        return x
    # strided views (e.g. one channel of interleaved stereo) put the frame
    # FFT on a slow gather path — a contiguous copy is ~10x faster overall
    x = np.ascontiguousarray(x)
    spec, win = _stft(x, n_fft, hop)
    n_in = spec.shape[0]
    steps = np.arange(0, n_in - 1, rate)
    phase_adv = np.linspace(0, np.pi * hop, spec.shape[1])  # float64
    # fully vectorized phase vocoder: the per-frame phase accumulator is a
    # cumulative sum of wrapped phase deltas, so the whole loop collapses to
    # fancy indexing + cumsum (was a ~1400-iteration python loop per chunk).
    # Phase math stays in float64: the top-bin accumulator reaches ~2e6 rad
    # over a 16 s chunk, where float32 ulp is ~0.25 rad
    idx = steps.astype(np.int64)
    frac = (steps - idx)[:, None].astype(np.float32)
    s0 = spec[idx]
    s1 = spec[np.minimum(idx + 1, n_in - 1)]
    ang0 = np.angle(s0).astype(np.float64)
    mag = (1 - frac) * np.abs(s0) + frac * np.abs(s1)
    dphase = np.angle(s1) - ang0 - phase_adv
    dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
    inc = phase_adv + dphase  # phase increment applied AFTER frame t
    phase = np.empty_like(inc)
    phase[0] = np.angle(spec[0])
    phase[1:] = phase[0] + np.cumsum(inc[:-1], axis=0)
    out = (mag * (np.cos(phase) + 1j * np.sin(phase))).astype(np.complex64)
    length = int(round(len(x) / rate))
    return _istft(out, win, hop, length)


def pitch_shift(x: np.ndarray, semitones: float, fs: int) -> np.ndarray:
    """Pitch shift preserving duration: time-stretch then resample."""
    if abs(semitones) < 1e-6:
        return x
    from scipy.signal import resample_poly

    factor = 2.0 ** (semitones / 12.0)
    stretched = time_stretch(x, 1.0 / factor)  # longer by `factor`
    # compress back to the original duration -> frequencies scale by `factor`.
    # A small-denominator rational approximation keeps the polyphase filter
    # short (up=10000 made resample_poly take seconds per chunk); the rate
    # error (<1e-6 relative) is far below the vocoder's own accuracy.
    from fractions import Fraction

    fr = Fraction(1.0 / factor).limit_denominator(500)
    y = resample_poly(stretched, fr.numerator, fr.denominator).astype(np.float32)
    if len(y) >= len(x):
        return y[: len(x)]
    return np.pad(y, (0, len(x) - len(y)))


def peaking_eq(x: np.ndarray, fs: int, f0: float, gain_db: float, q: float = 1.0):
    """RBJ cookbook peaking biquad."""
    from scipy.signal import lfilter

    a = 10 ** (gain_db / 40)
    w0 = 2 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2 * q)
    b = [1 + alpha * a, -2 * math.cos(w0), 1 - alpha * a]
    den = [1 + alpha / a, -2 * math.cos(w0), 1 - alpha / a]
    b = np.array(b) / den[0]
    den = np.array(den) / den[0]
    return lfilter(b, den, x).astype(np.float32)


class AugmentatorPitchShiftOnly:
    """Pitch-shift-only augmentation (ref ``AugmentatorPitchShiftOnly``,
    ``Data.py:616-650``): uniform shift in ``pitchShiftRange`` semitones,
    bypassed with probability ``byPassProb``."""

    def __init__(
        self,
        sampleRate: int,
        pitchShiftRange=(-0.30, 0.30),
        byPassProb: float = 0.1,
        rng: Optional[random.Random] = None,
    ):
        self.fs = sampleRate
        self.pitchShiftRange = pitchShiftRange
        self.byPassProb = byPassProb
        self.rng = rng or random.Random()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self.rng.random() < self.byPassProb:
            return x
        shift = self.rng.uniform(*self.pitchShiftRange)
        channels = [pitch_shift(x[:, c], shift, self.fs) for c in range(x.shape[1])]
        return np.stack(channels, axis=1)


def _sample_range(rng, lo, hi, log=False, triangular=False):
    if triangular:
        return rng.triangular(lo, hi, (lo + hi) / 2)
    if log:
        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    return rng.uniform(lo, hi)


def _schroeder_reverb(x, fs, reverberance, room_scale, pre_delay_ms):
    """Freeverb-style reverb (sox ``reverb`` is freeverb): 8 parallel combs
    + 2 series allpasses, comb delays scaled by room_scale, feedback mapped
    from reverberance.  An approximation of sox's DSP — augmentation noise,
    not a parity target."""
    from scipy.signal import lfilter

    comb_ms = np.array([25.3, 26.9, 28.9, 30.7, 32.2, 33.8, 35.3, 36.7])
    scale = 0.4 + 0.6 * room_scale / 100.0
    feedback = 0.7 + 0.28 * reverberance / 100.0
    wet = np.zeros_like(x)
    for ms in comb_ms * scale:
        d = max(1, int(fs * ms / 1000))
        b = np.zeros(d + 1)
        b[d] = 1.0
        a = np.zeros(d + 1)
        a[0] = 1.0
        a[d] = -feedback
        wet += lfilter(b, a, x)
    wet /= len(comb_ms)
    for ms in (5.0, 1.7):
        d = max(1, int(fs * ms / 1000))
        g = 0.5
        b = np.zeros(d + 1)
        b[0] = -g
        b[d] = 1.0
        a = np.zeros(d + 1)
        a[0] = 1.0
        a[d] = -g
        wet = lfilter(b, a, wet)
    pre = int(fs * pre_delay_ms / 1000)
    if pre > 0:
        wet = np.concatenate([np.zeros(pre, np.float32), wet[: len(x) - pre]])
    return wet.astype(np.float32)


class AugmentatorSoxChain:
    """The reference's sox-based chain (ref ``Augmentator``,
    ``Data.py:652-746``), rebuilt on scipy/numpy (sox unavailable): triangular
    pitch shift, freeverb-style reverb (reverberance/room-scale/pre-delay),
    4 random peaking EQs (log-uniform 32-12000 Hz, q 1-4, gain -10..5 dB),
    sine-shaping "contrast" compression, additive Gaussian noise, log-uniform
    gain, clipping — each stage bypassed with probability ``byPassProb``,
    matching the reference's per-stage gating.  Kept for capability parity;
    the reference's own train.py uses the audiomentations chain
    (``Augmentator`` here)."""

    def __init__(
        self,
        sampleRate: int,
        pitchShiftRange=(-0.3, 0.3),
        reverbRange=(0, 70),
        reverbRoomScale=(0, 100),
        reverbPreDelay=(0, 100),
        freqRange1=(32, 12000),
        width_q1=(1, 4),
        gain_db1=(-10, 5),
        noiseGain=(0, 0.01),
        contrastRange=(0, 100),
        gainRange=(0.25, 4),
        byPassProb: float = 0.1,
        rng: Optional[random.Random] = None,
    ):
        self.fs = sampleRate
        self.pitchShiftRange = pitchShiftRange
        self.reverbRange = reverbRange
        self.reverbRoomScale = reverbRoomScale
        self.reverbPreDelay = reverbPreDelay
        self.eqFreqRange = freqRange1
        self.eqWidthRange = width_q1
        self.eqGainRange = gain_db1
        self.noiseGain = noiseGain
        self.contrastRange = contrastRange
        self.gainRange = gainRange
        self.byPassProb = byPassProb
        self.rng = rng or random.Random()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        r = self.rng
        if r.random() < self.byPassProb:
            return x
        n_sample, n_ch = x.shape
        out = np.array(x, np.float32)

        shift = _sample_range(r, *self.pitchShiftRange, triangular=True)
        for c in range(n_ch):
            out[:, c] = pitch_shift(out[:, c], shift, self.fs)

        reverb_amount = _sample_range(r, *self.reverbRange)
        room = _sample_range(r, *self.reverbRoomScale)
        predelay = _sample_range(r, *self.reverbPreDelay)
        if reverb_amount > 0 and r.random() > self.byPassProb:
            for c in range(n_ch):
                wet = _schroeder_reverb(
                    out[:, c], self.fs, reverb_amount, room, predelay
                )
                w = reverb_amount / 100.0
                out[:, c] = (1 - 0.5 * w) * out[:, c] + 0.5 * w * wet

        for _ in range(4):
            f0 = _sample_range(r, *self.eqFreqRange, log=True)
            q = _sample_range(r, *self.eqWidthRange)
            gain = _sample_range(r, *self.eqGainRange)
            if r.random() > self.byPassProb and f0 < self.fs / 2:
                for c in range(n_ch):
                    out[:, c] = peaking_eq(out[:, c], self.fs, f0, gain, q)

        if r.random() > self.byPassProb:
            # sox ``contrast``: sine-shaping loudness enhancement
            amount = _sample_range(r, *self.contrastRange)
            out = np.sin(
                np.clip(out, -1, 1) * (math.pi / 2) * (1 + amount / 750.0)
            ).astype(np.float32)

        noise_gain = _sample_range(r, *self.noiseGain)
        gain = _sample_range(r, *self.gainRange, log=True)
        if r.random() < self.byPassProb:
            noise_gain = 0.0
        out = out + noise_gain * np.random.normal(0.0, 1.0, out.shape).astype(
            np.float32
        )
        out = out * gain
        if r.random() > self.byPassProb:
            out = np.clip(out, -1, 1)

        out = out.astype(np.float32)
        if out.shape[0] != n_sample:
            if out.shape[0] > n_sample:
                out = out[:n_sample]
            else:
                out = np.pad(out, ((0, n_sample - out.shape[0]), (0, 0)))
        return out


class Augmentator:
    """The audiomentations-equivalent augmentation chain; input/output
    float32 [nSample, nChannel]."""

    EQ_BANDS = (42.0, 107.0, 274.0, 697.0, 1779.0, 4535.0, 11559.0)

    def __init__(
        self,
        sampleRate: int = 44100,
        pitchShiftRange=(-0.2, 0.2),
        eqDBRange=(-3.0, 3.0),
        snrRange=(3.0, 40.0),
        convIRFolder: Optional[str] = None,
        noiseFolder: Optional[str] = None,
        rng: Optional[random.Random] = None,
    ):
        self.fs = sampleRate
        self.pitchShiftRange = pitchShiftRange
        self.eqDBRange = eqDBRange
        self.snrRange = snrRange
        self.rng = rng or random.Random()
        self.irFiles: List[str] = (
            [str(p) for p in Path(convIRFolder).glob(os.path.join("**", "*.wav"))]
            if convIRFolder
            else []
        )
        self.noiseFiles: List[str] = (
            [str(p) for p in Path(noiseFolder).glob(os.path.join("**", "*.wav"))]
            if noiseFolder
            else []
        )
        self._wav_cache = {}

    def _load_wav(self, path):
        if path not in self._wav_cache:
            from scipy.io import wavfile

            fs, data = wavfile.read(path)
            if data.ndim > 1:
                data = data.mean(axis=1)
            if np.issubdtype(data.dtype, np.integer):
                data = data / np.iinfo(data.dtype).max
            self._wav_cache[path] = (fs, data.astype(np.float32))
        return self._wav_cache[path]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        r = self.rng
        x = np.array(x, np.float32).T  # [C, n]

        # random channel downmix (ref ``Data.py:813-819``)
        if x.ndim == 2:
            w = 2 * np.array([r.random() for _ in range(x.shape[0])]) - 1
            w = (w + 1e-8) / (np.sum(np.abs(w)) + 1e-8)
            x = (w[None, :] @ x).astype(np.float32)
        x = x[0] if x.ndim == 2 else x

        if r.random() < 0.5:
            x = pitch_shift(x, r.uniform(*self.pitchShiftRange), self.fs)
        if r.random() < 0.5:
            for f0 in self.EQ_BANDS:
                if f0 < self.fs / 2:
                    x = peaking_eq(x, self.fs, f0, r.uniform(*self.eqDBRange))

        if self.irFiles and r.random() < 0.5:
            _, ir = self._load_wav(r.choice(self.irFiles))
            from scipy.signal import fftconvolve

            # direct np.convolve with a ~0.3 s IR is ~10 GMAC (seconds per
            # chunk); FFT convolution is ~50 ms for identical output
            wet = fftconvolve(x, ir)[: len(x)].astype(np.float32)
            alpha = r.random()
            x = alpha * x + (1 - alpha) * wet

        if self.noiseFiles and r.random() < 0.5:
            _, noise = self._load_wav(r.choice(self.noiseFiles))
            if r.random() < 0.5:
                noise = noise[::-1]
            if r.random() < 0.5:
                noise = -noise
            if len(noise) < len(x):
                noise = np.tile(noise, math.ceil(len(x) / len(noise)))
            start = r.randrange(max(1, len(noise) - len(x) + 1))
            noise = noise[start : start + len(x)]
            snr = r.uniform(*self.snrRange)
            sig_rms = np.sqrt(np.mean(x**2) + 1e-12)
            noise_rms = np.sqrt(np.mean(noise**2) + 1e-12)
            x = x + noise * (sig_rms / noise_rms) * 10 ** (-snr / 20)

        if r.random() < 0.5:  # AddGaussianSNR
            snr = r.uniform(*self.snrRange)
            sig_rms = np.sqrt(np.mean(x**2) + 1e-12)
            x = x + np.random.normal(0, sig_rms * 10 ** (-snr / 20), len(x)).astype(
                np.float32
            )

        return x[:, None]
