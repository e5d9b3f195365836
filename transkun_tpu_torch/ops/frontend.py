"""DSP frontend: framing, windows and the band-limited GEMM log-mel.

Port of ``transkun_tpu/ops/frontend.py``.  The filterbank and DFT constants
are host numpy, re-implemented here because the JAX module imports jax; the
mel itself is two ``torch.matmul`` calls over the band of DFT bins that the
filterbank touches, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def num_frames(n_samples: int, hop_size: int) -> int:
    """Frame count convention of the reference (``Util.py:24``)."""
    return math.ceil(n_samples / hop_size) + 1


def make_frame(
    x: torch.Tensor, hop_size: int, window_size: int,
    left_padding_half_frame: bool = True,
) -> torch.Tensor:
    """Slice a waveform [..., nSample] into frames [..., nFrame, windowSize]:
    half a window of zeros on the left (by default) and enough on the right
    for ``nFrame = ceil(nSample / hop) + 1`` windows."""
    if hop_size >= window_size:
        raise ValueError(f"hop {hop_size} must be below window {window_size}")
    n = x.shape[-1]
    n_frame = num_frames(n, hop_size)
    l_pad = window_size // 2 if left_padding_half_frame else 0
    r_pad = (n_frame - 1) * hop_size + window_size - l_pad - n
    x = torch.nn.functional.pad(x, (l_pad, r_pad))
    return x.unfold(-1, window_size, hop_size)


def hann_window(window_size: int, device=None) -> torch.Tensor:
    """Periodic Hann window, float32 (the ``torch.hann_window`` convention)."""
    n = torch.arange(window_size, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / window_size))


def gaussian_windows_init(n: int) -> dict:
    """Initial learnable Gaussian window parameters (``Util.py:47-60``)."""
    centers = np.arange(1, n + 1) / (n + 1)
    return {
        "sigma": -np.ones(n, np.float32),
        "center": np.log(centers / (1 - centers)).astype(np.float32),
    }


def gaussian_windows(
    sigma: torch.Tensor, center: torch.Tensor, n_win: int
) -> torch.Tensor:
    """Evaluate the learnable Gaussian windows -> [nExtra, n_win]."""
    s = torch.sigmoid(sigma)
    c = torch.sigmoid(center)
    x = torch.arange(n_win, dtype=sigma.dtype, device=sigma.device)
    return torch.exp(
        -0.5 * ((x[None, :] - n_win * c[:, None]) / (s[:, None] * n_win / 2)) ** 2
    )


def melscale_fbanks(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """HTK-mel triangular filterbank [n_freqs, n_mels], no area
    normalization (``Util.py:135-141``)."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def dft_mel_matrices(window_size: int, fbank: np.ndarray) -> tuple:
    """(cos [W, B], sin [W, B], fbank_band [B, n_mels]): the ortho DFT
    restricted to the B bins where the filterbank is nonzero."""
    n_freqs = fbank.shape[0]
    nz = np.nonzero(fbank.sum(axis=1) > 0)[0]
    lo = int(nz.min()) if nz.size else 0
    hi = int(nz.max()) + 1 if nz.size else n_freqs
    n = np.arange(window_size)[:, None].astype(np.float64)
    k = np.arange(lo, hi)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / window_size
    scale = 1.0 / math.sqrt(window_size)
    cos_m = (np.cos(ang) * scale).astype(np.float32)
    sin_m = (-np.sin(ang) * scale).astype(np.float32)
    return cos_m, sin_m, fbank[lo:hi].astype(np.float32)


def mel_spectrum_gemm(
    frames: torch.Tensor,
    wins: torch.Tensor,
    cos_m: torch.Tensor,
    sin_m: torch.Tensor,
    fbank_band: torch.Tensor,
    log: bool = True,
    eps: float = 1e-5,
    to_mono: bool = False,
    compute_dtype=None,
) -> torch.Tensor:
    """Log-mel via the band-limited GEMM DFT.

    frames [..., nFrame, W], wins [nWin, W] -> [..., nFrame, n_mels, nWin].
    ``to_mono`` averages the power over the channel axis (dim -4).
    ``compute_dtype=torch.bfloat16`` rounds the windowed frames and the DFT
    matrices to bf16 and takes the two DFT products of those values with
    fp32 results, as the JAX package does (``preferred_element_type``): the
    rounded operands go back to fp32, which is exact, and the product runs
    in fp32 on the CPU and on the card alike.  Power, filterbank and log
    stay fp32."""
    w = frames[..., None, :] * wins  # [..., nFrame, nWin, W]
    if compute_dtype is not None:
        w, cos_m, sin_m = (a.to(compute_dtype).float() for a in (w, cos_m, sin_m))
    re = torch.matmul(w, cos_m)
    im = torch.matmul(w, sin_m)
    power = re * re + im * im  # [..., nFrame, nWin, B]
    if to_mono and power.ndim >= 4:
        power = power.mean(dim=-4, keepdim=True)
    mel = torch.matmul(power, fbank_band).transpose(-1, -2)
    if log:
        mel = (torch.log(mel + eps) - math.log(eps)) / (-math.log(eps))
    return mel
