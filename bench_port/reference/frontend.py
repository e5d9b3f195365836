"""Plain log-mel frontend of the V2 reference: framing, the
Hann and learnable Gaussian analysis windows, an orthonormal DFT restricted
to the bins an HTK mel filterbank touches, and the scaled log.

Written from the published description (Yan & Duan 2021, 2024: multi-window
log-mel with gain normalization); nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def frame_count(n_samples: int, hop: int) -> int:
    return math.ceil(n_samples / hop) + 1


def frames(x: torch.Tensor, hop: int, window: int) -> torch.Tensor:
    """Waveform [..., n] -> frames [..., T, window]: half a window of zeros
    in front and enough behind for ``ceil(n / hop) + 1`` frames."""
    n = x.shape[-1]
    t = frame_count(n, hop)
    left = window // 2
    right = (t - 1) * hop + window - left - n
    return torch.nn.functional.pad(x, (left, right)).unfold(-1, window, hop)


def gaussian_window_init(n: int):
    centers = np.arange(1, n + 1) / (n + 1)
    return -np.ones(n, np.float32), np.log(centers / (1 - centers)).astype(np.float32)


def _mel_filterbank(n_freqs, f_min, f_max, n_mels, fs):
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, fs // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    width = np.diff(f_pts)
    rel = f_pts[None, :] - freqs[:, None]
    rising = -rel[:, :-2] / width[:-1]
    falling = rel[:, 2:] / width[1:]
    return np.maximum(0.0, np.minimum(rising, falling))


class Constants:
    """The frontend's fixed matrices for one configuration, on ``device``."""

    def __init__(self, conf: dict, device):
        w = conf["windowSize"]
        fb = _mel_filterbank(w // 2 + 1, conf["f_min"], conf["f_max"], conf["n_mels"], conf["fs"])
        band = np.nonzero(fb.sum(axis=1) > 0)[0]
        lo, hi = int(band.min()), int(band.max()) + 1
        ang = 2.0 * np.pi * np.arange(w)[:, None] * np.arange(lo, hi)[None, :] / w
        self.cos = torch.tensor(np.cos(ang) / math.sqrt(w), dtype=torch.float32, device=device)
        self.sin = torch.tensor(-np.sin(ang) / math.sqrt(w), dtype=torch.float32, device=device)
        self.fbank = torch.tensor(fb[lo:hi], dtype=torch.float32, device=device)
        n = torch.arange(w, dtype=torch.float32, device=device)
        self.hann = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / w))
        self.window = w


def log_mel(P: dict, prefix: str, k: Constants, fr: torch.Tensor) -> torch.Tensor:
    """Frames [N, C, T, W] -> features [N, T, n_mels, nWins]: each item
    normalized to zero mean and unit (unbiased) deviation, every window's
    power spectrum averaged over the channels, the mel bands, and
    ``(log(m + 1e-5) - log 1e-5) / -log 1e-5``."""
    dims = (1, 2, 3)
    fr = fr - fr.mean(dim=dims, keepdim=True)
    count = fr.shape[1] * fr.shape[2] * fr.shape[3]
    std = torch.sqrt((fr * fr).sum(dim=dims, keepdim=True) / max(count - 1, 1))
    fr = fr / (std + 1e-8)
    sigma = torch.sigmoid(P[prefix + "winGen.sigma"])
    center = torch.sigmoid(P[prefix + "winGen.center"])
    x = torch.arange(k.window, dtype=torch.float32, device=fr.device)
    gauss = torch.exp(-0.5 * ((x[None] - k.window * center[:, None]) / (sigma[:, None] * k.window / 2)) ** 2)
    wins = torch.cat([k.hann[None], gauss])  # [nWins, W]
    windowed = fr[..., None, :] * wins  # [N, C, T, nWins, W]
    power = (windowed @ k.cos) ** 2 + (windowed @ k.sin) ** 2
    mel = power.mean(dim=1) @ k.fbank  # [N, T, nWins, n_mels]
    eps = 1e-5
    return ((torch.log(mel + eps) - math.log(eps)) / -math.log(eps)).transpose(-1, -2)
