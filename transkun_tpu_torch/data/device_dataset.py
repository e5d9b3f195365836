"""Device-resident training corpus: pack every piece onto the card once,
slice each step's chunks there.

The port's copy of ``transkun_tpu/data/device_dataset.py``.  Every piece goes
into ONE int16 ``[total, C]`` tensor on the device at start-up, each piece
between zero pads of ``chunk_samples + 2`` samples, so a dithered chunk that
overhangs either edge of its piece reads zeros and never its neighbour's
samples.  A step's chunks are then a gather driven by one int32 start a
chunk, and the only upload a step makes is those starts.

Parity with the host slicer (``data.audio.read_audio_slice``, ref
``Data.py:380-424``):

- chunk starts are ``floor(begin * fs)`` in float64, as the host slicer's;
- samples outside the piece are zeros;
- ``dequantize_int16`` divides by 32767 (``iinfo.max``, the training
  slicer's scale) with the same rounding as the host's
  ``np.divide(x, 32767, dtype=float32)``: equal bit for bit, on the CPU and
  on the card.  (The JAX package's in-jit divide is within 1 ulp of the
  host floats; the port's is exact.)

Scope: training chunks of one fixed length; the packed corpus must stay
below 2**31 samples (~13.5 h mono at 44.1 kHz) and ``max_bytes``, else the
constructor raises and the trainer uses the host loader.  Augmentation is
host DSP, so it needs the host loader.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DeviceDataset", "dequantize_int16", "INT16_SCALE"]

# the training slicer's normalization: np.iinfo(np.int16).max (ref
# ``Data.py:416-419``), not the decode path's 2**15
INT16_SCALE = 32767.0


def dequantize_int16(x: torch.Tensor) -> torch.Tensor:
    """int16 audio -> float32 ``x / 32767``, equal bit for bit to
    ``np.divide(x, 32767, dtype=np.float32)`` on every int16 value.

    The port's one division of int16 training audio by 32767.  The divisor
    is a 0-dim tensor on ``x``'s device, not a Python number: on a CUDA
    tensor, PyTorch divides by a CPU scalar as a product with its reciprocal
    (ATen's ``div_true_kernel_cuda``), which is one bit off on about 2% of
    the int16 values."""
    return x.to(torch.float32) / torch.full((), INT16_SCALE, dtype=torch.float32, device=x.device)


def _read_piece_int16(path: str):
    """Read a wav as ``(fs, int16 [n, C])``.  An int16 payload is kept as it
    is; a float payload is rounded and clipped at the 32767 scale the host
    slicer divides by (error <= 0.5 / 32767); a wider int payload is scaled
    by ``32767 / iinfo.max``."""
    from scipy.io import wavfile

    fs, data = wavfile.read(path, mmap=True)
    if data.ndim == 1:
        data = data[:, np.newaxis]
    if data.dtype == np.int16:
        return fs, np.asarray(data)
    if data.dtype.kind == "f":
        return fs, np.clip(
            np.round(np.asarray(data, np.float32) * np.float32(32767.0)), -32768, 32767
        ).astype(np.int16)
    scale = 32767.0 / np.iinfo(data.dtype).max
    return fs, np.round(np.asarray(data, np.float64) * scale).astype(np.int16)


class DeviceDataset:
    """The packed corpus on one device.

    ``starts_for(piece_idx, begins_sec)`` turns the loader's chunk
    descriptors into int32 starts in the packed tensor (on the host);
    ``slice_batch(starts)`` returns the float32 ``[B, chunk_samples, C]``
    chunks on the device, equal to the host slicer's floats.  ``device``
    is the card (``cuda``) unless given: pass ``device="cpu"`` without
    one.  ``fs``, ``n_channel`` and ``nbytes`` (of the packed tensor)
    describe it."""

    def __init__(self, dataset, chunk_samples: int, device=None, max_bytes: int = 8 << 30):
        device = torch.device("cuda" if device is None else device)
        self.chunk_samples = int(chunk_samples)
        pad = self.chunk_samples + 2
        read = [_read_piece_int16(dataset.get_path(i)) for i in range(len(dataset.data))]
        pieces = [p for _, p in read]
        n_channel = pieces[0].shape[1]
        if any(p.shape[1] != n_channel for p in pieces):
            raise ValueError("device dataset requires a uniform channel count")
        if any(fs != read[0][0] for fs, _ in read):
            raise ValueError("device dataset requires a uniform sample rate")
        total = pad + sum(p.shape[0] + pad for p in pieces)
        if total * n_channel * 2 > max_bytes:
            raise ValueError(
                f"packed corpus is {total * n_channel * 2 / 2**30:.1f} GiB "
                f"(> {max_bytes / 2**30:.0f} GiB) — use the host loader"
            )
        if total >= 2**31:
            raise ValueError("corpus exceeds int32 indexing — use the host loader")
        # packed in (pinned) host memory, uploaded in one copy
        host = torch.zeros((total, n_channel), dtype=torch.int16, pin_memory=device.type == "cuda")
        packed = host.numpy()
        bases = np.empty(len(pieces), np.int64)
        off = pad
        for i, p in enumerate(pieces):
            bases[i] = off
            packed[off: off + p.shape[0]] = p
            off += p.shape[0] + pad
        self.fs = int(read[0][0])
        self.n_channel = n_channel
        self.nbytes = packed.nbytes
        self.device = device
        self._bases = bases
        self._lengths = np.array([p.shape[0] for p in pieces], np.int64)
        self._data = host.to(device)
        # every chunk of the packed tensor as a view: row s is [s, s + n)
        self._chunks = self._data.as_strided(
            (total - self.chunk_samples + 1, self.chunk_samples, n_channel), (n_channel, n_channel, 1))

    def starts_for(self, piece_idx, begins_sec) -> np.ndarray:
        """Loader descriptors -> int32 starts in the packed tensor, on the
        host: ``floor(begin * fs)`` like ``read_audio_slice``, clamped so that
        no start leaves its piece's pad zones."""
        piece_idx = np.asarray(piece_idx, np.int64)
        b = np.floor(np.asarray(begins_sec, np.float64) * self.fs).astype(np.int64)
        # chunks overhang their piece by at most one chunk a side; the clamp
        # keeps a malformed descriptor inside the pad zone (zeros either way)
        b = np.clip(b, -self.chunk_samples - 1, self._lengths[piece_idx] + 1)
        return (self._bases[piece_idx] + b).astype(np.int32)

    def slice_batch(self, starts: np.ndarray) -> torch.Tensor:
        """``[B]`` int32 starts -> float32 ``[B, chunk_samples, C]`` on the
        device."""
        idx = torch.from_numpy(np.asarray(starts, np.int64)).to(self.device)
        return dequantize_int16(self._chunks.index_select(0, idx))
