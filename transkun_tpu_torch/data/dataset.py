"""Dataset construction and chunk iteration for training.

Counterpart of the reference data pipeline (``transkun/Data.py:251-968``):
metadata builders over the MAESTRO layout, the pickle-index dataset with
interval queries, the dithered fixed-size chunk iterator with deterministic
epoch seeding, and the batching collate.  All host-side (CPU input pipeline).

The port's own copy of ``transkun_tpu/data/dataset.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import os
import pickle
import random
import wave
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .audio import read_audio_slice
from .midi import read_midi
from .note import (
    Note,
    create_index_events,
    parse_event_all,
    query_interval,
)


def parse_midi_file(
    midi_path: str, extend_sustain_pedal: bool = False, pedal_ext_offset: float = 0.0
) -> List[Note]:
    """MIDI file -> unified event list (ref ``parseMIDIFile``)."""
    mf = read_midi(midi_path)
    return parse_event_all(
        mf.notes,
        mf.control_changes,
        extend_sustain_pedal=extend_sustain_pedal,
        pedal_ext_offset=pedal_ext_offset,
    )


def _wav_meta(path: str) -> Tuple[int, int, int]:
    with wave.open(path) as f:
        return f.getframerate(), f.getnframes(), f.getnchannels()


def create_dataset_maestro_csv(
    dataset_path: str, meta_csv_path: str, extend_sustain_pedal: bool = True
) -> List[Dict]:
    """MAESTRO csv metadata -> sample dicts (ref ``createDatasetMaestroCSV``)."""
    samples = []
    with open(meta_csv_path) as f:
        for e in csv.DictReader(f):
            e = dict(e)
            midi_path = os.path.join(dataset_path, e["midi_filename"])
            audio_path = os.path.join(dataset_path, e["audio_filename"])
            events = parse_midi_file(midi_path, extend_sustain_pedal)
            fs, n_samples, n_channel = _wav_meta(audio_path)
            e.update(notes=events, fs=fs, nSamples=n_samples, nChannel=n_channel)
            samples.append(e)
    return samples


def create_dataset_maestro_json(
    dataset_path: str, meta_json_path: str, extend_sustain_pedal: bool = True
) -> List[Dict]:
    """MAESTRO v3 json metadata (column-major) -> sample dicts."""
    with open(meta_json_path) as f:
        meta = json.load(f)
    if isinstance(meta, dict):  # v3 column-major layout
        keys = list(meta.keys())
        n = len(meta[keys[0]])
        meta = [{k: meta[k][str(i) if str(i) in meta[k] else i] for k in keys} for i in range(n)]
    samples = []
    for e in meta:
        e = dict(e)
        midi_path = os.path.join(dataset_path, e["midi_filename"])
        audio_path = os.path.join(dataset_path, e["audio_filename"])
        events = parse_midi_file(midi_path, extend_sustain_pedal)
        fs, n_samples, n_channel = _wav_meta(audio_path)
        e.update(notes=events, fs=fs, nSamples=n_samples, nChannel=n_channel)
        samples.append(e)
    return samples


class DatasetMaestro:
    """Pickle-backed dataset with a per-piece interval index for O(log n)
    note-range queries (ref ``DatasetMaestro``, ``Data.py:457-595``)."""

    def __init__(self, dataset_path: str, annotation_pickle_path: str):
        self.datasetPath = dataset_path
        self.datasetAnnotationPicklePath = annotation_pickle_path
        with open(annotation_pickle_path, "rb") as f:
            self.data = pickle.load(f)
        self.durations = [float(e["duration"]) for e in self.data]
        for e in self.data:
            e["index"] = create_index_events(e["notes"])

    # DataLoader-worker-safe re-init (ref ``Data.py:484-490``)
    def __getstate__(self):
        return {
            "datasetPath": self.datasetPath,
            "datasetAnnotationPicklePath": self.datasetAnnotationPicklePath,
        }

    def __setstate__(self, d):
        self.__init__(d["datasetPath"], d["datasetAnnotationPicklePath"])

    def get_path(self, idx: int) -> str:
        return os.path.join(self.datasetPath, self.data[idx]["audio_filename"])

    def get_sample(self, idx: int, normalize: bool = True):
        from scipy.io import wavfile

        e = self.data[idx]
        fs, result = wavfile.read(self.get_path(idx), mmap=False)
        if normalize:
            result = np.divide(result, np.iinfo(result.dtype).max, dtype=np.float32)
        return e["audio_filename"], e["notes"], result, fs

    def fetch_data(
        self,
        idx: int,
        begin: float,
        end: float,
        audio_normalize: bool,
        notes_strictly_contained: bool,
        want_audio: bool = True,
    ):
        """Fetch [begin, end] seconds of audio + the notes inside, with
        boundary notes either dropped (strict) or trimmed and flagged
        (ref ``fetchData``, ``Data.py:528-574``).  ``want_audio=False``
        skips the wav read (device-resident datasets slice audio on
        device; the loader then only prepares labels)."""
        e = self.data[idx]
        if end < 0 and begin < 0:
            note_indices = []
        else:
            note_indices = query_interval(max(begin, 0.0), max(end, 0.0), e["index"])
        notes = [e["notes"][int(i)] for i in note_indices]
        if notes_strictly_contained:
            notes = [
                Note(n.start - begin, n.end - begin, n.pitch, n.velocity)
                for n in notes
                if n.start >= begin and n.end < end
            ]
        else:
            notes = [
                Note(
                    max(n.start, begin) - begin,
                    min(n.end, end) - begin,
                    n.pitch,
                    n.velocity,
                    n.start >= begin,
                    n.end < end,
                )
                for n in notes
            ]
        if not want_audio:
            return notes, None, int(self.data[idx].get("fs", 44100))
        audio, fs = read_audio_slice(self.get_path(idx), begin, end, audio_normalize)
        return notes, audio, fs


class DatasetMaestroIterator:
    """Pre-enumerated dithered fixed-size chunks with a deterministic epoch
    seed (ref ``DatasetMaestroIterator``, ``Data.py:846-927``).  Map-style:
    supports len() and indexing, so it drops into any sampler/loader."""

    def __init__(
        self,
        dataset: DatasetMaestro,
        hop_size_in_second: float,
        chunk_size_in_second: float,
        audio_normalize: bool = True,
        notes_strictly_contained: bool = True,
        dithering_frames: bool = True,
        seed: int = 1234,
        augmentator=None,
        skip_audio: bool = False,
    ):
        self.dataset = dataset
        self.hopSizeInSecond = hop_size_in_second
        self.chunkSizeInSecond = chunk_size_in_second
        self.audioNormalize = audio_normalize
        self.notesStrictlyContained = notes_strictly_contained
        self.augmentator = augmentator
        self.skipAudio = skip_audio
        if skip_audio and augmentator is not None:
            raise ValueError("augmentation needs host audio (skip_audio)")

        rand = random.Random(seed)
        chunks = []
        for idx, e in enumerate(dataset.data):
            duration = float(e["duration"])
            n_chunks = math.ceil((duration + chunk_size_in_second) / hop_size_in_second)
            hop_per_chunk = math.ceil(chunk_size_in_second / hop_size_in_second)
            for j in range(-hop_per_chunk, n_chunks + hop_per_chunk):
                shift = rand.random() - 0.5 if dithering_frames else 0.0
                begin = (j + shift) * hop_size_in_second - chunk_size_in_second / 2
                end = begin + chunk_size_in_second
                if begin < duration and end > 0:
                    chunks.append((idx, begin, end))
        rand.shuffle(chunks)
        self.chunksAll = chunks

    def __len__(self):
        return len(self.chunksAll)

    def __getitem__(self, i: int):
        if i >= len(self):
            raise IndexError()
        idx, begin, end = self.chunksAll[i]
        notes, audio, fs = self.dataset.fetch_data(
            idx,
            begin,
            end,
            audio_normalize=self.audioNormalize,
            notes_strictly_contained=self.notesStrictlyContained,
            want_audio=not self.skipAudio,
        )
        if self.augmentator is not None:
            audio = self.augmentator(audio)
        return {"notes": notes, "audioSlice": audio, "fs": fs,
                "begin": begin, "pieceIdx": idx}


def sample_slice(
    dataset: DatasetMaestro,
    duration_in_second: float,
    audio_normalize: bool = True,
    notes_strictly_contained: bool = True,
):
    """Sample one random duration-weighted chunk (ref ``sampleSlice``,
    ``Data.py:577-595``)."""
    idx = random.choices(range(len(dataset.durations)), dataset.durations)[0]
    dur = dataset.durations[idx]
    if dur < duration_in_second:
        begin, end = 0.0, dur
    else:
        begin = random.random() * (dur - duration_in_second)
        end = begin + duration_in_second
    return dataset.fetch_data(
        idx, begin, end, audio_normalize, notes_strictly_contained
    )


def midi_to_key_number(midi_number: int) -> int:
    """Piano MIDI range [21, 108] -> key index [0, 87] (ref ``Data.py:972-975``)."""
    return midi_number - 21


def collate_fn(batch):
    return batch


def collate_fn_batching(batch):
    """Stack audio (lengths may differ by <2 samples from float begin/end
    rounding; ref ``Data.py:932-946``)."""
    notes_batch = [s["notes"] for s in batch]
    slices = [s["audioSlice"] for s in batch]
    n_min = min(a.shape[0] for a in slices)
    n_max = max(a.shape[0] for a in slices)
    assert n_max - n_min < 2
    audio = np.stack([a[:n_min] for a in slices], axis=0)
    return {"notes": notes_batch, "audioSlices": audio}


def collate_fn_device(batch):
    """Collate for device-resident audio (``DeviceDataset``): labels plus
    the chunk descriptors; the audio itself is sliced on device from the
    packed corpus array."""
    return {
        "notes": [s["notes"] for s in batch],
        "pieceIdx": np.array([s["pieceIdx"] for s in batch], np.int64),
        "begins": np.array([s["begin"] for s in batch], np.float64),
    }


def collate_fn_randomized_len(batch):
    """Randomly right-crop the batch to a shared fraction of its length and
    drop notes beyond the crop (ref ``collate_fn_randmized_len``,
    ``Data.py:950-968``)."""
    r = random.random() * 0.5 + 0.5
    out = []
    for sample in batch:
        fs = sample["fs"]
        n = sample["audioSlice"].shape[0]
        keep = math.ceil(n * r)
        sample = dict(sample)
        sample["audioSlice"] = sample["audioSlice"][:keep, :]
        t = keep / fs
        sample["notes"] = [m for m in sample["notes"] if m.end < t]
        out.append(sample)
    return out


_WORKER_STATE = None


def _pool_init(data, seed):
    global _WORKER_STATE
    _WORKER_STATE = (data, seed)
    # the augmentation chain lazily imports scipy.signal (~4 s cold); pay it
    # once at worker startup, overlapped across workers, not on first batch
    if getattr(data, "augmentator", None) is not None:
        import scipy.fft  # noqa: F401
        import scipy.signal  # noqa: F401


def _pool_fetch(j):
    data, seed = _WORKER_STATE
    aug = getattr(data, "augmentator", None)
    if aug is not None and getattr(aug, "rng", None) is not None:
        # per-item seeding: augmentation depends only on (loader seed, item
        # index), not on which worker draws the item — deterministic across
        # worker counts (torch DataLoader workers are not)
        aug.rng.seed(seed * 1_000_003 + j)
    return data[j]


class BatchLoader:
    """Multi-epoch batch loader: shuffled shards of a map-style iterator,
    optional rank sharding for data parallelism, worker-based sample loading
    with batch prefetch (the reference's torch DataLoader +
    DistributedSampler + worker processes, ``train.py:120-126``).

    Workers default to PROCESSES when the iterator carries an augmentator
    (``use_processes=None`` auto): the augmentation chain is GIL-bound numpy
    (threads measured ~1x scaling), while fork workers scale linearly and
    inherit loaded modules.  Plain wav slicing stays on threads (cheap, and
    mmap-friendly)."""

    def __init__(
        self,
        data,
        batch_size: int,
        collate=collate_fn_batching,
        shuffle: bool = False,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        use_processes: Optional[bool] = None,
    ):
        self.data = data
        self.batch_size = batch_size
        self.collate = collate
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        if use_processes is None:
            # processes only pay off when there are cores to use them (the
            # augmentation chain is GIL-bound numpy, so threads don't scale,
            # but on a 1-core host processes just add pickle overhead)
            use_processes = (
                getattr(data, "augmentator", None) is not None
                and (os.cpu_count() or 1) > 1
            )
        self.use_processes = use_processes
        if use_processes:
            self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        order = list(range(len(data)))
        if shuffle:
            random.Random(seed).shuffle(order)
        order = order[rank::world_size]
        if drop_last:
            order = order[: len(order) // batch_size * batch_size]
        self.order = order
        self._drop_last = drop_last
        self._pool = None
        import threading

        self._aug_lock = threading.Lock()

    def __len__(self):
        if getattr(self, "_drop_last", True):
            return len(self.order) // self.batch_size
        return -(-len(self.order) // self.batch_size)

    def _batch_indices(self, i):
        return self.order[i * self.batch_size : (i + 1) * self.batch_size]

    def _fetch(self, j):
        # same per-item augmentation seeding as the process path
        # (_pool_fetch): the stream depends only on (loader seed, item
        # index), never on worker identity or count.  With threads the
        # augmentator's rng is SHARED, so seed+augment must not interleave —
        # the lock costs nothing real because the augmentation chain is
        # GIL-bound numpy anyway (threads never sped it up)
        aug = getattr(self.data, "augmentator", None)
        if aug is not None and getattr(aug, "rng", None) is not None:
            with self._aug_lock:
                aug.rng.seed(self.seed * 1_000_003 + j)
                return self.data[j]
        return self.data[j]

    def __iter__(self):
        if self.num_workers <= 0:
            for i in range(len(self)):
                yield self.collate(
                    [self._fetch(j) for j in self._batch_indices(i)]
                )
            return
        if self.use_processes:
            yield from self._iter_processes()
        else:
            yield from self._iter_threads()

    def _iter_threads(self):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            # one future PER SAMPLE (not per batch): samples of the same
            # batch load concurrently across workers, and `prefetch` batches
            # stay in flight.  No nested pools — workers only run
            # data[j]; collate runs on the consumer thread.
            def submit_batch(i):
                return [
                    pool.submit(self._fetch, j)
                    for j in self._batch_indices(i)
                ]

            yield from self._drain(submit_batch)

    def _ensure_pool(self):
        """One long-lived worker pool per loader, reused across epochs.

        Prefer the SPAWN context: the training CLI initializes CUDA (runtime
        threads, device buffers) before the first epoch, and forking a
        multithreaded parent is a documented deadlock hazard.  Spawn needs
        the dataset picklable; fall back to fork (torch DataLoader's
        default posture) when it is not.  Either way the pool is created
        ONCE, so the per-worker spawn import cost (~seconds) amortizes over
        the whole run."""
        if self._pool is None:
            import multiprocessing as mp
            import pickle

            try:
                pickle.dumps(self.data)
                method = "spawn"
            except Exception:
                method = "fork"
            ctx = mp.get_context(method)
            self._pool = ctx.Pool(
                self.num_workers, initializer=_pool_init,
                initargs=(self.data, self.seed),
            )
        return self._pool

    def close(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _iter_processes(self):
        pool = self._ensure_pool()

        def submit_batch(i):
            return [
                pool.apply_async(_pool_fetch, (j,))
                for j in self._batch_indices(i)
            ]

        yield from self._drain(submit_batch, lambda f: f.get())

    def _drain(self, submit_batch, result=lambda f: f.result()):
        from collections import deque

        pending = deque()
        nxt = 0
        while nxt < min(self.prefetch, len(self)):
            pending.append(submit_batch(nxt))
            nxt += 1
        for _ in range(len(self)):
            futs = pending.popleft()
            samples = [result(f) for f in futs]
            if nxt < len(self):
                pending.append(submit_batch(nxt))
                nxt += 1
            yield self.collate(samples)
