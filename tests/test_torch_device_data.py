"""The port's device-resident training corpus (``data/device_dataset.py``)
and the trainer's int16 link against the JAX package, on the CPU at tiny
sizes.

- ``dequantize_int16`` equals ``np.divide(v, 32767, dtype=float32)`` on all
  65,536 int16 values, bit for bit (the card is checked by
  ``chip_smoke.py`` path 9);
- ``DeviceDataset(..., device="cpu")``: the JAX package's ``starts_for``
  integers, slices within 1 ulp of its (its in-jit divide), and the port's
  host loader floats bit for bit, overhanging chunks included; its wav
  reader and its guards as the JAX package's, messages included;
- ``quantize_link`` equal to the JAX package's ``_quantize_link``;
- ``cli.train.main``: ``--deviceData on``, ``off --linkInt16 force`` and
  ``off --linkInt16 off`` end one epoch with equal parameters bit for bit,
  in one process and in two gloo ranks; ``auto``'s choice and fallback;
  under ``--linkInt16 force --augment`` the stats pass decodes the cropped
  float batch, as the JAX trainer's, and only the frames take the link.
"""

import csv
import functools
import json
import os
import pickle

import jax  # noqa: F401  (the JAX package on the CPU, as the reference)
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from transkun_tpu.data import device_dataset as jdd
from transkun_tpu.models.transkun import _quantize_link as jax_quantize_link
from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset
from transkun_tpu_torch.cli.train import main as train
from transkun_tpu_torch.data import dataset as D
from transkun_tpu_torch.data import device_dataset as pdd
from transkun_tpu_torch.data.midi import write_midi
from transkun_tpu_torch.data.note import Note
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun, quantize_link
from transkun_tpu_torch.train import checkpoint as ckpt_mod

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0, "segmentHopSizeInSecond": 1.0,
}
ROUTES = {"device": ["--deviceData", "on"],
          "int16 link": ["--deviceData", "off", "--linkInt16", "force"],
          "float32 link": ["--deviceData", "off", "--linkInt16", "off"]}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


# -- the dequantize ------------------------------------------------------------------


def test_dequantize_int16_equals_np_divide_on_every_value():
    v = np.arange(-32768, 32768).astype(np.int16)
    got = pdd.dequantize_int16(torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.divide(v, 32767, dtype=np.float32)))


def test_frames_of_the_int16_link_equal_the_host_floats():
    """``TransKun.frames`` on host int16 audio (uploaded as int16, divided on
    the device), on the host floats and on a float tensor: the same frames."""
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", seed=0)
    rng = np.random.default_rng(1)
    i16 = rng.integers(-32768, 32768, size=(2, 3000, 1)).astype(np.int16)
    floats = np.divide(i16, 32767, dtype=np.float32)
    assert quantize_link(floats, None, 32767.0).dtype == np.int16
    want = model.frames(floats)
    for x in (i16, torch.from_numpy(floats), torch.from_numpy(i16)):
        assert torch.equal(model.frames(x), want)


# -- the corpus against the JAX package's and the host loader ---------------------------


@pytest.fixture(scope="module")
def stereo_corpus(tmp_path_factory):
    """The JAX package's device-dataset test corpus: three 4 s stereo int16
    pieces at 4 kHz with six notes each."""
    root = tmp_path_factory.mktemp("stereo")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        wav = f"p{i}.wav"
        wavfile.write(str(root / wav), FS, (rng.normal(size=(4 * FS, 2)) * 3000).astype(np.int16))
        rows.append({"audio_filename": wav, "duration": 4.0, "fs": FS, "nSamples": 4 * FS, "nChannel": 2,
                     "notes": [Note(0.2 + 0.5 * k, 0.5 + 0.5 * k, 60 + k, 80) for k in range(6)]})
    pkl = root / "train.pickle"
    with open(pkl, "wb") as f:
        pickle.dump(rows, f)
    return D.DatasetMaestro(str(root), str(pkl))


def test_device_dataset_matches_jax_and_the_host_loader(stereo_corpus):
    ds = stereo_corpus
    n_chunk = 2 * FS
    dd = pdd.DeviceDataset(ds, n_chunk, device="cpu")
    jd = jdd.DeviceDataset(ds, n_chunk)
    assert (dd.fs, dd.n_channel, dd.nbytes) == (jd.fs, jd.n_channel, jd.nbytes) == (FS, 2, jd.nbytes)
    it_host = D.DatasetMaestroIterator(ds, 1.0, 2.0, seed=7, notes_strictly_contained=False)
    it_dev = D.DatasetMaestroIterator(ds, 1.0, 2.0, seed=7, notes_strictly_contained=False, skip_audio=True)
    assert it_host.chunksAll == it_dev.chunksAll
    # overhanging chunks (zeros past either edge) are compared too
    assert any(b < 0 for _, b, _ in it_host.chunksAll) and any(e > 4.0 for *_, e in it_host.chunksAll)
    host = D.BatchLoader(it_host, 4, shuffle=True, seed=3, num_workers=0)
    dev = D.BatchLoader(it_dev, 4, shuffle=True, seed=3, num_workers=0, collate=D.collate_fn_device)
    n_cmp = 0
    for hb, db in zip(host, dev):
        starts = dd.starts_for(db["pieceIdx"], db["begins"])
        assert starts.dtype == np.int32
        np.testing.assert_array_equal(starts, jd.starts_for(db["pieceIdx"], db["begins"]))
        got = dd.slice_batch(starts)
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, n_chunk, 2)
        ref = hb["audioSlices"][:, :n_chunk]
        got = got.numpy()[:, : ref.shape[1]]
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert np.abs(_bits(got) - _bits(np.asarray(jd.slice_batch(starts))[:, : ref.shape[1]])).max() <= 1
        assert [[(n.start, n.end, n.pitch, n.velocity) for n in notes] for notes in hb["notes"]] == \
            [[(n.start, n.end, n.pitch, n.velocity) for n in notes] for notes in db["notes"]]
        n_cmp += 1
    assert n_cmp > 0


@pytest.mark.parametrize("payload", ["int16", "float32", "int32"])
def test_wav_reader_matches_jax(tmp_path, payload):
    """Each payload type of a wav reads to the JAX package's int16 samples."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1000, 2)) * 0.3
    data = {"int16": (x * 3000).astype(np.int16), "float32": np.clip(x, -1.2, 1.2).astype(np.float32),
            "int32": (np.clip(x, -1, 1) * 2**31 * 0.99).astype(np.int32)}[payload]
    path = str(tmp_path / "p.wav")
    wavfile.write(path, FS, data)
    fs, got = pdd._read_piece_int16(path)
    jfs, want = jdd._read_piece_int16(path)
    assert fs == jfs == FS and got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


class _Pieces:
    """A dataset of given (fs, int16 samples) pieces, read through a
    patched ``_read_piece_int16`` of both packages."""

    def __init__(self, pieces):
        self.pieces = pieces
        self.data = [None] * len(pieces)

    def get_path(self, i):
        return i


@pytest.mark.parametrize("guard", ["channels", "sample rate", "max_bytes", "int32"])
def test_guards_raise_the_jax_packages_messages(monkeypatch, guard):
    mono, stereo = np.zeros((100, 1), np.int16), np.zeros((100, 2), np.int16)
    pieces, kw = {
        "channels": ([(FS, mono), (FS, stereo)], {}),
        "sample rate": ([(FS, mono), (2 * FS, mono)], {}),
        "max_bytes": ([(FS, mono)], {"max_bytes": 256}),
        # 2**31 samples of a zero-stride view: past int32, under the 8 GiB guard
        "int32": ([(FS, np.broadcast_to(mono[:1], (2**31, 1)))], {}),
    }[guard]
    ds = _Pieces(pieces)
    for mod in (pdd, jdd):
        monkeypatch.setattr(mod, "_read_piece_int16", lambda i: ds.pieces[i])
    with pytest.raises(ValueError) as port:
        pdd.DeviceDataset(ds, 64, device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        jdd.DeviceDataset(ds, 64, **kw)
    assert str(port.value) == str(ref.value)


# -- the link ----------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [None, True, False])
@pytest.mark.parametrize("scale", [32768.0, 32767.0])
def test_quantize_link_matches_jax(mode, scale):
    rng = np.random.default_rng(3)
    v = rng.integers(-32768, 32768, size=(2, 700_000)).astype(np.int16)
    exact = (v / np.float32(scale)).astype(np.float32) if scale == 32768.0 else np.divide(
        v, 32767, dtype=np.float32)
    late = exact.copy()
    late[1, -1] += np.float32(1e-6)  # the last block, past the first 2**19 samples, is inexact
    inexact = (rng.normal(size=(1, 5000)) * 0.2).astype(np.float32)
    clipping = np.array([[0.5, 1.5, -1.5, 1.0, -1.0]], np.float32)
    for x in (exact, late, inexact, clipping, v):
        got, want = quantize_link(x, mode, scale), jax_quantize_link(x, mode, scale)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert quantize_link(exact, mode, scale).dtype == (np.float32 if mode is False else np.int16)
    assert quantize_link(late, None, scale).dtype == np.float32


# -- the trainer ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 3 s training pieces and one for validation through the port's
    dataset CLI, and the tiny conf; returns the trainer's arguments."""
    tmp = tmp_path_factory.mktemp("corpus")
    root = tmp / "corpus"
    os.makedirs(root / "2020")
    rng = np.random.default_rng(0)
    rows = []
    for i, split in enumerate(["train", "train", "train", "validation"]):
        notes, t = [], 0.2
        while t < 2.5:
            notes.append(Note(t, t + float(rng.uniform(0.2, 0.4)), int(rng.integers(40, 80)),
                              int(rng.integers(30, 100))))
            t += float(rng.uniform(0.3, 0.6))
        wav, mid = f"2020/p{i}.wav", f"2020/p{i}.midi"
        write_midi(notes, str(root / mid))
        tt = np.arange(3 * FS) / FS
        x = sum(0.1 * ((tt >= n.start) & (tt < n.end)) * np.sin(2 * np.pi * 440 * 2 ** ((n.pitch - 69) / 12) * tt)
                for n in notes) + rng.normal(size=tt.shape) * 0.01
        wavfile.write(str(root / wav), FS, (np.clip(x, -1, 1) * 32000).astype(np.int16))
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"p{i}", "split": split,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": 3.0})
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    create_dataset([str(root), str(root / "meta.csv"), str(tmp / "pickles")])
    conf = tmp / "tiny.conf"
    conf.write_text(json.dumps({"Model": {"module": "transkun_tpu_torch.models.transkun", "config": TINY}}))
    return tmp, ["--datasetPath", str(root),
                 "--datasetMetaFile_train", str(tmp / "pickles" / "train.pickle"),
                 "--datasetMetaFile_val", str(tmp / "pickles" / "val.pickle"),
                 "--modelConf", str(conf), "--maxEvents", "8", "--statsEvery", "4",
                 "--validateEvery", "2", "--logEvery", "1", "--seed", "5", "--warmupCutoff", "0",
                 "--nIter", "100", "--dataLoaderWorkers", "0", "--device", "cpu", "--maxEpoch", "1"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_three_training_routes_end_with_the_same_parameters(corpus, ranks):
    """One epoch on each route from the same seed: the same losses and the
    same final parameters, bit for bit; with ``--nDevices 2`` each gloo rank
    packs its own corpus and slices its own shard."""
    tmp, args = corpus
    extra = ["--batchSize", "2"] if ranks == 1 else ["--batchSize", "1", "--nDevices", "2"]
    records, params = {}, {}
    for name, route in ROUTES.items():
        ckpt = str(tmp / f"ckpt_{ranks}_{name.replace(' ', '_')}.pt")
        records[name] = train([ckpt, *args, *extra, *route])
        params[name] = ckpt_mod.load_checkpoint(ckpt)["state_dict"]
    dev, i16, f32 = (records[k] for k in ROUTES)
    assert dev["steps"] == i16["steps"] == f32["steps"] >= 3 and dev["stats_passes"] >= 1
    assert (dev["device_data"], i16["device_data"], f32["device_data"]) == (True, False, False)
    assert dev["device_data_bytes"] == 2 * (2 * FS + 2 + 3 * (3 * FS + 2 * FS + 2))
    assert (dev["link_dtype"], i16["link_dtype"], f32["link_dtype"]) == (None, "int16", "float32")
    assert len(dev["iter_seconds"]) == len(dev["step_seconds"]) == dev["steps"]
    assert all(i >= s for i, s in zip(dev["iter_seconds"], dev["step_seconds"]))
    assert dev["losses"] == i16["losses"] == f32["losses"]
    for name in ("int16 link", "float32 link"):
        assert params[name].keys() == params["device"].keys()
        for key, value in params["device"].items():
            assert torch.equal(params[name][key], value), (name, key)


def test_stats_pass_decodes_the_cropped_float_batch(corpus, monkeypatch):
    """Under ``--linkInt16 force --augment`` only the frames' copy of the
    batch takes the int16 link: the stats pass decodes the cropped float
    batch, as the JAX trainer's (``audio[:, :min(n_chunk_samples, width)]``
    of ``batch["audioSlices"]``), so the logged train F1 and MSEs are of
    the audio the step saw before rounding."""
    tmp, args = corpus
    batches, stats_inputs, frames_inputs = [], [], []

    class RecordingLoader(D.BatchLoader):
        def __iter__(self):
            for batch in super().__iter__():
                batches.append(np.array(batch["audioSlices"]))
                yield batch

    def recorded(original, sink):
        def method(self, audio, *rest):
            sink.append(np.array(audio))
            return original(self, audio, *rest)
        return method

    monkeypatch.setattr(D, "BatchLoader", RecordingLoader)
    monkeypatch.setattr(TransKun, "compute_stats", recorded(TransKun.compute_stats, stats_inputs))
    monkeypatch.setattr(TransKun, "frames", recorded(TransKun.frames, frames_inputs))
    record = train([str(tmp / "ckpt_stats.pt"), *args, "--batchSize", "2", "--stopAtStep", "1",
                    "--statsEvery", "1", "--augment", "--deviceData", "off", "--linkInt16", "force"])
    assert record["link_dtype"] == "int16" and record["stats_passes"] >= 1
    n_chunk_samples = int(TINY["segmentSizeInSecond"] * FS)
    # the trainer's batches come first, in order; every step ran the stats pass
    for stats_audio, batch in zip(stats_inputs, batches):
        expected = batch[:, : min(n_chunk_samples, batch.shape[1])]
        assert stats_audio.dtype == np.float32
        np.testing.assert_array_equal(stats_audio, expected)
        # the frames' copy is the same batch through the link
        assert any(f.dtype == np.int16 and np.array_equal(f, jax_quantize_link(expected, True, 32767.0))
                   for f in frames_inputs)


def test_auto_takes_the_device_corpus_and_falls_back(corpus, monkeypatch, capsys):
    """``--deviceData auto`` packs the corpus without ``--augment`` and uses
    the host loader with it; past the size guard ``auto`` says why and uses
    the host loader, and ``on`` raises the guard's error.  ``on --augment``
    is refused with the JAX trainer's message."""
    tmp, args = corpus
    one = [*args, "--batchSize", "2", "--stopAtStep", "1", "--statsEvery", "0"]
    ckpt = str(tmp / "ckpt_auto.pt")
    assert train([ckpt, *one])["device_data"]
    os.remove(ckpt)
    augmented = train([ckpt, *one, "--augment"])
    assert not augmented["device_data"] and augmented["link_dtype"] is not None
    os.remove(ckpt)
    with pytest.raises(SystemExit, match="--deviceData on is incompatible with: host augmentation"):
        train([ckpt, *one, "--augment", "--deviceData", "on"])

    monkeypatch.setattr(pdd, "DeviceDataset", functools.partial(pdd.DeviceDataset, max_bytes=1024))
    capsys.readouterr()
    fell_back = train([ckpt, *one])
    assert not fell_back["device_data"] and fell_back["link_dtype"] == "int16"
    assert "device dataset unavailable (packed corpus is 0.0 GiB (> 0 GiB) — use the host loader); " \
           "using host loader" in capsys.readouterr().out
    os.remove(ckpt)
    with pytest.raises(ValueError, match="use the host loader"):
        train([ckpt, *one, "--deviceData", "on"])


def test_training_spans_one_a_step_and_a_line_a_fetch(corpus, monkeypatch, capsys):
    """With ``TRANSKUN_TPU_TIMING`` set the loop records, a step at a time,
    one ``transkun.input`` (with its slice, frames and labels),
    ``transkun.step``, ``forward``, ``backward``, ``clip`` and
    ``optimizer``, and one ``transkun.fetch`` a metric fetch: every
    ``--logEvery`` steps and at the epoch's last step.  Set to 1 it prints
    one ``[train]`` line a fetch; ``silent`` prints none."""
    from transkun_tpu_torch.utils import profiling

    tmp, args = corpus
    one = [*args, "--batchSize", "2", "--logEvery", "2", "--hopSize", "2"]
    monkeypatch.setenv(profiling.ENV, "1")
    profiling.reset()
    capsys.readouterr()
    record = train([str(tmp / "ckpt_spans.pt"), *one, "--statsEvery", "8"])
    steps = record["steps"]
    fetches = -(-steps // 2)
    assert steps % 2 and record["stats_passes"] == 1  # the epoch's last fetch is its own
    counts = {k[len("transkun."):]: n for k, (n, _) in profiling.totals().items()}
    for name in ("input", "slice", "frames", "labels", "step", "forward", "backward", "clip", "optimizer"):
        assert counts[name] == steps, name
    assert "allreduce" not in counts and counts["fetch"] == fetches and counts["ckpt"] == 1
    assert counts["stats"] == 1
    assert profiling.counters() == {"steps": steps, "fetches": fetches, "stats_passes": 1}
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[train]")]
    assert len(lines) == fetches
    assert all(" step " in line and "(forward " in line and "optimizer " in line and " fetch " in line
               for line in lines)
    monkeypatch.setenv(profiling.ENV, "silent")
    os.remove(tmp / "ckpt_spans.pt")
    train([str(tmp / "ckpt_spans.pt"), *one, "--statsEvery", "0", "--stopAtStep", "2"])
    assert "[train]" not in capsys.readouterr().out
    assert profiling.counters()["fetches"] == fetches + 1
    profiling.reset()
