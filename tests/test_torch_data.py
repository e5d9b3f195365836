"""The port's own copies of the host-side modules (``data/note``, ``midi``,
``audio``, ``labels``, ``dataset``, ``augment``, ``eval`` and the dataset
CLI) against the JAX package's, on the same seeded inputs: they are
numpy-only code under the same names, so every result must be equal, not
just close.  Then the import guard: after the port's entry points have run
(dataset build, a tiny training run, a transcription), no module of
``jax``, ``jaxlib``, ``flax`` or ``transkun_tpu`` is loaded.  That runs in a
subprocess, since this test process imports ``transkun_tpu`` itself."""

import csv
import json
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from transkun_tpu.cli import create_dataset_maestro as jax_create
from transkun_tpu.data import audio as jaudio
from transkun_tpu.data import augment as jaugment
from transkun_tpu.data import dataset as jdataset
from transkun_tpu.data import labels as jlabels
from transkun_tpu.data import midi as jmidi
from transkun_tpu.data import note as jnote
from transkun_tpu.eval import evaluation as jevaluation
from transkun_tpu_torch.cli import create_dataset_maestro as port_create
from transkun_tpu_torch.data import audio as paudio
from transkun_tpu_torch.data import augment as paugment
from transkun_tpu_torch.data import dataset as pdataset
from transkun_tpu_torch.data import labels as plabels
from transkun_tpu_torch.data import midi as pmidi
from transkun_tpu_torch.data import note as pnote
from transkun_tpu_torch.eval import evaluation as pevaluation
from transkun_tpu_torch.models.config import default_conf_path, load_default_conf
from transkun_tpu_torch.models.transkun import target_midi_pitches

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


FS = 4000
FIELDS = ("start", "end", "pitch", "velocity", "hasOnset", "hasOffset")

def _fields(notes):
    return [tuple(getattr(n, f) for f in FIELDS) for n in notes]


def _events(seed, cls, cc_cls=None, dur=6.0):
    """Seeded notes (two same-pitch overlaps among them) and, with
    ``cc_cls``, a sustain and an una-corda stream."""
    rng = np.random.default_rng(seed)
    notes, t = [], 0.1
    while t < dur - 1.0:
        pitch = int(rng.integers(40, 52))
        notes.append(cls(t, t + float(rng.uniform(0.1, 0.9)), pitch, int(rng.integers(20, 120))))
        t += float(rng.uniform(0.05, 0.3))
    if cc_cls is None:
        return notes
    ccs = [cc_cls(num, int(rng.integers(0, 128)), float(tt))
           for num in (64, 67) for tt in np.sort(rng.uniform(0, dur, size=12))]
    return notes, sorted(ccs, key=lambda c: c.time)


def test_default_conf_is_the_ports_own_file():
    path = default_conf_path()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(pnote.__file__)))
    assert os.path.dirname(os.path.dirname(path)) == pkg
    with open(path) as f:
        own = json.load(f)
    here = os.path.dirname(os.path.abspath(jnote.__file__))
    with open(os.path.join(here, "..", "pretrained", "2.0.conf")) as f:
        theirs = json.load(f)
    assert own["Model"]["module"] == "transkun_tpu_torch.models.transkun"
    assert own["Model"]["config"] == theirs["Model"]["config"]
    assert load_default_conf()[1].baseSize == 64


@pytest.mark.parametrize("extend", [True, False])
def test_parse_event_all_equal(extend):
    jn, jc = _events(1, jnote.Note, jnote.ControlChange)
    pn, pc = _events(1, pnote.Note, pnote.ControlChange)
    want = jnote.parse_event_all(jn, jc, extend_sustain_pedal=extend)
    got = pnote.parse_event_all(pn, pc, extend_sustain_pedal=extend)
    assert _fields(got) == _fields(want) and any(n.pitch < 0 for n in got)
    index_j, index_p = jnote.create_index_events(want), pnote.create_index_events(got)
    for a, b in zip(index_p, index_j):
        np.testing.assert_array_equal(a, b)
    assert pnote.query_interval(1.0, 2.5, index_p) == jnote.query_interval(1.0, 2.5, index_j)


@pytest.mark.parametrize("n_notes", [40, 700])  # the scalar and the vectorized form
def test_resolve_overlapping_equal(n_notes):
    dur = n_notes * 0.2
    want = jnote.resolve_overlapping(_events(2, jnote.Note, dur=dur))
    got = pnote.resolve_overlapping(_events(2, pnote.Note, dur=dur))
    assert _fields(got) == _fields(want)
    pnote.validate_notes(got)


def test_midi_round_trip_equal(tmp_path):
    jn, jc = _events(3, jnote.Note, jnote.ControlChange)
    pn, pc = _events(3, pnote.Note, pnote.ControlChange)
    jn, pn = jnote.resolve_overlapping(jn), pnote.resolve_overlapping(pn)
    jmidi.write_midi(jn, str(tmp_path / "j.mid"))
    pmidi.write_midi(pn, str(tmp_path / "p.mid"))
    assert (tmp_path / "j.mid").read_bytes() == (tmp_path / "p.mid").read_bytes()
    want, got = jmidi.read_midi(str(tmp_path / "j.mid")), pmidi.read_midi(str(tmp_path / "j.mid"))
    assert _fields(got.notes) == _fields(want.notes) and len(got.notes) == len(pn)
    assert [(c.number, c.value, c.time) for c in got.control_changes] == \
        [(c.number, c.value, c.time) for c in want.control_changes]
    assert isinstance(got.notes[0], pnote.Note)


def test_audio_read_and_resample_equal(tmp_path):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(FS, 2)) * 8000).astype(np.int16)
    wavfile.write(str(tmp_path / "a.wav"), FS, x)
    fs_j, a_j = jaudio.read_audio(str(tmp_path / "a.wav"))
    fs_p, a_p = paudio.read_audio(str(tmp_path / "a.wav"))
    assert fs_j == fs_p == FS
    np.testing.assert_array_equal(a_p, a_j)
    np.testing.assert_array_equal(paudio.resample(a_p, FS, 3000), jaudio.resample(a_j, FS, 3000))
    slice_p, fs_p = paudio.read_audio_slice(str(tmp_path / "a.wav"), 100, 900)
    slice_j, fs_j = jaudio.read_audio_slice(str(tmp_path / "a.wav"), 100, 900)
    assert fs_p == fs_j == FS and slice_p.shape[0] > 0
    np.testing.assert_array_equal(slice_p, slice_j)


def test_labels_equal():
    pitches = target_midi_pitches()
    jn = jnote.resolve_overlapping(_events(5, jnote.Note))
    pn = pnote.resolve_overlapping(_events(5, pnote.Note))
    want = jlabels.prepare_intervals(jn, 64 / FS, pitches)
    got = plabels.prepare_intervals(pn, 64 / FS, pitches)
    assert got == want and sum(len(v) for v in got["intervals"]) > 0
    assert plabels.prepare_intervals_no_quantize(pn, pitches) == \
        jlabels.prepare_intervals_no_quantize(jn, pitches)
    for a, b in zip(plabels.encode_batch([pn, pn[:7]], 64 / FS, pitches, 16).astuple(),
                    jlabels.encode_batch([jn, jn[:7]], 64 / FS, pitches, 16).astuple()):
        np.testing.assert_array_equal(a, b)


def test_compare_transcription_equal():
    def pair(cls, resolve):
        gt = resolve(_events(6, cls))
        est = [cls(n.start + 0.01 * (i % 7), n.end + 0.03, n.pitch, max(1, n.velocity - i % 9))
               for i, n in enumerate(gt) if i % 5]
        return resolve(est), gt

    want = jevaluation.compare_transcription(*pair(jnote.Note, jnote.resolve_overlapping))
    got = pevaluation.compare_transcription(*pair(pnote.Note, pnote.resolve_overlapping))
    assert got.keys() == want.keys() and "note+offset" in got
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    a, b = [(0.0, 1.0), (2.0, 3.5)], [(0.5, 1.5), (2.0, 3.0)]
    assert pevaluation.compare_bracket(a, b) == jevaluation.compare_bracket(a, b)
    assert pevaluation.compare_framewise(a, b) == jevaluation.compare_framewise(a, b)


def _corpus(root, midi_mod, note_mod, n_pieces=2, dur=3.0):
    """A MAESTRO-layout corpus of sine notes; returns the meta csv path."""
    os.makedirs(os.path.join(root, "2020"))
    rng = np.random.default_rng(0)
    rows = []
    for i, split in enumerate(["train", "validation", "test"][:n_pieces]):
        wav, mid = f"2020/p{i}.wav", f"2020/p{i}.midi"
        notes, t = [], 0.2
        while t < dur - 0.5:
            notes.append(note_mod.Note(t, t + float(rng.uniform(0.2, 0.4)),
                                       int(rng.integers(40, 80)), int(rng.integers(30, 100))))
            t += float(rng.uniform(0.3, 0.6))
        midi_mod.write_midi(notes, os.path.join(root, mid))
        tt = np.arange(int(dur * FS)) / FS
        x = sum(0.1 * ((tt >= n.start) & (tt < n.end))
                * np.sin(2 * np.pi * 440 * 2 ** ((n.pitch - 69) / 12) * tt) for n in notes)
        wavfile.write(os.path.join(root, wav), FS, (np.clip(x, -1, 1) * 32000).astype(np.int16))
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"p{i}", "split": split,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": dur})
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return meta


def _plain(obj):
    """Pickled metadata with every Note turned into its field tuple."""
    if hasattr(obj, "hasOnset"):
        return tuple(getattr(obj, f) for f in FIELDS)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """One corpus, its pickles built by the JAX package's dataset CLI and by
    the port's."""
    tmp = tmp_path_factory.mktemp("data")
    root = str(tmp / "corpus")
    meta = _corpus(root, pmidi, pnote, n_pieces=3)
    jax_create.main([root, meta, str(tmp / "j")])
    port_create.main([root, meta, str(tmp / "p")])
    return root, str(tmp / "j"), str(tmp / "p")


def test_create_dataset_maestro_pickles_equal(pickles):
    _, dir_j, dir_p = pickles
    assert sorted(os.listdir(dir_p)) == sorted(os.listdir(dir_j)) != []
    for name in os.listdir(dir_j):
        with open(os.path.join(dir_j, name), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(dir_p, name), "rb") as f:
            got = pickle.load(f)
        assert _plain(got) == _plain(want) and len(got) == 1
        assert type(got[0]["notes"][0]).__module__ == "transkun_tpu_torch.data.note"


def test_dataset_chunks_and_batches_equal(pickles):
    root, dir_j, dir_p = pickles
    ds_j = jdataset.DatasetMaestro(root, os.path.join(dir_j, "train.pickle"))
    ds_p = pdataset.DatasetMaestro(root, os.path.join(dir_p, "train.pickle"))
    it_j = jdataset.DatasetMaestroIterator(ds_j, 1.0, 2.0, seed=11, notes_strictly_contained=False)
    it_p = pdataset.DatasetMaestroIterator(ds_p, 1.0, 2.0, seed=11, notes_strictly_contained=False)
    assert it_p.chunksAll == it_j.chunksAll and len(it_p) > 2
    for i in (0, len(it_p) // 2, len(it_p) - 1):
        want, got = it_j[i], it_p[i]
        assert _fields(got["notes"]) == _fields(want["notes"])
        np.testing.assert_array_equal(got["audioSlice"], want["audioSlice"])
        assert (got["fs"], got["begin"], got["pieceIdx"]) == (want["fs"], want["begin"], want["pieceIdx"])
    batches_j = list(jdataset.BatchLoader(it_j, 2, shuffle=True, seed=1, drop_last=True, num_workers=0))
    batches_p = list(pdataset.BatchLoader(it_p, 2, shuffle=True, seed=1, drop_last=True, num_workers=0))
    assert len(batches_p) == len(batches_j) > 0
    for got, want in zip(batches_p, batches_j):
        assert [_fields(n) for n in got["notes"]] == [_fields(n) for n in want["notes"]]
        for a, b in zip(got["audioSlices"], want["audioSlices"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [7, 8, 9])  # different draws of the chain's coin flips
def test_augmentation_equal(seed):
    x = (np.random.default_rng(seed).normal(size=(2 * FS, 2)) * 0.1).astype(np.float32)
    out = []
    for mod in (jaugment, paugment):
        np.random.seed(seed)  # the chain's noise comes from numpy's global generator
        out.append(mod.Augmentator(sampleRate=FS, rng=random.Random(seed))(x))
    np.testing.assert_array_equal(out[1], out[0])
    assert out[1].shape[0] > 0 and not np.array_equal(out[1][: len(x)], x[: len(out[1])])
    shift = [mod.AugmentatorPitchShiftOnly(FS, rng=random.Random(seed))(x)
             for mod in (jaugment, paugment)]
    np.testing.assert_array_equal(shift[1], shift[0])


TINY1 = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0, "contextDropoutProb": 0.0,
}

GUARD = """
import os, shutil, sys
import numpy as np
from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset
from transkun_tpu_torch.cli.train import main as train
from transkun_tpu_torch.cli.transcribe import main as transcribe

tmp, root, meta, conf = sys.argv[1:5]
create_dataset([root, meta, os.path.join(tmp, "pickles")])
ckpt = os.path.join(tmp, "ckpt.pt")
os.environ["TRANSKUN_TPU_FUSED_ATTN"] = os.environ["TRANSKUN_TPU_FUSED_MLP"] = "1"
run = train([ckpt, "--datasetPath", root,
             "--datasetMetaFile_train", os.path.join(tmp, "pickles", "train.pickle"),
             "--datasetMetaFile_val", os.path.join(tmp, "pickles", "val.pickle"),
             "--modelConf", conf, "--batchSize", "2", "--maxEvents", "8", "--statsEvery", "2",
             "--ckptEvery", "2", "--logEvery", "1", "--seed", "3", "--warmupCutoff", "0",
             "--nIter", "100", "--dataLoaderWorkers", "0", "--device", "cpu", "--maxEpoch", "1"])
assert run["steps"] >= 2 and run["val_batches"] >= 1 and np.isfinite(run["losses"]).all()
out = os.path.join(tmp, "out.mid")
transcribe([os.path.join(root, "2020", "p1.wav"), out, "--conf", conf, "--weight", ckpt,
            "--device", "cpu"])
assert os.path.exists(out)
from transkun_tpu_torch import crf_minimal_example
from transkun_tpu_torch.cli import compute_metrics, gen_conf, plot_deviation
from transkun_tpu_torch.parallel import init_distributed, process_info
from transkun_tpu_torch.utils import profiling
for sub in ("est", "gt"):
    os.makedirs(os.path.join(tmp, sub))
    shutil.copy(os.path.join(root, "2020", "p1.midi"), os.path.join(tmp, sub, "p1.midi"))
metrics = os.path.join(tmp, "metrics.json")
compute_metrics.main([os.path.join(tmp, "est"), os.path.join(tmp, "gt"), "--outputJSON", metrics])
plot_deviation.main([metrics, "--cumulative", "--output", os.path.join(tmp, "dev.png"), "--noDisplay"])
gen_conf.main([])
crf_minimal_example.main(["--device", "cpu"])
assert not init_distributed("cpu") and process_info() == (0, 1)
with profiling.device_trace(os.path.join(tmp, "trace")):
    profiling.block(crf_minimal_example.main(["--device", "cpu"]))
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "transkun_tpu")]
assert not bad, bad
print("entry points ran,", run["steps"], "steps")
"""


def test_entry_points_import_nothing_of_jax(tmp_path):
    """Dataset build, a tiny CPU training run on the fused route (plain
    versions), a transcription with the saved weights, the evaluation,
    plotting and conf CLIs, the semi-CRF example, the process-group and
    profiling modules and ``chip_smoke``'s import, in a fresh interpreter:
    then no module of jax, jaxlib, flax or transkun_tpu may be loaded."""
    root = str(tmp_path / "corpus")
    meta = _corpus(root, pmidi, pnote)
    conf = tmp_path / "tiny.conf"
    conf.write_text(json.dumps(
        {"Model": {"module": "transkun_tpu_torch.models.transkun", "config": TINY1}}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRANSKUN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", GUARD, str(tmp_path), root, meta, str(conf)],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "entry points ran" in proc.stdout


def test_guard_catches_a_stray_import(tmp_path):
    """The guard's own condition fails when a JAX-free module of the JAX
    package is imported, which the earlier guard let pass."""
    code = ("import sys, transkun_tpu_torch.data.note, transkun_tpu.data.note\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'transkun_tpu')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "transkun_tpu.data.note" in proc.stderr
