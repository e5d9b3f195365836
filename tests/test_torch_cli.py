"""The port's remaining entry points and public API against the JAX
package, on the CPU at tiny sizes: the trainer's two-rank mode (gloo ranks
spawned by ``--nDevices 2``, a resume, the TensorBoard tags),
``transcribe_many(devices=...)`` and the CLI's ``--allDevices``,
``compute_metrics``, ``gen_conf``, ``plot_deviation``, the semi-CRF example,
``param_count``, ``merge_params_tolerant``, ``utils.profiling`` and the
transcription's timing marks.

Tolerances: the semi-CRF ``logProb`` within rtol 1e-5 of the JAX package's,
its decode equal; everything else equal."""

import csv
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from transkun_tpu.cli import compute_metrics as jax_compute_metrics
from transkun_tpu.cli import gen_conf as jax_gen_conf
from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.ops.semicrf import NeuralSemiCRFInterval as JaxCRF
from transkun_tpu.train.checkpoint import merge_params_tolerant as jax_merge
from transkun_tpu.train.validate import AGG_KEYS as JAX_AGG_KEYS
from transkun_tpu_torch import crf_minimal_example
from transkun_tpu_torch.cli import compute_metrics, gen_conf, plot_deviation
from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset
from transkun_tpu_torch.cli.train import main as train
from transkun_tpu_torch.cli.transcribe import main as transcribe
from transkun_tpu_torch.data.midi import write_midi
from transkun_tpu_torch.data.note import Note
from transkun_tpu_torch.models.config import ModelConfig, parse_conf_file
from transkun_tpu_torch.models.transkun import TransKun
from transkun_tpu_torch.ops import semicrf
from transkun_tpu_torch.train import checkpoint as ckpt_mod
from transkun_tpu_torch.utils import profiling

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0, "segmentHopSizeInSecond": 1.0,
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _notes(rng, dur):
    notes, t = [], 0.2
    while t < dur - 0.5:
        notes.append(Note(t, t + float(rng.uniform(0.2, 0.4)), int(rng.integers(40, 80)),
                          int(rng.integers(30, 100))))
        t += float(rng.uniform(0.3, 0.6))
    return notes


def _wav(path, notes, dur):
    tt = np.arange(int(dur * FS)) / FS
    x = sum(0.1 * ((tt >= n.start) & (tt < n.end))
            * np.sin(2 * np.pi * 440 * 2 ** ((n.pitch - 69) / 12) * tt) for n in notes)
    wavfile.write(path, FS, (np.clip(x, -1, 1) * 32000).astype(np.int16))


def _model(seed=0):
    """The tiny V2 model with random weights, the scorer's diagonal biased
    down so that the decode keeps a few notes."""
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", seed=seed)
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] = -4.0
    return model


def _key(n):
    return (n.start, n.end, n.pitch, n.velocity, n.hasOnset, n.hasOffset)


# -- the trainer on two gloo ranks -----------------------------------------------------


def _jax_tensorboard_tags():
    """The tags the JAX package's trainer writes: its ``add_scalar``
    literals and ``val/`` + each validation metric."""
    import transkun_tpu.cli.train as jax_train
    from transkun_tpu.train.validate import _metrics_from_agg

    with open(jax_train.__file__) as f:
        tags = {t for t in re.findall(r'add_scalar\(\s*"([^"]+)"', f.read()) if t != "val/"}
    return tags | {"val/" + k for k in _metrics_from_agg(dict.fromkeys(JAX_AGG_KEYS, 1.0))}


def test_cli_train_two_ranks_resume_and_tensorboard(tmp_path):
    """``--device cpu --nDevices 2``: two gloo ranks take an epoch (steps,
    stats passes, checkpoints, validation), resume for two more steps with
    two ranks, and rank 0's TensorBoard log holds the JAX package's tags."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    root = tmp_path / "corpus"
    os.makedirs(root / "2020")
    rng = np.random.default_rng(0)
    rows = []
    for i, split in enumerate(["train", "train", "validation"]):
        wav, mid = f"2020/p{i}.wav", f"2020/p{i}.midi"
        notes = _notes(rng, 3.0)
        write_midi(notes, str(root / mid))
        _wav(str(root / wav), notes, 3.0)
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"p{i}", "split": split,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": 3.0})
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    create_dataset([str(root), str(root / "meta.csv"), str(tmp_path / "pickles")])
    conf = tmp_path / "tiny.conf"
    conf.write_text(json.dumps({"Model": {"module": "transkun_tpu_torch.models.transkun",
                                          "config": TINY}}))
    ckpt = str(tmp_path / "ckpt.pt")
    args = [ckpt, "--datasetPath", str(root),
            "--datasetMetaFile_train", str(tmp_path / "pickles" / "train.pickle"),
            "--datasetMetaFile_val", str(tmp_path / "pickles" / "val.pickle"),
            "--modelConf", str(conf), "--batchSize", "1", "--maxEvents", "8",
            "--statsEvery", "2", "--ckptEvery", "2", "--logEvery", "1", "--seed", "3",
            "--warmupCutoff", "0", "--nIter", "100", "--dataLoaderWorkers", "0", "--device", "cpu",
            "--nDevices", "2"]

    first = train(args + ["--maxEpoch", "1"])
    assert first["steps"] >= 2 and first["stats_passes"] >= 1 and first["val_batches"] >= 1
    assert np.isfinite(first["losses"]).all() and len(first["losses"]) == first["steps"]
    saved = ckpt_mod.load_checkpoint(ckpt)
    assert saved["step"] == first["steps"] and saved["extra"]["epoch"] == 1
    assert set(first["val_results"][0]) == {"meanNLL", "precision", "recall", "f1"}

    second = train(args + ["--maxEpoch", "2", "--stopAtStep", str(first["steps"] + 2)])
    assert second["steps"] == 2 and np.isfinite(second["losses"]).all()
    assert ckpt_mod.load_checkpoint(ckpt)["step"] == first["steps"] + 2

    logs = [os.path.join(ckpt + ".log", f) for f in sorted(os.listdir(ckpt + ".log"))]
    tags, steps = set(), []
    for log in logs:
        events = EventAccumulator(log)
        events.Reload()
        tags |= set(events.Tags()["scalars"])
        steps += [e.step for e in events.Scalars("Loss/train")]
    assert tags == _jax_tensorboard_tags()
    assert steps == list(range(first["steps"] + 2))


def test_cli_train_refuses_a_rank_count_it_cannot_run(monkeypatch):
    """More ranks than cards names both numbers; under a launcher,
    ``--nDevices`` must equal ``WORLD_SIZE``."""
    args = ["ckpt.pt", "--datasetPath", ".", "--datasetMetaFile_train", "t",
            "--datasetMetaFile_val", "v", "--modelConf", "c"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--nDevices 2 needs 2 cards, one a rank; 1 found"):
        train(args + ["--nDevices", "2"])
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="--nDevices 3 under a launcher of WORLD_SIZE 2"):
        train(args + ["--nDevices", "3", "--device", "cpu"])


# -- many devices ------------------------------------------------------------------------


def test_transcribe_many_devices_equals_one_device():
    """Pieces round-robin over two devices give each piece's notes of one
    ``transcribe`` call, in order.  ``cpu`` and ``cpu:0`` are two devices to
    ``torch.device``, so the second takes a replica of the module, cached
    until the weights change."""
    model = _model()
    rng = np.random.default_rng(3)
    pieces = [(rng.normal(size=(int(s * FS), 1)) * 0.1).astype(np.float32) for s in (3.5, 2.2)]
    want = [[_key(n) for n in model.transcribe(x)] for x in pieces]
    assert any(want)
    for devices in (["cpu", "cpu"], [torch.device("cpu"), torch.device("cpu", 0)]):
        got = [[_key(n) for n in notes] for notes in model.transcribe_many(pieces, devices=devices)]
        assert got == want
    replica = model._replica(torch.device("cpu", 0))
    assert replica is not model and replica is model._replica(torch.device("cpu", 0))
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] += 1.0
    fresh = model._replica(torch.device("cpu", 0))
    assert fresh is not replica
    assert torch.equal(fresh.module.scorer.map[0].bias, model.module.scorer.map[0].bias)


def test_transcribe_cli_all_devices(tmp_path):
    """The directory mode with ``--allDevices`` writes the files it writes
    without."""
    conf = tmp_path / "tiny.conf"
    conf.write_text(json.dumps({"Model": {"module": "transkun_tpu_torch.models.transkun",
                                          "config": TINY}}))
    audio = tmp_path / "in"
    os.makedirs(audio / "sub")
    rng = np.random.default_rng(4)
    for name in ("a.wav", "sub/b.wav"):
        _wav(str(audio / name), _notes(rng, 3.0), 3.0)
    outs = []
    for flags in ([], ["--allDevices"]):
        out = tmp_path / f"out{len(flags)}"
        transcribe([str(audio), str(out), "--conf", str(conf), "--device", "cpu", *flags])
        outs.append({p: (out / p).read_bytes() for p in ("a.midi", "sub/b.midi")})
    assert outs[0] == outs[1]


# -- the small CLIs ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def midi_dirs(tmp_path_factory):
    """Ground-truth and estimated MIDI trees: the estimate moves each onset
    and offset a few ms, drops a note and adds one."""
    root = tmp_path_factory.mktemp("midi")
    rng = np.random.default_rng(5)
    for name in ("x.mid", "sub/y.midi"):
        gt = _notes(rng, 12.0) + [Note(1.0, 3.0, -64, 100)]
        est = [Note(n.start + float(rng.normal()) * 0.01, n.end + float(rng.normal()) * 0.02,
                    n.pitch, n.velocity) for n in gt[1:]] + [Note(5.0, 5.3, 100, 40)]
        for sub, notes in (("gt", gt), ("est", est)):
            path = root / sub / name
            path.parent.mkdir(parents=True, exist_ok=True)
            write_midi(sorted(notes, key=lambda n: n.start), str(path))
    return root


def test_compute_metrics_equals_jax(midi_dirs, tmp_path):
    for mod, out in ((compute_metrics, "port.json"), (jax_compute_metrics, "jax.json")):
        mod.main([str(midi_dirs / "est"), str(midi_dirs / "gt"), "--outputJSON", str(tmp_path / out)])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == want
    assert 0.5 < got["aggregated"]["note"][2] < 1.0 and len(got["detailed"]) == 2


def test_plot_deviation_writes_its_figure(midi_dirs, tmp_path):
    compute_metrics.main([str(midi_dirs / "est"), str(midi_dirs / "gt"),
                          "--outputJSON", str(tmp_path / "m.json")])
    fig = tmp_path / "dev.png"
    plot_deviation.main([str(tmp_path / "m.json"), "--cumulative", "--output", str(fig),
                         "--noDisplay"])
    assert fig.stat().st_size > 1000


def test_gen_conf_equals_jax_and_loads(capsys, tmp_path):
    gen_conf.main([])
    got = json.loads(capsys.readouterr().out)
    jax_gen_conf.main([])
    want = json.loads(capsys.readouterr().out)
    assert got["Model"]["module"] == "transkun_tpu_torch.models.transkun"
    assert got["Model"]["config"] == want["Model"]["config"]
    path = tmp_path / "model.conf"
    path.write_text(json.dumps(got))
    module, conf = parse_conf_file(str(path))
    assert module.TransKun is TransKun and conf.to_dict() == ModelConfig().to_dict()


def test_crf_example_and_semicrf_api_equal_jax():
    """The example's scores through the JAX package's
    ``NeuralSemiCRFInterval``; and numpy-seeded scores through both."""
    out = crf_minimal_example.main(["--device", "cpu"])
    rng = np.random.default_rng(6)
    cases = [(out["score"].numpy(), out["noise_score"].numpy(), out["intervals"])]
    s = rng.normal(size=(60, 60, 3)).astype(np.float32)
    n = rng.normal(size=(59, 3)).astype(np.float32)
    cases.append((s, n, [[(0, 2), (5, 9)], [], [(3, 3), (40, 59)]]))
    for s, n, intervals in cases:
        crf = semicrf.NeuralSemiCRFInterval(torch.from_numpy(s), torch.from_numpy(n))
        crf_j = JaxCRF(jax.numpy.asarray(s), jax.numpy.asarray(n))
        np.testing.assert_allclose(crf.logProb(intervals).numpy(), np.asarray(crf_j.logProb(intervals)),
                                   rtol=1e-5)
        assert crf.decode() == crf_j.decode()
        assert crf.decode(forcedStartPos=[7] * s.shape[2]) == crf_j.decode(forcedStartPos=[7] * s.shape[2])
    np.testing.assert_allclose(out["log_prob"].numpy(),
                               np.asarray(JaxCRF(jax.numpy.asarray(cases[0][0]),
                                                 jax.numpy.asarray(cases[0][1])).logProb(out["intervals"])),
                               rtol=1e-5)
    assert out["decoded"] == JaxCRF(jax.numpy.asarray(cases[0][0]), jax.numpy.asarray(cases[0][1])).decode()


def test_crf_example_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        crf_minimal_example.main([])


# -- the API ------------------------------------------------------------------------------------


def test_param_count_equals_jax():
    jmodel = JaxTransKun(JaxModelConfig.from_dict(TINY))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, n_frames=64), jax.random.PRNGKey(0))
    assert _model().param_count() == jmodel.param_count(shapes) > 0


def test_merge_params_tolerant_follows_jax():
    """Same key and same shape: taken from the source; another shape, or a
    key the source lacks: kept; a key the target lacks: dropped."""
    rng = np.random.default_rng(7)
    target = {"a.w": rng.normal(size=(3, 2)), "a.b": rng.normal(size=2), "c.w": rng.normal(size=4)}
    source = {"a.w": rng.normal(size=(3, 2)), "a.b": rng.normal(size=3), "d.w": rng.normal(size=1)}

    def nest(flat):
        tree = {}
        for k, v in flat.items():
            mod, leaf = k.split(".")
            tree.setdefault(mod, {})[leaf] = v
        return tree

    want = jax_merge(nest(target), nest(source))
    got = ckpt_mod.merge_params_tolerant({k: torch.from_numpy(v) for k, v in target.items()},
                                         {k: torch.from_numpy(v) for k, v in source.items()})
    assert set(got) == set(target)
    for k, v in got.items():
        mod, leaf = k.split(".")
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[mod][leaf]))
    assert torch.equal(got["a.w"], torch.from_numpy(source["a.w"]))
    assert torch.equal(got["a.b"], torch.from_numpy(target["a.b"]))


def test_profiling_meters_count(tmp_path, monkeypatch):
    rtf = profiling.RTFMeter()
    for _ in range(2):
        with rtf.measure(3.0, device=torch.device("cpu")):
            sum(range(20000))
    assert rtf.audio_seconds == 6.0 and rtf.wall_seconds > 0
    assert rtf.rtf == pytest.approx(6.0 / rtf.wall_seconds)
    monkeypatch.setenv("TRANSKUN_TPU_TIMING", "silent")
    profiling.reset()
    for name in ("load", "load", "decode"):
        with profiling.root(f"transkun.{name}"):
            profiling.count("items")
    assert {k: c for k, (c, _) in profiling.totals().items()} == {"transkun.load": 2, "transkun.decode": 1}
    assert profiling.counters() == {"items": 3}
    profiling.reset()
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    tree = {"a": [torch.ones(2), (torch.zeros(1),)], "b": 3}
    assert profiling.block(tree) is tree


def test_timing_marks_exist_and_stay_silent(monkeypatch, capsys):
    """``TRANSKUN_TPU_TIMING=silent`` keeps the phases' host-clock marks in
    ``last_transcribe_marks`` and prints nothing; set to 1 it prints each
    phase; unset, no marks are taken."""
    model = _model()
    x = (np.random.default_rng(8).normal(size=(int(5.5 * FS), 1)) * 0.1).astype(np.float32)
    model.transcribe(x, segment_batch=2)
    assert model.last_transcribe_marks == []
    monkeypatch.setenv("TRANSKUN_TPU_TIMING", "silent")
    capsys.readouterr()
    want = model.transcribe(x, segment_batch=2)
    marks = model.last_transcribe_marks
    n_groups = len(model.last_transcribe_group_counts)
    assert [label for label, _ in marks] == (
        ["begin", "upload enqueued"] + [f"group {g} enqueued" for g in range(n_groups)]
        + ["event waited for", "assembled", "merged"])
    assert n_groups == 4 and all(a <= b for (_, a), (_, b) in zip(marks, marks[1:]))
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("TRANSKUN_TPU_TIMING", "1")
    got = model.transcribe(x, segment_batch=2)
    assert capsys.readouterr().out.count("[transcribe]") == len(marks) - 1
    assert [_key(n) for n in got] == [_key(n) for n in want]


def test_console_scripts_resolve():
    """Every ``[project.scripts]`` entry of the port names a function of
    the port; the trainer's is the record-free ``cli``."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if v.startswith("transkun_tpu_torch.")}
    assert set(port) == {"transkun-tpu-torch", "transkun-tpu-torch-train", "transkun-tpu-torch-eval",
                         "transkun-tpu-torch-dataset"}
    for target in port.values():
        module, name = target.split(":")
        assert callable(getattr(importlib.import_module(module), name))
    assert port["transkun-tpu-torch-train"].endswith(":cli")
