"""Continuing the JAX trainer's run in the port's trainer, against the JAX
package on the CPU:

- (a) the whole tree of a JAX checkpoint whose ``extra`` holds ``[]``,
  ``{}`` and ``()`` reads as JAX ``load_checkpoint`` returns it;
- (b) ``save_checkpoint`` refuses a path where a directory stands, and
  leaves every file of it as it was;
- (c) ``restore_train_state_from_orbax`` of a JAX ``save_checkpoint`` of the
  tiny V2 (non-zero moments, count 1000, a clip ring of 1001 pushes)
  equals the JAX tree bit for bit;
- (d) from that state, five clip and optimizer steps on the same seeded
  gradients match optax's from the state ``restore_opt_state`` rebuilds
  (rtol 1e-5, atol 1e-7, as ``test_torch_train.py``'s optimizer test);
- (e) the CLI: the JAX trainer stops at step 2, the port's trainer resumes
  its directory to step 4, saving beside it, and a second port run resumes
  from the port's file;
- (f) refusals: counts that differ, a conf of another width, a directory
  with no ``_METADATA``;
- (g) the flagship's whole train state, bit for bit.
"""

import csv
import hashlib
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.config import load_default_conf as jax_default_conf
from transkun_tpu.train import init_train_state, make_optimizer
from transkun_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from transkun_tpu.train.checkpoint import restore_opt_state
from transkun_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from transkun_tpu.train.optim import QuantileClipState, quantile_clip
from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset
from transkun_tpu_torch.cli.train import main as port_train
from transkun_tpu_torch.data.midi import write_midi
from transkun_tpu_torch.data.note import Note
from transkun_tpu_torch.models.config import ModelConfig, load_default_conf
from transkun_tpu_torch.models.transkun import TransKun
from transkun_tpu_torch.train import checkpoint as ckpt_mod
from transkun_tpu_torch.train.optim import AdaBelief
from transkun_tpu_torch.train.step import TrainState
from transkun_tpu_torch.utils.convert import state_dict_from_flax
from transkun_tpu_torch.utils.orbax_read import OrbaxCheckpoint

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytest.importorskip("orbax.checkpoint", reason="orbax writes the checkpoints")

FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0, "segmentHopSizeInSecond": 1.0,
}
STEP = 1000
OPT = dict(max_lr=1e-2, weight_decay=0.5, n_iter=2000, warmup_cutoff=2)
EXTRA = {"loss_tracker": {"train": [1.5, 2.25], "val": []}, "epoch": 3, "run_seed": 11,
         "warmstart_from": "/some/donor"}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]


def _assert_same_tree(got, want):
    assert jax.tree_util.tree_structure(got, is_leaf=lambda x: x is None) == \
        jax.tree_util.tree_structure(want, is_leaf=lambda x: x is None)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert type(a) is type(b), (path, type(a), type(b))
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path
        else:
            assert a == b, path


def _resumable_state(params, rng, step=STEP):
    """A JAX train state worth resuming: ``params``, non-zero ``mu``, ``nu >
    0``, both optimizer counts at ``step`` and a clip ring of ``step``
    pushes after its seed value."""
    state = init_train_state(params, make_optimizer(params["params"]))
    belief, masked, schedule = state.opt_state
    moved = lambda scale, f: jax.tree.map(  # noqa: E731
        lambda a: f(scale * rng.standard_normal(np.shape(a))).astype(np.float32), params["params"])
    belief = belief._replace(count=np.int32(step), mu=moved(1e-3, lambda x: x),
                             nu=moved(1e-6, lambda x: np.abs(x) + 1e-9))
    buffer = np.zeros(10000, np.float32)
    buffer[0] = 40.0
    buffer[1:step + 1] = rng.uniform(0.5, 5.0, step).astype(np.float32)
    return state._replace(opt_state=(belief, masked, schedule._replace(count=np.int32(step))),
                          clip_state=QuantileClipState(buffer, np.int32(step + 1)), step=np.int32(step))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX ``save_checkpoint`` of the tiny V2 at step 1000: seeded params
    and best params, the state of ``_resumable_state``, the ``extra`` the
    JAX trainer writes before its first validation plus ``{}`` and ``()``."""
    tmp = tmp_path_factory.mktemp("resume")
    init = jax.jit(lambda k: JaxTransKun(JaxModelConfig.from_dict(TINY)).init(k, n_frames=64))
    rng = np.random.default_rng(17)
    noisy = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) + (0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), t)
    params = noisy(init(jax.random.PRNGKey(0)))
    best = noisy(params)
    state = _resumable_state(params, rng)
    path = str(tmp / "run")
    jax_save_checkpoint(path, state, best_params=best,
                        extra={**EXTRA, "empty_dict": {}, "empty_tuple": ()})
    return path


def _port_state(conf=TINY, seed=5):
    model = TransKun(ModelConfig.from_dict(conf), device="cpu", seed=seed)
    return TrainState(model, AdaBelief(model.module.named_parameters(), **OPT))


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().numpy().tobytes()


def _hashes(root):
    """sha256 of every file under ``root``, by path relative to it."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = hashlib.sha256(f.read()).hexdigest()
    return out


# -- (a) the whole tree, empty containers included ------------------------------------


def test_whole_tree_with_empty_containers_equals_jax(jax_run):
    got, want = ckpt_mod.load_orbax_checkpoint(jax_run), jax_load_checkpoint(jax_run)
    _assert_same_tree(got, want)
    assert got["extra"]["loss_tracker"]["val"] == [] and got["extra"]["empty_dict"] == {}
    assert got["extra"]["empty_tuple"] == ()
    # a read by prefix reaches the empty leaf as well
    extra = OrbaxCheckpoint(jax_run).read(("extra", "loss_tracker"))
    assert extra["extra"]["loss_tracker"]["val"] == []


# -- (b) a directory is never written over ----------------------------------------------


@pytest.mark.parametrize("where", ["", ".new", ".old"])
def test_save_checkpoint_refuses_a_directory(jax_run, tmp_path, where):
    """A JAX checkpoint directory at ``path``, ``path.new`` or ``path.old``:
    ``save_checkpoint(path, ...)`` raises before it writes, and every file of
    the directory keeps its bytes."""
    path = str(tmp_path / "run")
    shutil.copytree(jax_run, path + where)
    before = _hashes(str(tmp_path))
    state = _port_state()
    with pytest.raises(IsADirectoryError, match=r"is a directory \(a JAX checkpoint\?\)"):
        ckpt_mod.save_checkpoint(path, state, None, {"epoch": 0})
    assert _hashes(str(tmp_path)) == before
    assert sorted(os.listdir(tmp_path)) == ["run" + where]


# -- (c) the restored state, bit for bit --------------------------------------------------


def _assert_restored(state, ckpt, tree, conf=None):
    """``state`` (and the returned ``ckpt``) equal the JAX ``tree`` bit for
    bit through ``state_dict_from_flax``."""
    opt = tree["opt_state"]
    want = {"params": state_dict_from_flax(tree["params"], conf),
            "mu": state_dict_from_flax(opt[0]["mu"], conf), "nu": state_dict_from_flax(opt[0]["nu"], conf),
            "best": state_dict_from_flax(tree.get("best_params", tree["params"]), conf)}
    got = {"params": dict(state.model.module.named_parameters()), "mu": state.optimizer.mu,
           "nu": state.optimizer.nu, "best": ckpt["best_state_dict"]}
    names = [n for n, _ in state.optimizer.named]
    assert sorted(names) == sorted(want["params"])
    for what in got:
        for name in names:
            a, b = got[what][name], want[what][name]
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, (what, name)
            assert _bits(a) == _bits(b), (what, name)
    assert state.optimizer.count.dtype == torch.int32
    assert int(state.optimizer.count) == int(opt[0]["count"]) == int(opt[2]["count"])
    assert _bits(state.clip.buffer) == np.asarray(tree["clip_buffer"]).tobytes()
    assert state.clip.count.dtype == torch.int32 and int(state.clip.count) == int(tree["clip_count"])
    assert state.step == int(tree["step"])


def test_restore_equals_the_jax_tree(jax_run):
    tree = jax_load_checkpoint(jax_run)
    state = _port_state()
    ckpt = ckpt_mod.restore_train_state_from_orbax(state, ckpt_mod.load_orbax_checkpoint(jax_run),
                                                   ModelConfig.from_dict(TINY))
    _assert_restored(state, ckpt, tree)
    assert state.step == STEP and int(state.clip.count) == STEP + 1
    assert float(min(v.abs().min() for v in state.optimizer.nu.values())) > 0
    assert ckpt["extra"] == {**EXTRA, "empty_dict": {}, "empty_tuple": ()}
    assert type(ckpt["extra"]["epoch"]) is int and type(ckpt["extra"]["loss_tracker"]["train"][0]) is float
    # the reshaped leaves in the port's layout: the upsample's Dense [in, 8*out]
    # -> [in, out, 8], the MHA projections [in, out] as they are, DownConv's
    # kernels [kh, kw, in, out] -> [out, in, kh, kw]
    mu = tree["opt_state"][0]["mu"]["backbone"]
    up = np.asarray(mu["upConv1dSkip"]["kernel"])
    np.testing.assert_array_equal(state.optimizer.mu["backbone.upConv1dSkip.weight"].numpy(),
                                  up.reshape(up.shape[0], 8, -1).transpose(0, 2, 1))
    np.testing.assert_array_equal(state.optimizer.mu["backbone.upConv1dSkip.bias"].numpy(),
                                  mu["upConv1dSkip"]["bias"])
    np.testing.assert_array_equal(
        state.optimizer.nu["backbone.encoderLayers.0.mhaBlockF.module.q_proj_weight"].numpy(),
        tree["opt_state"][0]["nu"]["backbone"]["encoderLayers_0"]["mhaBlockF"]["mha"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(state.optimizer.mu["backbone.downConv.5.weight"].numpy(),
                                  np.transpose(mu["downConv"]["conv1"]["kernel"], (3, 2, 0, 1)))


# -- (d) five optimizer steps from the restored state ----------------------------------------


def test_five_steps_from_the_restored_state_match_optax(jax_run):
    tree = jax_load_checkpoint(jax_run)
    p_j = jax.tree_util.tree_map(jnp.asarray, tree["params"]["params"])
    opt_j = make_optimizer(p_j, **OPT)
    st_j = restore_opt_state(tree["opt_state"], opt_j.init(p_j))
    clip_j = QuantileClipState(jnp.asarray(tree["clip_buffer"]), jnp.asarray(tree["clip_count"]))
    update_j = jax.jit(opt_j.update)
    clip_fn_j = jax.jit(lambda g, s: quantile_clip(g, s, 0.8))

    state = _port_state()
    ckpt_mod.restore_train_state_from_orbax(state, ckpt_mod.load_orbax_checkpoint(jax_run))
    opt, clip = state.optimizer, state.clip
    names = [n for n, _ in opt.named]
    rng = np.random.default_rng(5)
    finite = torch.tensor(True)
    for _ in range(5):
        scale = float(rng.uniform(0.5, 3.0))
        g_j = jax.tree_util.tree_map(
            lambda a: jnp.asarray((rng.normal(size=a.shape) * scale).astype(np.float32)), p_j)
        clipped_j, clip_j, norm_j, cv_j = clip_fn_j(g_j, clip_j)
        upd, st_j = update_j(clipped_j, st_j, p_j)
        p_j = jax.tree_util.tree_map(lambda a, b: a + b, p_j, upd)

        g_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_j))
        clipped, norm, cv = clip([g_sd[n] for n in names], 0.8)
        opt.step(clipped, finite)
        clip.push(norm, finite)
        np.testing.assert_allclose(float(norm), float(norm_j), rtol=1e-5)
        np.testing.assert_allclose(float(cv), float(cv_j), rtol=1e-5)

    np.testing.assert_allclose(clip.buffer.numpy(), np.asarray(clip_j.buffer), rtol=1e-5)
    assert int(clip.count) == int(clip_j.count) == STEP + 6
    assert int(opt.count) == int(st_j[0].count) == int(st_j[2].count) == STEP + 5
    for tree_j, got in ((p_j, dict(state.model.module.named_parameters())),
                        (st_j[0].mu, opt.mu), (st_j[0].nu, opt.nu)):
        want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, tree_j)})
        for name in names:
            np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


# -- (e) the CLI: a JAX run continued by the port ----------------------------------------------


def _notes(rng, dur):
    notes, t = [], 0.2
    while t < dur - 0.5:
        notes.append(Note(t, t + float(rng.uniform(0.2, 0.4)), int(rng.integers(40, 80)),
                          int(rng.integers(30, 100))))
        t += float(rng.uniform(0.3, 0.6))
    return notes


def _corpus(tmp_path):
    """``test_torch_cli.py``'s three-piece corpus (two to train, one to
    validate) and its pickles."""
    root = tmp_path / "corpus"
    os.makedirs(root / "2020")
    rng = np.random.default_rng(0)
    rows = []
    for i, split in enumerate(["train", "train", "validation"]):
        wav, mid = f"2020/p{i}.wav", f"2020/p{i}.midi"
        notes = _notes(rng, 3.0)
        write_midi(notes, str(root / mid))
        tt = np.arange(int(3.0 * FS)) / FS
        x = sum(0.1 * ((tt >= n.start) & (tt < n.end))
                * np.sin(2 * np.pi * 440 * 2 ** ((n.pitch - 69) / 12) * tt) for n in notes)
        wavfile.write(str(root / wav), FS, (np.clip(x, -1, 1) * 32000).astype(np.int16))
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"p{i}", "split": split,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": 3.0})
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    create_dataset([str(root), str(root / "meta.csv"), str(tmp_path / "pickles")])
    return root


def test_cli_continues_a_jax_run(tmp_path, capsys):
    """JAX ``cli.train.main --stopAtStep 2`` writes its directory; the
    port's ``cli.train.main --device cpu --stopAtStep 4`` on the same path
    prints the resume lines, takes 2 steps from step 2 and writes
    ``<path>.pt`` (step 4, both counts +2, ``loss_tracker``, epoch and
    ``run_seed`` carried over), leaving the directory's files as they were;
    a second port run resumes from ``<path>.pt``."""
    from transkun_tpu.cli.train import main as jax_train

    root = _corpus(tmp_path)
    conf = tmp_path / "tiny.conf"
    conf.write_text(json.dumps({"Model": {"module": "transkun_tpu.models.transkun", "config": TINY}}))
    path = str(tmp_path / "run")
    common = [path, "--datasetPath", str(root),
              "--datasetMetaFile_train", str(tmp_path / "pickles" / "train.pickle"),
              "--datasetMetaFile_val", str(tmp_path / "pickles" / "val.pickle"),
              "--modelConf", str(conf), "--batchSize", "1", "--maxEvents", "8", "--statsEvery", "0",
              "--logEvery", "1", "--warmupCutoff", "0", "--nIter", "100", "--dataLoaderWorkers", "0",
              "--maxEpoch", "4"]
    # the test session's JAX sees 8 CPU devices: one of them, a batch of 8 chunks
    jax_train(common + ["--seed", "3", "--nDevices", "1", "--stopAtStep", "2", "--validateEvery", "2"])
    jax_tree = jax_load_checkpoint(path)
    assert int(jax_tree["step"]) == 2 and jax_tree["extra"]["loss_tracker"]["val"] == []
    epoch = int(jax_tree["extra"]["epoch"])
    assert epoch >= 1 and len(jax_tree["extra"]["loss_tracker"]["train"]) == epoch
    before = _hashes(str(tmp_path))
    capsys.readouterr()

    port = common + ["--seed", "99", "--device", "cpu", "--statsEvery", "1"]
    record = port_train(port + ["--stopAtStep", "4"])
    out = capsys.readouterr().out
    assert "resuming from checkpoint...\n" in out
    assert (f"resuming from the JAX package's orbax checkpoint {path}; saving to {path}.pt\n") in out
    assert record["steps"] == 2 and record["stats_passes"] == 2 and np.isfinite(record["losses"]).all()
    assert [int(line.split("step:")[1].split()[0]) for line in out.splitlines() if " step:" in line] == [2, 3]
    after = _hashes(str(tmp_path))
    assert {k: v for k, v in after.items() if k in before} == before  # the JAX run's files untouched
    assert sorted(os.listdir(tmp_path)) == sorted(["corpus", "pickles", "tiny.conf", "run", "run.log",
                                                   "run.pt"])
    saved = ckpt_mod.load_checkpoint(path + ".pt")
    assert saved["step"] == 4
    assert int(saved["optimizer"]["count"]) == int(jax_tree["opt_state"][0]["count"]) + 2 == 4
    assert int(saved["clip_count"]) == int(jax_tree["clip_count"]) + 2
    assert saved["extra"] == {"loss_tracker": {"train": [float(x) for x in jax_tree["extra"]["loss_tracker"]["train"]],
                                               "val": []},
                              "epoch": epoch, "run_seed": 3}

    # a second port run resumes from the port's file, not from the directory
    record = port_train(port + ["--stopAtStep", "5"])
    out = capsys.readouterr().out
    assert f"resuming from checkpoint {path}.pt; saving to {path}.pt\n" in out
    assert record["steps"] == 1 and ckpt_mod.load_checkpoint(path + ".pt")["step"] == 5
    assert {k: v for k, v in _hashes(str(tmp_path)).items() if k in before} == before


def test_resolve_checkpoint_plans(jax_run, tmp_path):
    """Fresh, a port file, a JAX directory (at the path or a sibling), the
    port's file beside it, which wins on a restart."""
    path = str(tmp_path / "run")
    assert ckpt_mod.resolve_checkpoint(path) == ("fresh", None, path)
    shutil.copytree(jax_run, path + ".old")
    assert ckpt_mod.resolve_checkpoint(path + "/") == ("jax", path, path + ".pt")
    with open(path + ".pt.new", "wb") as f:
        f.write(b"x")
    assert ckpt_mod.resolve_checkpoint(path) == ("port", path + ".pt", path + ".pt")
    file_path = str(tmp_path / "ckpt.pt")
    with open(file_path + ".old", "wb") as f:
        f.write(b"x")
    assert ckpt_mod.resolve_checkpoint(file_path) == ("port", file_path, file_path)


# -- (f) refusals --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["counts differ", "another width", "no _METADATA"])
def test_refusals(jax_run, tmp_path, case):
    tree = ckpt_mod.load_orbax_checkpoint(jax_run)
    if case == "counts differ":
        params = jax.tree.map(np.asarray, tree["params"])
        state = _resumable_state(params, np.random.default_rng(0))
        belief, masked, schedule = state.opt_state
        state = state._replace(opt_state=(belief, masked, schedule._replace(count=np.int32(STEP - 1))))
        jax_save_checkpoint(str(tmp_path / "bad"), state)
        with pytest.raises(ValueError, match=r"opt_state/0/count \(1000\) and opt_state/2/count \(999\) "
                                             r"differ"):
            ckpt_mod.restore_train_state_from_orbax(
                _port_state(), ckpt_mod.load_orbax_checkpoint(str(tmp_path / "bad")))
    elif case == "another width":
        with pytest.raises(ValueError, match=r"^params: framewiseFeatureExtractor.spectrogramExtractor."
                                             r"winGen.sigma is \[2\] in the checkpoint, \[4\] in the conf's "
                                             r"model$"):
            ckpt_mod.restore_train_state_from_orbax(_port_state({**TINY, "nExtraWins": 4}), tree)
        with pytest.raises(ValueError, match=r"^params: backbone.posEmbedBuilder.proj.weight is \[8, 1\] in "
                                             r"the checkpoint, \[16, 1\] in the conf's model$"):
            ckpt_mod.restore_train_state_from_orbax(_port_state({**TINY, "baseSize": 16}), tree)
    else:
        plain = tmp_path / "run"
        plain.mkdir()
        (plain / "weights.bin").write_bytes(b"\0" * 8)
        with pytest.raises(ValueError, match=r"run: a directory that holds no orbax checkpoint \(no "
                                             r"_METADATA\)"):
            port_train([str(plain), "--datasetPath", str(tmp_path), "--datasetMetaFile_train", "x",
                        "--datasetMetaFile_val", "x", "--modelConf", _tiny_conf(tmp_path),
                        "--device", "cpu"])
        assert sorted(os.listdir(plain)) == ["weights.bin"] and not os.path.exists(str(plain) + ".pt")


def _tiny_conf(tmp_path):
    conf = tmp_path / "tiny.conf"
    conf.write_text(json.dumps({"Model": {"module": "transkun_tpu_torch.models.transkun", "config": TINY}}))
    return str(conf)


# -- (g) the flagship's whole train state ------------------------------------------------------


def test_full_width_train_state_bit_for_bit(tmp_path):
    """JAX ``save_checkpoint`` of a flagship (``2.0.conf``) train state:
    seeded float32 params and best params, non-zero ``mu`` and ``nu``,
    counts at 1000, a clip ring of 1001 pushes, step 1000.  The port's
    restored ``TrainState`` equals the JAX tree through
    ``state_dict_from_flax`` bit for bit.  The values are not put on the
    bfloat16 grid: its zero bytes become zstd sequences, which the port's
    decoder runs several times slower than literals."""
    _, jconf = jax_default_conf()
    shapes = jax.eval_shape(lambda k: JaxTransKun(jconf).init(k, n_frames=33), jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    best = jax.tree.map(lambda a: a + np.float32(0.01), params)
    state = _resumable_state(params, rng)
    path = str(tmp_path / "flagship")
    jax_save_checkpoint(path, state, best_params=best, extra={"epoch": 1, "run_seed": 4})
    _, conf = load_default_conf()
    model = TransKun(conf, device="cpu", seed=0)
    port = TrainState(model, AdaBelief(model.module.named_parameters()))
    t0 = time.perf_counter()
    ckpt = ckpt_mod.restore_train_state_from_orbax(port, ckpt_mod.load_orbax_checkpoint(path), conf)
    seconds = time.perf_counter() - t0
    assert sum(p.numel() for _, p in port.optimizer.named) == 13_615_503
    _assert_restored(port, ckpt, jax_load_checkpoint(path), conf)
    assert ckpt["extra"] == {"epoch": 1, "run_seed": 4}
    print(f"port load_orbax_checkpoint + restore of the flagship train state: {seconds:.2f} s")
