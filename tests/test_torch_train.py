"""The port's training path against the JAX package, on the CPU at tiny
sizes: the two repairs (no scorer dropout, an untied upsample bias), the
objective and its gradients, the optimizer and clip, the non-finite guard,
checkpoints, gradient checkpointing, and the training CLI end to end.

Tolerances: the per-track log-probability and every parameter gradient
within 1e-3 of the tensor's largest magnitude (fp32 sums in another order
through a deep graph); the optimizer state within rtol 1e-5 (the global
norm is summed in another order, so also 1e-7 absolute); the schedule
within rtol 1e-6."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.data.labels import encode_batch
from transkun_tpu.data.note import Note
from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.backbone import Backbone as JaxBackbone
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.transkun import log_prob_padded as jax_log_prob_padded
from transkun_tpu.ops import frontend as jfrontend
from transkun_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
    onecycle_with_cutoff as jax_onecycle,
    quantile_clip,
    quantile_clip_init,
    weight_decay_mask as jax_weight_decay_mask,
)
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun, log_prob_padded, target_midi_pitches
from transkun_tpu_torch.train import checkpoint as ckpt_mod
from transkun_tpu_torch.train.optim import AdaBelief, QuantileClip, onecycle_with_cutoff
from transkun_tpu_torch.train.step import TrainState, make_train_step
from transkun_tpu_torch.utils.convert import state_dict_from_flax

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 2,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0,
}
PITCHES = target_midi_pitches()


TINY1 = {**TINY, "nLayers": 1}

@pytest.fixture(scope="module")
def params():
    """flax params of the one-layer tiny model, every leaf moved off its
    init (the dropout rates change no parameter, so every conf below
    shares them)."""
    init = jax.jit(lambda k: JaxTransKun(JaxModelConfig.from_dict(TINY1)).init(k, n_frames=64))
    rng = np.random.default_rng(10)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32),
        init(jax.random.PRNGKey(0)),
    )


def _port(conf_dict, params):
    model = TransKun(ModelConfig.from_dict(conf_dict), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return model


def _batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=(n, FS, 1)) * 0.1).astype(np.float32)
    notes = [
        [Note(0.1, 0.4, 60, 80), Note(0.45, 0.8, 60, 70), Note(0.2, 0.9, 64, 90),
         Note(0.0, 0.6, -64, 127, hasOnset=False)]
        for _ in range(n)
    ]
    return audio, notes


def _close_rel(got, want, rel=1e-3, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


# -- repairs ---------------------------------------------------------------------


def test_scorer_applies_no_dropout_in_train_mode():
    """The JAX scorer never applies its dropout field: in train mode the
    port's q, k and diag equal their eval values."""
    model = TransKun(ModelConfig.from_dict({**TINY, "scoreDropoutProb": 0.5}), device="cpu", seed=0)
    ctx = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 5, 7, 16)).astype(np.float32))
    scorer = model.module.scorer
    scorer.train()
    got = scorer._qkd(ctx)
    scorer.eval()
    want = scorer._qkd(ctx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert "scorer.map.0.weight" in model.module.state_dict()


def test_untied_upsample_bias_round_trips(params):
    """flax params with a different upConv1dSkip bias per output step load
    unchanged and give the JAX backbone's ctx."""
    bias = params["params"]["backbone"]["upConv1dSkip"]["bias"]
    assert not np.array_equal(bias[:16], bias[16:32])  # untied
    model = _port(TINY1, params)
    np.testing.assert_array_equal(
        model.module.state_dict()["backbone.upConv1dSkip.bias"].numpy(), bias
    )
    feats = np.random.default_rng(3).normal(size=(1, 64, 32, 3)).astype(np.float32)
    pitches = np.asarray(PITCHES, np.float32)
    backbone_j = JaxBackbone(
        input_size=3, base_size=8, pos_embed_init_gamma=1, n_head=2, hidden_factor=4,
        hidden_factor_attn=1, expansion_factor=2, n_layers=1, use_gradient_checkpoint=False,
    )
    want = jax.jit(lambda p, f, pi: backbone_j.apply({"params": p}, f, pi, True))(
        params["params"]["backbone"], jnp.asarray(feats), jnp.asarray(pitches)
    )
    with torch.no_grad():
        got = model.module.backbone(torch.from_numpy(feats), torch.from_numpy(pitches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_reference_tied_bias_loads():
    """A reference state_dict holds the ConvTranspose1d bias [out]; it loads
    tiled 8x (step-major)."""
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", seed=1)
    sd = dict(model.module.state_dict())
    tied = torch.arange(16, dtype=torch.float32)
    sd["backbone.upConv1dSkip.bias"] = tied
    model.load_state_dict(sd)
    assert torch.equal(model.module.backbone.upConv1dSkip.bias, tied.repeat(8))


# -- the objective -----------------------------------------------------------------


def test_log_prob_padded_and_grads_match_jax(params):
    model = _port(TINY1, params)
    audio, notes = _batch()
    frames_j = jfrontend.make_frame(jnp.swapaxes(jnp.asarray(audio), -1, -2), 64, 256)
    labels = encode_batch(notes, 64 / FS, PITCHES, 8).astuple()
    module_j = JaxTransKun(JaxModelConfig.from_dict(TINY1)).module

    def jax_loss(p):
        logp = jax_log_prob_padded(module_j, p, frames_j, tuple(jnp.asarray(a) for a in labels))
        return -logp.sum(-1).mean() / 50.0, logp

    (_, logp_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)

    model.module.eval()
    frames = model.frames(audio)
    logp = log_prob_padded(model.module, frames, tuple(torch.from_numpy(a) for a in labels))
    assert logp.shape == (2, 90)
    _close_rel(logp.detach().numpy(), logp_j, what="logp")
    (-logp.sum(-1).mean() / 50.0).backward()
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads_j))
    got = {n: p.grad for n, p in model.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        _close_rel(got[name].numpy(), g.numpy(), what=name)


def test_gradient_checkpoint_replays_dropout(params):
    """Checkpointed encoder layers redraw the same dropout masks from the
    explicit generator: the same seed gives the same gradients with
    checkpointing on and off."""
    conf = {**TINY1, "contextDropoutProb": 0.3}
    audio, notes = _batch(seed=1)

    def grads(remat, seed):
        model = _port({**conf, "useGradientCheckpoint": remat}, params)
        loss_fn = model.make_train_loss()
        labels = model.labels(notes, 8)
        logp = loss_fn(model.frames(audio), labels, torch.Generator().manual_seed(seed))
        (-logp.sum(-1).mean()).backward()
        return [p.grad.clone() for p in model.module.parameters()]

    on, off, other = grads(True, 7), grads(False, 7), grads(False, 8)
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert any(not torch.allclose(a, b) for a, b in zip(off, other))  # dropout is on


def test_stats_and_transcribe_frames_match_jax(params):
    """``compute_stats`` (route 1b decode, bracket and framewise counts,
    forced attribute errors), ``compute_stats_mireval`` and
    ``transcribe_frames`` against the JAX package on the same weights.  The
    scorer is made confident, as in test_torch_transcribe.py, so that no
    decode decision is a near-tie between the two frameworks."""
    import copy

    p = copy.deepcopy(params)
    m = p["params"]["scorer"]["map"]
    e = m["kernel"].shape[1] // 2
    m["kernel"] *= 10.0
    m["bias"][0] += 6.0
    m["bias"][e] -= 6.0
    m["bias"][-1] = -8.0
    jax_model = JaxTransKun(JaxModelConfig.from_dict(TINY1))
    model = _port(TINY1, p)
    rng = np.random.default_rng(7)
    audio = np.zeros((2, 2 * FS, 1), np.float32)
    tt = np.arange(2 * FS) / FS
    notes = []
    for i in range(2):
        cur = []
        for k, pitch in enumerate(rng.choice(np.arange(40, 80), size=6, replace=False)):
            on = 0.2 + 0.25 * k
            cur.append(Note(on, on + 0.3, int(pitch), int(rng.integers(30, 100))))
            env = (tt >= on) & (tt < on + 0.3)
            audio[i, env, 0] += 0.1 * np.sin(2 * np.pi * 440 * 2 ** ((pitch - 69) / 12) * tt[env])
        notes.append(cur)

    want = jax_model.compute_stats(p, audio, notes)
    got = model.compute_stats(audio, notes)
    assert set(got) == set(want)
    for k in ("nGT", "nEst", "nCorrect", "nGTFramewise", "nEstFramewise", "nCorrectFramewise"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    for k in ("seVelocityForced", "seOFForced"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["nEst"] > 0
    assert model.compute_stats_mireval(audio, notes) == jax_model.compute_stats_mireval(p, audio, notes)

    frames = model.frames(audio)
    got_notes, got_last = model.transcribe_frames(frames)
    want_notes, want_last = jax_model.transcribe_frames(
        p, jfrontend.make_frame(jnp.swapaxes(jnp.asarray(audio), -1, -2), 64, 256)
    )
    assert got_last == want_last and sum(len(n) for n in got_notes) > 0
    for a_seg, b_seg in zip(got_notes, want_notes):
        assert [(n.pitch, n.velocity, n.hasOnset, n.hasOffset) for n in a_seg] == [
            (n.pitch, n.velocity, n.hasOnset, n.hasOffset) for n in b_seg
        ]
        np.testing.assert_allclose([(n.start, n.end) for n in a_seg],
                                   [(n.start, n.end) for n in b_seg], atol=1e-6)


# -- optimizer and clip --------------------------------------------------------------


def test_schedule_matches_jax():
    n = 1000
    sched = onecycle_with_cutoff(2e-4, n)
    want = jax_onecycle(2e-4, n)
    for step in (0, 499, 500, 501, 530, 900, n + 500, n + 900):
        np.testing.assert_allclose(
            float(sched(torch.tensor(step))), float(want(jnp.int32(step))), rtol=1e-6
        )


def test_weight_decay_mask_matches_jax(params):
    mask = jax_weight_decay_mask(params["params"])
    want = state_dict_from_flax(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), mask, params["params"]
    ))
    model = _port(TINY1, params)
    got = AdaBelief(model.module.named_parameters()).mask
    assert got == {k: bool(v.reshape(-1)[0] > 0.5) for k, v in want.items()}
    assert got["backbone.encoderLayers.0.fnnBlockF.scale"]
    assert not got["backbone.downConv.6.weight"] and not got["backbone.posEmbedBuilder.proj.weight"]


@pytest.mark.parametrize("start_count", [0, 1000])
def test_optimizer_and_clip_match_optax(params, start_count):
    """Five steps of clip + rectified AdaBelief with masked decay on the
    tiny model's tree, fed the same numpy gradients, against
    ``make_optimizer`` + ``quantile_clip``; from count 0 (the rectification
    gate opens at the fifth step) and from count 1000."""
    kw = dict(max_lr=1e-2, weight_decay=0.5, n_iter=20, warmup_cutoff=2)
    opt_j = jax_make_optimizer(params["params"], **kw)
    p_j = jax.tree_util.tree_map(jnp.asarray, params["params"])
    st_j = opt_j.init(p_j)
    st_j = (st_j[0]._replace(count=jnp.int32(start_count)), st_j[1],
            st_j[2]._replace(count=jnp.int32(start_count)))
    clip_j = quantile_clip_init()
    update_j = jax.jit(opt_j.update)
    clip_fn_j = jax.jit(lambda g, s: quantile_clip(g, s, 0.8))

    model = _port(TINY1, params)
    opt = AdaBelief(model.module.named_parameters(), **kw)
    opt.count.fill_(start_count)
    clip = QuantileClip("cpu")
    names = [n for n, _ in opt.named]
    rng = np.random.default_rng(5)
    finite = torch.tensor(True)
    for _ in range(5):
        scale = float(rng.uniform(0.5, 3.0))
        g_j = jax.tree_util.tree_map(
            lambda a: jnp.asarray((rng.normal(size=a.shape) * scale).astype(np.float32)), p_j
        )
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
    assert int(clip.count) == int(clip_j.count) and int(opt.count) == int(st_j[0].count)
    # 1e-7 absolute besides: the clip scale differs in its 7th digit, so an
    # entry that cancels to near 0 (a moment, a parameter) keeps an error of
    # 1e-7 of the terms that made it (gradients ~1, parameters ~0.1-1)
    for tree, got in ((p_j, dict(model.module.named_parameters())),
                      (st_j[0].mu, opt.mu), (st_j[0].nu, opt.nu)):
        want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, tree)})
        for name in names:
            np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


# -- the step, checkpoints -------------------------------------------------------------


def _train_state(seed=0):
    model = TransKun(ModelConfig.from_dict(TINY1), device="cpu", seed=seed)
    optimizer = AdaBelief(model.module.named_parameters(), max_lr=2e-3, n_iter=1000, warmup_cutoff=0)
    return TrainState(model, optimizer)


def _snapshot(state):
    return {
        "params": {k: v.clone() for k, v in state.model.module.state_dict().items()},
        "mu": {k: v.clone() for k, v in state.optimizer.mu.items()},
        "nu": {k: v.clone() for k, v in state.optimizer.nu.items()},
        "count": state.optimizer.count.clone(),
        "buffer": state.clip.buffer.clone(),
        "clip_count": state.clip.count.clone(),
    }


def _assert_same(a, b):
    for key in a:
        if isinstance(a[key], dict):
            for k in a[key]:
                assert torch.equal(a[key][k], b[key][k]), (key, k)
        else:
            assert torch.equal(a[key], b[key]), key


def test_nonfinite_step_keeps_state():
    state = _train_state()
    step = make_train_step(state.model)
    audio, notes = _batch()
    frames, labels = state.model.frames(audio), state.model.labels(notes, 8)
    m = step(state, frames, labels, torch.Generator().manual_seed(0))
    assert bool(m["finite"]) and np.isfinite(float(m["loss"]))
    snap = _snapshot(state)
    bad = frames.clone()
    bad[0, 0, 0, 0] = float("nan")
    m = step(state, bad, labels, torch.Generator().manual_seed(1))
    assert not bool(m["finite"])
    _assert_same(snap, _snapshot(state))
    assert state.step == 2
    m = step(state, frames, labels, torch.Generator().manual_seed(2))
    assert bool(m["finite"]) and int(state.optimizer.count) == 2


def test_checkpoint_round_trip_and_fallbacks(tmp_path):
    state = _train_state()
    step = make_train_step(state.model)
    audio, notes = _batch()
    step(state, state.model.frames(audio), state.model.labels(notes, 8), torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.pt")
    best = {k: v.clone() for k, v in state.model.module.state_dict().items()}
    ckpt_mod.save_checkpoint(path, state, best, {"epoch": 3, "run_seed": 11})
    assert ckpt_mod.checkpoint_exists(path)
    assert sorted(os.listdir(tmp_path)) == ["ckpt.pt"]

    fresh = _train_state(seed=5)
    ckpt = ckpt_mod.load_checkpoint(path)
    ckpt_mod.restore_train_state(fresh, ckpt)
    _assert_same(_snapshot(state), _snapshot(fresh))
    assert fresh.step == 1 and ckpt["extra"] == {"epoch": 3, "run_seed": 11}
    # the transcription loader reads the best weights
    from transkun_tpu_torch.utils.convert import load_reference_checkpoint

    assert all(torch.equal(best[k], v) for k, v in load_reference_checkpoint(path).items())

    # a complete .new (a save that stopped before its swap) is the newest
    ckpt_mod.save_checkpoint(path, state, best, {"epoch": 4})
    os.rename(path, path + ".new")
    ckpt_mod.save_checkpoint(str(tmp_path / "other.pt"), state, best, {"epoch": 5})
    os.replace(str(tmp_path / "other.pt"), path)
    assert ckpt_mod.load_checkpoint(path)["extra"]["epoch"] == 4
    # a torn .new falls through to the path, a lone .old is the last resort
    with open(path + ".new", "wb") as f:
        f.write(b"torn")
    assert ckpt_mod.load_checkpoint(path)["extra"]["epoch"] == 5
    os.remove(path + ".new")
    os.rename(path, path + ".old")
    assert ckpt_mod.checkpoint_exists(path)
    assert ckpt_mod.load_checkpoint(path)["extra"]["epoch"] == 5
    with pytest.raises(FileNotFoundError):
        ckpt_mod.load_checkpoint(str(tmp_path / "missing.pt"))


# -- the CLI end to end -----------------------------------------------------------------


def _synth_piece(rng, path_wav, path_mid, dur):
    from scipy.io import wavfile

    from transkun_tpu.data.midi import write_midi

    notes = []
    t = 0.2
    while t < dur - 0.5:
        notes.append(Note(t, t + float(rng.uniform(0.2, 0.4)), int(rng.integers(40, 80)),
                          int(rng.integers(30, 100))))
        t += float(rng.uniform(0.3, 0.6))
    write_midi(notes, path_mid)
    x = np.zeros(int(dur * FS), np.float32)
    tt = np.arange(len(x)) / FS
    for n in notes:
        env = ((tt >= n.start) & (tt < n.end)).astype(np.float32)
        x += 0.1 * env * np.sin(2 * np.pi * 440 * 2 ** ((n.pitch - 69) / 12) * tt).astype(np.float32)
    wavfile.write(path_wav, FS, (np.clip(x, -1, 1) * 32000).astype(np.int16))


def test_cli_train_resume_transcribe(tmp_path):
    """A tiny corpus through the dataset CLI, then the port's trainer on the
    CPU: one epoch (steps, a stats decode, checkpoints, validation), a
    resume for two more steps, and the port's transcribe CLI on the
    checkpoint."""
    from transkun_tpu.cli.create_dataset_maestro import main as create_dataset
    from transkun_tpu_torch.cli.train import main as train
    from transkun_tpu_torch.cli.transcribe import main as transcribe

    root = tmp_path / "corpus"
    os.makedirs(root / "2020")
    rng = np.random.default_rng(0)
    rows = []
    for i, split in enumerate(["train", "validation"]):
        wav, mid = f"2020/p{i}.wav", f"2020/p{i}.midi"
        _synth_piece(rng, str(root / wav), str(root / mid), 3.0)
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"p{i}", "split": split,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": 3.0})
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    create_dataset([str(root), str(root / "meta.csv"), str(tmp_path / "pickles")])
    conf = tmp_path / "tiny.conf"
    conf.write_text(json.dumps({"Model": {"module": "transkun_tpu.models.transkun",
                                          "config": TINY1}}))
    ckpt = str(tmp_path / "ckpt.pt")
    args = [ckpt, "--datasetPath", str(root),
            "--datasetMetaFile_train", str(tmp_path / "pickles" / "train.pickle"),
            "--datasetMetaFile_val", str(tmp_path / "pickles" / "val.pickle"),
            "--modelConf", str(conf), "--batchSize", "2", "--maxEvents", "8",
            "--statsEvery", "3", "--ckptEvery", "2", "--logEvery", "1", "--seed", "3",
            "--warmupCutoff", "0", "--nIter", "100", "--dataLoaderWorkers", "0", "--device", "cpu"]

    first = train(args + ["--maxEpoch", "1"])
    assert first["steps"] >= 3 and first["stats_passes"] >= 1 and first["val_batches"] >= 1
    assert len(first["stats_seconds"]) == first["stats_passes"]
    assert np.isfinite(first["losses"]).all() and len(first["losses"]) == first["steps"]
    saved = ckpt_mod.load_checkpoint(ckpt)
    assert saved["step"] == first["steps"] and saved["extra"]["epoch"] == 1
    assert saved["extra"]["run_seed"] == 3 and "best_state_dict" in saved

    second = train(args + ["--maxEpoch", "2", "--stopAtStep", str(first["steps"] + 2)])
    assert second["steps"] == 2 and np.isfinite(second["losses"]).all()
    assert ckpt_mod.load_checkpoint(ckpt)["step"] == first["steps"] + 2

    out = tmp_path / "out.mid"
    transcribe([str(root / "2020" / "p1.wav"), str(out), "--conf", str(conf), "--weight", ckpt,
                "--device", "cpu"])
    assert out.exists()
    # the device corpus cannot take host augmentation: the JAX trainer's refusal
    with pytest.raises(SystemExit, match="--deviceData on is incompatible with: host augmentation"):
        train(args + ["--deviceData", "on", "--augment"])
