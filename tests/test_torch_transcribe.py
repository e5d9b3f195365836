"""The slice as a whole: the JAX package's ``TransKun.transcribe`` and the
port's, with the same weights, on one synthetic multi-segment piece.

Notes must agree in pitch, velocity, hasOnset and hasOffset, and in times
within 1e-6 s, compared pitch by pitch.  Scores differ between the two frameworks by ~1e-6, so a
Viterbi decision whose winner leads by less than that could flip; the test
asserts that every decision on the decoded paths (and every singleton gate
there) leads by more than 1e-3, so a near-tie fails loudly instead of
flaking."""

import jax
import numpy as np
import pytest
import torch

import transkun_tpu_torch.models.transkun as port_transkun
from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.transkun import TransKunModule as JaxModule
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun
from transkun_tpu_torch.ops import semicrf
from transkun_tpu_torch.utils.convert import state_dict_from_flax

FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0,
}


def _piece(dur=7.0, seed=3):
    """Short sine notes at ~20 notes/s, int16-exact like decoded audio."""
    rng = np.random.default_rng(seed)
    x = np.zeros(int(dur * FS), np.float32)
    tt = np.arange(len(x)) / FS
    t = 0.1
    while t < dur - 0.3:
        f0 = 440 * 2 ** ((int(rng.integers(40, 90)) - 69) / 12)
        if f0 < FS / 2:
            env = ((tt >= t) & (tt < t + 0.15)).astype(np.float32)
            x += 0.08 * env * np.sin(2 * np.pi * f0 * tt).astype(np.float32)
        t += 0.05
    x = np.round(np.clip(x, -1, 1) * 32768).clip(-32768, 32767) / np.float32(32768)
    return x.astype(np.float32)[:, None]


def _decision_margins(s_t, noise, diag_raw, ptr, t, n_sym, forced):
    """Smallest lead of the winning move (and of the singleton gate) over
    the walk's visited positions of one segment."""
    s = s_t.numpy().astype(np.float64)
    noise, diag = noise.numpy(), diag_raw.numpy()
    tp = s.shape[0]
    gate = diag * (diag > 0)
    q = np.zeros((tp, s.shape[2]))
    q[tp - 1] = gate[tp - 1]
    for p in range(tp - 2, -1, -1):
        best = np.maximum(q[p + 1] + noise[p], (q[p + 1 :] + s[p, p + 1 :]).max(0))
        q[p] = best + gate[p]
    margin = np.inf
    for j in range(n_sym):
        p = int(forced[j])
        while p < t - 1:
            cand = np.concatenate([[q[p + 1, j] + noise[p, j]], q[p + 1 :, j] + s[p, p + 1 :, j]])
            top2 = np.sort(cand)[-2:]
            margin = min(margin, top2[1] - top2[0], abs(diag[p, j]))
            sel = int(ptr[p, j])
            p = p + 1 if sel < 0 else p + 1 + sel
    return margin


def test_transcribe_matches_jax(monkeypatch):
    conf_j = JaxModelConfig.from_dict(TINY)
    jax_model = JaxTransKun(conf_j)
    params = jax.jit(lambda k: jax_model.init(k, n_frames=126))(jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(lambda a: np.array(a), params)
    # Random weights decode near-ties everywhere.  Make the scorer confident,
    # as a trained one is: 10x its projection (scores 100x) and a shared
    # negative q.k offset so that only a few intervals win; the diagonal
    # bias at -8 keeps random singletons off (as bench.py does).
    m = params["params"]["scorer"]["map"]
    e = m["kernel"].shape[1] // 2
    m["kernel"] *= 10.0
    m["bias"][0] += 6.0  # q_0 and k_0 of every frame: q.k drops by 6*6/sqrt(e)
    m["bias"][e] -= 6.0
    m["bias"][-1] = -8.0
    audio = _piece(dur=4.0)

    want = jax_model.transcribe(params, audio)

    model = TransKun(ModelConfig.from_dict(TINY), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    frames_seen, tables, starts = [], [], []
    decode = model.module.process_frames_decode
    viterbi = port_transkun.viterbi_backward_tables_padded
    walk = semicrf.backtrack_backward

    def record_frames(frames, t_pad, p_pad):
        frames_seen.append(frames.numpy())
        return decode(frames, t_pad, p_pad)

    def record_tables(s_t, noise, diag_gate):
        ptr = viterbi(s_t, noise, diag_gate)
        tables.append((s_t, noise, ptr))
        return ptr

    def record_walk(ptr, diag_pos, forced_start=None):
        starts.append(list(forced_start))
        return walk(ptr, diag_pos, forced_start)

    monkeypatch.setattr(model.module, "process_frames_decode", record_frames)
    monkeypatch.setattr(port_transkun, "viterbi_backward_tables_padded", record_tables)
    monkeypatch.setattr(semicrf, "backtrack_backward", record_walk)
    got = model.transcribe(audio)

    assert len(tables) == len(starts) == 6  # a multi-segment piece
    assert len(want) > 100
    assert len(got) == len(want)
    # times differ by ~1e-7 s, which may reorder notes of different pitch
    # that start together; per pitch the order is by time in both
    key = lambda n: (n.pitch, n.start)
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (a.pitch, a.velocity, a.hasOnset, a.hasOffset) == (
            b.pitch, b.velocity, b.hasOnset, b.hasOffset
        )
        assert abs(a.start - b.start) < 1e-6 and abs(a.end - b.end) < 1e-6

    # the decisions behind the notes are far from ties, and far above the
    # score difference between the two frameworks
    t = 126
    margin = min(
        _decision_margins(s_t, noise, torch.diagonal(s_t).transpose(0, 1), ptr, t, 90, forced)
        for (s_t, noise, ptr), forced in zip(tables, starts)
    )
    diff = 0.0
    for frames, (s_t, _, _) in zip(frames_seen, tables):
        s_j = JaxModule(conf_j).apply(
            params, frames, 128, 128, True, method=JaxModule.process_frames_decode
        )[0]
        diff = max(diff, float(np.abs(s_t.numpy()[:t, :t, :90] - np.asarray(s_j)[:t, :t, :90]).max()))
    print(f"smallest decision margin {margin:.3g}, largest score difference {diff:.3g}")
    assert margin > 1e-3, margin
    assert margin > 10 * diff, (margin, diff)


def _note_key(n):
    return (n.start, n.end, n.pitch, n.velocity, n.hasOnset, n.hasOffset)


@pytest.fixture(scope="module")
def grouped():
    """A piece of 9 segments at narrow width, the port's model with a
    confident scorer, and its notes one segment a group."""
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", seed=5)
    with torch.no_grad():
        m = model.module.scorer.map[0]
        e = m.weight.shape[0] // 2
        m.weight *= 10.0
        m.bias[0] += 6.0
        m.bias[e] -= 6.0
        m.bias[-1] = -8.0
    audio = _piece(dur=7.0, seed=11)
    return model, audio, model.transcribe(audio, segment_batch=1)


@pytest.mark.parametrize("segment_batch", [2, 3, None, 100])
def test_segment_batch_changes_no_note(grouped, segment_batch):
    """Grouping is bookkeeping: the same notes, bit for bit and in the same
    order, for every group size, the default and one group for the piece."""
    model, audio, want = grouped
    assert len(want) > 30
    got = model.transcribe(audio, segment_batch=segment_batch)
    assert [_note_key(n) for n in got] == [_note_key(n) for n in want]


@pytest.mark.parametrize("segment_batch", [1, 2, None])
def test_at_most_two_groups_of_ctx_alive(grouped, monkeypatch, segment_batch):
    """Whenever a group's device work is enqueued or its attributes are read,
    no ctx but its own and one neighbour's exists: memory does not grow with
    the piece."""
    import gc
    import weakref

    model, audio, _ = grouped
    made, alive_seen, sizes = [], [], []
    group_tables, assemble = model._group_tables, model._attr_and_assemble

    def alive():
        gc.collect()
        return sum(r() is not None for r in made)

    def counted_tables(audio, starts, *args):
        out = group_tables(audio, starts, *args)
        made.append(weakref.ref(out[3]))
        sizes.append(len(starts))
        assert tuple(out[3].shape[:2]) == (len(starts), 90)
        alive_seen.append(alive())
        return out

    def counted_assemble(ctx, *args, **kwargs):
        alive_seen.append(alive())
        return assemble(ctx, *args, **kwargs)

    monkeypatch.setattr(model, "_group_tables", counted_tables)
    monkeypatch.setattr(model, "_attr_and_assemble", counted_assemble)
    model.transcribe(audio, segment_batch=segment_batch)
    per_group = segment_batch or port_transkun.DEFAULT_SEGMENT_BATCH
    assert sum(sizes) == 9 and max(sizes) == per_group and len(sizes) == -(-9 // per_group) >= 3
    assert len(alive_seen) == 2 * len(sizes) and max(alive_seen) == 2
    assert alive() == 0  # nothing of the piece stays on the device


def test_segment_batch_matches_jax():
    """Grouped transcription against the JAX package's own ``segment_batch``
    on a piece of 9 segments: the same notes for every group size."""
    conf_j = JaxModelConfig.from_dict(TINY)
    jax_model = JaxTransKun(conf_j)
    params = jax.jit(lambda k: jax_model.init(k, n_frames=126))(jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(lambda a: np.array(a), params)
    m = params["params"]["scorer"]["map"]  # a confident scorer, as above
    e = m["kernel"].shape[1] // 2
    m["kernel"] *= 10.0
    m["bias"][0] += 6.0
    m["bias"][e] -= 6.0
    m["bias"][-1] = -8.0
    audio = _piece(dur=7.0, seed=4)
    want = jax_model.transcribe(params, audio, segment_batch=2)
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    key = lambda n: (n.pitch, n.start)
    assert len(want) > 100
    for segment_batch in (1, 2, 3, None):
        got = model.transcribe(audio, segment_batch=segment_batch)
        assert len(got) == len(want)
        for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
            assert (a.pitch, a.velocity, a.hasOnset, a.hasOffset) == (
                b.pitch, b.velocity, b.hasOnset, b.hasOffset
            )
            assert abs(a.start - b.start) < 1e-6 and abs(a.end - b.end) < 1e-6


@pytest.mark.parametrize("n", [60, 2000])  # the JAX package's scalar and vector paths
def test_resolve_overlapping_equals_jax(n):
    """The port's copy of the note tail against ``transkun_tpu.data.note``
    on dense same-pitch overlaps, ties and zero-length notes: equal notes,
    in the same order."""
    from transkun_tpu.data import note as jnote
    from transkun_tpu_torch.data import note as tnote

    rng = np.random.default_rng(n)
    start = rng.integers(0, n // 2, size=n) / 4.0
    dur = rng.integers(0, 6, size=n) / 4.0
    pitch = rng.integers(20, 26, size=n)
    rows = list(zip(start.tolist(), (start + dur).tolist(), pitch.tolist()))
    want = jnote.resolve_overlapping([jnote.Note(s, e, p, 64) for s, e, p in rows])
    got = tnote.resolve_overlapping([tnote.Note(s, e, p, 64) for s, e, p in rows])
    assert len(want) < n
    assert [(a.start, a.end, a.pitch) for a in got] == [(b.start, b.end, b.pitch) for b in want]


def test_cli_transcribes_to_midi(tmp_path):
    """The port's CLI on the CPU (asked for explicitly): a tiny conf, a
    reference-style checkpoint file, a wav in, a MIDI file out; and the
    default device refuses to fall back to the CPU without CUDA."""
    import json

    from scipy.io import wavfile

    from transkun_tpu.data.midi import read_midi
    from transkun_tpu_torch.cli.transcribe import main

    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(json.dumps(
        {"Model": {"module": "transkun_tpu.models.transkun", "config": TINY}}
    ))
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", seed=1)
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] = -8.0
    weight = tmp_path / "ref.pt"
    torch.save({"state_dict": model.module.state_dict()}, weight)
    wav = tmp_path / "in.wav"
    wavfile.write(wav, FS, (_piece(dur=3.0)[:, 0] * 32768).astype(np.int16))
    out = tmp_path / "out.mid"

    args = [str(wav), str(out), "--conf", str(conf_path), "--weight", str(weight)]
    main(args + ["--device", "cpu"])
    assert out.exists() and read_midi(str(out)) is not None
    assert len(model.transcribe(_piece(dur=3.0))) > 0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            main(args)


def test_transkun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``TransKun(conf)`` means the card: without CUDA it raises and names
    ``device="cpu"`` rather than carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = ModelConfig.from_dict(TINY)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TransKun(conf)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TransKun(conf, device="cuda")
    assert TransKun(conf, device="cpu").device == torch.device("cpu")
