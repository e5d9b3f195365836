"""The plain reference against the program at a small CPU size: the notes
of a transcription, a chunk's frames and labels, and the training
objective with its dropout masks, from the same harness-made weights."""

import numpy as np
import torch

from benchlib import compare, synth, weights
from bp_tiny import TINY_V2
from reference import train as rt
from reference import v2 as rv2

SPEC = {"first_onset_s": 0.2, "pitch": [21, 108], "duration_s": [0.1, 0.8], "gap_s": [0.05, 0.25],
        "velocity": [30, 110], "distinct_pitch_overlap": True, "retry_s": 0.05, "noise": 0.005,
        "decay": 3.0, "amplitude": 0.1}


def _v2(seed):
    from transkun_tpu_torch.models.config import ModelConfig
    from transkun_tpu_torch.models.transkun import TransKun

    conf = ModelConfig.from_dict(TINY_V2)
    model = TransKun(conf, device="cpu")
    full = conf.to_dict()
    w = weights.make(weights.layout_of(model.module.state_dict()), full, seed, "cpu",
                     {"scorer.map.0.bias[-1]": -2.0})
    model.load_state_dict(w)
    return model, rv2.Model(full, {k: v.clone() for k, v in w.items()}, "cpu"), full


def test_transcription_notes_equal():
    model, ref, conf = _v2(2**40 + 1)
    rng = np.random.default_rng(5)
    wave = synth.render(synth.draw_notes(6.0, SPEC, rng), 6.0, conf["fs"], SPEC, rng)
    got = [(n.start, n.end, n.pitch, n.velocity) for n in model.transcribe(wave[:, None])]
    want = [(n["start"], n["end"], n["pitch"], n["velocity"])
            for n in ref.transcribe(wave.astype(np.float32) / 32768.0)]
    assert len(got) > 100
    assert compare.note_mismatch(got, want, 1e-3) == 0.0


def _chunks(conf, n):
    rng = np.random.default_rng(7)
    notes = synth.draw_notes(12.0, SPEC, rng)
    wave = synth.render(notes, 12.0, conf["fs"], SPEC, rng)
    seg = conf["segmentSizeInSecond"]
    begins = [-0.4, 3.3, 9.7][:n]  # one chunk overhangs the piece's start
    return notes, wave, begins, seg


def test_frames_and_labels_equal_the_programs():
    from transkun_tpu_torch.data.note import Note

    model, _, conf = _v2(3)
    notes, wave, begins, seg = _chunks(conf, 3)
    waves = [rt.chunk_audio(wave, b, conf["fs"], int(seg * conf["fs"])) for b in begins]
    chunk = [rt.chunk_notes(notes, b, b + seg) for b in begins]
    assert torch.equal(model.frames(np.stack(waves)[..., None]), rt.batch_frames(waves, conf, "cpu"))
    got = model.labels([[Note(*n) for n in c] for c in chunk])
    want = rt.labels(chunk, conf["hopSize"] / conf["fs"], rv2.PITCHES, "cpu")
    k = want["begins"].shape[-1]
    for i, name in enumerate(("begins", "ends", "mask", "velocity", "refine", "presence")):
        g = got[i][:, :, :k]
        assert torch.allclose(g.to(want[name].dtype), want[name], atol=1e-6), name
        assert not got[i][:, :, k:].bool().any()


def test_v2_objective_equal():
    from transkun_tpu_torch.data.note import Note

    model, ref, conf = _v2(4)
    notes, wave, begins, seg = _chunks(conf, 2)
    waves = [rt.chunk_audio(wave, b, conf["fs"], int(seg * conf["fs"])) for b in begins]
    chunk = [rt.chunk_notes(notes, b, b + seg) for b in begins]
    assert conf["velocityDropoutProb"] > 0 and conf["refinedOFDropoutProb"] > 0
    lp = model.make_train_loss()(model.frames(np.stack(waves)[..., None]),
                                 model.labels([[Note(*n) for n in c] for c in chunk], 32),
                                 torch.Generator().manual_seed(rt.dropout_seed(77, 2)))
    labels = rt.labels(chunk, conf["hopSize"] / conf["fs"], rv2.PITCHES, "cpu", 32)
    want = ref.log_prob(rt.batch_frames(waves, conf, "cpu"), labels,
                        torch.Generator().manual_seed(rt.dropout_seed(77, 2)))
    assert torch.allclose(lp, want, rtol=1e-5, atol=1e-3)
    # other masks give another objective: the comparison sees the masks
    other = ref.log_prob(rt.batch_frames(waves, conf, "cpu"), labels,
                         torch.Generator().manual_seed(rt.dropout_seed(78, 2)))
    assert not torch.allclose(other, want, rtol=1e-5, atol=1e-3)


def test_reference_imports_nothing_of_the_program():
    import ast
    import glob
    import os

    for path in glob.glob(os.path.join(os.path.dirname(rv2.__file__), "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("transkun_tpu_torch", "transkun_tpu", "jax", "flax"), (path, name)
