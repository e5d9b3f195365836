"""FLOP and byte counters against counts by hand and by torch's own FLOP
counter on the plain reference, at a small size."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import manifest, synth, weights
from bp_tiny import TINY_V2
from reference import frontend
from reference import train as rt
from reference import v2 as rv2

semicrf = manifest.load_module("counters", "semicrf")
h100 = manifest.load_module("counters", "h100")
cv2 = manifest.load_module("counters", "v2")


def test_table_bound_by_hand():
    # t = 4 frames, 2 lanes: 6 triangle entries a lane, 12 in all; 48 bytes of
    # scores, three [4, 2] float32 tables (96 bytes): 144 bytes
    least, by = semicrf.table_bound_s(4, 2, 2)
    assert by == "bytes" and least == pytest.approx(144 / h100.HBM_BYTES_PER_S)
    # at the flagship's shapes the bytes bound it, for both kernels
    assert semicrf.table_bound_s(691, 90, semicrf.VITERBI_OPS_PER_TERM)[1] == "bytes"
    assert semicrf.table_bound_s(691, 360, semicrf.LOGZ_OPS_PER_TERM)[1] == "bytes"


def _v2_conf():
    from transkun_tpu_torch.models.config import ModelConfig

    return ModelConfig.from_dict(TINY_V2).to_dict()


def _layout(conf):
    from transkun_tpu_torch.models.config import ModelConfig
    from transkun_tpu_torch.models.transkun import TransKunModule

    return weights.layout_of(TransKunModule(ModelConfig.from_dict(conf)).state_dict())


def _batch(conf, n):
    spec = {"first_onset_s": 0.3, "pitch": [36, 95], "duration_s": [0.15, 0.6], "gap_s": [0.1, 0.3],
            "velocity": [30, 110], "distinct_pitch_overlap": True, "retry_s": 0.05, "noise": 0.003,
            "decay": 2.0, "amplitude": 0.1}
    rng = np.random.default_rng(3)
    notes = synth.draw_notes(10.0, spec, rng)
    wave = synth.render(notes, 10.0, conf["fs"], spec, rng)
    seg = conf["segmentSizeInSecond"]
    begins = [0.3 + 2.1 * i for i in range(n)]
    waves = [rt.chunk_audio(wave, b, conf["fs"], int(seg * conf["fs"])) for b in begins]
    lab = rt.labels([rt.chunk_notes(notes, b, b + seg) for b in begins], conf["hopSize"] / conf["fs"],
                    rv2.PITCHES, "cpu")
    return rt.batch_frames(waves, conf, "cpu"), lab


def test_v2_segment_flops_match_torch_counter():
    conf = _v2_conf()
    ref = rv2.Model(conf, weights.make(_layout(conf), conf, 1, "cpu"), "cpu")
    fr = frontend.frames(torch.randn(1, 1, 8000), conf["hopSize"], conf["windowSize"])
    with FlopCounterMode(display=False) as fc:
        ref.scores(ref.ctx(fr))
    assert fc.get_total_flops() == cv2.segment_flops(conf, fr.shape[2])


def test_v2_train_flops_match_torch_counter():
    conf = _v2_conf()
    ref = rv2.Model(conf, weights.make(_layout(conf), conf, 1, "cpu"), "cpu")
    fr, lab = _batch(conf, 2)
    with FlopCounterMode(display=False) as fc:
        ref.log_prob(fr, lab)
    assert 3 * fc.get_total_flops() == cv2.train_step_flops(conf, 2, fr.shape[2], lab["begins"].shape[-1])
