"""What the transcription drivers share: the model with the harness's
weights, the traffic's pool, warm-up, the host spans of a traced stretch,
and the check of the notes against the plain reference."""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import numpy as np

from . import compare, stats, synth, trace, weights


def segments(conf: Dict, n_samples: int):
    """Segments a piece of ``n_samples`` is cut into."""
    fs, hop = conf["fs"], conf["hopSize"]
    pad = math.ceil((conf["segmentSizeInSecond"] - conf["segmentHopSizeInSecond"]) * fs)
    step = math.ceil(conf["segmentHopSizeInSecond"] * fs / hop) * hop
    return math.ceil((n_samples + 2 * pad) / step)


def frames_per_segment(conf: Dict) -> int:
    return math.ceil(math.ceil(conf["segmentSizeInSecond"] * conf["fs"]) / conf["hopSize"]) + 1


def set_precision(config: Dict) -> None:
    """fp32 means TF32 off for products and convolutions, as the CLIs set it."""
    import torch

    if config["precision"] != "fp32":
        raise SystemExit(f"bench_port: precision {config['precision']!r} has no driver setting")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(run):
    """The program's V2 model on the card with the harness's weights;
    returns (model, the weights on the host)."""
    from transkun_tpu_torch.models.config import ModelConfig
    from transkun_tpu_torch.models.transkun import TransKun

    set_precision(run.cell.config)
    model = TransKun(ModelConfig.from_dict(run.conf), device=run.device)
    w = weights.make(weights.layout_of(model.module.state_dict()), run.conf, run.seed, run.device,
                     run.cell.config.get("overrides"))
    model.load_state_dict(w)
    return model, {k: v.cpu() for k, v in w.items()}


def make_pool(run):
    lengths, waves, order = synth.pool(run.cell.traffic, run.conf["fs"], run.seed)
    return [w[:, None] for w in waves], order


def warm_items(run, items: List[np.ndarray], per_group: int) -> List[int]:
    """The shortest item of each distinct size of a piece's last group: the
    shapes this traffic launches, and no others."""
    seen = {}
    for i in sorted(range(len(items)), key=lambda i: len(items[i])):
        last = segments(run.conf, len(items[i])) % per_group or per_group
        seen.setdefault(last, i)
    return sorted(seen.values())


def compact(notes) -> np.ndarray:
    return np.array([(n.start, n.end, n.pitch, n.velocity) for n in notes], np.float64).reshape(-1, 4)


@contextlib.contextmanager
def host_spans(model):
    """Name the model's dispatch and finish in the trace (instance
    attributes over the methods; removed afterwards)."""
    disp, fin = model._transcribe_dispatch, model._transcribe_finish

    def dispatch(*a, **k):
        with trace.span("dispatch"):
            return disp(*a, **k)

    def finish(*a, **k):
        with trace.span("finish"):
            return fin(*a, **k)

    model._transcribe_dispatch, model._transcribe_finish = dispatch, finish
    try:
        yield
    finally:
        del model._transcribe_dispatch, model._transcribe_finish


def marks_totals(marks) -> Dict[str, float]:
    """A piece's ``TRANSKUN_TPU_TIMING`` marks -> dispatch seconds (begin to
    the last group enqueued) and finish seconds (event waited for to the
    end)."""
    at = dict()
    for label, t in marks:
        at[label] = t
    groups = [t for label, t in marks if label.startswith("group ")]
    return {"dispatch": groups[-1] - at["begin"], "finish": marks[-1][1] - at["event waited for"]}


def window_result(run, items, done, wall, marks, host_walks) -> None:
    """The window's end-to-end numbers, counters and notes from its
    completed items [(item, notes)]."""
    audio_s = sum(len(items[k]) for k, _ in done) / run.conf["fs"]
    n_seg = sum(segments(run.conf, len(items[k])) for k, _ in done)
    run.e2e["transcribe_rtf"] = stats.rate(audio_s, wall)
    run.peak_bytes = run.peak()
    run.e2e["peak_mem_gib"] = run.peak_bytes / 2**30
    run.attempted = len(done)
    run.notes.update(items_completed=len(done), audio_seconds=audio_s, window_s=wall,
                     notes_per_audio_second=sum(len(n) for _, n in done) / audio_s,
                     items_resumed_on_host_walk=host_walks, segments=n_seg)
    run.counters.update(segments=n_seg, window_s=wall, marks=marks, frames=frames_per_segment(run.conf))


def check(run, items, completed, params, w_host) -> None:
    """Sample completed items (drawn from the seed, the longest among
    them), transcribe each with the plain reference, and hold the program's
    notes to it: the largest share of unpaired notes over the sample."""
    from reference import lowp, v2

    chk = params["check"]
    by_item = {}
    for k, notes in completed:
        by_item.setdefault(k, notes)
    keys = sorted(by_item)
    rng = np.random.default_rng(run.seed ^ 0x5EED)
    longest = max(keys, key=lambda k: len(items[k]))
    sample = [longest] + [k for k in rng.permutation(keys).tolist() if k != longest][:chk["sample"] - 1]
    run.free()
    set_precision(run.cell.config)
    ref = v2.Model(run.conf, {k: v.to(run.device) for k, v in w_host.items()}, run.device)
    worst, t0 = 0.0, time.perf_counter()
    for k in sample:
        x = items[k][:, 0].astype(np.float32) / 32768.0
        want = [(n["start"], n["end"], n["pitch"], n["velocity"]) for n in ref.transcribe(x)]
        got = [tuple(r) for r in by_item[k].tolist()]
        share = compare.note_mismatch(got, want, chk["tolerance_s"])
        worst = max(worst, share)
        run.failed += share > chk["note_mismatch"]
        if run.control:
            with lowp.tf32(run.device):
                low = [(n["start"], n["end"], n["pitch"], n["velocity"]) for n in ref.transcribe(x)]
            share = compare.note_mismatch(low, want, chk["tolerance_s"])
            run.control_readings["note_mismatch"] = max(run.control_readings.get("note_mismatch", 0.0), share)
    run.notes["reference_s"] = time.perf_counter() - t0
    run.notes["checked_items"] = len(sample)
    run.checks["note_mismatch"] = (worst, chk["note_mismatch"])
