"""Whole pieces through ``TransKun.transcribe_many`` at its default depth
(the transcription CLI's directory mode), as a closed loop: the pool's
pieces in the seeded order, cycled, each handed over when the pipeline
asks for the next.

The window starts when the first piece is handed over and ends when the
last piece in flight completes after ``--seconds``; ``transcribe_rtf`` is
the audio of every completed piece over that wall time."""

from __future__ import annotations

import os
import time

from benchlib import trace, transcription


def _loop(run, model, items, order, start, seconds, record_marks, traced=False):
    """Pieces from ``order[start:]`` (cycled) until one completes after
    ``seconds``, each hand-over marked in the trace when ``traced``; ->
    (first hand-over time, end time, [(item, notes)], [marks totals], next
    start, items resumed on the host walk)."""
    stop = [False]
    handed = []

    def feed():
        i = start
        while not stop[0]:
            k = order[i % len(order)]
            handed.append((k, time.perf_counter()))
            trace.mark(traced)
            yield items[k]
            i += 1

    done, marks, walked_on_host = [], [], []
    for notes in model.transcribe_many(feed()):
        t = time.perf_counter()
        done.append((handed[len(done)][0], transcription.compact(notes)))
        walked_on_host.append(model.last_transcribe_fallback_from is not None)
        if record_marks:
            marks.append(transcription.marks_totals(model.last_transcribe_marks))
        if t - handed[0][1] >= seconds:
            stop[0] = True
    return handed[0][1], time.perf_counter(), done, marks, start + len(handed), sum(walked_on_host)


def measure(run) -> None:
    params = run.cell.params
    model, w_host = transcription.build(run)
    items, order = transcription.make_pool(run)
    per_group = 4  # the program's default group, which the CLI takes
    warm = transcription.warm_items(run, items, per_group)
    list(model.transcribe_many(items[k] for k in warm))
    if run.trace:
        os.environ["TRANSKUN_TPU_TIMING"] = "silent"
    run.sync()
    run.reset_peak()
    run.setup_done()

    t_start, t_end, done, marks, nxt, host_walks = _loop(run, model, items, order, 0, run.seconds, run.trace)
    transcription.window_result(run, items, done, t_end - t_start, marks, host_walks)
    if run.trace:
        out = []
        with transcription.host_spans(model), trace.stretch(out):
            t0, t1, traced, *_ = _loop(run, model, items, order, nxt, params["trace_seconds"], False, True)
        run.summary = out[0]
        traced_rtf = sum(len(items[k]) for k, _ in traced) / run.conf["fs"] / (t1 - t0)
        run.notes.update(traced_rtf=traced_rtf, traced_s=run.summary.traced_s,
                         profiler_cost_pct=100.0 * (1.0 - traced_rtf / run.e2e["transcribe_rtf"]))
        os.environ.pop("TRANSKUN_TPU_TIMING", None)
    del model
    run.state = (items, done, w_host)


def check(run) -> None:
    items, done, w_host = run.state
    del run.state
    transcription.check(run, items, done, run.cell.params, w_host)
