"""What the training drivers share: the corpus, the step-function tap
that times the window, and the check of the first three steps against the
plain reference."""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List

import numpy as np

from . import compare, synth, trace


class WindowClosed(Exception):
    """Raised through the program's loop when the measurement is over."""


def corpus(run):
    """The traffic's MAESTRO-layout corpus under the run's directory, and
    its pickles made by the program's ``create_dataset_maestro``.  Returns
    (dataset root, pickle directory, [(notes, int16 wave)] of the training
    pieces)."""
    from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset

    root = os.path.join(run.tmpdir(), "corpus")
    meta, pieces = synth.write_corpus(root, run.cell.traffic, run.conf["fs"], run.seed)
    out = os.path.join(root, "pickles")
    create_dataset([root, meta, out])
    return root, out, pieces


class Tap:
    """Wraps the program's step function: counts and times steps, moves
    the run from warm-up to the window to the traced stretch, reads what the
    check needs from the first steps, and ends the loop by raising
    ``WindowClosed``.

    Calls ``0 .. warm-1`` are set-up.  The first call sets the optimizer's
    count to the cell's start (a run past AdaBelief's rectification gate);
    after call 0 the gradient as the optimizer took it is read from its
    first moment, at call 3 the parameters' change over calls 0-2; the
    window opens at call ``warm`` and closes at the first call after
    ``seconds``, on a synchronized card; with ``trace`` a profiled stretch
    of ``trace_seconds`` follows.

    The host time between one call's return and the next call goes to
    ``loop_s`` where the loop fetched its metrics in it (after every
    ``log_every``-th call) or ran a stats pass (``stats_seen``, set by the
    driver), and to ``input_s`` otherwise: the input route alone."""

    def __init__(self, run, real_step, w0: Dict, count0: int, warm: int, log_every: int = 0,
                 b1: float = 0.9):
        import torch

        self.torch = torch
        self.run = run
        self.real = real_step
        self.w0 = w0  # initial weights on the device, freed once read
        self.count0, self.warm, self.log_every, self.b1 = count0, warm, log_every, b1
        self.calls = 0
        self.losses, self.finite = [], []
        self.grad_norms = self.change_norms = None
        self.t_start = self.t_end = None
        self.returned = None
        self.input_s: List[float] = []
        self.loop_s: List[float] = []
        self.stats_seen = False
        self.dropout_seeds: List[int] = []  # the program's generator seeds of the first steps
        self.traced_steps = 0
        self.peak = 0
        self.in_input = None
        self.tracer = None
        self.trace_t0 = None
        self.shape = (0, 0, 0)  # batch, frames, label slots a track (the largest seen)

    def __call__(self, state, frames, labels, generator):
        torch, run = self.torch, self.run
        now = time.perf_counter()
        n = self.calls
        if self.in_input is not None:
            self.in_input.__exit__(None, None, None)
            self.in_input = None
        if n == 0:
            state.optimizer.count.fill_(self.count0)
        if n == 3:
            with torch.no_grad():
                self.change_norms = compare.leaf_norms(
                    {k: p.detach() - self.w0[k] for k, p in state.optimizer.named})
            self.w0 = None
        if n == self.warm:
            os.sync()  # the corpus written in set-up goes to disk now, not in the window
            run.sync()
            run.reset_peak()
            run.setup_done()
            now = self.t_start = time.perf_counter()
        elif self.t_start is not None and self.t_end is None and now - self.t_start >= run.seconds:
            run.sync()
            now = self.t_end = time.perf_counter()
            self.window_steps = n - self.warm
            if not run.trace:
                raise WindowClosed
            self.tracer = trace.Tracer()
            self.tracer.start()
            self.trace_t0 = time.perf_counter()
        elif self.tracer is not None and now - self.trace_t0 >= run.cell.params["trace_seconds"]:
            run.sync()
            traced = (time.perf_counter() - self.trace_t0) / self.traced_steps
            window = (self.t_end - self.t_start) / self.window_steps
            run.notes.update(traced_step_s=traced, profiler_cost_pct=100.0 * (traced / window - 1.0))
            run.summary = self.tracer.stop()
            raise WindowClosed
        if self.t_start is not None and self.t_end is None and self.returned is not None and n > self.warm:
            fetched = self.log_every > 0 and n % self.log_every == 0
            (self.loop_s if fetched or self.stats_seen else self.input_s).append(now - self.returned)
        self.stats_seen = False
        if self.tracer is not None:
            self.traced_steps += 1
        self.shape = (frames.shape[0], frames.shape[2], max(self.shape[2], labels[0].shape[-1]))
        with trace.span("step", self.tracer is not None):
            metrics = self.real(state, frames, labels, generator)
        if self.t_start is not None and self.t_end is None:
            self.peak = max(self.peak, run.peak())
            self.finite.append(metrics["finite"])
        if n < 3:
            self.losses.append(metrics["loss"])
            self.dropout_seeds.append(None if generator is None else int(generator.initial_seed()))
        if n == 0:
            with torch.no_grad():
                self.grad_norms = compare.leaf_norms(
                    {k: state.optimizer.mu[k] / (1 - self.b1) for k, _ in state.optimizer.named})
        self.calls += 1
        self.returned = time.perf_counter()
        if self.tracer is not None:
            self.in_input = torch.profiler.record_function("input")
            self.in_input.__enter__()
        return metrics

    def finish(self) -> None:
        """The window's numbers into the run."""
        run = self.run
        self.real = None  # the program's step and model go with it
        wall = self.t_end - self.t_start
        run.e2e["train_step_s"] = wall / self.window_steps
        run.peak_bytes = self.peak
        run.e2e["peak_mem_gib"] = self.peak / 2**30
        run.attempted = self.window_steps
        finite = [bool(f) for f in self.finite]
        run.failed += finite.count(False)
        run.counters.update(steps=self.window_steps, window_s=wall, input_s=self.input_s, loop_s=self.loop_s,
                            batch=self.shape[0], frames=self.shape[1], k=self.shape[2])
        run.notes.update(window_s=wall, steps=self.window_steps,
                         losses_first_steps=[float(x) for x in self.losses])


def model_conf_file(run, module: str) -> str:
    path = os.path.join(run.tmpdir(), "model.conf")
    with open(path, "w") as f:
        json.dump({"Model": {"module": module, "configClassName": "Config", "config": run.conf}}, f)
    return path


def check(run, tap: Tap, batches, pieces, w_host, run_seed: int, max_events: int) -> None:
    """The plain reference from the same weights through the first three
    steps on the same chunks, with the dropout masks of the run's seed;
    the program's losses, first gradient and change over the three steps
    held to it."""
    import torch

    from reference import lowp
    from reference import train as rt

    params = run.cell.params
    chk = params["check"]
    dev = run.device
    run.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = list(tap.grad_norms)
    steps = (run, w_host, names, batches, pieces, run_seed, max_events)
    losses, grads0, change = _reference_steps(*steps)
    run.notes["reference_s"] = time.perf_counter() - t0
    median_g = float(np.median(list(grads0.values())))
    keep = [k for k in names if grads0[k] >= 1e-3 * median_g]
    run.notes["leaves_compared"] = f"{len(keep)} of {len(names)}"
    prog_losses = [float(x) for x in tap.losses]
    readings = _readings(prog_losses, tap.grad_norms, tap.change_norms, losses, grads0, change, keep)
    ref_seeds = [rt.dropout_seed(run_seed, i) for i in range(3)]
    if tap.dropout_seeds != ref_seeds:
        run.notes["dropout_seeds"] = f"program {tap.dropout_seeds}, reference {ref_seeds}"
    run.notes.update(reference_losses=losses, program_losses=prog_losses,
                     worst_grad_leaf=compare.leaf_gap(tap.grad_norms, grads0, keep)[1],
                     worst_change_leaf=compare.leaf_gap(tap.change_norms, change, keep)[1])
    for name, value in readings.items():
        if name in chk:
            run.checks[name] = (value, chk[name])
        else:
            run.notes[name] = value  # read and said, not compared (PERF.md says why)
    if run.control:
        with lowp.tf32(dev):
            c_losses, c_grads0, c_change = _reference_steps(*steps)
        run.control_readings.update(_readings(c_losses, c_grads0, c_change, losses, grads0, change, keep))
        run.leaf_gaps = {
            "program": {"grad": compare.leaf_gaps(tap.grad_norms, grads0, keep),
                        "change": compare.leaf_gaps(tap.change_norms, change, keep)},
            "control": {"grad": compare.leaf_gaps(c_grads0, grads0, keep),
                        "change": compare.leaf_gaps(c_change, change, keep)}}
    if not all(math.isfinite(x) for x in prog_losses):
        run.failed += 1


def _readings(losses, grads0, change, ref_losses, ref_grads0, ref_change, keep):
    """The numbers a training cell can compare: the largest relative gap of
    the three steps' losses; the worst and the median leaf's gap of the
    first gradient and of the change over the three steps."""
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": compare.leaf_gap(grads0, ref_grads0, keep)[0],
        "change_gap": compare.leaf_gap(change, ref_change, keep)[0],
        "grad_median_gap": compare.median_leaf_gap(grads0, ref_grads0, keep),
        "change_median_gap": compare.median_leaf_gap(change, ref_change, keep),
    }


def _reference_steps(run, w_host, names, batches, pieces, run_seed, max_events):
    """Three reference steps from the harness's weights on the recorded
    chunks, each step's dropout masks drawn from a generator of its seed
    -> (losses, the first gradient's leaf norms as the moments took it, the
    leaves' change norms after the three)."""
    import torch

    from reference import train as rt
    from reference import v2

    conf, dev = run.conf, run.device
    P = {k: w_host[k].to(dev).requires_grad_(True) for k in names}
    extra = {k: v.to(dev) for k, v in w_host.items() if k not in P}
    w0 = {k: v.detach().clone() for k, v in P.items()}
    ref = v2.Model(conf, {**P, **extra}, dev)
    opt = rt.Optimizer(P, run.cell.params["optimizer_count"])
    fs, hop = conf["fs"], conf["hopSize"]
    chunk_s = conf["segmentSizeInSecond"]
    length = int(chunk_s * fs)
    losses, grads0 = [], None
    for step, (piece_idx, begins) in enumerate(batches[:3]):
        waves = [rt.chunk_audio(pieces[i][1], b, fs, length) for i, b in zip(piece_idx, begins)]
        notes = [rt.chunk_notes(pieces[i][0], b, b + chunk_s) for i, b in zip(piece_idx, begins)]
        gen = torch.Generator(device=dev).manual_seed(rt.dropout_seed(run_seed, step))
        lp = ref.log_prob(rt.batch_frames(waves, conf, dev),
                          rt.labels(notes, hop / fs, v2.PITCHES, dev, max_events), gen)
        loss = -lp.sum(-1).mean()
        (loss / 50.0).backward()
        losses.append(loss.item())
        taken = opt.step({k: p.grad for k, p in P.items()})
        for p in P.values():
            p.grad = None
        if step == 0:
            grads0 = compare.leaf_norms(taken)
    change = compare.leaf_norms({k: P[k].detach() - w0[k] for k in names})
    return losses, grads0, change
