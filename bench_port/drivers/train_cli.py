"""Flagship training through the training CLI's own loop, in this
process: ``transkun_tpu_torch.cli.train.main`` on the traffic's corpus at
the cell's batch and flags (the corpus on the card by the CLI's default
``--deviceData auto``, stats passes at its ``--statsEvery``, metrics
fetched at its ``--logEvery``).

The harness edits nothing of the program.  It puts a wrapper around the
step function that ``make_train_step`` returns (``benchlib.training.Tap``),
which loads the harness's weights into the model when the CLI builds the
step, times the window and ends the loop; it records which chunks the
loader picked (``DeviceDataset.starts_for``'s arguments) for the check;
and it marks the stats passes (named in a trace, and the time between
steps that holds one told apart from the input route).  ``train_step_s``
is the window's wall time over its steps, the input route, labels, metric
fetches and stats passes included.  The check draws each step's dropout
masks from the seed the CLI gives that step (``--seed``, the step)."""

from __future__ import annotations

from benchlib import trace, training, weights


def measure(run) -> None:
    import transkun_tpu_torch.train.step as step_mod
    from transkun_tpu_torch.cli import train as cli
    from transkun_tpu_torch.data import device_dataset

    params = run.cell.params
    root, pickles, pieces = training.corpus(run)
    conf_path = training.model_conf_file(run, "transkun_tpu_torch.models.transkun")
    picked = []
    holder = {}
    real_make, real_starts = step_mod.make_train_step, device_dataset.DeviceDataset.starts_for

    def starts_for(self, piece_idx, begins_sec):
        picked.append(([int(i) for i in piece_idx], [float(b) for b in begins_sec]))
        return real_starts(self, piece_idx, begins_sec)

    def make_train_step(model, **kw):
        w = weights.make(weights.layout_of(model.module.state_dict()), run.conf, run.seed, run.device,
                         run.cell.config.get("overrides"))
        model.load_state_dict(w)
        holder["w_host"] = {k: v.cpu() for k, v in w.items()}
        tap = training.Tap(run, real_make(model, **kw), w, params["optimizer_count"], params["warm_steps"],
                           _arg(params, "--logEvery"))
        for name in ("compute_stats", "compute_stats_mireval"):
            setattr(model, name, _stats(tap, getattr(model, name)))
        holder["tap"] = tap
        return tap

    argv = [f"{run.tmpdir()}/run.pt", "--datasetPath", root,
            "--datasetMetaFile_train", f"{pickles}/train.pickle",
            "--datasetMetaFile_val", f"{pickles}/val.pickle",
            "--modelConf", conf_path, "--seed", str(cli_seed(run)),
            "--device", "cuda" if run.on_card() else "cpu", *params["cli_args"]]
    step_mod.make_train_step = make_train_step
    device_dataset.DeviceDataset.starts_for = starts_for
    try:
        cli.main(argv)
    except training.WindowClosed:
        pass
    else:
        raise RuntimeError("the training loop ended before the window closed: the corpus is too short")
    finally:
        step_mod.make_train_step = real_make
        device_dataset.DeviceDataset.starts_for = real_starts
    tap = holder["tap"]
    tap.finish()
    run.sync()
    run.free()
    run.state = (tap, picked, pieces, holder["w_host"])


def cli_seed(run) -> int:
    return run.seed % 2**31


def _arg(params, flag: str) -> int:
    args = params["cli_args"]
    return int(args[args.index(flag) + 1])


def _stats(tap, fn):
    def call(*a, **k):
        tap.stats_seen = True
        with trace.span("stats"):
            return fn(*a, **k)
    return call


def check(run) -> None:
    tap, picked, pieces, w_host = run.state
    del run.state
    training.check(run, tap, picked, pieces, w_host, cli_seed(run), _arg(run.cell.params, "--maxEvents"))
