"""Model FLOPs of the window's training steps (forward and backward, no
recomputation; the configuration's counter) over the window's wall time
and the card's dense bf16 peak, in percent."""


def read(run):
    if "steps" not in run.counters:
        return None
    c = run.counters
    flops = run.counter(run.cell.config["model"]).train_step_flops(run.conf, c["batch"], c["frames"], c["k"])
    peak = run.counter("h100").BF16_FLOPS
    return 100.0 * c["steps"] * flops / (c["window_s"] * peak)
