"""Model FLOPs of the window's segments (the configuration's counter) over
the window's wall time and the card's dense bf16 peak, in percent."""


def read(run):
    if "segments" not in run.counters:
        return None
    flops = run.counter(run.cell.config["model"]).segment_flops(run.conf, run.counters["frames"])
    peak = run.counter("h100").BF16_FLOPS
    return 100.0 * run.counters["segments"] * flops / (run.counters["window_s"] * peak)
