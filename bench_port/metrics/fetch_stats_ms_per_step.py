"""Host milliseconds a window step spends, beyond the input route, in the
training loop's metric fetches (every ``--logEvery`` steps: a wait for the
card's queued work) and stats passes: the time between steps that holds
one, less the input route's mean, summed and spread over the window's
steps."""


def read(run):
    c = run.counters
    route, loop = c.get("input_s"), c.get("loop_s")
    if not route or not loop:
        return None
    mean = sum(route) / len(route)
    return 1e3 * (sum(loop) - len(loop) * mean) / c["steps"]
