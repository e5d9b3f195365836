"""Share of the traced stretch in which no operation ran on the card:
100 * (1 - union of the device operations' intervals / the stretch)."""


def read(run):
    if run.summary is None or "steps" not in run.counters:
        return None
    return 100.0 * (1.0 - run.summary.busy_s / run.summary.window_s)
