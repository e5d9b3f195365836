"""Host milliseconds between one step's return and the next step's call,
averaged over the window's steps in which the loop neither fetched its
metrics nor ran a stats pass: the training input route alone (loader,
chunk starts, slicing, frames, labels, the step's generator), with any
wait that the route's own copies make."""


def read(run):
    gaps = run.counters.get("input_s")
    if not gaps:
        return None
    return 1e3 * sum(gaps) / len(gaps)
