"""The share of the traced window in which no operation ran on the
device, averaged over the cards used."""


def read(run):
    if run.trace is None or run.busy_s is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace.window_s)
