"""Device kernels (no copies or sets) per traced unit."""

from portbench import harness as H


def read(run):
    tr = run.trace
    if tr is None or not tr.units:
        return None
    return sum(1 for d in tr.device if H.is_kernel(d[0])) / tr.units
