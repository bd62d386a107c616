"""K1's share of its roofline over the traced units' calls (forward only:
the replayed backward is not K1): the least time of the calls' shapes
(``costs/kernels.py``) over the device time of every kernel launched
inside them."""

from portbench import harness as H
from portbench.costs.kernels import k1_bound_s


def read(run):
    tr = run.trace
    if tr is None or not run.spans.k1_calls:
        return None
    secs, _ = H.kernels_in(tr, "portbench.k1")
    if secs <= 0:
        return None
    bound = sum(k1_bound_s(*shape, dtype)
                for shape, dtype in run.spans.k1_calls)
    return 100.0 * bound / secs
