"""What the span readers share: the program's own spans
(``windtpu_torch.<name>`` ranges, ``windtpu_torch.utils.logging.span``) in
a traced run, per traced unit.  A program without such a span (one
before the spans were added) gives None, and the metric is left out."""

from portbench import harness as H

PREFIX = "windtpu_torch."


def _found(run, name):
    tr = run.trace
    if tr is None or not tr.units:
        return None
    return tr if any(h[0] == PREFIX + name for h in tr.host) else None


def host_ms(run, name):
    """Host time inside the spans called ``name``, ms per traced unit."""
    tr = _found(run, name)
    if tr is None:
        return None
    return sum(e - s for n, s, e in tr.host
               if n == PREFIX + name) / 1e6 / tr.units


def device_ms(run, name):
    """Device time of the operations launched inside the spans called
    ``name`` (``harness.kernels_in``: by correlation id, summed over
    operations), ms per traced unit."""
    tr = _found(run, name)
    if tr is None:
        return None
    return 1e3 * H.kernels_in(tr, PREFIX + name)[0] / tr.units
