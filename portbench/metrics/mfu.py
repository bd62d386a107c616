"""The whole unit's model FLOPs (the configuration's ``model_flops`` under
the driver's ``FLOPS_UNIT``, counted once over the plain reference) per
second of the window's untraced units, over the chip's peak in the
configuration's precision times the cards used."""

import statistics

from portbench import harness as H
from portbench.costs import PEAK_FLOPS


def read(run):
    unit = H.driver_module(run.cell.driver).FLOPS_UNIT
    flops = run.cell.config.get("model_flops", {}).get(unit)
    # The traced units run slower under the profiler: leave them out,
    # unless every unit was traced.
    n = len(run.traced_unit_s)
    times = run.unit_s[:1] + run.unit_s[1 + n:] or list(run.unit_s)
    if not flops or not times:
        return None
    peak = PEAK_FLOPS[run.cell.config["peak"]] * run.cell.chips
    return 100.0 * flops / statistics.fmean(times) / peak
