"""Host time per traced day in the program's ``downscale.template`` span:
the high-resolution template and the regrid of ERA5 and the DEM onto it
(``api.downscale``)."""

from portbench.metrics._program_spans import host_ms


def read(run):
    return host_ms(run, "downscale.template")
