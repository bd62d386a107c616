"""Host time per call of the engine and its transfers
(``api.downscale_field``), from and to a synchronise, over the traced
days."""


def read(run):
    return run.spans.mean_ms("engine")
