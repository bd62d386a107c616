"""Host time per traced day in the program's ``predict.readback`` span:
the gated canvas copied to the host (``pred.cpu()`` in ``api.predict``),
the wait for the device gate's last kernels included."""

from portbench.metrics._program_spans import host_ms


def read(run):
    return host_ms(run, "predict.readback")
