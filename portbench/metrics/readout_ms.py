"""Host time per traced step in the program's ``loop.readout`` span: the
loop reading the step's metrics to the host, which waits there for the
step's last work on the device."""

from portbench.metrics._program_spans import host_ms


def read(run):
    return host_ms(run, "loop.readout")
