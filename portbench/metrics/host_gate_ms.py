"""Host time per traced day in the program's ``predict.gate`` span: the
texture gate's target energies (``gate.features``, ``gate.mlp``), on the
card from the one device copy of the field on the monolithic path, on
the host when streamed (``api.predict``)."""

from portbench.metrics._program_spans import host_ms


def read(run):
    return host_ms(run, "predict.gate")
