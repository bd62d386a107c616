"""Device time per traced step of the operations launched inside the
program's ``step.generator`` span: the generator update (forward with the
critic's score, backward, Adam)."""

from portbench.metrics._program_spans import device_ms


def read(run):
    return device_ms(run, "step.generator")
