"""Device time per traced step of the operations launched inside the
program's ``step.critic`` spans: the n_critic critic updates (the fake's
forward, the gradient penalty, scoring, the backward with the penalty's
double backward, Adam).  On one card the updates replay as one CUDA
graph (``critic.replay``); its kernels count through the graph's launch
(``harness._is_launch``)."""

from portbench.metrics._program_spans import device_ms


def read(run):
    return device_ms(run, "step.critic")
