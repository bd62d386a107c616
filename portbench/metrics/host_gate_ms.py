"""Host time per call of the texture gate
(``models.texture_gate.predict_log_energy_np``), over the traced days."""


def read(run):
    return run.spans.mean_ms("host_gate")
