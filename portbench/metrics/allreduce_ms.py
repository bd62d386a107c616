"""Device time of the NCCL kernels per step on rank 0 over the traced
steps, waits for the other ranks included."""


def read(run):
    tr = run.trace
    if tr is None or not tr.units:
        return None
    nccl = [e - s for name, s, e, _ in tr.device if "nccl" in name.lower()]
    if not nccl:
        return None
    return sum(nccl) / 1e6 / tr.units
