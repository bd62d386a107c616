"""MiB all-reduced per step (the port's ``core.mesh.all_reduce.bytes``)."""


def read(run):
    b = run.counters.get("all_reduce_bytes")
    return b / 2 ** 20 if b else None
