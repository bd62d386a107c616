"""Faults planted in the port in memory, for the checks that ``correct``
catches them: each replaces one function of the port for the duration of
a ``with`` block.

- ``answer``: one patch of each downscale group off by 2 m/s;
- ``train_answer``: the generator's output off by 2 m/s;
- ``state``: Adam's update skipped (the step returns its state
  unchanged);
- ``half_batch``: the step sees the first half of its batch only, its
  means taken over those rows;
- ``exchange``: every all-reduce of the port skipped (the ranks'
  exchange left out).
"""

import contextlib
from typing import Optional

# The fault planted now, if any: a multi-card run plants it in its other
# ranks' processes too (``drivers/train_ranks.py``).
ACTIVE: Optional[str] = None


@contextlib.contextmanager
def planted(fault: str):
    """Break the port in memory for the duration."""
    global ACTIVE
    import windtpu_torch.core.mesh as mesh
    import windtpu_torch.infer.engine as engine
    import windtpu_torch.models.generator as generator
    import windtpu_torch.train.optim as optim
    import windtpu_torch.train.wgan_gp as wgan_gp

    if fault == "answer":
        owner, attr = engine, "_group_apply"
        inner = engine._group_apply

        def broken(*args, **kwargs):
            out = inner(*args, **kwargs)
            out[:, 0, ..., 0] += 2.0
            return out
    elif fault == "train_answer":
        owner, attr = generator.Generator, "forward"
        inner = generator.Generator.forward

        def broken(self, *args, **kwargs):
            return inner(self, *args, **kwargs) + 2.0
    elif fault == "state":
        owner, attr = optim.Adam, "step"
        inner = optim.Adam.step

        def broken(self, grads):
            self.count += 1
    elif fault == "half_batch":
        owner, attr = wgan_gp, "_batch"
        inner = wgan_gp._batch

        def broken(*args):
            low, high = inner(*args)
            return low[:low.shape[0] // 2], high[:high.shape[0] // 2]
    elif fault == "exchange":
        owner, attr = mesh, "all_reduce"
        inner = mesh.all_reduce

        def broken(x, group):
            return x
        broken.bytes = 0
    else:
        raise ValueError(fault)
    setattr(owner, attr, broken)
    ACTIVE = fault
    try:
        yield
    finally:
        ACTIVE = None
        setattr(owner, attr, inner)
