"""Device resolution for the port's entry points.

``device=None`` means the card.  There is no silent CPU fallback: without
a CUDA device an entry point raises, and the CPU runs only when the caller
asks for it (as the tests do with ``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when the resolved device is CUDA and no
    card is present.  A CUDA device comes back with its index filled in,
    so resolved devices compare equal."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
