"""windtpu_torch — the PyTorch/CUDA port of windtpu.

A second package beside the JAX one, for one NVIDIA H100: the same module
layout and names, NHWC ``(B, T, H, W, C)`` fields at its public functions,
and the JAX package's Pallas kernels rewritten by hand for Hopper
(``ops/csrc``).  It imports nothing of ``windtpu`` or JAX.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

_API_EXPORTS = (
    "build_high_res_template_from_era5",
    "downscale",
    "get_network",
    "predict",
    "process_era5",
    "process_topo",
)


def __getattr__(name):
    # Lazy, so that `import windtpu_torch.io` stays cheap.
    if name in _API_EXPORTS:
        import windtpu_torch.api as _api

        return getattr(_api, name)
    raise AttributeError(f"module 'windtpu_torch' has no attribute {name!r}")
