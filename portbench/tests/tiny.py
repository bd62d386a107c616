"""Each cell of the benchmark at a size a CPU test holds: the same files
with the widths, the domain and the batch cut, so that a test drives the
same drivers and comparisons as a run."""

from __future__ import annotations

import copy

from portbench import harness as H


def cell(name: str) -> H.Cell:
    """The cell ``name`` cut to a tiny size."""
    c = H.load_cell(name)
    cfg = copy.deepcopy(c.config)
    spec = copy.deepcopy(c.spec)
    cfg["model"].update(image_size=24, sequence_length=2,
                        generator_features=16, discriminator_features=4)
    cfg["train"]["batch_size"] = 4
    if "inference" in cfg:
        cfg["inference"]["domain"] = {"era5_lat": 4, "era5_lon": 3,
                                      "hours": 4}
        cfg["weights"] = "seed"
        spec["params"].update(days=3, sample_every=2)
    if "data" in cfg:
        cfg["data"].update(sequence_length=2, patch_size=24, batch_size=4)
        spec["params"].update(day_px=32, day_hours=6)
    return H.Cell(f"tiny.{name}", spec, cfg)


def f32(c: H.Cell) -> H.Cell:
    """The cell with float32 compute, where program and reference agree to
    rounding on the CPU."""
    c = copy.deepcopy(c)
    c.config["model"]["compute_dtype"] = "float32"
    return c
