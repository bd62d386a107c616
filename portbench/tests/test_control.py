"""The control of ``correct`` (the reference in the next lower precision
in the program's place) comes out not correct under each cell's limits:
at a tiny size on the CPU here, and at the cell's own size on the card
(``-m gpu``; it skips without one)."""

import pytest
import torch

from portbench import control
from portbench import harness as H
from portbench.tests import tiny

CELLS = ["flagship.downscale", "flagship.train", "train_main.synthetic"]


def _fails(cell, seed, device):
    out = control.numbers(cell, seed, device, control.lower(cell))
    checks = H.checks_from(out, cell.spec["limits"])
    return [c.name for c in checks if not c.ok], out


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_a_tiny_size(name):
    failed, out = _fails(tiny.cell(name), 2 ** 35 + 3, torch.device("cpu"))
    assert failed, out


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = H.load_cell(name)
    for seed in (4000000001, 4000000002, 4000000003):
        failed, out = _fails(cell, seed, torch.device("cuda", 0))
        assert failed, (seed, out)
