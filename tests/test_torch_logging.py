"""The port's observability helpers (windtpu_torch/utils/logging.py), the
counterparts of windtpu/utils/logging.py: ``profile_region`` writes a
``torch.profiler`` Chrome trace where ``jax.profiler`` writes its own, and
nothing without a directory; ``enable_nan_checks`` turns on autograd's
anomaly detection where the JAX package turns on ``jax_debug_nans``."""

import json

import pytest
import torch

from windtpu.utils import logging as jlogging
from windtpu_torch import utils as tutils
from windtpu_torch.utils import logging as tlogging


def test_profile_region_is_exported_as_in_the_jax_package():
    assert tutils.profile_region is tlogging.profile_region
    assert callable(jlogging.profile_region)


def test_profile_region_writes_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with tlogging.profile_region(str(tmp_path / "prof")):
        y = x @ x
    assert y.shape == (64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


@pytest.mark.parametrize("log_dir", [None, ""])
def test_profile_region_without_a_directory_writes_nothing(
        tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.profiler, "profile", None)  # never started
    for mod in (tlogging, jlogging):
        with mod.profile_region(log_dir):
            torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_enable_nan_checks_names_the_op_whose_backward_made_a_nan():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    try:
        tlogging.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        y = torch.sqrt(x).sum()
        with pytest.raises(RuntimeError, match="SqrtBackward"), \
                pytest.warns(UserWarning, match="anomaly"):
            y.backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
