"""The port's observability helpers (windtpu_torch/utils/logging.py), the
counterparts of windtpu/utils/logging.py: ``profile_region`` writes a
``torch.profiler`` Chrome trace where ``jax.profiler`` writes its own, and
nothing without a directory; ``enable_nan_checks`` turns on autograd's
anomaly detection where the JAX package turns on ``jax_debug_nans``."""

import collections
import json

import numpy as np
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


# -- spans ---------------------------------------------------------------------

TINY = dict(image_size=16, sequence_length=3, generator_features=16)


def _span_counts(prof):
    """{name: count} of the ``windtpu_torch.*`` user annotations on the
    host side of a finished profile."""
    return dict(collections.Counter(
        e.name().removeprefix("windtpu_torch.")
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("windtpu_torch.") and e.is_user_annotation()
        and e.device_type().name == "CPU"))


def test_span_outside_a_profiler_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(tlogging, "record_function", refuse)
    with tlogging.span("step") as a, tlogging.span("step.critic") as b:
        torch.ones(3).sum()
    assert a is b is None
    assert tlogging.span("x") is tlogging.span("y")


def test_span_inside_a_profiler_is_a_user_annotation():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tlogging.span("step"):
                with tlogging.span("step.critic"):
                    torch.ones(3).sum()
    assert _span_counts(prof) == {"step": 3, "step.critic": 3}
    assert tutils.span is tlogging.span


def _tiny_day():
    from windtpu_torch.io.dataset import DataArray, Dataset

    rng = np.random.RandomState(1)
    nt, nlat, nlon = 7, 3, 4
    dims = ("time", "latitude", "longitude")
    era5 = Dataset(
        {"u10": DataArray(dims, (3 + rng.standard_normal(
            (nt, nlat, nlon))).astype(np.float32)),
         "v10": DataArray(dims, rng.standard_normal(
             (nt, nlat, nlon)).astype(np.float32))},
        {"time": DataArray(("time",), np.arange(
            "2016-04-01T00", "2016-04-01T07", dtype="datetime64[h]")),
         "latitude": DataArray(("latitude",), np.linspace(46, 45, nlat)),
         "longitude": DataArray(("longitude",), np.linspace(6, 7, nlon))})
    x, y = np.linspace(5.9, 7.1, 60), np.linspace(46.1, 44.9, 50)
    dem = Dataset(
        {"band_data": DataArray(("band", "y", "x"), (1500 + 700 * (
            rng.standard_normal((1, 50, 60)))).astype(np.float32))},
        {"band": DataArray(("band",), np.array([1])),
         "y": DataArray(("y",), y), "x": DataArray(("x",), x)})
    return era5, dem


def test_a_traced_downscale_names_its_phases(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from windtpu_torch import api
    from windtpu_torch.core.config import GANConfig, ModelConfig
    from windtpu_torch.infer import engine
    from windtpu_torch.models.texture_gate import load_gate_npz
    from windtpu_torch.network import WindDownscalingGAN

    torch.manual_seed(0)
    net = WindDownscalingGAN(GANConfig(model=ModelConfig(**TINY)),
                             device="cpu")
    net.texture_gate = load_gate_npz(api.BUNDLED_GATE)
    era5, dem = _tiny_day()
    groups = []
    inner = engine._group_apply
    monkeypatch.setattr(engine, "_group_apply",
                        lambda *a: groups.append(1) or inner(*a))

    def day():
        out = api.downscale(era5, dem, network=net, device="cpu", seed=3)
        return np.stack([out["u10"].values, out["v10"].values])

    plain = day()
    n_groups = len(groups)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = day()
    assert n_groups >= 2
    np.testing.assert_array_equal(traced, plain)   # bitwise, NaNs too
    counts = _span_counts(prof)
    assert counts == {
        "downscale": 1, "downscale.template": 1, "predict.upload": 1,
        "predict.gate": 1, "gate.features": 1, "gate.mlp": 1,
        "predict.engine": 1,
        "engine.plan": 1, "engine.stats": 1, "engine.group": n_groups,
        "engine.overlap_mean": 1, "predict.gate_apply": 1,
        "predict.readback": 1, "predict.assemble": 1,
        # The generator's one ConvLSTM, once per group.
        "ops.k1": n_groups}


def test_a_traced_train_run_names_its_phases(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from windtpu_torch.core.config import GANConfig, ModelConfig, TrainConfig
    from windtpu_torch.train.loop import train
    from windtpu_torch.train.state import create_train_state

    cfg = GANConfig(
        model=ModelConfig(image_size=24, sequence_length=2,
                          generator_features=16, discriminator_features=4),
        train=TrainConfig(batch_size=2, n_critic=2))
    g = torch.Generator().manual_seed(0)
    batches = [(torch.randn((2, 2, 24, 24, 3), generator=g),
                torch.randn((2, 2, 24, 24, 2), generator=g))
               for _ in range(2)]

    def run(checkpoint_dir):
        torch.manual_seed(1)
        c = GANConfig(model=cfg.model, train=cfg.train,
                      checkpoint_dir=checkpoint_dir)
        state = create_train_state(c, device="cpu")
        state, history = train(c, batches, 2, state=state, log_every=1,
                               log_fn=lambda *a: None, device="cpu")
        return history, [p.detach().clone() for p in
                         state.generator.parameters()]

    plain = run(str(tmp_path / "a"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run(str(tmp_path / "b"))
    for (_, m0), (_, m1) in zip(plain[0], traced[0]):
        m0, m1 = dict(m0), dict(m1)
        m0.pop("steps_per_sec"), m1.pop("steps_per_sec")
        assert m0 == m1
    for a, b in zip(plain[1], traced[1]):
        assert torch.equal(a, b)
    counts = _span_counts(prof)
    steps, n_critic = 2, 2
    assert counts == {
        "step": steps, "step.draws": steps,
        "step.critic": steps * n_critic,
        **{f"critic.{k}": steps * n_critic
           for k in ("fake", "penalty", "score", "backward", "adam")},
        "step.generator": steps, "generator.forward": steps,
        "generator.backward": steps, "generator.adam": steps,
        "step.eval": steps, "loop.readout": steps, "loop.checkpoint": 1,
        # The generator's ConvLSTM in each critic update's fake, the
        # generator update and the metric recompute.
        "ops.k1": steps * (n_critic + 2)}
