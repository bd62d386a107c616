"""The readers of the program's spans (``windtpu_torch.<name>`` ranges) on
hand-made traces: host time per unit, device time by correlation id, and
nothing where there is no trace or no such span (a program without the
spans)."""

import pytest

from portbench import harness as H


def _run(trace, cell="flagship.train"):
    return H.Run(H.load_cell(cell), 2, [1.0, 1.0], H.Spans(), {}, trace)


def _trace():
    # Two steps: a critic span with two launches each, a generator span
    # with one, a readout after each; a kernel launched outside any span.
    host = [("portbench.traced", 0, 2000),
            ("windtpu_torch.step", 0, 800),
            ("windtpu_torch.step.critic", 10, 300),
            ("windtpu_torch.step.generator", 400, 600),
            ("windtpu_torch.loop.readout", 800, 900),
            ("windtpu_torch.step", 1000, 1800),
            ("windtpu_torch.step.critic", 1010, 1300),
            ("windtpu_torch.step.generator", 1400, 1600),
            ("windtpu_torch.loop.readout", 1800, 1840),
            ("windtpu_torch.downscale.template", 1900, 1950),
            ("windtpu_torch.predict.gate", 1950, 1970),
            ("windtpu_torch.predict.readback", 1970, 1990)]
    launches = {1: 20, 2: 30, 3: 450, 4: 1020, 5: 1030, 6: 1450, 7: 700}
    device = [("conv", 100, 200, 1), ("conv", 200, 260, 2),
              ("gemm", 500, 550, 3), ("conv", 1100, 1200, 4),
              ("Memcpy DtoH", 1200, 1220, 5), ("gemm", 1500, 1530, 6),
              ("adam", 700, 710, 7)]
    return H.TraceData(device, host, launches, 0, 2000, 2e-6, 2)


def read(name, run):
    return H._reader(name, H.BENCH).read(run)


def test_host_time_per_unit():
    run = _run(_trace())
    assert read("readout_ms.train", run) == pytest.approx((100 + 40) / 2e6)
    assert read("template_ms.downscale", run) == pytest.approx(50 / 2e6)
    assert read("host_gate_ms.downscale", run) == pytest.approx(20 / 2e6)
    assert read("readback_ms.downscale", run) == pytest.approx(20 / 2e6)


def test_device_time_by_correlation_id():
    run = _run(_trace())
    # Launched inside the critic spans: 1, 2, 4 and the copy 5, wherever
    # they ran on the device.
    assert read("critic_ms.train", run) == pytest.approx(
        (100 + 60 + 100 + 20) / 2e6)
    assert read("generator_ms.train_main", run) == pytest.approx(
        (50 + 30) / 2e6)


def _graph_events(replayed):
    """A profiler's events for one step whose critic span replays a CUDA
    graph: the graph's launch inside ``critic.replay`` and its kernels,
    which carry the launch's correlation id, then an eager generator
    kernel.  ``replayed`` names the launch call."""
    from types import SimpleNamespace as NS

    def ev(name, start, dur, corr=0, device="CPU"):
        return NS(name=lambda: name, start_ns=lambda: start,
                  duration_ns=lambda: dur, correlation_id=lambda: corr,
                  device_type=lambda: NS(name=device),
                  is_user_annotation=lambda: name.startswith(
                      ("portbench.", "windtpu_torch.")))
    return [ev("portbench.traced", 0, 1000),
            ev("windtpu_torch.step", 0, 900),
            ev("windtpu_torch.step.critic", 10, 100),
            ev("windtpu_torch.critic.replay", 10, 100),
            ev(replayed, 12, 10, corr=9),
            ev("windtpu_torch.step.generator", 600, 200),
            ev("cudaLaunchKernel", 610, 5, corr=10),
            ev("conv", 30, 200, 9, "CUDA"), ev("adam", 240, 60, 9, "CUDA"),
            ev("gemm", 620, 100, 10, "CUDA")]


@pytest.mark.parametrize("launch", ["cudaGraphLaunch",
                                    "cudaGraphLaunch_v10000",
                                    "cuGraphLaunch"])
def test_a_replayed_graph_counts_in_the_span_that_launched_it(launch):
    from types import SimpleNamespace as NS

    prof = NS(profiler=NS(kineto_results=NS(
        events=lambda: _graph_events(launch))))
    tr = H.trace_data(prof, 1e-6, 1)
    run = _run(tr)
    # Both of the graph's kernels ran after the critic span closed.
    assert read("critic_ms.train", run) == pytest.approx(260 / 1e6)
    assert read("generator_ms.train", run) == pytest.approx(100 / 1e6)
    # The launch is no host range: the gap it spans is the step's.
    gaps = dict(H.idle_gaps(tr))
    assert not any("GraphLaunch" in k for k in gaps), gaps
    assert set(gaps) <= {"windtpu_torch.step", "windtpu_torch.step.critic",
                         "windtpu_torch.critic.replay",
                         "windtpu_torch.step.generator", "host"}, gaps


@pytest.mark.parametrize("name", [
    "template_ms.downscale", "readback_ms.downscale", "host_gate_ms.downscale",
    "critic_ms.train", "generator_ms.train", "readout_ms.train_main"])
def test_nothing_without_a_trace_or_the_span(name):
    assert read(name, _run(None)) is None
    bare = _trace()
    bare.host = [h for h in bare.host
                 if not h[0].startswith("windtpu_torch.")]
    assert read(name, _run(bare)) is None
