"""What every driver shares: finding a cell's files by name, seeds, the
measured window, host spans around calls into the port, the profiler's
trace reduced to plain numbers, and the result line.

A cell is ``workloads/<cell>.json`` (its configuration, traffic, driver,
chips, end-to-end metrics, correctness limits and why) with the
configuration ``configs/<config>.json``; a per-layer metric is an
entry of ``BENCHMARK.json`` read by ``metrics/<kind>.py``; a kind of
window is ``drivers/<driver>.py``.  Adding a cell, configuration or
metric adds files (and the entries of ``BENCHMARK.json``) and edits no
file here.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "windtpu")


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict           # workloads/<name>.json
    config: dict         # configs/<config>.json

    @property
    def driver(self) -> str:
        return self.spec["driver"]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])

    @property
    def end_to_end(self) -> List[str]:
        return ["setup_s"] + list(self.spec["end_to_end"])

    @property
    def traffic(self) -> dict:
        return self.spec["params"]


def load_cell(name: str, bench: Path = BENCH) -> Cell:
    spec = json.loads((bench / "workloads" / f"{name}.json").read_text())
    config = json.loads(
        (bench / "configs" / f"{spec['config']}.json").read_text())
    return Cell(name, spec, config)


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed drawn from ``seed`` and ``tags``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


# -- the measured window ------------------------------------------------------

class Window:
    """A closed loop measured for ``seconds``: the caller runs one unit
    (a day, a step) after another, each ending in a synchronise, and calls
    :meth:`end_unit` after each; :attr:`closed` turns true once the
    window's time has passed, after the unit that crosses it."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t0: Optional[float] = None
        self.ends: List[float] = []

    def begin(self) -> None:
        self.t0 = time.perf_counter()

    def end_unit(self) -> None:
        self.ends.append(time.perf_counter())

    @property
    def closed(self) -> bool:
        return (self.t0 is not None and bool(self.ends)
                and self.ends[-1] - self.t0 >= self.seconds)

    @property
    def units(self) -> int:
        return len(self.ends)

    @property
    def elapsed(self) -> float:
        return self.ends[-1] - self.t0

    def durations(self) -> List[float]:
        edges = [self.t0] + self.ends
        return [b - a for a, b in zip(edges, edges[1:])]


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation."""
    return float(np.percentile(np.asarray(values, np.float64), q))


# -- host spans around calls into the port ------------------------------------

class Spans:
    """Host times of calls into the port, by name, and the K1 calls'
    shapes.  :meth:`wrap` replaces ``owner.attr`` by a timed wrapper that
    also opens a profiler range ``portbench.<name>`` (restored on exit);
    ``sync`` (a callable) is called before and after, so a span of device
    work ends when the work does."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.k1_calls: List[Tuple[Tuple[int, ...], str]] = []
        self.tracing = False

    @contextlib.contextmanager
    def wrap(self, owner, attr: str, name: str,
             sync: Optional[Callable[[], None]] = None):
        from torch.profiler import record_function

        inner = getattr(owner, attr)
        times = self.times.setdefault(name, [])

        def timed(*args, **kwargs):
            if sync:
                sync()
            t0 = time.perf_counter()
            with record_function(f"portbench.{name}"):
                out = inner(*args, **kwargs)
                if sync:
                    sync()
            times.append(time.perf_counter() - t0)
            return out

        setattr(owner, attr, timed)
        try:
            yield
        finally:
            setattr(owner, attr, inner)

    @contextlib.contextmanager
    def k1(self, owner, attr: str = "convlstm_seq"):
        """Record each K1 call's (B, T, H, W, F) and dtype while a trace is
        on, inside a ``portbench.k1`` range."""
        from torch.profiler import record_function

        inner = getattr(owner, attr)

        def recorded(zx, rk, **kwargs):
            if not self.tracing:
                return inner(zx, rk, **kwargs)
            b, t, h, w, f4 = zx.shape
            self.k1_calls.append(((b, t, h, w, f4 // 4),
                                  str(zx.dtype).replace("torch.", "")))
            with record_function("portbench.k1"):
                return inner(zx, rk, **kwargs)

        setattr(owner, attr, recorded)
        try:
            yield
        finally:
            setattr(owner, attr, inner)

    def mean_ms(self, name: str) -> Optional[float]:
        times = self.times.get(name)
        return 1e3 * statistics.fmean(times) if times else None


# -- the profiler's trace -----------------------------------------------------

@dataclasses.dataclass
class TraceData:
    """A traced window as plain tuples, times in ns on the profiler's clock:
    ``device`` (name, start, end, correlation) of every device operation,
    ``host`` (name, start, end) of host ranges and operators, ``launches``
    correlation -> host start of each launch call, and the window."""
    device: List[Tuple[str, int, int, int]]
    host: List[Tuple[str, int, int]]
    launches: Dict[int, int]
    start: int
    end: int
    window_s: float
    units: int


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag else event.name().startswith("portbench.")


def _is_launch(name: str) -> bool:
    return name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                            "cudaMemset", "cuMemcpy", "cuMemset"))


def trace_data(prof, window_s: float, units: int) -> TraceData:
    """Reduce a finished ``torch.profiler.profile`` to :class:`TraceData`;
    the window is the ``portbench.traced`` range."""
    device, host, launches = [], [], {}
    start = end = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = _ns(e, "start")
        t1 = t0 + _ns(e, "duration")
        if e.device_type().name == "CUDA":
            # The device timeline also carries the host ranges' shadows.
            if not _annotation(e):
                device.append((name, t0, t1, int(e.correlation_id())))
            continue
        if _is_launch(name):
            launches[int(e.correlation_id())] = t0
            continue
        if name == "portbench.traced":
            start, end = t0, t1
        host.append((name, t0, t1))
    if start is None:
        start = min((d[1] for d in device), default=0)
        end = max((d[2] for d in device), default=0)
    return TraceData(device, host, launches, start, end, window_s, units)


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(tr: TraceData) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in _merged(
        (max(s, tr.start), min(e, tr.end)) for _, s, e, _ in tr.device
        if e > tr.start and s < tr.end)) / 1e9


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def device_ops(tr: TraceData, top: int = 10):
    total: Dict[str, float] = {}
    for name, s, e, _ in tr.device:
        key = name[:160]
        total[key] = total.get(key, 0.0) + (e - s) / 1e9
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:top]


def idle_gaps(tr: TraceData, top: int = 10):
    """Idle time of the device, summed by what the host was doing at each
    gap's middle: the innermost host range or operator open then."""
    busy = _merged((max(s, tr.start), min(e, tr.end))
                   for _, s, e, _ in tr.device if e > tr.start and s < tr.end)
    edges = [tr.start] + [x for iv in busy for x in iv] + [tr.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted((h for h in tr.host if h[0] != "portbench.traced"),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    total: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = "host"
        # Ranges nest, so the innermost one open at ``mid`` is the latest
        # to have started among those still open.
        i = bisect.bisect_right(starts, mid) - 1
        for name, s, e in host[max(0, i - 4000):i + 1][::-1]:
            if e > mid:
                label = name
                break
        total[label[:160]] = total.get(label[:160], 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:top]


def kernels_in(tr: TraceData, range_name: str) -> Tuple[float, int]:
    """(seconds, count) of the device operations launched inside the host
    ranges called ``range_name``."""
    ranges = sorted((s, e) for name, s, e in tr.host if name == range_name)
    if not ranges:
        return 0.0, 0
    starts = [r[0] for r in ranges]
    secs, n = 0.0, 0
    for _, s, e, corr in tr.device:
        at = tr.launches.get(corr)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and ranges[i][0] <= at <= ranges[i][1]:
            secs += (e - s) / 1e9
            n += 1
    return secs, n


# -- what a run hands the metric readers --------------------------------------

@dataclasses.dataclass
class Run:
    """One run's readings: the cell, the window's unit times, the host
    spans, the program's counters per unit, and the trace (trace runs)."""
    cell: Cell
    units: int
    unit_s: List[float]
    spans: Spans
    counters: Dict[str, float]
    trace: Optional[TraceData] = None
    traced_unit_s: List[float] = dataclasses.field(default_factory=list)
    busy_s: Optional[float] = None      # averaged over the chips used


def _reader(name: str, bench: Path):
    """The reader of metric ``name``, that of its kind:
    ``metrics/<kind>.py`` for ``<kind>.<cells>``."""
    path = bench / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(bench: Path = BENCH) -> dict:
    return json.loads((bench.parent / "BENCHMARK.json").read_text())


def per_layer(run: Run, bench: Path = BENCH) -> Dict[str, dict]:
    """The per-layer metrics of ``BENCHMARK.json`` that this cell reports
    (those that list it, or that list no cells and move one of its
    end-to-end metrics) and whose reader finds something to read."""
    out = {}
    for m in benchmark(bench)["per_layer"]:
        cells = m.get("workloads")
        if (run.cell.name not in cells if cells is not None
                else m["moves"] not in run.cell.end_to_end):
            continue
        value = _reader(m["name"], bench).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def driver_module(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


# -- correctness --------------------------------------------------------------

@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def checks_from(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> List[Check]:
    return [Check(k, float(numbers.get(k, float("nan"))), float(limits[k]))
            for k in limits]


class Tracer:
    """Profiles units ``first`` .. ``first + count - 1`` of a window (all
    of them in a window that closes sooner) when ``enabled``: device and
    host activity inside one ``portbench.traced`` range, started and
    stopped after a synchronise."""

    def __init__(self, enabled: bool, first: int, count: int, spans: Spans,
                 sync: Callable[[], None]):
        self.enabled, self.first, self.count = enabled, first, count
        self.spans, self.sync = spans, sync
        self.prof = self.range = None
        self.data: Optional[TraceData] = None
        self.unit_s: List[float] = []
        self._t0 = self._u0 = 0.0
        self._n = 0

    def before_unit(self, i: int) -> None:
        if not self.enabled or i != self.first or self.data is not None:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.range = record_function("portbench.traced")
        self.range.__enter__()
        self.spans.tracing = True
        self._t0 = self._u0 = time.perf_counter()

    def after_unit(self, i: int) -> None:
        if self.prof is None:
            return
        now = time.perf_counter()
        self.unit_s.append(now - self._u0)
        self._u0 = now
        self._n += 1
        if self._n >= self.count:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        self.sync()
        window_s = time.perf_counter() - self._t0
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.spans.tracing = False
        self.data = trace_data(self.prof, window_s, self._n)
        self.prof = self.range = None


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the readings for the metric readers, the
    end-to-end values (besides set-up), the work attempted and failed, the
    peak memory of the fullest card, and the checks of ``correct``."""
    run: Run
    end_to_end: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    memory_peak: int
    checks: List[Check]
