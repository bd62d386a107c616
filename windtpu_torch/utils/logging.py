"""Observability (counterpart of ``windtpu/utils/logging.py``):

* :class:`MetricsLogger` — an append-only JSONL of per-step scalar
  metrics, one object per line (step, wall time, metrics), cheap enough to
  leave on;
* :func:`profile_region` — a ``torch.profiler`` trace around a code
  region, written as a Chrome trace (``chrome://tracing``,
  ui.perfetto.dev);
* :func:`enable_nan_checks` — autograd's anomaly detection, which names
  the forward op whose backward produced a NaN.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


class MetricsLogger:
    """Append per-step metric dicts to a JSONL file."""

    def __init__(self, path, flush_every: int = 20):
        self.path = os.fspath(path)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._fh = open(self.path, "a")
        self._since_flush = 0
        self.flush_every = flush_every
        self._t0 = time.time()

    def __call__(self, step: int, metrics: dict):
        record = {"step": int(step),
                  "wall_time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._fh.write(json.dumps(record) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self._fh.flush()
            self._since_flush = 0

    def close(self):
        self._fh.flush()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def profile_region(log_dir: Optional[str]):
    """``torch.profiler`` trace of the CPU, and of the card where there is
    one, around a code region, written to ``log_dir/trace.json`` on exit
    (a no-op when ``log_dir`` is None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_checks():
    """Development mode: autograd raises at the first backward that
    produces a NaN, naming the forward op it came from."""
    torch.autograd.set_detect_anomaly(True)
