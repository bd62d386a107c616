"""Step-metric logging (counterpart of ``windtpu/utils/logging.py``'s
``MetricsLogger``): an append-only JSONL of per-step scalar metrics, one
object per line (step, wall time, metrics), cheap enough to leave on."""

from __future__ import annotations

import json
import os
import time


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
