"""Host-side training batch pipeline (counterpart of
``windtpu/data/batch.py``; everything but the device infeed is a copy,
pinned to it by ``tests/test_torch_data.py``).

Re-design of the reference BatchGenerator (data_generator.py:96-290):
one "item" is a calendar day; a batch is ``batch_size`` random
(time, y, x) crops of ``sequence_length x patch^2`` from that day's files,
normalized by a decoder and augmented with random flips / 90-degree
rotations.  Fixed output shapes make every batch the same shape.

* batches are produced by a background thread pool into a bounded queue
  instead of a Keras OrderedEnqueuer multiprocessing pool — with the same
  ordered-delivery contract: per-item PRNG streams plus consumer-side
  reordering make a seeded run's batch sequence independent of worker
  count and scheduling;
* a :class:`SyntheticDayProvider` fabricates deterministic in-memory days so
  the whole training stack is testable with zero external data;
* ``as_device_iterator`` moves batches (or, with a mesh, this rank's rows
  of them) to one device through page-locked memory, building the next
  host batch while the device takes the current one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from windtpu_torch.core.config import DataConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.data.decoders import NaiveDecoder
from windtpu_torch.data.providers import Provider


class SyntheticDayProvider(Provider):
    """Deterministic fake 'day' datasets for tests/benchmarks.

    Each date maps to a seeded random (T, Y, X, C) field with smooth spatial
    structure; ``load`` returns an in-memory dict (the BatchGenerator treats
    providers duck-typed: anything whose ``load`` yields an object
    ``open_day`` can read).
    """

    def __init__(self, dates: Sequence[str], variables: Sequence[str],
                 ny: int = 64, nx: int = 64, nt: int = 24, seed: int = 0):
        self._dates = list(dates)
        self.variables = list(variables)
        self.ny, self.nx, self.nt = ny, nx, nt
        self.seed = seed

    @property
    def available_dates(self):
        return set(self._dates)

    def load(self, date: str):
        rng = np.random.RandomState(self.seed + int(date) % 100003)
        data = {}
        yy, xx = np.meshgrid(np.linspace(0, 4, self.ny),
                             np.linspace(0, 4, self.nx), indexing="ij")
        for i, v in enumerate(self.variables):
            phase = rng.uniform(0, 2 * np.pi)
            base = np.sin(xx * (1 + i * 0.3) + phase) + np.cos(yy * (1.3 + i * 0.2))
            t_mod = rng.standard_normal((self.nt, 1, 1)) * 0.5
            noise = rng.standard_normal((self.nt, self.ny, self.nx)) * 0.1
            data[v] = (base[None] + t_mod + noise).astype(np.float32)
        return data


def _open_day(path_or_data, variables):
    """Return {var: (T, Y, X) ndarray} from a provider load result."""
    if isinstance(path_or_data, dict):
        return {v: path_or_data[v] for v in variables}
    from windtpu_torch.io.dataset import open_dataset

    ds = open_dataset(path_or_data)
    out = {}
    nt = ds.sizes.get("time", 1)
    for v in variables:
        arr = ds[v]
        vals = np.asarray(arr.values, dtype=np.float32)
        if "time" not in arr.dims:  # static topo field: replicate over time
            vals = np.broadcast_to(vals, (nt,) + vals.shape)
        out[v] = vals
    return out


class BatchGenerator:
    """Iterates (input_batch, output_batch) numpy arrays of fixed shape
    (B, T, P, P, C_in) / (B, T, P, P, C_out)."""

    def __init__(
        self,
        input_provider: Provider,
        decoder=None,
        output_provider: Optional[Provider] = None,
        start_date=None,
        end_date=None,
        config: DataConfig = DataConfig(),
        num_workers: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.cfg = config
        self.decoder = decoder if decoder is not None else NaiveDecoder()
        self.input_provider = input_provider
        self.output_provider = output_provider
        dates = set(input_provider.available_dates)
        if output_provider is not None:
            dates &= set(output_provider.available_dates)
        if start_date is not None:
            dates = {d for d in dates if d >= str(start_date)}
        if end_date is not None:
            dates = {d for d in dates if d <= str(end_date)}
        self.dates = sorted(dates)
        if not self.dates:
            raise ValueError("no dates available from providers")
        # None -> the config's value, so DataConfig(num_workers=...) is not
        # silently dead configuration; an explicit argument wins.
        self.num_workers = (config.num_workers if num_workers is None
                            else num_workers)
        self.reset(seed)

    # -- core sampling ---------------------------------------------------------
    def reset(self, seed=None):
        self._seed = seed
        self._prng = np.random.RandomState(seed)
        self._date_index = -1

    def _item_prng(self, index: int) -> "np.random.RandomState":
        """Deterministic per-item stream for the threaded path: the crop and
        augmentation draws for batch #index must not depend on which worker
        produced it or on thread scheduling — a single RandomState shared
        across workers would make seeded runs irreproducible.  Golden-ratio
        stride decorrelates consecutive item seeds."""
        if self._seed is None:
            return np.random.RandomState()
        return np.random.RandomState(
            (int(self._seed) + 0x9E3779B1 * (index + 1)) % (2 ** 32))

    def __len__(self):
        return len(self.dates)

    def _random_crop(self, day: dict, t0: int, y0: int, x0: int,
                     variables, elevation_scale=True) -> np.ndarray:
        cfg = self.cfg
        stack = []
        for v in variables:
            arr = day[v][t0:t0 + cfg.sequence_length,
                         y0:y0 + cfg.patch_size,
                         x0:x0 + cfg.patch_size]
            if elevation_scale and v == "elevation":
                arr = arr / 1e3  # reference data_generator.py:212-213
            stack.append(arr)
        return np.stack(stack, axis=-1)  # (T, P, P, C)

    def _augment(self, x: np.ndarray, y: Optional[np.ndarray], prng=None):
        """Random flips + k*90-degree rotation on the two spatial axes
        (reference data_generator.py:271-290; here axes (1, 2) of
        (T, H, W, C))."""
        prng = self._prng if prng is None else prng
        if prng.randint(2):
            x = np.flip(x, axis=1)
            y = np.flip(y, axis=1) if y is not None else None
        if prng.randint(2):
            x = np.flip(x, axis=2)
            y = np.flip(y, axis=2) if y is not None else None
        k = prng.randint(4)
        if k:
            x = np.rot90(x, k=k, axes=(1, 2))
            y = np.rot90(y, k=k, axes=(1, 2)) if y is not None else None
        return x, y

    def generate(self, date: str, prng=None):
        prng = self._prng if prng is None else prng
        cfg = self.cfg
        with self.input_provider.provide(date) as in_loaded:
            day_x = _open_day(in_loaded, cfg.input_variables)
            day_y = None
            if self.output_provider is not None:
                with self.output_provider.provide(date) as out_loaded:
                    day_y = _open_day(out_loaded, cfg.output_variables)
        some = next(iter(day_x.values()))
        nt, ny, nx = some.shape
        if nt < cfg.sequence_length or ny < cfg.patch_size or nx < cfg.patch_size:
            raise ValueError(
                f"day {date}: shape (nt={nt}, ny={ny}, nx={nx}) too small "
                f"for sequence_length={cfg.sequence_length}, "
                f"patch_size={cfg.patch_size}")
        xs, ys = [], []
        for _ in range(cfg.batch_size):
            t0 = prng.randint(0, nt + 1 - cfg.sequence_length)
            y0 = prng.randint(0, ny + 1 - cfg.patch_size)
            x0 = prng.randint(0, nx + 1 - cfg.patch_size)
            x = self._random_crop(day_x, t0, y0, x0, cfg.input_variables)
            x = self.decoder(x)
            y = (self._random_crop(day_y, t0, y0, x0, cfg.output_variables,
                                   elevation_scale=False)
                 if day_y is not None else None)
            if cfg.transform:
                x, y = self._augment(x, y, prng)
            xs.append(x)
            ys.append(y)
        xb = np.stack(xs, axis=0).astype(np.float32)
        if day_y is None:
            return xb
        return xb, np.stack(ys, axis=0).astype(np.float32)

    def __iter__(self) -> Iterator:
        if self.num_workers <= 1:
            while True:
                self._date_index = (self._date_index + 1) % len(self.dates)
                yield self.generate(self.dates[self._date_index])
        else:
            yield from self._threaded_iter()

    def _threaded_iter(self, max_queue: int = 8):
        q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        stop = threading.Event()
        lock = threading.Lock()
        counter = {"i": -1}

        def put(item) -> bool:
            """Enqueue, polling the stop event: a worker blocked forever
            in q.put on a full queue after the consumer went away would
            leak the thread plus its queued batches for every discarded
            iterator (the loop-break case, not just exhaustion)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                with lock:
                    counter["i"] += 1
                    index = counter["i"]
                date = self.dates[index % len(self.dates)]
                try:
                    # Per-item PRNG stream: draws depend on the item index,
                    # never on which worker ran it or on scheduling.
                    item = self.generate(date, prng=self._item_prng(index))
                except Exception as e:  # surface errors to the consumer
                    put((index, e))
                    return
                if not put((index, item)):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            # Ordered delivery (reference OrderedEnqueuer semantics,
            # data_generator.py:132-138): workers race, the consumer
            # reorders.  Out-of-order buffering is bounded by
            # num_workers + queue size.
            pending = {}
            next_index = 0
            while True:
                while next_index not in pending:
                    index, item = q.get()
                    pending[index] = item
                item = pending.pop(next_index)
                next_index += 1
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    # -- device infeed -------------------------------------------------------
    def as_device_iterator(self, device=None, mesh=None,
                           axis: str = "data"):
        """Yield (input, output) batches as tensors on ``device`` (``None``
        means the card).  On the card each batch goes through page-locked
        memory with ``non_blocking=True``, and the next host batch is
        built while the device takes the current one.

        With ``mesh`` (a :class:`windtpu_torch.core.mesh.Mesh`) every rank
        builds the identical global batch (the pipeline is seeded and
        deterministic) and moves only its contiguous rows: rank ``i`` of
        the ``axis`` group takes rows ``[i * B/n, (i + 1) * B/n)``."""
        from windtpu_torch.core.mesh import shard_batch

        device = resolve_device(device)
        cuda = device.type == "cuda"

        def put(item):
            arrays = item if isinstance(item, tuple) else (item,)
            out = []
            for a in arrays:
                if mesh is not None:
                    a = shard_batch(mesh, a, axis)
                t = torch.from_numpy(np.ascontiguousarray(a))
                if cuda:
                    t = t.pin_memory()
                out.append(t.to(device, non_blocking=cuda))
            return tuple(out) if isinstance(item, tuple) else out[0]

        it = iter(self)
        nxt = put(next(it))
        while True:
            cur = nxt
            try:
                nxt = put(next(it))
            except StopIteration:
                yield cur
                return
            yield cur
