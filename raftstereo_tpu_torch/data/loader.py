"""Multiprocess prefetching data loader: a copy of the JAX package's
``data/loader.py`` without its fault-injection hooks.

Shuffling seeded per epoch, fixed-size batches with drop_last, N worker
processes with per-worker seeding, and bounded prefetch.  Batches are
stacked NHWC numpy arrays; ``prefetch_to_device`` copies the next batch
to the device (``non_blocking`` from pinned memory) while the current one
is used.

Self-healing: per-sample retry with exponential backoff, a bounded
quarantine that replaces persistently-bad indices with deterministically
resampled ones (counted in :attr:`DataLoader.stats`, never silently), and
a timeout on batch results with a worker-pool recycle so one hung decoder
cannot stall training forever.

The loader is multi-process, not multi-threaded: ``quarantined``,
``stats`` and ``epoch`` are mutated only by the consumer thread iterating
the loader; the one cross-process value, ``_worker_counter``, is an
``mp.Value`` updated under its own lock in ``_init_worker``.
"""

from __future__ import annotations

import collections
import logging
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

logger = logging.getLogger(__name__)

_WORKER_DATASET = None


def _init_worker(dataset, seed, counter):
    global _WORKER_DATASET
    with counter.get_lock():
        worker_id = counter.value
        counter.value += 1
    dataset.reseed(seed + worker_id)
    _WORKER_DATASET = dataset


def _load_one(dataset, i):
    meta, img1, img2, flow, valid = dataset[i]
    return (img1, img2, flow, valid)


def _load_indices(indices, retries=2, backoff=0.05):
    """Worker task: load each index with per-sample retry.

    Returns ``(ok, bad, n_retries)``: ``ok`` is ``[(pos, sample), ...]``,
    ``bad`` is ``[(pos, index, error_string), ...]`` for indices that failed
    every attempt.  Failures are *reported*, not raised — the parent owns
    quarantine/resampling policy and a raise would poison the whole batch.
    """
    ok, bad, n_retries = [], [], 0
    for pos, i in enumerate(indices):
        for attempt in range(retries + 1):
            try:
                ok.append((pos, _load_one(_WORKER_DATASET, i)))
                break
            except Exception as e:  # noqa: BLE001 — any decode error counts
                if attempt >= retries:
                    bad.append((pos, i, f"{type(e).__name__}: {e}"))
                else:
                    n_retries += 1
                    time.sleep(backoff * (2 ** attempt))
    return ok, bad, n_retries


def default_num_workers() -> int:
    """SLURM-aware default (reference: core/stereo_datasets.py:312)."""
    return max(int(os.environ.get("SLURM_CPUS_PER_TASK", 6)) - 2, 0)


class DataLoader:
    """Iterable over stacked (img1, img2, flow, valid) batches.

    num_workers=0 loads inline (deterministic, used by tests); otherwise a
    process pool decodes and augments ahead of the training step.

    Robustness knobs:

    * ``sample_retries`` / ``retry_backoff``: per-sample retry with
      exponential backoff inside the load task (transient I/O).
    * ``quarantine_limit``: indices that fail every retry are quarantined
      (at most this many — beyond it the dataset is considered broken and
      the loader raises) and replaced with a deterministic resample; both
      are counted in :attr:`stats`.
    * ``batch_timeout``: seconds to wait for a worker batch before the pool
      is recycled (terminate + respawn) and in-flight batches resubmitted;
      a batch that times out twice raises.  ``None`` disables.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: Optional[int] = None,
                 seed: int = 0, prefetch_batches: int = 4,
                 sample_retries: int = 2, retry_backoff: float = 0.05,
                 quarantine_limit: int = 64,
                 batch_timeout: Optional[float] = 300.0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = (default_num_workers() if num_workers is None
                            else num_workers)
        self.seed = seed
        self.prefetch_batches = max(prefetch_batches, 1)
        self.epoch = 0
        self.sample_retries = sample_retries
        self.retry_backoff = retry_backoff
        self.quarantine_limit = quarantine_limit
        self.batch_timeout = batch_timeout
        self.quarantined: set = set()
        self.stats = collections.Counter()
        self._worker_counter = None  # created lazily, lives for the loader

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def health_metrics(self):
        """Cumulative robustness counters as float gauges for the metrics
        logger (quarantines must be countable, never silent)."""
        return {"data_" + k: float(self.stats[k]) for k in
                ("samples_retried", "samples_quarantined", "samples_replaced",
                 "load_timeouts", "pool_recycles")}

    # -- quarantine / resampling --------------------------------------------

    def _quarantine(self, index: int, err: str) -> None:
        if index in self.quarantined:
            return
        if len(self.quarantined) >= self.quarantine_limit:
            raise RuntimeError(
                f"quarantine limit reached ({self.quarantine_limit} bad "
                f"samples; latest: index {index}: {err}) — the dataset is "
                "broken beyond what resampling should paper over")
        self.quarantined.add(index)
        self.stats["samples_quarantined"] += 1
        logger.warning("quarantined dataset index %d (%s) — %d/%d slots used",
                       index, err, len(self.quarantined),
                       self.quarantine_limit)

    def _substitute(self, index: int) -> int:
        """Deterministic replacement for a quarantined index (seeded by
        (seed, epoch, index) so reruns resample identically)."""
        n = len(self.dataset)
        if len(self.quarantined) >= n:
            raise RuntimeError(f"all {n} dataset indices quarantined")
        rng = np.random.default_rng((self.seed, self.epoch, index))
        while True:
            j = int(rng.integers(n))
            if j != index and j not in self.quarantined:
                self.stats["samples_replaced"] += 1
                return j

    def _resolve(self, idxs):
        """Replace already-quarantined indices at dispatch time."""
        return [self._substitute(i) if i in self.quarantined else i
                for i in idxs]

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        end = n - n % self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield order[i:i + self.batch_size].tolist()

    @staticmethod
    def _collate(samples) -> Batch:
        img1, img2, flow, valid = (np.stack(x) for x in zip(*samples))
        return img1, img2, flow, valid

    # -- inline path --------------------------------------------------------

    def _load_resilient_inline(self, index: int):
        """Inline load with the same retry/quarantine/resample policy as the
        worker path (minus the pool timeout — nothing to recycle)."""
        i = index
        while True:
            for attempt in range(self.sample_retries + 1):
                try:
                    return _load_one(self.dataset, i)
                except Exception as e:  # noqa: BLE001
                    if attempt >= self.sample_retries:
                        self._quarantine(i, f"{type(e).__name__}: {e}")
                        i = self._substitute(i)
                    else:
                        self.stats["samples_retried"] += 1
                        time.sleep(self.retry_backoff * (2 ** attempt))

    def __iter__(self) -> Iterator[Batch]:
        self.epoch += 1
        if self.num_workers == 0:
            self.dataset.reseed(self.seed + self.epoch)
            for idxs in self._batches():
                yield self._collate([self._load_resilient_inline(i)
                                     for i in self._resolve(idxs)])
            return
        yield from self._iter_pool()

    # -- worker-pool path ---------------------------------------------------

    def _make_pool(self, ctx, counter):
        # Spawn, not fork: the parent may hold CUDA state and threads, and
        # fork()ing a multithreaded process can deadlock the workers.
        return ctx.Pool(self.num_workers, initializer=_init_worker,
                        initargs=(self.dataset, self.seed + 1000 * self.epoch,
                                  counter))

    def _iter_pool(self) -> Iterator[Batch]:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        # One counter for the LIFETIME of the loader (not per epoch, not
        # per pool): recycled pools and later epochs get fresh worker ids,
        # so a fire-once per-worker fault can never re-fire.
        if self._worker_counter is None:
            self._worker_counter = ctx.Value("i", 0)
        counter = self._worker_counter
        pool = self._make_pool(ctx, counter)

        def submit(p, idxs):
            return p.apply_async(_load_indices, (idxs, self.sample_retries,
                                                 self.retry_backoff))

        try:
            # pending entries: [async_result, idxs, timeouts_so_far]
            pending = collections.deque()
            batches = self._batches()
            try:
                for _ in range(self.num_workers * self.prefetch_batches):
                    idxs = self._resolve(next(batches))
                    pending.append([submit(pool, idxs), idxs, 0])
            except StopIteration:
                batches = iter(())
            while pending:
                entry = pending.popleft()
                try:
                    idxs = self._resolve(next(batches))
                    pending.append([submit(pool, idxs), idxs, 0])
                except StopIteration:
                    pass
                try:
                    ok, bad, n_retries = entry[0].get(self.batch_timeout)
                except mp.TimeoutError:
                    self.stats["load_timeouts"] += 1
                    entry[2] += 1
                    if entry[2] > 1:
                        raise RuntimeError(
                            f"batch {entry[1]} timed out twice "
                            f"({self.batch_timeout}s each) across a pool "
                            "recycle — giving up instead of deadlocking")
                    # Recycle: a hung/lost worker never returns its task, so
                    # terminate the whole pool and resubmit every in-flight
                    # batch (order preserved) on a fresh one.
                    logger.warning(
                        "no batch within %.1fs — recycling the %d-worker "
                        "pool and resubmitting %d in-flight batches",
                        self.batch_timeout, self.num_workers,
                        len(pending) + 1)
                    self.stats["pool_recycles"] += 1
                    pool.terminate()
                    pool.join()
                    pool = self._make_pool(ctx, counter)
                    entry[0] = submit(pool, entry[1])
                    for other in pending:
                        other[0] = submit(pool, other[1])
                    pending.appendleft(entry)
                    continue
                self.stats["samples_retried"] += n_retries
                if bad:
                    # Quarantine the persistently-bad indices and re-run the
                    # batch (quarantined indices resolve to substitutes at
                    # dispatch).  Substitutes that also fail get quarantined
                    # on the next pass until the bounded quarantine raises.
                    for _pos, i, err in bad:
                        self._quarantine(i, err)
                    idxs = self._resolve(entry[1])
                    pending.appendleft([submit(pool, idxs), idxs, 0])
                    continue
                yield self._collate([s for _pos, s in sorted(ok)])
        finally:
            pool.terminate()
            pool.join()


def prefetch_to_device(iterator, device, size: int = 2):
    """Move batches to ``device`` ahead of use: each numpy batch is pinned
    and copied with ``non_blocking`` so the copy of the next batch
    overlaps the current step (on the CPU the copy is a plain one)."""
    import itertools

    import torch

    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            out.append(t.to(device, non_blocking=pin))
        return tuple(out)

    queue = collections.deque()
    it = iter(iterator)
    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out
