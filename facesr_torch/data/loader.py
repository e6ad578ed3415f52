"""Threaded prefetching data loader (port of `facesr/data/loader.py`).

A thread pool decodes samples (zlib and the native PNG unfilter release
the GIL); a bounded queue keeps ``prefetch_batches`` collated numpy
batches ahead of the train step. Multi-process sharding takes the process
index and count from `torch.distributed` when it is initialised, else
(0, 1).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

__all__ = ["DataLoader", "bounded_prefetch", "host_shard", "host_shard_len"]


def _resolve_process(process_index: Optional[int],
                     process_count: Optional[int]) -> tuple[int, int]:
    if process_count is None or process_index is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    return process_index, process_count


def host_shard(order: np.ndarray, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> np.ndarray:
    """Disjoint equal-length per-host slice of a (shuffled) index order.

    All processes must call with the same `order` (same seed/epoch); each
    gets len(order) // process_count contiguous entries, so step counts
    match. Defaults resolve from `torch.distributed`; with one process this
    is the identity."""
    process_index, process_count = _resolve_process(process_index, process_count)
    if process_count <= 1:
        return order
    per_host = len(order) // process_count
    return order[process_index * per_host:(process_index + 1) * per_host]


def host_shard_len(n: int, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> int:
    """len(host_shard(arange(n))) without materializing the array."""
    process_index, process_count = _resolve_process(process_index, process_count)
    return n if process_count <= 1 else n // process_count

_STOP = object()


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterable over batched dict samples from a map-style dataset.

    Args:
        dataset: object with __len__ and __getitem__ -> dict of np arrays.
        batch_size / shuffle / drop_last: standard semantics (train mode
            shuffles and drops the last partial batch).
        num_workers: decode threads (0 = synchronous).
        prefetch_batches: bound of the ready-batch queue.
        seed: shuffle seed; each epoch reshuffles deterministically.
        process_index / process_count: multi-process sharding: every
            process computes the same seeded shuffle and takes a disjoint equal-length slice, so
            hosts see disjoint data yet run identical step counts (unequal
            counts would hang collectives). None = torch.distributed's rank
            and world size, or (0, 1) when it is not initialised.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 16,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch_batches: int = 4,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def _host_slice(self, order: np.ndarray) -> np.ndarray:
        return host_shard(order, self.process_index, self.process_count)

    def __len__(self) -> int:
        n = host_shard_len(len(self.dataset), self.process_index, self.process_count)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        order = self._host_slice(order)
        n = len(order)
        batches = []
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            batches.append(idx)
        return batches

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batch_indices()
        self.epoch += 1

        if self.num_workers <= 0:
            for idx in batches:
                yield _collate([self.dataset[int(i)] for i in idx])
            return

        yield from bounded_prefetch(
            batches,
            fetch=self.dataset.__getitem__,
            build=_collate,
            num_workers=self.num_workers,
            prefetch_batches=self.prefetch_batches,
        )


def bounded_prefetch(batches, fetch, build, num_workers: int,
                     prefetch_batches: int) -> Iterator[Any]:
    """Shared producer/consumer pipeline for batch loaders.

    Per batch of indices, `fetch(i)` runs on a thread pool (bounded window —
    submitting the whole epoch upfront would accumulate every decoded sample
    in host RAM) and `build(samples)` assembles the yielded batch. Producer
    shuts down cleanly when the consumer abandons the iterator.
    """
    # maxsize=0 would mean UNBOUNDED in queue.Queue — the opposite of the
    # memory bound this prefetcher exists for
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch_batches, 1))
    pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer abandoned us."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            window = max(prefetch_batches, 1) + 1
            pending = [
                [pool.submit(fetch, int(i)) for i in idx]
                for idx in batches[:window]
            ]
            next_submit = min(window, len(batches))
            for _ in range(len(batches)):
                fs = pending.pop(0)
                if not put(build([f.result() for f in fs])):
                    return
                if next_submit < len(batches):
                    pending.append([pool.submit(fetch, int(i))
                                    for i in batches[next_submit]])
                    next_submit += 1
        except Exception as e:  # surface loader errors to the consumer
            put(e)
        finally:
            put(_STOP)

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        pool.shutdown(wait=False, cancel_futures=True)
