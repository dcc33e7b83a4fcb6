"""Host-side batch loader with threaded prefetch (a port-owned copy of the JAX
package's ``data/loader.py``).

Samples are fetched with a thread pool (h5py and the native gather release
the GIL on I/O and copies), collated into stacked numpy batches, and a small
queue keeps batches ready while the card steps. For the same seed the index
stream is the JAX package's: the same ``np.random.RandomState`` calls in the
same order. ``data.prefetch.DevicePrefetcher`` overlaps the host->device
copy as well.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def collate(samples):
    """Stack a list of nested dict samples into one batch dict."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: collate([s[k] for s in samples]) for k in first}
    if first is None:
        return None
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Iterable over stacked batches.

    Args:
        dataset: indexable dataset (SequenceDataset / MetaDataset)
        batch_size (int)
        shuffle (bool): random permutation each epoch
        sampler_weights (np.ndarray or None): per-index probabilities for
            weighted sampling with replacement (MetaDataset mixing)
        num_workers (int): fetch threads (0 = synchronous)
        drop_last (bool)
        seed (int)
        prefetch (int): number of batches to keep ready ahead of the consumer
    """

    def __init__(self, dataset, batch_size, shuffle=True, sampler_weights=None,
                 num_workers=8, drop_last=True, seed=0, prefetch=2,
                 reuse_buffers=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler_weights = sampler_weights
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        # buffer ring for the batched fast path: page faults on fresh
        # ~150MB batch allocations dominate gather time (~20x), so reusing
        # a small ring of output buffers runs at memcpy speed. A batch's
        # arrays are only valid until `prefetch + 2` more batches are drawn
        # - safe for train loops that copy each batch out before drawing
        # further (DevicePrefetcher waits for its copy), NOT for callers
        # that retain host batches.
        self.reuse_buffers = reuse_buffers
        self._buffer_ring = [dict() for _ in range(max(prefetch, 0) + 2)]
        self._ring_pos = 0
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self):
        n = len(self.dataset)
        if self.sampler_weights is not None:
            return self._rng.choice(
                n, size=n, replace=True, p=self.sampler_weights
            )
        if self.shuffle:
            return self._rng.permutation(n)
        return np.arange(n)

    def _fetch_batch(self, pool, idx_chunk):
        # batched fast path: one native window-gather per (demo, key)
        get_batch = getattr(self.dataset, "get_batch", None)
        if get_batch is not None:
            buffers = None
            if self.reuse_buffers:
                buffers = self._buffer_ring[self._ring_pos]
                self._ring_pos = (self._ring_pos + 1) % len(self._buffer_ring)
            batch = get_batch(idx_chunk, buffers=buffers)
            if batch is not None:
                return batch
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, idx_chunk))
        else:
            samples = [self.dataset[i] for i in idx_chunk]
        return collate(samples)

    def __iter__(self):
        self._epoch += 1
        indices = self._epoch_indices()
        n_batches = len(self)
        chunks = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        pool = (
            ThreadPoolExecutor(max_workers=self.num_workers)
            if self.num_workers > 0
            else None
        )

        if pool is None or self.prefetch <= 0:
            for chunk in chunks:
                yield self._fetch_batch(pool, chunk)
            return

        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    q.put(self._fetch_batch(pool, chunk))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            # Shut the producer DOWN, don't just signal it: an abandoned
            # producer sits blocked in q.put (or mid h5py read) — and a
            # thread inside an h5py call at interpreter exit deadlocks
            # h5py's atexit close on the HDF5 global lock (observed: the
            # full bench_loader sweep hung forever after printing all
            # results). Drain the queue so q.put returns, let the
            # producer observe `stop`, and join it (bounded by one
            # in-flight fetch).
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=60.0)
            pool.shutdown(wait=True)


class InfiniteLoader:
    """Wraps a DataLoader to yield forever (run_epoch's next(iterator)
    pattern, reference train_utils.py:1283-1307)."""

    def __init__(self, loader):
        self.loader = loader
        self._it = iter(loader)

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)
