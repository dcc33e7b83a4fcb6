"""Device prefetch: the host->device pipeline of the training loop (the port's
counterpart of the JAX package's ``data/prefetch.py``).

``DevicePrefetcher`` runs one background thread over a batch loader. For
each batch the thread

1. draws the host batch from the loader (``fetch``),
2. runs ``prepare`` on it (the algo's host-side slicing and normalization),
3. on a card: copies every array into pinned staging tensors owned by the
   prefetcher (``stage``; this also makes the strided views that ``prepare``
   returns contiguous), issues ``tensor.to(device, non_blocking=True)`` for
   each on a side CUDA stream between two timing events, and waits for the
   copy's end event before it draws the next host batch (``copy``). The wait
   is what lets one set of staging tensors serve every batch, and it keeps
   the loader's reused host buffers (``DataLoader(reuse_buffers=True)``)
   out of any copy in flight;
   on the CPU: the same thread makes plain copies of the arrays as tensors;
4. queues the batch with its end event and its timings.

The consumer's ``get()`` makes the current stream wait on the batch's event
and calls ``record_stream`` on each of its tensors, so the caching allocator
does not hand their memory to the side stream while the step still reads it.
Batches come strictly in loader order and none is dropped: the stream equals
the synchronous path's (prepare each loader batch in turn). At the loader's
end the thread starts a new pass, as ``run_epoch`` does.

Each batch's timings are recorded in ``stats`` when ``get()`` hands the batch
out, so the statistics of a window of steps (``reset_stats()`` ...
``transfer_summary()``) describe the batches consumed in it, whichever pass
of the thread produced them.
"""

import queue
import threading
import time

import numpy as np
import torch

from robot_manipulation_vq_vae_tpu_torch import resolve_device

_SENTINEL = object()
STAT_KEYS = ("host_load_s", "host_process_s", "stage_s", "transfer_s", "bytes",
             "stall_s")


def _leaves(tree, path=()):
    """(path, array) for every numpy leaf of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, np.ndarray):
        yield path, tree


def _tensor_leaves(tree):
    """Every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _replace(tree, values, path=()):
    """@tree with each numpy leaf replaced by values[path]."""
    if isinstance(tree, dict):
        return {k: _replace(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return values[path]
    return tree


class DevicePrefetcher:
    """Background-thread host->device pipeline over @data_loader, @depth
    batches ahead (see the module docstring). @device is ``cuda`` unless
    given; without a card it raises rather than take the CPU.

    Attributes:
        stats: per consumed batch: ``host_load_s`` (the loader), ``host_process_s``
            (``prepare``), ``stage_s`` (host copy into the pinned staging),
            ``transfer_s`` (the host->device copy, CUDA events; 0 on the CPU),
            ``bytes`` (moved to the device), ``stall_s`` (how long ``get()``
            waited for it).
        pinned: whether batches go through pinned staging (on a card).
    """

    def __init__(self, data_loader, prepare=None, depth=2, device=None):
        self.device = resolve_device(device)
        self.pinned = self.device.type == "cuda"
        if self.pinned and self.device.index is None:
            # the thread selects the card by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._loader = data_loader
        self._prepare = prepare
        self._q = queue.Queue(maxsize=max(1, depth))
        self._closed = threading.Event()
        self._staging = {}
        self._stream = torch.cuda.Stream(self.device) if self.pinned else None
        self.stats = {k: [] for k in STAT_KEYS}
        self._thread = threading.Thread(target=self._work, name="device-prefetch",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ worker
    def _stage(self, path, arr):
        """The pinned staging tensor for leaf @path, holding a copy of @arr."""
        buf = self._staging.get(path)
        if buf is None or tuple(buf.shape) != arr.shape or buf.numpy().dtype != arr.dtype:
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            buf = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            self._staging[path] = buf
        np.copyto(buf.numpy(), arr)
        return buf

    def _to_device(self, batch, timing):
        """The batch's arrays as tensors on the device; returns (batch, the
        copy's end event or None)."""
        leaves = list(_leaves(batch))
        timing["bytes"] = sum(a.nbytes for _, a in leaves)
        if not self.pinned:
            t0 = time.perf_counter()
            out = {p: torch.from_numpy(np.array(a)) for p, a in leaves}
            timing["stage_s"], timing["transfer_s"] = time.perf_counter() - t0, 0.0
            return _replace(batch, out), None
        t0 = time.perf_counter()
        staged = [(p, self._stage(p, a)) for p, a in leaves]
        timing["stage_s"] = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            out = {p: buf.to(self.device, non_blocking=True) for p, buf in staged}
            end.record()
        end.synchronize()    # the staging and the loader's buffers are free again
        timing["transfer_s"] = start.elapsed_time(end) / 1e3
        return _replace(batch, out), end

    def _work(self):
        it = None
        try:
            if self.pinned:
                torch.cuda.set_device(self.device)
            it = iter(self._loader)
            while not self._closed.is_set():
                item = self._next(it)
                if item is None:      # a new pass of the loader
                    it = iter(self._loader)
                    item = self._next(it)
                    if item is None:  # an empty loader
                        self._put(_SENTINEL)
                        return
                self._put(item)
        except Exception as e:   # raised again in the consumer's get()
            self._put(e)
        finally:
            if hasattr(it, "close"):   # stop the loader's own threads
                it.close()

    def _next(self, it):
        """(batch on the device, its copy event, its timings) from @it, or
        None at the end of the pass."""
        timing = {}
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return None
        t1 = time.perf_counter()
        if self._prepare is not None:
            batch = self._prepare(batch)
        t2 = time.perf_counter()
        batch, event = self._to_device(batch, timing)
        timing["host_load_s"], timing["host_process_s"] = t1 - t0, t2 - t1
        return batch, event, timing

    def _put(self, item):
        """Queue @item, blocking while @depth batches wait, until closed."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    # ---------------------------------------------------------- consumer
    def get(self):
        """The next batch on the device (blocks while the pipeline fills)."""
        if self._closed.is_set():
            raise RuntimeError("the prefetcher is closed")
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("the device-prefetch thread died without a result")
        stall = time.perf_counter() - t0
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        batch, event, timing = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _tensor_leaves(batch):
                t.record_stream(stream)
        timing["stall_s"] = stall
        for k in STAT_KEYS:
            self.stats[k].append(timing[k])
        return batch

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def transfer_summary(self):
        """Totals over the batches consumed since ``reset_stats()``: seconds by
        stage, megabytes moved, the host->device rate (MB/s over the copies'
        device time) and the consumer's stall."""
        s = self.stats
        total_b, total_t = float(sum(s["bytes"])), float(sum(s["transfer_s"]))
        return {
            "batches": len(s["bytes"]),
            "host_load_s": float(sum(s["host_load_s"])),
            "host_process_s": float(sum(s["host_process_s"])),
            "stage_s": float(sum(s["stage_s"])),
            "transfer_s": total_t,
            "transfer_mbytes": total_b / 1e6,
            "transfer_mbytes_per_sec": total_b / 1e6 / total_t if total_t > 0 else 0.0,
            "stall_s": float(sum(s["stall_s"])),
            "pinned": self.pinned,
        }

    def reset_stats(self):
        for v in self.stats.values():
            del v[:]

    def close(self):
        """Stop the thread, drop the batches it prepared, and join it."""
        self._closed.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter teardown
            pass

