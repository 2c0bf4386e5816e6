"""Host data pipeline: threaded prefetch feeding batches to the card.

Port of :mod:`tao_amodal_tpu.data.loader`: host threads collate numpy
batches ahead of time (:class:`PrefetchLoader`, :func:`stack_collate`),
and :func:`device_feed` copies the next batch to the device while the
current step computes.  The mesh's sharded placement waits for the
multi-GPU slice; here the copy goes to one device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class PrefetchLoader:
    """Threaded prefetch around a sample iterator + collate fn.  With
    one worker the batches keep the samples' order.  An exception in a
    worker (the iterator's or the collate's) is raised in the consumer,
    which would otherwise wait forever."""

    def __init__(self, sample_iter, collate_fn, batch_size,
                 num_workers=2, prefetch=2):
        self._iter = sample_iter
        self.collate = collate_fn
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.num_workers = max(num_workers, 1)
        self._q = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()

    def _next_samples(self):
        with self._lock:
            return [next(self._iter) for _ in range(self.batch_size)]

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self.collate(self._next_samples())
            except StopIteration:
                self._q.put(None)
                return
            except BaseException as e:  # raised again by __next__
                self._q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()


def to_device(batch, device):
    """A batch (a dict of numpy arrays or tensors) as tensors on
    ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
            .to(device) for k, v in batch.items()}


def device_feed(loader, device="cuda"):
    """Wrap a host loader: each batch's arrays copied to ``device`` (the
    card by default) as tensors, with one-batch lookahead, so the next
    copy is queued before the consumer gets the current batch."""
    it = iter(loader)
    try:
        pending = to_device(next(it), device)
    except StopIteration:
        return
    for batch in it:
        nxt = to_device(batch, device)  # the copy overlaps with compute
        yield pending
        pending = nxt
    yield pending


def stack_collate(samples):
    """Default collate: stack same-keyed numpy arrays."""
    out = {}
    for key in samples[0]:
        out[key] = np.stack([np.asarray(s[key]) for s in samples])
    return out
