"""Host-side worker pools for embarrassingly parallel per-video work.

Port of :mod:`tao_amodal_tpu.parallel.pool` (the reference's
``pool_context.py`` and ``fixed_gpu_pool.py``): a process pool whose
workers hold an initialised context (a loaded annotation index, say),
and a pool of one worker process a device.  A device worker sets
``TAO_AMODAL_DEVICE`` to its id, as JAX's do, and runs on
``cuda:<id>`` (the current CUDA device of its process) where the id is
an integer and a card is present; its processes are spawned, since a
CUDA context does not survive a fork.
"""

from __future__ import annotations

import multiprocessing as mp

_worker_context = None


def _init_worker(context):
    global _worker_context
    _worker_context = context


def _call_with_context(args):
    func, item = args
    return func(_worker_context, item)


class PoolWithContext:
    """Process pool whose workers share an init-time context object."""

    def __init__(self, workers, context):
        self._pool = mp.Pool(workers, initializer=_init_worker,
                             initargs=(context,))

    def imap_unordered(self, func, items, chunksize=1):
        return self._pool.imap_unordered(
            _call_with_context, [(func, it) for it in items], chunksize)

    def map(self, func, items):
        return self._pool.map(_call_with_context,
                              [(func, it) for it in items])

    def close(self):
        self._pool.close()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _device_worker(device_id, context, task_queue, out_queue, func):
    import os

    os.environ["TAO_AMODAL_DEVICE"] = str(device_id)
    if isinstance(device_id, int):
        import torch

        if torch.cuda.is_available():
            torch.cuda.set_device(device_id)
    _init_worker(context)
    while True:
        item = task_queue.get()
        if item is None:
            break
        out_queue.put(func(_worker_context, device_id, item))


class FixedDevicePool:
    """One worker process pinned per device id (the reference's
    ``FixedGpuPool``); ``func(context, device_id, item)`` runs in the
    workers, and :meth:`run` returns the results in the order they
    finish."""

    def __init__(self, device_ids, context, func):
        ctx = mp.get_context("spawn")
        self._tasks = ctx.Queue()
        self._out = ctx.Queue()
        self._procs = [
            ctx.Process(target=_device_worker,
                        args=(d, context, self._tasks, self._out, func))
            for d in device_ids
        ]
        for p in self._procs:
            p.start()

    def run(self, items):
        for it in items:
            self._tasks.put(it)
        results = [self._out.get() for _ in items]
        for _ in self._procs:
            self._tasks.put(None)
        for p in self._procs:
            p.join()
        return results
