"""Start the ranks of a process group on one machine.

JAX drives every device from one controller; the port runs one process
a rank.  :func:`run_ranks` runs rank 0 in the calling process and starts
ranks 1 and up with ``torch.multiprocessing`` (the ``spawn`` method: a
CUDA context does not survive a fork), joins them through a
:class:`torch.distributed.FileStore` in a fresh temporary directory (no
port to collide with another job), calls ``fn(rank, *args)`` in each
once its group is up, and returns the ranks' results in rank order.
The backend is the caller's: ``"nccl"`` where each rank has its own
card, ``"gloo"`` on the CPU and where ranks share a card.

A rank that raises, dies or outlives ``timeout`` ends the whole job: the
others are killed and :class:`RankFailure` says which rank and why, so a
hung rendezvous fails instead of waiting forever.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankFailure(RuntimeError):
    """A rank raised, died or ran past the job's timeout."""


def rank_device(device, world):
    """The device string that puts ``world`` ranks where ``device`` asks:
    ``"cpu"`` (or another non-CUDA device) as it is; a CUDA device only
    where there is a card (raises otherwise, rather than running on the
    CPU).  ``"cuda"`` stays card ``rank`` a rank where there are
    ``world`` cards, and becomes ``"cuda:0"``, every rank sharing the
    first card (gloo only), where there are fewer."""
    if torch.device(device).type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} needs a CUDA device; pass "
                           f"the CPU explicitly to run the ranks there")
    if device == "cuda" and torch.cuda.device_count() < world:
        return "cuda:0"
    return device


def init_rank(rank, world, store_path, backend, timeout):
    """Join the group of ``world`` ranks through the file store at
    ``store_path``."""
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


def _rank_main(fn, rank, world, store_path, backend, timeout, threads,
               args, results):
    """Rank ``rank``: join the group, run ``fn`` and put ``(rank, ok,
    result or traceback)`` on ``results``.  The report goes out before
    the rank leaves its group, so that a failure's report comes ahead of
    those it causes in the other ranks' collectives."""
    joined = False
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        init_rank(rank, world, store_path, backend, timeout)
        joined = True
        results.put((rank, True, fn(rank, *args)))
    except Exception:  # noqa: BLE001 - the caller reports it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if joined:
            dist.destroy_process_group()


def run_ranks(fn, world, args=(), backend="gloo", timeout=300.0,
              threads=None):
    """``[fn(rank, *args) for rank in range(world)]``, each rank with the
    process group initialised (and destroyed after): rank 0 in the
    calling process (its CUDA graphs and its profile stay the caller's),
    every other rank in a process of its own.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable.  ``threads`` sets each rank's PyTorch CPU threads
    (the caller's are restored after rank 0).  ``timeout`` (seconds)
    bounds the whole job and each collective.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="tao_ranks_")
    store_path = os.path.join(tmp, "store")
    procs = {}
    out = {}
    deadline = time.monotonic() + timeout
    threads_before = torch.get_num_threads()
    try:
        for rank in range(1, world):
            p = ctx.Process(target=_rank_main, args=(
                fn, rank, world, store_path, backend, timeout, threads,
                args, results), daemon=True)
            p.start()
            procs[rank] = p
        try:
            _rank_main(fn, 0, world, store_path, backend, timeout, threads,
                       args, results)
        finally:
            torch.set_num_threads(threads_before)
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankFailure(
                    f"ranks {sorted(set(range(world)) - set(out))} of "
                    f"{world} did not finish within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in procs.items()
                        if r not in out and not p.is_alive()]
                if dead and results.empty():
                    # A rank that exited without a result: give its
                    # message a moment to arrive before blaming it.
                    time.sleep(1.0)
                    if results.empty():
                        raise RankFailure(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RankFailure(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs.values():
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
