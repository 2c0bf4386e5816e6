"""Profiling and metrics plumbing.

Port of :mod:`tao_amodal_tpu.utils.profiling`: named wall-clock sections
(:class:`StepTimer`), the ETA line of the reference's
``log_helper.print_speed``, scalar logging as a JSONL stream with
tensorboard where it is installed (:class:`ScalarWriter`), and a device
trace: :func:`device_trace` runs ``torch.profiler`` (CPU and, where a
card is present, CUDA activities) in place of ``jax.profiler`` and
writes a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class StepTimer:
    """Named wall-clock section timing with running stats."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def avg_ms(self, name):
        return 1000.0 * self.totals[name] / max(self.counts[name], 1)

    def summary(self):
        return {k: self.avg_ms(k) for k in self.totals}


def print_speed(step, total_steps, step_time, logger=None):
    """Log (or print) the progress and ETA line; returns it."""
    remaining = (total_steps - step) * step_time
    h, rem = divmod(int(remaining), 3600)
    m, s = divmod(rem, 60)
    msg = (f"Progress: {step} / {total_steps} "
           f"[{step / max(total_steps, 1):.1%}], "
           f"{step_time:.3f} s/step, ETA {h:d}:{m:02d}:{s:02d}")
    (logger.info if logger else print)(msg)
    return msg


@contextlib.contextmanager
def device_trace(log_dir):
    """``torch.profiler`` over the block; on exit its Chrome trace is
    written to ``<log_dir>/trace.json`` (open it in Perfetto or
    ``chrome://tracing``).  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ScalarWriter:
    """Scalar logging without a tensorboard dependency: a JSONL event
    stream (``<log_dir>/scalars.jsonl``), and tensorboard's writer too
    where it imports."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self._path, "a")
        self._tb = None
        try:  # pragma: no cover - optional dependency
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def scalar(self, tag, value, step):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
