"""Trainer: epochs, metrics, checkpoint/resume, fail-safe retry.

Port of :mod:`tao_amodal_tpu.train.loop` (the capability of both
reference trainers: pysot's per-step metrics and epoch snapshots of
{epoch, state, optimizer}, pytracking's fail-safe loop that reloads the
latest checkpoint after a crash).  A checkpoint is one ``torch.save``
file a kept epoch, ``{"epoch": n, "state": ...}`` where the state is
``state.state_dict()`` (for :class:`~tao_amodal_torch.train.step.
TrainState`: the model's state, BatchNorm statistics included, and the
optimizer's); JAX's orbax format is not carried over.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import re
import time

import numpy as np
import torch


class AverageMeter:
    """Running averages (capability of reference
    ``pysot/utils/average_meter.py`` / ``ltr/admin/stats.py``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sums = {}
        self._counts = {}

    def update(self, metrics, n=1):
        for k, v in metrics.items():
            v = float(v)
            self._sums[k] = self._sums.get(k, 0.0) + v * n
            self._counts[k] = self._counts.get(k, 0) + n

    def avg(self, key):
        return self._sums[key] / max(self._counts.get(key, 0), 1)

    def summary(self):
        return {k: self.avg(k) for k in self._sums}


@dataclasses.dataclass
class TrainConfig:
    num_epochs: int = 20
    steps_per_epoch: int = 1000
    checkpoint_dir: str = "./checkpoints"
    keep_checkpoints: int = 5
    log_every: int = 20
    fail_safe_retries: int = 10  # reference base_trainer.py:60 uses 10
    seed: int = 0


_CHECKPOINT = re.compile(r"^checkpoint_(\d+)\.pt$")


def _snapshot(state):
    return state.state_dict() if hasattr(state, "state_dict") else state


class Trainer:
    """Generic epoch trainer over a train step."""

    def __init__(self, train_step, init_state, data_iter_fn,
                 config: TrainConfig, logger=None,
                 epoch_hooks=(), writer=None):
        """
        Args:
          train_step: ``(state, batch, rng) -> (state, metrics)``, ``rng``
            an int seed (one a step).
          init_state: the initial state: an object with ``state_dict()``
            and ``load_state_dict()`` (a ``TrainState``), or plain data
            (tensors, numbers, containers of them).
          data_iter_fn: ``epoch -> iterator of batches``.
          writer: optional scalar writer with ``scalar(tag, val, step)``.
        """
        self.train_step = train_step
        self.state = init_state
        # Pristine copy for the fail-safe path: if training crashes
        # before any checkpoint exists, retry from a clean state rather
        # than the mid-epoch partially-mutated one.
        self._init_state = copy.deepcopy(_snapshot(init_state))
        self.data_iter_fn = data_iter_fn
        self.config = config
        self.logger = logger or logging.getLogger("tao.train")
        self.epoch_hooks = list(epoch_hooks)
        self.writer = writer
        self.epoch = 0

    # -- checkpointing -------------------------------------------------

    def _restore(self, snapshot):
        if hasattr(self.state, "load_state_dict"):
            self.state.load_state_dict(snapshot)
        else:
            self.state = snapshot

    def checkpoints(self):
        """``{epoch: path}`` of the checkpoints on disk."""
        path = os.path.abspath(self.config.checkpoint_dir)
        if not os.path.isdir(path):
            return {}
        found = (_CHECKPOINT.match(f) for f in os.listdir(path))
        return {int(m.group(1)): os.path.join(path, m.group(0))
                for m in found if m}

    def save_checkpoint(self):
        path = os.path.abspath(self.config.checkpoint_dir)
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, f"checkpoint_{self.epoch}.pt")
        tmp = final + ".tmp"
        torch.save({"epoch": self.epoch, "state": _snapshot(self.state)},
                   tmp)
        os.replace(tmp, final)
        found = self.checkpoints()
        for epoch in sorted(found)[:-self.config.keep_checkpoints]:
            os.remove(found[epoch])

    def load_checkpoint(self, step=None):
        """Load latest (or a specific epoch); returns True on success."""
        found = self.checkpoints()
        step = max(found, default=None) if step is None else step
        if step is None:
            return False
        saved = torch.load(found[step], map_location="cpu",
                           weights_only=True)
        self._restore(saved["state"])
        self.epoch = int(saved["epoch"])
        return True

    # -- the loop ------------------------------------------------------

    def train_epoch(self):
        cfg = self.config
        meter = AverageMeter()
        rng = np.random.RandomState(cfg.seed + self.epoch)
        data_iter = self.data_iter_fn(self.epoch)
        end = time.time()
        for step, batch in enumerate(data_iter):
            if step >= cfg.steps_per_epoch:
                break
            data_time = time.time() - end
            sub = int(rng.randint(2 ** 31 - 1))
            self.state, metrics = self.train_step(self.state, batch, sub)
            metrics = {k: float(v) for k, v in metrics.items()}
            batch_time = time.time() - end
            end = time.time()
            meter.update({**metrics, "batch_time": batch_time,
                          "data_time": data_time})
            if step % cfg.log_every == 0:
                global_step = self.epoch * cfg.steps_per_epoch + step
                msg = " ".join(f"{k}={meter.avg(k):.4f}"
                               for k in sorted(meter.summary()))
                self.logger.info(
                    f"epoch {self.epoch} step {step}: {msg}")
                if self.writer is not None:
                    for k, v in meter.summary().items():
                        self.writer.scalar(k, v, global_step)
        return meter.summary()

    def train(self, load_latest=False, fail_safe=True):
        """Run all epochs; on crash reload the latest checkpoint and
        continue (reference fail-safe semantics)."""
        if load_latest:
            self.load_checkpoint()
        retries = self.config.fail_safe_retries if fail_safe else 1
        attempt = 0
        while self.epoch < self.config.num_epochs:
            try:
                stats = self.train_epoch()
                self.epoch += 1
                self.save_checkpoint()
                for hook in self.epoch_hooks:
                    hook(self, stats)
                attempt = 0
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - fail-safe by design
                attempt += 1
                self.logger.exception(
                    f"Training crashed (attempt {attempt}/{retries}); "
                    "restoring latest checkpoint.")
                if attempt >= retries:
                    raise
                if not self.load_checkpoint():
                    # No checkpoint yet (crash inside the first epoch):
                    # restart from the pristine initial state.
                    self._restore(copy.deepcopy(self._init_state))
                    self.epoch = 0
        return self.state
