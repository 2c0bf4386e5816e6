"""The training step on one device.

Port of the single-device part of
:func:`tao_amodal_tpu.parallel.dp.make_train_step`: a loss over a model,
its gradient with respect to every leaf, the global norm of the
unclipped gradients, and the optimizer's update, applied in place.
:func:`make_train_step` gives the detector's step (the loss of
:func:`~tao_amodal_torch.train.detector_loss.detector_train_loss`); the
Siamese trainer (:func:`tao_amodal_torch.cli.train_cli.
build_siamese_training`) builds a :class:`TrainStep` over its own loss.

JAX differentiates the whole variables tree, ``batch_stats`` included,
and its optimizer moves every leaf, weight decay too.  The port does the
same: its leaves are the model's parameters and every BatchNorm running
mean and variance (:func:`trainable_leaves`), which BatchNorm uses
differentiably (``models/layers.py::batch_norm``).  The data- and
tensor-parallel step over ranks is :mod:`tao_amodal_torch.parallel.dp`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from tao_amodal_torch.data.loader import to_device
from tao_amodal_torch.train import optim
from tao_amodal_torch.train.detector_loss import (
    detector_train_loss,
    roi_noise,
)
from tao_amodal_torch.utils.weights import flax_names

BN_STATS = ("running_mean", "running_var")
# The profiler range of the optimizer's update.
OPTIMIZER_RANGE = "train:optimizer"


def trainable_leaves(model):
    """``(names, tensors)``: every parameter of ``model``, then every
    BatchNorm running statistic, which this marks as requiring grad (JAX's
    ``batch_stats`` leaves).  Make the step after moving the model: a
    move replaces the statistics with tensors that are not leaves."""
    names, leaves = [], []
    for name, p in model.named_parameters():
        names.append(name)
        leaves.append(p)
    for prefix, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            for stat in BN_STATS:
                t = getattr(m, stat)
                names.append(f"{prefix}.{stat}")
                leaves.append(t.requires_grad_(True))
    return names, leaves


class TrainState:
    """The model (trained in place) and the optimizer's state; a
    checkpoint is :meth:`state_dict`: the model's state, BatchNorm
    statistics included, and the optimizer's."""

    def __init__(self, model, opt_state):
        self.model = model
        self.opt_state = opt_state

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "opt_state": self.opt_state}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        device = next(self.model.parameters()).device
        self.opt_state = _to(state["opt_state"], device)


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(t, device) for t in tree)
    return tree


class TrainStep:
    """``step(state, batch, rng) -> (state, metrics)`` for ``model`` and
    an optimizer of :mod:`tao_amodal_torch.train.optim`.

    ``loss_fn(model, batch, draws) -> (loss, terms)``, a dict of 0-d
    terms; ``draws_fn(batch, generator) -> draws`` draws the loss's
    randomness.  ``rng`` (an int) seeds ``draws_fn``'s generator on the
    model's device; :meth:`run` takes the draws themselves.  ``batch``
    holds numpy arrays or tensors (moved to the model's device).  The
    metrics are 0-d tensors: ``loss``, ``grad_norm`` (the global norm of
    the unclipped gradients over every leaf) and the loss's terms.
    ``names_fn(model)`` maps the model's state names to JAX's flat keys
    (:func:`~tao_amodal_torch.utils.weights.flax_names` for the
    pipeline's container, ``variable_names`` for one module).
    """

    def __init__(self, model, optimizer, loss_fn, draws_fn,
                 names_fn=flax_names):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.draws_fn = draws_fn
        self.names_fn = names_fn
        self.names, self.leaves = trainable_leaves(model)
        self.device = self.leaves[0].device

    def init_state(self):
        return TrainState(self.model, self.optimizer.init(self.leaves))

    def flax_names(self):
        """The leaves' names in the JAX package's flat form."""
        table = self.names_fn(self.model)
        return [table[n] for n in self.names]

    def loss_and_grads(self, batch, draws):
        """``(loss, terms, grads)``: the gradient of every leaf (zeros
        where the loss does not reach it, as JAX returns them)."""
        batch = to_device(batch, self.device)
        loss, terms = self.loss_fn(self.model, batch, draws)
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in terms.items()}, grads

    def reduce(self, loss, terms, grads):
        """What the ranks of a data-parallel step agree on before the
        update (:mod:`tao_amodal_torch.parallel.dp`); one device: as
        given."""
        return loss, terms, grads

    def grad_norm(self, grads):
        """The global norm of the unclipped gradients."""
        return optim.global_norm(grads)

    def run(self, state, batch, draws):
        loss, terms, grads = self.reduce(*self.loss_and_grads(batch, draws))
        with record_function(OPTIMIZER_RANGE):
            grad_norm = self.grad_norm(grads)
            updates, state.opt_state = self.optimizer.update(
                optim.Gradients(grads, grad_norm), state.opt_state,
                self.leaves)
            optim.apply_updates(self.leaves, updates)
        return state, {"loss": loss, "grad_norm": grad_norm, **terms}

    def __call__(self, state, batch, rng):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng))
        return self.run(state, batch, self.draws_fn(batch, gen))


def detector_loss(pipe, batch, noise):
    """The detector's ``loss_fn``."""
    return detector_train_loss(pipe.detector, pipe.expander, batch, noise)


def detector_draws(batch, generator):
    """The detector's ``draws_fn``: :func:`roi_noise` for the batch's
    frames (``batch`` may hold meta tensors: only shapes are read)."""
    B, G = np.shape(batch["gt_boxes"])[:2]
    hw = tuple(np.shape(batch["images"])[1:3])
    return roi_noise(B, G, hw, generator)


def make_train_step(pipe, optimizer):
    """The detector's :class:`TrainStep` over ``pipe`` (an
    :class:`~tao_amodal_torch.pipeline.AmodalPipeline`, on its device) and
    ``optimizer``: the draws are :func:`~tao_amodal_torch.train.
    detector_loss.roi_noise`'s; the initial state is
    ``step.init_state()``."""
    return TrainStep(pipe, optimizer, detector_loss, detector_draws)
