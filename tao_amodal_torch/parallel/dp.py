"""The data-parallel (and hybrid tensor + data-parallel) training step.

Port of :mod:`tao_amodal_tpu.parallel.dp`.  JAX jits one step over the
global batch and GSPMD reduces the gradients over the sharded batch
axis.  The port runs :class:`~tao_amodal_torch.train.step.TrainStep` in
every rank on the rank's shard of the batch and makes the collectives
itself, so that the step equals JAX's on the global batch:

* the loss's random draws are drawn for the whole global batch from the
  step's ``rng`` (on every rank alike) and sliced by the rank's data
  index: a rank that drew for its own slice would take another step;
* the gradient of every trainable leaf (the BatchNorm statistics
  included: JAX trains ``batch_stats``), the loss and its terms are
  averaged over ``data`` in one bucketed ``all_reduce``.  The detector's
  loss is a mean over frames of per-frame terms and BatchNorm runs on
  its running statistics, so with equal shards the mean of the shards'
  means is the global mean;
* ``grad_norm`` is taken after that reduction (the clip uses it as it
  is); leaves split over ``model`` by :func:`~tao_amodal_torch.parallel.
  tp.place_tp` add their squares over the ``model`` group first.

Gradients of ``model``-split leaves reduce over ``data`` only, as do the
replicated ones: the tensor-parallel collectives already make those
equal across a ``model`` group.  The optimizer's update then runs on each
rank's own leaves, shards included, as JAX's runs sharded.
"""

from __future__ import annotations

import torch

from tao_amodal_torch.parallel.mesh import all_reduce, data_sharding, tree_map
from tao_amodal_torch.train import optim
from tao_amodal_torch.train.step import TrainStep


def _global_like(batch, n):
    """Meta tensors of ``batch``'s shapes with the leading axis ``n``
    times longer: what a ``draws_fn`` reads of the global batch."""
    def like(x):
        shape = tuple(x.shape)
        return torch.empty((shape[0] * n,) + shape[1:], device="meta")

    return tree_map(like, batch)


def _flatten(tensors):
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def _split(flat, like):
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t).to(t.dtype))
        at += t.numel()
    return out


class DataParallelStep(TrainStep):
    """:class:`TrainStep` on this rank's shard of a global batch over
    ``mesh`` (see the module's docstring).  ``sharded`` names the leaves
    that :func:`~tao_amodal_torch.parallel.tp.place_tp` split over
    ``model``.  ``step(state, local_batch, rng)`` draws for the global
    batch; :meth:`run` takes this rank's slice of the global draws."""

    def __init__(self, model, optimizer, loss_fn, draws_fn, mesh,
                 sharded=()):
        super().__init__(model, optimizer, loss_fn, draws_fn)
        self.mesh = mesh
        unknown = set(sharded) - set(self.names)
        if unknown:
            raise ValueError(f"sharded leaves not among the model's: "
                             f"{sorted(unknown)}")
        self.sharded = [n in set(sharded) for n in self.names]

    def __call__(self, state, batch, rng):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng))
        n = self.mesh.shape["data"]
        draws = self.draws_fn(_global_like(batch, n), gen)
        return self.run(state, batch, tree_map(
            lambda d: d[data_sharding(self.mesh, d.shape[0])], draws))

    def reduce(self, loss, terms, grads):
        group = self.mesh.data_group
        if group is None:
            return loss, terms, grads
        names = list(terms)
        scalars = [loss] + [terms[k] for k in names]
        flat = all_reduce(_flatten(scalars + list(grads)), group)
        flat.div_(self.mesh.shape["data"])
        values = _split(flat, scalars + list(grads))
        return (values[0], dict(zip(names, values[1:len(scalars)])),
                values[len(scalars):])

    def grad_norm(self, grads):
        group = self.mesh.model_group
        if group is None or not any(self.sharded):
            return optim.global_norm(grads)
        rep = [g for g, s in zip(grads, self.sharded) if not s]
        split = [g for g, s in zip(grads, self.sharded) if s]
        own = _flatten(split)
        squares = all_reduce(torch.sum(own * own).reshape(1), group)[0]
        flat = _flatten(rep)
        return torch.sqrt(torch.sum(flat * flat) + squares)


def make_train_step(loss_fn, optimizer, mesh, param_sharding=None, *,
                    model, draws_fn):
    """The data-parallel step of ``loss_fn(model, batch, draws) -> (loss,
    terms)`` (a mean over the batch's leading axis) with ``optimizer``
    (:mod:`tao_amodal_torch.train.optim`) over ``mesh``: ``step(state,
    local_batch, rng) -> (state, metrics)``, JAX's ``make_train_step``
    on the global batch.  ``model`` is trained in place (JAX's ``params``
    in ``state``) and ``draws_fn(batch, generator)`` draws the loss's
    randomness (JAX draws from ``rng`` inside the loss).
    ``param_sharding``: None (pure data parallelism) or the map that
    :func:`~tao_amodal_torch.parallel.tp.place_tp` returned after it
    split ``model``'s heads (hybrid TP+DP).  The initial state is
    ``step.init_state()``.  Make the step after moving ``model``."""
    sharded = [n for n, d in (param_sharding or {}).items()
               if d is not None]
    return DataParallelStep(model, optimizer, loss_fn, draws_fn, mesh,
                            sharded=sharded)


def make_eval_step(metric_fn, mesh):
    """``step(model, local_batch) -> metrics``: ``metric_fn(model,
    batch)``'s dict of 0-d tensors on this rank's shard, averaged over
    ``data`` (JAX's batch-sharded eval step with replicated outputs)."""
    def step(model, batch):
        metrics = metric_fn(model, batch)
        group = mesh.data_group
        if group is None:
            return metrics
        names = list(metrics)
        flat = all_reduce(_flatten([metrics[k] for k in names]), group)
        flat.div_(mesh.shape["data"])
        return dict(zip(names, _split(flat, [metrics[k] for k in names])))

    return step
