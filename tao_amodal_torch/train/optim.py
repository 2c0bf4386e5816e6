"""Optimizer schedules, staged unfreezing, and the training optimizers.

Port of :mod:`tao_amodal_tpu.train.optim`.  JAX builds its optimizers
from optax; the port writes the same transformations as small functions
over lists of tensors (one list of leaves, one of gradients), following
optax's formulas op for op:

* ``clip_by_global_norm``: ``g`` where the global norm is below the
  maximum, else ``g / norm * max`` (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
* ``add_decayed_weights``: ``g + wd * p`` on every leaf;
* ``trace`` (SGD's momentum): ``g + decay * trace``;
* ``scale_by_adam``: the moments ``(1 - b) * g^k + b * m``, bias
  corrected at the incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``;
* ``scale_by_learning_rate``: times ``-lr(count)``, the schedule read at
  the update count, which starts at 0.

A transformation is an ``(init, update)`` pair as in optax:
``init(leaves) -> state`` and ``update(grads, state, leaves) -> (updates,
state)``; a state is a tuple of ints and lists of tensors, which
``torch.save`` writes as it is.  On the card the per-leaf arithmetic runs
as PyTorch's multi-tensor (``_foreach``) ops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def log_schedule(start_lr, end_lr, steps):
    """Log-space interpolation from start to end (the pysot 'log'
    schedule); the rate at update count ``count`` as an f32 value."""
    lrs = np.exp(np.linspace(np.log(start_lr), np.log(end_lr), steps))
    lrs = lrs.astype(np.float32)

    def schedule(count):
        return float(lrs[min(count, steps - 1)])

    return schedule


def warmup_log_schedule(warmup_start, warmup_end, warmup_steps,
                        start_lr, end_lr, steps):
    """Warmup (log) then main log schedule, like pysot's
    ``WarmUPScheduler``."""
    warm = log_schedule(warmup_start, warmup_end, max(warmup_steps, 1))
    main = log_schedule(start_lr, end_lr, max(steps - warmup_steps, 1))

    def schedule(count):
        return (warm(count) if count < warmup_steps
                else main(count - warmup_steps))

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """optax's ``cosine_decay_schedule``: ``init_value * ((1 - alpha) *
    0.5 * (1 + cos(pi * min(count, decay_steps) / decay_steps)) +
    alpha)``, in f32 as optax computes it; the rate at update count
    ``count`` as a Python float."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")
    f32 = np.float32

    def schedule(count):
        t = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t
                                             / f32(decay_steps)))
        return float(f32(init_value) * (f32(1 - alpha) * cosine
                                        + f32(alpha)))

    return schedule


def staged_unfreeze_mask(names, frozen_prefixes, step, unfreeze_step):
    """``{name: trainable}`` for leaf names in the JAX package's flat
    form (``"detector/params/backbone/..."``,
    :func:`tao_amodal_torch.utils.weights.flax_name`): False (no update)
    where the name holds one of ``frozen_prefixes`` until
    ``unfreeze_step``, as JAX's mask tests each joined path."""
    return {n: not (any(p in n for p in frozen_prefixes)
                    and step < unfreeze_step) for n in names}


def global_norm(tensors):
    """``sqrt(sum of every element squared)`` over ``tensors``, a 0-d
    tensor (``optax.global_norm``), summed as one flat vector (PyTorch's
    tree-wise sum: ``torch.linalg.vector_norm`` on the CPU loses about
    1e-3 of a 12.8M-element leaf's square sum)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return torch.sqrt(torch.sum(flat * flat))


class Gradients(list):
    """Gradients that carry their global norm (``norm``, a 0-d tensor),
    which :func:`clip_by_global_norm` then takes as it is: a step whose
    leaves are split over ranks (:mod:`tao_amodal_torch.parallel.dp`)
    computes the norm of the whole across them."""

    def __init__(self, grads, norm):
        super().__init__(grads)
        self.norm = norm


def chain(*transforms):
    def init(leaves):
        return tuple(t.init(leaves) for t in transforms)

    def update(grads, state, leaves):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, leaves)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update)


def _empty(leaves):
    return ()


def clip_by_global_norm(max_norm):
    def update(grads, state, leaves):
        norm = getattr(grads, "norm", None)
        if norm is None:
            norm = global_norm(grads)
        if bool(norm < max_norm):
            return grads, state
        clipped = torch._foreach_div(grads, norm)
        torch._foreach_mul_(clipped, max_norm)
        return clipped, state

    return GradientTransformation(_empty, update)


def add_decayed_weights(weight_decay):
    def update(grads, state, leaves):
        out = torch._foreach_mul([p.detach() for p in leaves], weight_decay)
        torch._foreach_add_(out, grads)
        return out, state

    return GradientTransformation(_empty, update)


def _zeros(leaves):
    return [torch.zeros_like(p) for p in leaves]


def trace(decay):
    def init(leaves):
        return (_zeros(leaves),)

    def update(grads, state, leaves):
        (tr,) = state
        new = torch._foreach_mul(tr, decay)
        torch._foreach_add_(new, grads)
        return new, (new,)

    return GradientTransformation(init, update)


def _moment(grads, m, decay, square):
    g = torch._foreach_mul(grads, grads) if square else grads
    out = torch._foreach_mul(g, 1 - decay)
    torch._foreach_add_(out, torch._foreach_mul(m, decay))
    return out


def _correction(decay, count):
    """``1 - decay ** count`` in f32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    def init(leaves):
        return (0, _zeros(leaves), _zeros(leaves))

    def update(grads, state, leaves):
        count, mu, nu = state
        mu = _moment(grads, mu, b1, False)
        nu = _moment(grads, nu, b2, True)
        count += 1
        mu_hat = torch._foreach_div(mu, _correction(b1, count))
        nu_hat = torch._foreach_div(nu, _correction(b2, count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        return torch._foreach_div(mu_hat, denom), (count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate):
    """Times ``-learning_rate(count)`` (or ``-learning_rate``, a
    number)."""
    def init(leaves):
        return (0,)

    def update(grads, state, leaves):
        (count,) = state
        lr = (learning_rate(count) if callable(learning_rate)
              else learning_rate)
        step = float(-np.float32(lr))
        return torch._foreach_mul(grads, step), (count + 1,)

    return GradientTransformation(init, update)


def apply_updates(leaves, updates):
    """``p + u`` for every leaf, in place (``optax.apply_updates``)."""
    with torch.no_grad():
        torch._foreach_add_(list(leaves), updates)


def make_optimizer(schedule, weight_decay=1e-4, momentum=0.9,
                   clip_norm=10.0):
    """SGD+momentum with grad clipping (the reference's training
    recipe: clip_grad_norm_ then SGD, ``tools/train.py:217-231``)."""
    return chain(clip_by_global_norm(clip_norm),
                 add_decayed_weights(weight_decay), trace(momentum),
                 scale_by_learning_rate(schedule))


def make_adamw(schedule, weight_decay=1e-4, clip_norm=10.0):
    """The global-norm clip (none where ``clip_norm`` is None), then
    optax's ``adamw`` (Adam, decayed weights, the learning rate)."""
    clip = () if clip_norm is None else (clip_by_global_norm(clip_norm),)
    return chain(*clip, scale_by_adam(), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))


def adamw(learning_rate, weight_decay=1e-4):
    """optax's ``adamw(learning_rate)`` at its defaults: no clip, and the
    weight decay on every leaf."""
    return make_adamw(learning_rate, weight_decay, clip_norm=None)
