"""Tensor parallelism over the mesh's ``'model'`` axis.

Port of :mod:`tao_amodal_tpu.parallel.tp`: the Megatron column -> row
pattern on the two two-layer MLP blocks where the model's parameters
concentrate, the RoI box head (``box_head.Dense_0`` split on its output
features, ``Dense_1`` on its input features) and the Amodal Expander
(``fc0`` / ``fc1`` likewise); the trunk, FPN and RPN stay replicated.

JAX annotates the kernels' shardings and GSPMD inserts the collectives;
here the rank keeps its slice of each weight and the two collectives go
in as autograd functions (Megatron's ``f`` and ``g``): the column layer's
input passes through unchanged and its gradient is summed over the
``model`` group in the backward pass; the row layer's partial product is
summed over the group (one ``all_reduce`` a block, before the bias) and
its gradient passes through.  The port's weights are ``nn.Linear``'s
``[out, in]``, so the column layer splits dim 0 and the row layer dim 1,
the transposes of Flax's kernels.  In bf16 the row layer's sum is taken
in f32 (f64 on the CPU) and rounded once after the reduction, where
``models/layers.py::dense`` rounds an unsplit product, so the bf16 form
stays Flax's.

A width that ``model`` does not divide stays replicated, as in JAX.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

# (name parts) -> the dim of the port's tensor split over 'model'.
_TP_RULES = (
    (("box_head", "Dense_0", "weight"), 0),
    (("box_head", "Dense_0", "bias"), 0),
    (("box_head", "Dense_1", "weight"), 1),
    (("expander", "fc0", "weight"), 0),
    (("expander", "fc0", "bias"), 0),
    (("expander", "fc1", "weight"), 1),
)
# The layers whose input (column) or output (row) the collectives wrap.
_COLUMN = (("box_head", "Dense_0"), ("expander", "fc0"))
_ROW = (("box_head", "Dense_1"), ("expander", "fc1"))


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, gradient summed over the
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the partial products summed over the group
    forward, the gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _spec_for(name, shape, model_size):
    parts = name.split(".")
    for keys, dim in _TP_RULES:
        if all(k in parts for k in keys):
            if len(shape) > dim and shape[dim] % model_size == 0:
                return dim
            return None
    return None


def tp_param_shardings(model, mesh):
    """``{name: dim}`` for every tensor of ``model.state_dict()``: the dim
    split over ``'model'`` (Megatron column -> row on the FC heads), or
    None (replicated: every other tensor, and a head whose width
    ``model`` does not divide)."""
    m = mesh.shape["model"]
    return {name: _spec_for(name, tuple(t.shape), m)
            for name, t in model.state_dict().items()}


def _matches(prefix, keys):
    parts = prefix.split(".")
    return all(k in parts for k in keys)


def place_tp(model, mesh):
    """Split ``model``'s heads over the mesh's ``'model'`` axis in place:
    this rank keeps its slice of each split tensor (new parameters) and
    the split layers get the collectives over ``mesh.model_group``.
    Returns :func:`tp_param_shardings` (the ``param_sharding`` of
    :func:`~tao_amodal_torch.parallel.dp.make_train_step`).  Place before
    making a train step: the step's leaves are the parameters it finds."""
    shardings = tp_param_shardings(model, mesh)
    m, k = mesh.shape["model"], mesh.model_index
    group = mesh.model_group
    for prefix, layer in model.named_modules():
        if not isinstance(layer, nn.Linear):
            continue
        split = False
        for leaf in ("weight", "bias"):
            dim = shardings.get(f"{prefix}.{leaf}")
            t = getattr(layer, leaf)
            if dim is None or t is None:
                continue
            part = t.detach().chunk(m, dim=dim)[k].clone()
            setattr(layer, leaf, nn.Parameter(
                part, requires_grad=t.requires_grad))
            split = True
        if not split or group is None:
            continue
        if any(_matches(prefix, keys) for keys in _COLUMN):
            layer.out_features = layer.weight.shape[0]
            layer.tp_input = lambda x, g=group: _CopyToModel.apply(x, g)
        elif any(_matches(prefix, keys) for keys in _ROW):
            layer.in_features = layer.weight.shape[1]
            layer.tp_reduce = lambda y, g=group: _ReduceFromModel.apply(y, g)
    return shardings
