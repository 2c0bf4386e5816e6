"""Weight bridge: JAX/Flax checkpoints -> the port's modules.

Reads the flat ``{"a/b/c": ndarray}`` ``.npz`` that
``tao_amodal_tpu/utils/checkpoint.py::save_pytree`` writes, with numpy
alone, into PyTorch modules whose submodules carry the Flax auto-names
(``ConvBN_i``, ``Bottleneck_i``, ``lateral_i``, ``post_i``, ``extra_j``,
``tower``/``obj``/``delta``, ``Dense_0..3``,
``geom_embed``/``fc0``/``fc1``/``deltas``; the IoUNet's ``Dense_0..2`` and
``mod_proj``).  A key
``<top>/<collection>/<path...>/<leaf>`` maps to the PyTorch name
``<top>.<path...>.<param>``:

  * ``params/.../kernel`` 4-d (conv, HWIO) -> ``weight`` OIHW;
  * ``params/.../kernel`` 2-d (Dense, ``[in, out]``) -> Linear
    ``weight`` ``[out, in]``;
  * ``params/.../qkernel`` (the int8 ``ConvBN``'s f32 kernel, HWIO) ->
    ``qkernel``, HWIO as it is;
  * ``params/.../bias`` -> ``bias``; BatchNorm ``params/.../scale`` ->
    ``weight``; the Siamese model's fusion weights
    ``params/cls_weight|loc_weight`` keep their names;
  * ``batch_stats/.../mean|var`` -> ``running_mean|running_var``
    (BatchNorm eps 1e-5 on both sides).

The parameters stay f32, as the JAX package's master weights do; a
module that computes in bf16 takes its weights through :func:`cast`,
which rounds each one once and keeps the copy until the weight changes
(a load, an init, a move to another device).

:func:`save_flat` writes the same ``.npz`` from a module (the way back,
for weights trained by the port).  Also holds the seeded random init
used when no checkpoint is given.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tao_amodal_torch.utils.checkpoint import (  # noqa: F401
    load_flat,
    save_pytree,
)


def derived(t, tag, fn):
    """``fn(t.detach())``, computed once: kept on ``t`` under ``tag``
    until ``t`` is written in place (its version counter moves, as a load
    moves it) or moved."""
    key = (t._version, t.device, t.data_ptr())
    cache = getattr(t, "_derived", None)
    if cache is None:
        cache = t._derived = {}
    hit = cache.get(tag)
    if hit is None or hit[0] != key:
        hit = cache[tag] = (key, fn(t.detach()))
    return hit[1]


def cast(t, dtype):
    """``t`` in ``dtype``, rounded once (:func:`derived`).  Where grad is
    on and ``t`` requires it (a training step), the cast is recorded
    instead, so the gradient reaches the f32 master weight, as JAX
    differentiates through its cast."""
    if t.dtype == dtype:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return t.to(dtype)
    return derived(t, dtype, lambda d: d.to(dtype))


_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
         ("params", "scale"): "weight", ("params", "qkernel"): "qkernel",
         ("params", "cls_weight"): "cls_weight",
         ("params", "loc_weight"): "loc_weight",
         ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def torch_state_dict(flat):
    """Flat Flax dict -> PyTorch state dict (numpy values converted)."""
    sd = {}
    for key, value in flat.items():
        top, collection, *path, leaf = key.split("/")
        if (collection, leaf) not in _LEAF:
            raise KeyError(f"unmapped checkpoint entry {key!r}")
        value = np.asarray(value, np.float32)
        if leaf == "kernel":
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)   # HWIO -> OIHW
            elif value.ndim == 2:
                value = value.T                       # [in,out] -> [out,in]
            else:
                raise ValueError(f"{key}: kernel of rank {value.ndim}")
        name = ".".join([top, *path, _LEAF[(collection, leaf)]])
        sd[name] = torch.from_numpy(np.ascontiguousarray(value))
    return sd


def load_into(module, flat):
    """Copy a flat Flax dict into ``module`` (e.g. the pipeline's
    ``{"detector", "expander"}`` container).  Raises on any missing,
    unexpected or mis-shaped entry."""
    sd = torch_state_dict(flat)
    own = {k: v for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    bad = [(k, tuple(sd[k].shape), tuple(own[k].shape))
           for k in set(sd) & set(own) if sd[k].shape != own[k].shape]
    if missing or unexpected or bad:
        raise ValueError(f"checkpoint does not fit the module: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}, "
                         f"shape mismatches {bad[:5]}")
    module.load_state_dict(sd, strict=False)


def load_variables(module, flat):
    """Copy the flat variables of one Flax module (``params/...`` and
    ``batch_stats/...`` keys, as ``save_pytree`` writes a module's
    variables, e.g. the Siamese tracker's) into ``module``, through
    :func:`load_into`."""
    holder = nn.Module()
    holder.m = module
    load_into(holder, {f"m/{k}": v for k, v in flat.items()})


def variable_names(module):
    """``{PyTorch state name: flat key}`` of ``module`` as one Flax
    module's variables (``params/...``, ``batch_stats/...``; the pipeline
    container's are :func:`flax_names`)."""
    holder = nn.Module()
    holder.m = module
    return {name[len("m."):]: key[len("m/"):]
            for name, key in flax_names(holder).items()}


def flat_variables(module):
    """``module``'s weights as the flat variables of one Flax module
    (``params/...``, ``batch_stats/...`` keys, f32 numpy in JAX's
    layouts): the inverse of :func:`load_variables`."""
    sd = module.state_dict()
    return {key: flax_layout(key, sd[name])
            for name, key in variable_names(module).items()}


# The inverse of _LEAF, by the kind of module that holds the tensor.
_FLAX_LEAF = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
              "qkernel": ("params", "qkernel"),
              "cls_weight": ("params", "cls_weight"),
              "loc_weight": ("params", "loc_weight")}
_FLAX_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                 "running_mean": ("batch_stats", "mean"),
                 "running_var": ("batch_stats", "var")}


def flax_names(module):
    """``{PyTorch state name: flat Flax key}`` of every tensor of
    ``module`` that the JAX package's variables hold (BatchNorm's
    ``num_batches_tracked`` has no counterpart): the inverse of
    :func:`torch_state_dict`'s mapping, ``<top>.<path...>.<param>`` ->
    ``<top>/<collection>/<path...>/<leaf>``."""
    names = {}
    for prefix, m in module.named_modules():
        table = _FLAX_BN_LEAF if isinstance(m, nn.BatchNorm2d) else _FLAX_LEAF
        local = [n for n, _ in m.named_parameters(recurse=False)]
        local += [n for n, _ in m.named_buffers(recurse=False)]
        for name in local:
            if name not in table:
                continue
            top, *path = prefix.split(".")
            collection, leaf = table[name]
            names[f"{prefix}.{name}"] = "/".join(
                [top, collection, *path, leaf])
    return names


def flax_layout(key, t):
    """The f32 numpy value of tensor ``t`` (a weight or its gradient) in
    the layout of the Flax leaf ``key``: a conv ``kernel`` OIHW -> HWIO,
    a Dense ``kernel`` ``[out, in]`` -> ``[in, out]``."""
    value = _np(t)
    if key.endswith("/kernel"):
        value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
    return np.ascontiguousarray(value)


def flat_state(module):
    """``module``'s weights as the flat ``{"a/b/c": f32 ndarray}`` dict of
    the JAX package's variables (JAX layouts; :func:`load_into`'s
    input): copies, which later updates of the module leave as they
    are."""
    sd = module.state_dict()
    return {key: np.array(flax_layout(key, sd[name]))
            for name, key in flax_names(module).items()}


def save_flat(path, module):
    """Write ``module``'s weights as the ``.npz`` that the JAX package's
    ``save_pytree`` writes (:func:`flat_state`): its ``load_pytree`` and
    :func:`load_flat` read it, so weights trained by the port serve in
    either package."""
    save_pytree(path, flat_state(module))


@torch.no_grad()
def random_init_(module, generator):
    """Seeded init with Flax's defaults: LeCun-normal conv and Dense
    kernels (zeros where a layer sets ``zero_init``; the int8
    ``ConvBN``'s HWIO ``qkernel`` too), zero biases, identity BatchNorm
    (scale 1, bias 0, mean 0, var 1)."""
    for m in module.modules():
        q = getattr(m, "qkernel", None)
        if isinstance(q, nn.Parameter):
            q.copy_(torch.randn(q.shape, generator=generator,
                                device=generator.device)
                    * q[..., 0].numel() ** -0.5)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            if getattr(m, "zero_init", False):
                w.zero_()
            else:
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=generator.device)
                        * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


def block_vars_from_resnet(resnet, stage):
    """The identity ``Bottleneck``s of ``resnet``'s ``stage`` (1-indexed;
    every block after the stage's first) as the JAX package's
    ``block_vars``: one dict per block with numpy ``conv{1,2,3}/kernel``
    in HWIO and ``bn{1,2,3}`` = (scale, bias, mean, var), the input of
    both packages' ``quantize_bottleneck_params`` and
    ``bf16_params_from_bottlenecks``."""
    first = sum(resnet.stage_sizes[:stage - 1])
    out = []
    for b in range(first + 1, first + resnet.stage_sizes[stage - 1]):
        block = getattr(resnet, f"Bottleneck_{b}")
        bv = {}
        for j, cb in enumerate((block.ConvBN_0, block.ConvBN_1,
                                block.ConvBN_2), 1):
            bn = cb.BatchNorm_0
            bv[f"conv{j}/kernel"] = _np(cb.Conv_0.weight).transpose(
                2, 3, 1, 0)                               # OIHW -> HWIO
            bv[f"bn{j}"] = tuple(_np(t) for t in (
                bn.weight, bn.bias, bn.running_mean, bn.running_var))
        out.append(bv)
    return out


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy()


def block_params_from_jax(p):
    """A JAX ``QuantBlockParams`` or ``Bf16BlockParams`` of numpy arrays
    -> the port's (``tao_amodal_torch.ops.resnet_blocks``), same layouts;
    bf16 arrays keep their bits."""
    from tao_amodal_torch.ops import resnet_blocks

    def tensor(a):
        a = np.array(a)  # a writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    cls = (resnet_blocks.QuantBlockParams if "res_scale" in p._fields
           else resnet_blocks.Bf16BlockParams)
    return cls(*(tensor(a) for a in p))
