"""Weight bridge: JAX/Flax checkpoints -> the port's modules.

Reads the flat ``{"a/b/c": ndarray}`` ``.npz`` that
``tao_amodal_tpu/utils/checkpoint.py::save_pytree`` writes, with numpy
alone, into PyTorch modules whose submodules carry the Flax auto-names
(``ConvBN_i``, ``Bottleneck_i``, ``lateral_i``, ``post_i``, ``extra_j``,
``tower``/``obj``/``delta``, ``Dense_0..3``,
``geom_embed``/``fc0``/``fc1``/``deltas``).  A key
``<top>/<collection>/<path...>/<leaf>`` maps to the PyTorch name
``<top>.<path...>.<param>``:

  * ``params/.../kernel`` 4-d (conv, HWIO) -> ``weight`` OIHW;
  * ``params/.../kernel`` 2-d (Dense, ``[in, out]``) -> Linear
    ``weight`` ``[out, in]``;
  * ``params/.../bias`` -> ``bias``; BatchNorm ``params/.../scale`` ->
    ``weight``;
  * ``batch_stats/.../mean|var`` -> ``running_mean|running_var``
    (BatchNorm eps 1e-5 on both sides).

The parameters stay f32, as the JAX package's master weights do; a
module that computes in bf16 takes its weights through :func:`cast`,
which rounds each one once and keeps the copy until the weight changes
(a load, an init, a move to another device).

Also holds the seeded random init used when no checkpoint is given.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def cast(t, dtype):
    """``t`` in ``dtype``, rounded once: the copy is kept on ``t`` until
    ``t`` is written in place (its version counter moves) or moved."""
    if t.dtype == dtype:
        return t
    key = (dtype, t._version, t.device, t.data_ptr())
    hit = getattr(t, "_cast", None)
    if hit is None or hit[0] != key:
        hit = (key, t.detach().to(dtype))
        t._cast = hit
    return hit[1]

_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
         ("params", "scale"): "weight",
         ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def load_flat(path):
    """The flat ``{"a/b/c": ndarray}`` dict of a ``save_pytree`` npz."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


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


@torch.no_grad()
def random_init_(module, generator):
    """Seeded init with Flax's defaults: LeCun-normal conv and Dense
    kernels (zeros where a layer sets ``zero_init``), zero biases,
    identity BatchNorm (scale 1, bias 0, mean 0, var 1)."""
    for m in module.modules():
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
