"""Analytic FLOP counting: the numerator of a model FLOP utilisation.

Port of :mod:`tao_amodal_tpu.utils.flops`.  JAX walks the jaxpr and
counts ``2*M*N*K`` a ``dot_general`` and ``2 * output positions * kernel
volume * C_in / groups`` a convolution; the port counts the same
formulas over the ATen operations a call runs
(``torch.utils.flop_counter.FlopCounterMode``: matrix products and
convolutions, forward and backward), with one correction: PyTorch counts
a grouped convolution's weight gradient as if it were dense, ``groups``
times over, and :func:`flop_counter` counts it per group.

Two differences from JAX's walk:

* the hand-written CUDA kernels are opaque to the counter, as Pallas
  kernels are to the jaxpr, so count on the CPU (where every wrapper
  runs its plain PyTorch version) or on meta tensors, with
  ``pooling="packed"`` as JAX's docstring asks;
* JAX counts a ``while`` loop's body once, the port's eager loops run
  (and count) every round.  No matrix product sits in the serving
  path's loops, so the two counts agree on the trunk, the FPN and the
  detector.
"""

from __future__ import annotations

import torch
from torch.utils import flop_counter as fc


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride,
                   _padding, _dilation, transposed, _output_padding,
                   groups, output_mask, out_shape, **kwargs):
    """``aten.convolution_backward``'s FLOPs with the weight gradient
    counted per group."""
    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])

    n = 0
    if output_mask[0]:
        n += fc.conv_flop_count(grad_out_shape, w_shape, out_shape[0],
                                not transposed)
    if output_mask[1]:
        a, b = ((t(grad_out_shape), t(x_shape)) if transposed
                else (t(x_shape), t(grad_out_shape)))
        n += fc.conv_flop_count(a, b, t(out_shape[1])) // groups
    return n


def flop_counter():
    """A ``FlopCounterMode`` (no display) with the grouped convolution's
    backward counted per group: ``with flop_counter() as c: ...;
    c.get_total_flops()``."""
    return fc.FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward})


def count_flops(fn, *args, **kwargs):
    """Matrix-product and convolution FLOPs of ``fn(*args, **kwargs)``
    (one call, run; arguments may be meta tensors, as JAX's may be
    ``ShapeDtypeStruct``)."""
    with flop_counter() as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def resnet50_reference_flops(h, w, frames=1):
    """Closed-form ResNet-50 trunk FLOPs at ``h x w`` (the sanity anchor;
    classic stem, no FC head): the literature's 4.09 GMACs at 224^2, two
    FLOPs a multiply-add, 8.18e9 at 224x224."""
    return 2 * 4.09e9 * (h * w) / (224 * 224) * frames
