"""Convolution, Dense, BatchNorm and softmax at the JAX package's
rounding points, in f32 or bf16.

The JAX modules take a ``dtype`` and keep f32 parameters.  In bf16 Flax
rounds at fixed points, and these functions round at the same ones:

* ``nn.Conv`` / ``nn.Dense(dtype=bf16)``: input and kernel rounded to
  bf16, the product summed in f32 and rounded to bf16, then the bias,
  rounded to bf16, added in bf16 (a second rounding);
* ``nn.BatchNorm(dtype=bf16)`` in inference: ``(x - mean) * (rsqrt(var
  + eps) * scale) + bias`` in f32, rounded to bf16 once (in f32 too,
  where grad is on: :func:`batch_norm`);
* ``jax.nn.softmax`` of bf16 logits: ``x - max`` and ``exp`` rounded to
  bf16, the sum taken in f32 and rounded, the quotient rounded.

On the card a bf16 convolution or matmul (cuDNN, cuBLAS) sums in f32
and rounds once, as XLA does.  On the CPU the product is taken in f64
on the rounded operands and rounded after: the CPU's bf16 kernels
promise no f32 sum, and an f32 sum's order (which changes with the
CPU's thread count) moves a result near a bf16 rounding boundary, while
the f64 sum of these products is exact to far below a bf16 ulp, so the
CPU rounds each result from its true sum, whatever the thread count.
In f32 every function is the plain PyTorch layer, but BatchNorm under
grad.  Weights round through :func:`tao_amodal_torch.utils.weights.cast`,
once per load (under grad, differentiably, each call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tao_amodal_torch.utils.weights import cast

f32 = torch.float32


def _rounded_product(fn, x, w, dtype, reduce=None):
    """``fn(x, w)`` on ``dtype``-rounded operands, summed in f32 (card)
    or f64 (CPU), rounded to ``dtype``; ``reduce`` (a tensor-parallel
    layer's sum over its shards) is applied to the wide sum, before the
    rounding."""
    x = x.to(dtype)
    w = cast(w, dtype)
    if x.is_cuda and reduce is None:
        return fn(x, w)
    wide = f32 if x.is_cuda else torch.float64
    y = fn(x.to(wide), w.to(wide))
    return (y if reduce is None else reduce(y)).to(dtype)


def conv(x, m, dtype=f32):
    """``nn.Conv2d`` ``m`` on NCHW ``x`` computed in ``dtype``."""
    if dtype == f32:
        return m(x)
    y = _rounded_product(lambda a, w: F.conv2d(
        a, w, None, m.stride, m.padding, m.dilation, m.groups), x,
        m.weight, dtype)
    if m.bias is not None:
        y = y + cast(m.bias, dtype)[:, None, None]
    return y


def dense(x, m, dtype=f32):
    """``nn.Linear`` ``m`` on ``x [..., in]`` computed in ``dtype``.  A
    layer split by :func:`tao_amodal_torch.parallel.tp.place_tp` carries
    ``tp_input`` (applied to ``x`` first) or ``tp_reduce`` (the sum of the
    shards' products, taken before the bias)."""
    enter = getattr(m, "tp_input", None)
    if enter is not None:
        x = enter(x)
    reduce = getattr(m, "tp_reduce", None)
    if dtype == f32:
        if reduce is None:
            return m(x)
        y = reduce(F.linear(x, m.weight))
        return y if m.bias is None else y + m.bias
    y = _rounded_product(lambda a, w: a @ w.T, x, m.weight, dtype, reduce)
    if m.bias is not None:
        y = y + cast(m.bias, dtype)
    return y


def batch_norm(x, bn, dtype=f32):
    """Inference BatchNorm ``bn`` on NCHW ``x``, output in ``dtype``: the
    running statistics, whatever ``bn.training`` says (JAX's detector and
    its training loss run ``use_running_average=True``).

    Flax's ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32,
    written out so that it differentiates in ``x``, the scale, the bias
    and both statistics (JAX's train step takes the gradient of
    ``batch_stats`` too).  In f32 without grad it is PyTorch's inference
    kernel (``F.batch_norm``, ``training=False``), one pass."""
    if dtype == f32 and not torch.is_grad_enabled():
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = ((x.to(f32) - bn.running_mean[:, None, None]) * mul[:, None, None]
         + bn.bias[:, None, None])
    return y.to(dtype)


def batch_norm_train(x, bn, dtype=f32, momentum=0.99):
    """Training-mode BatchNorm ``bn`` on NCHW ``x`` (Flax's
    ``use_running_average=False``), output in ``dtype``.

    Flax's statistics: the mean and ``max(0, E[x^2] - mean^2)`` over
    N, H, W in f32, then the inference formula of :func:`batch_norm`
    with them.  The running statistics move as Flax's ``batch_stats``
    do, ``momentum * running + (1 - momentum) * batch`` (the biased
    variance), with Flax's ``momentum`` (not PyTorch's)."""
    xf = x.to(f32)
    mean = xf.mean((0, 2, 3))
    var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None,
                                                                  None]
    return y.to(dtype)


def softmax(x, dim=-1):
    """``jax.nn.softmax`` in the dtype of ``x``."""
    if x.dtype == f32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    s = e.to(f32).sum(dim=dim, keepdim=True).to(x.dtype)
    return e / s
