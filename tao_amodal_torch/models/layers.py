"""Convolution, Dense, BatchNorm and softmax at the JAX package's
rounding points, in f32 or bf16.

The JAX modules take a ``dtype`` and keep f32 parameters.  In bf16 Flax
rounds at fixed points, and these functions round at the same ones:

* ``nn.Conv`` / ``nn.Dense(dtype=bf16)``: input and kernel rounded to
  bf16, the product summed in f32 and rounded to bf16, then the bias,
  rounded to bf16, added in bf16 (a second rounding);
* ``nn.BatchNorm(dtype=bf16)`` in inference: ``(x - mean) * (rsqrt(var
  + eps) * scale) + bias`` in f32, rounded to bf16 once;
* ``jax.nn.softmax`` of bf16 logits: ``x - max`` and ``exp`` rounded to
  bf16, the sum taken in f32 and rounded, the quotient rounded.

On the card a bf16 convolution or matmul (cuDNN, cuBLAS) sums in f32
and rounds once, as XLA does.  On the CPU the product is taken in f64
on the rounded operands and rounded after: the CPU's bf16 kernels
promise no f32 sum, and an f32 sum's order (which changes with the
CPU's thread count) moves a result near a bf16 rounding boundary, while
the f64 sum of these products is exact to far below a bf16 ulp, so the
CPU rounds each result from its true sum, whatever the thread count.
In f32 every function is the plain PyTorch layer.
Weights round through :func:`tao_amodal_torch.utils.weights.cast`, once
per load.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tao_amodal_torch.utils.weights import cast

f32 = torch.float32


def _rounded_product(fn, x, w, dtype):
    """``fn(x, w)`` on ``dtype``-rounded operands, summed in f32 (card)
    or f64 (CPU), rounded to ``dtype``."""
    x = x.to(dtype)
    w = cast(w, dtype)
    if x.is_cuda:
        return fn(x, w)
    f64 = torch.float64
    return fn(x.to(f64), w.to(f64)).to(dtype)


def conv(x, m, dtype=f32):
    """``nn.Conv2d`` ``m`` on NCHW ``x`` computed in ``dtype``."""
    if dtype == f32:
        return m(x)
    y = _rounded_product(lambda a, w: F.conv2d(
        a, w, None, m.stride, m.padding, m.dilation), x, m.weight, dtype)
    if m.bias is not None:
        y = y + cast(m.bias, dtype)[:, None, None]
    return y


def dense(x, m, dtype=f32):
    """``nn.Linear`` ``m`` on ``x [..., in]`` computed in ``dtype``."""
    if dtype == f32:
        return m(x)
    y = _rounded_product(lambda a, w: a @ w.T, x, m.weight, dtype)
    if m.bias is not None:
        y = y + cast(m.bias, dtype)
    return y


def batch_norm(x, bn, dtype=f32):
    """Inference ``nn.BatchNorm2d`` ``bn`` on NCHW ``x``, output in
    ``dtype``."""
    if dtype == f32:
        return bn(x)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = ((x.to(f32) - bn.running_mean[:, None, None]) * mul[:, None, None]
         + bn.bias[:, None, None])
    return y.to(dtype)


def softmax(x, dim=-1):
    """``jax.nn.softmax`` in the dtype of ``x``."""
    if x.dtype == f32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    s = e.to(f32).sum(dim=dim, keepdim=True).to(x.dtype)
    return e / s
