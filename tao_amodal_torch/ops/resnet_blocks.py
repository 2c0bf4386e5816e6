"""Identity-bottleneck stacks in int8 and bf16: kernels B7 and B8 and
their plain versions.

Port of :mod:`tao_amodal_tpu.ops.pallas.resnet_blocks`, with its names.
A stack is the N stride-1 identity bottlenecks of one ResNet stage with
BatchNorm folded: per block ``1x1 (C -> M) -> 3x3 (M -> M) -> 1x1 (M ->
C) + x``, ReLU after each conv.  Activations are NHWC ``[T, H, W, C]``;
params keep the JAX layouts (w1 ``[N, C, M]``, w2 ``[N, 3, 3, M, M]``
HWIO, w3 ``[N, M, C]``).

* int8 (:class:`QuantBlockParams`): int8 x int8 dots accumulate exactly;
  the requantization ``_rq`` (``acc * s + b``, ReLU, round half to even,
  clip to [0, 127]) folds in BN, and the last conv adds the residual as
  ``((acc3 * s3) + b3) + x * res_scale``.
* bf16 (:class:`Bf16BlockParams`): dots accumulate in f32, BN is the
  per-channel ``acc * g + b``, and every conv's output is rounded to
  bf16; the last conv adds ``x`` before the ReLU.

Kernels: ``csrc/resnet_blocks.cu`` replaces the TPU kernels
``identity_blocks_pallas`` (B7, ``tao_conv_nhwc_s8``) and
``identity_blocks_bf16_pallas`` (B8, ``tao_conv_nhwc_bf16``).  The TPU
kernels keep a frame's whole stack in VMEM; here each conv is one
implicit-GEMM launch with its epilogue fused, and the intermediates go
through device memory in int8 or bf16, rounded where the plain version
rounds them, so the numbers match.  Forward only.

The plain int8 version takes its dots in float64, exact for these sums
(|acc| <= 127 * 127 * 9 * M < 2**53) on the CPU and on the card, where
cuDNN and cuBLAS have no integer path and f32 is not exact past 2**24.
The plain bf16 version casts each conv's operands to f32, whose products
of bf16 values are exact; on the card keep TF32 off around it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tao_amodal_torch import _build


class QuantBlockParams(NamedTuple):
    """N identity bottlenecks at one stage, int8 with requant vectors.

    w1 ``[N, C, M]``, w2 ``[N, 3, 3, M, M]``, w3 ``[N, M, C]`` int8;
    s*/b* f32 ``[N, M]`` or ``[N, C]`` (BN folded, scaled from the
    producing to the consuming activation scale); res_scale ``[N]`` f32
    (input scale / output scale).
    """

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor
    res_scale: torch.Tensor


class Bf16BlockParams(NamedTuple):
    """N identity bottlenecks at one stage, bf16 with BN folded.

    w1 ``[N, C, M]``, w2 ``[N, 3, 3, M, M]``, w3 ``[N, M, C]`` bf16;
    g*/b* f32 per-channel scale and bias.
    """

    w1: torch.Tensor
    g1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    g3: torch.Tensor
    b3: torch.Tensor


def _rq(acc, scale, bias):
    """f32 accumulator (an exact integer) -> int8: scale, bias, ReLU,
    round half to even, clip."""
    y = acc * scale + bias
    return torch.round(y.clamp_min(0.0)).clamp(0, 127).to(torch.int8)


def _conv3x3(y, w, dtype):
    """SAME 3x3 of NHWC ``y`` with HWIO ``w`` as nine shifted dots in
    ``dtype``, summed tap by tap as the JAX reference sums them."""
    H, W = y.shape[1:3]
    yp = F.pad(y.to(dtype), (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            d = yp[:, dy:dy + H, dx:dx + W] @ w[dy, dx].to(dtype)
            acc = d if acc is None else acc + d
    return acc


def identity_blocks_reference(x, p: QuantBlockParams):
    """Plain version of B7: ``[T, H, W, C]`` int8 -> int8."""
    f32, f64 = torch.float32, torch.float64
    for i in range(p.w1.shape[0]):
        acc1 = x.to(f64) @ p.w1[i].to(f64)
        y1 = _rq(acc1.to(f32), p.s1[i], p.b1[i])
        y2 = _rq(_conv3x3(y1, p.w2[i], f64).to(f32), p.s2[i], p.b2[i])
        acc3 = (y2.to(f64) @ p.w3[i].to(f64)).to(f32)
        y3 = acc3 * p.s3[i] + p.b3[i] + x.to(f32) * p.res_scale[i]
        x = torch.round(y3.clamp_min(0.0)).clamp(0, 127).to(torch.int8)
    return x


def identity_blocks_bf16_reference(x, p: Bf16BlockParams):
    """Plain version of B8: ``[T, H, W, C]`` -> bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    x = x.to(bf16)
    for i in range(p.w1.shape[0]):
        acc1 = x.to(f32) @ p.w1[i].to(f32)
        y1 = (acc1 * p.g1[i] + p.b1[i]).clamp_min(0.0).to(bf16)
        acc2 = _conv3x3(y1, p.w2[i], f32)
        y2 = (acc2 * p.g2[i] + p.b2[i]).clamp_min(0.0).to(bf16)
        acc3 = y2.to(f32) @ p.w3[i].to(f32)
        y3 = acc3 * p.g3[i] + p.b3[i] + x.to(f32)
        x = y3.clamp_min(0.0).to(bf16)
    return x


def _pack_s8(w):
    """int8 ``[N, K, Cout]`` -> int32 ``[N, K/4, Cout]``, each word four
    consecutive k of one output channel (the ``__dp4a`` operand)."""
    N, K, Co = w.shape
    return (w.reshape(N, K // 4, 4, Co).transpose(2, 3).contiguous()
            .view(torch.int32).reshape(N, K // 4, Co))


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_stack(name, x, p, dtype, multiple):
    """Raise unless ``x`` and ``p`` are a stack the kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != dtype or x.dim() != 4:
        raise ValueError(f"{name}: want {dtype} [T, H, W, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    C = x.shape[-1]
    N, _, M = p.w1.shape
    shapes = [(N, C, M), (N, M), (N, M), (N, 3, 3, M, M), (N, M), (N, M),
              (N, M, C), (N, C), (N, C), (N,)][:len(p)]
    for field, t, shape in zip(p._fields, p, shapes):
        want = (dtype if field[0] == "w" else torch.float32)
        if (tuple(t.shape) != shape or t.dtype != want
                or t.device != x.device):
            raise ValueError(f"{name}: {field} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, want {want} "
                             f"{shape} on {x.device}")
    if C % multiple or M % multiple:
        raise ValueError(f"{name}: C={C} and M={M} must be multiples of "
                         f"{multiple}")


def identity_blocks_pallas(x, p: QuantBlockParams):
    """Kernel B7 (same contract as :func:`identity_blocks_reference`).

    A CPU ``x`` takes the plain version; a CUDA ``x`` launches
    ``tao_conv_nhwc_s8`` three times per block (or this raises).  C and M
    must be multiples of 32 (one K slice of the kernel is 32 channels of
    one tap).  One call counts one launch.
    """
    if x.device.type == "cpu":
        return identity_blocks_reference(x, p)
    _check_stack("identity_blocks_pallas", x, p, torch.int8, 32)
    T, H, W, C = x.shape
    N, _, M = p.w1.shape
    lib, stream = _build.library(), torch.cuda.current_stream(
        x.device).cuda_stream
    w1, w2, w3 = (_pack_s8(p.w1), _pack_s8(p.w2.reshape(N, 9 * M, M)),
                  _pack_s8(p.w3))
    vec = [t.contiguous() for t in (p.s1, p.b1, p.s2, p.b2, p.s3, p.b3,
                                    p.res_scale)]
    s1, b1, s2, b2, s3, b3, rs = vec

    def conv(inp, w, s, b, cout, ks, res=None, res_scale=None):
        out = torch.empty((T, H, W, cout), dtype=torch.int8,
                          device=x.device)
        err = lib.tao_conv_nhwc_s8(
            inp.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(),
            None if res is None else res.data_ptr(),
            None if res_scale is None else res_scale.data_ptr(),
            out.data_ptr(), T, H, W, inp.shape[-1], cout, ks, stream)
        _build.check("tao_conv_nhwc_s8", err)
        return out

    x = _aligned(x)
    for i in range(N):
        y1 = conv(x, w1[i], s1[i], b1[i], M, 1)
        y2 = conv(y1, w2[i], s2[i], b2[i], M, 3)
        x = conv(y2, w3[i], s3[i], b3[i], C, 1, res=x, res_scale=rs[i])
    identity_blocks_pallas.launches += 1
    return x


def identity_blocks_bf16_pallas(x, p: Bf16BlockParams):
    """Kernel B8 (same contract as :func:`identity_blocks_bf16_reference`
    for a bf16 ``x``).

    A CPU ``x`` takes the plain version; a CUDA ``x`` launches
    ``tao_conv_nhwc_bf16`` three times per block (or this raises).  C and
    M must be multiples of 8.  One call counts one launch.
    """
    if x.device.type == "cpu":
        return identity_blocks_bf16_reference(x, p)
    _check_stack("identity_blocks_bf16_pallas", x, p, torch.bfloat16, 8)
    T, H, W, C = x.shape
    N, _, M = p.w1.shape
    lib, stream = _build.library(), torch.cuda.current_stream(
        x.device).cuda_stream
    # bf16 -> f32 is exact: the kernel stages weights as f32.
    w1, w2, w3 = (p.w1.to(torch.float32).contiguous(),
                  p.w2.to(torch.float32).reshape(N, 9 * M, M),
                  p.w3.to(torch.float32).contiguous())
    g1, b1, g2, b2, g3, b3 = (t.contiguous() for t in (
        p.g1, p.b1, p.g2, p.b2, p.g3, p.b3))

    def conv(inp, w, g, b, cout, ks, res=None):
        out = torch.empty((T, H, W, cout), dtype=torch.bfloat16,
                          device=x.device)
        err = lib.tao_conv_nhwc_bf16(
            inp.data_ptr(), w.data_ptr(), g.data_ptr(), b.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            T, H, W, inp.shape[-1], cout, ks, stream)
        _build.check("tao_conv_nhwc_bf16", err)
        return out

    x = _aligned(x)
    for i in range(N):
        y1 = conv(x, w1[i], g1[i], b1[i], M, 1)
        y2 = conv(y1, w2[i], g2[i], b2[i], M, 3)
        x = conv(y2, w3[i], g3[i], b3[i], C, 1, res=x)
    identity_blocks_bf16_pallas.launches += 1
    return x


identity_blocks_pallas.launches = 0
identity_blocks_bf16_pallas.launches = 0


# ---------------------------------------------------------------------
# Parameter folding: the JAX functions of these names, on ``block_vars``
# ---------------------------------------------------------------------
#
# ``block_vars``: one dict per identity Bottleneck with numpy
# ``conv{1,2,3}/kernel`` (HWIO: [1,1,C,M], [3,3,M,M], [1,1,M,C]) and
# ``bn{1,2,3}`` = (scale, bias, mean, var); see
# ``tao_amodal_torch/utils/weights.py::block_vars_from_resnet``.

def fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Inference BN -> per-channel f32 (scale, bias): y = x*scale + bias."""
    scale, bias, mean, var = (torch.as_tensor(np.asarray(a),
                                              dtype=torch.float32)
                              for a in (bn_scale, bn_bias, bn_mean, bn_var))
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def bf16_params_from_bottlenecks(block_vars):
    """Stack identity Bottleneck variable dicts into
    :class:`Bf16BlockParams` (weights rounded to bf16, BN folded)."""
    cols = {k: [] for k in "w1 g1 b1 w2 g2 b2 w3 g3 b3".split()}
    for bv in block_vars:
        for j in (1, 2, 3):
            k = torch.as_tensor(np.asarray(bv[f"conv{j}/kernel"]))
            if k.dim() == 4 and k.shape[:2] == (1, 1):
                k = k[0, 0]
            g, b = fold_bn(*bv[f"bn{j}"])
            cols[f"w{j}"].append(k.to(torch.bfloat16))
            cols[f"g{j}"].append(g)
            cols[f"b{j}"].append(b)
    return Bf16BlockParams(**{k: torch.stack(v) for k, v in cols.items()})


def _fold_convbn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Fold inference BatchNorm into conv (numpy): returns (kernel,
    scale, bias) with y = conv(x, kernel) * scale + bias."""
    inv = bn_scale / np.sqrt(bn_var + eps)
    return kernel, inv, bn_bias - bn_mean * inv


def _quant_weight(w, axis):
    """Per-output-channel symmetric int8 quantization (numpy)."""
    amax = np.max(np.abs(w), axis=axis, keepdims=True)
    s = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s.reshape(-1)


def quantize_bottleneck_params(block_vars, act_scales, in_scale,
                               out_scale):
    """Fold + quantize identity Bottleneck variable dicts into
    :class:`QuantBlockParams`, in numpy as the JAX function computes them.

    ``act_scales``: per block ``{'in', 'y1', 'y2', 'out'}`` calibrated
    activation scales ('in' of block i is 'out' of block i-1);
    ``in_scale``/``out_scale`` are the stage's (the first 'in' and the
    last 'out'), kept for the JAX signature.
    """
    cols = {k: [] for k in "w1 s1 b1 w2 s2 b2 w3 s3 b3 rs".split()}
    for bv, sc in zip(block_vars, act_scales):
        s_in = sc["in"]
        k1, g1, c1 = _fold_convbn(bv["conv1/kernel"][0, 0], *bv["bn1"])
        q1, sw1 = _quant_weight(k1, axis=0)
        cols["w1"].append(q1)
        cols["s1"].append(s_in * sw1 * g1 / sc["y1"])
        cols["b1"].append(c1 / sc["y1"])

        k2, g2, c2 = _fold_convbn(bv["conv2/kernel"], *bv["bn2"])
        q2, sw2 = _quant_weight(k2, axis=(0, 1, 2))
        cols["w2"].append(q2)
        cols["s2"].append(sc["y1"] * sw2 * g2 / sc["y2"])
        cols["b2"].append(c2 / sc["y2"])

        k3, g3, c3 = _fold_convbn(bv["conv3/kernel"][0, 0], *bv["bn3"])
        q3, sw3 = _quant_weight(k3, axis=0)
        cols["w3"].append(q3)
        cols["s3"].append(sc["y2"] * sw3 * g3 / sc["out"])
        cols["b3"].append(c3 / sc["out"])
        cols["rs"].append(np.float32(s_in / sc["out"]))

    def stack(key, dtype=np.float32):
        return torch.from_numpy(np.stack(cols[key]).astype(dtype))

    return QuantBlockParams(
        w1=stack("w1", np.int8), s1=stack("s1"), b1=stack("b1"),
        w2=stack("w2", np.int8), s2=stack("s2"), b2=stack("b2"),
        w3=stack("w3", np.int8), s3=stack("s3"), b3=stack("b3"),
        res_scale=stack("rs"))
