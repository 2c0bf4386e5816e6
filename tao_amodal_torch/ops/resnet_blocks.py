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
``identity_blocks_pallas`` (B7, ``tao_identity_stack_s8``) and
``identity_blocks_bf16_pallas`` (B8, ``tao_identity_stack_bf16``).  The
TPU kernels keep a frame's whole stack in VMEM; here each conv is one
implicit-GEMM launch on the tensor cores (``mma.sync``) with its
epilogue fused, and the intermediates go through device memory in int8
or bf16, rounded where the plain version rounds them, so the numbers
match.  :func:`conv_plan` picks each conv's tile width and K split.
Forward only: B8's wrapper raises under grad on the card, as JAX, whose
kernel is a bare ``pallas_call``, cannot differentiate it either.

The plain int8 version takes its dots in float64, exact for these sums
(|acc| <= 127 * 127 * 9 * M < 2**53) on the CPU and on the card, where
cuDNN and cuBLAS have no integer path and f32 is not exact past 2**24.
The plain bf16 version casts each conv's operands to f32, whose products
of bf16 values are exact; on the card keep TF32 off around it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tao_amodal_torch import _build
from tao_amodal_torch.ops import fused_stage


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


# csrc/resnet_blocks.cu: a K slice is 64 bytes of k (32 bf16 or 64 int8
# channels), and a 16-byte copy chunk must not straddle two taps.
SLICE_BYTES = 64
CHANNEL_MULTIPLE = {torch.int8: 16, torch.bfloat16: 8}
# A K range of a split keeps at least this many slices (2 KB of k a
# row): a shorter range loses more to writing and summing its partials
# than the fuller grid gains (experiments/identity_stack_profile.py
# --plans).
MIN_SPLIT_SLICES = 32


def conv_plan(P, Cin, Cout, ks, itemsize, sms=fused_stage.H100_SMS):
    """Tile width and K split of one conv of a stack whose activations
    take ``itemsize`` bytes: B4's :func:`~tao_amodal_torch.ops.fused_stage
    .conv_plan` (the same 128-pixel tiles, two blocks an SM) over
    ``SLICE_BYTES // itemsize``-deep slices, each split range at least
    ``MIN_SPLIT_SLICES`` slices deep.  At ResNet-50's 512^2, T=8 shapes
    that splits B7's stage-4 3x3 in 2, and B8's stage-3 3x3 and stage-4
    1x1 C -> M in 2 and its stage-4 3x3 in 4, nothing else."""
    return fused_stage.conv_plan(P, Cin, Cout, ks, sms,
                                 bk=SLICE_BYTES // itemsize,
                                 min_slices=MIN_SPLIT_SLICES)


def weights_s8(w):
    """int8 ``[N, K, Cout]`` -> ``[N, Cout, K]``, k contiguous: the layout
    of B7's weight operand (``ldmatrix`` has no transpose for 8-bit
    types).  The plain version of the transposition that
    ``tao_identity_stack_s8`` runs on the card (``transpose_s8_kernel``)
    before its convs."""
    return w.transpose(1, 2).contiguous()


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_stack(name, x, p, dtype):
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
    multiple = CHANNEL_MULTIPLE[dtype]
    if C % multiple or M % multiple:
        raise ValueError(f"{name}: C={C} and M={M} must be multiples of "
                         f"{multiple}")
    if max(x.shape[1:3]) >= 1 << 15:  # the kernel packs (y, x) in 16 bits
        raise ValueError(f"{name}: frames up to 32767 pixels a side, got "
                         f"{tuple(x.shape[1:3])}")


@functools.lru_cache(maxsize=64)
def _stack_layout(plan, N, P, C, M, itemsize, sms):
    """What a stack call of one shape needs under ``plan`` (the module's
    :func:`conv_plan`, or a test's), computed once: the three convs'
    plans as the C ``int[9]`` (tile width, splits, slices each),
    the byte offsets in one scratch buffer of y1, y2, the second block
    output, the workspace (4-byte partial sums), the tile counters and
    B7's transposed weights, its size, and the number of tile counters
    (0 where no conv splits)."""
    plans = [plan(P, cin, cout, ks, itemsize, sms)
             for cin, cout, ks in ((C, M, 1), (M, M, 3), (M, C, 1))]
    ints = (ctypes.c_int * 9)(*(v for pl in plans for v in pl[:3]))
    work = 4 * max(pl.workspace for pl in plans)
    tiles = -(-P // fused_stage.BM) * -(-max(C, M) // 64) if work else 0
    sizes = (P * M * itemsize, P * M * itemsize, P * C * itemsize, work,
             -(-4 * tiles // 16) * 16,
             N * (2 * C * M + 9 * M * M) if itemsize == 1 else 0)
    offsets = [sum(sizes[:i]) for i in range(len(sizes) + 1)]
    return ints, offsets, tiles


def _launch_stack(x, weights, vectors, entry):
    """One call of the library's stack entry point ``entry``, which
    launches the conv kernel three times per block on the card: per-conv
    calls from Python could not keep ahead of the card, so the host side
    is kept to a few tensor operations.  ``weights``: the three
    ``[N, K, Cout]`` weights; ``vectors``: the ``[N, ...]`` scale/bias
    vectors (and B7's residual scales).  The intermediates, the block
    outputs but the last, the workspace and tile counters of split convs
    and B7's transposed weights share one scratch buffer; the block
    outputs alternate between it and the returned tensor."""
    T, H, W, C = x.shape
    N, M = weights[0].shape[0], vectors[0].shape[1]
    dev = x.device
    sms = fused_stage._sm_count(dev.index if dev.index is not None
                                else torch.cuda.current_device())
    ints, off, tiles = _stack_layout(conv_plan, N, T * H * W, C, M,
                                     x.element_size(), sms)
    scratch = torch.empty(off[-1], dtype=torch.uint8, device=dev)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    at = [scratch.data_ptr() + o for o in off]
    # Block i writes outs[i % 2]; the last block writes `out`.
    outs = [at[2]] * 2
    outs[(N - 1) % 2] = out.data_ptr()
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    vectors = [t.contiguous() for t in vectors]
    b7 = x.dtype == torch.int8
    err = getattr(_build.library(), entry)(
        x.data_ptr(), *(w.data_ptr() for w in weights),
        *(t.data_ptr() for t in vectors), at[0], at[1], *outs,
        at[3] if tiles else None, at[4] if tiles else None,
        *((at[5],) if b7 else ()), ctypes.addressof(ints), N, T, H, W, C, M,
        tiles, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(entry, err)
    return out


def identity_blocks_pallas(x, p: QuantBlockParams):
    """Kernel B7 (same contract as :func:`identity_blocks_reference`).

    A CPU ``x`` takes the plain version; a CUDA ``x`` launches the conv
    kernel three times per block through ``tao_identity_stack_s8`` (or
    this raises), which first lays the weights out as :func:`weights_s8`
    does.  C and M must be multiples of 16 (a 16-byte copy chunk lies in
    one tap).  One call counts one launch.
    """
    if x.device.type == "cpu":
        return identity_blocks_reference(x, p)
    _check_stack("identity_blocks_pallas", x, p, torch.int8)
    out = _launch_stack(x, (p.w1, p.w2, p.w3),
                        (p.s1, p.b1, p.s2, p.b2, p.s3, p.b3, p.res_scale),
                        "tao_identity_stack_s8")
    identity_blocks_pallas.launches += 1
    return out


def identity_blocks_bf16_pallas(x, p: Bf16BlockParams):
    """Kernel B8 (same contract as :func:`identity_blocks_bf16_reference`
    for a bf16 ``x``).

    A CPU ``x`` takes the plain version; a CUDA ``x`` launches the conv
    kernel three times per block through ``tao_identity_stack_bf16`` (or
    this raises; under grad too, as JAX cannot differentiate B8), on the
    HWIO weights as they are.  C and M must be multiples of 8.  One call
    counts one launch.
    """
    if x.device.type == "cpu":
        return identity_blocks_bf16_reference(x, p)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(t.requires_grad for t in p)):
        raise ValueError("identity_blocks_bf16_pallas: the kernel is "
                         "forward only (JAX cannot differentiate it "
                         "either); run it under torch.no_grad()")
    _check_stack("identity_blocks_bf16_pallas", x, p, torch.bfloat16)
    out = _launch_stack(x, (p.w1, p.w2, p.w3),
                        (p.g1, p.b1, p.g2, p.b2, p.g3, p.b3),
                        "tao_identity_stack_bf16")
    identity_blocks_bf16_pallas.launches += 1
    return out


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
