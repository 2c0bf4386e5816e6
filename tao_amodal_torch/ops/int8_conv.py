"""The int8 trunk's quantized convolution and its plain version.

Port of ``_int8_conv`` (``tao_amodal_tpu/models/backbones.py:58-84``),
the body of every ``ConvBN`` of the trunk that
``ClipDetector(int8_backbone=True)`` builds, as plain functions:

* :func:`quantize_weight`: per-output-channel scales of the f32 HWIO
  ``qkernel``, ``s_w = max(max|w|, 1e-8) / 127``, and ``w8 = clip(
  round(w / s_w), -127, 127)``;
* :func:`quantize_activation`: one scale for the whole batch (the clip,
  or the ``[B*T]`` frames of ``batched``), the abs-max over every
  element ``/ 127``, or a static ``act_scale`` as JAX takes it; the
  scale stays a tensor on the input's device;
* :func:`int8_conv_reference`: the int8 x int8 convolution summed
  exactly, then :func:`dequant`;
* :func:`dequant`: ``float(acc) * (s_x * s_w[c])`` cast to the module's
  dtype, JAX's order of operations.

Rounding is half to even on both sides (``torch.round`` as
``jnp.round``), and the quotients are true f32 divisions, as in JAX.

Kernels (``csrc/conv_sm90.cu``) behind three wrappers:

* :func:`quantized_conv`, the whole of ``_int8_conv`` on the NCHW
  activation a ``ConvBN`` holds: :func:`quantize_activation_s8`, then
  the conv, which forms ``s_x * s_w[c]`` on the device from both scales
  in device memory.  Two launches a conv, no host sync and no eager
  pass; one where the caller hands in an activation it quantized once
  for two convs (``xq``: a bottleneck's first conv and its projection
  read the same ``x``, which JAX's jit computes once).
* :func:`quantize_activation_s8`: ``tao_quantize_s8``, one launch that
  takes the abs-max over the whole batch (a persistent grid, one
  grid-wide barrier; skipped for a static ``act_scale``), computes
  ``s_x`` on the device and writes the NHWC int8 activation, padded with
  zero channels to the conv's multiple of 16.
* :func:`int8_conv`: ``tao_conv_s8_sm90`` alone, on an int8 NHWC input
  and a given scale.

The conv is an implicit GEMM on ``wgmma`` m64nNk32 s8 -> s32 (stride 1
or 2, kernel 1, 3 or 7 with padding ``(k - 1) // 2``): weights ``[Cout,
K]`` by TMA, the input gathered by ``cp.async``, and a dequantizing
epilogue through shared memory that writes f32, or bf16 rounded to
nearest.  It replaces no Pallas kernel: it computes the XLA
``conv_general_dilated`` of ``_int8_conv``, which on the card must run
somewhere, since PyTorch has no int8 convolution on CUDA.  int32 sums
are exact in any order, split K included, so the kernels equal their
plain versions bit for bit.  The weights are laid out ``[Cout, K]`` (k
contiguous, Cin zero-padded to 16) once per set of quantized weights,
not on every call.

Bound: a ResNet-50 trunk at 512^2, T=8 is about 1.7e11 multiply-adds
(0.17 ms of int8 tensor-core peak), while its convs read f32
activations and write f32 outputs of several GB: bytes set the floor.
The plain version takes its dots in float64, exact for these sums
(|acc| <= 127^2 * K < 2**53) on the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tao_amodal_torch import _build
from tao_amodal_torch.ops import conv_sm90, fused_stage, resnet_blocks
from tao_amodal_torch.utils.weights import derived

f32, f64 = torch.float32, torch.float64
KERNEL_SIZES = (1, 3, 7)
STRIDES = (1, 2)
OUT_DTYPES = (torch.float32, torch.bfloat16)
# The kernel's channel multiple: a 16-byte copy chunk of int8 lies in one
# tap.
CHANNELS = resnet_blocks.CHANNEL_MULTIPLE[torch.int8]


def _f32_scalar(v, like):
    """``v`` as an f32 0-d tensor beside ``like``: dividing by it is a
    true division on the card too, where PyTorch multiplies by the
    reciprocal of a Python number (JAX divides truly, op by op)."""
    return torch.full((), v, dtype=f32, device=like.device)


def quantize_weight(w):
    """f32 HWIO ``w [kh, kw, Cin, Cout]`` -> (int8 ``w8`` HWIO, f32
    ``s_w [Cout]``)."""
    w = w.to(f32)
    w_max = w.abs().amax(dim=(0, 1, 2), keepdim=True)
    s_w = w_max.clamp_min(1e-8) / _f32_scalar(127.0, w)
    w8 = torch.round(w / s_w).clamp(-127, 127).to(torch.int8)
    return w8, s_w.reshape(-1)


def quantize_activation(x, act_scale=None):
    """NHWC ``x`` (any float dtype) -> (int8 ``x8`` NHWC, f32 0-d ``s_x``
    on ``x``'s device).  ``s_x`` is ``act_scale`` when given, else the
    abs-max over all of ``x`` (every frame of the batch) ``/ 127``."""
    x = x.to(f32)
    if act_scale is not None:
        s_x = torch.full((), act_scale, dtype=f32, device=x.device)
    else:
        s_x = x.abs().amax().clamp_min(1e-8) / _f32_scalar(127.0, x)
    x8 = torch.round(x / s_x).clamp(-127, 127).to(torch.int8)
    return x8.contiguous(), s_x


def dequant(acc, scale, dtype=f32):
    """``acc`` (exact integers, any dtype) -> ``float(acc) * scale`` in
    f32, cast to ``dtype``; ``scale [Cout]`` is ``s_x * s_w``."""
    return (acc.to(f32) * scale).to(dtype)


def int8_conv_reference(x8, w8, scale, stride=1, pad=0, out_dtype=f32):
    """Plain version of :func:`int8_conv`: the dots in float64 (exact),
    then :func:`dequant`."""
    acc = F.conv2d(x8.permute(0, 3, 1, 2).to(f64),
                   w8.permute(3, 2, 0, 1).to(f64), stride=stride,
                   padding=pad)
    return dequant(acc.permute(0, 2, 3, 1), scale, out_dtype)


def kernel_weights(w8):
    """int8 HWIO ``w8 [ks, ks, Cin, Cout]`` -> the kernel's operand
    ``[Cout, ks*ks*Cp]`` (k contiguous, ``Cp`` = Cin rounded up to
    :data:`CHANNELS` with zero channels).  Kept on ``w8`` until ``w8``
    is written in place or moved, so a model lays its weights out once
    per set of quantized weights (:func:`~tao_amodal_torch.utils.weights.
    derived`)."""
    def layout(w):
        ks, _, cin, cout = w.shape
        cp = -(-cin // CHANNELS) * CHANNELS
        w = F.pad(w, (0, 0, 0, cp - cin)) if cp != cin else w
        return w.permute(3, 0, 1, 2).reshape(cout, -1).contiguous()

    return derived(w8, "kernel_layout", layout)


def _check(x, w8, scale, stride, pad, out_dtype, name="int8_conv",
           in_dtypes=(torch.int8,)):
    """Raise unless the kernels take these operands (``x`` NHWC, or the
    NHWC view of an NCHW activation)."""
    if x.dtype not in in_dtypes or x.dim() != 4:
        raise ValueError(f"{name}: want {' or '.join(map(str, in_dtypes))} "
                         f"[T, H, W, C], got {x.dtype} {tuple(x.shape)}")
    if (w8.dtype != torch.int8 or w8.dim() != 4
            or w8.shape[0] != w8.shape[1] or w8.shape[2] != x.shape[-1]):
        raise ValueError(f"{name}: want int8 HWIO [k, k, {x.shape[-1]}, "
                         f"Cout], got {w8.dtype} {tuple(w8.shape)}")
    ks, cout = w8.shape[0], w8.shape[3]
    if ks not in KERNEL_SIZES or stride not in STRIDES or pad != (ks - 1) // 2:
        raise ValueError(f"{name}: kernel {ks}, stride {stride}, pad "
                         f"{pad}; the kernel takes sizes {KERNEL_SIZES}, "
                         f"strides {STRIDES} and pad (k - 1) // 2")
    if cout % CHANNELS:
        raise ValueError(f"{name}: Cout={cout} must be a multiple of "
                         f"{CHANNELS}")
    if (scale.dtype != f32 or tuple(scale.shape) != (cout,)
            or scale.device != x.device or w8.device != x.device):
        raise ValueError(f"{name}: scale {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}, weights on "
                         f"{w8.device}; want f32 [{cout}] beside x on "
                         f"{x.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype} not in "
                         f"{OUT_DTYPES}")
    if max(x.shape[1:3]) >= 1 << 15:  # the kernel packs (y, x) in 16 bits
        raise ValueError(f"{name}: frames up to 32767 pixels a side, got "
                         f"{tuple(x.shape[1:3])}")


def _conv_s8(x8, wk, s_w, s_x, ks, stride, out_dtype):
    """One ``tao_conv_s8_sm90`` launch on a checked int8 NHWC ``x8 [T,
    Hi, Wi, Cp]`` (16-byte aligned, Cp channels as ``wk [Cout, ks*ks*Cp]``
    has them), f32 ``s_w [Cout]`` and the device ``s_x`` (None: 1).
    Counts one launch of the conv in :func:`int8_conv`'s ``launches``."""
    T, Hi, Wi, cp = x8.shape
    cout = wk.shape[0]
    pad = (ks - 1) // 2
    Ho = (Hi + 2 * pad - ks) // stride + 1
    Wo = (Wi + 2 * pad - ks) // stride + 1
    P, dev = T * Ho * Wo, x8.device
    plan = conv_sm90.conv_plan(P, cp, cout, ks, 1, fused_stage._sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    out = torch.empty((T, Ho, Wo, cout), dtype=out_dtype, device=dev)
    split = plan.splits > 1
    ws = (torch.empty(plan.workspace, dtype=torch.int32, device=dev)
          if split else None)
    counters = (conv_sm90.counters(dev, conv_sm90.tiles(P, cout, plan.bn, 1))
                if split else None)
    err = _build.library().tao_conv_s8_sm90(
        x8.data_ptr(), wk.data_ptr(), s_w.data_ptr(),
        None if s_x is None else s_x.data_ptr(), out.data_ptr(),
        ws.data_ptr() if split else None,
        counters.data_ptr() if split else None, T, Hi, Wi, cp, Ho, Wo, cout,
        ks, stride, int(out_dtype == torch.bfloat16), plan.bn, plan.splits,
        plan.slices, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("tao_conv_s8_sm90", err)
    int8_conv.launches += 1
    return out


def int8_conv(x8, w8, scale, stride=1, pad=0, out_dtype=f32):
    """``dequant(conv(x8, w8), scale, out_dtype)``: int8 NHWC ``x8 [T, H,
    W, Cin]`` and HWIO ``w8 [k, k, Cin, Cout]``, the sums in int32, out
    NHWC ``[T, Ho, Wo, Cout]`` in ``out_dtype``.

    A CPU ``x8`` takes the plain version (any kernel size, stride and
    padding); a CUDA ``x8`` launches ``tao_conv_s8_sm90`` (k in 1, 3, 7,
    stride 1 or 2, ``pad = (k - 1) // 2``, Cout a multiple of 16, f32 or
    bf16 out) or this raises.  ``launches`` counts the conv's launches,
    here and in :func:`quantized_conv`.
    """
    if x8.device.type == "cpu":
        return int8_conv_reference(x8, w8, scale, stride, pad, out_dtype)
    if x8.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x8.device}")
    _check(x8, w8, scale, stride, pad, out_dtype)
    cin, ks = x8.shape[-1], w8.shape[0]
    wk = kernel_weights(w8)
    cp = wk.shape[1] // (ks * ks)
    x8 = resnet_blocks._aligned(F.pad(x8, (0, cp - cin)) if cp != cin
                                else x8)
    return _conv_s8(x8, wk, scale.contiguous(), None, ks, stride, out_dtype)


int8_conv.launches = 0


def quantize_activation_s8_torch(x, act_scale=None, channels=CHANNELS):
    """Plain version of :func:`quantize_activation_s8`:
    :func:`quantize_activation` of the NHWC view of NCHW ``x``, its
    channels zero-padded to a multiple of ``channels``."""
    x8, s_x = quantize_activation(x.permute(0, 2, 3, 1), act_scale)
    cin = x8.shape[-1]
    cp = -(-cin // channels) * channels
    return (F.pad(x8, (0, cp - cin)) if cp != cin else x8), s_x


def quantize_activation_s8(x, act_scale=None, channels=CHANNELS):
    """NCHW ``x [T, C, H, W]`` (f32 or bf16, any strides) -> (int8 NHWC
    ``x8 [T, H, W, Cp]``, ``Cp`` = C rounded up to ``channels`` with zero
    channels; f32 0-d ``s_x`` on ``x``'s device), as
    :func:`quantize_activation_s8_torch`.

    A CPU ``x`` takes the plain version; a CUDA ``x`` launches
    ``tao_quantize_s8`` once (the abs-max over the whole batch, skipped
    for a static ``act_scale``, and the quantizing pass that computes
    ``s_x`` on the device) or this raises.  One call counts one launch.
    """
    if x.device.type == "cpu":
        return quantize_activation_s8_torch(x, act_scale, channels)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_activation_s8: unsupported device "
                         f"{x.device}")
    if x.dtype not in OUT_DTYPES or x.dim() != 4:
        raise ValueError(f"quantize_activation_s8: want f32 or bf16 [T, C, "
                         f"H, W], got {x.dtype} {tuple(x.shape)}")
    T, C, H, W = x.shape
    if channels % 4:
        raise ValueError(f"quantize_activation_s8: channels={channels} must "
                         f"be a multiple of 4")
    cp = -(-C // channels) * channels
    dev = x.device
    out = torch.empty((T, H, W, cp), dtype=torch.int8, device=dev)
    # s_x, then the grid-wide barrier's state, which the call zeroes.
    s_x = torch.empty(4, dtype=f32, device=dev)
    err = _build.library().tao_quantize_s8(
        x.data_ptr(), int(x.dtype == torch.bfloat16), s_x.data_ptr(),
        out.data_ptr(), T, C, H, W, *x.stride(), cp,
        0.0 if act_scale is None else float(act_scale),
        int(act_scale is None), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("tao_quantize_s8", err)
    quantize_activation_s8.launches += 1
    return out, s_x[0]


quantize_activation_s8.launches = 0


def quantized_conv_reference(x, w8, s_w, stride=1, pad=0, out_dtype=f32,
                             act_scale=None):
    """Plain version of :func:`quantized_conv`: :func:`quantize_activation`
    of the NHWC view of ``x``, then :func:`int8_conv_reference` with the
    scale ``s_x * s_w``, as ``_int8_conv`` computes it."""
    x8, s_x = quantize_activation(x.permute(0, 2, 3, 1), act_scale)
    return int8_conv_reference(x8, w8, s_x * s_w, stride, pad,
                               out_dtype).permute(0, 3, 1, 2)


def quantized_conv(x, w8, s_w, stride=1, pad=0, out_dtype=f32,
                   act_scale=None, xq=None):
    """JAX's ``_int8_conv`` on NCHW ``x [T, Cin, H, W]`` (f32 or bf16, any
    strides): the activation quantized with one scale over the whole
    batch (or the static ``act_scale``), the int8 conv with HWIO ``w8`` and
    f32 ``s_w [Cout]`` from :func:`quantize_weight`, dequantized to
    ``out_dtype``.  Returns NCHW ``[T, Cout, Ho, Wo]`` (an NHWC tensor's
    view on the card).

    ``xq``, where given, is ``quantize_activation_s8(x, act_scale)``,
    computed once by a caller whose two convs read the same ``x`` at the
    same scale; this conv then quantizes nothing (the function is
    deterministic, so the result is the same bit for bit).

    A CPU ``x`` takes the plain version (:func:`quantized_conv_reference`,
    or :func:`int8_conv_reference` of ``xq``); a CUDA ``x`` runs
    :func:`quantize_activation_s8` (unless ``xq``) and the conv of
    :func:`int8_conv` (k in 1, 3, 7, stride 1 or 2, ``pad = (k - 1) //
    2``, Cout a multiple of 16), the conv taking ``s_x`` and ``s_w`` from
    device memory, or this raises.  One call counts one launch here, one
    in :func:`int8_conv` and, unless ``xq``, one in
    :func:`quantize_activation_s8`.
    """
    if x.device.type == "cpu":
        if xq is None:
            return quantized_conv_reference(x, w8, s_w, stride, pad,
                                            out_dtype, act_scale)
        x8, s_x = xq
        return int8_conv_reference(x8[..., :x.shape[1]], w8, s_x * s_w,
                                   stride, pad, out_dtype).permute(0, 3, 1, 2)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_conv: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"quantized_conv: want NCHW x, got "
                         f"{tuple(x.shape)}")
    _check(x.permute(0, 2, 3, 1), w8, s_w, stride, pad, out_dtype,
           "quantized_conv", OUT_DTYPES)
    ks = w8.shape[0]
    x8, s_x = quantize_activation_s8(x, act_scale) if xq is None else xq
    wk = kernel_weights(w8)
    out = _conv_s8(x8, wk, s_w.contiguous(), s_x, ks, stride, out_dtype)
    quantized_conv.launches += 1
    return out.permute(0, 3, 1, 2)


quantized_conv.launches = 0
