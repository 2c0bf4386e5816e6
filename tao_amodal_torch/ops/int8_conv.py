"""The int8 trunk's quantized convolution and its plain version.

Port of ``_int8_conv`` (``tao_amodal_tpu/models/backbones.py:58-84``),
the body of every ``ConvBN`` of the trunk that
``ClipDetector(int8_backbone=True)`` builds, as four plain functions:

* :func:`quantize_weight`: per-output-channel scales of the f32 HWIO
  ``qkernel``, ``s_w = max(max|w|, 1e-8) / 127``, and ``w8 = clip(
  round(w / s_w), -127, 127)``;
* :func:`quantize_activation`: one scale for the whole batch (the clip,
  or the ``[B*T]`` frames of ``batched``), the abs-max over every
  element ``/ 127``, or a static ``act_scale`` as JAX takes it; the
  scale stays a tensor on the input's device;
* :func:`int8_conv`: the int8 x int8 convolution summed in int32, then
  :func:`dequant`;
* :func:`dequant`: ``float(acc) * (s_x * s_w[c])`` cast to the module's
  dtype, JAX's order of operations.

Rounding is half to even on both sides (``torch.round`` as
``jnp.round``), and the quotients are true f32 divisions, as in JAX.

Kernel: ``csrc/resnet_blocks.cu::tao_conv_s8``, the trunk form of kernel
B7's implicit-GEMM ``mma.sync`` m16n8k32 s8 conv: stride 1 or 2, kernel
1, 3 or 7 with padding ``(k - 1) // 2``, and a dequantizing epilogue
that writes f32, or bf16 rounded to nearest.  It replaces no Pallas
kernel: it computes the XLA ``conv_general_dilated`` of ``_int8_conv``,
which on the card must run somewhere, since PyTorch has no int8
convolution on CUDA.  int32 sums are exact in any order, split K
included, so the kernel equals its plain version bit for bit.  The
kernel takes Cin and Cout in multiples of 16: the wrapper zero-pads a
narrower input's channels (the classic stem's 3) and the weights', which
leaves every sum unchanged.  The weights are laid out ``[Cout, K]`` (k
contiguous) once per set of quantized weights, not on every call.

Bound: a ResNet-50 trunk at 512^2, T=8 is about 1.7e11 multiply-adds
(0.17 ms of int8 tensor-core peak), while its convs read int8 and write
f32 activations of several GB: bytes set the floor.  The plain version
takes its dots in float64, exact for these sums (|acc| <= 127^2 * K <
2**53) on the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tao_amodal_torch import _build
from tao_amodal_torch.ops import fused_stage, resnet_blocks
from tao_amodal_torch.utils.weights import derived

f32, f64 = torch.float32, torch.float64
KERNEL_SIZES = (1, 3, 7)
STRIDES = (1, 2)
OUT_DTYPES = (torch.float32, torch.bfloat16)
# The kernel's channel multiple: a 16-byte copy chunk of int8 lies in one
# tap.
CHANNELS = resnet_blocks.CHANNEL_MULTIPLE[torch.int8]


def quantize_weight(w):
    """f32 HWIO ``w [kh, kw, Cin, Cout]`` -> (int8 ``w8`` HWIO, f32
    ``s_w [Cout]``)."""
    w = w.to(f32)
    w_max = w.abs().amax(dim=(0, 1, 2), keepdim=True)
    s_w = w_max.clamp_min(1e-8) / 127.0
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
        s_x = x.abs().amax().clamp_min(1e-8) / 127.0
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


def _check(x8, w8, scale, stride, pad, out_dtype):
    """Raise unless the kernel takes these operands."""
    if x8.dtype != torch.int8 or x8.dim() != 4:
        raise ValueError(f"int8_conv: want int8 [T, H, W, C], got "
                         f"{x8.dtype} {tuple(x8.shape)}")
    if (w8.dtype != torch.int8 or w8.dim() != 4
            or w8.shape[0] != w8.shape[1] or w8.shape[2] != x8.shape[-1]):
        raise ValueError(f"int8_conv: want int8 HWIO [k, k, {x8.shape[-1]}, "
                         f"Cout], got {w8.dtype} {tuple(w8.shape)}")
    ks, cout = w8.shape[0], w8.shape[3]
    if ks not in KERNEL_SIZES or stride not in STRIDES or pad != (ks - 1) // 2:
        raise ValueError(f"int8_conv: kernel {ks}, stride {stride}, pad "
                         f"{pad}; the kernel takes sizes {KERNEL_SIZES}, "
                         f"strides {STRIDES} and pad (k - 1) // 2")
    if cout % CHANNELS:
        raise ValueError(f"int8_conv: Cout={cout} must be a multiple of "
                         f"{CHANNELS}")
    if (scale.dtype != f32 or tuple(scale.shape) != (cout,)
            or scale.device != x8.device or w8.device != x8.device):
        raise ValueError(f"int8_conv: scale {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}, weights on "
                         f"{w8.device}; want f32 [{cout}] beside x on "
                         f"{x8.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_conv: out_dtype {out_dtype} not in "
                         f"{OUT_DTYPES}")
    if max(x8.shape[1:3]) >= 1 << 15:  # the kernel packs (y, x) in 16 bits
        raise ValueError(f"int8_conv: frames up to 32767 pixels a side, got "
                         f"{tuple(x8.shape[1:3])}")


def int8_conv(x8, w8, scale, stride=1, pad=0, out_dtype=f32):
    """``dequant(conv(x8, w8), scale, out_dtype)``: int8 NHWC ``x8 [T, H,
    W, Cin]`` and HWIO ``w8 [k, k, Cin, Cout]``, the sums in int32, out
    NHWC ``[T, Ho, Wo, Cout]`` in ``out_dtype``.

    A CPU ``x8`` takes the plain version (any kernel size, stride and
    padding); a CUDA ``x8`` launches ``tao_conv_s8`` (k in 1, 3, 7, stride
    1 or 2, ``pad = (k - 1) // 2``, Cout a multiple of 16, f32 or bf16
    out) or this raises.  One call counts one launch.
    """
    if x8.device.type == "cpu":
        return int8_conv_reference(x8, w8, scale, stride, pad, out_dtype)
    if x8.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x8.device}")
    _check(x8, w8, scale, stride, pad, out_dtype)
    T, Hi, Wi, cin = x8.shape
    ks, cout = w8.shape[0], w8.shape[3]
    wk = kernel_weights(w8)
    cp = wk.shape[1] // (ks * ks)
    x8 = resnet_blocks._aligned(F.pad(x8, (0, cp - cin)) if cp != cin
                                else x8)
    Ho = (Hi + 2 * pad - ks) // stride + 1
    Wo = (Wi + 2 * pad - ks) // stride + 1
    P = T * Ho * Wo
    dev = x8.device
    sms = fused_stage._sm_count(dev.index if dev.index is not None
                                else torch.cuda.current_device())
    plan = resnet_blocks.conv_plan(P, cp, cout, ks, 1, sms)
    scale = scale.contiguous()
    out = torch.empty((T, Ho, Wo, cout), dtype=out_dtype, device=dev)
    tiles = (-(-P // fused_stage.BM) * -(-cout // plan.bn)
             if plan.splits > 1 else 0)
    ws = (torch.empty(plan.workspace + -(-tiles // 4) * 4,
                      dtype=torch.int32, device=dev) if tiles else None)
    err = _build.library().tao_conv_s8(
        x8.data_ptr(), wk.data_ptr(), scale.data_ptr(),
        out.data_ptr(), ws.data_ptr() if tiles else None,
        ws[plan.workspace:].data_ptr() if tiles else None,
        T, Hi, Wi, cp, Ho, Wo, cout, ks, stride,
        int(out_dtype == torch.bfloat16), plan.bn, plan.splits, plan.slices,
        tiles, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("tao_conv_s8", err)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
