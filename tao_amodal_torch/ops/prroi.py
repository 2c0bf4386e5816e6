"""PrRoI pooling kernels B2, B5 and B6 and their plain versions.

The CUDA kernels of ``csrc/prroi.cu`` pool h-major ``[T, H, W, C]``
maps for three entry points, each the counterpart of a
TPU kernel of ``tao_amodal_tpu/ops/pallas/prroi.py`` that computes the
same function on its own layout:

* :func:`prroi_packed` replaces ``prroi_packed_fused`` (B2, the serving
  path, reached through ``prroi_packed_autodiff_t``);
* :func:`prroi_packed_pallas` replaces ``prroi_packed_pallas`` (B5, the
  detector's ``pallas_pooling=True``);
* :func:`prroi_pool_pallas` replaces ``prroi_pool_pallas`` (B6, the
  per-level ``multilevel_roi_align(method="prroi_pallas")``).

The TPU kernels hold the whole map in VMEM and run dense contractions;
on the H100 the op is bound by map reads, so the CUDA kernel sums only
the pixels under each bin's hat support (the sparse form of the
reference CUDA PrRoIPool op), clamped to the map: pixels outside it are
the zeros the plain integral adds.  f32 maps go to ``tao_prroi_f32``:
one block per (frame, RoI, bin row), which computes the row's x weights
once and reads each pixel of the row's support once for all its bins,
four channels a thread.  bf16 maps go to ``tao_prroi_bf16``: one block
per (frame, RoI, bin row), which computes each column's y-sum once for
the row's bins, then a warp a bin sums the bin over its own support,
eight channels a thread (one 16-byte load); it keeps each entry point's
TPU rounding points on bf16 maps, where the three compute different
functions:

* B2 rounds only the x weights (the long axis of its w-major canvas) to
  bf16, keeps the sum in f32 and returns bf16;
* B5 rounds both weights and each column's y-sum to bf16 and returns
  bf16;
* B6 rounds both weights, keeps the sum in f32 and returns f32.

Each wrapper counts its f32 launches in ``launches`` and its bf16
launches in ``bf16.launches``.

Gradients follow the JAX package.  B2 is ``prroi_packed_autodiff(_t)``
there: the kernel forward, and as backward the VJP of the plain
``prroi_pool(canvas, rois, S, 1.0)`` cast to the output's dtype
(``_prroi_autodiff_bwd``), with respect to the map and the RoI
coordinates; :func:`prroi_packed` is that ``torch.autograd.Function``
on both devices.  Its backward recomputes the plain forward under
autograd, in PyTorch (a CUDA backward kernel waits until a training step
is measured).  B5 and B6 are bare ``pallas_call``s in JAX, which cannot
differentiate them: on a CUDA map their wrappers raise under grad.
"""

from __future__ import annotations

import types

import torch
from torch.profiler import record_function

from tao_amodal_torch import _build
from tao_amodal_torch.ops.roi import prroi_pool, prroi_rounded

# The profiler range of B2's backward (the plain version's autograd).
BACKWARD_RANGE = "prroi_packed:backward"
# Shared memory of a block, at most 227 KB on the H100.
SMEM_LIMIT = 227 * 1024
# The bf16 kernel's form of each entry point (csrc/prroi.cu).
BF16_FORMS = {"prroi_packed": 0, "prroi_packed_pallas": 1,
              "prroi_pool_pallas": 2}
# csrc/prroi.cu's bf16 blocks: a warp a bin, at most 8 warps, and the
# y-sums of 32 columns of 256 channels in f32.
BF16_WARPS, BF16_SUMS_BYTES = 8, 32 * 1024


def smem_bytes(Hc, Wc, out_size, bf16):
    """Shared memory of a kernel block on an ``[Hc, Wc]`` map with
    ``out_size`` bins a side: f32, 8 weights of every map column; bf16
    (``bf16_smem_bytes`` of ``csrc/prroi.cu``), the columns' y-sums, the
    bin row's y weights and each warp's bin's x weights."""
    if not bf16:
        return Wc * 8 * 4
    return BF16_SUMS_BYTES + 4 * (Hc + min(out_size, BF16_WARPS) * Wc)


def _launch(name, features, rois, out_size):
    """``tao_prroi_f32`` or ``tao_prroi_bf16`` (the form of entry point
    ``name``) on a CUDA map ``[H, W, C]`` or ``[T, H, W, C]`` with RoIs
    ``[R, 4]`` or ``[T, R, 4]`` in map coordinates; raises on what the
    kernel does not take."""
    if features.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {features.device}")
    bf16 = features.dtype == torch.bfloat16
    if ((features.dtype != torch.float32 and not bf16)
            or features.dim() not in (3, 4)
            or rois.dim() != features.dim() - 1):
        raise ValueError(f"{name}: want f32 or bf16 [(T,) H, W, C] and "
                         f"rois [(T,) R, 4], got {features.dtype} "
                         f"{tuple(features.shape)} and {tuple(rois.shape)}")
    batched = features.dim() == 4
    canvas = features if batched else features[None]
    boxes = rois if batched else rois[None]
    T, Hc, Wc, C = canvas.shape
    if (boxes.shape[0] != T or boxes.shape[-1] != 4
            or rois.device != features.device):
        raise ValueError(f"{name}: want rois [(T={T},) R, 4] on "
                         f"{features.device}, got {tuple(rois.shape)} on "
                         f"{rois.device}")
    R = boxes.shape[1]
    if max(T, R) > 65535:  # grids (., R, T): y and z are 16-bit
        raise ValueError(f"{name}: at most 65535 frames and RoIs per "
                         f"frame, got T={T}, R={R}")
    vec = 8 if bf16 else 4
    if (C % vec or out_size < 1
            or smem_bytes(Hc, Wc, out_size, bf16) > SMEM_LIMIT):
        raise ValueError(f"{name}: want C % {vec} == 0 (16-byte channel "
                         f"loads), out_size >= 1 and a block's shared "
                         f"memory within {SMEM_LIMIT} bytes, got C={C}, "
                         f"H={Hc}, W={Wc}, out_size={out_size}")
    canvas = canvas.contiguous()
    if canvas.data_ptr() % 16:
        canvas = canvas.clone()
    boxes = boxes.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    lib = _build.library()
    if bf16:
        form = BF16_FORMS[name]
        out = torch.empty((T, R, out_size, out_size, C),
                          dtype=torch.float32 if form == 2 else torch.bfloat16,
                          device=canvas.device)
        err = lib.tao_prroi_bf16(canvas.data_ptr(), boxes.data_ptr(),
                                 out.data_ptr(), T, Hc, Wc, C, R, out_size,
                                 form, stream)
        _build.check("tao_prroi_bf16", err)
    else:
        out = torch.empty((T, R, out_size, out_size, C),
                          dtype=torch.float32, device=canvas.device)
        err = lib.tao_prroi_f32(canvas.data_ptr(), boxes.data_ptr(),
                                out.data_ptr(), T, Hc, Wc, C, R, out_size,
                                stream)
        _build.check("tao_prroi_f32", err)
    return out if batched else out[0]


def _forward_only(name, *tensors):
    """Raise where autograd would record a kernel that has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel is forward only (JAX cannot "
                         f"differentiate it either); run it under "
                         f"torch.no_grad()")


def _count(fn, features):
    (fn.bf16 if features.dtype == torch.bfloat16 else fn).launches += 1


def prroi_packed_torch(canvas, rois, out_size=7):
    """Plain version of B2: ``canvas [T, Hc, Wc, C]`` (h-major), ``rois
    [T, R, 4]`` xyxy in canvas coordinates -> ``[T, R, S, S, C]`` in the
    canvas dtype (bf16: JAX's ``_fused_kernel`` on its w-major canvas,
    x weights rounded, the sums in f32, times the f32 reciprocal of the
    bin area)."""
    if canvas.dtype == torch.float32:
        return prroi_pool(canvas, rois, out_size, 1.0)
    return prroi_rounded(canvas, rois, out_size, x_first=True,
                         round_y=False, round_mid=False,
                         inv_area=True).to(canvas.dtype)


def _prroi_packed_forward(canvas, rois, out_size):
    if canvas.device.type == "cpu":
        return prroi_packed_torch(canvas, rois, out_size)
    if canvas.dim() != 4:
        raise ValueError(f"prroi_packed: want [T, Hc, Wc, C], got "
                         f"{tuple(canvas.shape)}")
    out = _launch("prroi_packed", canvas, rois, out_size)
    _count(prroi_packed, canvas)
    return out


class _PrRoIPacked(torch.autograd.Function):
    """B2's forward, JAX's ``_prroi_autodiff_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, canvas, rois, out_size):
        ctx.save_for_backward(canvas, rois)
        ctx.out_size = out_size
        return _prroi_packed_forward(canvas, rois, out_size)

    @staticmethod
    def backward(ctx, grad):
        canvas, rois = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        with torch.enable_grad(), record_function(BACKWARD_RANGE):
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip((canvas, rois), needs)]
            out = prroi_pool(*inputs, ctx.out_size, 1.0).to(grad.dtype)
            wrt = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(got) if n else None for n in needs), None)


def prroi_packed(canvas, rois, out_size=7):
    """Kernel B2 (same contract as :func:`prroi_packed_torch`).

    A CPU canvas takes the plain version; a CUDA canvas launches the
    kernel (or this raises).  Differentiable in the canvas and the RoIs
    on both devices, as JAX's ``prroi_packed_autodiff``: the backward is
    the autograd of the plain ``prroi_pool(canvas, rois, out_size, 1.0)``
    cast to the output's dtype, which it recomputes (on a bf16 canvas
    that is not the rounded forward's own derivative, as in JAX).
    """
    if torch.is_grad_enabled() and (canvas.requires_grad
                                    or rois.requires_grad):
        return _PrRoIPacked.apply(canvas, rois, out_size)
    return _prroi_packed_forward(canvas, rois, out_size)


def prroi_packed_pallas_torch(features, rois, out_size=7):
    """Plain version of B5: the packed canvas ``[(T,) H, W, C]`` and
    ``rois [(T,) R, 4]`` in canvas coordinates -> ``[(T,) R, S, S, C]``
    in the feature dtype (bf16: JAX's ``_packed_kernel``, both weights
    rounded, y contracted first and each column's sum rounded)."""
    if features.dtype == torch.float32:
        return prroi_pool(features, rois, out_size, 1.0)
    return prroi_rounded(features, rois, out_size,
                         x_first=False).to(features.dtype)


def prroi_packed_pallas(features, rois, out_size=7):
    """Kernel B5 (same contract as :func:`prroi_packed_pallas_torch`).

    A CPU map takes the plain version; a CUDA map launches the kernel
    (or this raises; under grad too, as JAX cannot differentiate B5).
    """
    if features.device.type == "cpu":
        return prroi_packed_pallas_torch(features, rois, out_size)
    _forward_only("prroi_packed_pallas", features, rois)
    out = _launch("prroi_packed_pallas", features, rois, out_size)
    _count(prroi_packed_pallas, features)
    return out


def prroi_pool_pallas_torch(features, rois, out_size=7, spatial_scale=1.0):
    """Plain version of B6: one level ``[(T,) H, W, C]``, image-space
    ``rois [(T,) R, 4]`` scaled by ``spatial_scale`` in f32 ->
    ``[(T,) R, S, S, C]`` f32 (bf16 maps: JAX's ``_kernel``, both
    weights rounded, the sums in f32)."""
    if features.dtype == torch.float32:
        return prroi_pool(features, rois, out_size, spatial_scale)
    return prroi_rounded(features, rois, out_size, spatial_scale,
                         x_first=False, round_mid=False)


def prroi_pool_pallas(features, rois, out_size=7, spatial_scale=1.0):
    """Kernel B6 (same contract as :func:`prroi_pool_pallas_torch`).

    A CPU map takes the plain version; a CUDA map launches the kernel on
    the scaled RoIs (or this raises; under grad too, as JAX cannot
    differentiate B6).  A RoI that crosses the map's edge integrates
    zeros outside it.
    """
    if features.device.type == "cpu":
        return prroi_pool_pallas_torch(features, rois, out_size,
                                       spatial_scale)
    _forward_only("prroi_pool_pallas", features, rois)
    out = _launch("prroi_pool_pallas", features,
                  rois.to(torch.float32) * spatial_scale, out_size)
    _count(prroi_pool_pallas, features)
    return out


for _fn in (prroi_packed, prroi_packed_pallas, prroi_pool_pallas):
    _fn.launches = 0
    _fn.bf16 = types.SimpleNamespace(launches=0)
