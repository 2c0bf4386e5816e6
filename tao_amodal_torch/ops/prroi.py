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
the zeros the plain integral adds.  It runs one block per (frame, RoI,
bin row), which computes the row's x weights once and reads each pixel
of the row's support once for all its bins.  f32 maps go to
``tao_prroi_f32`` (four channels a thread); bf16 maps to
``tao_prroi_bf16`` (eight channels a thread, one 16-byte load), which
keeps each entry point's TPU rounding points on bf16 maps, where the
three compute different functions:

* B2 rounds only the x weights (the long axis of its w-major canvas) to
  bf16, keeps the sum in f32 and returns bf16;
* B5 rounds both weights and each column's y-sum to bf16 and returns
  bf16;
* B6 rounds both weights, keeps the sum in f32 and returns f32.

Each wrapper counts its f32 launches in ``launches`` and its bf16
launches in ``bf16.launches``.  Forward only: the port serves, it does
not train.
"""

from __future__ import annotations

import types

import torch

from tao_amodal_torch import _build
from tao_amodal_torch.ops.roi import prroi_pool, prroi_rounded

# Shared memory of a block, at most 227 KB on the H100: 8 weights of
# every map column (and, for bf16 maps, one of every row).
SMEM_LIMIT = 227 * 1024
# The bf16 kernel's form of each entry point (csrc/prroi.cu).
BF16_FORMS = {"prroi_packed": 0, "prroi_packed_pallas": 1,
              "prroi_pool_pallas": 2}


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
    if max(T, R) > 65535:  # grid (S*ceil(S/8), R, T): y and z are 16-bit
        raise ValueError(f"{name}: at most 65535 frames and RoIs per "
                         f"frame, got T={T}, R={R}")
    vec = 8 if bf16 else 4
    smem = (Wc * 8 + (Hc if bf16 else 0)) * 4
    if C % vec or smem > SMEM_LIMIT or out_size < 1:
        raise ValueError(f"{name}: want C % {vec} == 0 (16-byte channel "
                         f"loads), (8 W{' + H' if bf16 else ''}) * 4 bytes "
                         f"of weights within {SMEM_LIMIT} and out_size >= 1,"
                         f" got C={C}, H={Hc}, W={Wc}, out_size={out_size}")
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


def prroi_packed(canvas, rois, out_size=7):
    """Kernel B2 (same contract as :func:`prroi_packed_torch`).

    A CPU canvas takes the plain version; a CUDA canvas launches the
    kernel (or this raises).
    """
    if canvas.device.type == "cpu":
        return prroi_packed_torch(canvas, rois, out_size)
    if canvas.dim() != 4:
        raise ValueError(f"prroi_packed: want [T, Hc, Wc, C], got "
                         f"{tuple(canvas.shape)}")
    out = _launch("prroi_packed", canvas, rois, out_size)
    _count(prroi_packed, canvas)
    return out


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
    (or this raises).
    """
    if features.device.type == "cpu":
        return prroi_packed_pallas_torch(features, rois, out_size)
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
    the scaled RoIs (or this raises).  A RoI that crosses the map's edge
    integrates zeros outside it.
    """
    if features.device.type == "cpu":
        return prroi_pool_pallas_torch(features, rois, out_size,
                                       spatial_scale)
    out = _launch("prroi_pool_pallas", features,
                  rois.to(torch.float32) * spatial_scale, out_size)
    _count(prroi_pool_pallas, features)
    return out


for _fn in (prroi_packed, prroi_packed_pallas, prroi_pool_pallas):
    _fn.launches = 0
    _fn.bf16 = types.SimpleNamespace(launches=0)
