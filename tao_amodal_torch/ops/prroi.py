"""PrRoI pooling kernels B2, B5 and B6 and their plain versions.

One CUDA kernel, ``csrc/prroi.cu`` (``tao_prroi_f32``), pools h-major
``[T, H, W, C]`` maps for three entry points, each the counterpart of a
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
of the row's support once for all its bins, four channels a thread.
f32, forward only: the port serves, it does not train; the bf16 forms
are queued.
"""

from __future__ import annotations

import torch

from tao_amodal_torch import _build
from tao_amodal_torch.ops.roi import prroi_pool

# The kernel keeps 8 weights of every map column in shared memory, at
# most 227 KB a block on the H100.
MAX_MAP_WIDTH = 227 * 1024 // 32


def _launch(name, features, rois, out_size):
    """``tao_prroi_f32`` on a CUDA map ``[H, W, C]`` or ``[T, H, W, C]``
    with RoIs ``[R, 4]`` or ``[T, R, 4]`` in map coordinates; raises on
    what the kernel does not take."""
    if features.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {features.device}")
    if (features.dtype != torch.float32 or features.dim() not in (3, 4)
            or rois.dim() != features.dim() - 1):
        raise ValueError(f"{name}: want f32 [(T,) H, W, C] and rois "
                         f"[(T,) R, 4], got {features.dtype} "
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
    if C % 4 or Wc > MAX_MAP_WIDTH or out_size < 1:
        raise ValueError(f"{name}: want C % 4 == 0 (float4 channels), a "
                         f"map at most {MAX_MAP_WIDTH} wide and out_size "
                         f">= 1, got C={C}, W={Wc}, out_size={out_size}")
    canvas = canvas.contiguous()
    if canvas.data_ptr() % 16:
        canvas = canvas.clone()
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((T, R, out_size, out_size, C), dtype=torch.float32,
                      device=canvas.device)
    err = _build.library().tao_prroi_f32(
        canvas.data_ptr(), boxes.data_ptr(), out.data_ptr(), T, Hc, Wc, C,
        R, out_size, torch.cuda.current_stream(canvas.device).cuda_stream)
    _build.check("tao_prroi_f32", err)
    return out if batched else out[0]


def prroi_packed_torch(canvas, rois, out_size=7):
    """Plain version of B2: ``canvas [T, Hc, Wc, C]`` (h-major), ``rois
    [T, R, 4]`` xyxy in canvas coordinates -> ``[T, R, S, S, C]``."""
    return prroi_pool(canvas, rois, out_size, 1.0)


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
    prroi_packed.launches += 1
    return out


def prroi_packed_pallas_torch(features, rois, out_size=7):
    """Plain version of B5: the packed canvas ``[(T,) H, W, C]`` f32 and
    ``rois [(T,) R, 4]`` in canvas coordinates -> ``[(T,) R, S, S, C]``
    in the feature dtype (f32)."""
    return prroi_pool(features, rois, out_size, 1.0)


def prroi_packed_pallas(features, rois, out_size=7):
    """Kernel B5 (same contract as :func:`prroi_packed_pallas_torch`).

    A CPU map takes the plain version; a CUDA map launches
    ``tao_prroi_f32`` (or this raises).  f32 only.
    """
    _want_f32("prroi_packed_pallas", features)
    if features.device.type == "cpu":
        return prroi_packed_pallas_torch(features, rois, out_size)
    out = _launch("prroi_packed_pallas", features, rois, out_size)
    prroi_packed_pallas.launches += 1
    return out


def prroi_pool_pallas_torch(features, rois, out_size=7, spatial_scale=1.0):
    """Plain version of B6: one level ``[(T,) H, W, C]`` f32, image-space
    ``rois [(T,) R, 4]`` scaled by ``spatial_scale`` in f32 ->
    ``[(T,) R, S, S, C]`` f32."""
    return prroi_pool(features, rois, out_size, spatial_scale)


def prroi_pool_pallas(features, rois, out_size=7, spatial_scale=1.0):
    """Kernel B6 (same contract as :func:`prroi_pool_pallas_torch`).

    A CPU map takes the plain version; a CUDA map launches
    ``tao_prroi_f32`` on the scaled RoIs (or this raises).  A RoI that
    crosses the map's edge integrates zeros outside it.  f32 only.
    """
    _want_f32("prroi_pool_pallas", features)
    if features.device.type == "cpu":
        return prroi_pool_pallas_torch(features, rois, out_size,
                                       spatial_scale)
    out = _launch("prroi_pool_pallas", features,
                  rois.to(torch.float32) * spatial_scale, out_size)
    prroi_pool_pallas.launches += 1
    return out


def _want_f32(name, features):
    if features.dtype != torch.float32:
        raise ValueError(f"{name}: f32 features only (the bf16 form is "
                         f"not ported), got {features.dtype}")


prroi_packed.launches = 0
prroi_packed_pallas.launches = 0
prroi_pool_pallas.launches = 0
