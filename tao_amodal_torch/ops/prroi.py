"""PrRoI pooling over the packed canvas: kernel B2 and its plain version.

Kernel: ``csrc/prroi.cu`` replaces the TPU kernel
``tao_amodal_tpu/ops/pallas/prroi.py::prroi_packed_fused`` (the serving
path, reached through ``prroi_packed_autodiff_t``), and with it
``prroi_packed_pallas`` and ``prroi_pool_pallas``, which pool the same
function on other layouts.  The TPU kernel holds the whole canvas in
VMEM and runs two dense contractions; on the H100 the op is bound by
canvas reads, so the CUDA kernel runs one block per (frame, RoI, bin)
with threads over channels and sums only the <= (ceil(bin)+2)^2 pixels
under each bin's hat support (the sparse per-bin form of the reference
CUDA PrRoIPool op).  Forward only: the port serves, it does not train.
"""

from __future__ import annotations

import torch

from tao_amodal_torch import _build
from tao_amodal_torch.ops.roi import prroi_pool


def prroi_packed_torch(canvas, rois, out_size=7):
    """Plain version: ``canvas [T, Hc, Wc, C]`` (h-major), ``rois
    [T, R, 4]`` xyxy in canvas coordinates -> ``[T, R, S, S, C]``."""
    return prroi_pool(canvas, rois, out_size, 1.0)


def prroi_packed(canvas, rois, out_size=7):
    """Kernel wrapper (same contract as :func:`prroi_packed_torch`).

    A CPU canvas takes the plain version; a CUDA canvas launches the
    kernel (or this raises).
    """
    if canvas.device.type == "cpu":
        return prroi_packed_torch(canvas, rois, out_size)
    if canvas.device.type != "cuda":
        raise ValueError(f"prroi_packed: unsupported device "
                         f"{canvas.device}")
    if canvas.dtype != torch.float32 or canvas.dim() != 4:
        raise ValueError(f"prroi_packed: want f32 [T, Hc, Wc, C], got "
                         f"{canvas.dtype} {tuple(canvas.shape)}")
    T, Hc, Wc, C = canvas.shape
    if (rois.dim() != 3 or tuple(rois.shape[::2]) != (T, 4)
            or rois.device != canvas.device):
        raise ValueError(f"prroi_packed: want rois [T={T}, R, 4] on "
                         f"{canvas.device}, got {tuple(rois.shape)} on "
                         f"{rois.device}")
    R = rois.shape[1]
    if max(T, R) > 65535:  # grid (S*S, R, T): y and z are 16-bit
        raise ValueError(f"prroi_packed: at most 65535 frames and RoIs "
                         f"per frame, got T={T}, R={R}")
    canvas = canvas.contiguous()
    rois = rois.to(torch.float32).contiguous()
    out = torch.empty((T, R, out_size, out_size, C), dtype=torch.float32,
                      device=canvas.device)
    err = _build.library().tao_prroi_f32(
        canvas.data_ptr(), rois.data_ptr(), out.data_ptr(), T, Hc, Wc, C,
        R, out_size, torch.cuda.current_stream(canvas.device).cuda_stream)
    _build.check("tao_prroi_f32", err)
    prroi_packed.launches += 1
    return out


prroi_packed.launches = 0
