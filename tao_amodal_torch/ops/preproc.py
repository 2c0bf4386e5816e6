"""Frame preprocessing: resize -> letterbox pad -> normalize (kernel B1).

Port of :mod:`tao_amodal_tpu.ops.pallas.preproc` (classic-stem path):
the letterbox weight matrices are built with numpy exactly as the JAX
package builds them; :func:`preprocess_frames_torch` is the plain
two-einsum version, :func:`preprocess_frames` the kernel wrapper.

Kernel: ``csrc/preproc.cu`` replaces the TPU kernel
``tao_amodal_tpu/ops/pallas/preproc.py::preprocess_frames_pallas``.  It
is bound by device-memory bytes on the H100; each row of the resize
matrices has at most two nonzeros, so the wrapper turns the matrices
into (index, weight) taps on the host and the kernel gathers 2x2 taps
per output pixel instead of multiplying by mostly-zero matrices.  The
wrapper also passes the content extent (:func:`content_extent`): the
letterbox pad outside it is written without reading a frame.

The s2d stems' input (:func:`preprocess_clip_s2d`, JAX's
``preprocess_frames_xla_s2d``) is computed by XLA in the JAX package, not
by a TPU kernel, and here by plain PyTorch on either device; its kernel
form (B1 writing the folded layout in the trunk's dtype) is later work
(ROADMAP.md, Queue B #2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tao_amodal_torch import _build

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def _resize_weights(src, dst, scale):
    """Bilinear weight matrix ``[dst, src]`` for half-pixel centers
    (``tao_amodal_tpu/ops/pallas/preproc.py::_resize_weights``): rows
    past ``dst*scale`` sample out of range and get zero weight."""
    o = np.arange(dst) + 0.5
    src_coord = o / scale - 0.5
    idx = np.arange(src)
    w = np.maximum(0.0, 1.0 - np.abs(src_coord[:, None] - idx[None, :]))
    in_range = (src_coord >= -0.5) & (src_coord <= src - 0.5)
    row_sum = w.sum(axis=1, keepdims=True)
    w = np.where(row_sum > 0, w / np.maximum(row_sum, 1e-8), 0.0)
    w = w * in_range[:, None]
    return w.astype(np.float32)


def make_letterbox_weights(src_hw, dst):
    """(Wy ``[dstH, H]``, Wx ``[dstW, W]``, scale) numpy f32 matrices for
    an aspect-preserving letterbox into ``dst x dst`` (int) or
    ``(dstH, dstW)``."""
    H, W = src_hw
    dst_h, dst_w = (dst, dst) if isinstance(dst, int) else dst
    scale = min(dst_h / H, dst_w / W)
    return (_resize_weights(H, dst_h, scale),
            _resize_weights(W, dst_w, scale), scale)


def resize_taps(w):
    """``[dst, src]`` resize matrix -> (``[dst, 2]`` int32 indices,
    ``[dst, 2]`` f32 weights): the (at most two) nonzeros of each row.
    A row of zeros (letterbox pad) gets zero weights."""
    w = np.asarray(w, np.float32)
    nz = w != 0
    if (nz.sum(axis=1) > 2).any():
        raise ValueError("resize matrix has a row with more than two "
                         "nonzeros; the preproc kernel gathers 2 taps")
    rows = np.arange(w.shape[0])
    first = np.argmax(nz, axis=1)
    last = w.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
    w0 = w[rows, first]
    w1 = np.where(last != first, w[rows, last], 0.0)
    idx = np.stack([first, last], axis=1).astype(np.int32)
    return idx, np.stack([w0, w1], axis=1).astype(np.float32)


def content_extent(w):
    """``(lo, hi)``: the rows of a ``[dst, 2]`` tap-weight array (from
    :func:`resize_taps`) outside ``[lo, hi)`` have zero weights (the
    letterbox pad); ``(0, 0)`` when every row does."""
    nz = np.flatnonzero((np.asarray(w) != 0).any(axis=1))
    return (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)


@functools.lru_cache(maxsize=8)
def letterbox(src_hw, dst):
    """Cached :func:`make_letterbox_weights` for one geometry (every
    clip of a video shares it)."""
    return make_letterbox_weights(src_hw, dst)


@functools.lru_cache(maxsize=8)
def _kernel_operands(src_hw, dst, mean, std, device):
    """Device-resident taps and (mean, std) for one geometry, built once
    so that a launch issues no host-to-device copies, with the output
    size and the content extent ``(y_lo, y_hi, x_lo, x_hi)``."""
    wy, wx, _ = letterbox(src_hw, dst)
    yi, yw = resize_taps(wy)
    xi, xw = resize_taps(wx)
    taps = [torch.from_numpy(a).to(device) for a in (yi, yw, xi, xw)]
    norm = torch.tensor([*mean, *std], dtype=torch.float32, device=device)
    return (taps, norm, (wy.shape[0], wx.shape[0]),
            (*content_extent(yw), *content_extent(xw)))


def preprocess_frames_torch(frames, out_size, mean=IMAGENET_MEAN,
                            std=IMAGENET_STD):
    """Plain version: ``[T, H, W, 3]`` uint8 -> ``[T, S, S, 3]`` f32,
    ``(Wy . X . Wx^T - mean) / std`` per channel, as two einsums over
    the dense letterbox matrices."""
    dev = frames.device
    wy, wx, _ = letterbox(tuple(frames.shape[1:3]), out_size)
    wy = torch.from_numpy(wy).to(dev)
    wx = torch.from_numpy(wx).to(dev)
    mean = torch.tensor(mean, dtype=torch.float32, device=dev)
    std = torch.tensor(std, dtype=torch.float32, device=dev)
    f = frames.to(torch.float32)
    tmp = torch.einsum("oh,thwc->towc", wy, f)
    out = torch.einsum("pw,towc->topc", wx, tmp)
    return (out - mean) / std


def preprocess_frames(frames, out_size, mean=IMAGENET_MEAN,
                      std=IMAGENET_STD):
    """Kernel wrapper (same contract as :func:`preprocess_frames_torch`).

    ``frames`` on the CPU take the plain version; on a CUDA device the
    kernel runs (or this raises).
    """
    if frames.device.type == "cpu":
        return preprocess_frames_torch(frames, out_size, mean, std)
    if frames.device.type != "cuda":
        raise ValueError(f"preprocess_frames: unsupported device "
                         f"{frames.device}")
    if (frames.dtype != torch.uint8 or frames.dim() != 4
            or frames.shape[-1] != 3):
        raise ValueError(f"preprocess_frames: want uint8 [T, H, W, 3], "
                         f"got {frames.dtype} {tuple(frames.shape)}")
    T, H, W, _ = frames.shape
    frames = frames.contiguous()
    dev = frames.device
    taps, norm, (Sh, Sw), extent = _kernel_operands(
        (H, W), out_size, tuple(map(float, mean)), tuple(map(float, std)),
        dev)
    # One block holds its output row and two source rows in shared
    # memory (227 KB).
    lib = _build.library()
    if lib.tao_preproc_smem(W, Sw) > 227 * 1024:
        raise ValueError(f"preprocess_frames: W={W}, S={Sw} exceed the "
                         f"kernel's bound (12 S + 6 W bytes <= 227 KB)")
    out = torch.empty((T, Sh, Sw, 3), dtype=torch.float32, device=dev)
    err = lib.tao_preproc_f32(
        frames.data_ptr(), *[a.data_ptr() for a in taps], norm.data_ptr(),
        out.data_ptr(), T, H, W, Sh, Sw, *extent,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("tao_preproc_f32", err)
    preprocess_frames.launches += 1
    return out


preprocess_frames.launches = 0


def space_to_depth(x, block=4):
    """``[..., H, W, C] -> [..., H/b, W/b, C*b*b]``, channels in (c, by,
    bx) order with c slowest, the order of the JAX stem's weights."""
    *lead, h, w, c = x.shape
    b = block
    x = x.reshape(*lead, h // b, b, w // b, b, c)
    x = torch.movedim(x, (-4, -2), (-2, -1))
    return x.reshape(*lead, h // b, w // b, c * b * b)


@functools.lru_cache(maxsize=8)
def _s2d_operands(src_hw, dst, mean, std, block, dtype, device):
    """The resize matrices of one geometry rounded to ``dtype`` and
    reshaped for the fold (``[Sh/b, b, H]``, ``[Sw/b, b, W]``), and mean
    and std repeated over the ``b*b`` sub-channels, f32 on ``device``,
    built once (every clip of a video shares them)."""
    f32 = torch.float32
    wy, wx, _ = letterbox(src_hw, dst)

    def rounded(a):
        return torch.from_numpy(a).to(device).to(dtype).to(f32)

    rep = block * block
    return (rounded(wy).reshape(-1, block, src_hw[0]),
            rounded(wx).reshape(-1, block, src_hw[1]),
            torch.tensor(mean, dtype=f32, device=device).repeat_interleave(
                rep),
            torch.tensor(std, dtype=f32, device=device).repeat_interleave(
                rep))


def preprocess_frames_s2d(frames, out_size, mean=IMAGENET_MEAN,
                          std=IMAGENET_STD, block=4, dtype=torch.float32):
    """uint8 ``[T, H, W, 3]`` -> the letterboxed, normalized clip folded
    by :func:`space_to_depth`, ``[T, Sh/4, Sw/4, 48]`` in ``dtype``: two
    einsums whose resize matrices carry the fold.  In bf16 the frames
    and both matrices round to bf16, the first einsum's f32 sum rounds
    to bf16, the second stays f32, and mean/std apply in f32 before the
    last rounding: the products are taken in f32 on the rounded operands
    (keep TF32 off on the card), so that no bf16 matmul rounds its
    output where the JAX function does not."""
    f32 = torch.float32
    T, H, W, C = frames.shape
    dst = out_size if isinstance(out_size, int) else tuple(out_size)
    wy_b, wx_b, mean_b, std_b = _s2d_operands(
        (H, W), dst, tuple(map(float, mean)), tuple(map(float, std)), block,
        dtype, frames.device)
    f = frames.to(dtype).to(f32)
    tmp = torch.einsum("ybh,thwc->tybwc", wy_b, f).to(dtype).to(f32)
    out = torch.einsum("xaw,tybwc->tyxcba", wx_b, tmp)
    out = out.reshape(T, wy_b.shape[0], wx_b.shape[0], C * block * block)
    return ((out - mean_b) / std_b).to(dtype)


def preprocess_clip_s2d(frames, out_size=512, mean=IMAGENET_MEAN,
                        std=IMAGENET_STD, dtype=torch.float32):
    """uint8 clip ``[T, H, W, 3]`` -> (the ``s2d_pre`` stem's input
    ``[T, Sh/4, Sw/4, 48]`` in ``dtype``, scale)."""
    scale = letterbox(tuple(frames.shape[1:3]), out_size)[2]
    return preprocess_frames_s2d(frames, out_size, mean, std,
                                 dtype=dtype), scale


def preprocess_clip(frames, out_size=512, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD):
    """uint8 clip tensor ``[T, H, W, 3]`` -> (normalized letterboxed
    ``[T, S, S, 3]`` f32 on the clip's device, scale) where ``scale``
    maps output coords back to source pixels."""
    scale = letterbox(tuple(frames.shape[1:3]), out_size)[2]
    return preprocess_frames(frames, out_size, mean, std), scale
