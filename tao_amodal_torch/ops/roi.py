"""RoI pooling: Precise RoI Pooling over a multilevel feature pyramid.

Port of the serving-path part of :mod:`tao_amodal_tpu.ops.roi`.  PrRoI
pooling integrates the bilinearly interpolated feature surface over
each bin.  The bilinear hat basis is separable, so the integral over a
rectangle factors into per-axis weight vectors

    pool[bin] = (1/area) * g_y^T  F  g_x,
    g_x[i] = int_{x0}^{x1} max(0, 1-|x-i|) dx   (closed form),

which :func:`prroi_pool` evaluates as two dense einsums (the plain
version of the PrRoI kernels).  On bf16 maps each JAX route rounds at
its own points (:func:`prroi_rounded`), so the routes are different
functions there.  :func:`multilevel_roi_align` assigns
each RoI an FPN level and pools it there by one of the JAX package's
methods: over one zero-gapped canvas per frame (``"prroi_packed"`` and
``"prroi_packed_fused"``, the JAX name of kernel B2's route, through B2;
``"prroi_packed_pallas"`` through B5), or every RoI at every level
followed by a one-hot level select (``"prroi_pallas"`` through B6,
``"prroi"`` plain).  RoIAlign (the JAX fall-through for any other
method) is not ported (ROADMAP.md, Queue A #6): other names raise.
"""

from __future__ import annotations

import torch

METHODS = ("prroi_packed", "prroi_packed_fused", "prroi_packed_pallas",
           "prroi_pallas", "prroi")


def _hat_antideriv(u):
    """F(u) = integral_{-1}^{u} max(0, 1-|t|) dt, piecewise closed form."""
    u = u.clamp(-1.0, 1.0)
    neg = 0.5 * (u + 1.0) ** 2
    pos = 0.5 + u - 0.5 * u ** 2
    return torch.where(u <= 0, neg, pos)


def prroi_pool(features, rois, out_size=7, spatial_scale=1.0):
    """Precise RoI pooling as two dense einsums (JAX's
    ``ops/roi.py::prroi_pool``, the XLA ``"packed"`` route).

    Args:
      features: ``[..., H, W, C]`` feature map(s), f32 or bf16.
      rois: ``[..., R, 4]`` xyxy boxes (leading axes as ``features``),
        scaled by ``spatial_scale`` onto the feature grid.

    Returns ``[..., R, out_size, out_size, C]`` f32.  The longer spatial
    axis is contracted first; on a bf16 map both weights and that first
    contraction round to bf16.
    """
    H, W = features.shape[-3:-1]
    return prroi_rounded(features, rois, out_size, spatial_scale,
                         x_first=W >= H)


def prroi_rounded(features, rois, out_size=7, spatial_scale=1.0, *,
                  x_first, round_y=True, round_mid=True, inv_area=False):
    """PrRoI pooling, f32 output, with a JAX route's rounding points on a
    map whose dtype is not f32: the x weights (every route rounds them),
    the y weights (``round_y``) and the first contraction (over x with
    ``x_first``, ``round_mid``) round to the map's dtype, every sum is
    f32, and the bins divide by their area (``inv_area``: multiply by
    its f32 reciprocal).  On an f32 map the flags change nothing but the
    order of the contractions and the area's form."""
    H, W, _ = features.shape[-3:]
    dev = features.device
    dt, f32 = features.dtype, torch.float32

    def rounded(a, flag):
        return a.to(dt).to(f32) if flag and dt != f32 else a

    rois = rois.to(torch.float32) * spatial_scale
    x0, y0, x1, y1 = rois.unbind(-1)
    bw = ((x1 - x0) / out_size).clamp_min(1e-8)
    bh = ((y1 - y0) / out_size).clamp_min(1e-8)
    bins = torch.arange(out_size, dtype=torch.float32, device=dev)

    def axis_w(lo0, step, n):
        # [..., R, out, n] hat integrals per bin.
        lo = lo0[..., None] + bins * step[..., None]
        hi = lo + step[..., None]
        idx = torch.arange(n, dtype=torch.float32, device=dev)
        return (_hat_antideriv(hi[..., None] - idx)
                - _hat_antideriv(lo[..., None] - idx))

    wx = rounded(axis_w(x0, bw, W), True)
    wy = rounded(axis_w(y0, bh, H), round_y)
    features = features.to(f32)
    if x_first:
        tmp = rounded(torch.einsum("...rxw,...hwc->...rxhc", wx, features),
                      round_mid)
        out = torch.einsum("...ryh,...rxhc->...ryxc", wy, tmp)
    else:
        tmp = rounded(torch.einsum("...ryh,...hwc->...rywc", wy, features),
                      round_mid)
        out = torch.einsum("...rxw,...rywc->...ryxc", wx, tmp)
    area = (bw * bh)[..., None, None, None]
    return out * (1.0 / area) if inv_area else out / area


def canvas_layout(level_hw, gap=2):
    """Shelf layout of the packed canvas (``tao_amodal_tpu/ops/roi.py``
    ``multilevel_roi_align``): level 0 fills the left column, smaller
    levels stack vertically in further columns, 2-px zero gaps (the hat
    weights have +-1 px support, so levels cannot bleed).

    Returns ((canvas_h, canvas_w), [(oy, ox) per level]).
    """
    H = max(h for h, _ in level_hw)
    offs = []
    col_x, col_w, cur_y = 0, level_hw[0][1], 0
    for fh, fw in level_hw:
        if cur_y + fh > H:  # start a new column
            col_x += col_w + gap
            cur_y, col_w = 0, fw
        offs.append((cur_y, col_x))
        col_w = max(col_w, fw)
        cur_y += fh + gap
    return (H, col_x + col_w), offs


def level_targets(rois, num_levels, canonical_level=2,
                  canonical_size=224.0):
    """FPN level index (long, ``[..., R]``) of each xyxy RoI."""
    areas = ((rois[..., 2] - rois[..., 0])
             * (rois[..., 3] - rois[..., 1])).clamp_min(1e-6)
    target = torch.floor(canonical_level + torch.log2(
        torch.sqrt(areas) / canonical_size + 1e-8))
    return target.clamp(0, num_levels - 1).to(torch.long)


def multilevel_roi_align(pyramid, rois, canonical_level=2,
                         canonical_size=224.0, out_size=7,
                         strides=(4, 8, 16, 32), method="prroi_packed"):
    """FPN level assignment + PrRoI pooling.

    Args:
      pyramid: list of ``[T, h, w, C]`` levels (NHWC; strided views are
        fine).
      rois: ``[T, R, 4]`` xyxy in image coordinates.
      method: ``"prroi_packed"`` or ``"prroi_packed_fused"`` (the
        packed canvas through kernel B2: the JAX package's XLA and Pallas
        routes, one forward function in f32; on a bf16 pyramid
        ``"prroi_packed"`` is JAX's XLA function, :func:`prroi_pool`, in
        plain PyTorch, with an f32 output), ``"prroi_packed_pallas"`` (the
        canvas width rounded up to 16, as the JAX method pads it,
        through kernel B5), ``"prroi_pallas"`` (every RoI at every level
        through kernel B6, then a one-hot level select) or ``"prroi"``
        (the same through the plain :func:`prroi_pool`); the names of
        the JAX methods.

    Returns ``[T, R, out_size, out_size, C]``; every method equals
    pooling each RoI on its assigned level alone, up to its rounding
    points on a bf16 pyramid (B2 and B5 return bf16, the others f32).
    """
    from tao_amodal_torch.ops import prroi

    if method not in METHODS:
        raise ValueError(f"multilevel_roi_align: method {method!r} is not "
                         f"one of {METHODS}")
    if method in ("prroi_packed", "prroi_packed_fused",
                  "prroi_packed_pallas"):
        b5 = method == "prroi_packed_pallas"
        canvas, rois_p = pack_levels(pyramid, rois, canonical_level,
                                     canonical_size, strides,
                                     width_multiple=16 if b5 else 1)
        if b5:
            return prroi.prroi_packed_pallas(canvas, rois_p, out_size)
        if method == "prroi_packed" and canvas.dtype != torch.float32:
            return prroi_pool(canvas, rois_p, out_size, 1.0)
        return prroi.prroi_packed(canvas, rois_p, out_size)
    pool = prroi.prroi_pool_pallas if method == "prroi_pallas" else prroi_pool
    stacked = torch.stack([pool(f, rois, out_size, 1.0 / s)
                           for f, s in zip(pyramid, strides)])
    target = level_targets(rois, len(pyramid), canonical_level,
                           canonical_size)
    onehot = torch.nn.functional.one_hot(target, len(pyramid)).movedim(
        -1, 0).to(stacked.dtype)                            # [L, T, R]
    # An elementwise select, not a matmul: exact whatever the TF32 flags.
    return (stacked * onehot[..., None, None, None]).sum(0)


def pack_levels(pyramid, rois, canonical_level=2, canonical_size=224.0,
                strides=(4, 8, 16, 32), width_multiple=1):
    """The packed canvas ``[T, Hc, Wc, C]`` of :func:`canvas_layout` and
    each RoI moved onto its assigned level's rectangle of it (``[T, R,
    4]`` canvas coordinates): the operands of the pooling kernel.  Zero
    columns round the canvas width up to ``width_multiple``."""
    dev = rois.device
    target = level_targets(rois, len(pyramid), canonical_level,
                           canonical_size)
    (H, W), offs = canvas_layout([tuple(f.shape[1:3]) for f in pyramid])
    W = -(-W // width_multiple) * width_multiple
    T, C = pyramid[0].shape[0], pyramid[0].shape[-1]
    canvas = torch.zeros((T, H, W, C), dtype=pyramid[0].dtype, device=dev)
    for f, (oy, ox) in zip(pyramid, offs):
        canvas[:, oy:oy + f.shape[1], ox:ox + f.shape[2]] = f
    level = torch.tensor([[1.0 / s, oy, ox] for s, (oy, ox)
                          in zip(strides, offs)], dtype=torch.float32,
                         device=dev)[target]                 # [T, R, 3]
    inv_stride, off_y, off_x = level.unbind(-1)
    shift = torch.stack([off_x, off_y, off_x, off_y], dim=-1)
    return canvas, rois.to(torch.float32) * inv_stride[..., None] + shift
