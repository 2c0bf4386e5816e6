"""PasteNOcclude: synthetic-occlusion augmentation for amodal training.

Port of :mod:`tao_amodal_tpu.train.paste_n_occlude`: occluders from a
bank of RGBA patches are pasted over a target (a coordinate-mapped
bilinear sample and an alpha blend), the visible (modal) boxes shrink to
what stays unoccluded, and the amodal targets stay the full boxes.

JAX draws inside its functions from PRNG keys; here the draws are
arguments (:func:`pno_draws` makes them from a ``torch.Generator``), so a
test can feed JAX's own: per sample ``u [G]`` (the target's pick), and
per occluder ``do`` (pasted or not), ``idx`` (which patch) and two
offsets, plus one ``scale`` a sample that every occluder of the sample
uses (JAX draws it from ``keys[-1]`` for each).  Every function takes
leading batch axes and runs on the device of its tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tao_amodal_torch.ops.resize import linear_resize_weights

f32 = torch.float32


def paste_patch(image, patch_rgba, center, scale):
    """Alpha-blend RGBA patches onto images.

    ``image [..., H, W, 3]``, ``patch_rgba [..., ph, pw, 4]``, ``center
    [..., 2]`` (x, y) and ``scale [...]``: patch coordinates map through
    (center, scale); out-of-patch samples are transparent.  Returns
    ``(image', occupancy mask [..., H, W])``."""
    H, W = image.shape[-3:-1]
    ph, pw = patch_rgba.shape[-3:-1]
    dev = image.device
    scale = scale[..., None]
    ys = ((torch.arange(H, dtype=f32, device=dev) - center[..., 1, None])
          / scale + ph / 2)
    xs = ((torch.arange(W, dtype=f32, device=dev) - center[..., 0, None])
          / scale + pw / 2)
    lead = ys.shape[:-1]
    X = xs[..., None, :].expand(*lead, H, W)
    Y = ys[..., :, None].expand(*lead, H, W)
    inb = (X >= 0) & (X < pw - 1) & (Y >= 0) & (Y < ph - 1)
    x0 = torch.floor(X).to(torch.int64).clamp(0, pw - 2)
    y0 = torch.floor(Y).to(torch.int64).clamp(0, ph - 2)
    wx = (X - x0)[..., None]
    wy = (Y - y0)[..., None]
    flat = patch_rgba.reshape(*patch_rgba.shape[:-3], ph * pw, 4)
    flat = flat.expand(*lead, ph * pw, 4)

    def at(yi, xi):
        idx = (yi * pw + xi).reshape(*lead, H * W, 1).expand(
            *lead, H * W, 4)
        return torch.gather(flat, -2, idx).reshape(*lead, H, W, 4)

    sample = ((1 - wy) * ((1 - wx) * at(y0, x0) + wx * at(y0, x0 + 1))
              + wy * ((1 - wx) * at(y0 + 1, x0) + wx * at(y0 + 1, x0 + 1)))
    alpha = torch.where(inb, sample[..., 3], 0.0)[..., None]
    out = image * (1 - alpha) + sample[..., :3] * alpha
    return out, alpha[..., 0] > 0.5


def shrink_visible_box(box_xyxy, occ_mask):
    """Largest unoccluded sub-box: the modal box recomputed from the
    per-row/column visibility inside the original box.

    ``box_xyxy [..., 4]``, ``occ_mask [..., H, W]`` (leading axes
    broadcast).  Returns ``(new_box [..., 4], visibility [...])``; a box
    with nothing visible keeps its coordinates."""
    H, W = occ_mask.shape[-2:]
    dev = occ_mask.device
    ys = torch.arange(H, dtype=f32, device=dev)
    xs = torch.arange(W, dtype=f32, device=dev)
    in_y = ((ys >= box_xyxy[..., 1, None])
            & (ys < box_xyxy[..., 3, None])).to(f32)          # [..., H]
    in_x = ((xs >= box_xyxy[..., 0, None])
            & (xs < box_xyxy[..., 2, None])).to(f32)          # [..., W]
    free = (~occ_mask).to(f32)
    # Visible pixels a row (within the box's columns) and a column
    # (within its rows): sums of 0/1 values, exact in f32.
    rows = (free @ in_x[..., None])[..., 0] * in_y            # [..., H]
    cols = (in_y[..., None, :] @ free)[..., 0, :] * in_x      # [..., W]
    vis_count = rows.sum(-1)
    area = (in_y.sum(-1) * in_x.sum(-1)).clamp_min(1)
    visibility = vis_count / area
    any_row, any_col = rows > 0, cols > 0
    big = 1e9
    y0 = torch.where(any_row, ys, big).amin(-1)
    y1 = torch.where(any_row, ys, -big).amax(-1) + 1
    x0 = torch.where(any_col, xs, big).amin(-1)
    x1 = torch.where(any_col, xs, -big).amax(-1) + 1
    new_box = torch.stack([x0, y0, x1, y1], dim=-1)
    return torch.where((vis_count > 0)[..., None], new_box,
                       box_xyxy), visibility


def pno_draws(B, G, K, generator, max_occluders=3, scale_range=(0.5, 1.5),
              occlude_prob=0.8):
    """Draws for :func:`paste_n_occlude_batch` over ``B`` samples of
    ``G`` gt slots and a bank of ``K`` patches, on the generator's
    device: ``u [B, G]`` uniform, ``do [B, M]`` (each occluder pasted
    with ``occlude_prob``), ``idx [B, M]`` (a patch), ``offset [B, M,
    2]`` uniform in [-0.6, 0.6) and ``scale [B]`` uniform in
    ``scale_range``, M = ``max_occluders``."""
    dev = generator.device
    M = max_occluders

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    lo, hi = scale_range
    return {"u": rand(B, G), "do": rand(B, M) < occlude_prob,
            "idx": torch.randint(0, K, (B, M), generator=generator,
                                 device=dev),
            "offset": rand(B, M, 2) * 1.2 - 0.6,
            "scale": rand(B) * (hi - lo) + lo}


def _paste_occluders(image, target, bank, do, idx, offset, scale):
    """``[B]`` samples: every occluder pasted in turn near its sample's
    ``target`` box; returns (images, occupancy masks)."""
    ph, pw = bank.shape[1:3]
    cx = (target[..., 0] + target[..., 2]) / 2
    cy = (target[..., 1] + target[..., 3]) / 2
    bw = target[..., 2] - target[..., 0]
    bh = target[..., 3] - target[..., 1]
    root = float(np.sqrt(np.float32(ph * pw + 1e-6)))
    scale = (scale * torch.sqrt(bw * bh) / root).clamp_min(1e-3)
    occ = torch.zeros(image.shape[:-1], dtype=torch.bool,
                      device=image.device)
    for i in range(do.shape[-1]):
        center = torch.stack([cx + offset[..., i, 0] * bw,
                              cy + offset[..., i, 1] * bh], dim=-1)
        new_img, mask = paste_patch(image, bank[idx[..., i]], center, scale)
        d = do[..., i]
        image = torch.where(d[..., None, None, None], new_img, image)
        occ = occ | (mask & d[..., None, None])
    return image, occ


def paste_n_occlude(image, target_box_xyxy, occluder_bank, do, idx, offset,
                    scale):
    """PasteNOcclude on one sample: ``image [H, W, 3]``, the target's full
    (amodal) box, the bank ``[K, ph, pw, 4]`` and one sample's draws
    (``do [M]``, ``idx [M]``, ``offset [M, 2]``, ``scale`` 0-d).

    Returns ``image``, ``modal_box`` (the shrunk visible box),
    ``amodal_box`` (the target, unchanged), ``visibility`` and
    ``occlusion_mask``."""
    img, occ = _paste_occluders(image[None], target_box_xyxy[None],
                                occluder_bank, do[None], idx[None],
                                offset[None], scale.reshape(1))
    modal_box, visibility = shrink_visible_box(target_box_xyxy, occ[0])
    return {"image": img[0], "modal_box": modal_box,
            "amodal_box": target_box_xyxy, "visibility": visibility,
            "occlusion_mask": occ[0]}


def paste_n_occlude_batch(images, gt_boxes, gt_amodal, gt_valid,
                          occluder_bank, draws):
    """PasteNOcclude over a detector training batch.

    Per sample: one random valid gt is the paste target (occluders land
    near it), then every gt's visible box is re-shrunk against the
    composited occupancy mask.  The amodal targets are untouched; a gt
    whose visibility drops to zero is no longer a valid modal target.

    Args:
      images: ``[B, H, W, 3]`` float RGB in 0-255 (pre-normalization).
      gt_boxes / gt_amodal: ``[B, G, 4]`` xyxy.
      gt_valid: ``[B, G]`` bool.
      draws: :func:`pno_draws` of ``(B, G, K)``.

    Returns ``(images, gt_boxes, gt_valid, visibility [B, G])``.
    """
    u = torch.where(gt_valid, draws["u"], -1.0)
    pick = u.argmax(-1)
    target = torch.gather(gt_amodal, 1, pick[:, None, None].expand(
        -1, 1, 4))[:, 0]
    pasted, occ = _paste_occluders(images, target, occluder_bank,
                                   draws["do"], draws["idx"],
                                   draws["offset"], draws["scale"])
    any_valid = gt_valid.any(-1)
    images = torch.where(any_valid[:, None, None, None], pasted, images)
    occ = occ & any_valid[:, None, None]
    new_boxes, vis = shrink_visible_box(gt_boxes, occ[:, None])
    return images, new_boxes.to(gt_boxes.dtype), gt_valid & (vis > 0), vis


def _resize_linear(img, size):
    """``jax.image.resize(img, (size, size, C), "linear")`` of an ``[h,
    w, C]`` f32 array: an axis of equal size is left as it is."""
    h, w = img.shape[:2]
    out = img
    if h != size:
        out = np.einsum("hwc,hH->Hwc", out, linear_resize_weights(h, size))
    if w != size:
        out = np.einsum("Hwc,wW->HWc", out, linear_resize_weights(w, size))
    return out.astype(np.float32)


def make_occluder_bank(images_with_masks, patch_size=64, device="cuda"):
    """The RGBA occluder bank ``[N, P, P, 4]`` on ``device`` from (image,
    mask) pairs (e.g. BURST masks): each object's bounding box cropped,
    resized to a fixed patch (JAX's antialiased linear resize), alpha =
    mask.  Pairs with fewer than 4 mask pixels are skipped."""
    bank = []
    for img, mask in images_with_masks:
        ys, xs = np.nonzero(mask)
        if len(ys) < 4:
            continue
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        crop = img[y0:y1, x0:x1].astype(np.float32)
        alpha = mask[y0:y1, x0:x1].astype(np.float32)
        rgba = np.concatenate([crop, alpha[..., None]], axis=-1)
        bank.append(_resize_linear(rgba, patch_size))
    if not bank:
        raise ValueError("no usable occluders")
    return torch.from_numpy(np.stack(bank)).to(device)


def synthetic_occluder_bank(seed=0, num=16, patch_size=64, device="cuda"):
    """Zero-egress occluder bank on ``device``: textured ellipses in
    random colors (numpy ``RandomState``, the JAX package's bank byte for
    byte).

    Stands in for the reference recipe's segmented-object occluders
    (built from real masks via :func:`make_occluder_bank`) when no real
    segments are available.  Elliptical alpha keeps the occluders
    shape-distinct from the synthetic datasets' rectangular targets so
    the detector's background class stays learnable.
    """
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:patch_size, 0:patch_size].astype(np.float32)
    c = (patch_size - 1) / 2.0
    bank = []
    for _ in range(num):
        base = rs.uniform(30, 225, 3).astype(np.float32)
        tex = rs.uniform(-30, 30, (patch_size, patch_size, 3))
        rgb = np.clip(base[None, None] + tex, 0, 255)
        ry = rs.uniform(0.30, 0.49) * patch_size
        rx = rs.uniform(0.30, 0.49) * patch_size
        alpha = ((((yy - c) / ry) ** 2 + ((xx - c) / rx) ** 2)
                 <= 1.0).astype(np.float32)
        bank.append(np.concatenate([rgb, alpha[..., None]], axis=-1))
    return torch.from_numpy(np.stack(bank).astype(np.float32)).to(device)
