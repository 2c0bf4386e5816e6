"""Drawing primitives for annotation and prediction videos.

Port of :mod:`tao_amodal_tpu.utils.vis` (the reference's
``visualization/tao/utils/vis.py``): filled and bordered boxes, class and
visibility chips, the amodal/modal/prediction overlay families offset by
the padded canvas's origin, mask blending with contours, and dimming
outside boxes.  The JAX package draws with OpenCV; the port draws the
same pixels in numpy (:mod:`tao_amodal_torch.utils.raster`).  Colors come
from :mod:`tao_amodal_torch.utils.colormap` by track id, so a track keeps
its color across frames.
"""

from __future__ import annotations

import numpy as np

from tao_amodal_torch.utils import raster
from tao_amodal_torch.utils.colormap import color_for_id

_GRAY = (218, 227, 218)
_GREEN = (18, 127, 15)
_WHITE = (255, 255, 255)


def vis_bbox(img, box_xywh, color=_GRAY, thick=2, fill_alpha=0.0):
    """Draw one xywh box (border and an optional translucent fill)."""
    x, y, w, h = [int(round(v)) for v in box_xywh]
    if fill_alpha > 0:
        overlay = img.copy()
        raster.rectangle(overlay, (x, y), (x + w, y + h),
                         tuple(int(c) for c in color), raster.FILLED)
        img[:] = raster.add_weighted(overlay, fill_alpha, img,
                                     1 - fill_alpha, 0)
    raster.rectangle(img, (x, y), (x + w, y + h),
                     tuple(int(c) for c in color), thick)
    return img


def vis_class(img, pos, text, bg_color=_GREEN, text_color=_WHITE,
              font_scale=0.5):
    """Text chip above a box (reference ``vis_class``)."""
    x, y = int(pos[0]), int(pos[1])
    font = raster.FONT_HERSHEY_SIMPLEX
    ((tw, th), _) = raster.text_size(text, font, font_scale, 1)
    back_tl = (x, y - int(1.3 * th))
    back_br = (x + tw, y)
    raster.rectangle(img, back_tl, back_br,
                     tuple(int(c) for c in bg_color), raster.FILLED)
    raster.put_text(img, text, (x, y - int(0.3 * th)), font, font_scale,
                    tuple(int(c) for c in text_color))
    return img


def vis_visibility(img, pos, visibility, bg_color=_GREEN):
    """Visibility-fraction chip."""
    return vis_class(img, pos, f"vis: {visibility:.2f}",
                     bg_color=bg_color)


def vis_mask(img, mask, color, alpha=0.4, show_border=True,
             border_thick=1):
    """Blend a binary mask and draw its contour (reference ``vis_mask``)."""
    img = img.astype(np.float32)
    idx = mask.astype(bool)
    color = np.asarray(color, np.float32)
    img[idx] = img[idx] * (1 - alpha) + alpha * color
    img = img.astype(np.uint8)
    if show_border:
        contours, _ = raster.find_contours(mask.astype(np.uint8))
        raster.draw_contours(img, contours, -1,
                             tuple(int(c) for c in color), border_thick)
    return img


def transparent_except_boxes(img, boxes_xywh, dim=0.55, origin=(0, 0)):
    """Dim everything outside the given boxes (reference
    ``transparent_except_bbox``)."""
    mask = np.zeros(img.shape[:2], bool)
    ox, oy = origin
    for b in boxes_xywh:
        x, y, w, h = [int(round(v)) for v in
                      (b[0] + ox, b[1] + oy, b[2], b[3])]
        mask[max(y, 0):y + h, max(x, 0):x + w] = True
    out = img.astype(np.float32)
    out[~mask] *= (1 - dim)
    return out.astype(np.uint8)


def make_padded_canvas(img, scale=1.5, value=255):
    """Paste the frame into a white canvas ``scale`` x its size, so
    out-of-frame amodal boxes stay visible; returns (canvas, origin).
    The frame sits centred (reference ``vis_amodal_mask_videos.py:147-153``).
    """
    h, w = img.shape[:2]
    ch, cw = int(round(h * scale)), int(round(w * scale))
    canvas = np.full((ch, cw, 3), value, np.uint8)
    oy, ox = (ch - h) // 2, (cw - w) // 2
    canvas[oy:oy + h, ox:ox + w] = img
    return canvas, (ox, oy)


def overlay_amodal_boxes(canvas, anns, origin, show_class=True,
                         show_visibility=False, category_names=None,
                         thick=2):
    """Amodal boxes on the padded canvas, offset by its origin."""
    ox, oy = origin
    for ann in anns:
        color = color_for_id(ann.get("track_id", 0))
        x, y, w, h = ann["bbox"]
        vis_bbox(canvas, (x + ox, y + oy, w, h), color=color,
                 thick=thick)
        if show_class:
            name = _category_name(ann, category_names)
            if name:
                vis_class(canvas, (x + ox, y + oy - 2), name,
                          bg_color=color)
        if show_visibility and "visibility" in ann:
            vis_visibility(canvas, (x + ox, y + oy + h + 14),
                           ann["visibility"], bg_color=color)
    return canvas


def overlay_modal_boxes(canvas, anns, origin, category_names=None,
                        thick=1, dashed=False):
    """Modal (visible) boxes, thinner than the amodal ones."""
    ox, oy = origin
    for ann in anns:
        color = color_for_id(ann.get("track_id", 0))
        x, y, w, h = ann.get("modal_bbox", ann.get("bbox"))
        vis_bbox(canvas, (x + ox, y + oy, w, h), color=color,
                 thick=thick)
    return canvas


def overlay_prediction_boxes(canvas, anns, origin, score_thr=0.5,
                             category_names=None, show_score=True):
    """Prediction overlays: the box and a 'name score' chip."""
    ox, oy = origin
    for ann in anns:
        if ann.get("score", 1.0) < score_thr:
            continue
        color = color_for_id(ann.get("track_id", 0))
        x, y, w, h = ann["bbox"]
        vis_bbox(canvas, (x + ox, y + oy, w, h), color=color, thick=2)
        name = _category_name(ann, category_names) or ""
        label = (f"{name} {ann['score']:.2f}" if show_score
                 else name).strip()
        if label:
            vis_class(canvas, (x + ox, y + oy - 2), label,
                      bg_color=color)
    return canvas


def overlay_masks(canvas, masks_by_track, origin, alpha=0.4):
    """BURST per-track masks pasted at the canvas origin."""
    ox, oy = origin
    for track_id, mask in masks_by_track.items():
        color = color_for_id(int(track_id))
        h, w = mask.shape
        region = canvas[oy:oy + h, ox:ox + w]
        canvas[oy:oy + h, ox:ox + w] = vis_mask(region, mask, color,
                                                alpha=alpha)
    return canvas


def _category_name(ann, category_names):
    if category_names is None:
        return str(ann.get("category_id", ""))
    return category_names.get(ann.get("category_id"), "")
