"""The reference's own overlay variants, pixel for pixel.

Port of :mod:`tao_amodal_tpu.utils.vis_ref`, which reproduces the
reference's per-variant labels, offsets and fills
(``visualization/tao/utils/vis.py:28-640``): class chips are white-filled
TRIPLEX text boxes with a colored 3-px border at ``y - 1.7*text_h``;
visibility chips one filled SIMPLEX box at ``y - 1.1*text_h``; every
``overlay_*`` variant defaults its canvas offset to ``(h/4, w/4)``, the
1.5x padded canvas's origin; visibility labels are ``"Vis: {iou:.3f}
{O|X}"`` with the endpoint-inclusive (+1) IoU between the modal and amodal
box, ``X`` marking ``amodal_is_uncertain``; box families fill with
per-annotation colors, largest box first, and 'baby' renders as 'person'.
The JAX package draws with OpenCV; the port draws the same pixels in numpy
(:mod:`tao_amodal_torch.utils.raster`).
"""

from __future__ import annotations

import numpy as np

from tao_amodal_torch.utils import raster
from tao_amodal_torch.utils.colormap import colormap

_BLACK = (0, 0, 0)
_GRAY = (218, 227, 218)
_WHITE = (255, 255, 255)
_COLOR1 = tuple(255 * x for x in (0.000, 0.447, 0.741))


def _default_origin(image, oy, ox):
    if oy is None and ox is None:
        h, w = image.shape[:2]
        return int(h / 4), int(w / 4)
    return oy, ox


def _iou_plus1(box_a, box_b):
    """Endpoint-inclusive IoU (the reference's +1 convention) on xyxy."""
    xa, ya = max(box_a[0], box_b[0]), max(box_a[1], box_b[1])
    xb, yb = min(box_a[2], box_b[2]), min(box_a[3], box_b[3])
    inter = max(0, xb - xa + 1) * max(0, yb - ya + 1)
    area_a = (box_a[2] - box_a[0] + 1) * (box_a[3] - box_a[1] + 1)
    area_b = (box_b[2] - box_b[0] + 1) * (box_b[3] - box_b[1] + 1)
    return inter / float(area_a + area_b - inter)


def amodal_visibility_label(ann):
    """``"Vis: {iou:.3f} {O|X}"`` for one annotation (modal-vs-amodal
    +1-convention IoU; segmentation corner fallback; X = uncertain)."""
    amodal = ann["amodal_bbox"]
    amodal_xyxy = [amodal[0], amodal[1], amodal[0] + amodal[2],
                   amodal[1] + amodal[3]]
    if "bbox" in ann:
        b = ann["bbox"]
        modal_xyxy = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
    elif "segmentation" in ann:
        s = ann["segmentation"][0]
        modal_xyxy = [s[0], s[1], s[4], s[5]]
    else:
        return "Vis:0.000 " + ("X" if ann["amodal_is_uncertain"]
                               else "O")
    label = "Vis: {:.3f}".format(_iou_plus1(modal_xyxy, amodal_xyxy))
    return label + " " + ("X" if ann["amodal_is_uncertain"] else "O")


def get_annotation_colors(annotations):
    """Area-rank-stable per-annotation colors (reference behavior: the
    largest box keeps its color across a video's frames)."""
    areas = [x["bbox"][2] * x["bbox"][3] for x in annotations]
    box_order = sorted(range(len(areas)), key=lambda i: areas[i])
    colors = colormap(rgb=True)[:len(annotations)].tolist()
    return [colors[i % len(colors)] for i in box_order]


# ----------------------------------------------------------------------
# Text chips
# ----------------------------------------------------------------------

def vis_class(image, pos, class_str, font_scale=0.35, bg_color=_WHITE,
              text_color=_BLACK, box_thickness=3, thickness=1):
    """White-filled TRIPLEX chip with a colored border."""
    x, y = int(pos[0]), int(pos[1])
    font = raster.FONT_HERSHEY_TRIPLEX
    ((tw, th), _) = raster.text_size(class_str, font, font_scale, 1)
    back_tl = x, y - int(1.7 * th)
    back_br = int(x + 1.1 * tw), y - int(0.2 * th)
    txt_tl = int(x + 0.05 * tw), y - int(0.6 * th)
    raster.rectangle(image, back_tl, back_br, _WHITE, -1)
    raster.rectangle(image, back_tl, back_br, bg_color, box_thickness)
    raster.put_text(image, class_str, txt_tl, font, font_scale, text_color,
                    thickness=thickness)
    return image


def vis_visibility(image, pos, visibility_str, font_scale=0.1,
                   bg_color=_BLACK, text_color=_GRAY, thickness=1):
    """Single filled SIMPLEX chip (the visibility-label style)."""
    x, y = int(pos[0]), int(pos[1])
    font = raster.FONT_HERSHEY_SIMPLEX
    ((tw, th), _) = raster.text_size(visibility_str, font, font_scale, 1)
    raster.rectangle(image, (x, y - int(1.1 * th)), (x + tw, y), bg_color,
                  -1)
    raster.put_text(image, visibility_str, (x, y), font, font_scale,
                    text_color, thickness=thickness)
    return image


def _overlay_chips(image, annotations, labels, box_key, oy, ox,
                   background_colors, default_color, chip_fn, **chip_kw):
    oy, ox = _default_origin(image, oy, ox)
    boxes = [[int(round(v)) for v in a[box_key]] for a in annotations]
    boxes = [[b[0] + ox, b[1] + oy, b[2], b[3]] for b in boxes]
    colors = (background_colors if background_colors is not None
              else [default_color for _ in annotations])
    for box, label, color in zip(boxes, labels, colors):
        chip_fn(image, box, label, bg_color=color, **chip_kw)
    return image


def _class_labels(annotations, categories, show_track_id):
    labels = []
    for a in annotations:
        label = categories[a["category_id"]]["name"]
        if label == "baby":
            label = "person"
        if show_track_id and "track_id" in a:
            label = f'{label} ({a["track_id"]})'
        labels.append(label)
    return labels


def overlay_amodal_class_coco(image, annotations, categories, oy=None,
                              ox=None, background_colors=None,
                              font_scale=0.5, font_thickness=1,
                              text_color=_BLACK, show_track_id=False):
    """Class chips at amodal-box corners (white default background)."""
    return _overlay_chips(
        image, annotations,
        _class_labels(annotations, categories, show_track_id),
        "amodal_bbox", oy, ox, background_colors, _WHITE, vis_class,
        font_scale=font_scale, text_color=text_color,
        thickness=font_thickness)


def overlay_amodal_class_prediction(image, annotations, categories,
                                    oy=None, ox=None,
                                    background_colors=None,
                                    font_scale=0.5, font_thickness=1,
                                    text_color=_BLACK,
                                    show_track_id=False):
    """Class chips at predicted ('bbox') corners (black default)."""
    return _overlay_chips(
        image, annotations,
        _class_labels(annotations, categories, show_track_id),
        "bbox", oy, ox, background_colors, _BLACK, vis_class,
        font_scale=font_scale, text_color=text_color,
        thickness=font_thickness)


def overlay_class_coco(image, annotations, categories,
                       background_colors=None, font_scale=0.5,
                       font_thickness=1, text_color=_GRAY,
                       show_track_id=False):
    """Class chips at raw box corners — NO canvas offset."""
    return _overlay_chips(
        image, annotations,
        _class_labels(annotations, categories, show_track_id),
        "bbox", 0, 0, background_colors, _BLACK, vis_class,
        font_scale=font_scale, text_color=text_color,
        thickness=font_thickness)


def overlay_amodal_visibility_coco(image, annotations, categories,
                                   oy=None, ox=None,
                                   background_colors=None,
                                   font_scale=0.1, font_thickness=1,
                                   text_color=_GRAY,
                                   show_track_id=False):
    """Visibility chips ('Vis: <iou> O/X') at amodal-box corners."""
    del categories, show_track_id  # reference signature compatibility
    labels = [amodal_visibility_label(a) for a in annotations]
    return _overlay_chips(
        image, annotations, labels, "amodal_bbox", oy, ox,
        background_colors, _BLACK, vis_visibility,
        font_scale=font_scale, text_color=text_color,
        thickness=font_thickness)


# ----------------------------------------------------------------------
# Box families
# ----------------------------------------------------------------------

def vis_bbox(image, box, border_color=_BLACK, fill_color=_COLOR1,
             fill_opacity=0.65, thickness=1):
    """Filled + bordered xywh box (reference fill/border semantics)."""
    x0, y0, w, h = box
    x1, y1 = int(x0 + w), int(y0 + h)
    x0, y0 = int(x0), int(y0)
    if fill_opacity > 0 and fill_color is not None:
        with_fill = raster.rectangle(image.copy(), (x0, y0), (x1, y1),
                                  tuple(fill_color), raster.FILLED)
        image = raster.add_weighted(with_fill, fill_opacity, image,
                                1 - fill_opacity, 0, image)
    return raster.rectangle(image, (x0, y0), (x1, y1), tuple(border_color),
                         thickness)


def _overlay_box_family(image, annotations, box_key, oy, ox, colors,
                        border_color, fill_opacity, thickness,
                        default_border_is_color=True):
    oy, ox = _default_origin(image, oy, ox)
    anns = ([a for a in annotations if "bbox" in a]
            if box_key == "bbox" else annotations)
    boxes = [[int(round(v)) for v in a[box_key]] for a in anns]
    boxes = [[b[0] + ox, b[1] + oy, b[2], b[3]] for b in boxes]
    order = sorted(range(len(boxes)),
                   key=lambda i: boxes[i][2] * boxes[i][3],
                   reverse=True)
    if colors is None:
        colors = get_annotation_colors(annotations)
    for i in order:
        kwargs = {}
        if fill_opacity:
            kwargs["fill_opacity"] = fill_opacity
        if border_color is not None:
            kwargs["border_color"] = border_color
        elif default_border_is_color:
            kwargs["border_color"] = colors[i]
        image = vis_bbox(image, boxes[i], fill_color=colors[i],
                         thickness=thickness, **kwargs)
    return image


def overlay_amodal_boxes_coco(image, annotations, oy=None, ox=None,
                              colors=None, border_color=None,
                              fill_opacity=None, thickness=1):
    return _overlay_box_family(image, annotations, "amodal_bbox", oy,
                               ox, colors, border_color, fill_opacity,
                               thickness)


def overlay_modal_boxes_coco(image, annotations, oy=None, ox=None,
                             colors=None, border_color=None,
                             fill_opacity=None, thickness=1):
    return _overlay_box_family(image, annotations, "bbox", oy, ox,
                               colors, border_color, fill_opacity,
                               thickness)


def overlay_amodal_boxes_prediction(image, annotations, oy=None,
                                    ox=None, colors=None,
                                    border_color=None,
                                    fill_opacity=None, thickness=1):
    """Prediction variant: amodal boxes arrive in the 'bbox' field."""
    return _overlay_box_family(image, annotations, "bbox", oy, ox,
                               colors, border_color, fill_opacity,
                               thickness)


def overlay_boxes_coco(image, annotations, colors=None,
                       border_color=None, fill_opacity=None,
                       thickness=1):
    """No canvas offset; default border stays the reference's _BLACK."""
    return _overlay_box_family(image, annotations, "bbox", 0, 0,
                               colors, border_color, fill_opacity,
                               thickness, default_border_is_color=False)


def transparent_except_bbox(image, all_annos, opacity=0.6, modal=True,
                            oy=None, ox=None):
    """Whiten everything outside the (modal|amodal) boxes."""
    with_fill = np.ones_like(image) * 255
    if oy is None or ox is None:
        h, w = image.shape[:2]
        oy, ox = int(h / 4), int(w / 4)
    for ann in all_annos:
        if modal and "bbox" not in ann:
            continue
        box = ann["bbox"] if modal else ann["amodal_bbox"]
        x0 = max(0, box[0] + ox)
        y0 = max(0, box[1] + oy)
        x1 = min(image.shape[1], box[2] + box[0] + ox)
        y1 = min(image.shape[0], box[3] + box[1] + oy)
        with_fill[int(y0):int(y1), int(x0):int(x1)] = (
            image[int(y0):int(y1), int(x0):int(x1)])
    return raster.add_weighted(with_fill, opacity, image, 1 - opacity, 0,
                           image)
