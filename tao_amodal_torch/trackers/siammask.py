"""SiamMask tracking: SiamRPN localization + the refined mask.

Port of ``tao_amodal_tpu/trackers/siammask.py``.  A frame localizes as
SiamRPN does (:class:`~tao_amodal_torch.trackers.siamrpn.SiamCore`), then
refines the mask at the chosen response cell, takes its sigmoid and maps
the mask's exemplar-sized patch of the search crop to image coordinates
(the sub-window box), all on the card.  Only the rotated-box fit runs on
the host (:mod:`tao_amodal_torch.ops.rotated_box`, numpy): the polygon is
fit in mask coordinates and its 4 corners mapped to the image.
"""

from __future__ import annotations

import torch

from tao_amodal_torch.ops.rotated_box import mask_to_rotated_box
from tao_amodal_torch.trackers.siamrpn import (
    SiamConfig,
    SiamCore,
    SiamRPNTracker,
    _batched,
    _single,
    decode,
)


def sub_window(center, s_x, best, ss, cfg):
    """The image xywh box ``[4]`` of the mask: an exemplar-sized window of
    the search crop (side ``s_x`` around ``center``) centred at the
    response cell of the anchor-major index ``best``."""
    flat = best % (ss * ss)
    dy = (flat // ss).float()
    dx = (flat % ss).float()
    s = s_x / cfg.instance_size       # image px per crop px
    crop_x0 = center[0] - s_x / 2
    crop_y0 = center[1] - s_x / 2
    crop_cx = (dx - ss // 2) * cfg.stride + cfg.instance_size / 2
    crop_cy = (dy - ss // 2) * cfg.stride + cfg.instance_size / 2
    return torch.stack([
        crop_x0 + (crop_cx - cfg.exemplar_size / 2) * s,
        crop_y0 + (crop_cy - cfg.exemplar_size / 2) * s,
        cfg.exemplar_size * s,
        cfg.exemplar_size * s,
    ])


def make_siammask_step(model, cfg: SiamConfig = SiamConfig(),
                       mask_threshold=0.3):
    """``(init_fn, step_fn)``; ``step_fn(state, image) -> (state, (box,
    score, mask [out, out], sub [4]))``.  ``model`` is a
    :class:`~tao_amodal_torch.models.siamese.SiameseTracker` with
    ``with_mask=True`` and ``with_refine=True``.  ``mask_threshold`` is
    the tracker's (:class:`SiamMaskTracker`), as in JAX."""
    core = SiamCore(model, cfg)
    hp0 = core.hp()[None]
    ss = core.ss

    @torch.no_grad()
    def step_fn(state, image):
        image = torch.as_tensor(image, device=core.device)
        batch = _batched(state)
        s_x, out = core.search(batch, image)
        center, size, box, score, best = decode(
            out, batch, hp0, image.shape[:2], core.anchors, core.window, ss,
            cfg)
        flat = best % (ss * ss)
        dy = flat // ss
        dx = flat % ss
        logits = model.refine(out["mask_corr"], torch.stack([dy, dx], 1))[0]
        mask = torch.sigmoid(logits)
        sub = sub_window(state.center, s_x[0], best[0], ss, cfg)
        new = _single(batch._replace(center=center, size=size))
        return new, (box[0], score[0], mask, sub)

    step_fn.core = core
    return core.init, step_fn


def mask_polygon(box, mask, sub, threshold):
    """The rotated box of ``mask`` (numpy, in the sub-window ``sub``) as
    a polygon ``[4, 2]`` in image coordinates; a mask too small falls back
    to the axis-aligned ``box``."""
    P = mask.shape[0]
    corners = mask_to_rotated_box(
        mask, threshold=threshold,
        fallback_rect=[(box[0] - sub[0]) / sub[2] * P,
                       (box[1] - sub[1]) / sub[3] * P,
                       box[2] / sub[2] * P, box[3] / sub[3] * P])
    return corners / P * sub[2:4][None] + sub[:2][None]


class SiamMaskTracker(SiamRPNTracker):
    """Host wrapper: ``update`` also fills ``last_mask`` (the sigmoid
    mask in its sub-window), ``last_mask_box`` (that window, image xywh)
    and ``last_polygon`` (the rotated box's corners, flattened)."""

    def __init__(self, model, cfg: SiamConfig = SiamConfig(),
                 mask_threshold=0.3):
        self.model, self.cfg = model, cfg
        self.init_fn, self.step_fn = make_siammask_step(
            model, cfg, mask_threshold)
        self.mask_threshold = mask_threshold
        self.state = None
        self.last_mask = None
        self.last_mask_box = None
        self.last_polygon = None

    def update(self, image):
        self.state, (box, score, mask, sub) = self.step_fn(self.state, image)
        box = box.cpu().numpy()
        mask = mask.cpu().numpy()
        sub = sub.cpu().numpy()
        polygon = mask_polygon(box, mask, sub, self.mask_threshold)
        self.last_mask = mask
        self.last_mask_box = sub
        self.last_polygon = polygon.reshape(-1)
        return box, float(score)
