"""DiMP: an online-optimized filter, IoUNet ascent and a memory ring.

Port of ``tao_amodal_tpu/trackers/dimp.py`` (the reference's
``pytracking/tracker/dimp/dimp.py:20-657``): the first frame's filter
by Gauss-Newton/CG (5 x 8); then a frame classifies, takes the peak,
refines the box by IoUNet gradient ascent (5 steps of 0.5), pushes the
sample into a fixed ring, and every ``update_interval`` frames
re-optimizes the filter on the ring (2 x 5).  The ring's slot and the
frame counter are Python ints; a frame makes one host sync, the box and
score's copy, as JAX's ``update`` makes one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tao_amodal_torch.models.dimp import (
    classify,
    refine_box_ascent,
    train_filter,
)
from tao_amodal_torch.ops.optimization import gauss_newton_cg
from tao_amodal_torch.trackers import discriminative as disc
from tao_amodal_torch.trackers.base import Tracker
from tao_amodal_torch.trackers.siamrpn import crop_subwindow

f32 = torch.float32


class DimpState(NamedTuple):
    filt: torch.Tensor           # [fh, fw, C]
    memory_feats: torch.Tensor   # [M, H, W, C]
    memory_labels: torch.Tensor  # [M, Ho, Wo]
    memory_valid: torch.Tensor   # [M]
    mem_ptr: int
    center: torch.Tensor         # [2] (cx, cy) image coords
    size: torch.Tensor           # [2] (w, h)
    mod_vec: torch.Tensor        # IoUNet modulation vector
    frame: int


def gaussian_label(shape, center, sigma=2.0):
    """Desired response map: a Gaussian peak at ``center`` (row, col)."""
    return disc.gaussian_label(shape, center, sigma)


class DimpTracker(Tracker):
    """DiMP over ``extractor_fn``: ``crop [S, S, 3] -> feat [S/stride,
    S/stride, C]`` (NHWC, on ``device``), with ``iou_net`` an
    :class:`~tao_amodal_torch.models.dimp.IoUNet` (``iou_variables``,
    JAX's flat variables, loaded into it where given).  JAX's keyword
    names and defaults."""

    def __init__(self, extractor_fn, iou_net, iou_variables=None,
                 search_size=288, filter_size=4, feat_stride=16,
                 memory_size=16, update_interval=8, device="cuda"):
        if iou_variables is not None:
            from tao_amodal_torch.utils.weights import load_variables

            load_variables(iou_net, iou_variables)
        self.extract = extractor_fn
        self.iou_net = iou_net
        self.search_size = search_size
        self.filter_size = filter_size
        self.stride = feat_stride
        self.memory_size = memory_size
        self.update_interval = update_interval
        self.device = torch.device(device)
        self.out_hw = search_size // feat_stride - filter_size + 1
        self.state = None

    @torch.no_grad()
    def init_fn(self, image, box_xywh):
        S, fs, M, out_hw = (self.search_size, self.filter_size,
                            self.memory_size, self.out_hw)
        image = disc.upload(image, self.device)
        box = torch.as_tensor(np.asarray(box_xywh, np.float32)).to(
            self.device)
        center = torch.stack([box[0] + box[2] / 2, box[1] + box[3] / 2])
        size = box[2:4]
        crop_sz = torch.sqrt(torch.prod(size)) * 5.0
        avg = image.to(f32).mean(dim=(0, 1))
        feat = self.extract(crop_subwindow(image, center, crop_sz, S, avg))
        C = feat.shape[-1]

        label = gaussian_label(
            (out_hw, out_hw),
            torch.full((2,), out_hw / 2 - 0.5, device=self.device))
        mem_f = torch.zeros((M,) + tuple(feat.shape), device=self.device)
        mem_f[0] = feat
        mem_l = torch.zeros(M, out_hw, out_hw, device=self.device)
        mem_l[0] = label
        mem_v = torch.zeros(M, dtype=torch.bool, device=self.device)
        mem_v[0].fill_(True)

        filt, _ = train_filter(feat[None], label[None], (fs, fs, C),
                               num_gn_iters=5, num_cg_iters=8)

        # The IoUNet's modulation from the first box in crop coordinates.
        scale = S / crop_sz
        box_crop = torch.stack([
            S / 2 - size[0] * scale / 2, S / 2 - size[1] * scale / 2,
            S / 2 + size[0] * scale / 2, S / 2 + size[1] * scale / 2])
        mod = self.iou_net.modulation(feat, box_crop,
                                      spatial_scale=1.0 / self.stride)
        return DimpState(filt, mem_f, mem_l, mem_v, 1, center, size, mod, 1)

    @torch.no_grad()
    def step_fn(self, state, image):
        """One frame: ``(new state, (box xywh [4], score))`` on the
        device, no host sync.  Writes the memory ring in place."""
        S, M, out_hw, stride = (self.search_size, self.memory_size,
                                self.out_hw, self.stride)
        crop_sz = torch.sqrt(torch.prod(state.size)) * 5.0
        avg = image.to(f32).mean(dim=(0, 1))
        feat = self.extract(crop_subwindow(image, state.center, crop_sz, S,
                                           avg))

        resp = classify(feat[None], state.filt)[0]          # [Ho, Wo]
        idx = torch.argmax(resp.reshape(-1))
        peak = torch.stack([idx // out_hw, idx % out_hw]).to(f32)
        score = disc.take(resp.reshape(-1), idx)
        # Feature-grid peak -> crop pixel -> image displacement.
        disp = (peak.flip(0) - (out_hw - 1) / 2) * stride * (crop_sz / S)

        # IoUNet refinement in crop coordinates.
        scale = S / crop_sz
        w = state.size[0] * scale
        h = state.size[1] * scale
        cx = S / 2 + disp[0] * scale
        cy = S / 2 + disp[1] * scale
        box0 = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
        refined, _ = refine_box_ascent(
            self.iou_net, feat, state.mod_vec, box0, steps=5,
            step_size=0.5, spatial_scale=1.0 / stride)
        new_wh = torch.stack([refined[2] - refined[0],
                              refined[3] - refined[1]]) / scale
        center = state.center + (torch.stack([
            (refined[0] + refined[2]) / 2, (refined[1] + refined[3]) / 2])
            - S / 2) / scale
        size = 0.7 * state.size + 0.3 * new_wh

        # Memory push and the periodic re-optimization.
        ptr = state.mem_ptr % M
        state.memory_feats[ptr] = feat
        state.memory_labels[ptr] = gaussian_label((out_hw, out_hw), peak)
        state.memory_valid[ptr].fill_(True)   # t[i] = True syncs
        filt = state.filt
        if state.frame % self.update_interval == 0:
            mem_f, mem_l = state.memory_feats, state.memory_labels
            weights = state.memory_valid.to(f32)[:, None, None]

            def residual(f):
                return {"data": (classify(mem_f, f) - mem_l) * weights,
                        "reg": 0.1 * f}

            filt, _ = gauss_newton_cg(residual, filt, num_gn_iters=2,
                                      num_cg_iters=5)

        new_state = state._replace(filt=filt, mem_ptr=state.mem_ptr + 1,
                                   center=center, size=size,
                                   frame=state.frame + 1)
        box = torch.cat([center - size / 2, size])
        return new_state, (box, score)

    def init(self, image, box):
        self.state = self.init_fn(image, box)

    def update(self, image):
        self.state, (box, score) = self.step_fn(
            self.state, disc.upload(image, self.device))
        out = disc.read_back(box, score)
        return out[:4].copy(), float(out[4])
