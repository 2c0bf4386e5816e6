"""Amodal Expander: visible box -> amodal box regression head.

Port of :class:`tao_amodal_tpu.models.amodal_expander.AmodalExpander`:
an MLP over [RoI feature, 64-d box-geometry embedding] emitting
(dx, dy, dw, dh) deltas in the visible box's frame, with the log-scale
clamp at 4.0.  The ``deltas`` layer starts at zero (``zero_init``), so a
freshly initialised expander is the identity on boxes.

In bf16 (``dtype``) the geometry embedding, the fc layers and the
deltas are bf16 layers (:mod:`tao_amodal_torch.models.layers`) and the
box arithmetic promotes as JAX's does: the bf16 deltas meet the f32
boxes, so the amodal boxes are f32 and the deltas bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tao_amodal_torch.models import layers


class AmodalExpander(nn.Module):
    def __init__(self, in_features=1024, hidden=512, num_layers=2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.geom_embed = nn.Linear(6, 64)
        dims = [in_features + 64] + [hidden] * num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
        self.num_layers = num_layers
        self.deltas = nn.Linear(hidden, 4)
        self.deltas.zero_init = True

    def forward(self, roi_features, boxes, image_hw):
        """``roi_features [..., F]``, visible ``boxes [..., 4]`` xyxy,
        ``image_hw`` (h, w) -> (amodal ``[..., 4]`` xyxy, deltas)."""
        x0, y0, x1, y1 = boxes.unbind(-1)
        w = (x1 - x0).clamp_min(1e-3)
        h = (y1 - y0).clamp_min(1e-3)
        ih, iw = image_hw
        geom = torch.stack([x0 / iw, y0 / ih, x1 / iw, y1 / ih,
                            w / iw, h / ih], dim=-1)
        dt = self.dtype
        x = torch.cat([roi_features.to(dt),
                       layers.dense(geom, self.geom_embed, dt)], dim=-1)
        for i in range(self.num_layers):
            x = F.relu(layers.dense(x, getattr(self, f"fc{i}"), dt))
        deltas = layers.dense(x, self.deltas, dt)
        dx, dy, dw, dh = deltas.unbind(-1)
        cx = (x0 + x1) * 0.5 + dx * w
        cy = (y0 + y1) * 0.5 + dy * h
        nw = w * torch.exp(dw.clamp_max(4.0))
        nh = h * torch.exp(dh.clamp_max(4.0))
        amodal = torch.stack([cx - nw / 2, cy - nh / 2,
                              cx + nw / 2, cy + nh / 2], dim=-1)
        return amodal, deltas
