"""Disk-fed SOT training data: benchmark layouts -> Siamese pairs.

Port of :mod:`tao_amodal_tpu.data.sot_train` (the capability of the
reference's per-dataset training adapters, ``pytracking/ltr/dataset/
{lasot,got10k,tracking_net}.py`` and pysot's ``TrkDataset``): one
adapter feeds any :mod:`tao_amodal_torch.data.sot_datasets` layout into
:class:`~tao_amodal_torch.train.sampler.TrackPairSampler`, and a host
cropper makes numpy (template, search, box) batches, byte for byte
JAX's.  Frames are decoded with PIL, imported only in :func:`load_pair`.
Augmentation runs on the device (:mod:`tao_amodal_torch.train.augment`).
"""

from __future__ import annotations

import numpy as np


class SotSequenceSource:
    """:class:`.sot_datasets.SotDataset` -> sampler source (one track
    per sequence; frames with degenerate boxes are dropped)."""

    def __init__(self, dataset):
        self.tracks = []
        for seq in dataset:
            frames = [
                {"frame": path, "bbox": np.asarray(box, np.float64)}
                for path, box in zip(seq.frames, seq.gt_boxes)
                if np.all(np.isfinite(box)) and box[2] > 0 and box[3] > 0
            ]
            if len(frames) >= 2:
                self.tracks.append(frames)

    @property
    def num_tracks(self):
        return len(self.tracks)

    def track_frames(self, track_idx):
        return self.tracks[track_idx]


def _crop_resize(image, cx, cy, size, out, pad_value):
    """Square crop of side ``size`` centered at (cx, cy), resized to
    ``out`` — numpy nearest resample (host loader; sub-pixel detail is
    handled by the on-device augmentation, not here)."""
    H, W = image.shape[:2]
    xs = cx - size / 2 + (np.arange(out) + 0.5) * size / out
    ys = cy - size / 2 + (np.arange(out) + 0.5) * size / out
    xi = np.floor(xs).astype(np.int64)
    yi = np.floor(ys).astype(np.int64)
    ok_x = (xi >= 0) & (xi < W)
    ok_y = (yi >= 0) & (yi < H)
    crop = np.empty((out, out, 3), np.float32)
    crop[:] = pad_value
    sub = image[np.clip(yi, 0, H - 1)][:, np.clip(xi, 0, W - 1)]
    mask = ok_y[:, None] & ok_x[None, :]
    crop[mask] = sub[mask]
    return crop


def load_pair(template_rec, search_rec, exemplar_size=127,
              instance_size=255, context_amount=0.5):
    """Load + crop one (template, search) pair, pysot geometry.

    Template: square ``s_z = sqrt((w + p)(h + p))``, ``p = (w+h)/2``
    context (reference ``pysot/utils/bbox.py`` convention), resized to
    ``exemplar_size``.  Search: ``s_x = s_z * instance/exemplar``
    around the search-frame target, resized to ``instance_size``.
    Returns ``(template [z,z,3], search [x,x,3], box [4] cx,cy,w,h in
    search-crop coords)``.
    """
    from PIL import Image

    def s_z_of(w, h):
        p = context_amount * (w + h)
        return np.sqrt((w + p) * (h + p))

    t_img = np.asarray(
        Image.open(template_rec["frame"]).convert("RGB"), np.float32)
    x0, y0, w, h = template_rec["bbox"]
    cx, cy = x0 + w / 2, y0 + h / 2
    avg = t_img.mean(axis=(0, 1))
    template = _crop_resize(t_img, cx, cy, s_z_of(w, h),
                            exemplar_size, avg)

    s_img = np.asarray(
        Image.open(search_rec["frame"]).convert("RGB"), np.float32)
    x0, y0, w, h = search_rec["bbox"]
    cx, cy = x0 + w / 2, y0 + h / 2
    s_z = s_z_of(w, h)
    s_x = s_z * instance_size / exemplar_size
    avg = s_img.mean(axis=(0, 1))
    search = _crop_resize(s_img, cx, cy, s_x, instance_size, avg)
    scale = instance_size / s_x
    box = np.asarray([instance_size / 2, instance_size / 2,
                      w * scale, h * scale], np.float32)
    return template, search, box


def pair_batch_iter(sampler, sources, batch_size, exemplar_size=127,
                    instance_size=255):
    """Infinite iterator of ``{template, search, box}`` batches from a
    :class:`..train.sampler.TrackPairSampler` over ``sources``."""
    it = iter(sampler)
    while True:
        tm, sr, bx = [], [], []
        while len(tm) < batch_size:
            s = next(it)
            st, tt, ti = s["template"]
            ss, ts, si = s["search"]
            t, x, b = load_pair(
                sources[st].track_frames(tt)[ti],
                sources[ss].track_frames(ts)[si],
                exemplar_size=exemplar_size,
                instance_size=instance_size)
            if s["is_negative"]:
                # Negative pair: the search target is NOT the template
                # object; zero size marks "no positive anchors"
                # (anchor assignment gives it the all-negative label).
                b = np.asarray([instance_size / 2, instance_size / 2,
                                0.0, 0.0], np.float32)
            tm.append(t)
            sr.append(x)
            bx.append(b)
        yield {"template": np.stack(tm), "search": np.stack(sr),
               "box": np.stack(bx)}
