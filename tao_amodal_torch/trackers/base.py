"""Single-object tracker host API.

Port of ``tao_amodal_tpu/trackers/base.py``: ``init(image, box)``,
``update(image)``, the timing generator :meth:`Tracker.track_yield` and
the batch :meth:`Tracker.track` over a frame list.  The device work
happens in the subclasses' ``init``/``update``; this layer is host
orchestration and IO (frame paths are read with PIL, imported only when
a path is given).
"""

from __future__ import annotations

import abc
import time
from collections import namedtuple

import numpy as np

TrackResult = namedtuple("TrackResult", ["box", "score", "elapsed"])


def read_rgb(path):
    """An image file -> RGB uint8 ``[H, W, 3]``."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


class Tracker(abc.ABC):
    @abc.abstractmethod
    def init(self, image, box):
        """Start tracking ``box`` (xywh) in ``image`` (RGB uint8)."""

    @abc.abstractmethod
    def update(self, image):
        """Advance one frame; returns (box_xywh, score)."""

    def track_yield(self, images):
        """Yield a :class:`TrackResult` a frame with its wall-clock time
        (frame 0 through :meth:`init_frame`)."""
        for f, image in enumerate(images):
            start = time.time()
            if f == 0:
                box, score = self.init_frame(image)
            else:
                box, score = self.update(image)
            yield TrackResult(np.asarray(box), float(score),
                              time.time() - start)

    def init_frame(self, image):
        raise RuntimeError(
            "call track(images, init_box) or init() before track_yield")

    def track(self, images, init_box, return_all=True):
        """Track through a frame sequence (RGB uint8 arrays, or paths)
        from the xywh ``init_box`` of the first frame.

        Returns (boxes [T, 4] xywh, scores [T], times [T]), or the last
        frame's with ``return_all=False``.
        """
        boxes, scores, times = [], [], []
        for f, im in enumerate(images):
            if isinstance(im, str):
                im = read_rgb(im)
            start = time.time()
            if f == 0:
                self.init(im, init_box)
                box, score = np.asarray(init_box, float), 1.0
            else:
                box, score = self.update(im)
            boxes.append(np.asarray(box))
            scores.append(score)
            times.append(time.time() - start)
        if return_all:
            return np.stack(boxes), np.asarray(scores), np.asarray(times)
        return boxes[-1], scores[-1], times[-1]
