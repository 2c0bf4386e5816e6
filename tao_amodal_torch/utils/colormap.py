"""Detectron-style categorical color palette.

Port of :mod:`tao_amodal_tpu.utils.colormap` (the reference's
``tao_amodal/evaluation/lvis_amodal/colormap.py``): a fixed 79-color
palette for track and category coloring, RGB in [0, 255] by default,
generated by a golden-ratio HSV walk.
"""

from __future__ import annotations

import colorsys

import numpy as np

_NUM_COLORS = 79


def _generate(n=_NUM_COLORS):
    colors = []
    for i in range(n):
        h = (i * 0.61803398875) % 1.0
        s = 0.65 + 0.35 * ((i * 7) % 3) / 2.0
        v = 0.75 + 0.25 * ((i * 5) % 2)
        colors.append(colorsys.hsv_to_rgb(h, s, v))
    return np.asarray(colors) * 255.0


_PALETTE = _generate()


def colormap(rgb=False, maximum=255):
    """``[79, 3]`` palette; BGR unless ``rgb=True`` (the reference's
    OpenCV-oriented default)."""
    table = _PALETTE * (maximum / 255.0)
    if not rgb:
        table = table[:, ::-1]
    return table.copy()


def color_for_id(idx, rgb=True):
    """Stable color for a track or category id."""
    return colormap(rgb=rgb)[idx % _NUM_COLORS]
