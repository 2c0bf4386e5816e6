"""Filesystem and misc helpers.

Port of :mod:`tao_amodal_tpu.utils.fs` (the reference's
``visualization/tao/utils/{fs,misc}.py``): extension-filtered globbing,
bool parsing, simple tables, and the MOT-style detection files.
"""

from __future__ import annotations

import glob as _glob
import os

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")
VID_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv")


def glob_ext(path, extensions, recursive=False):
    """All files under ``path`` with one of ``extensions``, sorted."""
    pattern = os.path.join(path, "**" if recursive else "*")
    files = _glob.glob(pattern, recursive=recursive)
    return sorted(f for f in files
                  if os.path.splitext(f)[1].lower() in extensions)


def parse_bool(value):
    if isinstance(value, bool):
        return value
    return str(value).lower() in ("yes", "true", "t", "1")


def simple_table(rows):
    """An aligned two-column table of ``(key, value)`` rows."""
    if not rows:
        return ""
    width = max(len(str(r[0])) for r in rows)
    return "\n".join(f"{str(k):<{width}}  {v}" for k, v in rows)


def load_detection_mat(path):
    """A MOT-style detection file (``frame, id, x, y, w, h, score,
    ...`` rows) as a 2-d array."""
    return np.loadtxt(path, delimiter=",", ndmin=2)


def dump_detection_mat(path, dets):
    np.savetxt(path, np.asarray(dets), delimiter=",", fmt="%.2f")
