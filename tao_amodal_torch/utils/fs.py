"""Filesystem helpers: the port's copy of the extension-filtered glob of
``tao_amodal_tpu/utils/fs.py``."""

from __future__ import annotations

import glob as _glob
import os

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def glob_ext(path, extensions, recursive=False):
    """All files under ``path`` with one of ``extensions``, sorted."""
    pattern = os.path.join(path, "**" if recursive else "*")
    files = _glob.glob(pattern, recursive=recursive)
    return sorted(f for f in files
                  if os.path.splitext(f)[1].lower() in extensions)
