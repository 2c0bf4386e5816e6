"""Build and ctypes binding of the port's host library: the run-length
mask codec and pycocotools' box IoU and box NMS (``rle.cc``), and the
VOT polygon overlap (``region.cc``), the counterpart of
``tao_amodal_tpu/native/lib.py`` (whose class name, ``NativeLib``, is an
alias of :class:`NativeRle` here).

The library is compiled with the host's C++ compiler (``$CXX``, else
``g++``) into ``build/tao_amodal_torch/`` at the repository root, under
a name hashed from the sources, the flags and the compiler's version, so
an edited source or another machine's compiler never loads a stale
build.  The compiler writes a temporary file that is renamed into place,
so processes that build at once never load a half-written library.  A
failed build raises: neither the codec nor the polygon overlap has a
silent fallback (the numpy functions of :mod:`tao_amodal_torch.ops.mask`
are the codec's plain versions, which the tests hold it against; the
tests hold the overlap to the JAX package's library).  Marshalling is
plain numpy buffers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, f) for f in ("rle.cc", "region.cc"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "tao_amodal_torch")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _compiler():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (set CXX): the RLE codec of "
                           "tao_amodal_torch builds with g++")
    return cxx


def library_path(cxx=None):
    cxx = cxx or _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join((cxx, version) + FLAGS).encode())
    for source in SOURCES:
        with open(source, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtao_rle_{h.hexdigest()[:16]}.so")


def build():
    """Compile ``rle.cc`` and ``region.cc`` unless the library for these
    sources, these flags and this compiler exists; returns its path."""
    cxx = _compiler()
    path = library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, *SOURCES],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the host library failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


class NativeRle:
    """Typed wrapper over the codec (counts are uint32 numpy arrays), the
    box IoU and NMS (xywh float64) and the polygon overlap."""

    MAX_COUNTS = 1 << 22

    def __init__(self, so_path):
        lib = ctypes.CDLL(so_path)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        c_int, c_i64 = ctypes.c_int, ctypes.c_int64
        for name, res, args in (
                ("rle_encode", c_int, [u8p, c_i64, u32p, c_int]),
                ("rle_decode", None, [u32p, c_int, u8p, c_i64]),
                ("rle_area", ctypes.c_double, [u32p, c_int]),
                ("rle_merge_pair", c_int,
                 [u32p, c_int, u32p, c_int, c_int, u32p, c_int]),
                ("rle_iou_pair", ctypes.c_double,
                 [u32p, c_int, u32p, c_int, c_int]),
                ("rle_iou_matrix", None,
                 [u32p, i64p, c_int, u32p, i64p, c_int, u8p, f64p]),
                ("rle_to_bbox", None, [u32p, c_int, c_int, f64p]),
                ("rle_from_poly", c_int,
                 [f64p, c_int, c_int, c_int, u32p, c_int]),
                ("rle_compress", c_int,
                 [u32p, c_int, ctypes.c_char_p, c_int]),
                ("rle_decompress", c_int,
                 [ctypes.c_char_p, c_i64, i64p, c_int]),
                ("region_polygon_overlap", ctypes.c_double,
                 [f64p, c_int, f64p, c_int, c_int, c_int]),
                ("bbox_iou_matrix", None,
                 [f64p, c_int, f64p, c_int, u8p, f64p]),
                ("bbox_nms", None, [f64p, c_int, ctypes.c_double, u8p])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        self.path = so_path
        self._lib = lib

    @staticmethod
    def _u32(a):
        return np.ascontiguousarray(a, dtype=np.uint32)

    @staticmethod
    def _ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    def encode_counts(self, mask):
        """uint8 mask ``[h, w]`` -> its column-major counts."""
        flat = np.asfortranarray(mask, dtype=np.uint8).reshape(-1, order="F")
        out = np.empty(min(flat.size + 2, self.MAX_COUNTS), np.uint32)
        m = self._lib.rle_encode(self._ptr(flat, ctypes.c_uint8), flat.size,
                                 self._ptr(out, ctypes.c_uint32), out.size)
        if m < 0:
            raise RuntimeError("rle_encode overflow")
        return out[:m].copy()

    def decode_counts(self, counts, h, w):
        counts = self._u32(counts)
        out = np.zeros(h * w, np.uint8)
        self._lib.rle_decode(self._ptr(counts, ctypes.c_uint32),
                             len(counts), self._ptr(out, ctypes.c_uint8),
                             out.size)
        return out.reshape((h, w), order="F")

    def area(self, counts):
        counts = self._u32(counts)
        return self._lib.rle_area(self._ptr(counts, ctypes.c_uint32),
                                  len(counts))

    def merge_pair(self, a, b, intersect=False):
        a, b = self._u32(a), self._u32(b)
        out = np.empty(len(a) + len(b) + 2, np.uint32)
        m = self._lib.rle_merge_pair(
            self._ptr(a, ctypes.c_uint32), len(a),
            self._ptr(b, ctypes.c_uint32), len(b), int(intersect),
            self._ptr(out, ctypes.c_uint32), out.size)
        if m < 0:
            raise RuntimeError("rle_merge overflow")
        return out[:m].copy()

    def iou_pair(self, a, b, iscrowd=False):
        a, b = self._u32(a), self._u32(b)
        return self._lib.rle_iou_pair(
            self._ptr(a, ctypes.c_uint32), len(a),
            self._ptr(b, ctypes.c_uint32), len(b), int(iscrowd))

    def iou_matrix(self, dt_counts_list, gt_counts_list, iscrowd=None):
        """Pairwise RLE IoU ``[n_dt, n_gt]`` over lists of counts."""
        def pack(lst):
            off = np.zeros(len(lst) + 1, np.int64)
            off[1:] = np.cumsum([len(c) for c in lst])
            packed = (np.concatenate([self._u32(c) for c in lst])
                      if lst else np.zeros(0, np.uint32))
            return np.ascontiguousarray(packed, np.uint32), off

        d, doff = pack(dt_counts_list)
        g, goff = pack(gt_counts_list)
        crowd = np.zeros(len(gt_counts_list), np.uint8)
        if iscrowd is not None:
            crowd[:] = np.asarray(iscrowd, np.uint8)
        out = np.zeros((len(dt_counts_list), len(gt_counts_list)),
                       np.float64)
        if out.size:
            self._lib.rle_iou_matrix(
                self._ptr(d, ctypes.c_uint32),
                self._ptr(doff, ctypes.c_int64), len(dt_counts_list),
                self._ptr(g, ctypes.c_uint32),
                self._ptr(goff, ctypes.c_int64), len(gt_counts_list),
                self._ptr(crowd, ctypes.c_uint8),
                self._ptr(out, ctypes.c_double))
        return out

    def to_bbox(self, counts, h):
        counts = self._u32(counts)
        out = np.zeros(4, np.float64)
        self._lib.rle_to_bbox(self._ptr(counts, ctypes.c_uint32),
                              len(counts), h,
                              self._ptr(out, ctypes.c_double))
        return out

    def poly_counts(self, xy, h, w):
        """Polygon coordinates ``[x0, y0, x1, y1, ...]`` -> its counts."""
        xy = np.ascontiguousarray(xy, np.float64)
        # A small buffer first (a polygon's counts are about twice its
        # columns), the largest on overflow.
        for size in (4096, self.MAX_COUNTS):
            out = np.empty(size, np.uint32)
            m = self._lib.rle_from_poly(
                self._ptr(xy, ctypes.c_double), len(xy) // 2, h, w,
                self._ptr(out, ctypes.c_uint32), out.size)
            if m >= 0:
                return out[:m].copy()
        raise RuntimeError("rle_from_poly overflow")


    def compress(self, counts):
        """counts -> pycocotools' compressed string (bytes)."""
        counts = self._u32(counts)
        # A count takes at most 7 characters (32 bits, 5 a character,
        # and a sign bit).
        out = ctypes.create_string_buffer(7 * len(counts) + 1)
        n = self._lib.rle_compress(self._ptr(counts, ctypes.c_uint32),
                                   len(counts), out, len(out))
        if n < 0:
            raise RuntimeError("rle_compress overflow")
        return out.raw[:n]

    def decompress(self, s):
        """pycocotools' compressed string (bytes or str) -> counts
        (int64; one count per character at most)."""
        if isinstance(s, str):
            s = s.encode()
        out = np.empty(len(s), np.int64)
        m = self._lib.rle_decompress(s, len(s),
                                     self._ptr(out, ctypes.c_int64),
                                     out.size)
        if m < 0:
            raise RuntimeError("rle_decompress overflow")
        return out[:m]


    def bbox_iou(self, dt, gt, iscrowd=None):
        """Pairwise IoU ``[n_dt, n_gt]`` float64 of xywh boxes (crowd
        ``gt`` boxes divide by the detection's area alone)."""
        dt = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
        gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
        crowd = np.zeros(len(gt), np.uint8)
        if iscrowd is not None:
            crowd[:] = np.asarray(iscrowd, np.uint8)
        out = np.zeros((len(dt), len(gt)), np.float64)
        if out.size:
            self._lib.bbox_iou_matrix(
                self._ptr(dt, ctypes.c_double), len(dt),
                self._ptr(gt, ctypes.c_double), len(gt),
                self._ptr(crowd, ctypes.c_uint8),
                self._ptr(out, ctypes.c_double))
        return out

    def bbox_nms(self, boxes, thr):
        """Greedy NMS keep mask (bool ``[n]``) of xywh ``boxes`` sorted by
        descending score: a box goes where a kept one before it has IoU
        above ``thr``."""
        boxes = np.ascontiguousarray(boxes, np.float64).reshape(-1, 4)
        keep = np.zeros(len(boxes), np.uint8)
        self._lib.bbox_nms(self._ptr(boxes, ctypes.c_double), len(boxes),
                           float(thr), self._ptr(keep, ctypes.c_uint8))
        return keep.astype(bool)

    def polygon_overlap(self, p1, p2, bounds=None):
        """VOT region overlap (IoU by rasterization) of two polygons
        ``[x0, y0, x1, y1, ...]``; ``bounds=(w, h)`` clips both to the
        frame."""
        p1 = np.ascontiguousarray(p1, np.float64).reshape(-1)
        p2 = np.ascontiguousarray(p2, np.float64).reshape(-1)
        bw, bh = bounds if bounds is not None else (0, 0)
        return self._lib.region_polygon_overlap(
            self._ptr(p1, ctypes.c_double), len(p1) // 2,
            self._ptr(p2, ctypes.c_double), len(p2) // 2, int(bw), int(bh))


# The JAX package's name for the class.
NativeLib = NativeRle


@functools.cache
def load():
    """The host library, built on first use (raises if it cannot be
    built)."""
    return NativeRle(build())
