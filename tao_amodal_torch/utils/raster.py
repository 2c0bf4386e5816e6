"""The drawing calls of the JAX package's visualization, in numpy.

The JAX package draws its overlays with OpenCV (``utils/vis.py``,
``utils/vis_ref.py``).  This module is the port's counterpart of the six
OpenCV calls those modules make, so the port draws without cv2:

* :func:`rectangle`: ``cv2.rectangle`` at ``LINE_8``, outline of thickness
  1-3 (a thick outline is the 1-pixel outline widened by OpenCV's round
  joins: a disk of radius ``(t + 1) // 2``, so the outer corners are cut)
  or filled (``thickness < 0``), equal byte for byte;
* :func:`add_weighted`: ``cv2.addWeighted`` on uint8, ``fma(a, alpha,
  fma(b, beta, gamma))`` in float32 rounded half to even, as OpenCV's
  vector path computes it, equal byte for byte;
* :func:`text_size` and :func:`put_text`: ``cv2.getTextSize`` and
  ``cv2.putText(..., LINE_AA)`` at thickness 1 for the four (face, scale)
  pairs the JAX package uses (``SIMPLEX`` 0.5 and 0.1, ``TRIPLEX`` 0.35
  and 0.5).
  OpenCV 5 places each glyph at an integer pen position (the advances its
  text size adds up) and blends the glyphs one after another over the
  image; with OpenCV's own glyph coverage (``raster_tables.npz``, written
  by ``experiments/derive_raster_tables.py``) both are equal byte for byte
  for printable ASCII.  Other characters are drawn as ``?`` (OpenCV 5 has
  glyphs for them);
* :func:`find_contours`: ``cv2.findContours(RETR_CCOMP,
  CHAIN_APPROX_NONE)``, Suzuki and Abe's border following; the same points,
  contours and hierarchy;
* :func:`draw_contours`: ``cv2.drawContours`` at thickness 1, ``LINE_AA``:
  each step between two contour points is OpenCV's anti-aliased one-pixel
  segment, its weights from the same table, blended segment after segment
  as OpenCV's ``LineAA`` blends them; equal byte for byte.

Images are ``uint8`` ``[H, W]`` or ``[H, W, C]``; the drawing functions
work in place and return the image, as OpenCV's do.
"""

from __future__ import annotations

import functools
import os

import numpy as np

FILLED = -1
FONT_HERSHEY_SIMPLEX = 0
FONT_HERSHEY_TRIPLEX = 4

_FACES = {(FONT_HERSHEY_SIMPLEX, 0.5): "simplex_0.5",
          (FONT_HERSHEY_TRIPLEX, 0.35): "triplex_0.35",
          (FONT_HERSHEY_TRIPLEX, 0.5): "triplex_0.5",
          (FONT_HERSHEY_SIMPLEX, 0.1): "simplex_0.1"}
_TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "raster_tables.npz")


@functools.lru_cache(maxsize=None)
def _tables():
    with np.load(_TABLES) as z:
        return {k: z[k] for k in z.files}


def _color(img, color):
    """OpenCV's Scalar -> the image's channels (``saturate_cast``: round
    half to even, clip to [0, 255]; missing channels are 0)."""
    c = np.atleast_1d(np.asarray(color, np.float64))
    n = img.shape[2] if img.ndim == 3 else 1
    c = np.concatenate([c, np.zeros(max(n - len(c), 0))])[:n]
    return np.clip(np.rint(c), 0, 255).astype(np.uint8)


def _fill(img, y0, y1, x0, x1, color):
    """Fill rows ``[y0, y1]`` x columns ``[x0, x1]`` (inclusive), clipped."""
    h, w = img.shape[:2]
    y0, x0 = max(y0, 0), max(x0, 0)
    y1, x1 = min(y1, h - 1), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color if img.ndim == 3 else color[0]


def rectangle(img, pt1, pt2, color, thickness=1):
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` at ``LINE_8``."""
    if thickness > 3:
        raise ValueError("rectangle draws thickness -1 (filled) or 1-3")
    c = _color(img, color)
    xa, xb = sorted((int(pt1[0]), int(pt2[0])))
    ya, yb = sorted((int(pt1[1]), int(pt2[1])))
    if thickness < 0:
        _fill(img, ya, yb, xa, xb, c)
        return img
    r = (thickness + 1) // 2 if thickness > 1 else 0
    for d in range(-r, r + 1):
        hw = int(np.floor(np.sqrt(r * r - d * d)))
        for y in (ya, yb):                       # top and bottom edges
            _fill(img, y + d, y + d, xa - hw, xb + hw, c)
        for x in (xa, xb):                       # left and right edges
            _fill(img, ya - hw, yb + hw, x + d, x + d, c)
    return img


def _fma(x, y, z):
    """float32 ``x * y + z`` rounded once (exact in float64 for the uint8
    operands and float32 weights here)."""
    return (x.astype(np.float64) * np.float64(y)
            + np.asarray(z, np.float64)).astype(np.float32)


def add_weighted(src1, alpha, src2, beta, gamma, dst=None):
    """``cv2.addWeighted`` of two uint8 images."""
    a = np.float32(alpha)
    b = np.float32(beta)
    g = np.float32(gamma)
    t = _fma(src1, a, _fma(src2, b, g))
    out = np.clip(np.rint(t), 0, 255).astype(np.uint8)
    if dst is None:
        return out
    dst[...] = out
    return dst


def _face(font_face, font_scale, thickness):
    key = _FACES.get((int(font_face), float(font_scale)))
    if key is None or thickness != 1:
        raise ValueError(
            f"no glyph table for face {font_face} at scale {font_scale}, "
            f"thickness {thickness}; tables: {sorted(_FACES)} at "
            "thickness 1")
    t = _tables()
    return {name: t[f"{key}/{name}"] for name in
            ("advance", "baseline", "height", "box", "offset", "ink")}


def _codes(text):
    """Printable-ASCII table rows of ``text`` (anything else draws '?')."""
    return [ord(ch) - 32 if 32 <= ord(ch) < 127 else ord("?") - 32
            for ch in text]


def text_size(text, font_face, font_scale, thickness=1):
    """``cv2.getTextSize``: ``((width, height), baseline)``."""
    f = _face(font_face, font_scale, thickness)
    codes = _codes(text)
    if not codes:
        return (0, 0), 0
    width = int(f["advance"][codes].sum()) + 1
    return (width, int(f["height"])), int(f["baseline"][codes].max())


def put_text(img, text, org, font_face, font_scale, color, thickness=1):
    """``cv2.putText(img, text, org, ..., lineType=LINE_AA)``: each glyph's
    coverage ``a`` blended over the image as ``(bg * (255 - a) + color * a
    + 127) // 255``, glyph after glyph."""
    f = _face(font_face, font_scale, thickness)
    c = _color(img, color).astype(np.int32)
    h, w = img.shape[:2]
    pen, base = int(org[0]), int(org[1])
    for code in _codes(text):
        gx, gy, gw, gh = (int(v) for v in f["box"][code])
        if gw:
            x0, y0 = pen + gx, base + gy
            cx0, cy0 = max(x0, 0), max(y0, 0)
            cx1, cy1 = min(x0 + gw, w), min(y0 + gh, h)
            if cx0 < cx1 and cy0 < cy1:
                off = int(f["offset"][code])
                a = f["ink"][off:off + gw * gh].reshape(gh, gw)
                a = a[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0].astype(np.int32)
                region = img[cy0:cy1, cx0:cx1]
                if img.ndim == 3:
                    a = a[..., None]
                    blend = (region * (255 - a) + c * a + 127) // 255
                else:
                    blend = (region * (255 - a) + c[0] * a + 127) // 255
                img[cy0:cy1, cx0:cx1] = blend.astype(img.dtype)
        pen += int(f["advance"][code])
    return img


# 8-neighbour steps (di, dj), counterclockwise on the screen from east.
_DI = (0, -1, -1, -1, 0, 1, 1, 1)
_DJ = (1, 1, 0, -1, -1, -1, 0, 1)
_STEP = {(di, dj): k for k, (di, dj) in enumerate(zip(_DI, _DJ))}


def _follow(f, i, j, i2, j2, nbd):
    """Suzuki-Abe step 3: follow the border that starts at (i, j) with its
    zero neighbour (i2, j2), marking it in ``f`` (a list of rows, padded);
    returns its points as (x, y) of the unpadded image."""
    d0 = _STEP[(i2 - i, j2 - j)]
    for s in range(8):                           # (3.1) clockwise
        k = (d0 - s) % 8
        if f[i + _DI[k]][j + _DJ[k]]:
            i1, j1 = i + _DI[k], j + _DJ[k]
            break
    else:
        f[i][j] = -nbd
        return [(j - 1, i - 1)]
    pts = [(j - 1, i - 1)]
    i2, j2, i3, j3 = i1, j1, i, j
    while True:
        d = _STEP[(i2 - i3, j2 - j3)]
        east_zero = False
        for s in range(1, 9):                    # (3.3) counterclockwise
            k = (d + s) % 8
            i4, j4 = i3 + _DI[k], j3 + _DJ[k]
            if f[i4][j4]:
                break
            if k == 0:
                east_zero = True
        if east_zero:                            # (3.4)
            f[i3][j3] = -nbd
        elif f[i3][j3] == 1:
            f[i3][j3] = nbd
        if i4 == i and j4 == j and i3 == i1 and j3 == j1:
            return pts
        i2, j2, i3, j3 = i3, j3, i4, j4
        pts.append((j3 - 1, i3 - 1))


def find_contours(mask):
    """``cv2.findContours(mask, RETR_CCOMP, CHAIN_APPROX_NONE)``:
    ``(contours, hierarchy)``, each contour ``int32 [N, 1, 2]`` of (x, y)
    points, ``hierarchy`` ``int32 [1, K, 4]`` (next, previous, first child,
    parent) or None.  Outer borders are the top level, each followed by
    its holes; both in the reverse of their scan order, as OpenCV lists
    them.  Nonzero pixels are foreground, 8-connected; outside the image
    is background."""
    h, w = mask.shape
    fg = np.zeros((h + 2, w + 2), bool)
    fg[1:-1, 1:-1] = np.asarray(mask) != 0
    # A border starts at a foreground pixel with background on its left
    # (outer) or right (hole); the scan visits only those pixels.
    starts = fg & (~np.roll(fg, 1, axis=1) | ~np.roll(fg, -1, axis=1))
    f = fg.astype(np.int64).tolist()
    outer_of = {1: False}                       # NBD 1 is the frame (a hole)
    parent_of = {1: 0}
    found = []                                  # (nbd, is_outer, points)
    nbd = 1
    for i, j in zip(*np.nonzero(starts)):
        i, j = int(i), int(j)
        v = f[i][j]
        if v == 1 and f[i][j - 1] == 0:
            is_outer, i2, j2 = True, i, j - 1
        elif v >= 1 and f[i][j + 1] == 0:
            is_outer, i2, j2 = False, i, j + 1
        else:
            continue
        if not is_outer and v > 1:
            lnbd = v
        else:                                    # last border left of j
            row, lnbd = f[i], 1
            for k in range(j - 1, -1, -1):
                if row[k] not in (0, 1):
                    lnbd = abs(row[k])
                    break
        nbd += 1
        if is_outer == outer_of[lnbd]:
            parent_of[nbd] = parent_of[lnbd]
        else:
            parent_of[nbd] = lnbd
        outer_of[nbd] = is_outer
        found.append((nbd, is_outer, _follow(f, i, j, i2, j2, nbd)))
    if not found:
        return (), None
    holes = {}
    for n, is_outer, pts in found:
        if not is_outer:
            holes.setdefault(parent_of[n], []).append(pts)
    contours, rows, prev_top = [], [], -1
    for n, is_outer, pts in reversed(found):
        if not is_outer:
            continue
        top = len(contours)
        if prev_top >= 0:
            rows[prev_top][0] = top
        contours.append(pts)
        rows.append([-1, prev_top, -1, -1])
        prev_top = top
        prev = -1
        for hole in reversed(holes.get(n, [])):
            k = len(contours)
            if prev < 0:
                rows[top][2] = k
            else:
                rows[prev][0] = k
            contours.append(hole)
            rows.append([-1, prev, -1, top])
            prev = k
    contours = tuple(np.asarray(p, np.int32).reshape(-1, 1, 2)
                     for p in contours)
    return contours, np.asarray([rows], np.int32)


def draw_contours(img, contours, contour_idx, color, thickness=1):
    """``cv2.drawContours(img, contours, contour_idx, color, 1,
    lineType=LINE_AA)`` for contours of neighbouring points (as
    :func:`find_contours` returns them), each drawn closed: segments
    ``p[k] -> p[k+1]`` for k = 0, 1, ..., the one back to ``p[0]`` last
    (``cv2.polylines`` draws that one first), each pixel of
    a segment written twice as ``x += ((color - x) * a + 127) >> 8`` with
    OpenCV's weight ``a`` for that step."""
    if thickness != 1:
        raise ValueError("draw_contours draws thickness 1 only")
    chosen = contours if contour_idx < 0 else [contours[contour_idx]]
    h, w = img.shape[:2]
    starts, dirs = [], []
    for cnt in chosen:
        p = np.asarray(cnt, np.int64).reshape(-1, 2)
        step = np.roll(p, -1, axis=0) - p
        if np.abs(step).max(initial=0) > 1:
            raise ValueError("draw_contours needs neighbouring points "
                             "(CHAIN_APPROX_NONE)")
        starts.append(p)
        dirs.append((step[:, 1] + 1) * 3 + (step[:, 0] + 1))
    if not starts:
        return img
    # Every (segment, tap) in drawing order; a pixel's writes are applied in
    # that order, all pixels at once: rank r is each pixel's r-th write.
    p, d = np.concatenate(starts), np.concatenate(dirs)
    a = _tables()["line_aa"].astype(np.int64)[d].reshape(len(d), 25)
    oy, ox = np.divmod(np.arange(25), 5)
    y = (p[:, 1, None] + oy - 2).ravel()
    x = (p[:, 0, None] + ox - 2).ravel()
    a = a.ravel()
    keep = (a > 0) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    pix, a = (y * w + x)[keep], a[keep]
    order = np.argsort(pix, kind="stable")
    pix, a = pix[order], a[order]
    first = np.r_[True, pix[1:] != pix[:-1]]
    group = np.cumsum(first) - 1
    rank = np.arange(len(pix)) - np.flatnonzero(first)[group]
    work = np.ascontiguousarray(img)
    flat = work.reshape(h * w, -1)
    c = _color(img, color).astype(np.int64)
    uniq = pix[first]
    v = flat[uniq].astype(np.int64)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        g, ar = group[sel], a[sel][:, None]
        vg = v[g]
        for _ in range(2):
            vg = vg + (((c - vg) * ar + 127) >> 8)
        v[g] = vg
    flat[uniq] = v.astype(img.dtype)
    if work is not img:
        img[...] = work
    return img
