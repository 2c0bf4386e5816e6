"""Derive the tables that ``tao_amodal_torch/utils/raster.py`` draws text
and anti-aliased contours with, from the installed OpenCV.

The JAX package draws its labels with ``cv2.putText`` and its mask contours
with ``cv2.drawContours(..., LINE_AA)``.  OpenCV 5 draws the Hershey faces as
TrueType glyphs, so no stroke table can be copied; instead this script
records, for every printable ASCII character at the four (face, scale)
pairs the JAX package uses, what OpenCV itself produces:

* the integer advance and the baseline that ``cv2.getTextSize`` adds up
  (its width is the sum of the advances plus one, its height a constant of
  the face, its baseline the largest of the characters'),
* the glyph's anti-aliased coverage (``cv2.putText`` of the character alone,
  white on black), cropped to its ink, with its offset from the text origin,

and the weights of a one-pixel anti-aliased segment in each of the eight
directions (and of a single point), which is what a contour of
``CHAIN_APPROX_NONE`` points is made of: OpenCV writes each pixel such a
segment touches twice, ``x += ((color - x) * a + 127) >> 8``, and the
script finds the one ``a`` that reproduces it for every background and
colour.

It is the only module of the repository that imports cv2 for the port, and
it runs on a machine that has it:

    python experiments/derive_raster_tables.py [--out PATH]

and rewrites ``tao_amodal_torch/utils/raster_tables.npz`` (a few tens of KB).
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

FACES = (("simplex_0.5", cv2.FONT_HERSHEY_SIMPLEX, 0.5),
         ("triplex_0.35", cv2.FONT_HERSHEY_TRIPLEX, 0.35),
         ("triplex_0.5", cv2.FONT_HERSHEY_TRIPLEX, 0.5),
         ("simplex_0.1", cv2.FONT_HERSHEY_SIMPLEX, 0.1))
CHARS = [chr(c) for c in range(32, 127)]
PAD = 64


def face_tables(font, scale):
    adv, base, boxes, offsets, ink = [], [], [], [], []
    heights = set()
    pos = 0
    for ch in CHARS:
        (w, h), b = cv2.getTextSize(ch, font, scale, 1)
        adv.append(w - 1)
        base.append(b)
        heights.add(h)
        img = np.zeros((2 * PAD, 2 * PAD), np.uint8)
        cv2.putText(img, ch, (PAD, PAD), font, scale, 255, 1, cv2.LINE_AA)
        ys, xs = np.nonzero(img)
        if len(xs):
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            crop = img[y0:y1, x0:x1]
            boxes.append((x0 - PAD, y0 - PAD, x1 - x0, y1 - y0))
        else:
            crop = np.zeros((0, 0), np.uint8)
            boxes.append((0, 0, 0, 0))
        offsets.append(pos)
        ink.append(crop.ravel())
        pos += crop.size
    assert len(heights) == 1, heights
    return {"advance": np.asarray(adv, np.int16),
            "baseline": np.asarray(base, np.int16),
            "height": np.asarray(heights.pop(), np.int16),
            "box": np.asarray(boxes, np.int16),
            "offset": np.asarray(offsets, np.int32),
            "ink": np.concatenate(ink).astype(np.uint8)}


def _put_point(x, c, a):
    """OpenCV's anti-aliased pixel write (``LineAA``): each pixel a
    segment touches is blended twice with its weight ``a`` in [0, 256]."""
    for _ in range(2):
        x = x + (((c - x) * a + 127) >> 8)
    return x


def line_stencils():
    """[9, 5, 5] weights ``a`` of a segment from the centre of a 5x5 window
    to its neighbour (dx, dy), indexed (dy + 1) * 3 + (dx + 1): the one
    weight in [0, 256] whose double write reproduces ``cv2.polylines(...,
    LINE_AA)`` of that segment for every background and colour."""
    bg, c = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    weights = np.arange(257)
    grid = _put_point(bg[None], c[None], weights[:, None, None])
    out = np.zeros((9, 5, 5), np.int16)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            pts = np.asarray([(10, 10), (10 + dx, 10 + dy)], np.int32)
            drawn = np.zeros((256, 21, 21), np.int64)
            for v in range(256):                 # background v, colour 255 - v
                img = np.full((21, 21), v, np.uint8)
                cv2.polylines(img, [pts], False, 255 - v, 1, cv2.LINE_AA)
                drawn[v] = img
            assert (drawn[:, :8] == np.arange(256)[:, None, None]).all()
            for y in range(8, 13):
                for x in range(8, 13):
                    got = drawn[:, y, x]
                    want = grid[:, np.arange(256), 255 - np.arange(256)]
                    fit = np.nonzero((want == got[None]).all(1))[0]
                    assert len(fit), (dx, dy, y, x)
                    out[(dy + 1) * 3 + (dx + 1), y - 8, x - 8] = fit[0]
    return out


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=os.path.join(
        here, "..", "tao_amodal_torch", "utils", "raster_tables.npz"))
    args = p.parse_args(argv)
    arrays = {"cv2_version": np.asarray(cv2.__version__),
              "line_aa": line_stencils()}
    for key, font, scale in FACES:
        for name, value in face_tables(font, scale).items():
            arrays[f"{key}/{name}"] = value
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, "
          f"cv2 {cv2.__version__})")


if __name__ == "__main__":
    main()
