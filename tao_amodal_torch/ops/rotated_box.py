"""Rotated-box geometry: binary mask -> min-area rectangle polygon.

The port's numpy copy of ``tao_amodal_tpu/ops/rotated_box.py`` (SiamMask's
post-processing, the reference's ``cv2.minAreaRect`` of the mask's
largest contour): threshold -> on-pixel point set -> convex hull (Andrew's
monotone chain) -> rotating-calipers minimum-area rectangle.  The full
on-pixel set stands in for the largest contour (equal for the tracker's
single-target masks); a mask of at most ``min_area`` pixels falls back to
the axis-aligned state box, as the reference does.
"""

from __future__ import annotations

import numpy as np


def convex_hull(points):
    """Andrew's monotone chain.  points ``[N, 2]`` float ->
    counter-clockwise hull vertices ``[M, 2]``."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    # lexicographic sort (x, then y)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return ((a[0] - o[0]) * (b[1] - o[1])
                - (a[1] - o[1]) * (b[0] - o[0]))

    lower = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def min_area_rect(points):
    """Minimum-area enclosing rectangle of a point set.

    Returns corners ``[4, 2]`` (a rotating-calipers sweep over hull
    edges: the optimal rectangle has one side collinear with a hull
    edge).
    """
    hull = convex_hull(points)
    if len(hull) == 0:
        return np.zeros((4, 2))
    if len(hull) == 1:
        return np.repeat(hull, 4, axis=0)
    if len(hull) == 2:
        # Degenerate: a segment.
        return np.asarray([hull[0], hull[1], hull[1], hull[0]],
                          np.float64)

    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    angles = np.arctan2(edges[:, 1], edges[:, 0])
    best = None
    for theta in angles:
        c, s = np.cos(-theta), np.sin(-theta)
        rot = np.array([[c, -s], [s, c]])
        proj = hull @ rot.T
        lo = proj.min(axis=0)
        hi = proj.max(axis=0)
        area = np.prod(hi - lo)
        if best is None or area < best[0]:
            best = (area, theta, lo, hi)
    _, theta, lo, hi = best
    corners_local = np.array([[lo[0], lo[1]], [hi[0], lo[1]],
                              [hi[0], hi[1]], [lo[0], hi[1]]])
    c, s = np.cos(theta), np.sin(theta)
    rot_back = np.array([[c, -s], [s, c]])
    return corners_local @ rot_back.T


def mask_to_rotated_box(mask, threshold=0.3, min_area=100.0,
                        fallback_rect=None):
    """Threshold a soft mask and fit the min-area rotated rectangle.

    Args:
      mask: ``[H, W]`` float (e.g. sigmoid probabilities) in the
        target coordinate frame.
      threshold: binarization threshold (reference
        ``TRACK.MASK_THERSHOLD``).
      min_area: below this on-pixel count, fall back (reference
        ``siammask_tracker.py:49``: contour area > 100).
      fallback_rect: ``[x, y, w, h]``; returned as an axis-aligned
        4-corner polygon when the mask is empty/small.

    Returns polygon corners ``[4, 2]`` (x, y) float64.
    """
    ys, xs = np.nonzero(np.asarray(mask) > threshold)
    if len(xs) < 4 or len(xs) <= min_area:
        if fallback_rect is None:
            return np.zeros((4, 2))
        x, y, w, h = fallback_rect
        return np.array([[x, y], [x + w, y], [x + w, y + h],
                         [x, y + h]], np.float64)
    pts = np.stack([xs, ys], axis=1).astype(np.float64)
    return min_area_rect(pts)


def polygon_area(poly):
    """Shoelace area of an ``[N, 2]`` polygon."""
    x = poly[:, 0]
    y = poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1))
                     - np.dot(y, np.roll(x, -1)))
