"""COCO-style RLE mask codec (pycocotools-compatible API).

Port of :mod:`tao_amodal_tpu.ops.mask`: run-length masks are column-major
(Fortran order) alternating runs starting with a zero-run, compressed to
the LEB128-style strings pycocotools writes, so RLE strings are
interchangeable with BURST masks and LVIS segmentations.

The run-level work (merging, intersections, mask IoU without decoding,
polygon rasterization) and the counts' string form run in the port's
C++ codec
(:mod:`tao_amodal_torch.native.lib`, built on first use; a failed build
raises).  The numpy functions named ``*_numpy`` compute the same on
decoded masks or in plain numpy: they are its plain versions, which the
tests hold it against.  Encoding, decoding, areas and boxes are
vectorized numpy, as in the JAX package.  :func:`mask_iou_dense` is the
dense-bitmask IoU as one matrix product on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from tao_amodal_torch.native import lib as native_lib
from tao_amodal_torch.ops.boxes import box_iou_matrix


def _native():
    return native_lib.load()


# ----------------------------------------------------------------------
# Core run-length representation: dict {"size": [h, w], "counts": ...}
# counts either a list of ints (uncompressed) or a bytes/str (compressed).
# ----------------------------------------------------------------------

def encode(mask):
    """Binary mask ``[h, w]`` (or ``[h, w, n]``) -> compressed RLE dict(s).

    Column-major runs, first run counts zeros.
    """
    if mask.ndim == 3:
        return [encode(mask[:, :, i]) for i in range(mask.shape[2])]
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    if flat.size == 0:
        counts = []
    else:
        change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        bounds = np.concatenate([[0], change, [flat.size]])
        counts = np.diff(bounds).tolist()
        if flat[0] == 1:
            counts = [0] + counts
    return {"size": [h, w], "counts": _compress(counts)}


def decode(rle):
    """RLE dict (compressed or uncompressed) -> uint8 mask ``[h, w]``.

    Lists of RLEs decode to ``[h, w, n]``.
    """
    if isinstance(rle, (list, tuple)):
        masks = [decode(r) for r in rle]
        return (np.stack(masks, axis=2) if masks
                else np.zeros((0, 0, 0), np.uint8))
    h, w = rle["size"]
    counts = _counts_list(rle)
    flat = np.zeros(h * w, dtype=np.uint8)
    if counts:
        bounds = np.concatenate([[0], np.cumsum(counts)])
        # Runs alternate starting with zeros: 1-run i is
        # [bounds[2i+1], bounds[2i+2]).
        ends = np.append(bounds[2::2], h * w)
        for s, e in zip(bounds[1::2], ends):
            flat[s:e] = 1
    return flat.reshape((h, w), order="F")


def area(rle):
    """Foreground pixel count; works on a dict or list of dicts."""
    if isinstance(rle, (list, tuple)):
        return np.array([area(r) for r in rle], dtype=np.uint64)
    return int(sum(_counts_list(rle)[1::2]))


def to_bbox(rle):
    """RLE -> xywh bbox (float), matching pycocotools ``toBbox``."""
    if isinstance(rle, (list, tuple)):
        return np.stack([to_bbox(r) for r in rle]).astype(np.float64)
    h, w = rle["size"]
    counts = np.asarray(_counts_list(rle), dtype=np.int64)
    if counts.sum() == 0 or len(counts) < 2 or counts[1::2].sum() == 0:
        return np.zeros(4, dtype=np.float64)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    starts = bounds[1::2][: len(counts[1::2])]       # start index of 1-runs
    ends = starts + counts[1::2]                      # end (exclusive)
    cols_s, rows_s = np.divmod(starts, h)
    cols_e, rows_e = np.divmod(ends - 1, h)
    # A 1-run that spans columns covers full rows.
    if (cols_e > cols_s).any():
        ymin, ymax = 0, h - 1
    else:
        ymin, ymax = int(rows_s.min()), int(rows_e.max())
    xmin, xmax = int(cols_s.min()), int(cols_e.max())
    return np.array([xmin, ymin, xmax - xmin + 1, ymax - ymin + 1],
                    dtype=np.float64)


def from_bbox(boxes, h, w):
    """xywh boxes ``[n, 4]`` -> list of RLEs (rasterized rectangles)."""
    boxes = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
    out = []
    for x, y, bw, bh in boxes:
        poly = [x, y, x, y + bh, x + bw, y + bh, x + bw, y]
        out.append(from_poly([poly], h, w)[0])
    return out


def merge(rles, intersect=False):
    """Union (or intersection) of RLEs -> one RLE, run by run in the
    native codec."""
    if not isinstance(rles, (list, tuple)):
        return rles
    if len(rles) == 1:
        return dict(rles[0])
    native = _native()
    acc = counts_of(rles[0])
    for r in rles[1:]:
        acc = native.merge_pair(acc, counts_of(r), intersect=intersect)
    return {"size": list(rles[0]["size"]), "counts": _compress(acc)}


def merge_numpy(rles, intersect=False):
    """Plain version of :func:`merge`: decode, combine, encode."""
    if not isinstance(rles, (list, tuple)):
        return rles
    if len(rles) == 1:
        return dict(rles[0])
    masks = decode(list(rles))
    combined = np.all(masks, axis=2) if intersect else np.any(masks, axis=2)
    return encode(combined.astype(np.uint8))


def intersect_area(a, b):
    """Exact ``|A ∩ B|`` (pixel count) of two same-size RLEs."""
    return intersect_counts(counts_of(a), counts_of(b))


def intersect_counts(a, b):
    """:func:`intersect_area` of two RLEs' counts (:func:`counts_of`)."""
    acc = _native().merge_pair(a, b, intersect=True)
    return int(acc[1::2].sum(dtype=np.int64))


def intersect_area_numpy(a, b):
    """Plain version of :func:`intersect_area`, on decoded masks."""
    return int(np.logical_and(decode(a), decode(b)).sum())


def iou(dt, gt, iscrowd):
    """Pairwise IoU of detections vs gts; boxes or RLEs.

    pycocotools-``mask.iou``-compatible: inputs may be ``[n, 4]`` xywh
    arrays (box IoU) or lists of RLE dicts (mask IoU, a run-level sweep
    in the native codec); ``iscrowd[g]`` switches the denominator to the
    dt area.  ``[]`` when either side is empty.
    """
    if _is_box_input(dt) and _is_box_input(gt):
        d = np.asarray(dt, dtype=np.float64).reshape(-1, 4)
        g = np.asarray(gt, dtype=np.float64).reshape(-1, 4)
        if d.size == 0 or g.size == 0:
            return []
        return np.asarray(box_iou_matrix(d, g, iscrowd=np.asarray(
            iscrowd, dtype=bool) if len(iscrowd) else None))
    dts = dt if isinstance(dt, (list, tuple)) else [dt]
    gts = gt if isinstance(gt, (list, tuple)) else [gt]
    if not dts or not gts:
        return []
    return _native().iou_matrix(
        [counts_of(r) for r in dts], [counts_of(r) for r in gts],
        iscrowd=iscrowd if iscrowd is not None and len(iscrowd) else None)


def iou_numpy(dt, gt, iscrowd):
    """Plain version of :func:`iou` for RLE lists, on decoded masks."""
    dts = dt if isinstance(dt, (list, tuple)) else [dt]
    gts = gt if isinstance(gt, (list, tuple)) else [gt]
    if not dts or not gts:
        return []
    out = np.zeros((len(dts), len(gts)), dtype=np.float64)
    d_masks = [decode(r).astype(bool) for r in dts]
    g_masks = [decode(r).astype(bool) for r in gts]
    d_areas = [m.sum() for m in d_masks]
    g_areas = [m.sum() for m in g_masks]
    for i, dm in enumerate(d_masks):
        for j, gm in enumerate(g_masks):
            inter = np.logical_and(dm, gm).sum()
            if iscrowd is not None and len(iscrowd) > j and iscrowd[j]:
                denom = d_areas[i]
            else:
                denom = d_areas[i] + g_areas[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def mask_iou_dense(dt_masks, gt_masks, iscrowd=None):
    """Mask IoU ``[D, G]`` of dense bitmasks ``[D, H, W]`` and ``[G, H,
    W]`` (numpy or tensors; computed on ``dt_masks``' device, the CPU for
    numpy) as one f32 matrix product ``[D, HW] x [HW, G]``, as JAX's
    ``mask_iou_dense`` contracts them; ``iscrowd[g]`` switches the
    denominator to the dt area."""
    dt = torch.as_tensor(dt_masks)
    dev = dt.device
    d = dt.to(torch.float32).reshape(dt.shape[0], -1)
    g = torch.as_tensor(gt_masks, device=dev).to(torch.float32)
    g = g.reshape(g.shape[0], -1)
    inter = d @ g.T
    d_area = d.sum(1, keepdim=True)
    g_area = g.sum(1, keepdim=True).T
    union = d_area + g_area - inter
    if iscrowd is not None:
        crowd = torch.as_tensor(np.asarray(iscrowd, bool), device=dev)
        union = torch.where(crowd[None, :], d_area, union)
    return torch.where(union > 0,
                       inter / torch.where(union > 0, union, 1.0), 0.0)


def from_poly(polys, h, w):
    """Polygons ``[[x0, y0, x1, y1, ...], ...]`` -> list of RLEs.

    The same boundary scan-conversion convention as pycocotools
    ``rleFrPoly`` (5x upsampled boundary walk, then column-crossing
    parity), in the native codec.
    """
    native = _native()
    return [{"size": [h, w], "counts": native.compress(
        native.poly_counts(np.asarray(p, np.float64), h, w))}
        for p in polys]


def from_poly_numpy(polys, h, w):
    """Plain version of :func:`from_poly`."""
    return [_fr_poly_numpy(np.asarray(p, np.float64), h, w) for p in polys]


def fr_py_objects(pyobj, h, w):
    """pycocotools ``frPyObjects`` equivalent: polygons, uncompressed
    RLE dicts, or boxes -> RLE(s)."""
    if isinstance(pyobj, dict):
        if isinstance(pyobj.get("counts"), list):
            return {"size": pyobj["size"],
                    "counts": _compress(pyobj["counts"])}
        return pyobj
    if isinstance(pyobj, (list, tuple)):
        if len(pyobj) == 0:
            return []
        first = pyobj[0]
        if isinstance(first, dict):
            return [fr_py_objects(o, h, w) for o in pyobj]
        if isinstance(first, (list, tuple, np.ndarray)):
            # A list of numeric lists is read as polygons (pycocotools
            # reads a list of 4-lists the same way).
            return from_poly([np.asarray(p, np.float64) for p in pyobj], h, w)
        # Flat list of coordinates: single polygon.
        return from_poly([np.asarray(pyobj, np.float64)], h, w)
    raise TypeError(f"Unsupported object type for frPyObjects: {type(pyobj)}")


# ----------------------------------------------------------------------
# Internals
# ----------------------------------------------------------------------

def _is_box_input(x):
    if isinstance(x, np.ndarray):
        return x.ndim == 2 and x.shape[1] == 4
    if isinstance(x, (list, tuple)) and x:
        el = x[0]
        return (isinstance(el, (list, tuple, np.ndarray)) and len(el) == 4
                and not isinstance(el, dict))
    return isinstance(x, (list, tuple)) and not x


def counts_of(rle):
    """An RLE's counts as a uint32 array (for the native codec)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return _native().decompress(counts).astype(np.uint32)
    return np.asarray(counts, np.uint32)


def _counts_list(rle):
    """An RLE's counts as a list of ints (strings decompressed by the
    native codec; :func:`_decompress_counts` is its plain version)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return _native().decompress(counts).tolist()
    return list(counts)


def _compress(counts):
    """counts -> pycocotools' string, in the native codec
    (:func:`_compress_counts` is its plain version)."""
    return _native().compress(counts)


def _compress_counts(counts):
    """LEB128-style signed varint string, pycocotools-compatible.

    Runs after the first two are delta-coded against the run two back;
    each value is emitted 5 bits at a time, bit 5 = continuation, offset
    by 48 into printable ASCII.
    """
    out = bytearray()
    cnts = list(counts)
    for i, c in enumerate(cnts):
        x = int(c)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            cbits = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (cbits & 0x10)
                        or x == -1 and (cbits & 0x10))
            if more:
                cbits |= 0x20
            out.append(cbits + 48)
    return bytes(out)


def _decompress_counts(s):
    if isinstance(s, str):
        s = s.encode()
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _fr_poly_numpy(xy, h, w):
    """Scan-convert one polygon to RLE, pycocotools-convention.

    Walks the 5x-upsampled boundary, records column-crossing y values,
    and builds runs from the sorted crossing positions (even-odd rule
    along column-major order).
    """
    scale = 5.0
    k = len(xy) // 2
    # trunc, not floor: pycocotools rleFrPoly converts with a C '(int)'
    # cast (truncation toward zero), which differs from floor for the
    # negative coordinates of out-of-frame amodal polygons.
    x = np.trunc(scale * xy[0::2] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[1::2] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    # Dense boundary points along each edge.
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # Downsample: keep points where the column changes; x must land on an
    # integer pixel boundary after the inverse transform.
    xs_out, ys_out = [], []
    for j in range(1, len(u)):
        if u[j] == u[j - 1]:
            continue
        xd = float(min(u[j], u[j - 1]) if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if np.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(min(v[j], v[j - 1]))
        yd = (yd + 0.5) / scale - 0.5
        yd = min(max(yd, 0.0), float(h))
        yd = np.ceil(yd)
        xs_out.append(int(xd))
        ys_out.append(int(yd))

    # Column-major positions of crossings; parity between sorted
    # crossings gives the interior runs.
    a = np.array(sorted(int(px) * h + int(py)
                        for px, py in zip(xs_out, ys_out)), dtype=np.int64)
    a = np.append(a, h * w)
    diffs = np.empty_like(a)
    diffs[0] = a[0]
    diffs[1:] = a[1:] - a[:-1]
    counts = []
    vals = diffs.tolist()
    if vals:
        counts.append(vals[0])
        j = 1
        while j < len(vals):
            if vals[j] > 0:
                counts.append(vals[j])
                j += 1
            else:
                j += 1
                if j < len(vals):
                    counts[-1] += vals[j]
                    j += 1
    return {"size": [h, w], "counts": _compress_counts(counts)}
