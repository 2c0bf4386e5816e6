"""The port's RLE mask codec (``tao_amodal_torch/ops/mask.py`` and its
native library ``tao_amodal_torch/native``) held against the JAX
package's ``tao_amodal_tpu.ops.mask`` on seeded masks and polygons, on
the CPU.

Tolerances: RLE strings byte-equal, counts, areas, boxes and pixel
masks exact; mask IoU (float64 quotients of integer pixel counts, the
same division on both sides) exact; ``mask_iou_dense`` (an f32 matrix
product of 0/1 masks, exact below 2^24 pixels) exact.  The native
library is held against the port's own numpy functions, its plain
versions, the same way.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tao_amodal_tpu.ops import mask as jmask
from tao_amodal_torch.native import lib as native_lib
from tao_amodal_torch.ops import mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masks(seed, h=23, w=31):
    """Seeded binary masks: blobs, a scatter of pixels, the empty and the
    full mask, one that starts with a foreground pixel (a leading zero
    run of length 0) and one whose runs span columns."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(4):
        m = np.zeros((h, w), np.uint8)
        for _ in range(rs.randint(1, 4)):
            y, x = rs.randint(0, h - 3), rs.randint(0, w - 3)
            m[y:y + rs.randint(2, h - y), x:x + rs.randint(2, w - x)] = 1
        out.append(m)
    out.append((rs.rand(h, w) < 0.3).astype(np.uint8))
    out.append(np.zeros((h, w), np.uint8))
    out.append(np.ones((h, w), np.uint8))
    first = np.zeros((h, w), np.uint8)
    first[:5, 0] = 1
    out.append(first)
    span = np.zeros((h, w), np.uint8)
    span[h // 2:, 3] = span[:h // 2, 4] = 1
    out.append(span)
    return out


def _polygons(seed, h=40, w=50):
    """Seeded polygons: triangles and pentagons inside the frame, one
    reaching past it on every side (amodal boxes: negative coordinates),
    a rectangle and a degenerate one of a single point."""
    rs = np.random.RandomState(seed)
    polys = [list(rs.uniform(0, [w, h] * 3, 6)),
             list(rs.uniform(0, [w, h] * 5, 10)),
             list(rs.uniform([-15, -12] * 4, [w + 15, h + 12] * 4, 8)),
             [3.5, 2.0, 3.5, 20.25, 30.75, 20.25, 30.75, 2.0],
             [5.0, 5.0, 5.0, 5.0, 5.0, 5.0]]
    return polys, h, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_decode_and_compression_match_jax(seed):
    """encode's strings byte-equal JAX's; decode, the counts'
    compression and decompression, area and to_bbox equal JAX's."""
    masks = _masks(seed)
    for m in masks:
        got, want = mask.encode(m), jmask.encode(m)
        assert got == want and isinstance(got["counts"], bytes)
        np.testing.assert_array_equal(mask.decode(got), m)
        np.testing.assert_array_equal(mask.decode(got), jmask.decode(want))
        counts = mask._counts_list(got)
        assert counts == jmask._counts_list(want)
        assert mask._compress_counts(counts) == jmask._compress_counts(
            counts)
        assert mask._decompress_counts(got["counts"].decode()) == counts
        assert mask.area(got) == jmask.area(want) == int(m.sum())
        np.testing.assert_array_equal(mask.to_bbox(got), jmask.to_bbox(want))
        # Uncompressed counts decode the same.
        plain = {"size": got["size"], "counts": counts}
        np.testing.assert_array_equal(mask.decode(plain), m)
    stack = np.stack(masks, axis=2)
    got, want = mask.encode(stack), jmask.encode(stack)
    assert got == want
    np.testing.assert_array_equal(mask.decode(got), stack)
    np.testing.assert_array_equal(mask.area(got), jmask.area(want))
    np.testing.assert_array_equal(mask.to_bbox(got), jmask.to_bbox(want))


@pytest.mark.parametrize("intersect", [False, True])
def test_merge_and_intersect_area_match_jax(intersect):
    """Union and intersection of two and of three RLEs through the native
    codec, byte-equal to JAX's and to the port's numpy version."""
    masks = _masks(3)
    rles = [mask.encode(m) for m in masks]
    for group in (rles[:2], rles[1:4], rles[4:7], [rles[0], rles[-1]]):
        got = mask.merge(group, intersect=intersect)
        assert got == jmask.merge(group, intersect=intersect)
        assert got == mask.merge_numpy(group, intersect=intersect)
        op = np.logical_and if intersect else np.logical_or
        want = masks[0] * 0 + op.reduce([mask.decode(r) for r in group])
        np.testing.assert_array_equal(mask.decode(got), want)
    assert mask.merge(rles[2]) is rles[2]
    assert mask.merge([rles[2]]) == rles[2]
    for a in rles:
        for b in rles[::2]:
            n = mask.intersect_area(a, b)
            assert n == jmask.intersect_area(a, b)
            assert n == mask.intersect_area_numpy(a, b)


@pytest.mark.parametrize("crowd", ["none", "empty", "some"])
def test_iou_matches_jax(crowd):
    """Mask IoU of RLE lists (native run sweep) equal to JAX's and to the
    port's decoded numpy version, with ``iscrowd`` absent, empty or set
    on some gts; box inputs dispatch to the box IoU; empty sides give
    ``[]``."""
    dts = [mask.encode(m) for m in _masks(4)]
    gts = [mask.encode(m) for m in _masks(5)[:6]]
    iscrowd = {"none": None, "empty": [],
               "some": [0, 1, 0, 0, 1, 0]}[crowd]
    got = mask.iou(dts, gts, iscrowd)
    assert got.shape == (len(dts), len(gts))
    np.testing.assert_array_equal(got, jmask.iou(dts, gts, iscrowd))
    np.testing.assert_array_equal(got, mask.iou_numpy(dts, gts, iscrowd))
    assert (got[:, 0] > 0).any() and (got <= 1).all()
    crowd1 = None if iscrowd is None else iscrowd[:1]
    one = mask.iou(dts[0], gts[0], crowd1)
    np.testing.assert_array_equal(one, jmask.iou(dts[0], gts[0], crowd1))
    assert mask.iou([], gts, []) == [] == jmask.iou([], gts, [])
    boxes = np.random.RandomState(6).uniform(0, 30, (5, 4))
    np.testing.assert_array_equal(mask.iou(boxes, boxes[:3], [0, 1, 0]),
                                  jmask.iou(boxes, boxes[:3], [0, 1, 0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_from_poly_and_fr_py_objects_match_jax(seed):
    """Polygon rasterization (native) byte-equal to JAX's and to the
    port's numpy version, negative coordinates included;
    ``fr_py_objects`` on polygon lists, a flat polygon, uncompressed and
    compressed RLE dicts and lists of them; ``from_bbox``."""
    polys, h, w = _polygons(seed)
    got = mask.from_poly(polys, h, w)
    assert got == jmask.from_poly(polys, h, w)
    assert got == mask.from_poly_numpy(polys, h, w)
    assert mask.area(got[3]) > 0
    assert mask.fr_py_objects(polys, h, w) == jmask.fr_py_objects(polys, h,
                                                                  w)
    assert mask.fr_py_objects(polys[0], h, w) == jmask.fr_py_objects(
        polys[0], h, w)
    rle = mask.encode(_masks(seed, h, w)[0])
    plain = {"size": rle["size"], "counts": mask._counts_list(rle)}
    assert mask.fr_py_objects(plain, h, w) == rle
    assert mask.fr_py_objects(rle, h, w) is rle
    assert mask.fr_py_objects([plain, rle], h, w) == [rle, rle]
    assert mask.fr_py_objects([], h, w) == []
    with pytest.raises(TypeError):
        mask.fr_py_objects(3.0, h, w)
    boxes = [[2.0, 3.0, 10.5, 7.25], [-5.0, 30.0, 20.0, 20.0]]
    assert mask.from_bbox(boxes, h, w) == jmask.from_bbox(boxes, h, w)


@pytest.mark.parametrize("crowd", [False, True])
def test_mask_iou_dense_matches_jax(crowd):
    """``mask_iou_dense`` (a torch matrix product, CPU tensors and numpy)
    equal to JAX's and to the RLE IoU of the same masks."""
    dts, gts = np.stack(_masks(7)), np.stack(_masks(8)[:5])
    iscrowd = [0, 1, 0, 1, 0] if crowd else None
    got = mask.mask_iou_dense(torch.from_numpy(dts), torch.from_numpy(gts),
                              iscrowd)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jmask.mask_iou_dense(dts, gts, iscrowd))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mask.mask_iou_dense(dts, gts, iscrowd),
                                  got)
    rle = mask.iou([mask.encode(m) for m in dts],
                   [mask.encode(m) for m in gts], iscrowd)
    np.testing.assert_allclose(got.numpy(), rle, rtol=1e-6, atol=0)


def test_native_library_matches_numpy():
    """Every function of the native codec against the port's numpy
    functions on the same masks: counts, decoding, area, the pairwise
    merge, IoU of a pair and of two lists (with crowd), the box, a
    polygon's counts, and the counts' compressed string both ways."""
    lib = native_lib.load()
    masks = _masks(9)
    counts = [np.asarray(mask._counts_list(mask.encode(m)), np.uint32)
              for m in masks]
    for m, c in zip(masks, counts):
        np.testing.assert_array_equal(lib.encode_counts(m), c)
        np.testing.assert_array_equal(lib.decode_counts(c, *m.shape), m)
        assert lib.area(c) == m.sum()
        np.testing.assert_array_equal(
            lib.to_bbox(c, m.shape[0]),
            mask.to_bbox({"size": list(m.shape), "counts": c.tolist()}))
    rles = [mask.encode(m) for m in masks]
    for intersect in (False, True):
        for i in range(len(masks) - 1):
            got = lib.merge_pair(counts[i], counts[i + 1], intersect)
            want = mask.merge_numpy(rles[i:i + 2], intersect)
            assert mask._compress_counts(got.tolist()) == want["counts"]
    crowd = [i % 2 for i in range(len(masks))]
    want = mask.iou_numpy(rles, rles, crowd)
    np.testing.assert_array_equal(lib.iou_matrix(counts, counts, crowd),
                                  want)
    for i, j in ((0, 1), (2, 2), (4, 7)):
        assert lib.iou_pair(counts[i], counts[j], crowd[j]) == want[i, j]
    assert lib.iou_matrix([], counts).shape == (0, len(counts))
    polys, h, w = _polygons(2)
    # A polygon over a frame 5000 columns wide: more counts than the
    # first buffer holds.
    polys.append([0.5, 0.5, 4999.5, 2.5, 2500.0, 7.5])
    for p in polys:
        width = 5000 if len(p) == 6 and p[2] > w else w
        assert (mask._compress_counts(lib.poly_counts(p, h, width).tolist())
                == mask.from_poly_numpy([p], h, width)[0]["counts"])
    # The counts' string form, both ways, on every mask's counts and on
    # large and uncompressed-file-like counts (deltas of either sign).
    rs = np.random.RandomState(10)
    extra = [rs.randint(0, 2 ** 31, 50).astype(np.uint32),
             np.array([0, 1, 2 ** 32 - 1, 7, 2 ** 20], np.uint32),
             np.zeros(0, np.uint32)]
    for c in counts + extra:
        s = mask._compress_counts(c.tolist())
        assert lib.compress(c) == s
        assert lib.decompress(s).tolist() == mask._decompress_counts(s)
        assert lib.decompress(s.decode()).tolist() == c.tolist()


def test_native_library_is_the_ports_own():
    """The codec is built from ``tao_amodal_torch/native/rle.cc`` into
    ``build/tao_amodal_torch/`` under a name hashed from the source, the
    flags and the compiler; a process that uses the port's codec never
    loads the JAX package's library."""
    lib = native_lib.load()
    assert os.path.dirname(lib.path) == os.path.join(
        REPO, "build", "tao_amodal_torch")
    assert os.path.basename(lib.path).startswith("libtao_rle_")
    assert lib.path == native_lib.library_path()
    script = textwrap.dedent("""
        import numpy as np
        from tao_amodal_torch.ops import mask
        r = [mask.encode(np.eye(6, dtype=np.uint8))]
        assert mask.iou(r, r, [0])[0, 0] == 1.0
        maps = open("/proc/self/maps").read()
        assert "libtao_rle_" in maps and "libtao_native" not in maps
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", (
        proc.stderr)


def test_native_builds_from_two_processes_at_once(tmp_path):
    """Two processes that build the codec into an empty directory at the
    same time both load a whole library, and leave only it behind (the
    compiler writes a temporary file that is renamed into place)."""
    script = textwrap.dedent(f"""
        from tao_amodal_torch.native import lib
        lib.BUILD_DIR = {str(tmp_path)!r}
        rle = lib.NativeRle(lib.build())
        print(rle.path, rle.area([3, 4, 5, 6]))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.split()[0] for out, _ in outs}
    assert {out.split()[1] for out, _ in outs} == {"10.0"}
    assert len(paths) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths.pop())]
