"""The port's visualization modules against the JAX package's and OpenCV's.

``tao_amodal_torch/utils/{colormap,interpolation,raster,vis,vis_ref,
video}.py`` and ``data/burst.py`` on seeded canvases and annotations: the
palette to 1e-12, interpolation and BURST masks exactly, and every drawing
call byte for byte against the JAX package (which draws with cv2) and
against cv2 itself: rectangles, blends, text (sizes, and glyph ink inside
every glyph box), contours.  Each text and contour case prints its worst
difference from cv2.
"""

import json
import os

import cv2
import numpy as np
import pytest
from scipy import ndimage

from tao_amodal_torch.utils import raster

FACES = [(cv2.FONT_HERSHEY_SIMPLEX, 0.5), (cv2.FONT_HERSHEY_TRIPLEX, 0.35),
         (cv2.FONT_HERSHEY_TRIPLEX, 0.5), (cv2.FONT_HERSHEY_SIMPLEX, 0.1)]
NAMES = ["cat_1", "cat_2", "merged_cat", "person", "traffic light",
         "baby", "umbrella"]


def _labels(seed=0):
    """Every label the drawing code makes: category names, track ids,
    'name score', 'vis: v' and the reference's 'Vis: iou O|X'."""
    rs = np.random.RandomState(seed)
    out = list(NAMES) + [str(i) for i in range(40)]
    out += [f"{n} ({t})" for n in NAMES for t in (1, 7, 23)]
    out += [f"{n} {s:.2f}" for n in NAMES for s in rs.rand(4)]
    out += [f"vis: {v:.2f}" for v in np.linspace(0, 1, 101)]
    out += [f"Vis: {v:.3f} {o}" for v in rs.rand(10) for o in "OX"]
    return out + ["Vis:0.000 O", ""]


def _canvas(rs, h=72, w=96):
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _blob(rs, h, w, sigma=3):
    return (ndimage.gaussian_filter(rs.rand(h, w), sigma) > 0.5).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# colormap, interpolation, BURST
# ---------------------------------------------------------------------------

def test_colormap_matches_jax():
    from tao_amodal_torch.utils import colormap as pc
    from tao_amodal_tpu.utils import colormap as jc

    for rgb in (True, False):
        for maximum in (255, 1):
            np.testing.assert_allclose(pc.colormap(rgb, maximum),
                                       jc.colormap(rgb, maximum),
                                       rtol=0, atol=1e-12)
    for i in (0, 5, 78, 79, 1000):
        np.testing.assert_allclose(pc.color_for_id(i), jc.color_for_id(i),
                                   rtol=0, atol=1e-12)


def test_interpolation_matches_jax():
    from fixture_gen import make_fixture

    from tao_amodal_torch.utils import interpolation as pi
    from tao_amodal_tpu.utils import interpolation as ji

    rs = np.random.RandomState(3)
    frames = rs.choice(40, 6, replace=False)
    boxes = rs.uniform(0, 100, (6, 4))
    for a, b in zip(pi.interpolate_track(frames, boxes, range(45)),
                    ji.interpolate_track(frames, boxes, range(45))):
        np.testing.assert_array_equal(a, b)
    gt, _ = make_fixture(seed=4, num_videos=2, frames_per_video=8)
    imgs = {im["id"]: im for im in gt["images"]}
    keep = [a for i, a in enumerate(gt["annotations"]) if i % 3]
    for field in ("bbox", "amodal_bbox"):
        anns = [a for a in keep if field in a]
        assert (pi.interpolate_annotations(anns, imgs, field)
                == ji.interpolate_annotations(anns, imgs, field))


def burst_json(path, seed=0, videos=2, frames=3, tracks=3, hw=(36, 48)):
    """A BURST annotation file whose masks the port's codec encoded; string
    track ids as BURST writes them."""
    from tao_amodal_torch.ops import mask as mask_ops

    rs = np.random.RandomState(seed)
    h, w = hw
    seqs = []
    for v in range(videos):
        segs = []
        for _ in range(frames):
            seg = {}
            for t in range(1, tracks + 1):
                rle = mask_ops.encode(np.asfortranarray(_blob(rs, h, w, 2)))
                seg[str(t)] = {"rle": rle["counts"].decode()}
            segs.append(seg)
        seqs.append({
            "dataset": "LaSOT", "seq_name": f"seq-{v}", "height": h,
            "width": w, "segmentations": segs,
            "track_category_ids": {str(t): t for t in
                                   range(1, tracks + 1)},
            "annotated_image_paths": [f"{f:08d}.jpg"
                                      for f in range(frames)]})
    with open(path, "w") as f:
        json.dump({"split": "val", "sequences": seqs}, f)
    return path


def test_burst_matches_jax(tmp_path):
    from tao_amodal_torch.data.burst import BurstDataset as P
    from tao_amodal_tpu.data.burst import BurstDataset as J

    path = burst_json(str(tmp_path / "burst.json"))
    p, j = P(path, "imgs"), J(path, "imgs")
    assert p.video_names() == j.video_names() and p.split == j.split
    assert p.num_videos == j.num_videos == 2
    for name in p.video_names():
        pv, jv = p.get_video_by_name(name), j.get_video_by_name(name)
        assert (pv.name, pv.track_ids, pv.annotated_image_paths,
                pv.num_annotated_frames) == (
            jv.name, jv.track_ids, jv.annotated_image_paths,
            jv.num_annotated_frames)
        for f, frame in enumerate(pv.annotated_image_paths):
            pm, jm = pv.get_mask_by_frame(frame), jv.load_masks(f)
            assert list(pm) == list(jm) == [1, 2, 3]
            for t in pm:
                np.testing.assert_array_equal(pm[t], jm[t])
        assert pv.get_mask_by_frame("missing.jpg") == {}
        assert pv.is_mask_annotated("00000000.jpg")


# ---------------------------------------------------------------------------
# raster against cv2
# ---------------------------------------------------------------------------

def _rectangles(rs):
    for _ in range(400):
        h, w = rs.randint(4, 40, 2)
        img = _canvas(rs, h, w)
        p1 = tuple(int(v) for v in rs.randint(-12, 52, 2))
        p2 = tuple(int(v) for v in rs.randint(-12, 52, 2))
        th = int(rs.choice([-1, 1, 2, 3, 0, -4]))
        color = tuple(float(v) for v in rs.uniform(-20, 280, 3))
        yield (cv2.rectangle(img.copy(), p1, p2, color, th),
               raster.rectangle(img.copy(), p1, p2, color, th))
    gray = _canvas(rs)[..., 0].copy()
    yield (cv2.rectangle(gray.copy(), (3, 4), (40, 30), 77, 2),
           raster.rectangle(gray.copy(), (3, 4), (40, 30), 77, 2))


def _blends(rs):
    for alpha in (0.65, 0.6, 0.55, 0.4, 0.35, 0.3, 1.0, 0.0):
        for shape in ((1, 1, 3), (7, 5, 3), (72, 96, 3), (256, 256, 3)):
            a, b = _canvas(rs, *shape[:2]), _canvas(rs, *shape[:2])
            yield (cv2.addWeighted(a, alpha, b, 1 - alpha, 0),
                   raster.add_weighted(a, alpha, b, 1 - alpha, 0))
            dst = b.copy()
            out = raster.add_weighted(a, alpha, b, 1 - alpha, 0, dst)
            assert out is dst
            yield cv2.addWeighted(a, alpha, b, 1 - alpha, 0, b.copy()), dst


def _contours(rs):
    masks = [_blob(rs, 60, 70, s) for s in (1, 2, 3, 2, 1)]
    ring = np.ones((30, 40), np.uint8)
    ring[6:24, 8:30] = 0
    ring[10:20, 12:26] = 1                      # an island in the hole
    ring[13:17, 16:22] = 0                      # and a hole in the island
    masks += [ring, np.zeros((9, 9), np.uint8), np.ones((9, 9), np.uint8),
              (rs.rand(25, 30) > 0.6).astype(np.uint8)]
    for m in masks:
        cc, ch = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE)
        pc, ph = raster.find_contours(m)
        assert len(cc) == len(pc)
        assert (ch is None) == (ph is None)
        if ch is not None:
            np.testing.assert_array_equal(ch, ph)
        for a, b in zip(cc, pc):
            np.testing.assert_array_equal(a, b)
        img = _canvas(rs, *m.shape)
        color = tuple(int(v) for v in rs.randint(0, 256, 3))
        yield (cv2.drawContours(img.copy(), cc, -1, color, 1,
                                lineType=cv2.LINE_AA),
               raster.draw_contours(img.copy(), pc, -1, color))
        if len(pc):
            yield (cv2.drawContours(img.copy(), cc, 0, color, 1,
                                    lineType=cv2.LINE_AA),
                   raster.draw_contours(img.copy(), pc, 0, color))


@pytest.mark.parametrize("call", ["rectangle", "add_weighted", "contours"])
def test_raster_matches_cv2(call):
    """``rectangle`` (filled and thickness 0-3, clipped), ``add_weighted``
    (odd shapes, in place) and ``find_contours``/``draw_contours``
    (holes, islands, the image edge, empty) equal cv2 byte for byte."""
    rs = np.random.RandomState(7)
    cases = {"rectangle": _rectangles, "add_weighted": _blends,
             "contours": _contours}[call](rs)
    worst = n = 0
    for want, got in cases:
        assert got.shape == want.shape and got.dtype == want.dtype
        worst = max(worst, int(np.abs(want.astype(int) - got).max()))
        n += 1
    print(f"{call}: {n} images, worst |port - cv2| = {worst}")
    assert worst == 0


@pytest.mark.parametrize("face", FACES, ids=lambda f: f"{f}")
def test_text_matches_cv2(face):
    """``text_size`` equals ``cv2.getTextSize`` on every label the drawing
    code makes and on random printable strings; ``put_text`` equals
    ``cv2.putText(..., LINE_AA)`` byte for byte over seeded canvases,
    clipped at every edge.  Prints the worst case inside the glyph boxes:
    the ink's extent and total against cv2's (the drawing contract's
    measure), and the largest pixel difference."""
    font, scale = face
    rs = np.random.RandomState(11)
    chars = [chr(c) for c in range(32, 127)]
    labels = _labels() + ["".join(rs.choice(chars, rs.randint(1, 16)))
                          for _ in range(60)]
    worst_px = worst_bbox = 0
    worst_ink = 0.0
    for i, text in enumerate(labels):
        want_size = cv2.getTextSize(text, font, scale, 1)
        assert raster.text_size(text, font, scale, 1) == want_size, text
        img = _canvas(rs, 60, 200)
        org = ((5, 40) if i % 4 else
               (int(rs.randint(-30, 190)), int(rs.randint(-5, 70))))
        color = tuple(int(v) for v in rs.randint(0, 256, 3))
        want = cv2.putText(img.copy(), text, org, font, scale, color, 1,
                           cv2.LINE_AA).astype(int)
        got = raster.put_text(img.copy(), text, org, font, scale,
                              color).astype(int)
        (tw, th), base = want_size
        box = (slice(max(org[1] - th - base, 0), max(org[1] + base + 1, 0)),
               slice(max(org[0], 0), max(org[0] + tw + 1, 0)))
        ink_w = np.abs(want - img)[box].sum(-1)
        ink_g = np.abs(got - img)[box].sum(-1)
        if ink_w.any() or ink_g.any():
            yw, xw = np.nonzero(ink_w)
            yg, xg = np.nonzero(ink_g)
            worst_bbox = max(worst_bbox, *(abs(int(a) - int(b)) for a, b in (
                (yw.min(), yg.min()), (yw.max(), yg.max()),
                (xw.min(), xg.min()), (xw.max(), xg.max()))))
            worst_ink = max(worst_ink, abs(ink_g.sum() - ink_w.sum())
                            / max(ink_w.sum(), 1))
        worst_px = max(worst_px, int(np.abs(want - got).max()))
    print(f"face {font} at {scale}: {len(labels)} labels, sizes equal, "
          f"ink extent off by {worst_bbox} px, total ink off by "
          f"{100 * worst_ink:.2f} %, worst |port - cv2| = {worst_px}")
    assert worst_px == 0


def test_text_rejects_other_faces():
    with pytest.raises(ValueError, match="no glyph table"):
        raster.text_size("a", cv2.FONT_HERSHEY_PLAIN, 1.0)
    with pytest.raises(ValueError, match="no glyph table"):
        raster.put_text(np.zeros((9, 9, 3), np.uint8), "a", (0, 8),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (1, 2, 3),
                        thickness=2)


# ---------------------------------------------------------------------------
# vis and vis_ref against the JAX package
# ---------------------------------------------------------------------------

def _anns(rs, n=6, w=96, h=72, fields=("bbox",)):
    out = []
    for i in range(n):
        x, y = rs.uniform(-0.3 * w, 0.9 * w), rs.uniform(-0.3 * h, 0.9 * h)
        bw, bh = rs.uniform(2, 0.6 * w), rs.uniform(2, 0.6 * h)
        a = {"track_id": int(rs.randint(1, 90)), "category_id": i % 4 + 1,
             "score": float(rs.rand()), "visibility": float(rs.rand())}
        for f in fields:
            a[f] = [float(x), float(y), float(bw), float(bh)]
        if "modal_bbox" in fields:
            a["modal_bbox"] = [float(x) + 2, float(y) + 3, float(bw) / 2,
                               float(bh) / 2]
        out.append(a)
    return out


CATS = {1: "cat_1", 2: "traffic light", 3: "baby", 4: "person"}


def _vis_cases(m, rs):
    """(name, call) pairs of the vis module ``m`` on seeded inputs."""
    img = _canvas(rs)
    canvas, origin = m.make_padded_canvas(img, 1.5)
    anns = _anns(rs, fields=("bbox", "modal_bbox"))
    mask = _blob(rs, 72, 96)
    masks = {3: mask, 17: _blob(rs, 72, 96, 2)}
    return {
        "vis_bbox": lambda: m.vis_bbox(canvas.copy(), (10.4, 8.6, 40, 30),
                                       color=(50, 220, 50), thick=3,
                                       fill_alpha=0.35),
        "vis_class": lambda: m.vis_class(canvas.copy(), (20, 30),
                                         "traffic light 0.93"),
        "vis_visibility": lambda: [m.vis_visibility(
            canvas.copy(), (5 + i, 60), v) for i, v in
            enumerate(np.linspace(0, 1, 101))],
        "vis_mask": lambda: m.vis_mask(img.copy(), mask, (200, 40, 90)),
        "transparent_except_boxes": lambda: m.transparent_except_boxes(
            canvas.copy(), [a["bbox"] for a in anns], origin=origin),
        "make_padded_canvas": lambda: m.make_padded_canvas(img, 1.5),
        "overlay_amodal_boxes": lambda: m.overlay_amodal_boxes(
            canvas.copy(), anns, origin, show_visibility=True,
            category_names=CATS),
        "overlay_amodal_boxes_ids": lambda: m.overlay_amodal_boxes(
            canvas.copy(), anns, origin),
        "overlay_modal_boxes": lambda: m.overlay_modal_boxes(
            canvas.copy(), anns, origin),
        "overlay_prediction_boxes": lambda: m.overlay_prediction_boxes(
            canvas.copy(), anns, origin, score_thr=0.2,
            category_names=CATS),
        "overlay_masks": lambda: m.overlay_masks(canvas.copy(), masks,
                                                 origin),
    }


VIS_CASES = ["vis_bbox", "vis_class", "vis_visibility", "vis_mask",
             "transparent_except_boxes", "make_padded_canvas",
             "overlay_amodal_boxes", "overlay_amodal_boxes_ids",
             "overlay_modal_boxes", "overlay_prediction_boxes",
             "overlay_masks"]


@pytest.mark.parametrize("case", VIS_CASES)
def test_vis_matches_jax(case):
    """Every function of ``utils/vis.py`` draws the JAX package's pixels
    (cv2 there, numpy here) byte for byte on a seeded 1.5x canvas."""
    from tao_amodal_torch.utils import vis as pv
    from tao_amodal_tpu.utils import vis as jv

    got = _vis_cases(pv, np.random.RandomState(5))[case]()
    want = _vis_cases(jv, np.random.RandomState(5))[case]()
    np.testing.assert_equal(got, want)


def _ref_cases(m, rs):
    canvas = _canvas(rs)
    anns = _anns(rs, n=7, fields=("bbox", "amodal_bbox"))
    for i, a in enumerate(anns):
        a["amodal_is_uncertain"] = bool(i % 2)
    anns[0].pop("bbox")
    anns[1]["segmentation"] = [[5, 6, 20, 6, 20, 30, 5, 30]]
    anns[1].pop("bbox")
    cats = {c: {"name": n} for c, n in CATS.items()}
    boxed = [a for a in anns if "bbox" in a]
    colors = m.get_annotation_colors(boxed)
    return {
        "vis_class": lambda: m.vis_class(canvas.copy(), (20, 30), "person"),
        "vis_visibility": lambda: m.vis_visibility(canvas.copy(), (4, 60),
                                                   "Vis: 0.532 O"),
        "overlay_amodal_class_coco": lambda: m.overlay_amodal_class_coco(
            canvas.copy(), anns, cats, show_track_id=True),
        "overlay_amodal_class_prediction": lambda: (
            m.overlay_amodal_class_prediction(
                canvas.copy(), boxed, cats, background_colors=colors)),
        "overlay_class_coco": lambda: m.overlay_class_coco(
            canvas.copy(), boxed, cats, font_scale=0.35),
        "overlay_amodal_visibility_coco": lambda: (
            m.overlay_amodal_visibility_coco(canvas.copy(), anns, cats)),
        "vis_bbox": lambda: m.vis_bbox(canvas.copy(), [8.7, -3.2, 50, 40],
                                       thickness=2),
        "overlay_amodal_boxes_coco": lambda: m.overlay_amodal_boxes_coco(
            canvas.copy(), boxed, fill_opacity=0.4, thickness=2),
        "overlay_modal_boxes_coco": lambda: m.overlay_modal_boxes_coco(
            canvas.copy(), boxed, colors=colors, thickness=3),
        "overlay_amodal_boxes_prediction": lambda: (
            m.overlay_amodal_boxes_prediction(canvas.copy(), boxed,
                                              border_color=(9, 9, 9))),
        "overlay_boxes_coco": lambda: m.overlay_boxes_coco(canvas.copy(),
                                                           boxed),
        "transparent_except_bbox": lambda: [
            m.transparent_except_bbox(canvas.copy(), anns, modal=modal)
            for modal in (True, False)],
        "labels_and_colors": lambda: (
            [m.amodal_visibility_label(a) for a in anns]
            + [m.amodal_visibility_label({"amodal_bbox": [0, 0, 1, 1],
                                          "amodal_is_uncertain": True})],
            colors),
    }


REF_CASES = ["vis_class", "vis_visibility", "overlay_amodal_class_coco",
             "overlay_amodal_class_prediction", "overlay_class_coco",
             "overlay_amodal_visibility_coco", "vis_bbox",
             "overlay_amodal_boxes_coco", "overlay_modal_boxes_coco",
             "overlay_amodal_boxes_prediction", "overlay_boxes_coco",
             "transparent_except_bbox", "labels_and_colors"]


@pytest.mark.parametrize("case", REF_CASES)
def test_vis_ref_matches_jax(case):
    """Every function of ``utils/vis_ref.py`` (chips, box families,
    labels, colors, whitening) equals the JAX package's byte for byte."""
    from tao_amodal_torch.utils import vis_ref as pr
    from tao_amodal_tpu.utils import vis_ref as jr

    got = _ref_cases(pr, np.random.RandomState(6))[case]()
    want = _ref_cases(jr, np.random.RandomState(6))[case]()
    np.testing.assert_equal(got, want)


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------

def test_video_writer_matches_jax(tmp_path):
    """The backend each package picks (JAX's order: imageio, cv2, frames)
    is the same for a video path and a directory, and the frame directory
    (PIL here, ``cv2.imwrite`` there) decodes to the same pixels."""
    from PIL import Image

    from tao_amodal_torch.utils import video as pvid
    from tao_amodal_tpu.utils import video as jvid

    rs = np.random.RandomState(2)
    frames = [_canvas(rs, 30, 44) for _ in range(3)]
    for name, mod in (("ours", pvid), ("theirs", jvid)):
        with mod.video_writer(str(tmp_path / name), fps=5) as w:
            assert type(w).__name__ == "_FrameDirWriter"
            for f in frames:
                w.write_frame(f)
    for i, f in enumerate(frames):
        for name in ("ours", "theirs"):
            got = np.asarray(Image.open(tmp_path / name / f"{i:06d}.png"))
            np.testing.assert_array_equal(got, f)
    kinds = []
    for mod in (pvid, jvid):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.mp4")
        with mod.video_writer(path, fps=5, size_wh=(44, 30)) as w:
            w.write_frame(frames[0])
            kinds.append(type(w).__name__)
    assert kinds[0] == kinds[1]
    assert os.path.exists(tmp_path / "tao_amodal_torch.mp4")
