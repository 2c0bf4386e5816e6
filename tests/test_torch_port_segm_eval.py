"""The port's segm evaluation held against the JAX package's, on the CPU:
``track_mask_iou_matrix`` in its three modes, the host Track-mAP and
detection AP with ``iou_type="segm"``, the device evaluators with
``"segm"`` on ``device="cpu"``, the results loader's mask-only branch,
and ``ann_to_rle`` / ``ann_to_mask`` of both dataset classes.

The fixture is ``fixture_gen.make_fixture`` with triangle segmentations
on the ground truth (``tests/test_device_eval.py:102-107``), box-only
predictions (their masks: the box, as the reference synthesizes them)
and, for detection, mask-only predictions carrying compressed RLE
strings.

Tolerances: the host evaluators are the same float64 numpy arithmetic on
the same integer pixel counts on both sides, so every metric agrees to
1e-12; mask track IoU exact; the device evaluators (f32 IoU, matching in
torch) within 2e-3 of the host and of JAX's device evaluators, the
bound of ``tests/test_torch_port_eval_device.py`` and
``tests/test_device_eval.py``.
"""

import copy

import numpy as np
import pytest

from fixture_gen import make_fixture

from tao_amodal_tpu.data.lvis import LvisDataset as JaxLvisDataset
from tao_amodal_tpu.data.results import LvisResultsDataset as JaxLvisResults
from tao_amodal_tpu.data.tao import TaoDataset as JaxTaoDataset
from tao_amodal_tpu.evaluation import (
    AmodalDetectionEvaluator as JaxDetectionEvaluator,
    TrackMapEvaluator as JaxTrackEvaluator,
)
from tao_amodal_tpu.evaluation.device_detection import (
    DeviceDetectionEval as JaxDeviceDetectionEval,
)
from tao_amodal_tpu.evaluation.device_eval import (
    DeviceTrackEval as JaxDeviceTrackEval,
)
from tao_amodal_tpu.ops import mask as jmask
from tao_amodal_tpu.ops.track_iou import (
    track_mask_iou_matrix as jax_track_mask_iou,
)
from tao_amodal_torch.data.lvis import LvisDataset
from tao_amodal_torch.data.results import (
    LvisResultsDataset,
    make_track_ids_unique,
)
from tao_amodal_torch.data.tao import TaoDataset
from tao_amodal_torch.evaluation import (
    AmodalDetectionEvaluator,
    DeviceDetectionEval,
    DeviceTrackEval,
    TrackMapEvaluator,
)
from tao_amodal_torch.ops import mask
from tao_amodal_torch.ops.track_iou import track_mask_iou_matrix

MODES = ("3d_iou", "avg_iou", "imagenetvid")


def _triangles(gt):
    for ann in gt["annotations"]:
        x, y, w, h = ann["bbox"]
        ann["segmentation"] = [[x, y, x, y + h, x + w, y + h]]
    return gt


@pytest.fixture(scope="module")
def segm_fixture():
    """(gt with triangle segmentations, box-only predictions with unique
    track ids)."""
    gt, preds = make_fixture(seed=11, num_videos=2, frames_per_video=8,
                             num_cats=4, tracks_per_video=4)
    _triangles(gt)
    make_track_ids_unique(preds)
    return gt, preds


def _mask_only(gt, preds):
    """The predictions as mask-only results: each box's left half as a
    compressed RLE string (JSON-safe), no ``bbox``."""
    imgs = {im["id"]: im for im in gt["images"]}
    out = []
    for p in preds:
        im = imgs[p["image_id"]]
        x, y, w, h = p["bbox"]
        rle = mask.from_bbox([[x, y, w / 2, h]], im["height"],
                             im["width"])[0]
        q = {k: v for k, v in p.items() if k != "bbox"}
        q["segmentation"] = {"size": rle["size"],
                             "counts": rle["counts"].decode()}
        out.append(q)
    return out


def _random_rle_tracks(rs, n_tracks, n_frames, hw=(24, 31), p_blob=0.75):
    """Nested [T][F] lists of random-blob RLEs (None = absent)."""
    h, w = hw
    out = []
    for _ in range(n_tracks):
        row = []
        for _ in range(n_frames):
            if rs.rand() > p_blob:
                row.append(None)
                continue
            m = np.zeros((h, w), np.uint8)
            y, x = rs.randint(0, h - 4), rs.randint(0, w - 4)
            m[y:y + rs.randint(2, h - y), x:x + rs.randint(2, w - x)] = 1
            if rs.rand() < 0.3:
                y2, x2 = rs.randint(0, h - 3), rs.randint(0, w - 3)
                m[y2:y2 + 3, x2:x2 + 3] = 1
            row.append(mask.encode(m))
        out.append(row)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_track_mask_iou_matrix_matches_jax(mode):
    """Random blob tracks with absent frames, and empty sides: equal to
    JAX's matrix entry for entry."""
    rs = np.random.RandomState(MODES.index(mode))
    for D, G, F in ((5, 4, 7), (3, 6, 1), (1, 1, 5)):
        dt = _random_rle_tracks(rs, D, F)
        gt = _random_rle_tracks(rs, G, F)
        got = track_mask_iou_matrix(dt, gt, mode=mode)
        assert got.shape == (D, G) and got.dtype == np.float64
        np.testing.assert_array_equal(got, jax_track_mask_iou(dt, gt,
                                                              mode=mode))
    assert track_mask_iou_matrix([], gt, mode=mode).shape == (0, G)
    with pytest.raises(ValueError):
        track_mask_iou_matrix(dt, gt, mode="nope")


def _agree(got, want, atol):
    assert list(got) == list(want)
    bad = {k: (got[k], want[k]) for k in got
           if not abs(got[k] - want[k]) <= atol}
    assert not bad, bad


@pytest.mark.parametrize("iou_3d_type", MODES)
def test_host_track_eval_segm_matches_jax(segm_fixture, iou_3d_type):
    """Track-mAP with ``iou_type="segm"``: masks of the gt triangles
    against the predictions' boxes; equal to JAX's to 1e-12, and other
    than bbox's (masks flowed)."""
    gt, preds = segm_fixture
    kw = dict(iou_type="segm")
    ours = TrackMapEvaluator(copy.deepcopy(gt), copy.deepcopy(preds), **kw)
    theirs = JaxTrackEvaluator(copy.deepcopy(gt), copy.deepcopy(preds), **kw)
    for ev in (ours, theirs):
        ev.params.iou_3d_type = iou_3d_type
        ev.run()
    _agree(ours.get_results(), theirs.get_results(), 1e-12)
    assert ours.get_results()["AP"] > 0
    if iou_3d_type == "3d_iou":
        bbox = TrackMapEvaluator(copy.deepcopy(gt), copy.deepcopy(preds))
        bbox.run()
        assert any(not np.isclose(ours.get_results()[k], v)
                   for k, v in bbox.get_results().items())


@pytest.mark.parametrize("results", ["boxes", "masks"])
def test_host_detection_eval_segm_matches_jax(segm_fixture, results):
    """Detection AP with ``iou_type="segm"`` (the default): box results
    (their degenerate polygons rasterized) and mask-only RLE results,
    equal to JAX's to 1e-12."""
    gt, preds = segm_fixture
    if results == "masks":
        preds = _mask_only(gt, preds)
    ours = AmodalDetectionEvaluator(copy.deepcopy(gt), copy.deepcopy(preds))
    theirs = JaxDetectionEvaluator(copy.deepcopy(gt), copy.deepcopy(preds))
    assert ours.params.iou_type == theirs.params.iou_type == "segm"
    for ev in (ours, theirs):
        ev.run()
    _agree(ours.get_results(), theirs.get_results(), 1e-12)
    assert ours.get_results()["AP"] > 0


@pytest.mark.parametrize("kind", ["track", "detection"])
def test_device_evaluators_segm_within_bounds(segm_fixture, kind):
    """``DeviceTrackEval`` and ``DeviceDetectionEval`` with ``"segm"`` on
    ``device="cpu"``: mask IoU on the host through the RLE codec, the
    matching cells in torch; within 2e-3 of the port's host evaluator
    and of JAX's device evaluator."""
    gt, preds = segm_fixture
    if kind == "track":
        ours = DeviceTrackEval(copy.deepcopy(gt), copy.deepcopy(preds),
                               iou_type="segm", device="cpu")
        host = TrackMapEvaluator(copy.deepcopy(gt), copy.deepcopy(preds),
                                 iou_type="segm")
        theirs = JaxDeviceTrackEval(copy.deepcopy(gt), copy.deepcopy(preds),
                                    iou_type="segm")
    else:
        ours = DeviceDetectionEval(copy.deepcopy(gt), copy.deepcopy(preds),
                                   "segm", device="cpu")
        host = AmodalDetectionEvaluator(copy.deepcopy(gt),
                                        copy.deepcopy(preds), "segm")
        theirs = JaxDeviceDetectionEval(copy.deepcopy(gt),
                                        copy.deepcopy(preds), "segm")
    for ev in (ours, host, theirs):
        ev.run()
    _agree(ours.get_results(), host.get_results(), 2e-3)
    _agree(ours.get_results(), theirs.get_results(), 2e-3)


def test_results_loader_reads_mask_only_results_as_jax(segm_fixture):
    """``LvisResultsDataset`` on mask-only results: each result's area
    and box from the RLE codec and its id, equal to JAX's loader."""
    gt, preds = segm_fixture
    masks = _mask_only(gt, preds)
    ours = LvisResultsDataset(LvisDataset(copy.deepcopy(gt)),
                              copy.deepcopy(masks))
    theirs = JaxLvisResults(JaxLvisDataset(copy.deepcopy(gt)),
                            copy.deepcopy(masks))
    assert list(ours.anns) == list(theirs.anns)
    for k, ann in ours.anns.items():
        other = theirs.anns[k]
        assert ann["area"] == other["area"] > 0
        np.testing.assert_array_equal(ann["bbox"], other["bbox"])
        assert ann["segmentation"] == other["segmentation"]


def _segm_cases(h, w):
    """(name, segmentation) of each form an annotation may carry."""
    poly = [[4.5, 3.0, 4.5, 21.0, 27.0, 21.0], [30.0, 2.0, 40.0, 2.0,
                                                35.0, 12.0]]
    m = np.zeros((h, w), np.uint8)
    m[5:15, 7:30] = 1
    rle = mask.encode(m)
    return (("polygon", poly),
            ("uncompressed", {"size": [h, w],
                              "counts": mask._counts_list(rle)}),
            ("compressed", {"size": [h, w],
                            "counts": rle["counts"].decode()}),
            ("missing", None))


@pytest.mark.parametrize("case", ["polygon", "uncompressed", "compressed",
                                  "missing"])
def test_ann_to_rle_and_mask_match_jax(segm_fixture, case):
    """``ann_to_rle`` and ``ann_to_mask`` of ``TaoDataset`` (and of
    ``LvisDataset``, which has no box fallback) for a polygon, an
    uncompressed RLE, a compressed RLE and a missing segmentation (the
    box): RLE strings and masks equal to JAX's."""
    gt, _ = segm_fixture
    img = gt["images"][0]
    h, w = img["height"], img["width"]
    segm = dict(_segm_cases(h, w))[case]
    ann = {"image_id": img["id"], "bbox": [3.0, 4.5, 20.25, 11.0]}
    if segm is not None:
        ann["segmentation"] = segm
    pairs = [(TaoDataset(copy.deepcopy(gt)), JaxTaoDataset(copy.deepcopy(gt)))]
    if segm is not None:
        pairs.append((LvisDataset(copy.deepcopy(gt)),
                      JaxLvisDataset(copy.deepcopy(gt))))
    for ours, theirs in pairs:
        got = ours.ann_to_rle(copy.deepcopy(ann))
        want = theirs.ann_to_rle(copy.deepcopy(ann))
        assert mask._counts_list(got) == jmask._counts_list(want)
        assert got == want
        m = ours.ann_to_mask(copy.deepcopy(ann))
        assert m.shape == (h, w) and m.sum() > 0
        np.testing.assert_array_equal(m, theirs.ann_to_mask(
            copy.deepcopy(ann)))
