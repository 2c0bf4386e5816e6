"""The port's host evaluators against the JAX package's, on the CPU.

Both sides run the same float64 numpy arithmetic, so every metric must
agree to 1e-12 and come in the same key order; against the stored
reference-oracle metrics (``tests/fixtures/golden_seed0.json``) the
bound is 1e-9, as ``tests/test_golden.py`` holds the JAX package.
"""

import copy
import json
import os

import numpy as np
import pytest

from fixture_gen import make_fixture

from tao_amodal_tpu.data.results import (
    make_track_ids_unique as jax_make_track_ids_unique,
)
from tao_amodal_tpu.evaluation import (
    AmodalDetectionEvaluator as JaxDetectionEvaluator,
    TrackMapEvaluator as JaxTrackEvaluator,
)
from tao_amodal_torch.data.results import make_track_ids_unique
from tao_amodal_torch.data.tao import TaoDataset
from tao_amodal_torch.evaluation import (
    AmodalDetectionEvaluator,
    TrackMapEvaluator,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "golden_seed0.json")


def _fixture(seed, **kw):
    gt, preds = make_fixture(seed=seed, **kw)
    make_track_ids_unique(preds)
    return gt, preds


def _results(cls, gt, preds, *args, **kw):
    ev = cls(copy.deepcopy(gt), copy.deepcopy(preds), *args, **kw)
    ev.run()
    return ev.get_results()


def _assert_same(ours, theirs, atol):
    assert list(ours.keys()) == list(theirs.keys())
    for k in theirs:
        assert abs(float(ours[k]) - float(theirs[k])) <= atol, (
            k, ours[k], theirs[k])


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_track_map_equals_jax(seed):
    gt, preds = _fixture(seed)
    _assert_same(_results(TrackMapEvaluator, gt, preds),
                 _results(JaxTrackEvaluator, gt, preds), 1e-12)


@pytest.mark.parametrize("iou_3d_type", ["avg_iou", "imagenetvid"])
def test_track_map_other_track_ious_equal_jax(iou_3d_type):
    gt, preds = _fixture(0)
    _assert_same(
        _results(TrackMapEvaluator, gt, preds, iou_3d_type=iou_3d_type),
        _results(JaxTrackEvaluator, gt, preds, iou_3d_type=iou_3d_type),
        1e-12)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_detection_ap_equals_jax(seed):
    gt, preds = _fixture(seed)
    _assert_same(_results(AmodalDetectionEvaluator, gt, preds, "bbox"),
                 _results(JaxDetectionEvaluator, gt, preds, "bbox"), 1e-12)


def test_golden_metrics(tmp_path):
    """The JSON-file route of ``tests/test_golden.py``."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    gt, preds = _fixture(golden["seed"])
    gt_path, pred_path = tmp_path / "gt.json", tmp_path / "preds.json"
    gt_path.write_text(json.dumps(gt))
    pred_path.write_text(json.dumps(preds))

    track = TrackMapEvaluator(str(gt_path), str(pred_path))
    track.run()
    det = AmodalDetectionEvaluator(str(gt_path), str(pred_path), "bbox")
    det.run()
    for got, want in ((track.get_results(), golden["track"]),
                      (det.get_results(), golden["detection"])):
        _assert_same({str(k): v for k, v in got.items()}, want, 1e-9)


def test_make_track_ids_unique_equals_jax():
    _, preds = make_fixture(seed=2)
    ours, theirs = copy.deepcopy(preds), copy.deepcopy(preds)
    n = make_track_ids_unique(ours)
    assert n > 0 and n == jax_make_track_ids_unique(theirs)
    assert ours == theirs
    # Already unique: nothing changes.
    assert make_track_ids_unique(ours) == 0 and ours == theirs


def test_serving_annotation_without_tracks_still_indexes(tmp_path):
    """The serving CLI's annotation may list only videos, frames and
    categories; the full dataset class still gives its three indices."""
    path = tmp_path / "ann.json"
    path.write_text(json.dumps({
        "videos": [{"id": 3, "name": "v", "width": 8, "height": 6}],
        "images": [{"id": 10 + i, "video_id": 3, "frame_index": i}
                   for i in range(2)],
        "categories": [{"id": 1, "name": "a"}]}))
    ds = TaoDataset(str(path))
    assert list(ds.vids) == [3] and list(ds.cats) == [1]
    assert [im["id"] for im in ds.vid_img_map[3]] == [10, 11]
    assert np.array_equal(ds.get_img_ids(), [10, 11])
