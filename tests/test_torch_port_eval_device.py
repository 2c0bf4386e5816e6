"""The port's device evaluators on ``device="cpu"``, against the JAX
package's device functions and the port's float64 host evaluators.

Tolerances:
  * the greedy matcher, float32 on both sides on the same IoUs: every
    integer exactly equal;
  * float32 IoUs (track and box) against JAX's float32: 1e-6, a few f32
    ulps of values <= 1 summed in another order;
  * the evaluators against the float64 host oracle: 2e-3 on
    ``fixture_gen`` (``tests/test_device_eval.py:41``), and the
    ``tests/test_device_tolerance.py`` contract: < 1e-9 when every IoU
    is >= 1e-3 off every threshold, <= 0.30 on the on-threshold fixture.
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixture_gen import make_fixture
from test_device_tolerance import _fixture as jax_threshold_fixture
from torch_port_eval_fixtures import threshold_fixture

from tao_amodal_tpu.evaluation.batched import (
    eval_video_device as jax_eval_video_device,
)
from tao_amodal_tpu.evaluation.device_detection import (
    eval_images_device as jax_eval_images_device,
)
from tao_amodal_tpu.ops.boxes import box_iou_matrix as jax_box_iou_matrix
from tao_amodal_tpu.ops.matching import greedy_match_jax
from tao_amodal_tpu.ops.track_iou import (
    track_iou_matrix as jax_track_iou_matrix,
    track_iou_partials as jax_track_iou_partials,
)
from tao_amodal_torch.cli.eval_cli import main as eval_main
from tao_amodal_torch.data.results import make_track_ids_unique
from tao_amodal_torch.evaluation import (
    AmodalDetectionEvaluator,
    DeviceDetectionEval,
    DeviceTrackEval,
    TrackMapEvaluator,
)
from tao_amodal_torch.evaluation.batched import (
    check_int16_ids,
    eval_video_device,
)
from tao_amodal_torch.evaluation.device_detection import eval_images_device
from tao_amodal_torch.ops.boxes import box_iou_matrix
from tao_amodal_torch.ops.matching import greedy_match, greedy_match_torch
from tao_amodal_torch.ops.track_iou import (
    track_iou_matrix,
    track_iou_partials,
)

CPU = "cpu"
THRS = np.linspace(0.5, 0.95, 10)


@pytest.fixture(scope="module")
def fixture():
    gt, preds = make_fixture(seed=4, num_videos=4, frames_per_video=16)
    make_track_ids_unique(preds)
    return gt, preds


def _results(cls, gt, preds, *args, **kw):
    ev = cls(copy.deepcopy(gt), copy.deepcopy(preds), *args, **kw)
    ev.run()
    return ev.get_results()


def _match_case(rs, D, G, step):
    """IoUs on a grid of ``step`` (ties, values on the thresholds), some
    ignored and some padded gts and detections."""
    ious = (rs.randint(0, int(round(1 / step)) + 1, (D, G)) * step)
    ious[rs.rand(D, G) < 0.3] = 0.0
    gt_ig = (rs.rand(G) < 0.3).astype(np.float32)
    gt_ig.sort()                     # ignore-last, as the callers sort
    dt_valid = rs.rand(D) < 0.85
    gt_valid = rs.rand(G) < 0.85
    return ious.astype(np.float32), gt_ig, dt_valid, gt_valid


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("unmatched", [-1.0, 0.0])
def test_greedy_match_torch_equals_jax(seed, unmatched):
    rs = np.random.RandomState(seed)
    D, G = 12, 9
    ious, gt_ig, dt_valid, gt_valid = _match_case(rs, D, G, 0.05)
    dt_ids = np.arange(D, dtype=np.float32) + 1
    gt_ids = np.arange(G, dtype=np.float32) + 101
    want = greedy_match_jax(ious, gt_ig, dt_ids, gt_ids, THRS,
                            dt_valid=dt_valid, gt_valid=gt_valid,
                            unmatched=unmatched)
    got = greedy_match_torch(*map(torch.from_numpy, (
        ious, gt_ig, dt_ids, gt_ids, THRS.astype(np.float32), dt_valid,
        gt_valid)), unmatched=unmatched)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_greedy_match_torch_batches_cells_as_single_calls():
    """Cells on leading axes (broadcast dt ids, per-cell masks) give each
    cell's single call; the host matcher agrees on exact IoUs (k/16)."""
    rs = np.random.RandomState(7)
    B, D, G = 5, 10, 7
    cases = [_match_case(rs, D, G, 1 / 16) for _ in range(B)]
    ious, gt_ig, dt_valid, gt_valid = (np.stack(x) for x in zip(*cases))
    dt_ids = np.arange(D, dtype=np.float32) + 1
    gt_ids = np.arange(G, dtype=np.float32) + 101
    thrs = torch.from_numpy(THRS.astype(np.float32))
    batched = greedy_match_torch(
        torch.from_numpy(ious), torch.from_numpy(gt_ig),
        torch.from_numpy(dt_ids), torch.from_numpy(gt_ids), thrs,
        dt_valid=torch.from_numpy(dt_valid),
        gt_valid=torch.from_numpy(gt_valid))
    for b in range(B):
        one = greedy_match_torch(
            *map(torch.from_numpy, (ious[b], gt_ig[b], dt_ids, gt_ids)),
            thrs, dt_valid=torch.from_numpy(dt_valid[b]),
            gt_valid=torch.from_numpy(gt_valid[b]))
        for x, y in zip(batched, one):
            assert torch.equal(x[b], y)
        # The host matcher has no masks: give it the valid rows/columns.
        d, g = dt_valid[b], gt_valid[b]
        host = greedy_match(ious[b][d][:, g], gt_ig[b][g], dt_ids[d],
                            gt_ids[g], THRS)
        assert np.array_equal(batched[0][b].numpy()[:, d], host[0])
        assert np.array_equal(batched[1][b].numpy()[:, g], host[1])
        assert np.array_equal(batched[2][b].numpy()[:, d], host[2])


def _track_case(rs, D=5, G=4, F=7):
    boxes = lambda n: np.concatenate(  # noqa: E731
        [rs.uniform(0, 60, (n, F, 2)), rs.uniform(4, 40, (n, F, 2))], -1)
    return (boxes(D).astype(np.float32), rs.rand(D, F) < 0.7,
            boxes(G).astype(np.float32), rs.rand(G, F) < 0.7)


@pytest.mark.parametrize("mode", ["3d_iou", "avg_iou", "imagenetvid"])
def test_track_iou_matrix_equals_jax(mode):
    args = _track_case(np.random.RandomState(3))
    want = np.asarray(jax_track_iou_matrix(*map(jnp.asarray, args),
                                           mode=mode))
    got = track_iou_matrix(*map(torch.from_numpy, args), mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # The host form: float64 numpy, the JAX package's numpy path exactly.
    args64 = [a.astype(np.float64) if a.dtype == np.float32 else a
              for a in args]
    assert np.array_equal(
        track_iou_matrix(*args64, mode=mode),
        np.asarray(jax_track_iou_matrix(*args64, mode=mode, xp=np)))


def test_track_iou_partials_and_batch_axes_equal_jax():
    rs = np.random.RandomState(4)
    cases = [_track_case(rs) for _ in range(3)]
    stacked = [np.stack(x) for x in zip(*cases)]
    i_sum, u_sum = track_iou_partials(*map(torch.from_numpy, stacked))
    batch = track_iou_matrix(*map(torch.from_numpy, stacked))
    for b, case in enumerate(cases):
        wi, wu = jax_track_iou_partials(*map(jnp.asarray, case))
        np.testing.assert_allclose(i_sum[b].numpy(), wi, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(u_sum[b].numpy(), wu, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            batch[b].numpy(), jax_track_iou_matrix(*map(jnp.asarray, case)),
            rtol=0, atol=1e-6)


@pytest.mark.parametrize("crowd", [False, True])
def test_box_iou_matrix_equals_jax(crowd):
    rs = np.random.RandomState(5)
    dt = np.concatenate([rs.uniform(0, 50, (6, 2)),
                         rs.uniform(0, 30, (6, 2))], -1).astype(np.float32)
    gt = np.concatenate([rs.uniform(0, 50, (4, 2)),
                         rs.uniform(0, 30, (4, 2))], -1).astype(np.float32)
    iscrowd = np.array([0, 1, 0, 1], bool) if crowd else None
    want = np.asarray(jax_box_iou_matrix(jnp.asarray(dt), jnp.asarray(gt),
                                         iscrowd=iscrowd))
    got = box_iou_matrix(torch.from_numpy(dt), torch.from_numpy(gt),
                         iscrowd=iscrowd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    d64, g64 = dt.astype(np.float64), gt.astype(np.float64)
    assert np.array_equal(box_iou_matrix(d64, g64, iscrowd=iscrowd),
                          np.asarray(jax_box_iou_matrix(
                              d64, g64, iscrowd=iscrowd, xp=np)))


def _ranges(p):
    return (np.asarray(p.area_rng, np.float32),
            np.asarray(p.time_rng, np.float32),
            np.arange(len(p.area_rng)) == len(p.area_rng) - 1,
            np.asarray(p.iou_thrs, np.float32))


def _pad_pack(pack, n, F):
    """A packed video padded to ``n`` tracks over ``F`` frames, padding
    as ``_pack`` pads (score -inf, category -1, zeros elsewhere)."""
    out = {"cell_cats": pack["cell_cats"]} if "cell_cats" in pack else {}
    for k, v in pack.items():
        if k == "cell_cats":
            continue
        fill = {"scores": -np.inf, "cats": -1}.get(k, 0)
        a = np.full((n,) + ((F,) if v.ndim > 1 else ()) + v.shape[2:],
                    fill, v.dtype)
        a[(slice(0, v.shape[0]),) + ((slice(0, v.shape[1]),)
                                     if v.ndim > 1 else ())] = v
        out[k] = a
    return out


def test_eval_video_device_bucket_equals_jax(fixture):
    """Two videos of the fixture packed as DeviceTrackEval packs them:
    the bucket in one port call against JAX's program per video."""
    gt, preds = fixture
    ev = DeviceTrackEval(copy.deepcopy(gt), copy.deepcopy(preds),
                         device=CPU)
    gt_cells, dt_cells = ev._grouped_tracks()
    packs = []
    for vid in ev.params.vid_ids[:2]:
        entry = {"dt": [t for (v, _), ts in dt_cells.items() if v == vid
                        for t in ts],
                 "gt": [t for (v, _), ts in gt_cells.items() if v == vid
                        for t in ts]}
        dt, g, F = ev._pack(entry, ev.params)
        dt["cell_cats"] = np.array([1, 2, 3, 4, 5, 6, 7, -2], np.int32)
        packs.append((dt, g))
    # One bucket shape: pad both videos to the larger of each axis.
    D = max(d["scores"].shape[0] for d, _ in packs)
    G = max(g["cats"].shape[0] for _, g in packs)
    F = max(d["boxes"].shape[1] for d, _ in packs)
    packs = [(_pad_pack(d, D, F), _pad_pack(g, G, F)) for d, g in packs]
    area, time, occ, thrs = _ranges(ev.params)
    stack = lambda i: {k: torch.from_numpy(np.stack(  # noqa: E731
        [p[i][k] for p in packs])) for k in packs[0][i]}
    got = eval_video_device(stack(0), stack(1),
                            *map(torch.from_numpy, (area, time, occ, thrs)))
    for b, (dt, g) in enumerate(packs):
        want = jax_eval_video_device(
            {k: jnp.asarray(v) for k, v in dt.items()},
            {k: jnp.asarray(v) for k, v in g.items()}, None,
            *map(jnp.asarray, (area, time, occ, thrs)))
        for k in ("dt_matches", "dt_ignore", "gt_ignore", "dt_scores",
                  "dt_order"):
            assert np.array_equal(got[k][b].numpy(), np.asarray(want[k])), k
        assert np.array_equal(
            np.broadcast_to(got["dt_in_cell"][b].numpy()[:, None, None],
                            want["dt_in_cell"].shape),
            np.asarray(want["dt_in_cell"]))
        assert np.array_equal(
            np.broadcast_to(got["cell_valid"][b].numpy()[:, None, None],
                            want["cell_valid"].shape),
            np.asarray(want["cell_valid"]))
    assert (got["dt_matches"] > 0).any()


def test_eval_images_device_equals_jax(fixture):
    gt, preds = fixture
    ev = DeviceDetectionEval(copy.deepcopy(gt), copy.deepcopy(preds),
                             "bbox", device=CPU)
    p = ev.params
    gt_cells, dt_cells = ev._prepare_cells()
    per_img = {}
    for side, cells in (("gt", gt_cells), ("dt", dt_cells)):
        for (img, _), anns in cells.items():
            per_img.setdefault(img, {"dt": [], "gt": []})[side].extend(anns)
    items = []
    for i, img in enumerate(sorted(per_img)[:24]):
        e = per_img[img]
        e["cats"] = sorted({a["category_id"] for s in ("dt", "gt")
                            for a in e[s]})
        items.append((i, img, e))
    dt, g = ev._pack(items, 8, 8, 4)
    vis = np.asarray(p.visibility_rng, np.float32)
    oof = np.arange(len(vis)) == len(vis) - 1
    thrs = np.asarray(p.iou_thrs, np.float32)
    got = eval_images_device(
        {k: torch.from_numpy(v) for k, v in dt.items()},
        {k: torch.from_numpy(v) for k, v in g.items()},
        *map(torch.from_numpy, (vis, oof, thrs)))
    want = jax_eval_images_device(
        {k: jnp.asarray(v) for k, v in dt.items()},
        {k: jnp.asarray(v) for k, v in g.items()}, None,
        *map(jnp.asarray, (vis, oof, thrs)))
    for k in ("dt_matches", "dt_ignore", "gt_ignore", "dt_scores"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(
        np.broadcast_to(got["dt_in_cell"].numpy()[:, :, None],
                        want["dt_in_cell"].shape),
        np.asarray(want["dt_in_cell"]))
    assert np.array_equal(
        np.broadcast_to(got["cell_valid"].numpy()[:, :, None],
                        want["cell_valid"].shape),
        np.asarray(want["cell_valid"]))
    assert (got["dt_matches"] > 0).any()


@pytest.mark.parametrize("device_cls,host_cls,args", [
    (DeviceTrackEval, TrackMapEvaluator, ()),
    (DeviceDetectionEval, AmodalDetectionEvaluator, ("bbox",))])
def test_device_evaluator_matches_host(fixture, device_cls, host_cls,
                                       args):
    gt, preds = fixture
    h = _results(host_cls, gt, preds, *args)
    d = _results(device_cls, gt, preds, *args, device=CPU)
    assert list(h.keys()) == list(d.keys())
    for key in h:
        assert abs(h[key] - d[key]) < 2e-3, (key, h[key], d[key])
    assert h["AP50"] > 0.05


@pytest.mark.parametrize("device_cls,args,min_chunk", [
    (DeviceTrackEval, (), 1), (DeviceDetectionEval, ("bbox",), 2)])
def test_chunking_changes_no_metric(fixture, device_cls, args, min_chunk):
    gt, preds = fixture
    base = _results(device_cls, gt, preds, *args, device=CPU)
    ev = device_cls(copy.deepcopy(gt), copy.deepcopy(preds), *args,
                    device=CPU)
    ev.chunk_budget_bytes, ev.min_chunk = 1, min_chunk
    ev.run()
    for key, value in ev.get_results().items():
        assert abs(base[key] - value) < 1e-12, (key, base[key], value)


@pytest.mark.parametrize("on_threshold", [True, False])
def test_device_drift_bound(tmp_path, on_threshold):
    """``tests/test_device_tolerance.py``'s contract for the port."""
    gt, dt = threshold_fixture(on_threshold)
    assert (gt, dt) == jax_threshold_fixture(on_threshold)
    make_track_ids_unique(dt)
    gt_path, dt_path = tmp_path / "gt.json", tmp_path / "dt.json"
    gt_path.write_text(json.dumps(gt))
    dt_path.write_text(json.dumps(dt))
    h = _results(TrackMapEvaluator, str(gt_path), str(dt_path))
    d = _results(DeviceTrackEval, str(gt_path), str(dt_path), device=CPU)
    drift = max(abs(h[k] - d[k]) for k in h)
    if on_threshold:
        assert 0.05 < drift <= 0.30, (drift, h, d)
    else:
        assert drift < 1e-9, (drift, h, d)


def test_cuda_without_a_card_raises(fixture, tmp_path):
    """The device evaluators and ``--device_eval`` default to the card;
    where there is none they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gt, preds = fixture
    for make in (lambda: DeviceTrackEval(gt, preds),
                 lambda: DeviceDetectionEval(gt, preds, "bbox")):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        eval_main(["--track_result", "unused.json", "--annotation",
                   "unused.json", "--output_log",
                   str(tmp_path / "eval.log"), "--device_eval"])


def test_unported_arms_raise(fixture):
    """The ``mesh=`` arm in one process (a mesh of one rank, no process
    group): every video's track IoU from its frame sums
    (``cp_min_frames=8`` < the fixture's 16 frames) gives the metrics of
    the evaluator without a mesh, within 1e-6; a long ``cp_min_frames``
    takes none.  The gt ids stay within int16."""
    from tao_amodal_torch.parallel import cp
    from tao_amodal_torch.parallel.mesh import make_mesh

    gt, preds = fixture
    want = _results(DeviceTrackEval, gt, preds, device=CPU)
    calls = []
    real = cp.sharded_track_iou

    def counting(*args):
        calls.append(1)
        return real(*args)

    cp.sharded_track_iou = counting
    try:
        mesh = make_mesh(device=CPU)
        for cp_min, n in ((8, len(gt["videos"])), (1 << 20, 0)):
            calls.clear()
            got = _results(DeviceTrackEval, gt, preds, mesh=mesh,
                           cp_min_frames=cp_min, device=CPU)
            assert len(calls) == n
            assert set(got) == set(want)
            for k in want:
                assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    finally:
        cp.sharded_track_iou = real
    check_int16_ids(2 ** 15 - 102)
    with pytest.raises(ValueError, match="int16"):
        check_int16_ids(2 ** 15 - 101)
