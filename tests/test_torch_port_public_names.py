"""The port's public names and the module-level functions it lacked,
held against the JAX package's on the CPU.

* Every name that ``tao_amodal_tpu.{data,ops,models,trackers}`` export
  imports from the port's package of the same name (``greedy_match_jax``
  is ``greedy_match_torch`` in the port).
* ``native/lib.py``: ``NativeRle.bbox_iou`` and ``bbox_nms`` (xywh,
  pycocotools' crowd rule, strict ``>`` suppression over boxes sorted by
  score) against JAX's ``NativeLib`` on the cases of
  ``tests/test_native.py`` and a seeded random set, crowd included: IoU
  within 1e-12, keep masks equal.
* ``evaluation/batched.py``: ``pr_curves_device`` against JAX's on
  seeded ``[C, T, N]`` cells, absent cells included (equal, f32), and
  ``pack_video`` equal to JAX's array for array.
* ``ops/boxes.py``: ``xywh_to_xyxy`` and ``xyxy_to_xywh`` on numpy and
  torch against JAX's; ``ops/optimization.py::GNState``.
"""

import importlib
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# JAX's names that the port spells otherwise.
RENAMED = {"greedy_match_jax": "greedy_match_torch"}


@pytest.mark.parametrize("package", ["data", "ops", "models", "trackers"])
def test_package_exports_jax_names(package):
    jax_pkg = importlib.import_module(f"tao_amodal_tpu.{package}")
    port_pkg = importlib.import_module(f"tao_amodal_torch.{package}")
    names = [n for n, v in vars(jax_pkg).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)
             and n != "annotations"]
    assert names
    for name in names:
        ours = getattr(port_pkg, RENAMED.get(name, name))
        theirs = getattr(jax_pkg, name)
        assert ours.__name__ == theirs.__name__ or name in RENAMED or (
            ours is getattr(port_pkg, theirs.__name__)), name
        assert inspect.isclass(ours) == inspect.isclass(theirs), name
        assert ours.__module__.startswith("tao_amodal_torch."), name
    if package == "data":
        assert port_pkg.Tao is port_pkg.TaoDataset
        assert port_pkg.LVISResults is port_pkg.LvisResultsDataset


@pytest.fixture(scope="module")
def libs():
    from tao_amodal_torch.native import lib as port_lib

    native = pytest.importorskip("tao_amodal_tpu.native.lib")
    assert port_lib.NativeLib is port_lib.NativeRle
    return native.load(), port_lib.load()


def box_sets():
    """(dt, gt, iscrowd) cases: ``tests/test_native.py``'s, then seeded
    random ones with crowds, degenerate and touching boxes."""
    rng = np.random.RandomState(3)
    yield np.abs(rng.randn(9, 4)) * 40, np.abs(rng.randn(5, 4)) * 40, None
    rs = np.random.RandomState(11)
    for n_dt, n_gt in ((17, 13), (1, 30), (30, 1), (0, 4), (4, 0)):
        dt = rs.rand(n_dt, 4) * [200, 150, 60, 60]
        gt = rs.rand(n_gt, 4) * [200, 150, 60, 60]
        if n_dt > 3:
            dt[0, 2:] = 0                       # zero-area detection
            dt[1] = dt[2] + [dt[2, 2], 0, 0, 0]  # touching at an edge
        yield dt, gt, rs.rand(n_gt) < 0.3
    yield np.array([[0, 0, 10, 10]], float), np.array(
        [[0, 0, 10, 10], [2, 2, 4, 4], [20, 20, 5, 5]], float), [1, 1, 0]


def test_bbox_iou_matches_jax(libs):
    from tao_amodal_torch.ops.boxes import box_iou_matrix

    theirs, ours = libs
    for dt, gt, crowd in box_sets():
        got = ours.bbox_iou(dt, gt, crowd)
        want = theirs.bbox_iou(dt, gt, crowd)
        assert got.dtype == want.dtype == np.float64
        assert got.shape == want.shape == (len(dt), len(gt))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        if len(dt) and len(gt):
            np.testing.assert_allclose(
                got, box_iou_matrix(dt, gt, None if crowd is None else
                                    np.asarray(crowd, bool)),
                rtol=0, atol=1e-12)


def test_bbox_nms_matches_jax(libs):
    theirs, ours = libs
    boxes = np.array([[0, 0, 10, 10], [1, 1, 10, 10], [50, 50, 10, 10]],
                     float)
    assert ours.bbox_nms(boxes, 0.5).tolist() == [True, False, True]
    rs = np.random.RandomState(7)
    for n in (0, 1, 40, 200):
        centers = rs.rand(n, 2) * 120
        wh = 10 + rs.rand(n, 2) * 30
        boxes = np.concatenate([centers, wh], 1)
        for thr in (0.0, 0.3, 0.5, 0.7):
            got = ours.bbox_nms(boxes, thr)
            assert got.dtype == bool and got.shape == (n,)
            np.testing.assert_array_equal(got, theirs.bbox_nms(boxes, thr))
    # Strict suppression: an IoU of exactly thr keeps the box.
    pair = np.array([[0, 0, 10, 10], [0, 0, 10, 5]], float)
    assert ours.bbox_nms(pair, 0.5).tolist() == [True, True]
    assert ours.bbox_nms(pair, 0.49).tolist() == [True, False]


def pr_cells(seed, lead=(6,), T=3, N=40):
    rs = np.random.RandomState(seed)
    tps = rs.rand(*lead, T, N) < 0.4
    fps = ~tps & (rs.rand(*lead, T, N) < 0.7)
    num_gt = rs.randint(0, 12, size=lead).astype(np.int32)
    num_gt.reshape(-1)[::3] = 0                    # absent cells
    return tps, fps, num_gt, np.linspace(0, 1, 101).astype(np.float32)


@pytest.mark.parametrize("lead", [(6,), (2, 5)])
def test_pr_curves_device_matches_jax(lead):
    from tao_amodal_tpu.evaluation.batched import pr_curves_device as jpr
    from tao_amodal_torch.evaluation.batched import pr_curves_device

    tps, fps, num_gt, rec = pr_cells(sum(lead), lead)
    want_p, want_r = jpr(jnp.asarray(tps), jnp.asarray(fps),
                         jnp.asarray(num_gt), jnp.asarray(rec))
    got_p, got_r = pr_curves_device(torch.from_numpy(tps),
                                    torch.from_numpy(fps),
                                    torch.from_numpy(num_gt),
                                    torch.from_numpy(rec))
    assert got_p.dtype == got_r.dtype == torch.float32
    assert tuple(got_p.shape) == lead + (3, 101)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    absent = num_gt == 0
    assert (got_p.numpy()[absent] == -1).all()
    assert (got_r.numpy()[absent] == -1).all()


def test_pack_video_matches_jax():
    from tao_amodal_tpu.evaluation.batched import pack_video as jpack
    from tao_amodal_torch.evaluation.batched import pack_video

    rs = np.random.RandomState(2)

    def tracks(n, is_gt):
        out = []
        for i in range(n):
            frames = sorted(rs.choice(8, size=rs.randint(1, 8),
                                      replace=False).tolist())
            tr = {"boxes": {f: (rs.rand(4) * 50).tolist() for f in frames},
                  "category_id": int(rs.randint(1, 5)),
                  "area": float(rs.rand() * 900),
                  "duration": float(len(frames))}
            if is_gt:
                if i % 2:
                    tr.update(hp_frames=int(rs.randint(0, 8)), ignore=1)
            else:
                tr["score"] = float(rs.rand())
                if i % 2:
                    tr["nel"] = True
            out.append(tr)
        return out

    dt, gt = tracks(5, False), tracks(4, True)
    for pad_d, pad_g in ((8, 6), (3, 2)):
        got = pack_video(dt, gt, pad_d, pad_g, 8)
        want = jpack(dt, gt, pad_d, pad_g, 8)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_xywh_helpers_match_jax():
    from tao_amodal_tpu.ops import boxes as jboxes
    from tao_amodal_torch.ops.boxes import xywh_to_xyxy, xyxy_to_xywh

    b = np.random.RandomState(4).rand(3, 5, 4).astype(np.float32) * 80
    for ours, theirs in ((xywh_to_xyxy, jboxes.xywh_to_xyxy),
                         (xyxy_to_xywh, jboxes.xyxy_to_xywh)):
        want = np.asarray(theirs(jnp.asarray(b)))
        np.testing.assert_array_equal(ours(b), want)
        np.testing.assert_array_equal(ours(b.astype(np.float64)),
                                      theirs(b.astype(np.float64), xp=np))
        t = ours(torch.from_numpy(b))
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want)
    whole = np.round(b)        # exact in f32 both ways
    np.testing.assert_array_equal(xyxy_to_xywh(xywh_to_xyxy(whole)), whole)


def test_gn_state():
    from tao_amodal_tpu.ops.optimization import GNState as JGNState
    from tao_amodal_torch.ops.optimization import GNState

    assert GNState._fields == JGNState._fields
    s = GNState(params={"w": torch.ones(2)}, losses=torch.zeros(3))
    assert s.losses.shape == (3,) and s[0]["w"].sum() == 2
