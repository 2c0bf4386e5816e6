"""The port's scale-out layer held against the JAX package on the CPU:
the mesh's layout, multi-host feeding, the serving lanes (the stateful
and the stateless sharded serving, and the inference CLI's
``--data_parallel``), context-parallel track IoU and the device
evaluator's ``mesh=`` arm, and the host pools.

The port's side runs in gloo ranks on the CPU, started per test (rank 0
in this process, the others spawned) with a file store in a temporary
directory, one PyTorch thread a rank and a timeout of their own (``tests/torch_port_parallel_ranks.py``); JAX's
side runs in this process on two (or four) of the virtual CPU devices
of ``tests/conftest.py``.  The weights are JAX's, perturbed
(``torch_port_fixtures.jax_pipeline``), carried across by the npz
bridge.

Tolerances: the serving outputs at ``test_torch_port_batched.py``'s
(integers exact on coherent clips, boxes rtol 1e-4 + 1e-3 px, scores
1e-5); the CLI's records at the CLI parity bounds (integers exact,
boxes rtol 1e-4 + 1e-3 px, scores 1e-5 against the port's single stream
and 3e-5 against JAX's lanes), in JAX's order; track IoU and
the evaluator's metrics within 1e-6.
"""

import copy
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks
from fixture_gen import make_fixture
from test_torch_port_batched import (
    assert_outputs_close,
    assert_states_close,
    coherent_videos,
)
from torch_port_fixtures import jax_pipeline, one_torch_thread, save_npz

from tao_amodal_torch.cli.infer_cli import main as port_infer
from tao_amodal_torch.data.dayone_fixture import build
from tao_amodal_torch.data.results import make_track_ids_unique
from tao_amodal_torch.parallel import FixedDevicePool, PoolWithContext
from tao_amodal_torch.parallel.mesh import make_mesh as port_make_mesh
from tao_amodal_tpu.evaluation.device_eval import (
    DeviceTrackEval as JaxDeviceTrackEval,
)
from tao_amodal_tpu.parallel import mesh as jax_mesh_mod
from tao_amodal_tpu.parallel.cp import sharded_track_iou as jax_track_iou
from tao_amodal_tpu.parallel.host import ShardedSampler as JaxSampler
from tao_amodal_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tao_amodal_tpu.pipeline import (
    make_sharded_inference as jax_sharded_inference,
    make_sharded_streaming as jax_sharded_streaming,
)

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

LANES, CLIPS, T = 2, 2, 4
INT_FIELDS = ("image_id", "category_id", "track_id", "video_id")
IOU_TOL = 1e-6
# The CLI's scores against JAX's: on the tree of
# test_data_parallel_cli_matches_jax one record of 103 differs by
# 1.26e-5, and the two packages' single streams already differ by up to
# 1.42e-5 on it (the f32 trunks sum in other orders); the lanes part from
# the port's single stream by 1.1e-6 at most.
CLI_SCORE_TOL = 3e-5


def jax_mesh(data, model=1):
    return jax_make_mesh(data=data, model=model,
                         devices=jax.devices()[:data * model])


def test_mesh_layout_matches_jax():
    """Four ranks as ``(2, 2)``: each rank's coordinates are where JAX's
    ``reshape(data, model)`` puts device ``rank``; its data group sums
    over its column, its model group over its row.  One process without
    a group is the ``(1, 1)`` mesh, and ``"cuda"`` names card ``rank``."""
    got = ranks.start(ranks.mesh_layout, 4, 2, 2)
    devices = np.asarray([d.id for d in jax.devices()[:4]])
    layout = jax_mesh(2, 2).devices
    for r, (shape, d, m, (data_sum, model_sum), device) in enumerate(got):
        assert shape == {"data": 2, "model": 2}
        assert layout[d, m].id == devices[r]
        assert data_sum == sum(2 ** (dd * 2 + m) for dd in range(2))
        assert model_sum == sum(2 ** (d * 2 + mm) for mm in range(2))
        assert device == "cpu"
    one = port_make_mesh()
    assert one.shape == {"data": 1, "model": 1}
    assert one.data_group is None and one.model_group is None
    assert one.device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="does not cover"):
        port_make_mesh(data=2)


def test_sharded_sampler_and_host_shards_match_jax():
    """The sampler's indices of each of 2 ranks (index and count from the
    process group) for 3 epochs equal JAX's ``ShardedSampler`` given the
    same index and count, and ``host_shard_indices`` splits a batch of 8
    as JAX's does."""
    got = ranks.start(ranks.sampler, 2, 101, 7, 3)
    union = []
    for r, (epochs, shard) in enumerate(got):
        want = JaxSampler(101, seed=7, process_index=r, process_count=2)
        for e, idx in enumerate(epochs):
            np.testing.assert_array_equal(idx, want.epoch_indices(e))
        assert shard == slice(4 * r, 4 * r + 4)
        union.extend(epochs[0].tolist())
    assert sorted(union) == list(range(101))


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    pipe, variables = jax_pipeline(seed=5)
    return pipe, variables, save_npz(tmp_path_factory.mktemp("npz"),
                                     variables)


def test_sharded_streaming_matches_jax(bridged):
    """Two lanes, one a rank, two clips of 4 frames with each lane's
    state threaded: every clip's outputs and the final states against
    JAX's ``make_sharded_streaming`` on a 2-device mesh, and
    ``make_sharded_inference`` of the first clips against JAX's."""
    pipe, variables, npz = bridged
    clips = np.stack([coherent_videos(10 + j, b=LANES, t=T)
                      for j in range(CLIPS)], axis=1)
    mesh = jax_mesh(LANES)
    init_states, run = jax_sharded_streaming(pipe, variables, mesh,
                                             score_thr=0.0)
    states, want = init_states(), []
    for j in range(CLIPS):
        out, states = run(clips[:, j], states)
        want.append(jax.tree_util.tree_map(np.asarray, out))
    want_states = jax.tree_util.tree_map(np.asarray, states)
    stateless = jax.tree_util.tree_map(np.asarray, jax_sharded_inference(
        pipe, variables, mesh)(clips[:, 0]))

    got = ranks.start(ranks.streaming, LANES, npz, clips, 0.0)
    for b, (outs, lane_states, lane_stateless) in enumerate(got):
        for j in range(CLIPS):
            assert outs[j]["track_ids"].shape == (1, T, 8)
            assert_outputs_close({k: v[0] for k, v in outs[j].items()},
                                 {k: v[b] for k, v in want[j].items()},
                                 f"lane {b} clip {j} ")
        assert_states_close(
            types.SimpleNamespace(**{k: v[0] for k, v in
                                     lane_states.items()}),
            jax.tree_util.tree_map(lambda v: v[b], want_states),
            f"lane {b} ")
        assert_outputs_close({k: v[0] for k, v in lane_stateless.items()},
                             {k: v[b] for k, v in stateless.items()},
                             f"stateless lane {b} ")
    assert (want_states.next_id > 1).all()


def _dayone_tree(tmp_path):
    """The day-one tree (3 videos of 6 frames at 64^2) with video 2 cut
    to 3 frames and video 3 to 5, so that lanes run out at different
    clips; returns (annotation path, frames dir, categories)."""
    root = build(str(tmp_path / "tree"), num_videos=3, frames_per_video=6,
                 hw=64, tracks_per_video=2, seed=2)
    path = os.path.join(root, "amodal_annotations",
                        "validation_lvis_v1.json")
    with open(path) as f:
        gt = json.load(f)
    keep = {1: 6, 2: 3, 3: 5}
    drop = {im["id"] for im in gt["images"]
            if im["frame_index"] >= keep[im["video_id"]]}
    gt["images"] = [im for im in gt["images"] if im["id"] not in drop]
    gt["annotations"] = [a for a in gt["annotations"]
                         if a["image_id"] not in drop]
    cut = str(tmp_path / "annotation.json")
    with open(cut, "w") as f:
        json.dump(gt, f)
    return cut, os.path.join(root, "frames"), len(gt["categories"])


def _by_key(records):
    return sorted(records, key=lambda r: tuple(r[k] for k in INT_FIELDS))


def _assert_records_close(got, want, score_tol=1e-5):
    """Integers equal, boxes rtol 1e-4 + 1e-3 px, scores within
    ``score_tol``."""
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert [a[k] for k in INT_FIELDS] == [b[k] for k in INT_FIELDS]
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=1e-4,
                                   atol=1e-3)
        assert abs(a["score"] - b["score"]) <= score_tol, (a, b)


def test_data_parallel_cli_matches_jax(tmp_path, monkeypatch):
    """``--data_parallel`` over 2 lanes (gloo ranks on the CPU) on 3
    videos of 6, 3 and 5 frames (more videos than lanes: a second group
    of one video, lanes of different lengths, short last clips): the JSON
    holds the port's single stream's records within the CLI bounds (the
    ranks' thread counts sum the f32 convolutions in other orders) and
    equals JAX's ``--data_parallel`` on a 2-device mesh record for
    record, in JAX's order, its scores within CLI_SCORE_TOL."""
    from tao_amodal_tpu.cli.infer_cli import main as jax_infer

    ann, frames, n_cats = _dayone_tree(tmp_path)
    _, variables = jax_pipeline(seed=3, num_classes=n_cats)
    npz = save_npz(tmp_path, variables)
    common = ["--annotation", ann, "--images_dir", frames, "--input_size",
              "64", "--clip_len", str(T), "--score_threshold", "0.0",
              "--backbone_stages", "1,1,1,1", "--num_dets", "8",
              "--num_proposals", "16", "--checkpoint", npz]
    real = jax_mesh_mod.make_mesh
    monkeypatch.setattr(jax_mesh_mod, "make_mesh", lambda model=1: real(
        data=LANES, model=model, devices=jax.devices()[:LANES]))
    want = jax_infer(common + ["--data_parallel", "--output",
                               str(tmp_path / "jax.json")])
    lanes = str(tmp_path / "lanes.json")
    got = port_infer(common + ["--data_parallel", "--lanes", str(LANES),
                               "--device", "cpu", "--output", lanes])
    solo = port_infer(common + ["--device", "cpu", "--output",
                                str(tmp_path / "solo.json")])
    with open(lanes) as f:
        assert json.load(f) == got
    _assert_records_close(_by_key(got), _by_key(solo))
    assert [r["video_id"] for r in got][0] == 1
    assert {r["video_id"] for r in got} == {1, 2, 3}
    _assert_records_close(got, want, score_tol=CLI_SCORE_TOL)


def _track_scene(seed, D=6, G=5, F=32):
    rs = np.random.RandomState(seed)
    return (rs.rand(D, F, 4).astype(np.float32) * 50, rs.rand(D, F) < 0.7,
            rs.rand(G, F, 4).astype(np.float32) * 50, rs.rand(G, F) < 0.7)


def test_sharded_track_iou_matches_jax():
    """Frames split over 2 ranks: the ``[D, G]`` matrix on each rank
    against JAX's ``sharded_track_iou`` on a 2-device mesh."""
    scene = _track_scene(0)
    want = np.asarray(jax_track_iou(jax_mesh(2), *scene))
    got = ranks.start(ranks.track_iou, 2, *scene)
    for g in got:
        np.testing.assert_allclose(g, want, rtol=0, atol=IOU_TOL)
    assert (want > 0).any()


@pytest.fixture(scope="module")
def eval_fixture():
    gt, preds = make_fixture(seed=4, num_videos=4, frames_per_video=16)
    make_track_ids_unique(preds)
    return gt, preds


def test_device_eval_mesh_matches_jax(eval_fixture):
    """``DeviceTrackEval(mesh=..., cp_min_frames=8)`` over 2 ranks (every
    video's 16 frames split 8 + 8) against JAX's on a 2-device mesh:
    every metric within 1e-6, and every video took the split IoU."""
    gt, preds = eval_fixture
    ev = JaxDeviceTrackEval(copy.deepcopy(gt), copy.deepcopy(preds),
                            mesh=jax_mesh(2), cp_min_frames=8)
    ev.run()
    want = ev.get_results()
    for got, calls in ranks.start(ranks.device_eval, 2, gt, preds, 8):
        assert calls == len(gt["videos"])
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= IOU_TOL, (k, got[k], want[k])


def test_pools():
    """``PoolWithContext`` hands its workers the context; each worker of
    ``FixedDevicePool`` sees its own device id in ``TAO_AMODAL_DEVICE``."""
    with PoolWithContext(2, 10) as pool:
        assert sorted(pool.map(ranks.scaled, [1, 2, 3])) == [10, 20, 30]
        assert sorted(pool.imap_unordered(ranks.scaled, [4])) == [40]
    out = FixedDevicePool(["cpu-a", "cpu-b"], 3, ranks.on_device).run(
        [1, 2, 3, 4])
    assert sorted(o[2] for o in out) == [3, 6, 9, 12]
    assert all(o[0] == o[1] for o in out)
    assert {o[0] for o in out} <= {"cpu-a", "cpu-b"}


def test_data_parallel_cli_without_a_card_raises(tmp_path):
    """``--data_parallel`` serves one lane a visible card by default;
    where there is none it raises rather than serve on the CPU (``--device
    cpu`` asks for the CPU).  Whether there is a card is decided here, at
    run time."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="found no card"):
        port_infer(["--annotation", "unused.json", "--output",
                    str(tmp_path / "p.json"), "--data_parallel"])
