"""The port's whole serving slice held against the JAX package on the
CPU: ``AmodalPipeline.streaming`` over two clips with the SORT state
threaded between them, then both inference CLIs on the same annotation,
frames and npz checkpoint."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fixture_gen import make_fixture
from torch_port_fixtures import (
    S,
    T,
    TINY,
    jax_pipeline,
    save_npz,
    torch_pipeline,
    write_frames,
)


def coherent_clips(seed, n=2):
    """n clips of one slowly changing scene: every frame is a base frame
    plus small noise, so detections persist and SORT keeps its tracks
    across frames and across the clip boundary (coherent
    scenes keep the integer outputs away from f32 near-ties)."""
    rs = np.random.RandomState(seed)
    base = rs.randn(1, S, S, 3).astype(np.float32)
    return [base + 0.01 * rs.randn(T, S, S, 3).astype(np.float32)
            for _ in range(n)]


def test_streaming_two_clips_matches_jax(tmp_path):
    """Outputs of both clips and the threaded SORT state.  Integers
    exact; boxes rtol 1e-4 + atol 1e-3 px and scores atol 1e-5 (f32
    through the trunk in another summation order).  Random
    weights put scores near 1/9, under the 0.05 default, so the clips
    run at score_thr=0.0 and tracks must be born."""
    pipe, variables = jax_pipeline(seed=1)
    tp = torch_pipeline(save_npz(tmp_path, variables))
    run = jax.jit(lambda c, s: pipe.streaming(variables, c, s,
                                              score_thr=0.0))
    js, ts = pipe.init_tracker_state(), tp.init_tracker_state()
    for clip in coherent_clips(3):
        want, js = run(jnp.asarray(clip), js)
        got, ts = tp.streaming(torch.from_numpy(clip), ts, score_thr=0.0)
        assert set(got) == set(want)
        for k in ("classes", "track_ids", "valid"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        for k in ("boxes", "visible_boxes"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(want["scores"]), atol=1e-5)
    assert int(ts.next_id) == int(js.next_id) > 1
    # Ids continue across the clip boundary: the second clip reuses
    # ids born in the first.
    assert got["track_ids"][0][got["valid"][0]].min() < int(ts.next_id)
    # The expander's (perturbed) deltas move the reported boxes.
    assert not np.allclose(got["boxes"].numpy(),
                           got["visible_boxes"].numpy())


def test_detections_to_json_matches_jax():
    """The per-clip emission on one outputs dict, with raw SORT ids and
    with the (track, class) split map threaded over two calls: the
    records are equal (the host code is numpy on both sides)."""
    from tao_amodal_tpu.pipeline import detections_to_json as jemit
    from tao_amodal_torch.pipeline import detections_to_json as temit

    rs = np.random.RandomState(7)
    xy = rs.uniform(0, 50, (3, 5, 2)).astype(np.float32)
    out = {"boxes": np.concatenate([xy, xy + 10], -1),
           "scores": rs.rand(3, 5).astype(np.float32),
           "classes": rs.randint(0, 3, (3, 5)),
           "track_ids": rs.randint(1, 4, (3, 5)),
           "valid": rs.rand(3, 5) > 0.3}
    tout = {k: torch.from_numpy(v) for k, v in out.items()}
    ids, cmap = [11, 12, 13], {0: 5, 1: 6, 2: 9}
    assert (temit(tout, ids, 3, class_id_map=cmap, track_id_base=3000)
            == jemit(out, ids, 3, class_id_map=cmap, track_id_base=3000))
    tmap, jmap = {}, {}
    for _ in range(2):
        assert (temit(tout, ids, 3, track_key_map=tmap)
                == jemit(out, ids, 3, track_key_map=jmap))
    assert tmap == jmap


def test_cli_records_match_jax_cli(tmp_path):
    """Both CLIs on one annotation (2 videos x 6 frames at 80x60, so a
    0.8 letterbox and a zero-padded last clip), one npz.  Video 1 has
    frame files (PIL path), video 2 has none (gray fallback).  Records,
    ids, categories and track ids equal; bbox rtol 1e-4 + atol 2e-3 px
    (boxes are divided by the 0.8 scale) and score atol 1e-5."""
    from tao_amodal_tpu.cli.infer_cli import main as jax_main
    from tao_amodal_torch.cli.infer_cli import main as torch_main

    gt, _ = make_fixture(seed=11, num_videos=2, frames_per_video=6,
                         num_cats=TINY["num_classes"], img_size=(80, 60))
    ann = tmp_path / "gt.json"
    ann.write_text(json.dumps(gt))
    images_dir = tmp_path / "frames"
    write_frames(images_dir, gt, video_id=1, seed=4)
    _, variables = jax_pipeline(seed=2)
    npz = save_npz(tmp_path, variables)
    common = ["--annotation", str(ann), "--images_dir", str(images_dir),
              "--checkpoint", npz, "--input_size", str(S),
              "--clip_len", str(T), "--score_threshold", "0.0",
              "--backbone_stages", "1,1,1,1",
              "--num_dets", str(TINY["num_dets"]),
              "--num_proposals", str(TINY["num_proposals"])]
    want = jax_main(common + ["--output", str(tmp_path / "jax.json")])
    got = torch_main(common + ["--output", str(tmp_path / "torch.json"),
                               "--device", "cpu"])
    assert got == json.loads((tmp_path / "torch.json").read_text())
    assert len(got) == len(want) > 0
    assert {r["video_id"] for r in got} == {1, 2}
    for g, w in zip(got, want):
        for k in ("image_id", "category_id", "track_id", "video_id"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5)
    # Track ids are video_id * 10**6 + SORT id.
    assert all(r["track_id"] // 10 ** 6 == r["video_id"] for r in got)


def test_cli_random_init_runs_without_checkpoint(tmp_path):
    """Smoke mode: seeded random weights, gray frames, schema intact."""
    from tao_amodal_torch.cli.infer_cli import main as torch_main

    gt, _ = make_fixture(seed=12, num_videos=1, frames_per_video=3,
                         num_cats=3, img_size=(64, 64))
    ann = tmp_path / "gt.json"
    ann.write_text(json.dumps(gt))
    recs = torch_main(["--annotation", str(ann), "--output",
                       str(tmp_path / "p.json"), "--input_size", "64",
                       "--clip_len", "2", "--score_threshold", "0.0",
                       "--backbone_stages", "1,1,1,1", "--num_dets", "4",
                       "--num_proposals", "8", "--device", "cpu"])
    assert recs
    assert set(recs[0]) == {"image_id", "category_id", "bbox", "score",
                            "track_id", "video_id"}
    assert {r["category_id"] for r in recs} <= {1, 2, 3}
    assert torch.isfinite(torch.tensor([r["bbox"] for r in recs])).all()
