"""Multi-video serving and the rest of ``AmodalPipeline.create``'s
options, held against the JAX package on the CPU.

``batched`` folds B videos' clips into one ``[B*T]`` frame batch and
runs SORT per video: against the JAX ``batched`` on the tiny pipeline of
``tests/test_batched_pipeline.py`` (3 videos x 4 frames, the npz
bridge's weights) with the states threaded 2 + 2 frames, and against B
``streaming`` calls of the port.  Then ``use_expander=False``, the SORT
options of ``create``, ``pooling``, the options that raise, the
``"prroi_packed_fused"`` pooling method, and the CLI's ``--assignment``.

Tolerances: integers (classes, track ids, valid, SORT counters) exact;
boxes rtol 1e-4 + atol 1e-3 px and scores atol 1e-5 (f32 through the
trunk in another summation order, or at another batch size); SORT's
float state rtol 1e-4 + atol 1e-3, but the area velocity, which carries
the boxes' tolerance times their sides, atol 0.1 px^2.  Clips are
coherent (a base frame plus small noise) and scores are thresholded at
0, so tracks are born and the integers stay away from f32 near-ties."""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixture_gen import make_fixture
from torch_port_fixtures import (
    S,
    TINY,
    jax_pipeline,
    save_npz,
    torch_pipeline,
    write_frames,
)

B, T = 3, 4
INT_KEYS = ("classes", "track_ids", "valid")
SORT_INT_FIELDS = ("alive", "track_id", "hits", "hit_streak", "age",
                   "time_since_update", "next_id", "frame_count")


def coherent_videos(seed, b=B, t=T):
    """``[b, t, S, S, 3]`` f32: each video a base frame plus small
    noise."""
    rs = np.random.RandomState(seed)
    base = rs.randn(b, 1, S, S, 3).astype(np.float32)
    return base + 0.01 * rs.randn(b, t, S, S, 3).astype(np.float32)


def assert_outputs_close(got, want, what=""):
    """Port outputs (tensors) against reference outputs (arrays or
    tensors) at the stated tolerances."""
    assert set(got) == set(want)
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=what + k)
    for k in ("boxes", "visible_boxes"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-3, err_msg=what + k)
    np.testing.assert_allclose(np.asarray(got["scores"]),
                               np.asarray(want["scores"]), atol=1e-5,
                               err_msg=what + "scores")


# The area velocity (px^2 per frame, state index 6) is a difference of
# areas, each carrying the boxes' 1e-3 px tolerance times a side of up
# to ~100 px.
AREA_VELOCITY_ATOL = 0.1


def assert_states_close(got, want, what=""):
    for f in SORT_INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=what + f)
    x, wx = np.asarray(got.x), np.asarray(want.x)
    np.testing.assert_allclose(x[..., :6], wx[..., :6], rtol=1e-4,
                               atol=1e-3, err_msg=what + "x")
    np.testing.assert_allclose(x[..., 6], wx[..., 6], rtol=1e-4,
                               atol=AREA_VELOCITY_ATOL,
                               err_msg=what + "x area velocity")
    np.testing.assert_allclose(np.asarray(got.P), np.asarray(want.P),
                               rtol=1e-4, atol=1e-3, err_msg=what + "P")


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """(JAX pipeline, its perturbed variables, the npz path)."""
    pipe, variables = jax_pipeline(seed=5)
    return pipe, variables, save_npz(tmp_path_factory.mktemp("npz"),
                                     variables)


def test_batched_matches_jax_batched(bridged):
    """Two clip batches of 2 frames, the states threaded: outputs of
    both batches and the final ``[B]``-leading states."""
    pipe, variables, npz = bridged
    tp = torch_pipeline(npz)
    clips = coherent_videos(1)
    run = jax.jit(lambda c, s: pipe.batched(variables, c, sort_states=s,
                                            score_thr=0.0))
    js, ts = None, None
    for half in (slice(0, 2), slice(2, 4)):
        want, js = run(jnp.asarray(clips[:, half]), js)
        got, ts = tp.batched(torch.from_numpy(clips[:, half]), ts,
                             score_thr=0.0)
        assert tuple(got["track_ids"].shape) == (B, 2, TINY["num_dets"])
        assert_outputs_close(got, want)
    assert ts.x.shape == (B, 2 * TINY["num_dets"], 7)
    assert tuple(ts.next_id.shape) == (B,)
    assert_states_close(ts, js)
    assert (ts.next_id > 1).all()


def test_batched_equals_streaming_in_the_port(bridged):
    """B ``streaming`` calls over 2 + 2 frames each, the state threaded,
    against ``batched`` over the same frames: the same outputs and
    states (floats at the stated tolerances: the detector runs 12
    frames a batch instead of 2)."""
    _, _, npz = bridged
    tp = torch_pipeline(npz, sort_assignment="gated_auction")
    clips = torch.from_numpy(coherent_videos(2))
    states = None
    got = []
    for half in (slice(0, 2), slice(2, 4)):
        out, states = tp.batched(clips[:, half], states, score_thr=0.0)
        got.append(out)
    for b in range(B):
        state = tp.init_tracker_state()
        for out, half in zip(got, (slice(0, 2), slice(2, 4))):
            want, state = tp.streaming(clips[b, half], state,
                                       score_thr=0.0)
            assert_outputs_close({k: v[b] for k, v in out.items()}, want,
                                 f"video {b}: ")
        assert_states_close(type(states)(*(f[b] for f in states)), state,
                            f"video {b}: ")
        assert int(state.next_id) > 1


def _streaming_pair(pipe, variables, tp, clips):
    """JAX and port ``streaming`` over ``clips`` with the state
    threaded; asserts every clip's outputs and the final state."""
    run = jax.jit(lambda c, s: pipe.streaming(variables, c, s,
                                              score_thr=0.0))
    js, ts = pipe.init_tracker_state(), tp.init_tracker_state()
    for clip in clips:
        want, js = run(jnp.asarray(clip), js)
        got, ts = tp.streaming(torch.from_numpy(clip), ts, score_thr=0.0)
        assert_outputs_close(got, want)
    assert_states_close(ts, js)
    return got, ts


def test_use_expander_false_matches_jax(bridged):
    """The identity-expander control reports the detector's boxes; the
    same npz loads into it (the expander's weights exist either way)."""
    pipe, variables, npz = bridged
    pipe = pipe._replace(use_expander=False)
    tp = torch_pipeline(npz, use_expander=False)
    assert not tp.use_expander and hasattr(tp.expander, "deltas")
    got, ts = _streaming_pair(pipe, variables, tp, coherent_videos(3)[:2])
    assert torch.equal(got["boxes"], got["visible_boxes"])
    assert int(ts.next_id) > 1


@pytest.mark.parametrize("options", [
    dict(sort_max_age=1, sort_min_hits=3, sort_assignment="auction"),
    dict(sort_max_age=2, sort_min_hits=2,
         sort_assignment="gated_auction", sort_on="amodal"),
])
def test_sort_options_through_create_match_jax(bridged, options):
    """Non-default lifecycle and assignment given to ``create`` reach
    ``streaming``'s SORT, as in JAX."""
    pipe, variables, npz = bridged
    pipe = pipe._replace(**options)
    tp = torch_pipeline(npz, **options)
    for k, v in options.items():
        assert getattr(tp, k) == getattr(pipe, k) == v
    _, ts = _streaming_pair(pipe, variables, tp, coherent_videos(4)[:2])
    assert int(ts.next_id) > 1


def test_pooling_values_compute_one_function(bridged):
    """``pooling`` "auto", "packed" and "fused" give equal outputs (one
    forward per device); an unknown value raises ValueError."""
    _, _, npz = bridged
    clip = torch.from_numpy(coherent_videos(6)[0])
    outs = []
    for pooling in ("auto", "packed", "fused"):
        tp = torch_pipeline(npz, pooling=pooling)
        assert tp.detector.pooling == pooling
        outs.append(tp(clip, score_thr=0.0))
    for out in outs[1:]:
        for k in outs[0]:
            assert torch.equal(out[k], outs[0][k]), k
    with pytest.raises(ValueError, match="pooling"):
        torch_pipeline(npz, pooling="prroi")


@pytest.mark.parametrize("option", [
    dict(dtype=torch.bfloat16),
    dict(stem="s2d"),
    dict(stem="s2d_pre"),
    dict(dtype=torch.bfloat16, stem="s2d_pre", fused_stages=(1, 2, 3, 4)),
])
def test_ported_options_run_on_cpu(option):
    """The bf16 trunk and the s2d stems run on the CPU at the tiny size:
    ``preprocess`` of uint8 4:3 frames, then ``streaming`` and
    ``batched``, with the bench's bf16 scores and f32 boxes in bf16, and
    the s2d_pre clip folded in the detector's dtype.  (What they compute
    is held against JAX in ``tests/test_torch_port_bf16_pipeline.py`` and
    ``tests/test_torch_port_s2d_pipeline.py``.)"""
    from tao_amodal_torch.pipeline import AmodalPipeline

    pipe = AmodalPipeline.create(**TINY, **option, device="cpu").init(
        torch.Generator().manual_seed(0))
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (4, 60, 80, 3), np.uint8))
    clip, _ = pipe.preprocess(frames, out_size=(48, 64))
    dtype = option.get("dtype", torch.float32)
    if option.get("stem") == "s2d_pre":
        assert clip.shape == (4, 12, 16, 48) and clip.dtype == dtype
    out, state = pipe.streaming(clip, pipe.init_tracker_state(),
                                score_thr=0.0)
    assert out["scores"].dtype == dtype
    assert out["boxes"].dtype == torch.float32
    assert out["valid"].any() and int(state.next_id) > 1
    both, _ = pipe.batched(torch.stack([clip, clip]), score_thr=0.0)
    for k in out:
        assert torch.equal(both[k][1], both[k][0]), k


def test_unported_options_raise():
    """The int8 trunk raises NotImplementedError naming its ROADMAP item
    rather than compute f32; an unknown stem or assignment raises
    ValueError."""
    from tao_amodal_torch.pipeline import AmodalPipeline

    with pytest.raises(NotImplementedError, match="Queue A #5"):
        AmodalPipeline.create(**TINY, int8_backbone=True, device="cpu")
    with pytest.raises(ValueError, match="stem"):
        AmodalPipeline.create(**TINY, stem="deep", device="cpu")
    with pytest.raises(ValueError, match="assignment"):
        AmodalPipeline.create(**TINY, sort_assignment="hungarian",
                              device="cpu")


def test_create_takes_every_jax_argument():
    """The port's ``create`` has every parameter of the JAX ``create``,
    in its order, with its default (``dtype`` as the torch float32),
    plus ``device``; ``exact_topk`` is accepted and changes nothing (the
    port's top-k is exact)."""
    from tao_amodal_tpu.pipeline import AmodalPipeline as JaxPipeline
    from tao_amodal_torch.pipeline import AmodalPipeline

    jp = inspect.signature(JaxPipeline.create).parameters
    tp = inspect.signature(AmodalPipeline.create).parameters
    assert list(tp) == list(jp) + ["device"]
    for name, p in jp.items():
        want = torch.float32 if name == "dtype" else p.default
        assert tp[name].default == want, name
    pipe = AmodalPipeline.create(**TINY, exact_topk=True, device="cpu")
    assert pipe.detector.exact_topk


def test_prroi_packed_fused_equals_prroi_packed():
    """JAX's name of kernel B2's route pools as ``"prroi_packed"`` does;
    RoIAlign (``"align"``) is not ported and raises."""
    from tao_amodal_torch.ops.roi import multilevel_roi_align

    rs = np.random.RandomState(8)
    pyramid = [torch.from_numpy(rs.randn(2, n, n, 8).astype(np.float32))
               for n in (16, 8, 4, 2)]
    xy = rs.uniform(0, 100, (2, 6, 2))
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(4, 60, (2, 6, 2))], -1).astype(np.float32))
    kw = dict(canonical_level=1, strides=(8, 16, 32, 64))
    want = multilevel_roi_align(pyramid, rois, method="prroi_packed", **kw)
    got = multilevel_roi_align(pyramid, rois, method="prroi_packed_fused",
                               **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="method"):
        multilevel_roi_align(pyramid, rois, method="align", **kw)


@pytest.mark.parametrize("assignment", ["gated_auction", "auction"])
def test_cli_assignment_records_match_jax_cli(tmp_path, assignment):
    """Both CLIs with ``--assignment`` on one annotation (2 videos x 6
    frames at 80x60: a 0.8 letterbox and a zero-padded last clip) and
    one npz, the pattern of ``test_cli_records_match_jax_cli``: records,
    ids, categories and track ids equal; bbox rtol 1e-4 + atol 2e-3 px
    (divided by the 0.8 scale), score atol 1e-5."""
    from tao_amodal_tpu.cli.infer_cli import main as jax_main
    from tao_amodal_torch.cli.infer_cli import main as torch_main

    gt, _ = make_fixture(seed=13, num_videos=2, frames_per_video=6,
                         num_cats=TINY["num_classes"], img_size=(80, 60))
    ann = tmp_path / "gt.json"
    ann.write_text(json.dumps(gt))
    images_dir = tmp_path / "frames"
    write_frames(images_dir, gt, video_id=1, seed=6)
    _, variables = jax_pipeline(seed=3)
    npz = save_npz(tmp_path, variables)
    common = ["--annotation", str(ann), "--images_dir", str(images_dir),
              "--checkpoint", npz, "--input_size", str(S),
              "--clip_len", str(T), "--score_threshold", "0.0",
              "--backbone_stages", "1,1,1,1",
              "--num_dets", str(TINY["num_dets"]),
              "--num_proposals", str(TINY["num_proposals"]),
              "--assignment", assignment]
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
