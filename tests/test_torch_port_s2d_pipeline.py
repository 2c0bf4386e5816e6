"""The space-to-depth stems in f32 through the port's pipeline, and the
weight bridge of an ``s2d_pre`` checkpoint, held against the JAX package
on the CPU at 4:3 frames.

uint8 frames of a coherent 60x80 video (a base image plus small noise)
are letterboxed to (48, 64) by ``preprocess`` -- for ``s2d_pre`` folded
to ``[T, 12, 16, 48]``, for ``s2d`` left ``[T, 48, 64, 3]`` for the trunk
to fold -- and run through ``streaming`` (two clips of 4 frames, the
SORT state threaded) and, for ``s2d_pre``, ``batched`` over two videos.
Tolerances are the port's f32 ones (``tests/test_torch_port_batched.py``):
integers (classes, track ids, valid) exact; boxes rtol 1e-4 + atol 1e-3
px and scores atol 1e-5 (f32 through the trunk in another summation
order).  Scores are thresholded at 0, so tracks are born.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import jax_pipeline, save_npz, torch_pipeline

T, HW, OUT = 4, (60, 80), (48, 64)


def frames_of(seed, b=2, clips=2):
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 256, (b, 1, *HW, 3))
    noise = rs.randint(-3, 4, (b, clips * T, *HW, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def assert_f32_close(got, want, what=""):
    for k in ("classes", "track_ids", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=what + k)
    for k in ("boxes", "visible_boxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-3, err_msg=what + k)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5,
                               err_msg=what + "scores")


@pytest.mark.parametrize("stem", ["s2d_pre", "s2d"])
def test_f32_s2d_stems_match_jax(stem, tmp_path):
    """``create(stem=...)`` in f32: ``preprocess`` then ``streaming``
    over two clips per video, and for ``s2d_pre`` ``batched`` over both
    videos, against JAX's ``streaming``; the letterbox geometry is
    non-square, and ``image_hw_of`` unfolds the s2d_pre clip."""
    pipe, variables = jax_pipeline(seed=2, stem=stem)
    tp = torch_pipeline(save_npz(tmp_path, variables), stem=stem)
    run = jax.jit(lambda c, s: pipe.streaming(variables, c, s,
                                              score_thr=0.0))
    frames = frames_of(8)
    want = []
    for v in range(frames.shape[0]):
        js, ts = pipe.init_tracker_state(), tp.init_tracker_state()
        want.append([])
        for c in range(2):
            raw = frames[v, c * T:(c + 1) * T]
            jclip, jscale = pipe.preprocess(jnp.asarray(raw), out_size=OUT)
            clip, scale = tp.preprocess(torch.from_numpy(raw), out_size=OUT)
            assert scale == jscale and clip.dtype == torch.float32
            np.testing.assert_allclose(clip.numpy(), np.asarray(jclip),
                                       atol=1e-5)
            assert tp.detector.image_hw_of(clip) == (48, 64)
            w, js = run(jclip, js)
            got, ts = tp.streaming(clip, ts, score_thr=0.0)
            assert_f32_close(got, w, f"{stem} video {v} clip {c} ")
            want[-1].append(w)
        assert int(ts.next_id) == int(js.next_id) > 1
    if stem != "s2d_pre":
        return
    states = None
    for c in range(2):
        clips = torch.stack([tp.preprocess(torch.from_numpy(
            frames[v, c * T:(c + 1) * T]), out_size=OUT)[0]
            for v in range(frames.shape[0])])
        out, states = tp.batched(clips, states, score_thr=0.0)
        for v in range(frames.shape[0]):
            assert_f32_close({k: x[v] for k, x in out.items()}, want[v][c],
                             f"batched video {v} clip {c} ")


def test_s2d_pre_weight_bridge(tmp_path):
    """A JAX pipeline initialised with ``stem="s2d_pre"`` goes through
    ``save_pytree`` -> npz -> ``AmodalPipeline.load``: the stem's
    ``[3, 3, 48, 64]`` HWIO kernel lands as the OIHW ``[64, 48, 3, 3]``
    conv weight; in f32 the detector's outputs match JAX's at the f32
    tolerances, in bf16 the stem's output on the preprocessed clip
    matches JAX's bf16 stem within B8's rule (max |d| <= 1e-2 max|ref|,
    mean |d| <= 1e-3 mean|ref|; the whole bf16 slice on bridged weights
    is ``tests/test_torch_port_bf16_pipeline.py``).  The bf16 copies of
    the f32 weights are made once and kept until a load writes the
    weights."""
    from tao_amodal_tpu.models.backbones import ConvBN as JConvBN
    from tao_amodal_torch.utils import weights

    frames = frames_of(9, b=1, clips=1)[0]
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        pipe, variables = jax_pipeline(seed=5, stem="s2d_pre", dtype=jdt)
        npz = save_npz(tmp_path, variables, f"{jdt.__name__}.npz")
        kernel = variables["detector"]["params"]["backbone"]["ConvBN_0"][
            "Conv_0"]["kernel"]
        assert kernel.shape == (3, 3, 48, 64)
        tp = torch_pipeline(npz, stem="s2d_pre", dtype=dtype)
        conv = tp.detector.backbone.ConvBN_0.Conv_0
        assert conv.weight.dtype == torch.float32
        np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                      kernel.transpose(3, 2, 0, 1))
        jclip, _ = pipe.preprocess(jnp.asarray(frames), out_size=OUT)
        clip, _ = tp.preprocess(torch.from_numpy(frames), out_size=OUT)
        det = pipe.detector
        if dtype == torch.float32:
            want = jax.jit(det.apply)(variables["detector"], jclip)
            with torch.no_grad():
                got = tp.detector(clip)
            for k in ("boxes", "scores", "roi_features"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-4,
                                           atol=1e-3, err_msg=k)
            np.testing.assert_array_equal(got["classes"].numpy(),
                                          np.asarray(want["classes"]))
            continue
        # Inference casts (without grad) share one cached copy; under
        # grad the cast is recorded instead (the training path).
        with torch.no_grad():
            copy = weights.cast(conv.weight, torch.bfloat16)
            assert weights.cast(conv.weight, torch.bfloat16) is copy
        backbone = {c: variables["detector"][c]["backbone"]["ConvBN_0"]
                    for c in ("params", "batch_stats")}
        want = np.asarray(jnp.asarray(JConvBN(64, (3, 3), dtype=jdt).apply(
            backbone, jclip), jnp.float32))
        with torch.no_grad():
            got = tp.detector.backbone.ConvBN_0(clip.permute(0, 3, 1, 2))
        assert got.dtype == torch.bfloat16
        d = np.abs(got.permute(0, 2, 3, 1).float().numpy() - want)
        assert d.max() <= 1e-2 * np.abs(want).max()
        assert d.mean() <= 1e-3 * np.abs(want).mean()
        # A load writes the weights in place: the next cast rounds anew.
        tp.load(npz)
        with torch.no_grad():
            assert weights.cast(conv.weight, torch.bfloat16) is not copy
