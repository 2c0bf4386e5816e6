"""The port's detector path held against the JAX package on the CPU:
weight bridge, trunk + FPN, anchors and proposals, NMS, and the whole
``ClipDetector.apply`` output dict, on shared (bridged) weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (
    jax_pipeline,
    random_clip,
    save_npz,
    torch_pipeline,
)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    pipe, variables = jax_pipeline(seed=0)
    npz = save_npz(tmp_path_factory.mktemp("w"), variables)
    return pipe, variables, torch_pipeline(npz)


def test_weight_bridge_maps_every_tensor(bridged):
    """Every JAX leaf lands in the torch module with the layout change
    the bridge promises (HWIO -> OIHW, Dense [in,out] -> [out,in], BN
    scale/stats -> weight/running stats); nothing is left unset."""
    from tao_amodal_tpu.utils.checkpoint import flatten

    _, variables, tp = bridged
    flat = flatten(variables)
    sd = tp.state_dict()
    assert len([k for k in sd if "num_batches" not in k]) == len(flat)
    k = "detector/params/backbone/Bottleneck_0/ConvBN_1/Conv_0/kernel"
    np.testing.assert_array_equal(
        sd["detector.backbone.Bottleneck_0.ConvBN_1.Conv_0.weight"].numpy(),
        flat[k].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["detector.box_head.Dense_0.weight"].numpy(),
        flat["detector/params/box_head/Dense_0/kernel"].T)
    np.testing.assert_array_equal(
        sd["detector.backbone.ConvBN_0.BatchNorm_0.running_var"].numpy(),
        flat["detector/batch_stats/backbone/ConvBN_0/BatchNorm_0/var"])
    # Zero-initialised layers: the expander deltas were perturbed, so the
    # expander parity below does not compare two identities.
    assert np.abs(sd["expander.deltas.weight"].numpy()).max() > 0


def test_weight_bridge_rejects_mismatched_checkpoint(bridged, tmp_path):
    from tao_amodal_torch.pipeline import AmodalPipeline

    _, variables, _ = bridged
    npz = save_npz(tmp_path, variables)
    wrong = AmodalPipeline.create(num_classes=3, num_dets=8,
                                  num_proposals=16,
                                  backbone_stages=(1, 1, 1, 1),
                                  device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        wrong.load(npz)


def test_features_match_jax(bridged):
    """Trunk + FPN (P3..P7).  Padding (symmetric ConvBN pads,
    -inf max-pool pad, stride on the 3x3, SAME post/tower, explicit
    (1,1) extra convs) and the broadcast nearest upsampling show
    here.  Tolerance atol 2e-4 / rtol 1e-4: f32 convolutions in another
    summation order, activations O(10)."""
    pipe, variables, tp = bridged
    clip = random_clip(1)
    want = pipe.detector.apply(variables["detector"], jnp.asarray(clip),
                               method=pipe.detector.features_for)
    with torch.no_grad():
        got = tp.detector.fpn(tp.detector.backbone(
            torch.from_numpy(clip).permute(0, 3, 1, 2)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=2e-4)


def test_upsample_non_integer_matches_jax_resize():
    """FPN fallback for non-integer factors == jax.image.resize nearest
    (exact: a pure gather)."""
    from tao_amodal_torch.models.fpn import upsample_nearest

    lo = np.random.RandomState(0).randn(1, 7, 5, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(lo), (1, 13, 9, 3), "nearest")
    got = upsample_nearest(torch.from_numpy(lo).permute(0, 3, 1, 2),
                           (13, 9)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_anchors_and_decode_match_jax():
    """Anchor (y, x, anchor) order, exact; the 4.135 delta clamp to
    rtol 2e-6 (XLA's and PyTorch's exp differ in the last ulp)."""
    from tao_amodal_tpu.models import rpn as jrpn
    from tao_amodal_torch.models import rpn as trpn

    a_j = jrpn.level_anchors(3, 5, 16, [64], (0.5, 1.0, 2.0))
    a_t = trpn.level_anchors(3, 5, 16, [64], (0.5, 1.0, 2.0),
                             device="cpu")
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    d = np.random.RandomState(2).randn(45, 4).astype(np.float32) * 3
    np.testing.assert_allclose(
        trpn.decode_deltas(a_t, torch.from_numpy(d)).numpy(),
        np.asarray(jrpn.decode_deltas(a_j, jnp.asarray(d))), rtol=2e-6)


def _random_boxes(rs, n, span=100.0):
    xy = rs.uniform(0, span, (n, 2))
    wh = rs.uniform(5, 40, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_jax(seed):
    """Keep masks and -1-padded keep lists, exact (the eager
    fixpoint loop must reach the same fixpoint).  Quantized scores make
    ties, so the (score desc, index asc) rank order is exercised."""
    from tao_amodal_tpu.ops import nms as jnms
    from tao_amodal_torch.ops import nms as tnms

    rs = np.random.RandomState(seed)
    boxes = _random_boxes(rs, 60, span=60.0)
    scores = (rs.randint(0, 10, 60) / 10).astype(np.float32)
    classes = rs.randint(0, 3, 60)
    bj, sj = jnp.asarray(boxes), jnp.asarray(scores)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    np.testing.assert_array_equal(
        tnms.nms_keep_mask(bt, st, 0.5).numpy(),
        np.asarray(jnms.nms_keep_mask(bj, sj, 0.5)))
    np.testing.assert_array_equal(
        tnms.batched_nms(bt, st, 0.5, 40).numpy(),
        np.asarray(jnms.batched_nms(bj, sj, 0.5, 40)))
    np.testing.assert_array_equal(
        tnms.class_aware_nms(bt, st, torch.from_numpy(classes), 0.5,
                             40).numpy(),
        np.asarray(jnms.class_aware_nms(bj, sj, jnp.asarray(classes), 0.5,
                                        40)))
    # Batched over frames == frame by frame.
    batch = tnms.batched_nms(torch.stack([bt, bt.flip(0)]),
                             torch.stack([st, st.flip(0)]), 0.5, 40)
    np.testing.assert_array_equal(batch[1].numpy(),
                                  tnms.batched_nms(bt.flip(0), st.flip(0),
                                                   0.5, 40).numpy())


def test_nms_deep_chain_runs_past_the_first_block():
    """A suppression chain deeper than the 8 unrolled rounds: the host
    convergence check must keep iterating to the exact fixpoint."""
    from tao_amodal_tpu.ops import nms as jnms
    from tao_amodal_torch.ops import nms as tnms

    n = 30
    x = np.arange(n, dtype=np.float32) * 3.0
    boxes = np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)], 1)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    got = tnms.nms_keep_mask(torch.from_numpy(boxes.astype(np.float32)),
                             torch.from_numpy(scores), 0.5)
    want = jnms.nms_keep_mask(jnp.asarray(boxes, jnp.float32),
                              jnp.asarray(scores), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_clip_detector_matches_jax(bridged):
    """The whole ``ClipDetector.apply`` output dict on shared weights.

    Covers f32 throughout (TF32 is a CUDA-only setting), the box-head
    flatten order (NHWC pooled features flatten in Flax's order, so
    Dense_0 needs no permutation), the NHWC score/anchor order, exact
    stable top-k with k = min(pre_nms_topk, H*W*A), and -1 keep slots
    wrapping to the last candidate.  Integer outputs exact.  Boxes rtol 1e-4 + atol 1e-3 px
    (boxes reach ~300 px through exp-decoded deltas), scores atol 1e-5,
    features rtol/atol 1e-4 (values O(10)): f32 in another summation
    order through the trunk (measured <= 1.3e-3 px, 2.2e-6, 6e-5), far
    below the gaps that decide top-k and NMS."""
    pipe, variables, tp = bridged
    clip = random_clip(3)
    want = jax.jit(pipe.detector.apply)(variables["detector"],
                                        jnp.asarray(clip))
    with torch.no_grad():
        got = tp.detector(torch.from_numpy(clip))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["roi_features"].numpy(),
                               np.asarray(want["roi_features"]),
                               rtol=1e-4, atol=1e-4)
    assert (got["classes"] >= 0).any()
