"""The port's fused-trunk configuration held against the JAX package on
the CPU: ``fold_convbn``, the fused bottleneck chain (on the CPU its
wrapper takes the plain version), ``ResNet(fused_stages=...)`` and the
``--fused_stages`` CLI.

The JAX side runs through ``bottleneck_chain_reference`` or unfused:
its fused path would run the Pallas kernel in interpret mode here.  The
JAX package's own tests pin its fused path equal to its unfused one.
The kernel itself (B4) is held against the plain version on the card by
``test_torch_port_isolation.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fixture_gen import make_fixture
from tao_amodal_tpu.models.backbones import ResNet as JaxResNet
from tao_amodal_tpu.ops.pallas import fused_stage as jfs
from tao_amodal_torch.models import backbones as tbb
from tao_amodal_torch.ops import fused_stage as tfs
from tao_amodal_torch.utils import weights
from torch_port_fixtures import (
    S,
    T,
    TINY,
    jax_pipeline,
    perturb,
    save_npz,
    write_frames,
)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def test_fold_convbn_matches_jax():
    """3x3 and 1x1 kernels with non-trivial BN statistics; the fold is
    three elementwise f32 ops on each side."""
    rs = np.random.RandomState(0)
    for k in (1, 3):
        w = rs.randn(k, k, 16, 24).astype(np.float32)
        scale, bias, mean = (rs.randn(24).astype(np.float32)
                             for _ in range(3))
        var = rs.uniform(0.5, 1.5, 24).astype(np.float32)
        jw, jb = jfs.fold_convbn(jnp.asarray(w), scale, bias, mean, var)
        tw, tb = tfs.fold_convbn(_oihw(w), *(torch.from_numpy(v) for v in
                                             (scale, bias, mean, var)))
        assert tw.dtype == tb.dtype == torch.float32
        np.testing.assert_allclose(tw.numpy(), _oihw(np.asarray(jw)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-6)


def _block(rs, cin, m, ds):
    """One folded block, HWIO as the JAX chain takes it."""
    p = dict(wa=rs.randn(1, 1, cin, m) * 0.2, ba=rs.randn(m) * 0.1,
             w3=rs.randn(3, 3, m, m) * 0.1, b3=rs.randn(m) * 0.1,
             wb=rs.randn(1, 1, m, 4 * m) * 0.1, bb=rs.randn(4 * m) * 0.1)
    if ds:
        p.update(wd=rs.randn(1, 1, cin, 4 * m) * 0.2,
                 bd=rs.randn(4 * m) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _torch_params(params):
    return [{k: _oihw(v) if v.ndim == 4 else torch.from_numpy(v)
             for k, v in p.items()} for p in params]


@pytest.mark.parametrize("projection", [True, False])
@pytest.mark.parametrize("nblocks", [1, 2, 3])
def test_chain_matches_jax_reference(nblocks, projection):
    """1-3 blocks, with and without the block-0 projection (without it
    the chain enters at 4M channels).  Frame-edge SAME padding of every
    3x3 shows here: biases make conv(0) + b != 0.  rtol/atol 1e-4: f32
    convolutions in another summation order, outputs O(1)."""
    rs = np.random.RandomState(10 * nblocks + projection)
    M = 8
    cin = 16 if projection else 4 * M
    params = [_block(rs, cin, M, projection)] + [
        _block(rs, 4 * M, M, False) for _ in range(nblocks - 1)]
    x = rs.randn(2, 12, 10, cin).astype(np.float32)
    want = jfs.bottleneck_chain_reference(jnp.asarray(x), params)
    before = tfs.fused_bottleneck_chain.launches
    got = tfs.fused_bottleneck_chain(torch.from_numpy(x),
                                     _torch_params(params))
    assert tfs.fused_bottleneck_chain.launches == before
    assert got.shape == (2, 12, 10, 4 * M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_resnet_fused_stages_match_jax():
    """Port ``ResNet(stage_sizes=(2, 3, 3, 3), fused_stages=(1, 2, 3,
    4))`` (classic stem; every stage's chain has >= 2 blocks, stage 1
    with its projection, stages 2-4 behind their strided block) against
    the unfused JAX ``ResNet`` on the same weights with perturbed BN
    statistics.  rtol/atol 2e-4, the JAX package's own fused-vs-unfused
    tolerance (tests/test_fused_stage.py)."""
    stages = (2, 3, 3, 3)
    rs = np.random.RandomState(3)
    x = rs.randn(2, S, S, 3).astype(np.float32)
    jnet = JaxResNet(stage_sizes=stages)
    variables = perturb(jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(x)), rs)
    want = jnet.apply(variables, jnp.asarray(x))

    flat = {}
    for col, tree in variables.items():
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            path = "/".join(p.key for p in k)
            flat[f"backbone/{col}/{path}"] = np.asarray(v)
    holder = nn.Module()
    holder.backbone = tbb.ResNet(stage_sizes=stages,
                                 fused_stages=(1, 2, 3, 4))
    weights.load_into(holder, flat)
    net = holder.backbone.eval()

    seen = []
    orig = tfs.bottleneck_chain_torch

    def spy(inp, params):
        seen.append((inp.shape[-1], len(params), "wd" in params[0],
                     inp.is_contiguous()))
        return orig(inp, params)

    tfs.bottleneck_chain_torch = spy
    try:
        with torch.no_grad():
            got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    finally:
        tfs.bottleneck_chain_torch = orig
    # Stage 1 whole with its 64 -> 256 projection; stages 2-4 their
    # stride-1 tails; each NHWC view read in place (channels-last).
    assert seen == [(64, 2, True, True), (512, 2, False, True),
                    (1024, 2, False, True), (2048, 2, False, True)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=2e-4, atol=2e-4)


def test_resnet_training_mode_never_fuses():
    """Training mode runs unfused.  At inference with stage sizes
    (2, 2, 2, 2) only stage 1 fuses: the stride-1 tails of stages 2-4
    are one block each, and a chain needs at least 2."""
    net = tbb.ResNet(stage_sizes=(2, 2, 2, 2), fused_stages=(1, 2, 3, 4))
    calls = []
    orig = tfs.fused_bottleneck_chain
    tbb.fused_bottleneck_chain = lambda *a: calls.append(1) or orig(*a)
    try:
        x = torch.randn(2, 3, 32, 32)
        net.train()(x)
        assert calls == []
        with torch.no_grad():
            net.eval()(x)
        assert len(calls) == 1
    finally:
        tbb.fused_bottleneck_chain = orig


def test_cli_fused_stages_match_jax_cli(tmp_path):
    """The port CLI with ``--fused_stages 1,2,3,4 --backbone_stages
    2,3,3,3`` against the JAX CLI with the same flags unfused, on one
    npz and annotation (2 videos x 5 frames at 80x60; video 1 with frame
    files, video 2 gray).  Records equal; bbox rtol 1e-4 + atol 2e-3 px
    and score atol 1e-5, as for the unfused CLIs."""
    from tao_amodal_tpu.cli.infer_cli import main as jax_main
    from tao_amodal_torch.cli.infer_cli import main as torch_main

    stages = (2, 3, 3, 3)
    gt, _ = make_fixture(seed=13, num_videos=2, frames_per_video=5,
                         num_cats=TINY["num_classes"], img_size=(80, 60))
    ann = tmp_path / "gt.json"
    ann.write_text(json.dumps(gt))
    images_dir = tmp_path / "frames"
    write_frames(images_dir, gt, video_id=1, seed=5)
    _, variables = jax_pipeline(seed=3, backbone_stages=stages)
    npz = save_npz(tmp_path, variables)
    common = ["--annotation", str(ann), "--images_dir", str(images_dir),
              "--checkpoint", npz, "--input_size", str(S),
              "--clip_len", str(T), "--score_threshold", "0.0",
              "--backbone_stages", ",".join(map(str, stages)),
              "--num_dets", str(TINY["num_dets"]),
              "--num_proposals", str(TINY["num_proposals"])]
    want = jax_main(common + ["--output", str(tmp_path / "jax.json")])
    got = torch_main(common + ["--output", str(tmp_path / "torch.json"),
                               "--device", "cpu",
                               "--fused_stages", "1,2,3,4"])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("image_id", "category_id", "track_id", "video_id"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5)
