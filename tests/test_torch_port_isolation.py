"""Isolation of the PyTorch port, and its CUDA kernels against their
plain versions.

This file imports neither jax nor the JAX package, so its CUDA tests run
on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_isolation.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports jax).
Tests marked ``cuda`` skip where no CUDA device is present.
"""

import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_port_fixtures import (
    PREPROC_ODD,
    chain_inputs,
    coherent_scene,
    greedy_fixpoint,
    resnet50_chain_convs,
    sort_rounds,
    stack_arrays,
    tie_scene,
    torch_stack,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tao_amodal_torch")


def test_every_module_imports_without_jax_flax_pil():
    """With jax, flax and PIL blocked on sys.meta_path (the port depends
    on none of them; the card's machine has no flax), every module of
    the port imports."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL",
                                          "tao_amodal_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import tao_amodal_torch
        names = [m.name for m in pkgutil.walk_packages(
            tao_amodal_torch.__path__, "tao_amodal_torch.")]
        for name in names:
            importlib.import_module(name)
        # The CLI's gray fallback for missing frames needs no PIL.
        from tao_amodal_torch.cli.infer_cli import load_clip
        clip = load_clip([{"file_name": "missing.jpg"}] * 2,
                         "/nonexistent", (4, 6))
        assert clip.shape == (2, 4, 6, 3) and (clip == 128).all()
        # Multi-video serving and the Sort wrapper run (on the CPU).
        import torch
        from tao_amodal_torch.pipeline import AmodalPipeline
        from tao_amodal_torch.trackers.sort import Sort
        pipe = AmodalPipeline.create(
            num_classes=3, num_dets=4, num_proposals=8,
            backbone_stages=(1, 1, 1, 1), sort_assignment="auction",
            device="cpu").init(torch.Generator().manual_seed(0))
        out, states = pipe.batched(torch.zeros(2, 2, 32, 32, 3),
                                   score_thr=0.0)
        assert out["track_ids"].shape == (2, 2, 4)
        assert states.next_id.shape == (2,)
        tracker = Sort(device="cpu")
        assert tracker.update([[0, 0, 10, 10, 0.9]]).shape == (1, 5)
        assert not any(m.split(".")[0] in ("jax", "flax", "PIL")
                       for m in sys.modules)
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_sources_never_import_jax_or_flax():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax",
                                                 "import flax",
                                                 "from flax")), (f, s)


def _preproc_inputs(device, T=2, H=48, W=64, S=64, seed=0):
    frames = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 255, (T, H, W, 3), np.uint8)).to(device)
    return frames, S, (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


def _prroi_inputs(device, T=2, Hc=16, Wc=26, C=32, R=5, seed=0):
    rs = np.random.RandomState(seed)
    canvas = torch.from_numpy(
        rs.randn(T, Hc, Wc, C).astype(np.float32)).to(device)
    xy = rs.uniform(-2, min(Hc, Wc) - 4, (T, R, 2))
    wh = rs.uniform(0.5, 12, (T, R, 2))
    rois = torch.from_numpy(
        np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(device)
    return canvas, rois


def _scene(device, clips=6, T=8, D=64, objects=40, seed=0):
    """``clips`` consecutive [T, D] clips of one coherent scene."""
    boxes, valid = coherent_scene(seed, frames=clips * T, objects=objects,
                                  D=D, extent=600)
    return [(torch.from_numpy(boxes[i:i + T]).to(device),
             torch.from_numpy(valid[i:i + T]).to(device))
            for i in range(0, clips * T, T)]


def test_wrappers_take_plain_path_on_cpu():
    """CPU tensors go to the plain versions; the launch counters, which
    count kernel launches only, stay at 0."""
    from tao_amodal_torch.ops import fused_stage, prroi, preproc, sort_scan
    from tao_amodal_torch.trackers.sort import init_sort

    counters = (preproc.preprocess_frames, prroi.prroi_packed,
                fused_stage.fused_bottleneck_chain,
                sort_scan.sort_scan_pallas)
    before = tuple(f.launches for f in counters)
    args = _preproc_inputs("cpu")
    torch.testing.assert_close(preproc.preprocess_frames(*args),
                               preproc.preprocess_frames_torch(*args),
                               rtol=0, atol=0)
    canvas, rois = _prroi_inputs("cpu")
    torch.testing.assert_close(prroi.prroi_packed(canvas, rois),
                               prroi.prroi_packed_torch(canvas, rois),
                               rtol=0, atol=0)
    x, params = chain_inputs("cpu", (2, 9, 13, 16), 8, 2, True)
    torch.testing.assert_close(
        fused_stage.fused_bottleneck_chain(x, params),
        fused_stage.bottleneck_chain_torch(x, params), rtol=0, atol=0)
    (boxes, valid), = _scene("cpu", clips=1, T=4, D=8, objects=5)
    got = sort_scan.sort_scan_pallas(init_sort(16, "cpu"), boxes, valid)
    want = sort_scan.sort_scan_torch(init_sort(16, "cpu"), boxes, valid)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tuple(f.launches for f in counters) == before == (0, 0, 0, 0)


def test_streaming_runs_with_tf32_off_and_restores_it():
    """TF32: cuDNN convolutions default to TF32 in PyTorch.  The
    pipeline's serving default is full f32: ``streaming`` turns TF32 off
    for convolutions and matmuls while it runs, and restores the
    caller's settings after."""
    from tao_amodal_torch.pipeline import AmodalPipeline

    pipe = AmodalPipeline.create(num_classes=3, num_dets=4,
                                 num_proposals=8,
                                 backbone_stages=(1, 1, 1, 1), device="cpu")
    pipe.init(torch.Generator().manual_seed(0))
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = []
    pipe.detector.register_forward_pre_hook(
        lambda m, a: seen.append(tuple(f.allow_tf32 for f in flags)))
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        pipe.streaming(torch.zeros(2, 64, 64, 3), pipe.init_tracker_state())
        assert seen == [(False, False)]
        assert tuple(f.allow_tf32 for f in flags) == (True, True)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_detector_runs_with_tf32_off_and_restores_it():
    """A caller of the detector alone (not through ``streaming``) gets
    the f32 function too: ``ClipDetector.forward`` turns TF32 off for
    convolutions and matmuls while it runs and restores the caller's
    settings after."""
    from tao_amodal_torch.pipeline import AmodalPipeline

    pipe = AmodalPipeline.create(num_classes=3, num_dets=4,
                                 num_proposals=8,
                                 backbone_stages=(1, 1, 1, 1), device="cpu")
    pipe.init(torch.Generator().manual_seed(0))
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = []
    pipe.detector.backbone.register_forward_pre_hook(
        lambda m, a: seen.append(tuple(f.allow_tf32 for f in flags)))
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        with torch.no_grad():
            out = pipe.detector(torch.zeros(2, 64, 64, 3))
        assert seen == [(False, False)]
        assert tuple(f.allow_tf32 for f in flags) == (True, True)
        assert out["boxes"].shape == (2, 4, 4)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def _tie_rich_benefit(rs, n, m, gate):
    """IoU-like payoffs on a few levels: many exact zeros, values exactly
    at ``gate``, ties, NEG entries and whole NEG rows and columns."""
    from tao_amodal_torch.ops.hungarian import NEG

    levels = np.array([0, 0, 0, 0.1, gate, gate, 0.5, 0.7, 0.7, 1.0],
                      np.float32)
    b = levels[rs.randint(0, len(levels), (n, m))]
    b[rs.rand(n, m) < 0.2] = NEG
    b[rs.rand(n) < 0.1] = NEG
    b[:, rs.rand(m) < 0.1] = NEG
    return b


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gated_greedy_keeps_the_matches_above_the_gate(seed):
    """B3 sets every benefit below ``iou_threshold`` to NEG before the
    greedy rounds.  On tie-rich matrices (D != K, ties, values exactly at
    the gate, zeros, NEG rows and columns) the gated fixpoint yields
    exactly the matches at or above the gate of the port's ungated
    ``greedy_assign``, and never takes more rounds."""
    from tao_amodal_torch.ops.hungarian import greedy_assign

    rs = np.random.RandomState(seed)
    gate = np.float32(0.3)
    fewer = 0
    for _ in range(100):
        n, m = rs.randint(1, 40), rs.randint(1, 70)
        b = _tie_rich_benefit(rs, n, m, gate)
        want = greedy_assign(torch.from_numpy(b)).numpy()
        ungated, r_ungated = greedy_fixpoint(b)
        np.testing.assert_array_equal(ungated, want)
        kept = np.array([c >= 0 and b[d, c] >= gate
                         for d, c in enumerate(want)])
        gated, r_gated = greedy_fixpoint(b, gate)
        np.testing.assert_array_equal(gated, np.where(kept, want, -1))
        assert r_gated <= r_ungated
        fewer += r_gated < r_ungated
    assert fewer > 0


def _tie_clips(device, seed=0):
    return [(torch.from_numpy(b).to(device), torch.from_numpy(v).to(device))
            for b, v in tie_scene(seed)]


@pytest.mark.parametrize("max_age,min_hits", [(5, 1), (1, 3)])
def test_gated_sort_loop_equals_plain_loop_on_a_tie_rich_scene(
        max_age, min_hits, monkeypatch):
    """The gate B3 applies before the greedy rounds, put into the plain
    loop: on a scene of 64 valid detections a frame with hundreds of
    IoUs exactly at the gate, ties and full slots, the gated loop gives
    every integer output of the ungated one, threaded over 3 clips, in
    a few rounds a frame where the ungated loop takes up to 24."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.ops.hungarian import NEG, greedy_assign
    from tao_amodal_torch.trackers import sort
    from tao_amodal_torch.trackers.sort import init_sort

    clips = _tie_clips("cpu")
    kw = dict(max_age=max_age, min_hits=min_hits)

    def run():
        state, outs = init_sort(128, "cpu"), []
        for boxes, valid in clips:
            state, out = sort_scan.sort_scan(state, boxes, valid, **kw)
            outs.append(out)
        return state, outs

    want_s, want = run()
    monkeypatch.setattr(sort, "greedy_assign", lambda b: greedy_assign(
        torch.where(b >= 0.3, b, NEG)))
    got_s, got = run()
    for (gi, gr), (wi, wr) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gr, wr)
    for f in ("alive", "track_id", "hits", "hit_streak", "age",
              "time_since_update", "next_id", "frame_count"):
        assert torch.equal(getattr(got_s, f), getattr(want_s, f)), f
    monkeypatch.undo()
    rounds = np.array(sort_rounds(init_sort(128, "cpu"), clips, **kw))
    assert rounds[:, 0].max() >= 10 and rounds[:, 1].max() <= 4


def test_sort_rounds_counts_the_plain_loop():
    """The host count of greedy rounds behind B3's latency bound: one
    (ungated, gated) pair per frame, gated never more, and the plain
    loop's outputs unchanged by the counting."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.trackers.sort import init_sort

    clips = _scene("cpu", clips=2, T=4, D=16, objects=10)
    rounds = sort_rounds(init_sort(32, "cpu"), clips, max_age=5,
                         min_hits=1)
    assert len(rounds) == 8
    assert all(0 <= g <= u for u, g in rounds)
    assert sum(g for _, g in rounds) > 0
    state = init_sort(32, "cpu")
    for boxes, valid in clips:
        state, _ = sort_scan.sort_scan(state, boxes, valid, max_age=5,
                                       min_hits=1)
    assert int(state.next_id) > 1


@pytest.mark.parametrize("hw,S", [((480, 640), 512), ((640, 480), 512),
                                  ((45, 61), 64), ((33, 50), 61)])
def test_preproc_content_extent_holds_every_nonzero_weight(hw, S):
    """B1 writes the letterbox pad outside the content extent without
    reading a frame: every output row and column with a nonzero weight
    lies inside it, and landscape frames pad rows, portrait columns."""
    from tao_amodal_torch.ops import preproc

    wy, wx, scale = preproc.make_letterbox_weights(hw, S)
    for w, n_src in ((wy, hw[0]), (wx, hw[1])):
        lo, hi = preproc.content_extent(preproc.resize_taps(w)[1])
        nz = np.flatnonzero((w != 0).any(axis=1))
        assert (lo, hi) == (nz[0], nz[-1] + 1)
        # Output o samples source (o + 0.5) / scale - 0.5 <= n_src - 0.5.
        assert lo == 0 and hi == min(S, int(n_src * scale - 0.5) + 1)
    ylo, yhi = preproc.content_extent(preproc.resize_taps(wy)[1])
    xlo, xhi = preproc.content_extent(preproc.resize_taps(wx)[1])
    assert (yhi < S) == (hw[0] < hw[1]) and (xhi < S) == (hw[0] > hw[1])


def test_wrappers_reject_other_devices():
    from tao_amodal_torch.ops import fused_stage, prroi, preproc, sort_scan
    from tao_amodal_torch.trackers.sort import init_sort

    frames, S, mean, std = _preproc_inputs("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        preproc.preprocess_frames(frames.to("meta"), S, mean, std)
    canvas, rois = _prroi_inputs("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        prroi.prroi_packed(canvas.to("meta"), rois.to("meta"))
    x, params = chain_inputs("cpu", (2, 9, 13, 16), 8, 2, True)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_stage.fused_bottleneck_chain(x.to("meta"), params)
    (boxes, valid), = _scene("cpu", clips=1, T=3, D=4, objects=2)
    state = init_sort(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sort_scan.sort_scan_pallas(state, boxes.to("meta"),
                                   valid.to("meta"))


def test_prroi_variant_and_stack_wrappers_take_plain_path_on_cpu():
    """B5, B6, B7 and B8 on CPU tensors: the plain versions, counters at
    0; other devices and non-f32 PrRoI maps raise."""
    from tao_amodal_torch.ops import prroi, resnet_blocks

    counters = (prroi.prroi_packed_pallas, prroi.prroi_pool_pallas,
                resnet_blocks.identity_blocks_pallas,
                resnet_blocks.identity_blocks_bf16_pallas)
    before = tuple(f.launches for f in counters)
    canvas, rois = _prroi_inputs("cpu")
    for t in (slice(None), 0):  # [T, H, W, C] and one [H, W, C] map
        torch.testing.assert_close(
            prroi.prroi_packed_pallas(canvas[t], rois[t]),
            prroi.prroi_packed_pallas_torch(canvas[t], rois[t]),
            rtol=0, atol=0)
        torch.testing.assert_close(
            prroi.prroi_pool_pallas(canvas[t], rois[t], 7, 0.5),
            prroi.prroi_pool_pallas_torch(canvas[t], rois[t], 7, 0.5),
            rtol=0, atol=0)
    for kind, fn, ref in (
            ("int8", resnet_blocks.identity_blocks_pallas,
             resnet_blocks.identity_blocks_reference),
            ("bf16", resnet_blocks.identity_blocks_bf16_pallas,
             resnet_blocks.identity_blocks_bf16_reference)):
        x, p = torch_stack("cpu", *stack_arrays((2, 6, 7, 32), 8, 2, kind),
                           kind)
        assert torch.equal(fn(x, p), ref(x, p))
    assert tuple(f.launches for f in counters) == before == (0, 0, 0, 0)
    # bf16 maps take the plain versions too: B5 returns bf16, B6 f32.
    bf = canvas.to(torch.bfloat16)
    for fn, ref, dtype in (
            (prroi.prroi_packed_pallas, prroi.prroi_packed_pallas_torch,
             torch.bfloat16),
            (prroi.prroi_pool_pallas, prroi.prroi_pool_pallas_torch,
             torch.float32)):
        got = fn(bf, rois)
        assert got.dtype == dtype and torch.equal(got, ref(bf, rois))
        assert fn.bf16.launches == 0
    for fn in (prroi.prroi_packed_pallas, prroi.prroi_pool_pallas):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(canvas.to("meta"), rois.to("meta"))
    for kind, fn in (("int8", resnet_blocks.identity_blocks_pallas),
                     ("bf16", resnet_blocks.identity_blocks_bf16_pallas)):
        x, p = torch_stack("cpu", *stack_arrays((2, 6, 7, 32), 8, 2, kind),
                           kind)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x.to("meta"), p)


def _default_device_calls():
    """name -> (the entry point, a call that leaves ``device`` at its
    default and returns the device of what it built)."""
    from tao_amodal_torch.models.rpn import level_anchors
    from tao_amodal_torch.pipeline import AmodalPipeline
    from tao_amodal_torch.trackers.sort import Sort, init_sort

    def tiny():
        return AmodalPipeline.create(num_classes=3, num_dets=4,
                                     num_proposals=8,
                                     backbone_stages=(1, 1, 1, 1))

    return {
        "AmodalPipeline.create": (AmodalPipeline.create,
                                  lambda: tiny().device),
        # batched builds its fresh SORT states where the pipeline is.
        "AmodalPipeline.batched": (AmodalPipeline.create, lambda: (
            tiny().batched(torch.zeros(2, 2, 32, 32, 3, device="cuda"))
            [1].x.device)),
        "init_sort": (init_sort, lambda: init_sort(8).x.device),
        "Sort": (Sort, lambda: Sort().state.x.device),
        "level_anchors": (level_anchors, lambda: level_anchors(
            2, 3, 16, [32], (0.5, 1.0)).device),
    }


@pytest.mark.parametrize("name", ["AmodalPipeline.create",
                                  "AmodalPipeline.batched", "init_sort",
                                  "Sort", "level_anchors"])
def test_entry_points_default_to_the_card(name):
    """The port's entry points build on the card unless the caller passes
    ``device="cpu"``; without a card they raise rather than hand back
    CPU tensors.  Whether there is a card is decided here, at run time."""
    fn, call = _default_device_calls()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert call().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_conv_plan_covers_resnet50_chain_convs():
    """B4's plan for each of the 40 convs of ResNet-50's stride-1 chains
    at 512^2, T=8: a tile the kernel has (64 wide iff Cout <= 64), K in
    whole BK slices split into ranges that cover it with none empty, the
    workspace of the partial sums, and a grid that fills at least 90 %
    of the blocks 132 SMs hold.  Stage 3's 1x1a and 3x3 split in 2,
    stage 4's in 4, nothing else."""
    from tao_amodal_torch.ops import fused_stage as fs

    convs = resnet50_chain_convs()
    assert len(convs) == 40
    slots = fs.BLOCKS_PER_SM * fs.H100_SMS
    for stage, P, cin, cout, ks in convs:
        plan = fs.conv_plan(P, cin, cout, ks)
        K = ks * ks * cin
        nk = K // fs.BK
        assert plan.bn == (64 if cout <= 64 else 128)
        assert K % fs.BK == 0
        assert ((plan.splits - 1) * plan.slices < nk
                <= plan.splits * plan.slices)
        assert plan.splits == 1 or plan.slices >= fs.MIN_SLICES
        assert plan.workspace == (plan.splits * P * cout
                                  if plan.splits > 1 else 0)
        tiles = -(-P // fs.BM) * -(-cout // plan.bn)
        assert 10 * tiles * plan.splits >= 9 * slots
        # The 1x1a (cin > cout) and the 3x3 of stages 3 and 4.
        split = {3: 2, 4: 4}.get(stage, 1) if ks == 3 or cin > cout else 1
        assert plan.splits == split, (stage, P, cin, cout, ks, plan)


def test_make_plan_never_leaves_a_range_empty():
    """Any asked-for split shrinks to one whose ranges are all non-empty
    and cover K; the workspace follows the split."""
    from tao_amodal_torch.ops import fused_stage as fs

    rs = np.random.RandomState(0)
    for _ in range(500):
        P, cin, cout = (rs.randint(1, 5000), 8 * rs.randint(1, 80),
                        4 * rs.randint(1, 200))
        ks, bn, splits = (int(rs.choice([1, 3])), int(rs.choice([64, 128])),
                          rs.randint(1, 40))
        plan = fs.make_plan(P, cin, cout, ks, bn, splits)
        nk = -(-ks * ks * cin // fs.BK)
        assert plan.bn == bn and 1 <= plan.splits <= splits
        assert ((plan.splits - 1) * plan.slices < nk
                <= plan.splits * plan.slices)
        assert plan.workspace == (plan.splits * P * cout
                                  if plan.splits > 1 else 0)


RESNET50_STACKS = (((8, 128, 128, 256), 64, 2), ((8, 64, 64, 512), 128, 3),
                   ((8, 32, 32, 1024), 256, 5), ((8, 16, 16, 2048), 512, 2))


# (stage, conv) -> K splits of B7's and B8's plans at ResNet-50's shapes;
# every other conv is whole.
STACK_SPLITS = {torch.int8: {(4, "3x3"): 2},
                torch.bfloat16: {(3, "3x3"): 2, (4, "1x1 C->M"): 2,
                                 (4, "3x3"): 4}}


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_stack_conv_plan_covers_resnet50_stack_convs(dtype):
    """B7's and B8's plan for each conv of ResNet-50's four identity
    stacks at 512^2, T=8 (1x1 C -> M, 3x3 M -> M, 1x1 M -> C): a tile the
    kernel has (64 wide iff Cout <= 64), K in whole 64-byte slices split
    into ranges that cover it with none empty and none under
    ``MIN_SPLIT_SLICES`` deep, the workspace of the partial sums, and a
    grid that fills at least 90 % of the blocks 132 SMs hold unless one
    more split would make a range shorter than that; the splits of
    ``STACK_SPLITS``."""
    from tao_amodal_torch.ops import fused_stage as fs
    from tao_amodal_torch.ops import resnet_blocks as rb

    itemsize = torch.empty((), dtype=dtype).element_size()
    bk = rb.SLICE_BYTES // itemsize
    slots = fs.BLOCKS_PER_SM * fs.H100_SMS
    for stage, ((T, H, W, C), M, _) in enumerate(RESNET50_STACKS, 1):
        P = T * H * W
        for role, cin, cout, ks in (("1x1 C->M", C, M, 1),
                                    ("3x3", M, M, 3),
                                    ("1x1 M->C", M, C, 1)):
            plan = rb.conv_plan(P, cin, cout, ks, itemsize)
            K = ks * ks * cin
            nk = K // bk
            assert K % bk == 0 and cin % rb.CHANNEL_MULTIPLE[dtype] == 0
            assert plan.bn == (64 if cout <= 64 else 128)
            assert ((plan.splits - 1) * plan.slices < nk
                    <= plan.splits * plan.slices)
            assert plan.workspace == (plan.splits * P * cout
                                      if plan.splits > 1 else 0)
            assert plan.splits == 1 or plan.slices >= rb.MIN_SPLIT_SLICES
            tiles = -(-P // fs.BM) * -(-cout // plan.bn)
            assert (10 * tiles * plan.splits >= 9 * slots
                    or nk < 2 * plan.splits * rb.MIN_SPLIT_SLICES)
            assert plan.splits == STACK_SPLITS[dtype].get((stage, role), 1), (
                stage, role, plan)


@pytest.mark.parametrize("itemsize", [1, 2])
def test_stack_layout_follows_the_plan(itemsize):
    """The per-shape layout of a stack call (cached) holds the plan it
    was given, as the C ``int[9]``, and one scratch buffer of y1, y2,
    the second block output, the split workspace (4-byte partials), the
    tile counters and, for int8, the three transposed weights, each
    region 16-byte aligned; another plan function gets its own entry
    (the CUDA tests force plans this way)."""
    from tao_amodal_torch.ops import fused_stage as fs
    from tao_amodal_torch.ops import resnet_blocks as rb

    N, P, C, M = 2, 2 * 9 * 13, 48, 32

    def forced(P, cin, cout, ks, itemsize, sms):
        return fs.make_plan(P, cin, cout, ks, 64, 4,
                            rb.SLICE_BYTES // itemsize)

    for plan in (rb.conv_plan, forced):
        ints, off, tiles = rb._stack_layout(plan, N, P, C, M, itemsize, 132)
        plans = [plan(P, cin, cout, ks, itemsize, 132)
                 for cin, cout, ks in ((C, M, 1), (M, M, 3), (M, C, 1))]
        assert list(ints) == [v for pl in plans for v in pl[:3]]
        work = max(pl.workspace for pl in plans)
        assert tiles == (-(-P // fs.BM) * -(-C // 64) if work else 0)
        sizes = [b - a for a, b in zip(off, off[1:])]
        assert sizes[:5] == [P * M * itemsize, P * M * itemsize,
                             P * C * itemsize, 4 * work,
                             -(-4 * tiles // 16) * 16]
        assert sizes[5] == (N * (2 * C * M + 9 * M * M) if itemsize == 1
                            else 0)
        assert all(o % 16 == 0 for o in off)
    ints, _, _ = rb._stack_layout(forced, N, P, C, M, itemsize, 132)
    assert max(ints[1::3]) > 1


def test_int8_weight_layout_is_cout_by_k():
    """B7's weight operand: int8 ``[N, K, Cout]`` (HWIO flattened, k =
    (ky*3 + kx)*Cin + c) as ``[N, Cout, K]`` with k contiguous, equal to
    a numpy definition element by element.  (On the card the stack's own
    transposition makes it; the CUDA tests hold B7 bit-equal on ragged
    K and Cout.)"""
    from tao_amodal_torch.ops import resnet_blocks as rb

    N, Cin, Cout = 2, 16, 32
    w = np.random.RandomState(0).randint(-127, 128, (N, 3, 3, Cin, Cout),
                                         dtype=np.int8)
    got = rb.weights_s8(torch.from_numpy(w).reshape(N, 9 * Cin, Cout))
    assert got.is_contiguous() and tuple(got.shape) == (N, Cout, 9 * Cin)
    want = np.empty((N, Cout, 9 * Cin), np.int8)
    for n in range(N):
        for ky in range(3):
            for kx in range(3):
                for c in range(Cin):
                    want[n, :, (ky * 3 + kx) * Cin + c] = w[n, ky, kx, c]
    np.testing.assert_array_equal(got.numpy(), want)


def test_parse_ptxas_reads_registers_and_spills():
    from tao_amodal_torch import _build

    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4convILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z4convILi128EEvv
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, 16 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5prroiv' for 'sm_90a'
ptxas info    : Function properties for _Z5prroiv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, 400 bytes cmem[0]
"""
    assert _build.parse_ptxas(text) == {
        "_Z4convILi128EEvv": dict(registers=128, smem=16, spill_stores=8,
                                  spill_loads=12),
        "_Z5prroiv": dict(registers=90, smem=0, spill_stores=0,
                          spill_loads=0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_preproc_kernel_matches_plain_on_cuda(cuda):
    """B1 at the serving shape (480x640 -> 512^2, T=8) and a small one;
    atol 1e-3 on outputs of magnitude <= ~3 (same taps, other order)."""
    from tao_amodal_torch.ops import preproc

    for shape in ((8, 480, 640, 512), (2, 45, 61, 64)):
        T, H, W, S = shape
        args = _preproc_inputs(cuda, T, H, W, S)
        n = preproc.preprocess_frames.launches
        got = preproc.preprocess_frames(*args)
        torch.cuda.synchronize()
        assert preproc.preprocess_frames.launches == n + 1
        want = preproc.preprocess_frames_torch(*args)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_prroi_kernel_matches_plain_on_cuda(cuda):
    """B2 at the serving canvas (T=8, 64x98 P3..P6 shelf, C=256, 96 RoIs
    per frame) and a small one with RoIs overhanging the canvas; atol
    1e-4 + rtol 1e-4 on N(0,1) features (same weights, other order)."""
    from tao_amodal_torch.ops import prroi

    for shape in ((8, 64, 98, 256, 96), (2, 16, 26, 40, 5)):
        canvas, rois = _prroi_inputs(cuda, *shape)
        n = prroi.prroi_packed.launches
        got = prroi.prroi_packed(canvas, rois)
        torch.cuda.synchronize()
        assert prroi.prroi_packed.launches == n + 1
        want = prroi.prroi_packed_torch(canvas, rois)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_chain_kernel_matches_plain_on_cuda(cuda):
    """B4 at ResNet-50's stage-2 tail width (T=2, 64x64, 512 -> M=128,
    3 blocks), and small chains with ragged tiles (9x13 frames, 64-wide
    convs) with and without the projection.  The plain version is cuDNN
    with TF32 off; the bound is 1e-4 of the output's largest magnitude
    (f32 sums of up to 9*M products in another order)."""
    from tao_amodal_torch.ops import fused_stage

    cases = [((2, 64, 64, 512), 128, 3, False),
             ((2, 9, 13, 64), 64, 2, True),
             ((2, 9, 13, 64), 16, 3, True),
             ((2, 9, 13, 256), 64, 1, False)]
    for case in cases:
        x, params = chain_inputs(cuda, *case)
        n = fused_stage.fused_bottleneck_chain.launches
        with torch.no_grad():
            got = fused_stage.fused_bottleneck_chain(x, params)
            torch.cuda.synchronize()
            want = fused_stage.bottleneck_chain_torch(x, params)
        assert fused_stage.fused_bottleneck_chain.launches == n + 1
        assert got.shape == want.shape
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * max(scale, 1.0), (
            case, float((got - want).abs().max()), scale)


@pytest.mark.cuda
def test_sort_scan_kernel_matches_plain_on_cuda(cuda):
    """B3 against the per-frame loop at the serving shape (K=128, D=64,
    T=8) over 6 clips of a coherent scene of 40 objects with the state
    threaded, and on a clip of empty then full frames: integers exact,
    Kalman state rtol 1e-4 / atol 1e-3."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.trackers.sort import init_sort

    clips = _scene(cuda)
    full = torch.rand(8, 64, 2, device=cuda) * 500
    clips.append((torch.cat([full, full + 30], -1),
                  torch.arange(8, device=cuda)[:, None].expand(8, 64) >= 4))
    for max_age, min_hits in ((5, 1), (1, 3)):
        kw = dict(max_age=max_age, min_hits=min_hits)
        got_s = want_s = init_sort(128, device=cuda)
        for boxes, valid in clips:
            n = sort_scan.sort_scan_pallas.launches
            got_s, got = sort_scan.sort_scan(got_s, boxes, valid,
                                             impl="pallas", **kw)
            torch.cuda.synchronize()
            assert sort_scan.sort_scan_pallas.launches == n + 1
            want_s, want = sort_scan.sort_scan(want_s, boxes, valid, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            for f in ("alive", "track_id", "hits", "hit_streak", "age",
                      "time_since_update", "next_id", "frame_count"):
                assert torch.equal(getattr(got_s, f), getattr(want_s, f)), f
            torch.testing.assert_close(got_s.x, want_s.x, rtol=1e-4,
                                       atol=1e-3)
            torch.testing.assert_close(got_s.P, want_s.P, rtol=1e-4,
                                       atol=1e-3)
        assert int(got_s.next_id) > 40


@pytest.mark.cuda
def test_sort_scan_kernel_matches_plain_on_a_tie_rich_scene(cuda):
    """B3 against the per-frame loop on 64 valid detections a frame with
    hundreds of IoUs exactly at the gate, exact ties between rows, many
    non-overlapping boxes and full slots, the state threaded over 3
    clips, at both lifecycles: every integer exact."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.trackers.sort import init_sort

    clips = _tie_clips(cuda)
    for max_age, min_hits in ((5, 1), (1, 3)):
        kw = dict(max_age=max_age, min_hits=min_hits)
        got_s = want_s = init_sort(128, device=cuda)
        for boxes, valid in clips:
            got_s, got = sort_scan.sort_scan(got_s, boxes, valid,
                                             impl="pallas", **kw)
            want_s, want = sort_scan.sort_scan(want_s, boxes, valid, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            for f in ("alive", "track_id", "hits", "hit_streak", "age",
                      "time_since_update", "next_id", "frame_count"):
                assert torch.equal(getattr(got_s, f), getattr(want_s, f)), f
            torch.testing.assert_close(got_s.x, want_s.x, rtol=1e-4,
                                       atol=1e-3)
        assert int(got_s.next_id) > 200


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,W,S", PREPROC_ODD)
def test_preproc_kernel_odd_geometries_match_plain_on_cuda(cuda, T, H, W,
                                                           S):
    """B1 against its plain version on geometries off the serving shape,
    atol 1e-3; the letterbox pad equal bit for bit."""
    from tao_amodal_torch.ops import preproc

    args = _preproc_inputs(cuda, T, H, W, S, seed=H + W)
    n = preproc.preprocess_frames.launches
    got = preproc.preprocess_frames(*args)
    torch.cuda.synchronize()
    assert preproc.preprocess_frames.launches == n + 1
    want = preproc.preprocess_frames_torch(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    wy, wx, _ = preproc.make_letterbox_weights((H, W), S)
    pad = torch.from_numpy(~(wy != 0).any(1)[:, None]
                           | ~(wx != 0).any(1)[None, :]).to(cuda)
    assert torch.equal(got[:, pad], want[:, pad])


@pytest.mark.cuda
def test_kernels_reject_wrong_inputs_on_cuda(cuda):
    from tao_amodal_torch.ops import fused_stage, prroi, preproc, sort_scan
    from tao_amodal_torch.trackers.sort import init_sort

    frames, S, mean, std = _preproc_inputs(cuda)
    with pytest.raises(ValueError):
        preproc.preprocess_frames(frames.float(), S, mean, std)
    canvas, rois = _prroi_inputs(cuda)
    with pytest.raises(ValueError):
        prroi.prroi_packed(canvas.double(), rois)
    with pytest.raises(ValueError):
        prroi.prroi_packed(canvas, rois[:1])
    # Cin = 12 is not a multiple of 8.
    x, params = chain_inputs(cuda, (2, 9, 13, 12), 8, 2, True)
    with pytest.raises(ValueError), torch.no_grad():
        fused_stage.fused_bottleneck_chain(x, params)
    x, params = chain_inputs(cuda, (2, 9, 13, 16), 8, 2, True)
    with pytest.raises(ValueError, match="forward only"):
        fused_stage.fused_bottleneck_chain(x.requires_grad_(), params)
    (boxes, valid), = _scene(cuda, clips=1, T=3, D=4, objects=2)
    with pytest.raises(ValueError):
        sort_scan.sort_scan_pallas(init_sort(8, device=cuda),
                                   boxes.double(), valid)
    with pytest.raises(ValueError):
        sort_scan.sort_scan_pallas(init_sort(8, device=cuda), boxes.cpu(),
                                   valid.cpu())


@pytest.mark.cuda
def test_prroi_variant_kernels_match_plain_on_cuda(cuda):
    """B5 at the serving canvas padded to 112 columns ([8, 64, 112, 256],
    96 RoIs a frame) equals B2 on the unpadded canvas bit for bit (the
    zero columns lie outside every support, which the kernel clamps to
    the map) and its plain version to atol 1e-4 + rtol 1e-4; B5 on one
    [H, W, C] map; B6 on a serving P3 level [8, 64, 64, 256] at
    spatial_scale 1/8 with RoIs crossing the map's edges, and on one
    small map.  f32, the same weights summed in another order."""
    from tao_amodal_torch.ops import prroi

    canvas, rois = _prroi_inputs(cuda, 8, 64, 98, 256, 96)
    padded = torch.nn.functional.pad(canvas, (0, 0, 0, 14))
    n = prroi.prroi_packed_pallas.launches
    got = prroi.prroi_packed_pallas(padded, rois)
    torch.cuda.synchronize()
    assert prroi.prroi_packed_pallas.launches == n + 1
    assert torch.equal(got, prroi.prroi_packed(canvas, rois))
    torch.testing.assert_close(
        got, prroi.prroi_packed_pallas_torch(padded, rois), rtol=1e-4,
        atol=1e-4)
    one = prroi.prroi_packed_pallas(padded[3], rois[3])
    torch.testing.assert_close(one, got[3], rtol=0, atol=0)

    for shape, scale in (((8, 64, 64, 256, 96), 0.125),
                         ((2, 16, 26, 40, 8), 0.5)):
        level, boxes = _prroi_inputs(cuda, *shape)
        boxes = boxes / scale + torch.tensor([[[-3.0, -3.0, 12.0, 12.0]]],
                                             device=cuda)
        assert bool((boxes[..., 2] * scale > level.shape[2]).any())
        for t in (slice(None), 0):
            n = prroi.prroi_pool_pallas.launches
            got = prroi.prroi_pool_pallas(level[t], boxes[t], 7, scale)
            torch.cuda.synchronize()
            assert prroi.prroi_pool_pallas.launches == n + 1
            torch.testing.assert_close(
                got, prroi.prroi_pool_pallas_torch(level[t], boxes[t], 7,
                                                   scale),
                rtol=1e-4, atol=1e-4)


# The JAX test's shape (tests/test_resnet_blocks.py:33), a ragged small
# frame, ResNet-50's stage-2 width and its stage-4 width.
STACK_CASES = [((2, 16, 16, 64), 16, 2), ((2, 9, 13, 64), 32, 2),
               ((2, 64, 64, 512), 128, 3), ((1, 16, 16, 2048), 512, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,M,N", STACK_CASES)
def test_int8_stack_kernel_matches_plain_on_cuda(cuda, shape, M, N):
    """B7 against the plain version (float64 dots, exact): int8 outputs
    equal at each of ``STACK_CASES``."""
    from tao_amodal_torch.ops import resnet_blocks

    x, p = torch_stack(cuda, *stack_arrays(shape, M, N, "int8", seed=1),
                       "int8")
    n = resnet_blocks.identity_blocks_pallas.launches
    got = resnet_blocks.identity_blocks_pallas(x, p)
    torch.cuda.synchronize()
    assert resnet_blocks.identity_blocks_pallas.launches == n + 1
    want = resnet_blocks.identity_blocks_reference(x, p)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert 0 < float((want > 0).float().mean()) < 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,M,N", STACK_CASES)
def test_bf16_stack_kernel_matches_plain_on_cuda(cuda, shape, M, N):
    """B8 against the plain version (f32 dots, TF32 off): max |d| <= 1e-2
    max|ref| and mean |d| <= 1e-3 mean|ref| (f32 sums in another order
    flip a bf16 rounding now and then, and a flip propagates through the
    later blocks)."""
    from tao_amodal_torch.ops import resnet_blocks

    x, p = torch_stack(cuda, *stack_arrays(shape, M, N, "bf16", seed=1),
                       "bf16")
    n = resnet_blocks.identity_blocks_bf16_pallas.launches
    got = resnet_blocks.identity_blocks_bf16_pallas(x, p).float()
    torch.cuda.synchronize()
    assert resnet_blocks.identity_blocks_bf16_pallas.launches == n + 1
    want = resnet_blocks.identity_blocks_bf16_reference(x, p).float()
    d = (got - want).abs()
    assert float(d.max()) <= 1e-2 * float(want.abs().max())
    assert float(d.mean()) <= 1e-3 * float(want.abs().mean())


@pytest.mark.cuda
def test_prroi_variant_and_stack_kernels_reject_wrong_inputs_on_cuda(cuda):
    from tao_amodal_torch.ops import prroi, resnet_blocks

    canvas, rois = _prroi_inputs(cuda)
    with pytest.raises(ValueError):
        prroi.prroi_packed_pallas(canvas, rois[:1])
    with pytest.raises(ValueError):
        prroi.prroi_pool_pallas(canvas[0], rois)
    # C and M: multiples of 16 in int8 (M = 8 is not), 8 in bf16.
    x, p = torch_stack(cuda, *stack_arrays((2, 9, 13, 64), 8, 2, "int8"),
                       "int8")
    with pytest.raises(ValueError, match="multiples of 16"):
        resnet_blocks.identity_blocks_pallas(x, p)
    xb, pb = torch_stack(cuda, *stack_arrays((2, 9, 13, 64), 4, 2, "bf16"),
                         "bf16")
    with pytest.raises(ValueError, match="multiples of 8"):
        resnet_blocks.identity_blocks_bf16_pallas(xb, pb)
    x, p = torch_stack(cuda, *stack_arrays((2, 9, 13, 64), 32, 2, "int8"),
                       "int8")
    with pytest.raises(ValueError):
        resnet_blocks.identity_blocks_pallas(x.float(), p)
    with pytest.raises(ValueError):
        resnet_blocks.identity_blocks_pallas(x, p._replace(w1=p.w1.cpu()))
    xb, pb = torch_stack(cuda, *stack_arrays((2, 9, 13, 64), 32, 2,
                                             "bf16"), "bf16")
    with pytest.raises(ValueError):
        resnet_blocks.identity_blocks_bf16_pallas(xb.float(), pb)


def _resnet50_plans():
    """The (tile width, splits) plans B4 takes at ResNet-50's 512^2, T=8
    chain shapes."""
    from tao_amodal_torch.ops import fused_stage

    return sorted({fused_stage.conv_plan(P, cin, cout, ks)[:2]
                   for _, P, cin, cout, ks in resnet50_chain_convs()})


@pytest.mark.cuda
@pytest.mark.parametrize("bn,splits", [(64, 1), (128, 1), (128, 2),
                                       (128, 4)])
def test_fused_chain_plans_match_plain_on_cuda(cuda, bn, splits,
                                              monkeypatch):
    """B4 under each plan the ResNet-50 shapes take, forced on every conv
    of ragged chains: P = 2*9*13 (not a multiple of the 128-pixel tile),
    Cin = 8, Cout = 4M = 96 (a multiple of 4 but not of the tile), a
    projection; then the default plan at stage 4's shape.  The plain
    version is cuDNN with TF32 off; the bound is 1e-4 of the output's
    largest magnitude (f32 sums of up to 9*M products in other orders,
    the split ones summed in parts)."""
    from tao_amodal_torch.ops import fused_stage

    assert (bn, splits) in _resnet50_plans()

    def forced(P, cin, cout, ks, sms):
        return fused_stage.make_plan(P, cin, cout, ks, bn, splits)

    for case, plan in ((((2, 9, 13, 8), 24, 2, True), forced),
                       (((2, 9, 13, 256), 64, 1, False), forced),
                       (((8, 16, 16, 2048), 512, 1, False),
                        fused_stage.conv_plan)):
        x, params = chain_inputs(cuda, *case, seed=3)
        n = fused_stage.fused_bottleneck_chain.launches
        monkeypatch.setattr(fused_stage, "conv_plan", plan)
        with torch.no_grad():
            got = fused_stage.fused_bottleneck_chain(x, params)
            torch.cuda.synchronize()
            want = fused_stage.bottleneck_chain_torch(x, params)
        assert fused_stage.fused_bottleneck_chain.launches == n + 1
        assert got.shape == want.shape
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(scale, 1.0), (case, bn, splits, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("bn,splits", [(64, 1), (128, 1), (128, 2),
                                       (128, 4)])
def test_stack_plans_match_plain_on_cuda(cuda, bn, splits, monkeypatch):
    """B7 and B8 under each plan the ResNet-50 stacks take, forced on
    every conv of ragged stacks: P = 2*9*13 (not a multiple of the
    128-pixel tile), C = 48 and M = 16 or 32 (not multiples of the tile
    width, and slices that straddle two taps of the 3x3), then C = 2048,
    M = 512 at stage 4's frame size.  B7 equal to its plain version, B8
    within its bound (as ``test_bf16_stack_kernel_matches_plain_on_cuda``)."""
    from tao_amodal_torch.ops import fused_stage
    from tao_amodal_torch.ops import resnet_blocks as rb

    def forced(P, cin, cout, ks, itemsize, sms):
        return fused_stage.make_plan(P, cin, cout, ks, bn, splits,
                                     rb.SLICE_BYTES // itemsize)

    monkeypatch.setattr(rb, "conv_plan", forced)
    for shape, M, N in (((2, 9, 13, 48), 16, 2), ((2, 9, 13, 48), 32, 1),
                        ((1, 16, 16, 2048), 512, 1)):
        x, p = torch_stack(cuda, *stack_arrays(shape, M, N, "int8", seed=2),
                           "int8")
        n = rb.identity_blocks_pallas.launches
        got = rb.identity_blocks_pallas(x, p)
        torch.cuda.synchronize()
        assert rb.identity_blocks_pallas.launches == n + 1
        assert torch.equal(got, rb.identity_blocks_reference(x, p)), (
            shape, M, bn, splits)
        x, p = torch_stack(cuda, *stack_arrays(shape, M, N, "bf16", seed=2),
                           "bf16")
        got = rb.identity_blocks_bf16_pallas(x, p).float()
        want = rb.identity_blocks_bf16_reference(x, p).float()
        d = (got - want).abs()
        assert float(d.max()) <= 1e-2 * float(want.abs().max())
        assert float(d.mean()) <= 1e-3 * float(want.abs().mean())


def _edge_rois(Hc, Wc):
    """RoIs that cross each canvas edge, zero-area ones (the 1e-8 bin
    clamp), one on the whole canvas, one past it, and small ones."""
    return [[-3.0, 2.0, 8.0, 9.5], [Wc - 6.5, Hc - 5.0, Wc + 4.0, Hc + 2.0],
            [4.0, -2.5, 11.0, 3.0], [5.0, 5.0, 5.0, 5.0],
            [7.25, 3.0, 7.25, 10.0], [2.0, 6.5, 9.0, 6.5],
            [0.0, 0.0, float(Wc), float(Hc)],
            [-10.0, -10.0, Wc + 10.0, Hc + 10.0],
            [10.3, 4.7, 12.1, 5.9], [1.0, 1.0, 3.5, 2.0]]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 256])
def test_prroi_kernels_edge_rois_match_plain_on_cuda(cuda, C):
    """B2, B5 and B6 against their plain versions on RoIs that cross the
    edges, have zero area, cover the whole map or more, at C = 64 and
    256 (atol 1e-4 + rtol 1e-4: the same weights summed in another
    order); B5 on the canvas padded with zero columns equals B2 bit for
    bit."""
    from tao_amodal_torch.ops import prroi

    T, Hc, Wc = 2, 20, 30
    canvas = torch.from_numpy(np.random.RandomState(C).randn(
        T, Hc, Wc, C).astype(np.float32)).to(cuda)
    rois = torch.tensor([_edge_rois(Hc, Wc)] * T, device=cuda)
    rois[1] += 0.37
    b2 = prroi.prroi_packed(canvas, rois)
    torch.testing.assert_close(b2, prroi.prroi_packed_torch(canvas, rois),
                               rtol=1e-4, atol=1e-4)
    padded = torch.nn.functional.pad(canvas, (0, 0, 0, 2))
    b5 = prroi.prroi_packed_pallas(padded, rois)
    torch.testing.assert_close(
        b5, prroi.prroi_packed_pallas_torch(padded, rois), rtol=1e-4,
        atol=1e-4)
    assert torch.equal(b5, b2)
    b6 = prroi.prroi_pool_pallas(canvas, rois * 4.0, 7, 0.25)
    torch.testing.assert_close(
        b6, prroi.prroi_pool_pallas_torch(canvas, rois * 4.0, 7, 0.25),
        rtol=1e-4, atol=1e-4)
    # More bins than one block's group of 8: two groups per bin row.
    torch.testing.assert_close(
        prroi.prroi_packed(canvas, rois, 10),
        prroi.prroi_packed_torch(canvas, rois, 10), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("assignment", ["gated_auction", "auction"])
def test_auction_on_cuda_matches_cpu(cuda, assignment):
    """The auction on the card against the same function on the CPU:
    ``auction_assign`` on random payoffs with forbidden entries, and
    ``sort_scan(impl="auto")`` over 3 threaded clips of the coherent
    40-object scene (K=128, D=64).  Elementwise f32 and first-index
    max/argmax on both devices: every integer equal, the Kalman state
    rtol 1e-4 + atol 1e-3 (einsums in another order)."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.ops.hungarian import NEG, auction_assign
    from tao_amodal_torch.trackers.sort import init_sort

    eps, floor = {"auction": (5e-5, -1e-3),
                  "gated_auction": (1e-3, 0.24)}[assignment]
    rs = np.random.RandomState(3)
    for n, m in ((12, 12), (30, 9), (7, 40)):
        b = rs.rand(n, m).astype(np.float32)
        b[rs.rand(n, m) < 0.3] = NEG
        got = auction_assign(torch.from_numpy(b).to(cuda), eps, floor)
        want = auction_assign(torch.from_numpy(b), eps, floor)
        assert torch.equal(got.cpu(), want)
    kw = dict(max_age=5, min_hits=1, assignment=assignment)
    got_s, want_s = init_sort(128, device=cuda), init_sort(128, device="cpu")
    for boxes, valid in _scene(cuda, clips=3):
        got_s, got = sort_scan.sort_scan(got_s, boxes, valid, **kw)
        want_s, want = sort_scan.sort_scan(want_s, boxes.cpu(), valid.cpu(),
                                           **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        for f in ("alive", "track_id", "hits", "hit_streak", "age",
                  "time_since_update", "next_id", "frame_count"):
            assert torch.equal(getattr(got_s, f).cpu(), getattr(want_s, f)), f
        torch.testing.assert_close(got_s.x.cpu(), want_s.x, rtol=1e-4,
                                   atol=1e-3)
    assert int(got_s.next_id) > 40


@pytest.mark.cuda
def test_prroi_and_fused_chain_at_32_frames_match_plain_on_cuda(cuda):
    """The shapes ``AmodalPipeline.batched`` gives B2 and B4 at B = 4
    videos of T = 8 frames: B2 on the 32-frame serving canvas (64x98
    P3..P6 shelf, C=256, 96 RoIs a frame), atol 1e-4 + rtol 1e-4; B4 on
    ResNet-50's four stride-1 chains at 32 x 512^2 / 4^s, where
    ``conv_plan`` sees four times the rows of a clip, within 1e-4 of the
    output's largest magnitude of cuDNN f32 (TF32 off)."""
    from tao_amodal_torch.ops import fused_stage, prroi

    canvas, rois = _prroi_inputs(cuda, 32, 64, 98, 256, 96)
    got = prroi.prroi_packed(canvas, rois)
    torch.testing.assert_close(got, prroi.prroi_packed_torch(canvas, rois),
                               rtol=1e-4, atol=1e-4)
    del canvas, got
    stages = (((32, 128, 128, 64), 64, 3, True),
              ((32, 64, 64, 512), 128, 3, False),
              ((32, 32, 32, 1024), 256, 5, False),
              ((32, 16, 16, 2048), 512, 2, False))
    for case in stages:
        x, params = chain_inputs(cuda, *case, seed=31)
        with torch.no_grad():
            got = fused_stage.fused_bottleneck_chain(x, params)
            want = fused_stage.bottleneck_chain_torch(x, params)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * max(scale, 1.0), (
            case, float((got - want).abs().max()), scale)
        del x, params, got, want


def _bf16_close(got, want, what="", other=None):
    """B8's bound for bf16 results: max |d| <= 1e-2 max|ref| and mean |d|
    <= 1e-3 mean|ref| (f32 sums in another order flip a bf16 rounding
    now and then), or, given ``other`` (the plain version run in another
    f32 order, on the CPU), twice its spread from ``want`` where that is
    larger: over many convs the flips carry on, as chip_smoke.py holds
    B8's deep stacks."""
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    max_b, mean_b = 1e-2 * float(ref.max()), 1e-3 * float(ref.mean())
    if other is not None:
        spread = (other.to(want.device).float() - want.float()).abs()
        max_b = max(max_b, 2 * float(spread.max()))
        mean_b = max(mean_b, 2 * float(spread.mean()))
    assert float(d.max()) <= max_b, (what, float(d.max()), max_b)
    assert float(d.mean()) <= mean_b, (what, float(d.mean()), mean_b)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 256])
def test_bf16_prroi_kernels_match_plain_on_cuda(cuda, C):
    """The bf16 forms of B2, B5 and B6 against their plain versions on a
    bf16 map: RoIs that cross the edges, have zero area, cover the whole
    map or more (``_edge_rois``), then the 384x512 serving canvas (T=8,
    the 48x98 P3..P6 shelf, 96 RoIs a frame, C=256) for B2 and B5 and
    its P3 level for B6.  Output dtypes as JAX's (B2, B5 bf16; B6 f32);
    B8's bound (each form's weights are rounded as its plain version
    rounds them, the f32 sums run in another order); each call counts
    one bf16 launch and no f32 one."""
    from tao_amodal_torch.ops import prroi

    T, Hc, Wc = 2, 20, 30
    canvas = torch.from_numpy(np.random.RandomState(C).randn(
        T, Hc, Wc, C).astype(np.float32)).to(cuda).to(torch.bfloat16)
    rois = torch.tensor([_edge_rois(Hc, Wc)] * T, device=cuda)
    rois[1] += 0.37
    cases = [(canvas, rois, 1.0)]
    if C == 256:
        big, big_rois = _prroi_inputs(cuda, 8, 48, 98, 256, 96)
        cases.append((big.to(torch.bfloat16), big_rois, 1.0))
    for feats, boxes, _ in cases:
        for fn, ref, dtype, scale in (
                (prroi.prroi_packed, prroi.prroi_packed_torch,
                 torch.bfloat16, None),
                (prroi.prroi_packed_pallas, prroi.prroi_packed_pallas_torch,
                 torch.bfloat16, None),
                (prroi.prroi_pool_pallas, prroi.prroi_pool_pallas_torch,
                 torch.float32, 0.25)):
            n, n32 = fn.bf16.launches, fn.launches
            args = (feats, boxes) if scale is None else (
                feats, boxes * 4.0, 7, scale)
            got = fn(*args)
            torch.cuda.synchronize()
            assert (fn.bf16.launches, fn.launches) == (n + 1, n32)
            want = ref(*args)
            assert got.dtype == want.dtype == dtype, fn.__name__
            _bf16_close(got, want, fn.__name__)
    # More bins than one block's group of 8: two groups per bin row.
    _bf16_close(prroi.prroi_packed(canvas, rois, 10),
                prroi.prroi_packed_torch(canvas, rois, 10), "S=10")


@pytest.mark.cuda
@pytest.mark.parametrize("bn,splits", [(None, None), (64, 1), (128, 2),
                                       (128, 4)])
def test_bf16_fused_chain_kernel_matches_plain_on_cuda(cuda, bn, splits,
                                                       monkeypatch):
    """B4's bf16 form against its plain version: a chain with the
    projection at a ragged width (2x9x13 frames, Cin=64, M=16, 3
    blocks), one without (Cin=256, M=64), stage 1 at the 384x512 serving
    shape (96x128, Cin=64, M=64, 3 blocks, projection) and stage 3's
    (24x32, 1024 -> M=256, 5 blocks); under the default plan and each
    forced plan (split K through the f32 epilogues too).  One call
    counts one bf16 launch; B8's bound, or twice the spread of the plain
    version on the CPU (another f32 order) over the 15 convs of stage
    3, as chip_smoke.py bounds B8's deep stacks."""
    from tao_amodal_torch.ops import fused_stage
    from tao_amodal_torch.ops import resnet_blocks as rb

    if bn is not None:
        monkeypatch.setattr(rb, "conv_plan", lambda P, cin, cout, ks, item,
                            sms: fused_stage.make_plan(
                                P, cin, cout, ks, bn, splits,
                                rb.SLICE_BYTES // item))
    cases = [((2, 9, 13, 64), 16, 3, True), ((2, 9, 13, 256), 64, 1, False)]
    if bn is None:
        cases += [((2, 96, 128, 64), 64, 3, True),
                  ((2, 24, 32, 1024), 256, 5, False)]
    for case in cases:
        x, params = chain_inputs(cuda, *case, seed=5)
        x = x.to(torch.bfloat16)
        n = fused_stage.fused_bottleneck_chain.bf16.launches
        with torch.no_grad():
            got = fused_stage.fused_bottleneck_chain(x, params)
            torch.cuda.synchronize()
            want = fused_stage.bottleneck_chain_torch(x, params)
        assert fused_stage.fused_bottleneck_chain.bf16.launches == n + 1
        assert got.dtype == want.dtype == torch.bfloat16
        other = None
        if case[2] > 3:
            other = fused_stage.bottleneck_chain_torch(
                x.cpu(), [{k: v.cpu() for k, v in p.items()}
                          for p in params])
        _bf16_close(got, want, case, other)


@pytest.mark.cuda
def test_bf16_kernels_reject_wrong_inputs_on_cuda(cuda):
    """bf16 maps need C % 8 == 0 (16-byte loads); B4's bf16 form needs
    Cin and M multiples of 8 and a projection where the width changes."""
    from tao_amodal_torch.ops import fused_stage, prroi

    canvas, rois = _prroi_inputs(cuda, C=36)
    with pytest.raises(ValueError, match="C % 8"):
        prroi.prroi_packed(canvas.to(torch.bfloat16), rois)
    x, params = chain_inputs(cuda, (2, 9, 13, 64), 12, 2, True)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_stage.fused_bottleneck_chain(x.to(torch.bfloat16), params)
    x, params = chain_inputs(cuda, (2, 9, 13, 64), 32, 2, False)
    with pytest.raises(ValueError, match="projection"):
        fused_stage.fused_bottleneck_chain(x.to(torch.bfloat16), params)
