"""Isolation of the PyTorch port, and its CUDA kernels against their
plain versions.

This file imports neither jax nor the JAX package, so its CUDA tests run
on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_isolation.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports jax).
Tests marked ``cuda`` skip where no CUDA device is present.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

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


def test_wrappers_take_plain_path_on_cpu():
    """CPU tensors go to the plain versions; the launch counters, which
    count kernel launches only, stay at 0."""
    from tao_amodal_torch.ops import prroi, preproc

    before = (preproc.preprocess_frames.launches,
              prroi.prroi_packed.launches)
    args = _preproc_inputs("cpu")
    torch.testing.assert_close(preproc.preprocess_frames(*args),
                               preproc.preprocess_frames_torch(*args),
                               rtol=0, atol=0)
    canvas, rois = _prroi_inputs("cpu")
    torch.testing.assert_close(prroi.prroi_packed(canvas, rois),
                               prroi.prroi_packed_torch(canvas, rois),
                               rtol=0, atol=0)
    assert (preproc.preprocess_frames.launches,
            prroi.prroi_packed.launches) == before == (0, 0)


def test_streaming_runs_with_tf32_off_and_restores_it():
    """TF32: cuDNN convolutions default to TF32 in PyTorch.  The
    pipeline's serving default is full f32: ``streaming`` turns TF32 off
    for convolutions and matmuls while it runs, and restores the
    caller's settings after."""
    from tao_amodal_torch.pipeline import AmodalPipeline

    pipe = AmodalPipeline.create(num_classes=3, num_dets=4,
                                 num_proposals=8,
                                 backbone_stages=(1, 1, 1, 1))
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


def test_wrappers_reject_other_devices():
    from tao_amodal_torch.ops import prroi, preproc

    frames, S, mean, std = _preproc_inputs("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        preproc.preprocess_frames(frames.to("meta"), S, mean, std)
    canvas, rois = _prroi_inputs("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        prroi.prroi_packed(canvas.to("meta"), rois.to("meta"))


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
def test_kernels_reject_wrong_inputs_on_cuda(cuda):
    from tao_amodal_torch.ops import prroi, preproc

    frames, S, mean, std = _preproc_inputs(cuda)
    with pytest.raises(ValueError):
        preproc.preprocess_frames(frames.float(), S, mean, std)
    canvas, rois = _prroi_inputs(cuda)
    with pytest.raises(ValueError):
        prroi.prroi_packed(canvas.double(), rois)
    with pytest.raises(ValueError):
        prroi.prroi_packed(canvas, rois[:1])
