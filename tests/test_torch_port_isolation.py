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
    prroi_edge_rois,
    resnet50_chain_convs,
    resnet50_trunk_convs,
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
        # The RLE codec's host library, built from the port's own source.
        assert "tao_amodal_torch.native.lib" in names
        from tao_amodal_torch.native import lib as native_lib
        assert "tao_amodal_torch" in native_lib.load().path
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
        # The captured serving functions and the fixpoints' wrappers run
        # (eagerly, on the CPU).
        from tao_amodal_torch.ops.hungarian import greedy_fixpoint
        from tao_amodal_torch.ops.nms import nms_fixpoint
        from tao_amodal_torch.pipeline import (
            make_batched_fn, make_inference_fn, make_streaming_fn)
        from tao_amodal_torch.utils import graphs
        infer = make_inference_fn(pipe)
        assert infer(torch.zeros(2, 32, 32, 3))["valid"].shape == (2, 4)
        out, _ = make_streaming_fn(pipe)(torch.zeros(2, 32, 32, 3),
                                         pipe.init_tracker_state())
        out, _ = make_batched_fn(pipe)(torch.zeros(2, 2, 32, 32, 3))
        assert out["valid"].shape == (2, 2, 4)
        assert infer.captured.graphs == {}
        assert isinstance(infer.captured, graphs.CapturedFn)
        assert nms_fixpoint(torch.zeros(3, 3, dtype=torch.bool),
                            torch.ones(3, dtype=torch.bool)).all()
        assert greedy_fixpoint(torch.eye(3)).tolist() == [0, 1, 2]
        # The int8 trunk, RoIAlign, the packed RPN and the GTR loader.
        from tao_amodal_torch.ops.roi import multilevel_roi_align
        from tao_amodal_torch.utils.torch_convert import (
            load_gtr_checkpoint)
        q8 = AmodalPipeline.create(
            num_classes=3, num_dets=4, num_proposals=8,
            backbone_stages=(1, 1, 1, 1), int8_backbone=True,
            device="cpu").init(torch.Generator().manual_seed(0))
        out, _ = q8.batched(torch.zeros(2, 2, 32, 32, 3), score_thr=0.0)
        assert out["scores"].shape == (2, 2, 4)
        feats = [torch.ones(1, 8, n, n) for n in (8, 4)]
        packed = q8.detector.rpn(
            [torch.ones(1, 256, n, n) for n in (8, 4)], packed=True)
        assert [o.shape[1:3] for o in packed[0]] == [(8, 8), (4, 4)]
        pooled = multilevel_roi_align(
            [f.permute(0, 2, 3, 1) for f in feats],
            torch.tensor([[[0.0, 0.0, 20.0, 20.0]]]), strides=(8, 16),
            method="align")
        assert pooled.shape == (1, 1, 7, 7, 8)
        assert callable(load_gtr_checkpoint)
        assert not any(m.split(".")[0] in ("jax", "flax", "PIL")
                       for m in sys.modules)
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_sot_trackers_run_without_jax_flax_pil():
    """With jax, flax, PIL and the JAX package blocked, the Siamese
    trackers track frames given as arrays (PIL reads only frame files),
    the sweep runs, the SOT evaluators score, and the VOT polygon overlap
    comes from the port's own host library (on the CPU, one thread)."""
    script = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL",
                                          "tao_amodal_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from tao_amodal_torch.evaluation.sot_benchmarks import (
            OPEBenchmark, trajectory_overlaps)
        from tao_amodal_torch.trackers.factory import build_tracker
        from tao_amodal_torch.trackers.siamrpn import (
            SiamConfig, make_siamrpn_hp_sweep)
        cfg = SiamConfig(exemplar_size=64, instance_size=128, base_size=0)
        frames = np.stack([np.full((96, 96, 3), 40 * i, np.uint8)
                           for i in range(3)])
        tracker = build_tracker("siammask", config=cfg, device="cpu")
        boxes, scores, _ = tracker.track(list(frames), [30, 30, 20, 20])
        assert boxes.shape == (3, 4) and np.isfinite(boxes).all()
        assert tracker.last_polygon.shape == (8,)
        swept, _ = make_siamrpn_hp_sweep(tracker.model, cfg)(
            torch.from_numpy(frames), [30, 30, 20, 20],
            np.asarray([[0.04, 0.44, 0.4], [0.1, 0.3, 0.2]], np.float32))
        assert swept.shape == (2, 3, 4)
        ope = OPEBenchmark({"s": {"gt_traj": boxes,
                                  "pred_trajs": {"t": boxes}}})
        assert ope.eval_success(["t"])["t"]["s"][0] == 1.0
        ov = trajectory_overlaps([[1.0], list(tracker.last_polygon)],
                                 [boxes[0], boxes[2]])
        assert np.isnan(ov[0]) and 0.0 <= ov[1] <= 1.0
        assert not any(m.split(".")[0] in ("jax", "flax", "PIL")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_sot_training_runs_without_jax_flax_pil():
    """With jax, flax, PIL and the JAX package blocked, the Siamese
    training path runs on the CPU (one thread): the config tree and its
    merges, a ``build_siamese_training`` step on synthetic pairs at 64/128
    (anchor targets, the loss, SGD), the augmentations on their draws,
    the samplers, and a DiMP actor step with its meta-gradient."""
    script = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL",
                                          "tao_amodal_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from tao_amodal_torch.cli.train_cli import (
            build_siamese_training, synthetic_pair_batch)
        from tao_amodal_torch.config import default_config
        from tao_amodal_torch.train.augment import (
            augment_draws, augment_pair)
        from tao_amodal_torch.train.dimp_loss import (
            build_dimp_actor, dimp_actor_loss)
        from tao_amodal_torch.train.sampler import (
            SequenceSampler, TrackPairSampler)
        cfg = default_config().merge_from_list(["track.exemplar_size", 64,
                                                "track.instance_size", 128,
                                                "track.base_size", 0])
        step, state = build_siamese_training(cfg, device="cpu")
        batch = synthetic_pair_batch(np.random.RandomState(0), 2, cfg)
        _, m = step(state, batch, 0)
        assert all(np.isfinite(float(v)) for v in m.values()), m
        g = torch.Generator().manual_seed(0)
        t, x, b = augment_pair(torch.from_numpy(batch["template"]),
                               torch.from_numpy(batch["search"]),
                               torch.from_numpy(batch["box"]),
                               augment_draws(2, g))
        assert x.shape == (2, 128, 128, 3) and b.shape == (2, 4)

        class Src:
            num_tracks = 3
            def track_frames(self, t):
                return list(range(8))
        pair = TrackPairSampler([Src()], seed=0).sample()
        seq = SequenceSampler([Src()], seed=0).sample()
        assert len(seq["train_frames"]) == 3 and "is_negative" in pair
        fn, _, iou = build_dimp_actor(search_size=64,
                                      stage_sizes=(1, 1, 1, 1),
                                      device="cpu")
        imgs = torch.rand(1, 2, 64, 64, 3) * 255
        box = torch.tensor([16.0, 16.0, 48.0, 48.0]).expand(1, 2, 4)
        loss, _ = dimp_actor_loss(fn, iou, {
            "train_images": imgs, "test_images": imgs,
            "train_boxes": box, "test_boxes": box}, num_gn_iters=1,
            num_cg_iters=2)
        (gw,) = torch.autograd.grad(loss, [iou.Dense_0.weight])
        assert torch.isfinite(gw).all()
        assert not any(m.split(".")[0] in ("jax", "flax", "PIL")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_eval_entry_points_run_without_jax_flax_tabulate():
    """With jax, flax, tabulate and the JAX package blocked, the
    evaluation package, the eval CLI and its tool script import, and the
    tool scores a small fixture on the host and with ``--device_eval
    --device cpu``, to the same log."""
    script = textwrap.dedent("""
        import json, os, runpy, sys, tempfile

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "tabulate", "tao_amodal_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        sys.path[:0] = [".", "tests"]
        import tao_amodal_torch.evaluation
        import tao_amodal_torch.cli.eval_cli
        from fixture_gen import make_fixture

        tmp = tempfile.mkdtemp()
        gt, preds = make_fixture(seed=3, num_videos=2, frames_per_video=8)
        for name, obj in (("gt", gt), ("preds", preds)):
            with open(os.path.join(tmp, name + ".json"), "w") as f:
                json.dump(obj, f)
        logs = []
        for extra in ([], ["--device_eval", "--device", "cpu"]):
            log = os.path.join(tmp, f"eval{len(logs)}.log")
            sys.argv = ["eval_on_tao_amodal_torch.py", "--track_result",
                        os.path.join(tmp, "preds.json"), "--output_log",
                        log, "--annotation", os.path.join(tmp, "gt.json"),
                        *extra]
            runpy.run_path("tools/eval_on_tao_amodal_torch.py",
                           run_name="__main__")
            logs.append(open(log).read())
        assert logs[0] == logs[1] and logs[0].count("copypaste:") == 4
        # segm: the gt's triangles through the port's RLE codec, host
        # and device (CPU) evaluators.
        from tao_amodal_torch.data.results import make_track_ids_unique
        from tao_amodal_torch.evaluation import (
            DeviceTrackEval, TrackMapEvaluator)
        make_track_ids_unique(preds)
        for ann in gt["annotations"]:
            x, y, w, h = ann["bbox"]
            ann["segmentation"] = [[x, y, x, y + h, x + w, y + h]]
        host = TrackMapEvaluator(gt, preds, iou_type="segm")
        dev = DeviceTrackEval(gt, preds, iou_type="segm", device="cpu")
        host.run()
        dev.run()
        h, d = host.get_results(), dev.get_results()
        assert max(abs(h[k] - d[k]) for k in h) < 2e-3
        assert not any(m.split(".")[0] in ("jax", "flax", "tabulate")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_study_and_host_tools_run_without_jax_flax_pil():
    """With jax, flax, PIL and the JAX package blocked, the accuracy
    study trains and serves on the CPU (two steps with PasteNOcclude,
    two cells), the stress evaluator runs its device evaluators on the
    CPU, and the checkpoint, profiling, fs and converter modules work."""
    script = textwrap.dedent("""
        import os, sys, tempfile

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL",
                                          "tao_amodal_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from tao_amodal_torch.cli import accuracy_study, stress_eval
        from tao_amodal_torch.data import converters
        from tao_amodal_torch.utils import checkpoint, fs, profiling
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "study.json")
            res = accuracy_study.main([
                "--cpu", "--hw", "64", "--videos_train", "1",
                "--videos_val", "1", "--frames", "4", "--tracks", "2",
                "--num_dets", "4", "--train_steps", "2", "--batch", "2",
                "--resolutions", "64", "--skip_exact",
                "--expander_ablation", "--paste_n_occlude",
                "--assignments", "greedy", "--score_threshold", "0.0",
                "--workdir", tmp, "--out", out])
            assert sorted(res) == ["ckpt2_res64", "ckpt2_res64_noexpander"]
            assert res["ckpt2_res64"]["num_predictions"] > 0
            flat = checkpoint.load_flat(os.path.join(tmp, "ckpt_2.npz"))
            assert all(np.isfinite(v).all() for v in flat.values())
            tree = checkpoint.load_pytree(os.path.join(tmp, "ckpt_2.npz"))
            assert set(tree) == {"detector", "expander"}
            summary = stress_eval.main([
                "--cpu", "--device_eval", "--num_videos", "2",
                "--frames_per_video", "4", "--num_cats", "3"])
            assert summary["gt_anns"] > 0
            with profiling.device_trace(os.path.join(tmp, "tr")):
                torch.ones(2) + 1
            assert os.path.exists(os.path.join(tmp, "tr", "trace.json"))
            assert fs.parse_bool("yes") and converters.list_datasets() == []
        assert not any(m.split(".")[0] in ("jax", "flax", "PIL")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_vis_tools_run_without_jax_flax_cv2_imageio_matplotlib():
    """With jax, flax, cv2, imageio, matplotlib and the JAX package
    blocked on sys.meta_path, ``tools/vis_prediction_torch.py``,
    ``tools/demo_burst_torch.py`` and ``tools/run_video_torch.py --cpu``
    run; their ``.mp4`` outputs fall back to PNG frame directories."""
    script = textwrap.dedent("""
        import json, os, runpy, sys, tempfile

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "cv2",
                                          "imageio", "matplotlib",
                                          "tao_amodal_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        from PIL import Image
        torch.set_num_threads(1)
        from tao_amodal_torch.ops import mask as mask_ops
        from tao_amodal_torch.trackers import factory
        from tao_amodal_torch.trackers.siamrpn import (
            SiamConfig, SiamRPNTracker)

        def tool(name):
            return runpy.run_path(os.path.join("tools", name))["main"]

        rs = np.random.RandomState(0)
        with tempfile.TemporaryDirectory() as tmp:
            imgs, anns = [], []
            for f in range(2):
                name = f"v/{f:04d}.png"
                os.makedirs(os.path.join(tmp, "v"), exist_ok=True)
                Image.fromarray(rs.randint(0, 256, (48, 64, 3)).astype(
                    np.uint8)).save(os.path.join(tmp, name))
                imgs.append({"id": f + 1, "video_id": 1, "file_name": name,
                             "frame_index": f, "width": 64, "height": 48})
                anns.append({"id": f + 1, "image_id": f + 1, "track_id": 1,
                             "category_id": 1, "score": 0.9,
                             "bbox": [5.0 + f, 6.0, 30.0, 20.0]})
            gt = {"videos": [{"id": 1, "name": "v", "width": 64,
                              "height": 48}], "images": imgs,
                  "annotations": anns,
                  "tracks": [{"id": 1, "category_id": 1, "video_id": 1}],
                  "categories": [{"id": 1, "name": "person"}]}
            for n, d in (("gt.json", gt), ("p.json", anns)):
                with open(os.path.join(tmp, n), "w") as fh:
                    json.dump(d, fh)
            sys.argv = ["vis", "--annotation", os.path.join(tmp, "gt.json"),
                        "--prediction", os.path.join(tmp, "p.json"),
                        "--images_dir", tmp, "--output_dir",
                        os.path.join(tmp, "out"), "--transparent"]
            runpy.run_path("tools/vis_prediction_torch.py",
                           run_name="__main__")
            assert len(os.listdir(os.path.join(tmp, "out", "v_frames"))) == 2
            m = np.zeros((48, 64), np.uint8, order="F")
            m[10:30, 20:40] = 1
            rle = mask_ops.encode(m)["counts"].decode()
            burst = {"sequences": [{
                "dataset": "d", "seq_name": "s", "height": 48, "width": 64,
                "segmentations": [{"1": {"rle": rle}}],
                "track_category_ids": {"1": 1},
                "annotated_image_paths": ["0000.png"]}]}
            with open(os.path.join(tmp, "burst.json"), "w") as fh:
                json.dump(burst, fh)
            tool("demo_burst_torch.py")([
                "--annotations", os.path.join(tmp, "burst.json"),
                "--output_dir", os.path.join(tmp, "burst")])
            assert os.listdir(os.path.join(tmp, "burst")) == ["00000.png"]
            factory.build_tracker = lambda name, device: SiamRPNTracker(
                factory.seeded_model(0, device), SiamConfig(
                    exemplar_size=64, instance_size=128, base_size=0,
                    stride=8))
            tool("run_video_torch.py")([
                "siamrpn", os.path.join(tmp, "v"), "--init_box",
                "10,10,20,20", "--output", os.path.join(tmp, "t.mp4"),
                "--boxes_out", os.path.join(tmp, "b.txt"), "--cpu"])
            assert len(os.listdir(os.path.join(tmp, "t_frames"))) == 2
            assert np.loadtxt(os.path.join(tmp, "b.txt"),
                              delimiter=",").shape == (2, 5)
        assert not any(m.split(".")[0] in ("jax", "flax", "cv2", "imageio",
                                           "matplotlib")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_sources_never_import_jax_or_flax():
    """No module of the port (``native/`` and the visualization modules
    included), no ``tools/*_torch.py`` (the vis tools included) and no
    line of ``chip_smoke.py`` imports jax, flax or the JAX package, and no
    source of the port names the JAX package's native library."""
    tools = os.path.join(REPO, "tools")
    scripts = [os.path.join(tools, f) for f in sorted(os.listdir(tools))
               if f.endswith("_torch.py")]
    paths = [os.path.join(root, f) for root, _, files in os.walk(PKG)
             for f in files] + scripts + [os.path.join(REPO, "chip_smoke.py")]
    scanned = set()
    for path in paths:
        f = os.path.basename(path)
        if f.endswith(".py"):
            scanned.add(os.path.relpath(os.path.dirname(path), REPO))
            with open(path) as fh:
                for line in fh:
                    s = line.strip()
                    assert not s.startswith((
                        "import jax", "from jax", "import flax",
                        "from flax", "import tao_amodal_tpu",
                        "from tao_amodal_tpu")), (path, s)
        if path.startswith(PKG) and f.endswith((".py", ".cc", ".cu")):
            with open(path) as fh:
                assert "libtao_native" not in fh.read(), path
    assert {"tao_amodal_torch/native", "tao_amodal_torch/trackers",
            "tools", "."} <= scanned
    assert {"run_tracker_torch.py", "eval_sot_torch.py",
            "hp_search_torch.py", "accuracy_study_torch.py",
            "scale_rehearsal_torch.py", "stress_eval_torch.py",
            "make_dayone_fixture_torch.py", "vis_prediction_torch.py",
            "vis_prediction_comparison_torch.py",
            "vis_amodal_mask_videos_torch.py", "demo_burst_torch.py",
            "run_video_torch.py"} <= {
                os.path.basename(p) for p in scripts}
    vis = {os.path.join(PKG, *f.split("/")) for f in (
        "cli/vis_cli.py", "data/burst.py", "evaluation/lvis_vis.py",
        "evaluation/sot_plots.py", "utils/colormap.py",
        "utils/interpolation.py", "utils/raster.py", "utils/vis.py",
        "utils/vis_ref.py", "utils/video.py")}
    assert vis <= set(paths)


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
    from tao_amodal_torch.ops import (
        fused_stage,
        hungarian,
        nms,
        preproc,
        prroi,
        sort_scan,
    )
    from tao_amodal_torch.trackers.sort import init_sort

    counters = (preproc.preprocess_frames, prroi.prroi_packed,
                fused_stage.fused_bottleneck_chain,
                sort_scan.sort_scan_pallas, nms.nms_fixpoint,
                hungarian.greedy_fixpoint)
    for f in counters:  # kernel tests earlier in the process count too
        f.launches = 0
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
    rs = np.random.RandomState(0)
    sup = torch.from_numpy(rs.rand(2, 9, 9) > 0.6).triu(1)
    valid = torch.from_numpy(rs.rand(2, 9) > 0.2)
    assert torch.equal(nms.nms_fixpoint(sup, valid),
                       nms.nms_fixpoint_torch(sup, valid))
    b = torch.from_numpy(rs.rand(6, 5).astype(np.float32))
    assert torch.equal(hungarian.greedy_fixpoint(b),
                       hungarian.greedy_fixpoint_torch(b))
    assert (tuple(f.launches for f in counters) == before
            == (0, 0, 0, 0, 0, 0))


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
    from tao_amodal_torch.ops import (
        fused_stage,
        hungarian,
        nms,
        preproc,
        prroi,
        sort_scan,
    )
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
    with pytest.raises(ValueError, match="unsupported device"):
        nms.nms_fixpoint(torch.zeros(2, 2, dtype=torch.bool, device="meta"),
                         torch.ones(2, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        hungarian.greedy_fixpoint(torch.zeros(2, 3, device="meta"))


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


def test_int8_conv_wrapper_takes_plain_path_on_cpu():
    """The int8 trunk conv on CPU tensors is its plain version (counter
    at 0); another device raises."""
    from tao_amodal_torch.ops import int8_conv

    x8, w8, scale = _int8_conv_inputs("cpu", 2, 9, 11, 3, 16, 7)
    before = int8_conv.int8_conv.launches
    assert torch.equal(int8_conv.int8_conv(x8, w8, scale, 2, 3),
                       int8_conv.int8_conv_reference(x8, w8, scale, 2, 3))
    assert int8_conv.int8_conv.launches == before == 0
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv.int8_conv(x8.to("meta"), w8.to("meta"), scale.to("meta"),
                            2, 3)


def _int8_conv_inputs(device, T, H, W, cin, cout, ks, seed=0):
    """int8 NHWC ``x8``, HWIO ``w8`` and an f32 scale (``s_x * s_w``-
    sized) on ``device``."""
    rs = np.random.RandomState(seed)
    x8 = rs.randint(-127, 128, (T, H, W, cin)).astype(np.int8)
    w8 = rs.randint(-127, 128, (ks, ks, cin, cout)).astype(np.int8)
    scale = rs.uniform(1e-6, 1e-4, cout).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x8, w8, scale))


def _write_png(path, rgb):
    """An RGB uint8 image file (PIL, imported here: the card's machine
    has it, and the port imports it only to read frame files)."""
    from PIL import Image

    Image.fromarray(rgb).save(path)


def _default_device_calls():
    """name -> (the entry point, a call that leaves ``device`` at its
    default and returns the device of what it built)."""
    import tempfile

    from tao_amodal_torch.cli.train_cli import build_siamese_training
    from tao_amodal_torch.cli.train_detector_cli import main as train_main
    from tao_amodal_torch.data.loader import device_feed
    from tao_amodal_torch.models.backbones import AlexNet, MobileNetV2
    from tao_amodal_torch.models.rpn import level_anchors
    from tao_amodal_torch.models.siamese import SiameseTracker
    from tao_amodal_torch.pipeline import AmodalPipeline
    from tao_amodal_torch.trackers.deep_features import (
        build_deep_atom,
        build_deep_dimp,
        build_deep_eco,
    )
    from tao_amodal_torch.trackers.factory import (
        _REGISTRY,
        build_tracker,
        seeded_model,
    )
    from tao_amodal_torch.trackers.siammask import make_siammask_step
    from tao_amodal_torch.trackers.siamrpn import (
        make_siamrpn_hp_sweep,
        make_siamrpn_step,
    )
    from tao_amodal_torch.trackers.sort import Sort, init_sort
    from tao_amodal_torch.train.anchor_target import anchor_draws
    from tao_amodal_torch.train.augment import augment_draws
    from tao_amodal_torch.train.dimp_loss import build_dimp_actor
    from tao_amodal_torch.train.optim import make_adamw
    from tao_amodal_torch.train.paste_n_occlude import (
        synthetic_occluder_bank,
    )
    from tao_amodal_torch.train.step import make_train_step

    def tiny():
        return AmodalPipeline.create(num_classes=3, num_dets=4,
                                     num_proposals=8,
                                     backbone_stages=(1, 1, 1, 1))

    def sot_cli():
        # No --cpu: the CLI tracks on the card.
        from unittest import mock

        from tao_amodal_torch.cli import sot_cli as cli

        with tempfile.TemporaryDirectory() as tmp, mock.patch.object(
                cli, "run_dataset", wraps=cli.run_dataset) as run:
            d = os.path.join(tmp, "seq", "img")
            os.makedirs(d)
            for i in range(2):
                _write_png(os.path.join(d, f"{i:04d}.png"),
                           np.full((48, 64, 3), 60 * i, np.uint8))
            np.savetxt(os.path.join(tmp, "seq", "groundtruth_rect.txt"),
                       [[10, 10, 20, 20]] * 2, delimiter=",")
            cli.main(["--dataset", "otb", "--dataset_root", tmp,
                      "--result_dir", os.path.join(tmp, "out")])
        return run.call_args[0][0].model.device

    def run_video():
        # No --cpu: tools/run_video_torch.py tracks on the card.
        import runpy
        from unittest import mock

        from tao_amodal_torch.trackers import factory

        main = runpy.run_path(os.path.join(REPO, "tools",
                                           "run_video_torch.py"))["main"]
        with tempfile.TemporaryDirectory() as tmp, mock.patch.object(
                factory, "build_tracker",
                wraps=factory.build_tracker) as build:
            for i in range(2):
                _write_png(os.path.join(tmp, f"{i:04d}.png"),
                           np.full((48, 64, 3), 60 * i, np.uint8))
            main(["siamrpn", tmp, "--init_box", "10,10,20,20", "--output",
                  os.path.join(tmp, "out")])
        return torch.device(build.call_args.kwargs["device"])

    def train_cli():
        # No --cpu: the CLI trains on the card.
        with tempfile.TemporaryDirectory() as tmp:
            trainer = train_main(["--smoke", "--batch_size", "2",
                                  "--checkpoint_dir", tmp])
        return trainer.state.model.device

    def siamese_cli():
        # No --cpu: the Siamese CLI trains on the card.
        from tao_amodal_torch.cli.train_cli import main as siamese_main

        with tempfile.TemporaryDirectory() as tmp:
            trainer = siamese_main(["--smoke", "--checkpoint_dir", tmp])
        return trainer.state.model.device

    def accuracy_study():
        # No --cpu: the study trains and serves on the card.
        from unittest import mock

        from tao_amodal_torch.cli import accuracy_study as study

        with tempfile.TemporaryDirectory() as tmp, mock.patch.object(
                study, "make_streaming_fn",
                wraps=study.make_streaming_fn) as serve:
            study.main(["--hw", "64", "--videos_train", "1",
                        "--videos_val", "1", "--frames", "2",
                        "--num_dets", "4", "--train_steps", "1",
                        "--batch", "1", "--resolutions", "64",
                        "--skip_exact", "--score_threshold", "0.0",
                        "--workdir", tmp,
                        "--out", os.path.join(tmp, "study.json")])
        return serve.call_args[0][0].device

    def scale_rehearsal():
        # No --cpu: the rehearsal's inference CLI runs on the card.
        from unittest import mock

        import tao_amodal_torch.pipeline as pipeline_mod
        from tao_amodal_torch.cli.scale_rehearsal import main

        with tempfile.TemporaryDirectory() as tmp, mock.patch.object(
                pipeline_mod, "make_streaming_fn",
                wraps=pipeline_mod.make_streaming_fn) as serve:
            main(["--videos", "1", "--frames", "2", "--hw", "64",
                  "--tracks", "1", "--input_size", "64", "--num_dets", "4",
                  "--num_proposals", "8", "--score_threshold", "0.0",
                  "--workdir", tmp, "--out", os.path.join(tmp, "r.json")])
        return serve.call_args[0][0].device

    def tool(name):
        import importlib

        if REPO not in sys.path:
            sys.path.insert(0, REPO)
        return importlib.import_module(f"tools.{name}")

    def dryrun():
        # No device argument: the dryrun's ranks run on the card.
        import torch

        return torch.device(tool("dryrun_multichip_torch").dryrun_multichip(
            2, threads=1)["device"])

    def multiprocess_smoke():
        # No --device, no --cpu: the smoke's ranks run on the card; rank 0
        # runs in this process, where its step is seen.
        from unittest import mock

        smoke = tool("multiprocess_smoke_torch")
        with mock.patch.object(smoke, "_train_step",
                               wraps=smoke._train_step) as step:
            assert smoke.main([]) == 0
        return step.call_args[0][0].device

    def siamese_cfg():
        from tao_amodal_torch.config import default_config

        cfg = default_config()
        cfg.track.exemplar_size, cfg.track.instance_size = 64, 128
        cfg.track.base_size = 0
        return cfg

    return {
        # The step trains where the pipeline is.
        "make_train_step": (AmodalPipeline.create, lambda: make_train_step(
            tiny(), make_adamw(1e-3)).device),
        # The CLI has no device argument: --cpu asks for the CPU.
        "train_detector_cli": (None, train_cli),
        "synthetic_occluder_bank": (synthetic_occluder_bank, lambda: (
            synthetic_occluder_bank(num=2, patch_size=8).device)),
        "device_feed": (device_feed, lambda: next(device_feed(
            [{"x": np.zeros(2)}]))["x"].device),
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
        # The Siamese trackers build and track where their model is.
        "SiameseTracker": (SiameseTracker, lambda: SiameseTracker().device),
        "build_tracker": (seeded_model, lambda: build_tracker(
            "siammask").model.device),
        "make_siamrpn_step": (SiameseTracker, lambda: make_siamrpn_step(
            SiameseTracker())[1].core.anchors.device),
        "make_siamrpn_hp_sweep": (SiameseTracker, lambda: (
            make_siamrpn_hp_sweep(SiameseTracker()).core.window.device)),
        "make_siammask_step": (SiameseTracker, lambda: make_siammask_step(
            SiameseTracker(with_mask=True, with_refine=True))[1]
            .core.device),
        # The SOT CLI has no device argument: --cpu asks for the CPU.
        "sot_cli": (None, sot_cli),
        "run_video": (None, run_video),
        # The discriminative trackers build and track on their device.
        "eco": (_REGISTRY["eco"], lambda: build_tracker(
            "eco").window.device),
        "atom": (_REGISTRY["atom"], lambda: build_tracker(
            "atom").window.device),
        "dimp": (_REGISTRY["dimp"], lambda: build_tracker(
            "dimp", extractor_fn=lambda crop: crop[::16, ::16],
            search_size=64).iou_net.Dense_0.weight.device),
        "atom_deep": (build_deep_atom, lambda: build_tracker(
            "atom_deep", stage_sizes=(1, 1, 1, 1)).window.device),
        "eco_deep": (build_deep_eco, lambda: build_tracker(
            "eco_deep", stage_sizes=(1, 1, 1, 1)).window.device),
        "dimp_deep": (build_deep_dimp, lambda: build_tracker(
            "dimp_deep", search_size=64, stage_sizes=(1, 1, 1, 1))
            .iou_net.Dense_0.weight.device),
        # Siamese training builds, draws and trains on the card.
        "build_siamese_training": (build_siamese_training, lambda: (
            build_siamese_training(siamese_cfg())[0].device)),
        "anchor_draws": (anchor_draws, lambda: anchor_draws(2, 5)[
            "pos"].device),
        "augment_draws": (augment_draws, lambda: augment_draws(2)[
            "shift"].device),
        "train_siamese_cli": (None, siamese_cli),
        # The DiMP actor's models (its loss draws nothing: its box jitter
        # is fixed, as JAX's).
        "build_dimp_actor": (build_dimp_actor, lambda: build_dimp_actor(
            search_size=64, stage_sizes=(1, 1, 1, 1))[2].Dense_0.weight
            .device),
        # The study and the rehearsal have no device argument: --cpu
        # asks for the CPU.
        "accuracy_study": (None, accuracy_study),
        "scale_rehearsal": (None, scale_rehearsal),
        # The pysot trunks build where they are asked, the card by default.
        "AlexNet": (AlexNet, lambda: AlexNet(width_mult=0.25).Conv_0
                    .weight.device),
        "MobileNetV2": (MobileNetV2, lambda: MobileNetV2(
            width_mult=0.25).ConvBN_0.Conv_0.weight.device),
        # The scale-out tools: --device cpu (the smoke's --cpu) asks for
        # the CPU.
        "dryrun_multichip": (tool("dryrun_multichip_torch")
                             .dryrun_multichip, dryrun),
        "multiprocess_smoke": (None, multiprocess_smoke),
    }


@pytest.mark.parametrize("name", ["AmodalPipeline.create",
                                  "AmodalPipeline.batched", "init_sort",
                                  "Sort", "level_anchors", "make_train_step",
                                  "train_detector_cli",
                                  "synthetic_occluder_bank", "device_feed",
                                  "SiameseTracker", "build_tracker",
                                  "make_siamrpn_step",
                                  "make_siamrpn_hp_sweep",
                                  "make_siammask_step", "sot_cli",
                                  "run_video", "eco",
                                  "atom", "dimp", "atom_deep", "eco_deep",
                                  "dimp_deep", "build_siamese_training",
                                  "anchor_draws", "augment_draws",
                                  "train_siamese_cli", "build_dimp_actor",
                                  "accuracy_study", "scale_rehearsal",
                                  "AlexNet", "MobileNetV2",
                                  "dryrun_multichip", "multiprocess_smoke"])
def test_entry_points_default_to_the_card(name):
    """The port's entry points build on the card unless the caller passes
    ``device="cpu"`` (the train CLI: ``--cpu``); without a card they raise
    rather than hand back CPU tensors.  Whether there is a card is decided
    here, at run time."""
    fn, call = _default_device_calls()[name]
    if fn is not None:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert call().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_make_inference_fn_captures_on_the_card_only():
    """``make_inference_fn`` builds its CUDA graph on the card: a CPU
    pipeline runs eagerly and keeps no graph; a pipeline on the card (where
    there is one) captures one graph at its first clip's geometry.
    Whether there is a card is decided here, at run time."""
    from tao_amodal_torch.pipeline import AmodalPipeline, make_inference_fn

    def infer(device):
        pipe = AmodalPipeline.create(
            num_classes=3, num_dets=4, num_proposals=8,
            backbone_stages=(1, 1, 1, 1), device=device).init(
                torch.Generator(device=device).manual_seed(0))
        run = make_inference_fn(pipe)
        out = run(torch.zeros(2, 32, 32, 3, device=device))
        return run, out

    run, out = infer("cpu")
    assert run.captured.graphs == {} and out["valid"].device.type == "cpu"
    if torch.cuda.is_available():
        run, out = infer("cuda")
        assert len(run.captured.graphs) == 1
        assert out["valid"].device.type == "cuda"


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
    return prroi_edge_rois(Hc, Wc)[:10]


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
@pytest.mark.parametrize("S", [1, 7, 14])
def test_bf16_prroi_kernels_edge_rois_match_plain_on_cuda(cuda, S):
    """The bf16 forms of B2, B5 and B6 (one block per RoI, each bin
    summed over its own support) against their plain versions by B8's
    rule on the 384x512 serving canvas's geometry (48 rows, 98 columns
    for B2 and B6, padded to 112 for B5), at S = 1, 7 and 14 bins a
    side: RoIs outside the canvas, of zero size, crossing its edges,
    spanning all of its 98 or 112 columns and more, and small ones; each
    call counts one bf16 launch."""
    from tao_amodal_torch.ops import prroi

    T, Hc = 2, 48
    rs = np.random.RandomState(S)
    for Wc, fn, ref, dtype in (
            (98, prroi.prroi_packed, prroi.prroi_packed_torch,
             torch.bfloat16),
            (112, prroi.prroi_packed_pallas, prroi.prroi_packed_pallas_torch,
             torch.bfloat16),
            (98, prroi.prroi_pool_pallas, prroi.prroi_pool_pallas_torch,
             torch.float32)):
        canvas = torch.from_numpy(rs.randn(T, Hc, Wc, 256).astype(
            np.float32)).to(cuda).to(torch.bfloat16)
        rois = torch.tensor([prroi_edge_rois(Hc, Wc)] * T, device=cuda)
        rois[1] += 0.37
        n = fn.bf16.launches
        got = fn(canvas, rois, S)
        torch.cuda.synchronize()
        assert fn.bf16.launches == n + 1
        want = ref(canvas, rois, S)
        assert got.dtype == want.dtype == dtype, fn.__name__
        assert got.shape == (T, rois.shape[1], S, S, 256)
        _bf16_close(got, want, f"{fn.__name__} S={S} W={Wc}")


@pytest.mark.cuda
@pytest.mark.parametrize("bn,splits", [(None, None), (64, 1), (128, 1),
                                       (64, 2), (128, 2), (128, 4)])
def test_bf16_fused_chain_kernel_matches_plain_on_cuda(cuda, bn, splits,
                                                       monkeypatch):
    """B4's bf16 form (the wgmma conv of ``csrc/conv_sm90.cu``) against
    its plain version: a chain with the projection at a ragged width
    (2x9x13 frames, Cin=64, M=16, 3 blocks), one without (Cin=256,
    M=64), stage 1 at the 384x512 serving shape (96x128, Cin=64, M=64, 3
    blocks, projection) and stage 3's (24x32, 1024 -> M=256, 5 blocks);
    under the default plan and each tile width and split the plan can
    pick, forced (split K through the f32 epilogues too).  One call
    counts one bf16 launch; B8's bound, or twice the spread of the plain
    version on the CPU (another f32 order) over the 15 convs of stage
    3, as chip_smoke.py bounds B8's deep stacks."""
    from tao_amodal_torch.ops import conv_sm90, fused_stage

    if bn is not None:
        monkeypatch.setattr(conv_sm90, "conv_plan", lambda P, cin, cout, ks,
                            item, sms: fused_stage.make_plan(
                                P, cin, cout, ks, bn, splits,
                                conv_sm90.SLICE_BYTES // item))
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


@pytest.mark.cuda
def test_device_evaluators_on_cuda_match_the_host(cuda, tmp_path):
    """The device evaluators on the card against the float64 host
    oracle within 2e-3 (``tests/test_device_eval.py``), and the eval CLI
    with ``--device_eval`` on the card to the host's log."""
    import json

    from fixture_gen import make_fixture
    from tao_amodal_torch.cli.eval_cli import main as eval_main
    from tao_amodal_torch.data.results import make_track_ids_unique
    from tao_amodal_torch.evaluation import (
        AmodalDetectionEvaluator,
        DeviceDetectionEval,
        DeviceTrackEval,
        TrackMapEvaluator,
    )

    gt, preds = make_fixture(seed=4, num_videos=4, frames_per_video=16)
    make_track_ids_unique(preds)
    gt_path, pred_path = tmp_path / "gt.json", tmp_path / "preds.json"
    gt_path.write_text(json.dumps(gt))
    pred_path.write_text(json.dumps(preds))
    for dev_cls, host_cls, args in (
            (DeviceTrackEval, TrackMapEvaluator, ()),
            (DeviceDetectionEval, AmodalDetectionEvaluator, ("bbox",))):
        host = host_cls(str(gt_path), str(pred_path), *args)
        host.run()
        dev = dev_cls(str(gt_path), str(pred_path), *args, device=cuda)
        dev.run()
        h, d = host.get_results(), dev.get_results()
        assert list(h) == list(d)
        for k in h:
            assert abs(h[k] - d[k]) < 2e-3, (k, h[k], d[k])
    logs = []
    for extra in ([], ["--device_eval"]):
        log = tmp_path / f"eval{len(logs)}.log"
        eval_main(["--track_result", str(pred_path), "--output_log",
                   str(log), "--annotation", str(gt_path), *extra])
        logs.append(log.read_text())
    assert logs[0] == logs[1]


# The trunk conv's cases: (T, H, W, Cin, Cout, ks, stride).  The classic
# stem (Cin 3, padded to 16 in the wrapper; 7x7/2) and the s2d stems'
# 3x3 from 48, the strided 3x3 and projection, odd frames (a stride-2
# window's last row past the frame), Cout not a multiple of the tile
# width, P not a multiple of the 128-pixel tile.
INT8_CONV_CASES = ((2, 19, 22, 3, 64, 7, 2), (2, 9, 7, 48, 64, 3, 1),
                   (2, 10, 11, 32, 48, 3, 2), (2, 9, 9, 64, 80, 1, 2),
                   (1, 5, 6, 96, 16, 1, 1), (1, 16, 16, 512, 512, 3, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_CONV_CASES)
def test_int8_conv_kernel_matches_plain_on_cuda(cuda, case):
    """The int8 trunk conv (``tao_conv_s8_sm90``) equals its plain
    version on the card bit for bit (exact int32 sums, the same f32
    dequantization), in f32 and bf16 out; one launch per call."""
    from tao_amodal_torch.ops import int8_conv

    T, H, W, cin, cout, ks, stride = case
    x8, w8, scale = _int8_conv_inputs(cuda, T, H, W, cin, cout, ks)
    for out_dtype in (torch.float32, torch.bfloat16):
        n = int8_conv.int8_conv.launches
        got = int8_conv.int8_conv(x8, w8, scale, stride, (ks - 1) // 2,
                                  out_dtype)
        torch.cuda.synchronize()
        assert int8_conv.int8_conv.launches == n + 1
        want = int8_conv.int8_conv_reference(x8, w8, scale, stride,
                                             (ks - 1) // 2, out_dtype)
        assert got.dtype == out_dtype and got.shape == want.shape
        assert torch.equal(got, want), (case, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bn,splits", [(64, 1), (128, 1), (64, 2),
                                       (128, 2), (128, 4)])
def test_int8_conv_plans_match_plain_on_cuda(cuda, bn, splits,
                                             monkeypatch):
    """Every tile width and K split forced on the trunk conv's ragged
    cases: equal to the plain version (int32 partial sums are exact in
    any order)."""
    from tao_amodal_torch.ops import conv_sm90, fused_stage, int8_conv

    monkeypatch.setattr(conv_sm90, "conv_plan", lambda P, cin, cout, ks,
                        itemsize, sms: fused_stage.make_plan(
                            P, cin, cout, ks, bn, splits,
                            conv_sm90.SLICE_BYTES))
    for T, H, W, cin, cout, ks, stride in INT8_CONV_CASES:
        x8, w8, scale = _int8_conv_inputs(cuda, T, H, W, cin, cout, ks, 1)
        got = int8_conv.int8_conv(x8, w8, scale, stride, (ks - 1) // 2)
        want = int8_conv.int8_conv_reference(x8, w8, scale, stride,
                                             (ks - 1) // 2)
        assert torch.equal(got, want), (H, W, cin, cout, ks, bn, splits)


@pytest.mark.cuda
def test_int8_conv_rejects_wrong_inputs_on_cuda(cuda):
    """A dilation-free kernel size, stride and padding the kernel has, an
    int8 input, Cout a multiple of 16, an f32 scale beside the input."""
    from tao_amodal_torch.ops import int8_conv

    x8, w8, scale = _int8_conv_inputs(cuda, 1, 8, 8, 16, 32, 3)
    for args, match in (((x8, w8, scale, 1, 0), "pad"),
                        ((x8, w8, scale, 3, 1), "stride"),
                        ((x8.float(), w8, scale, 1, 1), "int8"),
                        ((x8, w8[..., :24], scale[:24], 1, 1), "Cout"),
                        ((x8, w8, scale.cpu(), 1, 1), "scale")):
        with pytest.raises(ValueError, match=match):
            int8_conv.int8_conv(*args)


# ---------------------------------------------------------------------
# The Hopper convolutions (csrc/conv_sm90.cu): B4's bf16 form and the
# int8 trunk conv with its quantization.
# ---------------------------------------------------------------------

# (stage, Cin, Cout, ks) -> K splits of the bf16 chains' plans at the
# 384x512 trunk, T=8, and (stage, Cin, Cout, ks, stride) -> those of the
# int8 trunk's at 512^2, T=8; every other conv unsplit.
SM90_BF16_SPLITS = {(3, 256, 256, 3): 2, (4, 2048, 512, 1): 2,
                    (4, 512, 512, 3): 4}
SM90_INT8_SPLITS = {(4, 512, 512, 3, 2): 2, (4, 512, 512, 3, 1): 2}


def _check_sm90_plan(plan, P, cin, cout, ks, itemsize):
    """A tile the kernel has (64 wide iff Cout <= 64), K in whole 128-byte
    slices split into ranges that cover it with none empty and none under
    ``MIN_SPLIT_SLICES`` deep, the workspace of the partial sums, and a
    grid that fills at least 90 % of the blocks 132 SMs hold unless one
    more split would make a range shorter than that."""
    from tao_amodal_torch.ops import conv_sm90 as cs

    bk = cs.SLICE_BYTES // itemsize
    nk = -(-ks * ks * cin // bk)
    assert plan.bn == (64 if cout <= 64 else 128)
    assert (plan.splits - 1) * plan.slices < nk <= plan.splits * plan.slices
    assert plan.splits == 1 or plan.slices >= cs.MIN_SPLIT_SLICES
    assert plan.workspace == (plan.splits * P * cout if plan.splits > 1
                              else 0)
    tiles = cs.tiles(P, cout, plan.bn, itemsize)
    assert tiles == -(-P // cs.BM[itemsize]) * -(-cout // plan.bn)
    slots = cs.BLOCKS_PER_SM[itemsize] * 132
    assert (10 * tiles * plan.splits >= 9 * slots
            or nk < 2 * plan.splits * cs.MIN_SPLIT_SLICES)


def test_sm90_plan_covers_the_bf16_trunk_chains():
    """The wgmma conv's plan for each of the 40 convs of the bf16 chains
    of the JAX bench's 384x512 trunk, T=8 (``BF16_STAGES``): Cin a
    multiple of 8 (a 16-byte chunk in one tap), the plan's rules, and
    the splits of ``SM90_BF16_SPLITS``."""
    from tao_amodal_torch.ops import conv_sm90 as cs

    convs = resnet50_chain_convs(8, 384, 512)
    assert len(convs) == 40
    for stage, P, cin, cout, ks in convs:
        assert cin % 8 == 0 and cout % 8 == 0
        plan = cs.conv_plan(P, cin, cout, ks, 2)
        _check_sm90_plan(plan, P, cin, cout, ks, 2)
        assert plan.splits == SM90_BF16_SPLITS.get(
            (stage, cin, cout, ks), 1), (stage, P, cin, cout, ks, plan)


def test_sm90_plan_covers_the_int8_trunk():
    """The plan for each of the 53 convs of the int8 ResNet-50 trunk at
    512^2, T=8, on the channels the wrapper gives the kernel (the stem's
    3 padded to 16): the plan's rules, the splits of
    ``SM90_INT8_SPLITS``, and output frames of the kernel's geometry."""
    from tao_amodal_torch.ops import conv_sm90 as cs
    from tao_amodal_torch.ops import int8_conv

    convs = resnet50_trunk_convs()
    assert len(convs) == 53
    for stage, Hi, Wi, cin, cout, ks, stride in convs:
        cp = -(-cin // int8_conv.CHANNELS) * int8_conv.CHANNELS
        pad = (ks - 1) // 2
        Ho = (Hi + 2 * pad - ks) // stride + 1
        assert Ho == -(-Hi // stride) and cout % int8_conv.CHANNELS == 0
        P = 8 * Ho * ((Wi + 2 * pad - ks) // stride + 1)
        plan = cs.conv_plan(P, cp, cout, ks, 1)
        _check_sm90_plan(plan, P, cp, cout, ks, 1)
        assert plan.splits == SM90_INT8_SPLITS.get(
            (stage, cin, cout, ks, stride), 1), (stage, cin, cout, ks, plan)


def test_sm90_counter_buffer_is_one_zeroed_buffer_per_device():
    """The split-K tile counters: one zeroed int32 buffer a device, at
    least the tiles asked for, the same buffer while it is large enough
    (every kernel leaves it zeroed, so no conv clears it), a larger zeroed
    one when it is not."""
    from tao_amodal_torch.ops import conv_sm90 as cs

    dev = torch.device("cpu")
    saved = cs._COUNTERS.pop((dev.type, dev.index), None)
    try:
        a = cs.counters(dev, 10)
        assert a.dtype == torch.int32 and a.numel() >= 10
        assert not a.any() and cs.counters(dev, a.numel()) is a
        b = cs.counters(dev, a.numel() + 1)
        assert b.numel() > a.numel() and not b.any()
        assert cs.counters(dev, 5) is b
    finally:
        cs._COUNTERS.pop((dev.type, dev.index), None)
        if saved is not None:
            cs._COUNTERS[(dev.type, dev.index)] = saved


def test_bf16_chain_weights_are_cout_by_k():
    """The bf16 form's B operand: the folded OIHW weights rounded to bf16
    once and laid out ``[Cout, K]`` (k = (ky*ks + kx)*Cin + c, contiguous,
    16-byte aligned), the biases f32, kept until the folded params
    change."""
    from tao_amodal_torch.ops import fused_stage

    _, params = chain_inputs("cpu", (1, 4, 5, 16), 8, 2, True)
    blocks = fused_stage._bf16_operands(params)
    assert fused_stage._bf16_operands(params) is blocks
    for p, blk in zip(params, blocks):
        for (w, b), name in zip(blk, ("wa", "w3", "wb", "wd")):
            if name not in p:
                assert w is None and b is None
                continue
            o, i, kh, kw = p[name].shape
            assert w.dtype == torch.bfloat16 and w.is_contiguous()
            assert tuple(w.shape) == (o, kh * kw * i)
            assert w.data_ptr() % 16 == 0 and b.dtype == torch.float32
            want = p[name].to(torch.bfloat16)
            for ky in range(kh):
                for kx in range(kw):
                    k0 = (ky * kw + kx) * i
                    assert torch.equal(w[:, k0:k0 + i], want[:, :, ky, kx])
    params[0]["wa"] = params[0]["wa"].clone()
    assert fused_stage._bf16_operands(params) is not blocks


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "strided"])
@pytest.mark.parametrize("act_scale", [None, 0.0173])
def test_quantize_activation_s8_plain_path_on_cpu(layout, act_scale):
    """The quantizer on a CPU activation is its plain version:
    ``quantize_activation`` of the NHWC view, channels zero-padded to 16
    (the stem's 3 and a ragged 20), the scale a 0-d f32 beside it, any
    strides; no launch counted."""
    from tao_amodal_torch.ops import int8_conv

    rs = np.random.RandomState(4)
    for C in (3, 20, 32):
        x = torch.from_numpy(rs.randn(2, C, 5, 7).astype(np.float32))
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        elif layout == "strided":
            x = torch.from_numpy(rs.randn(2, C, 5, 14).astype(
                np.float32))[..., ::2]
        n = int8_conv.quantize_activation_s8.launches
        x8, s_x = int8_conv.quantize_activation_s8(x, act_scale)
        assert int8_conv.quantize_activation_s8.launches == n
        want8, want_s = int8_conv.quantize_activation(x.permute(0, 2, 3, 1),
                                                      act_scale)
        cp = -(-C // 16) * 16
        assert tuple(x8.shape) == (2, 5, 7, cp) and x8.dtype == torch.int8
        assert torch.equal(x8[..., :C], want8) and not x8[..., C:].any()
        assert s_x.dim() == 0 and torch.equal(s_x, want_s)


def test_quantized_conv_plain_path_on_cpu():
    """``quantized_conv`` on a CPU activation is ``quantize_activation`` +
    ``int8_conv_reference`` with ``s_x * s_w``, NCHW in and out, for the
    stem (7x7/2 from 3 channels), a 3x3 and a strided projection, f32
    and bf16 in and out, static and dynamic scales; no launch counted;
    another device raises."""
    from tao_amodal_torch.ops import int8_conv

    rs = np.random.RandomState(5)
    counts = (int8_conv.quantized_conv, int8_conv.int8_conv,
              int8_conv.quantize_activation_s8)
    before = tuple(f.launches for f in counts)
    for cin, cout, ks, stride in ((3, 16, 7, 2), (32, 16, 3, 1),
                                  (16, 32, 1, 2)):
        x = torch.from_numpy(rs.randn(2, cin, 9, 11).astype(np.float32))
        w8, s_w = int8_conv.quantize_weight(torch.from_numpy(
            rs.randn(ks, ks, cin, cout).astype(np.float32)))
        for dt in (torch.float32, torch.bfloat16):
            for act in (None, 0.05):
                got = int8_conv.quantized_conv(x.to(dt), w8, s_w, stride,
                                               (ks - 1) // 2, dt, act)
                x8, s_x = int8_conv.quantize_activation(
                    x.to(dt).permute(0, 2, 3, 1), act)
                want = int8_conv.int8_conv_reference(
                    x8, w8, s_x * s_w, stride, (ks - 1) // 2, dt)
                assert got.dtype == dt
                assert torch.equal(got, want.permute(0, 3, 1, 2))
    assert tuple(f.launches for f in counts) == before
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv.quantized_conv(x.to("meta"), w8.to("meta"),
                                 s_w.to("meta"), 2, 0)


def test_forward_only_kernels_differentiate_on_cpu():
    """On CPU tensors B5, B6 and B8 take their plain versions, which
    autograd differentiates; the refusal under grad is the card's
    (``test_forward_only_kernels_raise_under_grad_on_cuda``)."""
    from tao_amodal_torch.ops import prroi, resnet_blocks

    canvas, rois = _prroi_inputs("cpu")
    canvas.requires_grad_()
    prroi.prroi_packed_pallas(canvas, rois).sum().backward()
    prroi.prroi_pool_pallas(canvas, rois, 7, 0.5).sum().backward()
    assert canvas.grad is not None and canvas.grad.abs().sum() > 0
    x, p = torch_stack("cpu", *stack_arrays((2, 6, 7, 32), 8, 2, "bf16"),
                       "bf16")
    x = x.float().requires_grad_()
    resnet_blocks.identity_blocks_bf16_pallas(x, p).float().sum().backward()
    assert x.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("ks,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                       (7, 2)])
@pytest.mark.parametrize("cin", [3, 64])
def test_quantized_conv_matches_plain_on_cuda(cuda, ks, stride, cin):
    """``quantized_conv`` (abs-max, quantization and conv on the card, no
    host sync) equals its plain version bit for bit: f32 and bf16
    activations, NCHW and channels-last (the flat quantizer), static and
    dynamic ``act_scale``, f32 and bf16 out, on a ragged frame.  Each
    call counts one launch of the conv, the quantizer and the whole; the
    quantizer alone equals its plain version, scale included (a true
    division, as JAX's op-by-op ``max / 127``)."""
    from tao_amodal_torch.ops import int8_conv as q

    rs = np.random.RandomState(ks * 10 + stride + cin)
    x = torch.from_numpy(rs.randn(2, cin, 13, 17).astype(np.float32)).to(
        cuda)
    w8, s_w = q.quantize_weight(torch.from_numpy(
        rs.randn(ks, ks, cin, 48).astype(np.float32)).to(cuda))
    for xi in (x, x.contiguous(memory_format=torch.channels_last)):
        for dt_in in (torch.float32, torch.bfloat16):
            xd = xi.to(dt_in)
            for act in (None, 0.0173):
                x8, s_x = q.quantize_activation_s8(xd, act)
                w_x8, w_sx = q.quantize_activation_s8_torch(xd, act)
                assert torch.equal(x8, w_x8) and torch.equal(s_x, w_sx)
                for dt in (torch.float32, torch.bfloat16):
                    n = (q.quantized_conv.launches, q.int8_conv.launches,
                         q.quantize_activation_s8.launches)
                    got = q.quantized_conv(xd, w8, s_w, stride,
                                           (ks - 1) // 2, dt, act)
                    torch.cuda.synchronize()
                    assert (q.quantized_conv.launches, q.int8_conv.launches,
                            q.quantize_activation_s8.launches) == tuple(
                                v + 1 for v in n)
                    want = q.quantized_conv_reference(
                        xd, w8, s_w, stride, (ks - 1) // 2, dt, act)
                    assert got.dtype == dt and got.shape == want.shape
                    assert torch.equal(got, want), (dt_in, act, dt)


@pytest.mark.cuda
def test_quantize_activation_s8_matches_plain_on_cuda(cuda):
    """The quantizer on a strided view (the tile path), a large dense
    activation (several abs-max blocks, the flat path's grid-stride
    loop) and a bf16 one: equal to the plain version, scale included."""
    from tao_amodal_torch.ops import int8_conv as q

    rs = np.random.RandomState(9)
    big = torch.from_numpy(rs.randn(4, 64, 96, 80).astype(np.float32)).to(
        cuda).contiguous(memory_format=torch.channels_last)
    for x in (big, big.to(torch.bfloat16), big[:, :40, ::2, 3:],
              big.permute(0, 1, 3, 2)):
        for act in (None, 0.02):
            got8, got_s = q.quantize_activation_s8(x, act)
            want8, want_s = q.quantize_activation_s8_torch(x, act)
            assert torch.equal(got8, want8) and torch.equal(got_s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_gradients_match_plain_on_cuda(cuda, dtype):
    """B2 on the card (``multilevel_roi_align``'s ``"prroi_packed_fused"``
    route, the ``"auto"`` default) returns the gradients of the plain
    route's autograd (``prroi_pool`` cast to the output's dtype, the
    rule B2's backward recomputes), for the pyramid and the RoIs, in f32
    and bf16: the same autograd graph on the same card, equal up to the
    order cuBLAS sums in (1e-5 of the largest gradient); the forward is
    the kernel's (one launch)."""
    from tao_amodal_torch.ops import prroi, roi

    rs = np.random.RandomState(11)
    pyramid = [torch.from_numpy(rs.rand(2, s, s, 32).astype(np.float32)).to(
        cuda).to(dtype) for s in (32, 16, 8, 4)]
    side = np.exp(rs.uniform(np.log(8), np.log(250), (2, 24, 2)))
    xy = rs.uniform(0, 256, (2, 24, 2)) - side / 2
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).clip(
        0, 256).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(2, 24, 7, 7, 32).astype(np.float32)).to(
        cuda).to(dtype)
    kw = dict(canonical_level=1, canonical_size=28.0,
              strides=(8, 16, 32, 64))

    def grads(pool):
        pyr = [p.clone().requires_grad_() for p in pyramid]
        boxes = rois.clone().requires_grad_()
        canvas, rois_p = roi.pack_levels(pyr, boxes, **kw)
        out = pool(canvas, rois_p)
        out.backward(g)
        return out, [p.grad for p in pyr], boxes.grad

    fn = prroi.prroi_packed.bf16 if dtype == torch.bfloat16 else \
        prroi.prroi_packed
    n = fn.launches
    out, gp, gr = grads(prroi.prroi_packed)
    assert fn.launches == n + 1 and out.dtype == dtype
    _, wp, wr = grads(lambda c, r: roi.prroi_pool(c, r, 7, 1.0).to(dtype))
    scales = []
    for a, b in zip(gp + [gr], wp + [wr]):
        scale = float(b.float().abs().max())  # 0 at a level without RoIs
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * scale
        scales.append(scale)
    assert scales[-1] > 0 and max(scales[:-1]) > 0
    via_route = roi.multilevel_roi_align(
        [p.clone().requires_grad_() for p in pyramid], rois,
        method="prroi_packed_fused", **kw)
    assert via_route.requires_grad


@pytest.mark.cuda
def test_forward_only_kernels_raise_under_grad_on_cuda(cuda):
    """B5, B6 and B8 have no backward (JAX cannot differentiate them
    either): on the card they raise under grad, as B4 does, and run under
    ``torch.no_grad()``."""
    from tao_amodal_torch.ops import prroi, resnet_blocks

    canvas, rois = _prroi_inputs(cuda)
    leaf = canvas.clone().requires_grad_()
    for fn, args in ((prroi.prroi_packed_pallas, (leaf, rois)),
                     (prroi.prroi_pool_pallas, (leaf, rois, 7, 0.5))):
        with pytest.raises(ValueError, match="forward only"):
            fn(*args)
        with torch.no_grad():
            fn(*args)
    x, p = torch_stack(cuda, *stack_arrays((2, 6, 7, 32), 8, 2, "bf16"),
                       "bf16")
    with pytest.raises(ValueError, match="forward only"):
        resnet_blocks.identity_blocks_bf16_pallas(x.clone().requires_grad_()
                                                  , p)
    with torch.no_grad():
        resnet_blocks.identity_blocks_bf16_pallas(x, p)


@pytest.mark.cuda
def test_sm90_kernels_reject_wrong_inputs_on_cuda(cuda):
    """``quantized_conv`` wants a float NCHW activation, an int8 HWIO
    kernel of its channels, a kernel size, stride and padding the conv
    has, Cout a multiple of 16 and an f32 ``s_w`` beside it; the
    quantizer a channel multiple of 4; the bf16 chain Cin and M
    multiples of 8."""
    from tao_amodal_torch.ops import fused_stage, int8_conv as q

    x = torch.randn(1, 16, 8, 8, device=cuda)
    w8, s_w = q.quantize_weight(torch.randn(3, 3, 16, 32, device=cuda))
    for args, match in (((x.to(torch.int8), w8, s_w, 1, 1), "float32"),
                        ((x, w8, s_w, 1, 0), "pad"),
                        ((x, w8, s_w, 3, 1), "stride"),
                        ((x[:, :8], w8, s_w, 1, 1), "HWIO"),
                        ((x, w8[..., :24], s_w[:24], 1, 1), "Cout"),
                        ((x, w8, s_w.cpu(), 1, 1), "scale")):
        with pytest.raises(ValueError, match=match):
            q.quantized_conv(*args)
    with pytest.raises(ValueError, match="multiple of 4"):
        q.quantize_activation_s8(x, channels=6)
    xc, params = chain_inputs(cuda, (2, 9, 13, 64), 12, 2, True)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_stage.fused_bottleneck_chain(xc.to(torch.bfloat16), params)
