"""The port's visualization entry points against the JAX package's.

Every mode of the vis CLI (``tao_amodal_torch/cli/vis_cli.py``, the tools
``vis_prediction_torch.py``, ``vis_prediction_comparison_torch.py`` and
``vis_amodal_mask_videos_torch.py``) renders the same frames as JAX's CLI
on ``tests/fixture_gen.make_fixture``: both write PNG frame directories
(each CLI's ``video_writer`` binding is replaced by its own package's,
given a path without extension).  ``tools/demo_burst_torch.py``, the SOT
figures (``evaluation/sot_plots.py``, matplotlib's Agg backend), ``LvisVis``
and ``tools/run_video_torch.py --cpu`` are held the same way.
"""

import json
import os
import runpy

import numpy as np
import pytest
from PIL import Image

from fixture_gen import make_fixture
from test_torch_port_vis import burst_json
from torch_port_fixtures import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")

pytestmark = pytest.mark.usefixtures("single_thread")


@pytest.fixture(scope="module")
def single_thread():
    yield from one_torch_thread()


def _frames(d):
    """``{name: pixels}`` of every PNG under ``d``."""
    out = {}
    for base, _, names in os.walk(d):
        for n in sorted(names):
            if n.endswith(".png"):
                path = os.path.join(base, n)
                out[os.path.relpath(path, d)] = np.asarray(Image.open(path))
    return out


def _assert_same_frames(got_dir, want_dir):
    got, want = _frames(got_dir), _frames(want_dir)
    assert got and sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A two-video fixture at 160x120 with seeded JPEG frames, its
    predictions split in two sets, and a BURST file for one video."""
    root = tmp_path_factory.mktemp("vis")
    gt, preds = make_fixture(seed=3, num_videos=2, frames_per_video=3,
                             img_size=(160, 120))
    gt["videos"][0]["name"] = "BDD/video_1"
    for im in gt["images"]:
        if im["video_id"] == 1:
            im["file_name"] = "BDD/video_1/" + os.path.basename(
                im["file_name"])
    rs = np.random.RandomState(0)
    for im in gt["images"]:
        path = root / "frames" / im["file_name"]
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (120, 160, 3)).astype(
            np.uint8)).save(path)
    for k, a in enumerate(gt["annotations"]):
        if k % 4 == 0:
            x, y, w, h = a["bbox"]
            a["modal_bbox"] = [x + 3, y + 2, w / 2, h / 2]
    paths = {"gt": root / "gt.json", "p1": root / "p1.json",
             "p2": root / "p2.json", "burst": root / "burst.json"}
    paths["gt"].write_text(json.dumps(gt))
    paths["p1"].write_text(json.dumps(preds[0::2]))
    paths["p2"].write_text(json.dumps(preds[1::2]))
    burst_json(str(paths["burst"]), seed=1, videos=1, frames=3, tracks=2,
               hw=(120, 160))
    data = json.loads(paths["burst"].read_text())
    data["sequences"][0].update(dataset="BDD", seq_name="video_1")
    data["sequences"][0]["annotated_image_paths"] = [
        "frame_0000.jpg", "frame_0001.jpg", "frame_0002.jpg"]
    paths["burst"].write_text(json.dumps(data))
    return root, {k: str(v) for k, v in paths.items()}


def _render(monkeypatch, cli, video, argv, mode):
    """Run one package's vis CLI with its writer turned to a frame
    directory; returns the rendered paths."""
    def frames_writer(path, fps=30, size_wh=None):
        return video.video_writer(os.path.splitext(path)[0], fps, size_wh)

    monkeypatch.setattr(cli, "video_writer", frames_writer)
    return cli.main(argv, mode=mode)


MODES = {
    "annotations": ("annotations", ["--video_name", "BDD/video_1"]),
    "transparent_visibility_modal": ("annotations", [
        "--video_name", "BDD/video_1", "--transparent",
        "--show_visibility", "--modal"]),
    "reference_style": ("annotations", [
        "--video_name", "BDD/video_1", "--reference_style",
        "--show_visibility"]),
    "interpolate_clip_filter": ("annotations", [
        "--video_name", "video_2", "--interpolate", "--clip_annotation",
        "--filter_tracks", "1", "2", "3", "4", "5", "--slow_down", "2"]),
    "burst_masks": ("annotations", [
        "--video_name", "BDD/video_1", "--mask_annotations", "burst"]),
    "prediction": ("prediction", [
        "--video_name", "BDD/video_1", "--prediction", "p1",
        "--score_threshold", "0.3", "--transparent"]),
    "comparison": ("comparison", [
        "--video_name", "video_2", "--prediction", "p1",
        "--prediction2", "p2", "--expand_ratio", "1.25"]),
    "random_videos_workers": ("annotations", [
        "--num_videos", "2", "--seed", "3", "--workers", "2"]),
}


@pytest.mark.parametrize("case", list(MODES))
def test_vis_cli_mode_matches_jax(case, scene, tmp_path, monkeypatch):
    """Each mode and flag renders JAX's frames byte for byte (drawn with
    cv2 there, numpy here) and returns the same paths."""
    from tao_amodal_torch.cli import vis_cli as pcli
    from tao_amodal_torch.utils import video as pvid
    from tao_amodal_tpu.cli import vis_cli as jcli
    from tao_amodal_tpu.utils import video as jvid

    root, paths = scene
    mode, extra = MODES[case]
    extra = [paths.get(a, a) for a in extra]
    outs = {}
    for name, cli, vid in (("ours", pcli, pvid), ("theirs", jcli, jvid)):
        argv = ["--annotation", paths["gt"], "--images_dir",
                str(root / "frames"), "--output_dir",
                str(tmp_path / name)] + extra
        outs[name] = _render(monkeypatch, cli, vid, argv, mode)
    assert [os.path.basename(p) for p in outs["ours"]] == [
        os.path.basename(p) for p in outs["theirs"]]
    _assert_same_frames(tmp_path / "ours", tmp_path / "theirs")


def test_vis_cli_helpers_match_jax(scene):
    """``PredictionIndex``, ``clip_annotation_boxes``, ``occlusion_score``
    (visibility, and the modal-vs-amodal IoU on the port's numpy
    ``box_iou_matrix``) and ``select_videos`` (its ``RandomState`` draw,
    and the occlusion ranking) equal JAX's."""
    from tao_amodal_torch.cli import vis_cli as p
    from tao_amodal_torch.data.tao import TaoDataset as PD
    from tao_amodal_tpu.cli import vis_cli as j
    from tao_amodal_tpu.data.tao import TaoDataset as JD

    _, paths = scene
    pi, ji = (m.PredictionIndex(paths["p1"], 0.4) for m in (p, j))
    assert dict(pi.img_to_anns) == dict(ji.img_to_anns) and pi[999] == []
    anns = pi[1] + ji[2]
    assert (p.clip_annotation_boxes(anns, 160, 120)
            == j.clip_annotation_boxes(anns, 160, 120))
    gt = json.loads(open(paths["gt"]).read())
    for a in gt["annotations"][1::2]:
        a.pop("visibility", None)
        a.setdefault("modal_bbox", [a["bbox"][0] + 1, a["bbox"][1],
                                    a["bbox"][2] / 3, a["bbox"][3]])
    pds, jds = PD(gt), JD(gt)
    for vid in pds.vids:
        assert p.occlusion_score(pds, vid) == j.occlusion_score(jds, vid)
    for seed in range(4):
        args = p.default_arg_parser().parse_args(
            ["--annotation", "a", "--output_dir", "o", "--num_videos", "1",
             "--seed", str(seed)])
        for mode in ("random", "occlusion"):
            assert (p.select_videos(pds, args, mode)
                    == j.select_videos(jds, args, mode))


def _tool(name):
    return runpy.run_path(os.path.join(TOOLS, name))["main"]


def test_demo_burst_matches_jax(scene, tmp_path, capsys):
    """``tools/demo_burst_torch.py`` writes JAX's mask overlays (blend and
    contour, byte for byte) from a BURST file the port's codec encoded."""
    root, paths = scene
    for name, tool in (("ours", "demo_burst_torch.py"),
                       ("theirs", "demo_burst.py")):
        _tool(tool)(["--annotations", paths["burst"], "--images_dir",
                     str(root / "frames"), "--output_dir",
                     str(tmp_path / name)])
    assert "wrote" in capsys.readouterr().out
    _assert_same_frames(tmp_path / "ours", tmp_path / "theirs")


def _plot_inputs():
    rs = np.random.RandomState(4)
    success = {t: {f"s{i}": np.sort(rs.rand(21))[::-1] for i in range(3)}
               for t in ("siamrpn", "dimp", "eco")}
    precision = {t: {f"s{i}": np.sort(rs.rand(51)) for i in range(3)}
                 for t in success}
    eao = {t: {tag: float(rs.rand()) for tag in
               ("all", "camera_motion", "occlusion", "size_change")}
           for t in success}
    return success, precision, eao


def test_sot_plots_match_jax(tmp_path):
    """The success/precision figures and the EAO radar decode to JAX's
    pixels (both through matplotlib's Agg backend)."""
    from tao_amodal_torch.evaluation import sot_plots as p
    from tao_amodal_tpu.evaluation import sot_plots as j

    success, precision, eao = _plot_inputs()
    for name, m in (("ours", p), ("theirs", j)):
        d = tmp_path / name
        d.mkdir()
        written = m.draw_success_precision(
            success, "OTB", precision_ret=precision, bold_name="dimp",
            out_prefix=str(d / "ope"))
        assert [os.path.basename(w) for w in written] == [
            "ope_success.png", "ope_precision.png"]
        assert m.draw_eao(eao, out_path=str(d / "eao.png"))
        assert m.draw_eao({}) is None
    _assert_same_frames(tmp_path / "ours", tmp_path / "theirs")


def test_lvis_vis_matches_jax(tmp_path):
    """``LvisVis.vis_img`` and ``vis_result`` (boxes, synsets, scores, RLE
    masks through the port's codec) draw JAX's figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tao_amodal_torch.data.lvis import LvisDataset as PL
    from tao_amodal_torch.evaluation.lvis_vis import LvisVis as PV
    from tao_amodal_torch.ops import mask as mask_ops
    from tao_amodal_tpu.data.lvis import LvisDataset as JL
    from tao_amodal_tpu.evaluation.lvis_vis import LvisVis as JV

    gt, preds = make_fixture(seed=2, num_videos=1, frames_per_video=2,
                             img_size=(160, 120))
    img_id = gt["annotations"][0]["image_id"]
    m = np.zeros((120, 160), np.uint8, order="F")
    m[20:70, 30:90] = 1
    rle = mask_ops.encode(m)
    gt["annotations"][0]["segmentation"] = {
        "size": rle["size"], "counts": rle["counts"].decode()}
    dt = {"images": gt["images"], "categories": gt["categories"],
          "annotations": [dict(a, id=i + 1) for i, a in enumerate(preds)]}
    pixels = []
    for L, V in ((PL, PV), (JL, JV)):
        vis = V(L(json.loads(json.dumps(gt))),
                L(json.loads(json.dumps(dt))))
        fig, axes = plt.subplots(1, 2, figsize=(6, 3), dpi=60)
        vis.vis_img(img_id, ax=axes[0])
        vis.vis_result(img_id, score_thrs=0.2, ax=axes[1])
        assert len(axes[0].patches) > 0
        fig.canvas.draw()
        pixels.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        plt.close(fig)
    np.testing.assert_array_equal(pixels[0], pixels[1])


class _GtTracker:
    """Reports the gt box of each frame (no arithmetic), score 0.5."""

    def __init__(self, gt):
        self.gt, self.f = gt, 0

    def init(self, image, box):
        self.f = 1

    def update(self, image):
        self.f += 1
        return np.asarray(self.gt[self.f - 1], np.float64), 0.5


def _square_frames(d, T=4, H=96, W=128):
    rs = np.random.RandomState(9)
    os.makedirs(d)
    gt = []
    for t in range(T):
        f = rs.randint(0, 60, (H, W, 3)).astype(np.uint8)
        x, y = 20 + 6 * t, 30 + 2 * t
        f[y:y + 24, x:x + 30] = 200
        gt.append([x, y, 30, 24])
        Image.fromarray(f).save(os.path.join(d, f"{t:04d}.png"))
    return np.asarray(gt, np.float64)


def test_run_video_matches_jax(tmp_path, monkeypatch, capsys):
    """``tools/run_video_torch.py --cpu`` over a frame directory: with a
    tracker that reports the gt, the drawn frames and the boxes file equal
    JAX's ``tools/run_video.py``; with a seeded SiamRPN at 64/128 on the
    CPU, its boxes equal the tracker's own ``track`` over the same
    frames, and every drawn frame shows the box's border."""
    from tao_amodal_torch.trackers import factory as pf
    from tao_amodal_torch.trackers.siamrpn import SiamConfig, SiamRPNTracker
    from tao_amodal_tpu.trackers import factory as jf

    gt = _square_frames(str(tmp_path / "clip"))
    src = str(tmp_path / "clip")
    init = ",".join(str(v) for v in gt[0])
    for name, tool, fac in (("ours", "run_video_torch.py", pf),
                            ("theirs", "run_video.py", jf)):
        monkeypatch.setattr(fac, "build_tracker",
                            lambda *a, **k: _GtTracker(gt))
        argv = ["gt", src, "--init_box", init, "--output",
                str(tmp_path / name), "--boxes_out",
                str(tmp_path / f"{name}.txt")]
        assert _tool(tool)(argv + (["--cpu"] if name == "ours" else [])) == 0
    assert (tmp_path / "ours.txt").read_bytes() == (
        tmp_path / "theirs.txt").read_bytes()
    _assert_same_frames(tmp_path / "ours", tmp_path / "theirs")
    assert "tracked 4 frames" in capsys.readouterr().out

    def small(name, device="cuda", **kw):
        assert name == "siamrpn" and device == "cpu"
        cfg = SiamConfig(exemplar_size=64, instance_size=128, base_size=0,
                         stride=8)
        return SiamRPNTracker(pf.seeded_model(0, device), cfg)

    monkeypatch.setattr(pf, "build_tracker", small)
    _tool("run_video_torch.py")(["siamrpn", src, "--init_box", init,
                                 "--output", str(tmp_path / "siam"),
                                 "--boxes_out", str(tmp_path / "s.txt"),
                                 "--cpu"])
    frames = [np.asarray(Image.open(os.path.join(src, f)))
              for f in sorted(os.listdir(src))]
    boxes, scores, _ = small("siamrpn", "cpu").track(frames, gt[0])
    got = np.loadtxt(tmp_path / "s.txt", delimiter=",")
    np.testing.assert_allclose(got[:, :4], boxes, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got[:, 4], scores, rtol=0, atol=5e-5)
    drawn = _frames(tmp_path / "siam")
    assert len(drawn) == 4
    for (name, img), box in zip(sorted(drawn.items()), boxes):
        x, y = (int(round(v)) for v in box[:2])
        h, w = img.shape[:2]
        if 0 <= x < w and 0 <= y < h:
            assert tuple(img[y, x]) == (50, 220, 50), name
