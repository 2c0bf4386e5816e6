"""The port's SOT harness held against the JAX package on the CPU: the
pysot checkpoint converter, the rotated-box geometry, the VOT polygon
overlap of the port's host library, the OPE / EAO / F1 benchmarks, the
eight dataset layouts and the SOT CLI (result files, evaluation, the
default-size ``--cpu`` run with a checkpoint, the batched sweep's CLI).

Numpy-only functions are held exactly; the trackers through the CLI as
closely as ``tests/test_torch_port_siamese.py`` holds their tracks.
"""

import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_fixtures import (
    one_torch_thread,
    pysot_state_dict,
    siamese_model,
)

pytestmark = pytest.mark.usefixtures("single_thread")

EX, INST = 64, 128


@pytest.fixture(scope="module")
def single_thread():
    yield from one_torch_thread()


def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


# ----------------------------------------------------------- converter


def test_siamese_checkpoint_converter_matches_jax():
    """A pysot-named checkpoint (trunk under ``backbone.``, necks as
    ``neck.downsample{2,3,4}``, DataParallel prefix, ``state_dict``
    container): the port's ``convert_siamese_checkpoint`` grafts it onto
    the same seed tree as JAX's, leaf for leaf, with the same report;
    ``load_siamese_checkpoint`` loads it into the port's model."""
    from tao_amodal_torch.trackers.factory import seeded_model
    from tao_amodal_torch.utils.torch_convert import (
        convert_adjust_necks,
        convert_siamese_checkpoint,
        load_siamese_checkpoint,
        unflatten,
    )
    from tao_amodal_torch.utils.weights import flat_variables
    from tao_amodal_tpu.models.siamese import SiameseTracker
    from tao_amodal_tpu.utils import torch_convert as jconv

    model = seeded_model(1, "cpu")
    seed = unflatten(flat_variables(model))
    sd = pysot_state_dict(0)
    got, got_report = convert_siamese_checkpoint(sd, seed_variables=seed)
    want, want_report = jconv.convert_siamese_checkpoint(
        sd, SiameseTracker(num_levels=3), seed)
    _leaves_equal(got, want)
    assert got_report == want_report
    assert len(got_report["loaded"]) == 53 * 5 + 3 * 5
    flat_sd = jconv.load_torch_state_dict(sd)
    _leaves_equal(convert_adjust_necks(flat_sd), jconv.convert_adjust_necks(
        flat_sd))

    report = load_siamese_checkpoint(model, sd)
    assert report["loaded"] == got_report["loaded"]
    w = sd["state_dict"]["module.backbone.layer3.2.conv2.weight"]
    assert torch.equal(model.backbone.Bottleneck_9.ConvBN_1.Conv_0.weight, w)
    w = sd["state_dict"]["module.neck.downsample4.downsample.1.running_var"]
    assert torch.equal(model.necks_2.BatchNorm_0.running_var, w)
    _leaves_equal(unflatten(flat_variables(model)), got)


# ------------------------------------------------ geometry and overlap


def _masks(seed):
    """Soft masks: rotated ellipses and rectangles, a speckle, a tiny
    blob (the fallback), an empty mask."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:63, :63].astype(np.float64)
    out = []
    for _ in range(4):
        cx, cy = rs.uniform(15, 48, 2)
        a, b = rs.uniform(4, 20, 2)
        th = rs.uniform(0, np.pi)
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        out.append(np.exp(-((u / a) ** 2 + (v / b) ** 2)))
        out.append(((np.abs(u) < a) & (np.abs(v) < b)).astype(np.float64)
                   * rs.uniform(0.5, 1.0))
    out.append(rs.rand(63, 63) ** 4)
    tiny = np.zeros((63, 63))
    tiny[30:33, 30:34] = 1.0
    out += [tiny, np.zeros((63, 63))]
    return [m.astype(np.float32) for m in out]


def test_rotated_box_matches_jax():
    """``mask_to_rotated_box`` (with and without a fallback),
    ``min_area_rect``, ``convex_hull`` and ``polygon_area``: equal to
    JAX's bit for bit."""
    from tao_amodal_torch.ops import rotated_box as pr
    from tao_amodal_tpu.ops import rotated_box as jr

    for i, mask in enumerate(_masks(0)):
        for fb in (None, [3.0, 4.0, 20.5, 11.25]):
            got = pr.mask_to_rotated_box(mask, 0.3, fallback_rect=fb)
            want = jr.mask_to_rotated_box(mask, 0.3, fallback_rect=fb)
            np.testing.assert_array_equal(got, want, err_msg=str(i))
            assert pr.polygon_area(got) == jr.polygon_area(want)
    rs = np.random.RandomState(1)
    for n in (1, 2, 3, 7, 40):
        pts = rs.randn(n, 2) * 10
        np.testing.assert_array_equal(pr.convex_hull(pts),
                                      jr.convex_hull(pts))
        np.testing.assert_array_equal(pr.min_area_rect(pts),
                                      jr.min_area_rect(pts))


def _polygons(seed, n=40):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        c = rs.uniform(-5, 60, 2)
        k = rs.choice([3, 4, 6])
        ang = np.sort(rs.uniform(0, 2 * np.pi, k))
        r = rs.uniform(2, 30, k)
        out.append(np.stack([c[0] + r * np.cos(ang),
                             c[1] + r * np.sin(ang)], 1).reshape(-1))
    return out


def test_region_polygon_overlap_matches_jax():
    """The port's ``region.cc`` (built into its own host library, not
    the JAX package's) gives JAX's overlap of random polygon pairs and
    rectangles, with and without frame bounds, bit for bit."""
    from tao_amodal_torch.native import lib as plib
    from tao_amodal_tpu.native.lib import load as jload

    ours, theirs = plib.load(), jload()
    assert "tao_amodal_torch" in ours.path
    polys = _polygons(0)
    rect = [10.0, 12.0, 40.0, 12.0, 40.0, 30.0, 10.0, 30.0]
    for i in range(0, len(polys) - 1):
        for a, b in ((polys[i], polys[i + 1]), (polys[i], rect)):
            for bounds in (None, (50, 40), (64, 64)):
                assert (ours.polygon_overlap(a, b, bounds=bounds)
                        == theirs.polygon_overlap(a, b, bounds=bounds))
    assert ours.polygon_overlap(rect, rect) == 1.0


# ---------------------------------------------------------- benchmarks


def _vot_sequences(seed, num_seqs=4, min_len=60, max_len=160,
                   polygons=False):
    """VOT-style runs (init/failure/skip markers) over random-walk gt,
    as ``tests/test_eao.py`` makes them; with ``polygons`` some
    predictions are rotated 4-point polygons."""
    rng = np.random.RandomState(seed)
    seqs = []
    for s in range(num_seqs):
        T = int(rng.randint(min_len, max_len))
        cx = np.cumsum(rng.randn(T) * 3) + 320
        cy = np.cumsum(rng.randn(T) * 2) + 240
        w = 40 + 10 * np.sin(np.arange(T) / 17.0)
        h = 50 + 8 * np.cos(np.arange(T) / 23.0)
        gt = [[float(cx[t] - w[t] / 2), float(cy[t] - h[t] / 2),
               float(w[t]), float(h[t])] for t in range(T)]
        traj, t = [], 0
        fail_p = rng.uniform(0.0, 0.04)
        while t < T:
            traj.append([1.0])
            t += 1
            while t < T:
                if rng.rand() < fail_p:
                    traj.append([2.0])
                    for _ in range(4):
                        t += 1
                        if t < T:
                            traj.append([0.0])
                    t += 1
                    break
                dx, dy = rng.randn(2) * 4
                box = [gt[t][0] + dx, gt[t][1] + dy,
                       gt[t][2] * (1 + rng.randn() * 0.05),
                       gt[t][3] * (1 + rng.randn() * 0.05)]
                if polygons and rng.rand() < 0.3:
                    x, y, bw, bh = box
                    th = rng.uniform(-0.3, 0.3)
                    c, s_ = np.cos(th), np.sin(th)
                    pts = [(x, y), (x + bw, y), (x + bw, y + bh),
                           (x, y + bh)]
                    mx, my = x + bw / 2, y + bh / 2
                    box = [v for px, py in pts for v in (
                        mx + c * (px - mx) - s_ * (py - my),
                        my + s_ * (px - mx) + c * (py - my))]
                traj.append(box)
                t += 1
        tags = {"camera_motion": (rng.rand(T) > 0.5).astype(float),
                "occlusion": (rng.rand(T) > 0.8).astype(float)}
        seqs.append((f"seq{s}", gt, traj, tags))
    return seqs


@pytest.mark.parametrize("polygons", [False, True])
def test_eao_and_overlaps_match_jax(polygons):
    """``EAOBenchmark`` (fragments, tags, two runs a sequence),
    ``trajectory_overlaps`` (polygons through the host library),
    ``expected_overlap_curve``, ``calculate_eao``,
    ``calculate_accuracy``/``calculate_failures``: equal to JAX's."""
    from tao_amodal_torch.evaluation import sot_benchmarks as pb
    from tao_amodal_tpu.evaluation import sot_benchmarks as jb

    seqs = _vot_sequences(3, polygons=polygons)
    ds = {n: {"gt_traj": gt, "pred_trajs": {"t": [traj, traj[::-1][::-1]]},
              "width": 640, "height": 480, "tags": tg}
          for n, gt, traj, tg in seqs}
    tags = ("all", "camera_motion", "occlusion")
    for name in ("VOT2018", "VOT2019"):
        got = pb.EAOBenchmark(ds, name=name, tags=tags).eval("t")
        want = jb.EAOBenchmark(ds, name=name, tags=tags).eval("t")
        assert got == want
        assert (pb.EAOBenchmark(ds).show_result(got)
                == jb.EAOBenchmark(ds).show_result(want))
    overlaps = []
    for n, gt, traj, _ in seqs:
        g = pb.trajectory_overlaps(traj, gt, (639, 479))
        np.testing.assert_array_equal(
            g, jb.trajectory_overlaps(traj, gt, (639, 479)))
        overlaps.append(np.nan_to_num(g))
        assert pb.calculate_accuracy(traj, gt, burnin=5) == \
            jb.calculate_accuracy(traj, gt, burnin=5)
        assert pb.calculate_failures(traj) == jb.calculate_failures(traj)
    lens = [len(o) for o in overlaps]
    assert pb.calculate_eao(overlaps, lens, 20, 80) == \
        jb.calculate_eao(overlaps, lens, 20, 80)
    rs = np.random.RandomState(4)
    frag = rs.rand(7, 30)
    frag[rs.rand(7, 30) < 0.2] = np.nan
    fw = rs.rand(7)
    np.testing.assert_array_equal(pb.expected_overlap_curve(frag, fw),
                                  jb.expected_overlap_curve(frag, fw))


def test_ope_and_f1_match_jax():
    """OPE success and precision curves, their table, the 21-threshold
    ``success_overlap`` with invisible frames, and the long-term F1:
    equal to JAX's."""
    from tao_amodal_torch.evaluation import sot_benchmarks as pb
    from tao_amodal_tpu.evaluation import sot_benchmarks as jb

    rs = np.random.RandomState(5)
    ds = {}
    for s in range(3):
        T = 40 + 10 * s
        gt = np.abs(rs.randn(T, 4)) * 20 + 5
        gt[rs.rand(T) < 0.1, 2] = 0          # absent target
        trajs = {n: gt + rs.randn(T, 4) * sc for n, sc in (("a", 2.0),
                                                            ("b", 8.0))}
        ds[f"s{s}"] = {"gt_traj": gt, "pred_trajs": trajs,
                       "pred_scores": {n: rs.rand(T) for n in trajs}}
    names = ["a", "b"]
    ours, theirs = pb.OPEBenchmark(ds), jb.OPEBenchmark(ds)
    gs, ws = ours.eval_success(names), theirs.eval_success(names)
    gp, wp = ours.eval_precision(names), theirs.eval_precision(names)
    _leaves_equal(gs, ws)
    _leaves_equal(gp, wp)
    assert ours.show_result(gs, gp) == theirs.show_result(ws, wp)
    for n in names:
        assert pb.F1Benchmark(ds).eval(n) == jb.F1Benchmark(ds).eval(n)


# ------------------------------------------------------------ datasets


def _frames(d, n, pattern):
    os.makedirs(d, exist_ok=True)
    for i in range(1, n + 1):
        Image.new("RGB", (8, 6)).save(os.path.join(d, pattern.format(i)))


def _write_layouts(root, rs):
    """A tiny tree of each benchmark's layout under ``root``; returns
    {loader name: (its root, loader kwargs)}."""
    def gt(n, delimiter=","):
        return rs.rand(n, 4) * 20 + 1

    def save(path, rows, delimiter=","):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savetxt(path, rows, delimiter=delimiter)

    r = os.path.join(root, "otb")
    for seq, n in (("Basketball", 3), ("Car4", 2)):
        _frames(os.path.join(r, seq, "img"), n, "{:04d}.jpg")
        save(os.path.join(r, seq, "groundtruth_rect.txt"), gt(n))
    os.makedirs(os.path.join(r, "empty"))
    v = os.path.join(root, "vot")
    for seq, n, poly in (("ball", 3, True), ("bag", 2, False)):
        _frames(os.path.join(v, seq, "color"), n, "{:08d}.jpg")
        rows = rs.rand(n, 8) * 30 if poly else gt(n)
        save(os.path.join(v, seq, "groundtruth.txt"), rows)
    la = os.path.join(root, "lasot")
    for cls, idx, n in (("airplane", 1, 3), ("bear", 4, 2)):
        d = os.path.join(la, cls, f"{cls}-{idx}")
        _frames(os.path.join(d, "img"), n, "{:08d}.jpg")
        save(os.path.join(d, "groundtruth.txt"), gt(n))
        save(os.path.join(d, "full_occlusion.txt"),
             (rs.rand(1, n) > 0.5).astype(float))
    split = os.path.join(root, "lasot_split.txt")
    with open(split, "w") as f:
        f.write("bear-4\n")
    g = os.path.join(root, "got10k", "val")
    for seq, n in (("GOT-10k_Val_000002", 2), ("GOT-10k_Val_000001", 3)):
        _frames(os.path.join(g, seq), n, "{:08d}.jpg")
        save(os.path.join(g, seq, "groundtruth.txt"), gt(n))
    with open(os.path.join(g, "list.txt"), "w") as f:
        f.write("GOT-10k_Val_000002\nGOT-10k_Val_000001\n")
    t = os.path.join(root, "trackingnet", "TEST")
    for seq, n in (("abc", 11), ("xyz", 2)):
        d = os.path.join(t, "frames", seq)
        os.makedirs(d)
        for i in range(n):
            Image.new("RGB", (8, 6)).save(os.path.join(d, f"{i}.jpg"))
        save(os.path.join(t, "anno", f"{seq}.txt"), gt(n))
    nf = os.path.join(root, "nfs")
    for seq, n in (("Gymnastics", 4), ("bee", 3)):
        _frames(os.path.join(nf, "sequences", seq), n, "{:05d}.jpg")
        save(os.path.join(nf, "anno", f"nfs_{seq}.txt"), gt(n), " ")
    _frames(os.path.join(nf, "sequences", "jet"), 2, "{:05d}.jpg")
    save(os.path.join(nf, "anno", "nfs_jet.txt"),
         np.array([[1, 10, 20, 30, 50, 0, 0], [2, 11, 21, 31, 51, 0, 0]],
                  float), " ")
    u = os.path.join(root, "uav")
    _frames(os.path.join(u, "data_seq", "UAV123", "bike1"), 5, "{:06d}.jpg")
    save(os.path.join(u, "anno", "UAV123", "bike1.txt"), gt(5))
    _frames(os.path.join(u, "data_seq", "UAV123", "bird1"), 4, "{:06d}.jpg")
    save(os.path.join(u, "anno", "UAV123", "bird1_2.txt"), gt(3))
    tp = os.path.join(root, "tpl")
    for seq, n in (("Skating2", 3), ("Pool_ce3", 4)):
        d = os.path.join(tp, f"tpl_{seq}")
        _frames(os.path.join(d, "img"), n, "{:04d}.jpg")
        save(os.path.join(d, f"{seq}_gt.txt"), gt(n))
    return [("otb", r, {}), ("vot", v, {}), ("lasot", la, {}),
            ("lasot", la, {"split_file": split}),
            ("got10k", os.path.join(root, "got10k"), {}),
            ("trackingnet", os.path.join(root, "trackingnet"), {}),
            ("nfs", nf, {}), ("uav123", u, {}), ("tpl", tp, {}),
            ("tpl", tp, {"exclude_otb": True}),
            ("otb", os.path.join(root, "missing"), {})]


def test_sot_datasets_match_jax(tmp_path):
    """Each of the eight layouts (and LaSOT's split file, TPL without
    OTB's sequences, a missing root) loads the same sequences as JAX's
    loader: names in order, frame paths, gt, init box, attributes."""
    from tao_amodal_torch.data import sot_datasets as pd
    from tao_amodal_tpu.data import sot_datasets as jd

    assert set(pd.LOADERS) == set(jd.LOADERS)
    for name, root, kw in _write_layouts(str(tmp_path),
                                         np.random.RandomState(0)):
        got = pd.load_sot_dataset(name, root, **kw)
        want = jd.load_sot_dataset(name, root, **kw)
        assert got.names() == want.names(), name
        assert [s.name for s in got] == [s.name for s in want], name
        for g, w in zip(got, want):
            assert g.frames == w.frames and len(g) == len(w)
            np.testing.assert_array_equal(g.gt_boxes, w.gt_boxes)
            np.testing.assert_array_equal(g.init_box, w.init_box)
            _leaves_equal(g.attributes, w.attributes)
        if name != "otb" or "missing" not in root:
            assert len(got), name


# ----------------------------------------------------------------- CLI


class TeleportTracker:
    """``tests/test_sot_harness.py``'s fake tracker: reports the gt box,
    with total misses on the given frames."""

    def __init__(self, gt, miss_frames=()):
        self.gt, self.miss, self.f = gt, set(miss_frames), 0

    def init(self, image, box):
        self.f += 1

    def update(self, image):
        f = self.f
        self.f += 1
        if f in self.miss:
            return np.array([0.0, 0.0, 1.0, 1.0]), 0.1
        return np.asarray(self.gt[min(f, len(self.gt) - 1)]), 0.9

    def track(self, frames, init_box):
        boxes, scores = [np.asarray(init_box, float)], [1.0]
        self.init(None, init_box)
        for _ in frames[1:]:
            b, s = self.update(None)
            boxes.append(b)
            scores.append(s)
        return np.stack(boxes), np.asarray(scores), np.full(len(frames),
                                                            1e-3)


def _moving_square_seq(T=6, H=160, W=160, size=36, step=6):
    frames, boxes = [], []
    for t in range(T):
        img = np.full((H, W, 3), 40, np.uint8)
        x = 30 + step * t
        y = 45 + (step // 2) * t
        img[y:y + size, x:x + size] = [220, 60, 60]
        frames.append(img)
        boxes.append([x, y, size, size])
    return frames, np.asarray(boxes, float)


def _sot_trees(root, T=6):
    """A two-sequence OTB tree and a one-sequence VOT tree (polygon gt)
    of the moving square, as PNG frames."""
    frames, gt = _moving_square_seq(T)
    for name, shift in (("sq0", 0), ("sq1", 3)):
        d = os.path.join(root, "otb", name, "img")
        os.makedirs(d)
        for i, f in enumerate(frames):
            Image.fromarray(np.roll(f, shift, 1)).save(
                os.path.join(d, f"{i:04d}.png"))
        np.savetxt(os.path.join(root, "otb", name, "groundtruth_rect.txt"),
                   gt + [shift, 0, 0, 0], delimiter=",", fmt="%.1f")
    d = os.path.join(root, "vot", "sq", "color")
    os.makedirs(d)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(d, f"{i:08d}.png"))
    x, y, w, h = gt.T
    poly = np.stack([x, y, x + w, y, x + w, y + h, x, y + h], 1)
    np.savetxt(os.path.join(root, "vot", "sq", "groundtruth.txt"), poly,
               delimiter=",", fmt="%.1f")
    return os.path.join(root, "otb"), os.path.join(root, "vot")


def _files(d):
    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                out[os.path.relpath(os.path.join(base, n), d)] = f.read()
    return out


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def test_sot_cli_result_files_equal_jax(tmp_path):
    """The harness on a tiny OTB and VOT tree with a tracker that makes
    no arithmetic (the gt, with misses): ``run_dataset``,
    ``run_vot_protocol`` (a failure, skips, a re-init), ``evaluate`` and
    ``evaluate_vot`` write byte-equal result files, print the same
    tables and return the same numbers as JAX's ``sot_cli``; so does
    ``main(["--eval_only", ...])`` (``tools/eval_sot_torch.py``), whose
    ``--plots`` figures decode to JAX's; ``track_video`` returns and draws
    JAX's boxes."""
    from tao_amodal_torch.cli import sot_cli as pc
    from tao_amodal_torch.data.sot_datasets import load_sot_dataset as pl
    from tao_amodal_tpu.cli import sot_cli as jc
    from tao_amodal_tpu.data.sot_datasets import load_sot_dataset as jl

    otb, vot = _sot_trees(str(tmp_path))
    for cli, load, out in ((pc, pl, "ours"), (jc, jl, "theirs")):
        rd = str(tmp_path / out)
        ds = load("otb", otb)
        for seq in ds:
            cli.run_dataset(TeleportTracker(seq.gt_boxes, {3}),
                            [seq], rd, "fake")
        vds = load("vot", vot)
        cli.run_vot_protocol(TeleportTracker(vds["sq"].gt_boxes, {2}), vds,
                             os.path.join(rd, "vot"), "fake", burnin=0,
                             skip_after_failure=2)
    assert _files(tmp_path / "ours") == _files(tmp_path / "theirs")
    assert b"2.0000" in _files(tmp_path / "ours")[
        os.path.join("vot", "fake", "baseline", "sq_001.txt")]
    for kind, root, extra in (("otb", otb, []),
                              ("vot", vot, ["--vot_protocol"])):
        args = ["--dataset", kind, "--dataset_root", root, "--tracker",
                "fake", "--eval_only", *extra]
        sub = "vot" if kind == "vot" else ""
        got = _quiet(pc.main, args + ["--result_dir",
                                      str(tmp_path / "ours" / sub)])
        want = _quiet(jc.main, args + ["--result_dir",
                                       str(tmp_path / "theirs" / sub)])
        assert got == want
    # --plots writes JAX's figures (the titles name the result
    # directory, so both trees are copied under one name).
    import shutil

    for out in ("ours", "theirs"):
        shutil.copytree(tmp_path / out, tmp_path / "plots" / out / "bench")
    figs = {}
    for out, cli in (("ours", pc), ("theirs", jc)):
        rd = str(tmp_path / "plots" / out / "bench")
        _quiet(cli.main, ["--dataset", "otb", "--dataset_root", otb,
                          "--tracker", "fake", "--eval_only", "--plots",
                          "--result_dir", rd])
        _quiet(cli.main, ["--dataset", "vot", "--dataset_root", vot,
                          "--tracker", "fake", "--eval_only", "--plots",
                          "--vot_protocol", "--result_dir",
                          os.path.join(rd, "vot")])
        figs[out] = {n: np.asarray(Image.open(os.path.join(rd, n)))
                     for n in ("ope_success.png", "ope_precision.png",
                               os.path.join("vot", "eao.png"))}
    for n, want in figs["theirs"].items():
        np.testing.assert_array_equal(figs["ours"][n], want, err_msg=n)
    # track_video reads a clip with cv2 (here an image sequence) and
    # returns JAX's boxes; its drawn frames decode to JAX's.
    frames, gt = _moving_square_seq(5)
    clip = tmp_path / "clip"
    clip.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(clip / f"{i:04d}.png")
    tracks = {}
    for out, cli in (("ours", pc), ("theirs", jc)):
        tracks[out] = cli.track_video(
            TeleportTracker(gt, {2}), str(clip / "%04d.png"), gt[0],
            output_path=str(tmp_path / "tracked" / out))
    np.testing.assert_array_equal(tracks["ours"], tracks["theirs"])
    assert tracks["ours"].shape == (5, 4)
    for i in range(5):
        got, want = (np.asarray(Image.open(
            tmp_path / "tracked" / out / f"{i:06d}.png"))
            for out in ("ours", "theirs"))
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def bridged():
    from tao_amodal_torch.utils.torch_convert import unflatten
    from tao_amodal_torch.utils.weights import flat_variables

    tm = siamese_model(0, "cpu", EX, INST, with_mask=True, with_refine=True)
    flat = flat_variables(tm)
    return tm, jax.tree_util.tree_map(jnp.asarray, unflatten(flat))


def _load_traj(path):
    rows = []
    with open(path) as f:
        for line in f:
            rows.append([float(v) for v in line.split(",")])
    return rows


def test_sot_cli_trackers_match_jax(tmp_path, bridged):
    """Real trackers through the harness (64/128 crops): SiamRPN one
    pass over the OTB tree and SiamMask through the VOT restart protocol
    (its polygons overlapping the gt through the host library): the
    port's result files hold JAX's markers exactly and its boxes and
    scores as closely as ``tests/test_torch_port_siamese.py`` holds a
    track (2e-3 of the box's size + 0.1 px; scores 5e-3, less the files'
    rounding)."""
    from tao_amodal_torch.cli import sot_cli as pc
    from tao_amodal_torch.data.sot_datasets import load_sot_dataset as pl
    from tao_amodal_torch.trackers.siammask import SiamMaskTracker as PM
    from tao_amodal_torch.trackers.siamrpn import SiamConfig as PCfg
    from tao_amodal_torch.trackers.siamrpn import SiamRPNTracker as PT
    from tao_amodal_tpu.cli import sot_cli as jc
    from tao_amodal_tpu.models.siamese import SiameseTracker
    from tao_amodal_tpu.trackers.siammask import SiamMaskTracker as JM
    from tao_amodal_tpu.trackers.siamrpn import SiamConfig as JCfg
    from tao_amodal_tpu.trackers.siamrpn import SiamRPNTracker as JT

    otb, vot = _sot_trees(str(tmp_path), T=5)
    tm, jv = bridged
    jm = SiameseTracker(num_levels=3, with_mask=True, with_refine=True)
    kw = dict(exemplar_size=EX, instance_size=INST, base_size=0, stride=8)
    ds = pl("otb", otb)
    pc.run_dataset(PT(tm, PCfg(**kw)), ds, str(tmp_path / "p"), "siamrpn")
    pc.run_vot_protocol(PM(tm, PCfg(**kw)), pl("vot", vot),
                        str(tmp_path / "p"), "siammask")
    jc.run_dataset(JT(jm, jv, JCfg(**kw)), ds, str(tmp_path / "j"),
                   "siamrpn")
    jc.run_vot_protocol(JM(jm, jv, JCfg(**kw)), pl("vot", vot),
                        str(tmp_path / "j"), "siammask")
    got, want = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert set(got) == set(want)
    for name in got:
        g = _load_traj(tmp_path / "p" / name)
        w = _load_traj(tmp_path / "j" / name)
        assert [len(r) for r in g] == [len(r) for r in w], name
        for a, b in zip(g, w):
            if len(a) == 1 and "confidence" not in name:
                assert a == b, name            # VOT markers
            elif len(a) == 1:
                assert abs(a[0] - b[0]) <= 5e-3 + 1e-4, name
            else:
                tol = 0.1 + 2e-3 * max(abs(b[2]), abs(b[3])) + 0.01
                assert np.abs(np.subtract(a, b)).max() <= tol, name


def test_sot_cli_main_on_cpu_with_checkpoint(tmp_path):
    """``main([... "--cpu", "--checkpoint", npz])`` at the default
    SiamConfig (127/255 crops, full-width ResNet-50) on the OTB tree and
    through the VOT protocol: the same files as ``run_dataset`` /
    ``run_vot_protocol`` of ``build_tracker(params=...)`` on the CPU; and
    the batched sweep's CLI (``tools/hp_search_torch.py``) over a 2-cell
    grid ranks its cells by the AUC of each cell's own run."""
    from tao_amodal_torch.cli import sot_cli as pc
    from tao_amodal_torch.data.sot_datasets import load_sot_dataset as pl
    from tao_amodal_torch.evaluation.sot_benchmarks import success_overlap
    from tao_amodal_torch.trackers.factory import build_tracker
    from tao_amodal_torch.trackers.siamrpn import (
        make_siamrpn_step,
        track_clip,
    )
    from tao_amodal_torch.utils.weights import flat_variables, load_flat

    otb, vot = _sot_trees(str(tmp_path), T=3)
    model = siamese_model(2, "cpu", 127, 255)
    npz = str(tmp_path / "siamese.npz")
    np.savez(npz, **flat_variables(model))
    flat = load_flat(npz)
    base = ["--dataset_root", otb, "--cpu", "--checkpoint", npz]
    _quiet(pc.main, ["--dataset", "otb", "--result_dir",
                     str(tmp_path / "cli"), *base])
    _quiet(pc.main, ["--dataset", "vot", "--dataset_root", vot,
                     "--vot_protocol", "--tracker", "siamrpn_lt",
                     "--result_dir", str(tmp_path / "cli"), "--cpu",
                     "--checkpoint", npz])
    tracker = build_tracker("siamrpn", params=flat, device="cpu")
    pc.run_dataset(tracker, pl("otb", otb), str(tmp_path / "api"),
                   "siamrpn")
    pc.run_vot_protocol(build_tracker("siamrpn_lt", params=flat,
                                      device="cpu"),
                        pl("vot", vot), str(tmp_path / "api"), "siamrpn_lt")
    assert _files(tmp_path / "cli") == _files(tmp_path / "api")

    out = str(tmp_path / "sweep.json")
    res, text = _quiet(pc.sweep_main, [
        "--dataset_root", otb, "--cpu", "--checkpoint", npz,
        "--penalty_k", "0.04,0.16", "--window_influence", "0.44",
        "--lr", "0.4", "--output", out])
    assert "best:" in text and os.path.exists(out)
    aucs = []
    for pk in (0.04, 0.16):
        cfg = tracker.cfg._replace(penalty_k=pk)
        auc = 0.0
        for seq in pl("otb", otb):
            frames = torch.from_numpy(np.stack(
                [np.asarray(Image.open(f).convert("RGB"))
                 for f in seq.frames]))
            boxes, _ = track_clip(*make_siamrpn_step(tracker.model, cfg),
                                  frames, seq.init_box)
            auc += success_overlap(seq.gt_boxes, boxes.numpy()).mean() / 2
        aucs.append(auc)
    assert res["auc"] == pytest.approx(max(aucs), abs=1e-9)
