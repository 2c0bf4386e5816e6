"""The port's host utilities held against the JAX package on the CPU:
checkpoints (``save_pytree``/``load_pytree`` across packages,
``load_pretrain``), the study's optimizer (``cosine_decay_schedule``,
``adamw`` without a clip), profiling (``print_speed``, ``StepTimer``,
``ScalarWriter``, ``device_trace``), ``utils/fs.py``, the annotation
converters and the stress evaluator."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tao_amodal_torch.evaluation as port_eval
import tao_amodal_tpu.evaluation as jax_eval
from tao_amodal_torch.cli import stress_eval
from tao_amodal_torch.data import converters
from tao_amodal_torch.train import optim
from tao_amodal_torch.utils import checkpoint, fs, profiling
from tao_amodal_tpu.data import converters as jconverters
from tao_amodal_tpu.utils import checkpoint as jcheckpoint
from tao_amodal_tpu.utils import fs as jfs
from tao_amodal_tpu.utils import profiling as jprofiling
from test_torch_port_train import OPT_TOL, _updates
from tools import stress_eval as jax_stress_eval


def _tree(rs):
    conv = {"kernel": rs.randn(3, 3, 4, 8).astype(np.float32),
            "bias": rs.randn(8).astype(np.float32)}
    return {"detector": {"params": {"conv": conv},
                         "batch_stats": {"bn": {"mean": np.zeros(8)}}},
            "step": np.asarray(7, np.int32),
            "scale": np.asarray(0.5, np.float64)}


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_save_pytree_loads_in_either_package(tmp_path):
    """A port-written npz loads in JAX's ``load_pytree`` and a JAX-written
    one in the port's, every leaf's dtype, shape and value kept; the
    files hold the same arrays."""
    tree = _tree(np.random.RandomState(0))
    checkpoint.save_pytree(tmp_path / "port.npz", tree)
    jcheckpoint.save_pytree(tmp_path / "jax.npz", tree)
    _assert_trees_equal(jcheckpoint.load_pytree(tmp_path / "port.npz"), tree)
    _assert_trees_equal(checkpoint.load_pytree(tmp_path / "jax.npz"), tree)
    assert checkpoint.flatten(tree).keys() == jcheckpoint.flatten(
        tree).keys()
    a = checkpoint.load_flat(tmp_path / "port.npz")
    b = checkpoint.load_flat(tmp_path / "jax.npz")
    assert list(a) == list(b)


@pytest.mark.parametrize("strip_prefix", [None, "model/"])
def test_load_pretrain_matches_jax(strip_prefix):
    """The merged tree and the report (loaded, missing, unused, shape
    mismatch) equal JAX's, with and without a stripped prefix."""
    rs = np.random.RandomState(1)
    params = {"backbone": {"w": np.zeros((3, 3), np.float32),
                           "b": np.zeros(3, np.float32)},
              "head": {"w": np.zeros((2, 2), np.float32)}}
    p = strip_prefix or ""
    pretrained = {f"{p}backbone": {"w": rs.randn(3, 3).astype(np.float32),
                                   "b": rs.randn(4).astype(np.float32)},
                  f"{p}extra": {"v": rs.randn(5).astype(np.float32)},
                  "head": {"w": rs.randn(2, 2).astype(np.float32)}}
    pretrained = checkpoint.unflatten(checkpoint.flatten(pretrained))
    got, got_report = checkpoint.load_pretrain(params, pretrained,
                                               strip_prefix=strip_prefix)
    want, want_report = jcheckpoint.load_pretrain(
        params, pretrained, strip_prefix=strip_prefix)
    assert got_report == want_report
    assert got_report["loaded"] and got_report["missing"]
    assert got_report["unused"] and got_report["shape_mismatch"]
    a, b = checkpoint.flatten(got), jcheckpoint.flatten(want)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))


@pytest.mark.parametrize("init_value, decay_steps, alpha",
                         [(1e-3, 500, 1e-2), (3e-4, 7, 0.0), (0.1, 40, 0.5)])
def test_cosine_decay_schedule_matches_optax(init_value, decay_steps,
                                             alpha):
    """At every count of a run and past its end, within 2.5e-7 of
    ``init_value``: two f32 ulps of the cosine near 1, where optax's
    jitted ``cos`` and numpy's part by one (optax's jitted and
    op-by-op forms differ by as much)."""
    want = jax.jit(optax.cosine_decay_schedule(init_value, decay_steps,
                                               alpha))
    got = optim.cosine_decay_schedule(init_value, decay_steps, alpha)
    for count in range(decay_steps + 3):
        w = float(want(jnp.int32(count)))
        assert abs(got(count) - w) <= 2.5e-7 * init_value, (count, w)
    with pytest.raises(ValueError):
        optim.cosine_decay_schedule(1e-3, 0)


def test_adamw_matches_optax():
    """``adamw`` (no clip; weight decay on every leaf) on the cosine
    schedule over three updates of random leaves, fed the same
    gradients as ``optax.adamw``: every leaf within 1e-6 of its largest
    after each update; ``make_adamw(clip_norm=None)`` is the same
    chain."""
    rs = np.random.RandomState(2)
    shapes = {"a": (3, 5, 7, 2), "b": (11,), "c": (4, 9)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads_seq = [{n: (scale * rs.randn(*s)).astype(np.float32)
                  for n, s in shapes.items()} for scale in (0.3, 40.0, 1e-3)]
    want = _updates(optax.adamw(optax.cosine_decay_schedule(1e-2, 3, 1e-2)),
                    params, grads_seq, False)
    for opt in (optim.adamw(optim.cosine_decay_schedule(1e-2, 3, 1e-2)),
                optim.make_adamw(optim.cosine_decay_schedule(1e-2, 3, 1e-2),
                                 clip_norm=None)):
        got = _updates(opt, params, grads_seq, True)
        for a, w in zip(got, want):
            for n in shapes:
                err = np.abs(a[n] - w[n]).max()
                assert err <= OPT_TOL * np.abs(w[n]).max(), (n, err)
    assert len(optim.adamw(1e-3).init([torch.zeros(2)])) == 3


def test_print_speed_and_step_timer_match_jax(monkeypatch, capsys):
    """``print_speed``'s line (returned, logged and printed) for several
    steps, and ``StepTimer``'s sections on one fake clock."""
    import logging

    for step, total, dt in ((0, 100, 0.25), (37, 1000, 1.5),
                            (999, 1000, 12.0), (5, 0, 3.0)):
        assert profiling.print_speed(step, total, dt) == \
            jprofiling.print_speed(step, total, dt)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 8 and out[0::2] == out[1::2]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("test_print_speed")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    profiling.print_speed(3, 10, 0.5, logger=log)
    jprofiling.print_speed(3, 10, 0.5, logger=log)
    assert records[0].getMessage() == records[1].getMessage()

    summaries = []
    for mod in (profiling, jprofiling):
        ticks = iter(np.arange(0.0, 100.0, 0.125))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        timer = mod.StepTimer()
        for name in ("data", "step", "data", "step", "step"):
            with timer.section(name):
                pass
        summaries.append((timer.summary(), dict(timer.counts),
                          timer.avg_ms("missing")))
    assert summaries[0] == summaries[1]
    assert summaries[0][1] == {"data": 2, "step": 3}


def test_scalar_writer_records_match_jax(tmp_path):
    """The JSONL stream's records (tag, value, step; the time field
    aside) and their order."""
    streams = []
    for name, mod in (("port", profiling), ("jax", jprofiling)):
        w = mod.ScalarWriter(str(tmp_path / name))
        for step in range(3):
            w.scalar("loss", np.float32(1.0 / (step + 1)), step)
            w.scalar("lr", 1e-3 * step, np.int64(step))
        w.close()
        with open(tmp_path / name / "scalars.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert all(isinstance(r.pop("time"), float) for r in rows)
        streams.append(rows)
    assert streams[0] == streams[1] and len(streams[0]) == 6


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    """``device_trace`` profiles the block and writes a Chrome trace
    holding its ops."""
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum()
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_fs_helpers_match_jax(tmp_path):
    """``parse_bool``, ``simple_table`` and the detection-mat round trip
    (either package reads the other's file; the files are equal), and
    ``glob_ext``."""
    for v in (True, False, "yes", "True", "t", "1", "no", "0", 1, 0,
              "false", "TRUE", None):
        assert fs.parse_bool(v) == jfs.parse_bool(v), v
    for rows in ([], [("a", 1)], [("long key", 2.5), ("k", "v"), (3, None)]):
        assert fs.simple_table(rows) == jfs.simple_table(rows)
    dets = np.random.RandomState(3).uniform(0, 500, (7, 7))
    fs.dump_detection_mat(tmp_path / "port.txt", dets)
    jfs.dump_detection_mat(tmp_path / "jax.txt", dets)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    np.testing.assert_array_equal(
        fs.load_detection_mat(tmp_path / "jax.txt"),
        jfs.load_detection_mat(tmp_path / "port.txt"))
    np.savetxt(tmp_path / "one.txt", dets[:1], delimiter=",")
    assert fs.load_detection_mat(tmp_path / "one.txt").shape == (1, 7)
    for name in ("a.JPG", "b.png", "c.txt", "d.mp4"):
        (tmp_path / name).write_text("")
    assert fs.glob_ext(str(tmp_path), fs.IMG_EXTENSIONS) == jfs.glob_ext(
        str(tmp_path), jfs.IMG_EXTENSIONS)
    assert fs.VID_EXTENSIONS == jfs.VID_EXTENSIONS


def _write_vid_xml(d, rs):
    os.makedirs(d)
    for i in range(3):
        objs = "".join(
            f"<object><trackid>{t}</trackid><name>n0{t % 2}</name>"
            f"<bndbox><xmax>{x + 20}</xmax><xmin>{x}</xmin>"
            f"<ymax>{y + 30}</ymax><ymin>{y}</ymin></bndbox></object>"
            for t, (x, y) in enumerate(rs.randint(0, 100, (i + 1, 2))))
        name = "" if i == 2 else f"<filename>{i:06d}</filename>"
        with open(os.path.join(d, f"{i:06d}.xml"), "w") as f:
            f.write(f"<annotation>{name}<size><width>640</width>"
                    f"<height>480</height></size>{objs}</annotation>")


def test_converters_match_jax(tmp_path):
    """ImageNet-VID XML (with and without a category map), a VIA project
    (rect regions kept, others skipped; from a dict and a file), BURST to
    the TrackEval layout (the same files and script), and the dataset
    registry."""
    rs = np.random.RandomState(4)
    xml = str(tmp_path / "xml")
    _write_vid_xml(xml, rs)
    for cmap in (None, {"n00": 5}):
        assert converters.imagenetvid_to_coco(xml, cmap) == \
            jconverters.imagenetvid_to_coco(xml, cmap)

    via = {"_via_img_metadata": {
        "b.jpg": {"filename": "b.jpg", "regions": [
            {"shape_attributes": {"name": "rect", "x": 1, "y": 2,
                                  "width": 3, "height": 4},
             "region_attributes": {"label": "car"}},
            {"shape_attributes": {"name": "polygon"}}]},
        "a.jpg": {"regions": []}}}
    path = tmp_path / "via.json"
    path.write_text(json.dumps(via))
    for src in (via, str(path)):
        got = converters.via_to_coco(src)
        assert got == jconverters.via_to_coco(src)
    assert len(got["annotations"]) == 1

    burst = {"sequences": [
        {"dataset": "LaSOT", "seq_name": f"s{i}", "id": i,
         "segmentations": [{"1": {"rle": "abc"}}]} for i in range(2)]}
    trees = {}
    for name, mod in (("port", converters), ("jax", jconverters)):
        out = str(tmp_path / name)
        info = mod.burst_to_trackeval(burst, out, split="val")
        assert info["num_sequences"] == 2
        assert os.access(info["script"], os.X_OK)
        files = {}
        for dirpath, _, names in os.walk(out):
            for n in names:
                p = os.path.join(dirpath, n)
                with open(p) as f:
                    files[os.path.relpath(p, out)] = f.read().replace(out,
                                                                       "OUT")
        trees[name] = files
    assert trees["port"] == trees["jax"]

    for mod in (converters, jconverters):
        mod.register_dataset("toy_port_test", lambda: {"images": [1]})
        assert mod.get_dataset("toy_port_test") == {"images": [1]}
        assert "toy_port_test" in mod.list_datasets()
    assert converters.list_datasets() == jconverters.list_datasets()


def _recording(cls, store, name):
    class Recording(cls):
        def get_results(self):
            out = super().get_results()
            store[name] = {k: float(v) for k, v in out.items()}
            return out
    return Recording


def test_stress_eval_matches_jax(monkeypatch):
    """``--cpu`` at a tiny size: the same fixture counts as JAX's
    ``tools/stress_eval.py --cpu``, its host metrics equal JAX's (1e-12),
    and ``--device_eval`` on the CPU holds the device evaluators to the
    host ones."""
    args = ["--num_videos", "6", "--frames_per_video", "8", "--num_cats",
            "5", "--tracks_per_video", "3", "--seed", "11"]
    got, want = {}, {}
    for mod, store in ((port_eval, got), (jax_eval, want)):
        monkeypatch.setattr(mod, "TrackMapEvaluator", _recording(
            mod.TrackMapEvaluator, store, "track"))
        monkeypatch.setattr(mod, "AmodalDetectionEvaluator", _recording(
            mod.AmodalDetectionEvaluator, store, "det"))
    summary = stress_eval.main(args + ["--cpu", "--device_eval"])
    jax_summary = jax_stress_eval.main(args + ["--cpu"])
    for k in ("videos", "gt_anns", "preds", "cats"):
        assert summary[k] == jax_summary[k], k
    assert summary["device_track_s"] >= 0
    assert sorted(got) == sorted(want) == ["det", "track"]
    for name in want:
        assert set(got[name]) == set(want[name])
        for k, v in want[name].items():
            assert abs(got[name][k] - v) <= 1e-12, (name, k)
    assert want["track"]["AP50"] > 0
