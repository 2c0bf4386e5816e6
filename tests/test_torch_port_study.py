"""The port's accuracy study (``infer`` and ``main``), day-one tree and
scale rehearsal held against the JAX tools on the CPU, on one seeded
checkpoint (JAX's init of the study's (1,1,1,1) detector, perturbed by
``torch_port_fixtures.perturb``, written by JAX's ``save_pytree``):

* ``main`` with ``--resume_ckpt`` over two arms (``res64``,
  ``res64_noexpander``) and two val groups: the same cells, integers
  equal, every AP (and group AP) within 1e-6, the prediction records
  within the detector's tolerances (boxes rtol 1e-4 + 1e-3 px, scores
  1e-5), ``tools/summarize_study.py``'s table the same; a resumed run
  extends the study file;
* ``data/dayone_fixture.build`` writes the JAX tool's tree byte for byte;
* ``scale_rehearsal.main --cpu`` writes JAX's prediction integers and
  Track-mAP and detection AP.
"""

import json
import os

import numpy as np
import pytest

from tao_amodal_torch.cli import accuracy_study as study
from tao_amodal_torch.cli import scale_rehearsal
from tao_amodal_torch.data.dayone_fixture import build
from tools import accuracy_study as jax_study
from tools import make_dayone_fixture as jax_dayone
from tools import scale_rehearsal as jax_rehearsal
from tools import summarize_study
from torch_port_fixtures import jax_pipeline, one_torch_thread, save_npz

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

ARCH = dict(num_classes=3, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
STUDY = ["--hw", "64", "--videos_train", "1", "--videos_val", "2",
         "--frames", "8", "--tracks", "2", "--num_dets", "8",
         "--resolutions", "64", "--skip_exact", "--expander_ablation",
         "--val_groups", "2"]
AP_TOL = 1e-6
INT_FIELDS = ("image_id", "category_id", "track_id", "video_id")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    _, variables = jax_pipeline(seed=3, **ARCH)
    return save_npz(tmp_path_factory.mktemp("ckpt"), variables)


@pytest.fixture(scope="module")
def jax_run(ckpt, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax")
    out = str(d / "study.json")
    results = jax_study.main(["--cpu", "--resume_ckpt", ckpt, *STUDY,
                              "--workdir", str(d / "work"), "--out", out])
    return results, out, str(d / "work")


def _records(workdir, name):
    with open(os.path.join(workdir, f"preds_{name}.json")) as f:
        return sorted(json.load(f), key=lambda r: (
            r["video_id"], r["image_id"], r["track_id"], r["category_id"]))


def assert_records_close(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert [a[k] for k in INT_FIELDS] == [b[k] for k in INT_FIELDS]
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=1e-4,
                                   atol=1e-3)
        assert abs(a["score"] - b["score"]) <= 1e-5


def assert_cells_close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key])
        for field, w in want[key].items():
            if field == "infer_seconds":
                continue
            np.testing.assert_allclose(got[key][field], w, rtol=0,
                                       atol=AP_TOL, err_msg=(key, field))


def test_study_main_matches_jax(ckpt, jax_run, tmp_path, capsys):
    """Both arms' cells and group lists, and the records of every cell
    and group, against JAX's; ``summarize_study`` prints the same table
    for both files."""
    want, jax_out, jax_work = jax_run
    out = str(tmp_path / "study.json")
    work = str(tmp_path / "work")
    got = study.main(["--cpu", "--resume_ckpt", ckpt, *STUDY, "--workdir",
                      work, "--out", out])
    assert sorted(got) == ["ckpt0_res64", "ckpt0_res64_noexpander"]
    assert_cells_close(got, want)
    with open(out) as f:
        assert json.load(f) == got
    for name in ("0_res64", "0_res64_noexpander", "0_res64_g0",
                 "0_res64_g1"):
        assert_records_close(_records(work, name), _records(jax_work, name))
    capsys.readouterr()
    tables = []
    for path in (out, jax_out):
        summarize_study.main([path, "--base", "res64"])
        tables.append(capsys.readouterr().out)
    assert tables[0] == tables[1] and "noexpander" in tables[0]


def test_study_resume_extends_the_study_file(ckpt, jax_run, tmp_path):
    """``--only_tags res64`` writes one cell; a second run with
    ``--resume_ckpt`` and both arms keeps it as it was (a recorded cell
    is final) and adds the other, equal to JAX's."""
    want = jax_run[0]
    out = str(tmp_path / "study.json")
    args = ["--cpu", "--resume_ckpt", ckpt, *STUDY, "--workdir",
            str(tmp_path / "work"), "--out", out]
    first = study.main(args + ["--only_tags", "res64"])
    assert sorted(first) == ["ckpt0_res64"]
    with open(out) as f:
        first_file = json.load(f)
    second = study.main(args)
    assert second["ckpt0_res64"] == first_file["ckpt0_res64"]
    assert_cells_close(second, want)
    with pytest.raises(ValueError, match="matched nothing"):
        study.main(args + ["--only_tags", "res999"])


def _tree_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_dayone_tree_is_byte_equal(tmp_path):
    """Frames (JPEG bytes), the annotation file, the example predictions
    and the BURST masks, for a seed and size off the defaults."""
    kw = dict(num_videos=7, frames_per_video=3, hw=48, tracks_per_video=3,
              seed=5)
    want = _tree_files(jax_dayone.build(str(tmp_path / "jax"), **kw))
    got = _tree_files(build(str(tmp_path / "port"), **kw))
    assert sorted(got) == sorted(want)
    assert len([k for k in want if k.endswith(".jpg")]) == 21
    for name in want:
        assert got[name] == want[name], name


def test_rehearsal_matches_jax(ckpt, tmp_path):
    """The port's rehearsal with ``--cpu`` and JAX's on the same tree
    (seed, size) and checkpoint: the prediction records (integers equal,
    boxes and scores within the detector's tolerances) and the summary's
    Track-mAP and detection AP."""
    args = ["--videos", "2", "--frames", "6", "--hw", "64", "--tracks", "2",
            "--input_size", "64", "--backbone_stages", "1,1,1,1",
            "--num_dets", "8", "--num_proposals", "16", "--checkpoint", ckpt]
    runs = {}
    for name, main, extra in (("jax", jax_rehearsal.main, []),
                              ("port", scale_rehearsal.main, ["--cpu"])):
        work = tmp_path / name
        summary = main(args + extra + ["--workdir", str(work), "--out",
                                       str(tmp_path / f"{name}.json")])
        path = work / "TAO-Amodal" / "lvis_instances_results.json"
        with open(path) as f:
            records = sorted(json.load(f), key=lambda r: (
                r["video_id"], r["image_id"], r["track_id"]))
        runs[name] = summary, records
    (got, got_rec), (want, want_rec) = runs["port"], runs["jax"]
    assert_records_close(got_rec, want_rec)
    for k in ("num_predictions", "videos", "frames_per_video", "hw",
              "tracks_per_video", "checkpoint"):
        assert got[k] == want[k], k
    for k in ("track_map", "track_map50", "det_ap", "det_ap50"):
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
