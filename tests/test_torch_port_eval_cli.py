"""The port's eval CLI against the JAX package's, on the CPU.

The logs are compared line by line.  No line of either log carries a
wall time (the evaluators keep theirs in ``eval["date"]``, which no line
prints), so nothing is masked; the test checks that it stays so.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
from tabulate import tabulate

from fixture_gen import make_fixture

from tao_amodal_torch.cli.eval_cli import (
    DETECTION_METRICS,
    create_small_table,
    evaluate_detection,
    main as eval_main,
)

REPO = Path(__file__).resolve().parent.parent
# A clock time, a date, or seconds: none may appear in a log.
WALL_TIME = re.compile(r"\d\d:\d\d:\d\d|\d{4}-\d\d-\d\d|\d\s*s\b")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_cli")
    gt, preds = make_fixture(seed=1, num_videos=3, frames_per_video=12)
    (tmp / "gt.json").write_text(json.dumps(gt))
    (tmp / "preds.json").write_text(json.dumps(preds))
    return tmp


def _port_log(files, name, extra=()):
    log = files / name / "eval.log"
    eval_main(["--track_result", str(files / "preds.json"),
               "--output_log", str(log),
               "--annotation", str(files / "gt.json"), *extra])
    return log.read_text()


def test_log_equals_the_jax_cli_line_by_line(files):
    log = files / "jax" / "eval.log"
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "eval_on_tao_amodal.py"),
         "--track_result", str(files / "preds.json"),
         "--output_log", str(log), "--annotation", str(files / "gt.json")],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    theirs = log.read_text().splitlines()
    ours = _port_log(files, "host").splitlines()
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a == b
    assert not [ln for ln in ours if WALL_TIME.search(ln)]
    assert sum("copypaste:" in ln for ln in ours) == 4


def test_device_eval_log_equals_host_log(files):
    host = _port_log(files, "host2")
    assert _port_log(files, "device", ["--device_eval", "--device",
                                       "cpu"]) == host


def test_tool_script_runs_the_port(files):
    log = files / "tool" / "eval.log"
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "eval_on_tao_amodal_torch.py"),
         "--track_result", str(files / "preds.json"),
         "--output_log", str(log), "--annotation", str(files / "gt.json"),
         "--device_eval", "--device", "cpu"],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert log.read_text() == _port_log(files, "host3")


def _tabulate(d):
    keys, values = tuple(zip(*d.items()))
    return tabulate([values], headers=keys, tablefmt="pipe",
                    floatfmt=".3f", stralign="center", numalign="center")


def test_small_table_equals_tabulate_on_the_cli_metrics(files):
    import logging

    results = evaluate_detection(
        str(files / "gt.json"), str(files / "preds.json"), "bbox",
        logging.getLogger("test_torch_port_eval_cli"))
    assert list(results) == DETECTION_METRICS
    assert create_small_table(results) == _tabulate(results)


@pytest.mark.parametrize("values", [
    {"AP": -100.0, "AP50-OOF": 0.0, "APr": 99.9996},
    {"a": -0.0004, "a_much_longer_header": 12345.6785, "b": 5.0},
    {"AP": 1e-9, "AP75-HP": 100.0}])
def test_small_table_equals_tabulate(values):
    assert create_small_table(values) == _tabulate(values)
