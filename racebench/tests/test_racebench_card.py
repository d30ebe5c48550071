"""The benchmark's command on a card: every cell runs end to end, short, and
is correct; a traced run reports its per-layer metrics; a directory holding
only the benchmark's files gives no result.  Each test skips without a CUDA
card.  On the card:

    python -m pytest -q -m cuda racebench/tests/test_racebench_card.py
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (ROOT / "src", HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import benchspec  # noqa: E402

BENCH = benchspec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_cell(name, trace=0, cwd=ROOT, seconds=2):
    proc = subprocess.run(
        [sys.executable, "racebench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 101), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, timeout=1200, cwd=cwd)
    return proc


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_and_is_correct(card, name):
    proc = run_cell(name)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    cell = benchspec.cell(BENCH, name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def test_a_traced_run_reports_every_per_layer_metric(card):
    name = "j3d27pt.grad512"
    proc = run_cell(name, trace=1)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    cell = benchspec.cell(BENCH, name)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["metrics"]["adjoint_roofline.grad"]["value"] < 100


def test_only_the_benchmarks_files_give_no_result(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "racebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cell(CELLS[0], cwd=tmp_path)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
