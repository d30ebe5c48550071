"""The harness on the CPU: names found in ``BENCHMARK.json``, the rules its
entries keep, the result's line, the import guard, the refusal to run
without a card, the traffic drawn from the seed and the trace reader.

A run here drives the whole harness at tiny extents on the CPU, where the
port's kernel runs as its tile emulator; ``run.py`` itself refuses the CPU.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (ROOT / "src", HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import benchspec  # noqa: E402
import devtrace  # noqa: E402
import drive  # noqa: E402
import readings  # noqa: E402
import run  # noqa: E402

BENCH = benchspec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_cell(name):
    """The cell at a tiny extent (and 3 examples where it has a batch axis)
    for a CPU run."""
    cell = benchspec.cell(BENCH, name)
    tr = {**cell.traffic, "extent": 8 + 2 * cell.program().HALO}
    if tr["batch"]:
        tr["batch"] = 3
    cell.traffic = tr
    return cell


def cpu_line(name, traced=False, seed=2 ** 31 + 11):
    return drive.measure(small_cell(name), seed, 0.3, traced, "cpu")


# -- names ---------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_each_cell_and_its_files_are_found_by_name(name):
    cell = benchspec.cell(BENCH, name)
    prog = cell.program()
    kind = cell.kind()
    assert cell.reference().forward
    assert all(callable(getattr(cell.work(), w)) for w in kind.WORK)
    assert prog.build(12).body
    assert kind.call and kind.reference and kind.gaps
    assert cell.limits and cell.control_dtype
    for m in cell.end_to_end:
        assert benchspec.module("end_to_end", m["name"]).read
    for m in cell.per_layer:
        assert benchspec.module("layers", m["name"]).read


def test_unknown_names_fail():
    with pytest.raises(benchspec.SpecError):
        benchspec.cell(BENCH, "j3d27pt.nope")
    bad = json.loads(json.dumps(BENCH))
    bad["workloads"][0]["traffic"] = "nope"
    with pytest.raises(benchspec.SpecError):
        benchspec.cell(bad, CELLS[0])
    bad = json.loads(json.dumps(BENCH))
    bad["workloads"][0]["config"] = "nope"
    with pytest.raises(benchspec.SpecError):
        benchspec.cell(bad, CELLS[0])
    with pytest.raises(benchspec.SpecError):
        benchspec.module("layers", "no_such_metric")
    cell = benchspec.cell(BENCH, CELLS[0])
    cell.traffic = {**cell.traffic, "kind": "no_such_kind"}
    with pytest.raises(benchspec.SpecError, match="no_such_kind"):
        drive.Run(cell, 1, "cpu")


def test_a_kind_whose_work_the_program_lacks_fails_by_name():
    """A traffic kind that needs a backward's counts, on a program whose
    ``work`` file has none, fails naming the missing function."""
    cell = small_cell(next(c for c in CELLS
                           if not hasattr(benchspec.cell(BENCH, c).work(),
                                          "backward")))
    cell.traffic = {**cell.traffic, "kind": "grad"}
    with pytest.raises(benchspec.SpecError, match=r"has no backward\(\)"):
        drive.Run(cell, 1, "cpu")


def test_run_refuses_an_unknown_workload():
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "no.such",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 2 and not proc.stdout.strip()
    assert "no workload 'no.such'" in proc.stderr


def test_names_and_units_keep_the_rules():
    assert benchspec.problems(BENCH) == []
    bad = json.loads(json.dumps(BENCH))
    bad["end_to_end"][0]["unit"] = "points per s"
    bad["per_layer"][0]["name"] = "build ms"
    bad["workloads"][1]["name"] = bad["workloads"][0]["name"]
    found = "\n".join(benchspec.problems(bad))
    assert "bad unit" in found and "bad name 'build ms'" in found
    assert "named twice" in found


def test_a_per_layer_metric_moves_what_all_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for c in CELLS:
            if benchspec.reports(m, c, BENCH):
                assert benchspec.reports(e2e[m["moves"]], c, BENCH), (m, c)
    bad = json.loads(json.dumps(BENCH))
    moved = next(m for m in bad["per_layer"] if m["name"] == "host_us.grad")
    moved["workloads"] = ["j3d27pt.sweep512"]
    assert any("does not report grad_gpts" in p
               for p in benchspec.problems(bad))


def test_the_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "racebench/run.py"]
    assert BENCH["paths"] == ["racebench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("racebench/") and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    texts = ([c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [w["why"] for w in BENCH["workloads"]]
             + [m["layer"] for m in BENCH["per_layer"]])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


# -- the result's line ---------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_line_has_the_contracts_keys_and_checks_last(name):
    line = cpu_line(name)
    assert list(line) == LINE_KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = benchspec.cell(BENCH, name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got == {"value": got["value"], "unit": m["unit"]}
        assert got["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def host_side(cell):
    """The cell with only its per-layer metrics that a CPU run can read
    (no device runs here, so a device trace holds nothing)."""
    cell.per_layer = [m for m in cell.per_layer
                      if m["source"] != "device_trace"]
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_line_adds_breakdown_and_the_host_layers(name):
    cell = host_side(small_cell(name))
    line = drive.measure(cell, 2 ** 31 + 11, 0.3, True, "cpu")
    assert list(line) == LINE_KEYS + ["breakdown", "checks"]
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert "build_ms" in line["metrics"]
    host = next(m for m in line["metrics"] if m.startswith("host_us."))
    assert line["metrics"][host]["value"] > 0


def test_a_listed_metric_with_nothing_to_read_fails_the_run():
    """A device metric that ``BENCHMARK.json`` lists for the cell, in a
    run whose trace holds no device activity, fails the run rather than
    leaving the metric out."""
    cell = small_cell(CELLS[0])
    assert any(m["source"] == "device_trace" for m in cell.per_layer)
    with pytest.raises(benchspec.SpecError, match="nothing for it to read"):
        drive.measure(cell, 2 ** 31 + 13, 0.2, True, "cpu")


def test_a_kind_may_bring_its_own_build_and_window():
    """A traffic kind's ``build`` and ``loop``, where it has them, stand in
    for RACE's build and the closed loop."""
    from types import SimpleNamespace

    from repro_torch import race

    cell = small_cell(CELLS[0])
    base = cell.kind()
    seen = []

    def build(run):
        seen.append("build")
        return race(run.program.build(run.traffic["extent"]))

    def loop(run, seconds, rng):
        seen.append("loop")
        answer, host = run._step(run.inputs[0], rng)
        run.calls, run.last = 1, (0, 0, answer)
        return drive.Window(calls=1, elapsed=2.0, host_s=host)

    kind = SimpleNamespace(**{k: getattr(base, k) for k in
                              ("WORK", "call", "reference", "gaps")},
                           build=build, loop=loop)
    cell.kind = lambda: kind
    line = drive.measure(cell, 2 ** 31 + 17, 0.2, False, "cpu")
    assert seen == ["build", "loop"]
    assert line["correct"] is True and line["attempted"] == 1
    rate = next(m for m in line["metrics"] if m != "setup_s")
    assert line["metrics"][rate]["value"] == pytest.approx(
        cell.work().points(cell.traffic["extent"]) / 2.0 / 1e9)


def test_a_limit_below_the_runs_reading_makes_it_not_correct():
    cell = small_cell("j3d27pt.sweep512")
    cell.limits = {"max_rel_err": 0.0}
    line = drive.measure(cell, 5, 0.2, False, "cpu")
    assert line["correct"] is False and line["failed"] >= 1


# -- the guard and the card ----------------------------------------------

def test_the_import_guard_rejects_jax_and_repro_but_not_repro_torch():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.race", "repro_torch", "repro_torch.core.race",
             "reproducible", "jaxtyping", "torch"]
    assert run.forbidden(names) == ["flax.linen", "jax", "jax.numpy",
                                    "jaxlib.xla_client", "repro",
                                    "repro.core.race"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "nothing runs on the CPU" in proc.stderr


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    for path in HERE.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro"), path
        if path != Path(__file__).resolve():
            assert "benchmarks/" not in path.read_text(), path


# -- traffic -------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_inputs_follow_the_seed(name):
    cell = small_cell(name)
    prog = cell.program()
    a = drive.draw_inputs(cell, 2 ** 31 + 7, "cpu")
    b = drive.draw_inputs(cell, 2 ** 31 + 7, "cpu")
    c = drive.draw_inputs(cell, 2 ** 32 + 9, "cpu")
    assert len(a) == cell.traffic["pool"]
    lead = (cell.traffic["batch"],) if cell.traffic["batch"] else ()
    n = cell.traffic["extent"]
    for x, y, z in zip(a, b, c):
        for k in prog.ARRAYS + prog.SCALARS:
            assert torch.equal(x[k], y[k])
            assert x[k].shape == z[k].shape and not torch.equal(x[k], z[k])
            assert x[k].dtype == getattr(torch, cell.traffic["dtype"])
        for k in prog.ARRAYS:
            assert x[k].shape == lead + tuple(prog.array_shape(n))
        for t in x.get("cotangent", {}).values():
            assert t.shape == lead + tuple(prog.output_shape(n))
        assert float(x[prog.ARRAYS[0]].detach().min()) >= -1
        assert float(x[prog.SCALARS[0]].detach().min()) >= 0.25
    assert not torch.equal(a[0][prog.ARRAYS[0]], a[1][prog.ARRAYS[0]])


def test_a_configuration_can_fix_a_scalar_for_every_seed():
    cell = small_cell(CELLS[0])
    prog = cell.program()
    fixed, drawn = prog.SCALARS[0], prog.SCALARS[1]
    cell.config = {**cell.config, "scalars": {fixed: -2.5}}
    a = drive.draw_inputs(cell, 2 ** 31 + 7, "cpu")
    c = drive.draw_inputs(cell, 2 ** 32 + 9, "cpu")
    for x, z in zip(a, c):
        assert float(x[fixed]) == float(z[fixed]) == -2.5
        assert not torch.equal(x[drawn], z[drawn])


# -- the trace reader ----------------------------------------------------

def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_the_trace_reader_ties_device_work_to_the_range_that_launched_it():
    events = [
        _ev("user_annotation", "racebench.window", 0, 1000),
        _ev("user_annotation", "racebench.backward", 100, 200),
        _ev("user_annotation", "racebench.backward", 500, 200),
        # launched on autograd's thread while the caller waits in its range
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, tid=2, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 160, 5, tid=2, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 550, 5, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 900, 5, correlation=4),
        _ev("cpu_op", "aten::copy_", 590, 10, **{"External id": 9}),
        _ev("kernel", "k1", 200, 100, tid=7, correlation=1),
        _ev("gpu_memset", "fill", 300, 50, tid=7, correlation=2),
        _ev("kernel", "k1", 600, 100, tid=7, correlation=3),
        _ev("kernel", "glue", 700, 20, tid=7, **{"External id": 9}),
        _ev("kernel", "outside", 950, 10, tid=7, correlation=4),
        _ev("gpu_user_annotation", "racebench.backward", 100, 600, tid=7),
    ]
    tr = devtrace.Trace(events)
    per = tr.per_range("backward")
    assert per == [[pytest.approx(150e-6), 1], [pytest.approx(120e-6), 2]]
    assert tr.window_s() == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(280e-6)
    ops = dict(tr.device_ops())
    assert ops["k1"] == pytest.approx(200e-6)
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(250e-6)
    assert sum(g for _, g in gaps) == pytest.approx(720e-6)
    assert gaps[0][0] == "between calls"


def test_build_ms_counts_each_span_once():
    spans = [{"path": "detect", "dur_us": 1000.0},
             {"path": "contract", "dur_us": 500.0},
             {"path": "adjoint_build", "dur_us": 4000.0},
             {"path": "adjoint_build/detect", "dur_us": 3000.0},
             {"path": "lower", "dur_us": 250.0},
             {"path": "compile", "dur_us": 9000.0}]
    assert readings.span_total_ms(spans) == pytest.approx(5.75)


def test_p95_is_the_95th_percentile_of_every_call():
    assert readings.p95([float(i) for i in range(1, 101)]) == pytest.approx(95.05)
    assert readings.p95([3.0]) == 3.0
