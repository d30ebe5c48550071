"""The port's examples (``examples/*_torch.py``) run on the CPU at their
quickest settings and print what the reference's examples print."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

pytestmark = pytest.mark.port

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_has_a_port_side_copy():
    ref = {p.stem for p in EXAMPLES.glob("*.py")
           if not p.stem.endswith("_torch")}
    assert {f"{s}_torch" for s in ref} <= {p.stem for p in
                                          EXAMPLES.glob("*_torch.py")}


def test_quickstart(capsys):
    _load("quickstart_torch.py").main(["--device", "cpu", "--n", "64"])
    out = capsys.readouterr().out
    from repro.apps.paper_kernels import pop_calc_tpoints
    from repro.core.race import race

    ref = race(pop_calc_tpoints(nx=64, ny=64).program, reassociate=3)
    assert f"auxiliary arrays found : {ref.n_aux()}" in out
    assert f"detection iterations   : {ref.rounds()}" in out
    assert f"reduced ops            : {ref.reduced_ops():.2f}" in out
    assert "cpu wall-clock: baseline" in out


def test_optimize_stencil(capsys):
    _load("optimize_stencil_torch.py").main(["--device", "cpu", "--n", "16"])
    out = capsys.readouterr().out
    assert "kernel == oracle: OK" in out
    assert "frontend == DSL: OK" in out


def test_serve_batch(tmp_path):
    r = subprocess.run(
        [sys.executable, str(EXAMPLES / "serve_batch_torch.py"), "--device",
         "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, HOME=str(tmp_path)))
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["arch"] == "falcon-mamba-7b-reduced" and out["batch"] == 4


@pytest.mark.parametrize("mesh", [[], ["--mesh", "2x2", "--devices",
                                       "cpu,cpu,cpu,cpu"]])
def test_train_lm(mesh, capsys, tmp_path):
    """``--quick`` at 2 steps, on one device and on a 2x2 mesh of cpu
    devices: the reference's JSON keys."""
    _load("train_lm_torch.py").main(["--quick", "--steps", "2", "--device",
                                     "cpu", "--ckpt-dir", str(tmp_path)]
                                    + mesh)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"first_loss", "final_loss", "loss_dropped", "steps",
                        "race_cache"}
    assert out["steps"] == 2
