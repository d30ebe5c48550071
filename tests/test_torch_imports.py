"""The PyTorch port imports neither jax nor anything of the JAX package,
not even the jax-free ``repro.obs``, ``repro.frontend`` and ``repro.data``:
it carries its own copies.  Its tuner, serving runtime, launchers, sharded
execution, LM stack (every model module and every architecture's config)
and training path (optimizer, data, checkpoints, trainer) included, and no
``ml_dtypes`` either.  Without torch the suite still collects (F9)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
pytest.importorskip("torch")

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.M)


def test_import_loads_no_jax_and_no_repro():
    code = ("import sys, repro_torch, repro_torch.apps, repro_torch.testing, "
            "repro_torch.kernels.build, repro_torch.kernels.fused_ce, "
            "repro_torch.core.adjoint, repro_torch.lowering.emit, "
            "repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.kernels.race_stencil, repro_torch.core.integration, "
            "repro_torch.obs, repro_torch.obs.metrics, "
            "repro_torch.obs.events, repro_torch.obs.spans, "
            "repro_torch.obs.trace, "
            "repro_torch.obs.report, repro_torch.obs.history, "
            "repro_torch.obs.check, repro_torch.frontend, "
            "repro_torch.frontend.capture, repro_torch.frontend.affine, "
            "repro_torch.frontend.diagnostics, repro_torch.frontend.runtime, "
            "repro_torch.apps.frontend_kernels, repro_torch.tuning, "
            "repro_torch.tuning.space, repro_torch.tuning.store, "
            "repro_torch.tuning.measure, repro_torch.tuning.tuner, "
            "repro_torch.core.compile_cache, repro_torch.serve, "
            "repro_torch.serve.runtime, repro_torch.serve.warm, "
            "repro_torch.launch.serve, repro_torch.launch.mesh, "
            "repro_torch.shard, repro_torch.shard.partition, "
            "repro_torch.shard.halo, repro_torch.shard.executor, "
            "repro_torch.models, repro_torch.models.config, "
            "repro_torch.models.common, repro_torch.models.attention, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.model, repro_torch.models.steps, "
            "repro_torch.models.weights, repro_torch.configs, "
            "repro_torch.tree, repro_torch.optim, repro_torch.optim.adamw, "
            "repro_torch.optim.compression, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.checkpoint, "
            "repro_torch.checkpoint.store, repro_torch.runtime, "
            "repro_torch.runtime.trainer, repro_torch.launch.train, "
            "repro_torch.models.sharding, repro_torch.launch.specs, "
            "repro_torch.runtime.elastic, repro_torch.runtime.grad_sync"
            "\n"
            "from repro_torch.configs import ARCHS, get_config\n"
            "assert [get_config(a).name for a in ARCHS]\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    scanned = {f.relative_to(ROOT / "src" / "repro_torch").parts[0]
               for f in files[:-1]}
    assert {"obs", "frontend", "tuning", "serve", "launch",
            "shard", "models", "configs", "optim", "data", "checkpoint",
            "runtime"} <= scanned
    assert ROOT / "src" / "repro_torch" / "launch" / "mesh.py" in files
    assert ROOT / "src" / "repro_torch" / "launch" / "train.py" in files
    for new in ("models/sharding.py", "launch/specs.py", "runtime/elastic.py",
                "runtime/grad_sync.py"):
        assert ROOT / "src" / "repro_torch" / new in files
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert bad == []


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, the smoke
    script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_suite_collects_without_torch(tmp_path):
    """F9: with a ``torch`` that fails to import first on the path, the
    whole suite collects without an error (the port's modules skip), as
    the reference's CI, which installs no torch, needs."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "torch.py").write_text(
        "raise ImportError('torch is hidden for this test')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(stub), str(ROOT / "src")]))
    try:
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "--collect-only", "-q",
             "-p", "no:cacheprovider", "tests/"], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
    except OSError as e:
        pytest.skip(f"could not start pytest in a subprocess: {e}")
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    summary = out.stdout.strip().splitlines()[-1]
    assert "collected" in summary and "error" not in summary, summary
