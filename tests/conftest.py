"""Shared pytest config: tier markers and the fast tier-1 selection.

Tier-1 (the default ``python -m pytest -x -q``) runs everything except
tests marked ``slow``; pass ``--runslow`` for the full-size sweeps.  The
``pallas`` marker tags tests exercising the Pallas kernel (interpret mode on
this container), so ``-m pallas`` selects the kernel surface alone; the
``lowering`` marker mirrors it for the dimension-generic lowering engine
(``repro.lowering`` — ``-m lowering``); the ``tuning`` marker tags the
autotuner subsystem (``-m tuning``).

Every test runs against an isolated, per-test ``RACE_TUNING_CACHE``: the
serving path consults the persistent autotuning store on ``backend="auto"``,
and records left behind by earlier runs (or by the developer's own tuning
sessions in ``~/.cache/repro-race/``) must never leak into test behavior.
"""
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full-size differential sweeps)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy sweeps excluded from the fast tier-1 run "
                   "(enable with --runslow)")
    config.addinivalue_line(
        "markers", "pallas: exercises the Pallas RACE-stencil kernel")
    config.addinivalue_line(
        "markers", "lowering: exercises the dimension-generic Pallas "
                   "lowering engine (repro.lowering)")
    config.addinivalue_line(
        "markers", "tuning: exercises the repro.tuning autotuner subsystem")
    config.addinivalue_line(
        "markers", "grad: exercises differentiable RACE (the adjoint-stencil "
                   "custom_vjp, repro.core.adjoint)")
    config.addinivalue_line(
        "markers", "obs: exercises the repro.obs observability layer "
                   "(metrics, spans, structured events)")
    config.addinivalue_line(
        "markers", "shard: exercises sharded giant-grid execution "
                   "(repro.shard: partitioner, halo transport, shard_map "
                   "executor; multi-device runs fork a subprocess)")
    config.addinivalue_line(
        "markers", "port: exercises the PyTorch port (repro_torch) against "
                   "the JAX reference")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (and nvcc); skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow tier; use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(autouse=True)
def _isolated_tuning_store(tmp_path, monkeypatch):
    monkeypatch.setenv("RACE_TUNING_CACHE", str(tmp_path / "tuning-store"))


@pytest.fixture(autouse=True)
def _isolated_obs(monkeypatch):
    """Fresh, env-clean observability state around every test.

    Telemetry is process-global by design (one registry per serving
    process); tests must neither inherit the developer's ``RACE_OBS``
    setting nor leak metrics/events into each other.
    """
    from repro import obs

    monkeypatch.delenv(obs.ENV_OBS, raising=False)
    monkeypatch.delenv(obs.ENV_EVENTS, raising=False)
    monkeypatch.delenv(obs.ENV_RING, raising=False)
    monkeypatch.delenv(obs.ENV_SPANS, raising=False)
    # the benchmark history is persistent cross-run state exactly like the
    # tuning store: tests must never read or grow the developer's file
    monkeypatch.delenv("RACE_BENCH_HISTORY", raising=False)
    obs.reset()
    yield
    obs.reset()
