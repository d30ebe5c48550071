"""Run one cell of the benchmark of ``repro_torch`` once, on one card.

    python3 racebench/run.py --workload j3d27pt.sweep512 --seed 7 \
        --seconds 10 --trace 0

The cell, its configuration, its traffic and its metrics are found by name
from ``BENCHMARK.json`` (see ``benchspec.py``).  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics (the
profiler's trace, the port's ``obs`` spans during set-up).  The last line
of standard output is the result as one JSON object; the numbers compared
with the plain reference are the last lines of standard error and the
result's last key, ``checks``.

It runs from the root of a checkout with no environment variable set (it
puts ``src/`` on its own path), fails when it finds no CUDA card, never
falls back to the CPU, and fails when the JAX package or JAX is loaded.
Kernels are built into ``build/repro_torch/`` and Python's bytecode (the
port's, torch's and every other module's it imports) is cached under
``build/racebench/pycache/`` inside the checkout, so only a checkout's
first run compiles either.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(names) -> list:
    """The module names whose top-level name (before the first dot, whole)
    is one of :data:`FORBIDDEN`."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def pin_environment() -> None:
    """The run's environment: none of the port's knobs from outside, and
    every build and kernel cache at a fixed path inside the checkout.
    Call it before importing torch: a Python that writes no bytecode
    beside installed packages recompiles all of torch in every process."""
    for k in [k for k in os.environ if k.startswith("RACE_")]:
        del os.environ[k]
    build = ROOT / "build"
    sys.pycache_prefix = str(build / "racebench" / "pycache")
    sys.dont_write_bytecode = False
    os.environ["RACE_COMPILE_CACHE"] = str(build / "repro_torch")
    os.environ["RACE_TUNING_CACHE"] = str(build / "racebench" / "tuning")
    os.environ["TRITON_CACHE_DIR"] = str(build / "racebench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "racebench" / "ext")
    for p in (ROOT / "src", HERE):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def card_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    import benchspec

    try:
        cell = benchspec.cell(benchspec.load(), args.workload)
    except benchspec.SpecError as e:
        print(f"racebench: {e}", file=sys.stderr)
        return 2
    t_torch = time.perf_counter()
    import torch

    t_check = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"racebench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()}); nothing runs on "
              f"the CPU in its place", file=sys.stderr)
        return 1
    import drive

    marks = {"start": t_torch - T0, "torch_import": t_check - t_torch,
             "card_check": time.perf_counter() - t_check}
    try:
        line = drive.measure(
            cell, args.seed, args.seconds, bool(args.trace), "cuda", T0,
            marks, lambda s: print(f"racebench: {s}", file=sys.stderr))
    except benchspec.SpecError as e:
        print(f"racebench: {e}; no result", file=sys.stderr)
        return 1
    print(f"racebench: {cell.name} seed {args.seed} on {card_limit()}",
          file=sys.stderr)
    bad = forbidden(list(sys.modules))
    if bad:
        print(f"racebench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
