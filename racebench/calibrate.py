"""Read the numbers that the correctness limits are set from, on the card.

    python3 racebench/calibrate.py --workload j3d27pt.sweep512 \
        --seeds 12 --control 3 --seconds 2 [--first-seed 3000000000]

For each of ``--seeds`` seeds the program runs the cell's traffic, at the
cell's own sizes, for a short window (set-up and the comparison as in a
benchmark run), and the numbers compared are printed.  For the first
``--control`` seeds the control is read as well: the plain reference
computed in the cell's ``control_dtype`` (``limits/<cell>.json``: bfloat16
for float32, float32 for float64, ``float8_e4m3fn``, rounded operation by
operation, for bfloat16) in the program's place.  One JSON line per seed;
the limit of each number lies between the largest sound reading and the
smallest control reading (``limits/<cell>.json``).  The benchmark's own
runs do not run this.
"""
import argparse
import json
import sys

from run import ROOT, pin_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    pin_environment()
    import torch

    import benchspec
    import drive
    import verdict

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    bench = benchspec.load(ROOT / "BENCHMARK.json")
    for name in args.workload:
        cell = benchspec.cell(bench, name)
        for k in range(args.seeds):
            seed = args.first_seed + 7919 * k
            run = drive.Run(cell, seed, "cuda")
            run.setup()
            run.window(args.seconds)
            run.release()
            checks, failed = run.judge()
            out = {"cell": name, "seed": seed, "calls": run.calls,
                   "program": {k: v for k, (v, _) in checks.items()},
                   "failed": failed}
            if k < args.control:
                out["control"] = verdict.control(cell, run.program, run.kind,
                                                 run.inputs)
            del run
            torch.cuda.empty_cache()
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
