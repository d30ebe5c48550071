"""Quickstart on the PyTorch port: RACE on the paper's flagship example
(POP calc_tpoints).

    PYTHONPATH=src python examples/quickstart_torch.py            # on cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds the loop nest of Fig. 1, runs the full RACE pipeline (reassociation +
Pair-Graph/MIS + IDF + contraction) through ``repro_torch``, prints the
Fig. 2-style transformed code and the Table-1 operation counts, then times
the baseline and RACE evaluators on the device (synchronized wall clock).
The port of ``examples/quickstart.py``.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.apps.paper_kernels import pop_calc_tpoints  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.core.race import race  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu to run here)")
    ap.add_argument("--n", type=int, default=512, help="grid side")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n

    case = pop_calc_tpoints(nx=n, ny=n)
    print("=== RACE: Redundant Array Computation Elimination ===\n")
    full = race(case.program, reassociate=3)
    nr = race(case.program)

    print(f"auxiliary arrays found : {full.n_aux()}  (paper: 9)")
    print(f"detection iterations   : {full.rounds()}  (paper: 3)")
    t_base, t_nr, t_full = (full.op_table(base=True), nr.op_table(),
                            full.op_table())
    for tag, t in [("base", t_base), ("RACE-NR", t_nr), ("RACE", t_full)]:
        print(f"  {tag:8s} add={t['add']:.0f} mul={t['mul']:.0f} "
              f"sincos={t['sincos']:.0f}")
    print(f"reduced ops            : {full.reduced_ops():.2f} (paper: 0.55)\n")
    print("--- transformed code (cf. paper Fig. 2) ---")
    print(full.to_source())

    rng = np.random.default_rng(0)
    env = {"ulon": torch.from_numpy(
               rng.standard_normal((n, n)).astype(np.float32)).to(dev),
           "ulat": torch.from_numpy(
               rng.standard_normal((n, n)).astype(np.float32)).to(dev),
           "p25": torch.tensor(0.25, dtype=torch.float32, device=dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def bench(fn):
        fn(env)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            fn(env)
        sync()
        return (time.perf_counter() - t0) / 5

    tb = bench(full.baseline_evaluator())
    tf = bench(full.evaluator())
    print(f"\n{dev} wall-clock: baseline {tb*1e3:.2f} ms -> RACE "
          f"{tf*1e3:.2f} ms ({tb/tf:.2f}x speedup; paper reports 3.06x on "
          f"Xeon)")


if __name__ == "__main__":
    main()
