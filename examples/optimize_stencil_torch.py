"""RACE + the Hopper stencil kernel (K1), end to end, on the PyTorch port.

    PYTHONPATH=src python examples/optimize_stencil_torch.py          # cuda
    PYTHONPATH=src python examples/optimize_stencil_torch.py --device cpu

Takes the 27-point Jacobi stencil (paper Table 1 'j3d27pt'), runs RACE, then
executes the optimized plan three ways — the baseline evaluator, the RACE
evaluator (``"torch"``) and K1 (the generated CUDA kernel on a card; on the
CPU its tile emulator, the kernel's plain version) — checking they agree and
reporting op counts and synchronized wall clock.  The port of
``examples/optimize_stencil.py``.

Two entry paths are shown:
  * the internal DSL (``repro_torch.core.ir`` builders, as in
    ``paper_kernels``);
  * the capture frontend: the same stencil written as a plain-Python loop
    nest, decorated with ``@race_kernel``, captured to the identical IR and
    executed through the same backend layer.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.apps import frontend_kernels  # noqa: E402
from repro_torch.apps.paper_kernels import stencil_j3d27pt  # noqa: E402
from repro_torch.core.codegen import required_shapes  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.core.race import race  # noqa: E402
from repro_torch.frontend import race_kernel  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.ops import race_stencil  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu to run here)")
    ap.add_argument("--n", type=int, default=48, help="grid side")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    case = stencil_j3d27pt(args.n)
    res = race(case.program, reassociate=3)
    tb, tr = res.op_table(base=True), res.op_table()
    print(f"j3d27pt {args.n}^3: aux={res.n_aux()} rounds={res.rounds()}")
    print(f"  ops/iter: base add={tb['add']:.0f} mul={tb['mul']:.0f} -> "
          f"RACE add={tr['add']:.0f} mul={tr['mul']:.0f} "
          f"(reduced {res.reduced_ops():.2f})")

    rng = np.random.default_rng(0)
    env = {}
    for nm, shp in required_shapes(case.program).items():
        v = (np.float32(rng.uniform(0.2, 1.0)) if nm in case.scalars
             else rng.uniform(-1, 1, shp).astype(np.float32))
        env[nm] = torch.as_tensor(v, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def bench(fn, *a):
        fn(*a)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn(*a)
        sync()
        return (time.perf_counter() - t0) / 3, out

    t_base, _ = bench(res.baseline_evaluator(), env)
    t_opt, _ = bench(res.evaluator(), env)
    t_k1, k1_out = bench(lambda e: race_stencil(res, e, device=dev), env)

    want = kref.reference(res.plan, env, device=dev)
    for k in want:
        np.testing.assert_allclose(k1_out[k].float().cpu().numpy(),
                                   want[k].float().cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)
    what = ("K1 (CUDA)" if dev.type == "cuda"
            else "K1's tile emulator (its plain version)")
    print(f"  baseline {t_base*1e3:.1f} ms | RACE evaluator "
          f"{t_opt*1e3:.1f} ms ({t_base/t_opt:.2f}x)")
    print(f"  {what} ran in {t_k1*1e3:.1f} ms on {dev}")
    print("  kernel == oracle: OK")

    # -- the same stencil through the capture frontend ----------------------
    kern = race_kernel(reassociate=3)(frontend_kernels.j3d27pt)
    t0 = time.perf_counter()
    fe_out = kern.run(env, backend="torch", device=dev)
    sync()
    t_fe = time.perf_counter() - t0
    fe_res = kern.trace({nm: tuple(v.shape) for nm, v in env.items()})
    assert fe_res.program == case.program, "frontend/DSL divergence"
    want_fe = kref.reference_plan(fe_res.plan, env, device=dev)
    np.testing.assert_allclose(fe_out["j27"].cpu().numpy(),
                               want_fe["j27"].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    print(f"  @race_kernel frontend: captured identical program, "
          f"ran in {t_fe*1e3:.1f} ms (capture "
          f"{kern.last_capture_seconds*1e3:.1f} ms) — frontend == DSL: OK")


if __name__ == "__main__":
    main()
