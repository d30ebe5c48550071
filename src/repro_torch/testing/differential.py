"""Differential-test helpers of the PyTorch port.

Port of the data half of ``repro/testing/differential.py``: the same seed
gives the same numpy arrays in both packages, so one :func:`build_env` feeds
the reference and, through :func:`env_to_torch`, the port."""
from __future__ import annotations

import numpy as np

from ..core.codegen import required_shapes
from ..core.executor import env_to_torch

__all__ = ["SWEEP_SIZES", "build_env", "default_tolerances", "env_to_torch",
           "rel_err"]

#: grid sizes of the registry sweeps (the reference's)
SWEEP_SIZES = {
    "calc_tpoints": 14, "hdifft_gm": 14, "ocn_export": 14, "gaussian": 18,
    "rhs_ph1": 10, "rhs_ph2": 10, "diffusion1": 10, "diffusion2": 10,
    "diffusion3": 10, "psinv": 10, "resid": 10, "rprj3": 12,
    "j3d27pt": 10, "poisson": 10, "derivative": 10,
    "smooth1d": 24, "blocked4d": 7, "mirror_deriv": 14, "diag2d": 14,
}


def default_tolerances(dtype) -> dict:
    """Relative tolerances per dtype: ``baseline`` (a plan vs the untransformed
    program, whose association order differs) and ``plan`` (two realizations
    of the same plan).  The reference's numbers."""
    return {
        np.dtype(np.float64): dict(baseline=1e-9, plan=1e-12),
        np.dtype(np.float32): dict(baseline=1e-4, plan=1e-5),
        np.dtype(np.float16): dict(baseline=2e-2, plan=1e-2),
    }[np.dtype(dtype)]


def build_env(case, dtype=np.float32, seed: int = 0) -> dict:
    """Random numpy inputs covering every access of the case's program.
    Scalars draw from [0.25, 1], arrays from [-1, 1]; same draws, in the same
    order, as the reference's ``build_env``."""
    rng = np.random.default_rng(seed)
    env = {}
    for nm, shp in required_shapes(case.program).items():
        if nm in case.scalars or shp == ():
            env[nm] = dtype(rng.uniform(0.25, 1.0))
        else:
            env[nm] = rng.uniform(-1, 1, shp).astype(dtype)
    return env


def rel_err(got: dict, want: dict) -> float:
    """Worst relative error across outputs: max |got - want| / max |want|,
    in float64; entries may be tensors (any device) or arrays."""
    worst = 0.0
    for k in want:
        g = np.asarray(_host(got[k]), np.float64)
        w = np.asarray(_host(want[k]), np.float64)
        denom = max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, float(np.abs(g - w).max()) / denom)
    return worst


def _host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else v
