"""Differential-test helpers of the PyTorch port."""
from .differential import (SWEEP_SIZES, CaseReport, ComboResult, build_env,
                           coverage_matrix, default_tolerances, env_to_torch,
                           grad_sweep_registry, rel_err, run_case,
                           run_grad_case, sweep_registry, torch_env)

__all__ = ["SWEEP_SIZES", "CaseReport", "ComboResult", "build_env",
           "coverage_matrix", "default_tolerances", "env_to_torch",
           "grad_sweep_registry", "rel_err", "run_case", "run_grad_case",
           "sweep_registry", "torch_env"]
