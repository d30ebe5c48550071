"""Differential-test helpers of the PyTorch port."""
from .differential import (SWEEP_SIZES, build_env, default_tolerances,
                           env_to_torch, rel_err)

__all__ = ["SWEEP_SIZES", "build_env", "default_tolerances", "env_to_torch",
           "rel_err"]
