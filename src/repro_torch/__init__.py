"""RACE (Redundant Array Computation Elimination) on PyTorch and CUDA.

The PyTorch port of the JAX package ``repro``, which stays the reference.
This package imports torch and numpy, never jax, and nothing of ``repro``:
it carries its own copies of the reference's jax-free modules under the
same module paths.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.

    from repro_torch import race
    from repro_torch.apps import get_case
    res = race(get_case("j3d27pt", 512).program, reassociate=3)
    out = res.run(env)                  # backend "auto": the Hopper kernel
    outs = res.run_batch(envs)          # one launch, the batch on the grid
"""
from .core.backend import (BACKENDS, BackendUnavailable, Capability,
                           Selection, probe_hopper, select_backend)
from .core.executor import (cache_stats, clear_cache, compile_plan,
                            configure_cache, env_signature, executor_cache,
                            plan_hash, program_hash, stacked_signature)
from .core.race import RaceResult, race

__all__ = ["BACKENDS", "BackendUnavailable", "Capability", "RaceResult",
           "Selection", "cache_stats", "clear_cache", "compile_plan",
           "configure_cache", "env_signature", "executor_cache", "plan_hash",
           "probe_hopper", "program_hash", "race", "select_backend",
           "stacked_signature"]
