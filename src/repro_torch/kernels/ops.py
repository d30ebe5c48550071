"""Public entry points for the RACE stencil kernel on Hopper.  Port of
``repro/kernels/ops.py``: the reference jits the Pallas call; here the call
goes through the executor cache to the kernel's wrapper, which launches the
CUDA kernel on a card (its tile emulator when ``device="cpu"``)."""
from __future__ import annotations

from ..core.race import RaceResult, race


def race_stencil(result: RaceResult, env: dict, *, device=None,
                 block_rows: int = 0, block_cols: int = 0,
                 block_inner: int = 0) -> dict:
    """Run a RACE-optimized stencil on the ``"hopper"`` backend.

    Raises :class:`~repro_torch.core.backend.BackendUnavailable` when the
    plan (or the env's dtypes) is out of the kernel's reach: there is no
    fallback to the ``"torch"`` evaluator.  ``block_*`` override the tile
    chooser (0 = choose)."""
    return result.run(env, "hopper", device=device, block_rows=block_rows,
                      block_cols=block_cols, block_inner=block_inner)


def optimize_and_run(program, env: dict, reassociate: int = 3, *,
                     device=None, block_rows: int = 0, block_cols: int = 0,
                     block_inner: int = 0):
    """One-shot: RACE-optimize a stencil program and execute it on the
    kernel; returns ``(result, outputs)``."""
    res = race(program, reassociate=reassociate)
    return res, race_stencil(res, env, device=device, block_rows=block_rows,
                             block_cols=block_cols, block_inner=block_inner)
