"""``repro_torch.tuning`` — persistent, correctness-gated autotuning on the
PyTorch port (port of ``repro.tuning``).

RACE leaves its biggest knobs open at apply time: the reassociation
strategy (paper Section 7), and in the port the backend (``"torch"`` or
K1, ``"hopper"``) and K1's plane tile and segment.  This subsystem decides
them by measurement on the card:

    space.py    candidate enumeration (levels x backends x K1's tile grid;
                block fields 0 = the chooser's tile)
    measure.py  warmup+repeats wall time through the executor path (each
                call synchronized), gated against the reassociate=0
                "torch" output
    store.py    schema-tagged JSON-lines persistence (atomic + locked
                writes) keyed by (hash, env signature, card, torch + CUDA
                versions); shares one file with the reference's store
    tuner.py    the ``autotune(program, env)`` front door

Entry points, lowest to highest level::

    dec = autotune(prog, env)                 # measure (or store-hit) + pick
    res = race(prog, tune=True); res.run(env) # tune on first run
    res.tune(env)                             # tune an existing RaceResult
    race_kernel(tune=True)                    # the frontend decorator

and ``compile_plan(..., backend="auto")`` consults the store directly, so a
decision tuned in one process is reused by every later process with zero
re-measurement.  Each entry point runs on ``cuda`` unless given
``device="cpu"``.
"""
from .measure import (Measurement, measure_candidate, time_executor,
                      time_executor_batch)
from .space import (DEFAULT_BATCH_SIZES, REASSOCIATE_LEVELS, Config,
                    block_grid, blocks_refusal, candidate_configs,
                    representative_batch_sizes)
from .store import (ENV_STORE, SCHEMA_VERSION, TuningStore, default_store,
                    plan_batch_choice, plan_choice, program_record,
                    record_key, runtime_fence, sig_json, store_file)
from .tuner import (TuningDecision, autotune, candidate_sources,
                    search_signature)

__all__ = [
    "autotune", "TuningDecision", "Config", "Measurement", "TuningStore",
    "search_signature", "candidate_sources",
    "candidate_configs", "block_grid", "blocks_refusal", "measure_candidate",
    "time_executor", "time_executor_batch", "representative_batch_sizes",
    "DEFAULT_BATCH_SIZES",
    "default_store", "store_file", "plan_choice", "plan_batch_choice",
    "program_record",
    "record_key", "runtime_fence", "sig_json", "REASSOCIATE_LEVELS",
    "SCHEMA_VERSION", "ENV_STORE",
]
