"""Collective-traffic accounting and roofline terms of the port (counterpart
of ``repro/launch/hlo_analysis.py``; the name is kept, there is no HLO).

The reference parses the collectives out of XLA's compiled HLO.  The port
runs its mesh steps itself (:mod:`repro_torch.models.spmd`), which logs
every cross-position gather and sum as it runs them: a
:class:`~repro_torch.models.spmd.TransferLog` of entries, one per mesh
position taking part in a collective, with the result's bytes ``R`` there
and the group size ``g``.  The wire-byte model per participating position
is the reference's:

    all-gather          R (g-1)/g     (ring gather of the full result)
    all-reduce          2 R (g-1)/g   (reduce-scatter + all-gather)
    reduce-scatter      R (g-1)       (R the scattered result; the log
                                       holds the operand, R g)
    all-to-all          R (g-1)/g
    collective-permute  R

The roofline takes the H100's data-sheet figures from
:mod:`repro_torch.launch.mesh`: the dense bf16 tensor-core peak, the HBM
rate and the NVLink rate, whose data-sheet figure already counts every
link of the card.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from .mesh import HBM_BW, LINK_BW, PEAK_BF16_FLOPS


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """One position's wire bytes for a log entry (the module docstring)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-gather":
        return nbytes * frac
    if kind == "all-reduce":
        return 2 * nbytes * frac
    if kind == "reduce-scatter":
        return nbytes / g * (g - 1)
    if kind == "all-to-all":
        return nbytes * frac
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}")


def collective_traffic(log, n_positions: int = 1) -> dict:
    """``{'bytes': float, 'counts': {op: n}, 'by_op': {op: bytes}}`` per
    mesh position (the reference's per-device program): the log's entries
    summed and divided by ``n_positions``, the positions whose programs
    the log holds."""
    counts: Counter = Counter()
    by_op: Counter = Counter()
    for e in log.entries:
        counts[e.kind] += 1
        by_op[e.kind] += wire_bytes(e.kind, e.nbytes, e.group)
    n = max(1, n_positions)
    return {"bytes": float(sum(by_op.values())) / n,
            "counts": {k: v / n for k, v in counts.items()},
            "by_op": {k: v / n for k, v in by_op.items()}}


def collective_schedule(log, n_positions: int = 1) -> dict:
    """Collective counts per position split by whether they ran inside a
    layer unit (``per_layer``: one unit's, which repeats per unit) or at
    top level (embedding, head, loss, optimizer)."""
    units = {e.unit for e in log.entries if e.unit is not None}
    per_layer: Counter = Counter()
    top: Counter = Counter()
    for e in log.entries:
        if e.unit is None:
            top[e.kind] += 1
        elif e.unit == min(units):
            per_layer[e.kind] += 1
    n = max(1, n_positions)
    return {"per_layer": {k: v / n for k, v in per_layer.items()},
            "top_level": {k: v / n for k, v in top.items()}}


# ---------------------------------------------------------------------------


def analytic_hbm_bytes(cfg, shape, n_devices: int, opt_bytes_per_param: float,
                       logits_bytes_per: float = 4.0,
                       kv_bytes_per: float = 2.0) -> float:
    """Model-based per-device HBM traffic per step (the reference's, term
    for term):

    train:   3x params (fwd read, bwd read, update write) + grads rw
             + 2x opt state + ~12 residual-stream accesses per layer
             + CE logits write+read (vocab-sharded when 16 divides it)
    prefill: 1x params + ~6 stream accesses per layer
    decode:  1x active params + KV/state cache read+write
    """
    P = cfg.n_params() * 2 / n_devices  # bf16
    D, V, L = cfg.d_model, cfg.vocab, cfg.num_layers
    tok_local = shape.global_batch * shape.seq_len / n_devices
    stream = tok_local * D * 2  # one (B,S,D) bf16 access
    if shape.mode == "train":
        act = 12 * stream * L
        v_loc = V // 16 if V % 16 == 0 else V  # vocab TP when divisible
        logits = 2 * tok_local * v_loc * logits_bytes_per  # write + read
        opt = cfg.n_params() * opt_bytes_per_param / n_devices
        return 3 * P + 2 * P + 2 * opt + act + logits
    if shape.mode == "prefill":
        act = 6 * stream * L
        return P + act
    cache = 0.0
    B = shape.global_batch
    for li in range(L):
        lk = cfg.layer_kind(li)
        if lk in ("attn", "dense_attn", "moe", "cross"):
            S_eff = (min(shape.seq_len, cfg.window) if cfg.kind == "hybrid"
                     else shape.seq_len)
            cache += 2 * B * S_eff * cfg.n_kv_heads * cfg.d_head * kv_bytes_per
            cache += 2 * B * 1 * cfg.n_kv_heads * cfg.d_head * kv_bytes_per
        elif lk == "mamba":
            cache += 2 * B * cfg.d_inner * cfg.ssm_state * 4
        elif lk == "rglru":
            cache += 2 * B * (cfg.lru_width or D) * 4
    n_active = cfg.n_active_params() * 2 / n_devices
    return n_active + cache / n_devices


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(flops_per_device: float, bytes_per_device: float,
             coll_bytes_per_device: float, *,
             peak_flops: float = PEAK_BF16_FLOPS, hbm_bw: float = HBM_BW,
             link_bw: float = LINK_BW) -> RooflineTerms:
    """All inputs per device.  The defaults are one H100 SXM's data-sheet
    figures (:mod:`repro_torch.launch.mesh`), not measurements."""
    return RooflineTerms(
        compute_s=flops_per_device / peak_flops,
        memory_s=bytes_per_device / hbm_bw,
        collective_s=coll_bytes_per_device / link_bw,
    )
