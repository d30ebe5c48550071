"""The LM on a mesh: the port's stand-in for GSPMD, in one process.

The reference runs the LM on a mesh by ``jax.jit`` with sharded arguments:
GSPMD compiles one program per device from the partition specs and
inserts the collectives.  The port is single-controller (as
:mod:`repro_torch.shard` and :mod:`.sharding` are): one process holds a
:class:`~repro_torch.launch.mesh.Mesh` of torch devices, which may repeat
(``["cuda:0"] * 4`` on one card, ``["cpu"] * 4`` in the tests), and runs
every mesh position's share of the step on that position's device.
Autograd crosses devices inside the process, so the backward's
collectives come from the forward's differentiable copies and sums: the
gradient of an all-gather is the reduce-scatter into each shard leaf, the
gradient of an all-reduce is the all-reduce of the gradients.  No
``torch.distributed``: NCCL refuses two ranks on one card.

The layout of a step (every choice changes where work and data live, never
the function computed):

* **Placement.**  :class:`MeshLM` holds every parameter as a
  :class:`~.sharding.Placed` by the reference's ``param_spec`` (a unit's
  tensor by its stacked leaf's spec, the leading unit axis dropped), each
  shard a leaf tensor on its position's device; AdamW's state is placed by
  ``opt_state_shardings``.  A replicated block has a copy per position:
  the copies' gradients are summed over the positions that hold them (an
  all-reduce) and every copy takes the same update, so they stay
  bit-equal.
* **Batch.**  A *row* is one coordinate on the batch axes (``pod``,
  ``data``); row ``r`` takes the ``r``-th slice of the batch, as
  ``batch_shardings`` splits it.  The residual stream of row ``r`` is held
  by each of its *members* (its positions along ``model``), replicated.
* **FSDP.**  A position gathers the blocks of a unit's weights it needs
  (:meth:`Collectives.fetch`: an all-gather over the axes that split them)
  inside the unit's remat region, so the backward gathers them again;
  nothing outlives the unit.
* **Tensor parallel over ``model``** for attention (a member computes a
  contiguous run of query heads: whole KV groups when ``model`` divides
  the KV heads' count, else part of one group, its KV head replicated), the
  MLPs (a run of ``d_ff`` columns of ``w_gate`` / ``w_up``, the same rows of
  ``w_down``), the head (a run of vocab columns; the loss's log-sum-exp and
  gold logit combined across members) and the embedding (a run of vocab
  rows; the members' lookups summed).  Each block is ``x + f(norm(x))``,
  so the members run the single-device block code on their slices and sum
  their partial outputs (an all-reduce) before the residual add.  The
  ``race_smooth`` mixer splits by channels, which is exact (each channel is
  its own stream): each position runs it on its row's ``B_r`` examples and
  ``D / M`` channels, ``S + R + 2`` by ``B_r D / M`` on K1.
* **Sequence-parallel residual** (the reference's ``seq_parallel``: its
  ``forward_hidden`` constrains the stream to ``(batch, "model", None)``
  at each layer unit's input and after the trailing blocks).  Where
  :func:`seq_layout` holds (``ExecConfig.seq_parallel``, a family other
  than ``ssm`` / ``hybrid``, more than one member and ``model`` dividing
  S), member ``m`` of a row holds its tokens ``[m S / M, (m + 1) S / M)``
  of the residual, (B_r, S / M, D), from the first unit's input on: what
  each unit's remat saves shrinks by M.  Inside a block (Megatron's
  sequence parallelism) ``rmsnorm`` runs on the member's tokens, the normed
  tokens are all-gathered over ``model`` along S, the block's per-member
  code above runs on them unchanged, and the members' partial outputs are
  reduce-scattered along S (in :meth:`Collectives.all_reduce`'s order, so
  each part is that sum's slice bit for bit) before the residual add on
  the member's tokens; a block computed whole on each member (heads that
  do not split) keeps its slice.  The embedding's sums reduce-scatter
  straight to the tokens where no mixer or prelude block reads the whole
  stream; the mixer's channel runs (over the whole S) reach the tokens by
  an all-to-all over ``model``; prelude blocks run on the replicated
  stream, which the first unit slices in place.  ``ln_f``'s output is
  all-gathered along S for the loss (the vocab splits over ``model``);
  a prefill gathers the last token (member M - 1's).  Decode (one token)
  and the recurrent families keep the replicated stream.
* **MoE** (the reference's ``moe.py`` constraints: the dispatch buffer's
  capacity over the batch axes, the expert FFN over ``model``; the expert
  axis stays whole, no all-to-all).  Routing is global: every position
  gathers every row's tokens and routes them all, since the capacity
  counts them all.  Row ``r`` fills and computes its capacity slots
  ``[r C / R, (r + 1) C / R)`` of every expert, member ``m`` with its
  ``d_ff`` columns of ``w_gate`` / ``w_up`` and rows of ``w_down``
  (E, D, F / M each); the members' partial outputs are summed over
  ``model``, the rows' slots gathered over the batch axes, and each row
  combines its own tokens.  The shared experts split as the MLPs do; the
  router is gathered whole.
* **Mamba and RG-LRU** split their channels (``d_inner``, W) over
  ``model``, as the reference pins their (B, S, channels) intermediates:
  a member runs the conv, the scan and the gating on its channels, from
  its two column regions of ``in_proj`` (one in each half: at ``model`` =
  2 the reference's column blocks are the halves, so one region lies in
  the other member's block).  Mamba sums ``x_proj``'s small (B, S,
  dt_rank + 2N) product over ``model``; RG-LRU all-gathers its conv output
  (B, S, W) for the two (W, W) gates, of which a member computes its
  channels' columns.  ``out_proj``'s products are summed over ``model``.
  A dimension an axis does not divide stays whole (the reference's
  ``ExecConfig.constrain`` and ``_fit``).
* **Decode** splits attention by the KV cache's sequence, as
  ``cache_shardings`` places it (flash-decoding's split-K): each member
  projects the token's q, k and v for its own heads, the members' are
  gathered over ``model``, the member holding slot ``pos`` writes k and
  v, each member scores its slots for every head, the members' partial
  softmax sums are merged by their maxima, and each member multiplies its
  heads' rows of ``wo`` (summed over ``model``).  Mamba and RG-LRU states
  are read and updated in place in each member's shard (``conv`` and
  ``h`` by channel, as ``cache_shardings`` lays them out);
  cross-attention's vision caches are gathered for the row.

Every cross-position copy, gather and partial sum is logged in a
:class:`TransferLog` in mesh positions (not devices), so the log is the
same on a mesh of one repeated device as on distinct cards.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from math import prod
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import obs
from ..tree import Stack, leaves, leaves_with_paths, map_with_paths
from .attention import NEG_INF, _project_qkv, _quantize_kv, attention_block
from .common import (ExecConfig, apply_rope, mm, mm_f32, rmsnorm, silu,
                     to_device, torch_dtype)
from .config import ModelConfig
from .model import (LM, _rope_cache, _save_dots, decode_block,
                    init_block_cache, prelude_kinds, trailing_kinds,
                    unit_kinds)
from .moe import _route, mlp_block
from .sharding import (P, Placed, Sharding, _blocks, batch_axes,
                       cache_shardings, leaf_shape, param_spec)
from .ssm import (_causal_conv1d, _mamba_conv, _mamba_scan, _rglru_scan,
                  _smooth_result, race_smooth, smooth_env)

class MeshError(ValueError):
    """A mesh, batch or model this execution cannot run."""


# ---------------------------------------------------------------------------
# the transfer log
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Transfer:
    """One mesh position's part in one collective: ``nbytes`` is the
    result's size there (the whole gathered or summed tensor; for a
    reduce-scatter, as for its backward's all-gather, the whole tensor
    summed), ``group``
    the positions taking part, ``unit`` the layer unit it ran in (None: top
    level), ``phase`` ``"forward"`` or ``"backward"``.  A collective over a
    group of ``g`` positions is ``g`` entries."""

    kind: str
    nbytes: int
    group: int
    unit: Optional[int]
    phase: str


@dataclass
class TransferLog:
    entries: list = field(default_factory=list)

    def add(self, kind, nbytes, group, unit, phase="forward"):
        self.entries.append(Transfer(kind, int(nbytes), int(group), unit,
                                     phase))

    def bytes_by_kind(self) -> dict:
        out = {}
        for e in self.entries:
            out[e.kind] = out.get(e.kind, 0) + e.nbytes
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the mesh's positions
# ---------------------------------------------------------------------------


class Layout:
    """Positions (coordinate tuples in row-major order), rows (the batch
    axes' coordinates) and members (the ``model`` coordinate) of a mesh."""

    def __init__(self, mesh):
        if mesh.abstract:
            raise MeshError(f"{mesh} is abstract (it holds no devices): a "
                            f"step runs only on a mesh of torch devices")
        unknown = set(mesh.axis_names) - {"pod", "data", "model"}
        if unknown:
            raise MeshError(f"mesh axes {sorted(unknown)}: the LM runs on "
                            f"'pod', 'data' and 'model' only")
        self.mesh = mesh
        self.names = tuple(mesh.axis_names)
        self.batch_axes = batch_axes(mesh)
        self.positions = list(itertools.product(*(range(n)
                                                  for n in mesh.sizes)))
        self.M = mesh.shape.get("model", 1)
        self.n_rows = prod(mesh.shape[a] for a in self.batch_axes)

    def device(self, p) -> torch.device:
        return self.mesh.devices[p]

    def member(self, p) -> int:
        return p[self.names.index("model")] if "model" in self.names else 0

    def row(self, p) -> int:
        r = 0
        for a in self.batch_axes:
            r = r * self.mesh.shape[a] + p[self.names.index(a)]
        return r

    def group(self, p, axes) -> list:
        """The positions equal to ``p`` but on ``axes``, in row-major order
        (which is the order of those axes' coordinates, major first)."""
        free = [self.names.index(a) for a in axes]
        return [q for q in self.positions
                if all(q[i] == p[i] for i in range(len(p)) if i not in free)]

    def live(self, axes) -> tuple:
        return tuple(a for a in axes if self.mesh.shape.get(a, 1) > 1)


def _split(n: int, parts: int, i: int) -> tuple:
    """``[lo, hi)`` of the ``i``-th of ``parts`` near-equal runs of ``n``."""
    base, extra = divmod(n, parts)
    lo = i * base + min(i, extra)
    return lo, lo + base + (1 if i < extra else 0)


def _divides(n: int, parts: int) -> bool:
    return parts > 1 and n % parts == 0


def seq_layout(cfg: ModelConfig, exec_cfg: ExecConfig, M: int,
               S: int) -> bool:
    """Whether a step of S tokens on ``M`` members holds the residual
    sequence-split over ``model``: where the reference's ``forward_hidden``
    shards it (``seq_parallel`` set, time not a recurrence's axis) and its
    ``ExecConfig.constrain`` would (``model`` divides S)."""
    return (exec_cfg.seq_parallel and cfg.kind not in ("ssm", "hybrid")
            and _divides(S, M))


def _even(n: int, parts: int, i: int) -> tuple:
    """``[lo, hi)`` of the ``i``-th of ``parts`` equal runs of ``n``, or all
    of ``n`` where ``parts`` does not divide it: the reference's
    ``ExecConfig.constrain`` and ``_fit`` leave such a dimension whole."""
    if not _divides(n, parts):
        return 0, n
    step = n // parts
    return i * step, (i + 1) * step


# ---------------------------------------------------------------------------
# collectives: differentiable, logged
# ---------------------------------------------------------------------------


class Collectives:
    """The collectives of one step on one :class:`Layout`, logged into
    ``log`` with the layer unit being run (``unit``)."""

    def __init__(self, layout: Layout, log: TransferLog, active=None):
        self.L = layout
        self.log = log
        #: the positions whose programs run (all of them, or one on the
        #: meta device: every position runs the same program)
        self.active = list(active or layout.positions)
        self.unit: Optional[int] = None
        #: on the meta device, the running positions' parts of a collective
        #: that positions which do not run read (see :meth:`Step.loss`)
        self.sent: list = []

    def value(self, vals: dict, q, like: torch.Tensor) -> torch.Tensor:
        """``vals[q]``; a position that does not run stands in with its
        shape, on the meta device only."""
        if q in vals:
            return vals[q]
        if like.device.type != "meta":
            raise MeshError(f"position {q} did not run")
        return torch.empty_like(like)

    def _logged(self, out: torch.Tensor, kind: str, back: str, group: int,
                nbytes: Optional[int] = None):
        """Log ``kind`` now and ``back`` when the gradient reaches ``out``
        (``nbytes``: the entries' bytes, default ``out``'s)."""
        unit, log = self.unit, self.log
        nb = _nbytes(out) if nbytes is None else nbytes
        log.add(kind, nb, group, unit)
        if out.requires_grad:
            out.register_hook(lambda g: log.add(back, nb, group, unit,
                                                "backward"))
        return out

    def fetch(self, placed: Placed, blocks: list, region, at) -> torch.Tensor:
        """``region`` (``(lo, hi)`` per dimension) of the tensor ``placed``
        holds, assembled on ``at``'s device from the blocks that cover it;
        a block ``at`` holds is read there, any other from its first
        holder.  ``blocks`` is :func:`unique_blocks` of ``placed``."""
        dev = self.L.device(at)
        cuts = []
        for d, (lo, hi) in enumerate(region):
            pts = {lo, hi}
            for sl, _ in blocks:
                for b in (sl[d].start, sl[d].stop):
                    if lo < b < hi:
                        pts.add(b)
            s = sorted(pts)
            cuts.append(list(zip(s[:-1], s[1:])))
        sources = {at}

        def piece(cell):
            for sl, holders in blocks:
                if all(s.start <= lo < s.stop for s, (lo, _) in
                       zip(sl, cell)):
                    q = at if at in holders else holders[0]
                    local = tuple(slice(lo - s.start, hi - s.start)
                                  for s, (lo, hi) in zip(sl, cell))
                    t = placed.shards[q][local]
                    if q != at:
                        sources.add(q)
                        t = t.to(dev)
                    return t
            raise MeshError(f"no block holds {cell}")

        def assemble(d, prefix):
            if d == len(cuts):
                return piece(prefix)
            parts = [assemble(d + 1, prefix + [c]) for c in cuts[d]]
            return parts[0] if len(parts) == 1 else torch.cat(parts, d)

        out = assemble(0, [])
        if len(sources) > 1:
            out = self._logged(out, "all-gather", "reduce-scatter",
                               len(sources))
        return out

    def _sending(self, vals: dict, p, grp) -> None:
        if vals[p].requires_grad and any(q not in vals for q in grp):
            self.sent.append(vals[p])

    def all_reduce(self, vals: dict, axes) -> dict:
        """Every position's sum of ``vals`` over the positions differing
        from it on ``axes``, added in one order on every member (so the
        members' sums are bit-equal)."""
        axes = self.L.live(axes)
        if not axes:
            return vals
        out = {}
        for p in vals:
            grp = self.L.group(p, axes)
            self._sending(vals, p, grp)
            dev = self.L.device(p)
            s = None
            for q in grp:
                t = self.value(vals, q, vals[p]).to(dev)
                s = t if s is None else s + t
            out[p] = self._logged(s, "all-reduce", "all-reduce", len(grp))
        return out

    def reduce_scatter(self, vals: dict, axes, dim: int) -> dict:
        """Every position's part of :meth:`all_reduce`'s sum: the ``i``-th
        of ``g`` equal runs along ``dim`` for the ``i``-th position of its
        group, added in the same order (so it is that sum's slice, bit for
        bit).  Logged with the whole summed tensor's bytes."""
        axes = self.L.live(axes)
        if not axes:
            return vals
        out = {}
        for p in vals:
            grp = self.L.group(p, axes)
            self._sending(vals, p, grp)
            dev = self.L.device(p)
            n = vals[p].shape[dim] // len(grp)
            lo = grp.index(p) * n
            s = None
            for q in grp:
                t = self.value(vals, q, vals[p]).narrow(dim, lo, n).to(dev)
                s = t if s is None else s + t
            out[p] = self._logged(s, "reduce-scatter", "all-gather",
                                  len(grp), _nbytes(vals[p]))
        return out

    def all_to_all(self, vals: dict, axes, split: int, cat: int) -> dict:
        """Every position's concatenation along ``cat`` of the ``i``-th of
        ``g`` equal runs along ``split`` of each group member's ``vals``
        (``i`` its own place in the group), in the members' order."""
        axes = self.L.live(axes)
        if not axes:
            return vals
        out = {}
        for p in vals:
            grp = self.L.group(p, axes)
            self._sending(vals, p, grp)
            dev = self.L.device(p)
            n = vals[p].shape[split] // len(grp)
            lo = grp.index(p) * n
            t = torch.cat([self.value(vals, q, vals[p]).narrow(split, lo, n)
                           .to(dev) for q in grp], cat)
            out[p] = self._logged(t, "all-to-all", "all-to-all", len(grp))
        return out

    def all_gather(self, vals: dict, axes, dim: int, like=None) -> dict:
        """Every position's concatenation along ``dim`` of ``vals`` over the
        positions differing from it on ``axes``, in their coordinates'
        order.  ``like(q)`` gives the shape of ``q``'s part where the
        parts differ (a position that does not run stands in by it)."""
        axes = self.L.live(axes)
        if not axes:
            return vals
        out = {}
        for p in vals:
            grp = self.L.group(p, axes)
            self._sending(vals, p, grp)
            dev = self.L.device(p)
            t = torch.cat([self.value(vals, q, vals[p] if like is None
                                      else like(q)).to(dev)
                           for q in grp], dim)
            out[p] = self._logged(t, "all-gather", "reduce-scatter", len(grp))
        return out


def unique_blocks(placed: Placed) -> list:
    """``[(slices, holders), ...]``: each distinct block of ``placed`` and
    the positions holding it, in row-major order."""
    out = {}
    for coords, sl in _blocks(placed.shape, placed.sharding):
        out.setdefault(tuple((s.start, s.stop) for s in sl), []).append(
            coords)
    return [(tuple(slice(a, b) for a, b in k), v) for k, v in out.items()]


def _placed_empty(shape, dtype, sharding: Sharding) -> Placed:
    """A :class:`Placed` of zeros made on each position's device."""
    mesh = sharding.mesh
    shards = np.empty(mesh.sizes, dtype=object)
    for coords, sl in _blocks(tuple(shape), sharding):
        block = tuple(s.stop - s.start for s in sl)
        shards[coords] = torch.zeros(block, dtype=dtype,
                                     device=mesh.devices[coords])
    return Placed(tuple(shape), dtype, sharding, shards)


# ---------------------------------------------------------------------------
# the model on the mesh
# ---------------------------------------------------------------------------


def _unit_spec(spec, ndim: int) -> P:
    """A stacked unit leaf's spec without its leading unit axis."""
    sp = tuple(spec) + (None,) * (ndim - len(spec))
    return P(*sp[1:])


class MeshLM:
    """An :class:`~.model.LM`'s parameters placed on a mesh.

    ``placed[name]`` is the :class:`~.sharding.Placed` of the parameter
    ``name`` (``LM.named_parameters()``' names: ``units.3.attn.wq``); each
    shard is a leaf tensor on its position's device.  Build one with
    :func:`place_model`."""

    def __init__(self, cfg: ModelConfig, mesh, placed: dict):
        self.cfg = cfg
        self.mesh = mesh
        self.layout = Layout(mesh)
        self.placed = placed
        self.blocks = {n: unique_blocks(p) for n, p in placed.items()}
        self.structure = LM(cfg, None, torch.device("meta"),
                            self._n_units())
        #: the transfer log of the last step run on these parameters, the
        #: RACE mixer's operations it ran on the meta device, and the bytes
        #: its units' remat saved per position (:attr:`Step.saved`)
        self.last_log: Optional[TransferLog] = None
        self.last_meta_ops = 0.0
        self.last_saved: dict = {}

    def _n_units(self) -> int:
        nk = len(unit_kinds(self.cfg))
        units = {int(n.split(".")[1]) for n in self.placed
                 if n.startswith("units.")}
        return len(units) // nk

    @property
    def device(self) -> torch.device:
        return self.layout.device(self.layout.positions[0])

    # -- the reference's tree ---------------------------------------------

    def names_of(self, path: tuple, leaf) -> list:
        """The parameter names of a reference leaf (a unit leaf's per
        unit)."""
        if path[0] == "units":
            nk = len(unit_kinds(self.cfg))
            rest = ".".join(map(str, path[2:]))
            return [f"units.{u * nk + path[1]}.{rest}"
                    for u in range(len(leaf))]
        return [".".join(map(str, path))]

    def ref_leaves(self) -> list:
        """``(path, names, stacked)`` per reference leaf, in leaf order."""
        tree = self.structure.param_tree()
        return [(path, self.names_of(path, leaf), isinstance(leaf, Stack))
                for path, leaf in leaves_with_paths(tree)]

    def specs(self) -> dict:
        """Reference path -> the stacked leaf's partition spec."""
        tree = self.structure.param_tree()
        return {path: param_spec(path, leaf_shape(leaf), self.mesh, self.cfg)
                for path, leaf in leaves_with_paths(tree)}

    def shard_leaves(self) -> list:
        return [s for n in sorted(self.placed)
                for s in self.placed[n].shards.flat]

    def gathered(self, device=None) -> dict:
        """The reference tree of whole tensors (units stacked), gathered
        from the shards bit for bit on ``device`` (default the first
        position's)."""
        from .sharding import gather

        dev = device or self.device
        tree = self.structure.param_tree()

        def leaf(path, lf):
            ts = [gather(self.placed[n], dev).detach()
                  for n in self.names_of(path, lf)]
            return torch.stack(ts) if isinstance(lf, Stack) else ts[0]

        return map_with_paths(leaf, tree)

    def load_stacked(self, state) -> None:
        """Copy a tree of :class:`~.sharding.Placed` stacked leaves (what
        ``restore_checkpoint(shardings=)`` gives for :meth:`shardings`)
        into the shards."""
        with torch.no_grad():
            for (path, names, stacked), pl in zip(
                    self.ref_leaves(), leaves(state), strict=True):
                for u, n in enumerate(names):
                    for coords in self.layout.positions:
                        src = pl.shards[coords]
                        self.placed[n].shards[coords].copy_(
                            src[u] if stacked else src)

    def shardings(self):
        """The reference tree of :class:`~.sharding.Sharding` s (stacked
        unit leaves), as ``params_shardings`` gives it."""
        from .sharding import params_shardings

        return params_shardings(self.structure.param_tree(), self.mesh,
                                self.cfg)

    # -- one block's weights at one position -------------------------------

    def full(self, name: str, coll: Collectives, at) -> torch.Tensor:
        pl = self.placed[name]
        return coll.fetch(pl, self.blocks[name],
                          tuple((0, n) for n in pl.shape), at)

    def cols(self, name: str, coll, at, lo: int, hi: int) -> torch.Tensor:
        pl = self.placed[name]
        region = tuple((0, n) for n in pl.shape[:-1]) + ((lo, hi),)
        return coll.fetch(pl, self.blocks[name], region, at)

    def rows(self, name: str, coll, at, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` of a matrix (of each matrix of a stack, such
        as the experts' ``w_down``): its second-to-last dimension."""
        pl = self.placed[name]
        region = tuple((0, n) for n in pl.shape)
        region = region[:-2] + ((lo, hi),) + region[-1:]
        return coll.fetch(pl, self.blocks[name], region, at)

    def module(self, prefix: str, coll, at) -> SimpleNamespace:
        """Every parameter under ``prefix`` gathered whole onto ``at``, as
        nested namespaces the single-device block code reads."""
        root = SimpleNamespace()
        for n in self.placed:
            if not n.startswith(prefix + "."):
                continue
            *path, last = n[len(prefix) + 1:].split(".")
            ns = root
            for k in path:
                if not hasattr(ns, k):
                    setattr(ns, k, SimpleNamespace())
                ns = getattr(ns, k)
            setattr(ns, last, self.full(n, coll, at))
        return root

def place_model(model: LM, mesh, trainable: Optional[bool] = None) -> MeshLM:
    """``model``'s parameters placed on ``mesh`` by the reference's
    ``param_spec`` (shards are copies on each position's device; ``model``
    is not touched).  ``trainable`` defaults to ``model``'s."""
    from .sharding import place

    cfg = model.cfg
    Layout(mesh)  # refuses an abstract mesh or foreign axes
    if trainable is None:
        trainable = next(model.parameters()).requires_grad
    tree = model.param_tree()
    placed = {}
    nk = len(unit_kinds(cfg))
    for path, leaf in leaves_with_paths(tree):
        spec = param_spec(path, leaf_shape(leaf), mesh, cfg)
        if isinstance(leaf, Stack):
            sh = Sharding(mesh, _unit_spec(spec, len(leaf_shape(leaf))))
            rest = ".".join(map(str, path[2:]))
            items = [(f"units.{u * nk + path[1]}.{rest}", t)
                     for u, t in enumerate(leaf)]
        else:
            sh = Sharding(mesh, spec)
            items = [(".".join(map(str, path)), leaf)]
        for name, t in items:
            pl = place(t.detach(), sh)
            for s in pl.shards.flat:
                s.requires_grad_(trainable)
            placed[name] = pl
    return MeshLM(cfg, mesh, placed)


# ---------------------------------------------------------------------------
# one forward on the mesh
# ---------------------------------------------------------------------------


def _head_split(cfg: ModelConfig, M: int, m: int):
    """Member ``m``'s query heads as ``(kv0, kv1, g0, g1)`` (KV groups
    ``[kv0, kv1)``, query heads ``[g0, g1)`` within each), or None when
    the heads do not split over ``M`` members."""
    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if M <= KV:
        k0, k1 = _split(KV, M, m)
        return k0, k1, 0, G
    per = M // KV
    if M % KV or G < per:
        return None
    g0, g1 = _split(G, per, m % per)
    kv = m // per
    return kv, kv + 1, g0, g1


class Step:
    """One forward (and backward) of a :class:`MeshLM`: its collectives,
    the rows' inputs and the per-position state."""

    def __init__(self, mp: MeshLM, exec_cfg: ExecConfig, active=None):
        self.mp = mp
        self.cfg = mp.cfg
        self.ec = exec_cfg
        self.L = mp.layout
        self.log = TransferLog()
        self.c = Collectives(self.L, self.log, active)
        self.active = self.c.active
        #: whether the batch splits over the rows (else, as
        #: ``batch_shardings`` leaves it, every row holds all of it)
        self.split = True
        #: operations the mixer's RACE plans do on the meta device (the
        #: flop counter does not see K1)
        self.meta_mixer_ops = 0.0
        #: whether the residual stream is sequence-split over ``model`` now
        #: (:meth:`hidden` sets it where :func:`seq_layout` holds)
        self.seq = False
        #: position -> bytes the units' remat saved there (their inputs)
        self.saved = {p: 0 for p in self.active}

    # -- inputs -------------------------------------------------------------

    def rows(self, value, dtype=None) -> dict:
        """Each position's row slice of a batch entry (leading axis: the
        batch), on its device; the whole batch on every row where it does
        not split over the rows (``batch_shardings``' ``_fit``)."""
        B = np.shape(value)[0] if not isinstance(value, torch.Tensor) \
            else value.shape[0]
        n = self.L.n_rows
        self.split = B % n == 0
        b = B // n if self.split else B
        out = {}
        for p in self.active:
            r = self.L.row(p) if self.split else 0
            out[p] = to_device(value[r * b:(r + 1) * b], self.L.device(p),
                               dtype)
        return out

    def each(self, fn) -> dict:
        return {p: fn(p) for p in self.active}

    # -- the sequence-parallel residual --------------------------------------

    def tokens(self, t: torch.Tensor, p) -> torch.Tensor:
        """Member ``p``'s run of the tokens (dim 1) of ``t``."""
        n = t.shape[1] // self.L.M
        return t.narrow(1, self.L.member(p) * n, n)

    def own(self, vals: dict) -> dict:
        """Each member's tokens of a result it holds whole (where the
        stream is sequence-split; else ``vals``)."""
        if not self.seq:
            return vals
        return {p: self.tokens(v, p).contiguous() for p, v in vals.items()}

    def sum_members(self, vals: dict) -> dict:
        """The members' partial outputs summed over ``model``: each
        member's tokens of the sum where the stream is sequence-split (a
        reduce-scatter along S), else the whole sum on every member."""
        if self.seq:
            return self.c.reduce_scatter(vals, ("model",), 1)
        return self.c.all_reduce(vals, ("model",))

    def whole(self, vals: dict) -> dict:
        """A row's whole sequence on each member (an all-gather along S
        where the stream is sequence-split; else ``vals``)."""
        return self.c.all_gather(vals, ("model",), 1) if self.seq else vals

    # -- blocks -------------------------------------------------------------

    def embed(self, batch) -> dict:
        """The rows' embeddings: whole on every member, or each member's
        tokens where the stream is sequence-split already."""
        cfg, mp = self.cfg, self.mp
        if cfg.input_embed_dim:
            e = self.rows(batch["embeds"], torch_dtype(cfg.dtype))
            return self.own(self.each(lambda p: mm(e[p], mp.full(
                "in_proj", self.c, p))))
        tok = self.rows(batch["tokens"], torch.long)
        V = cfg.vocab

        def part(p):
            lo, hi = _split(V, self.L.M, self.L.member(p))
            table = mp.rows("embed", self.c, p, lo, hi)
            local = tok[p] - lo
            ok = (local >= 0) & (local < hi - lo)
            return table[local.clamp(0, hi - lo - 1)] * ok[..., None].to(
                table.dtype)

        return self.sum_members(self.each(part))

    def mixer(self, xs: dict, scatter: bool = False) -> dict:
        """``xs`` plus the ``race_smooth`` mixer, each position running it
        on its ``D / M`` channels over the whole S; with ``scatter`` the
        channel runs reach each member's tokens by an all-to-all (the
        stream becomes sequence-split), else every member gathers them
        all."""
        cfg = self.cfg
        R = cfg.race_smooth_radius
        D = cfg.d_model

        def part(p):
            c0, c1 = _split(D, self.L.M, self.L.member(p))
            x = xs[p][..., c0:c1]
            taps = self.mp.full("smooth_taps", self.c, p)
            if x.device.type == "meta":
                return self._meta_mixer(x, R)
            with obs.span("spmd_mixer", position=",".join(map(str, p))):
                return race_smooth(x, taps, radius=R)

        if scatter:
            ys = self.c.all_to_all(self.each(part), ("model",), 1, -1)
            return {p: self.tokens(xs[p], p) + ys[p] for p in xs}
        ys = self.c.all_gather(self.each(part), ("model",), -1)
        return {p: xs[p] + ys[p] for p in xs}

    def _meta_mixer(self, x, R: int):
        """On the meta device the mixer runs no kernel: its output's shape,
        and the RACE plans' operations (forward, and each adjoint plan the
        backward runs) tallied in :attr:`meta_mixer_ops`."""
        from ..core.adjoint import adjoint_build, adjoint_runs

        B, S, C = x.shape
        res = _smooth_result(S, B * C, R)
        plans = [res]
        if torch.is_grad_enabled():
            env = smooth_env(x, torch.empty(R + 1, device=x.device), R)
            plans += [u.result() for u in adjoint_runs(
                adjoint_build(res.program), env, {"sy": env["sy"]}, env)]
        for r in plans:
            pts = prod(lp.hi - lp.lo + 1 for lp in r.program.loops)
            self.meta_mixer_ops += r.op_table()["weighted_total"] * pts
        return torch.empty_like(x)

    def head_runs(self) -> tuple:
        """(whether the heads split over ``model``, ``run(q)``): ``run(q)``
        is position ``q``'s (KV heads, query heads per KV head, query
        columns ``(lo, hi)``) run of :func:`_head_split` (every head where
        they do not split)."""
        cfg = self.cfg
        G = cfg.n_heads // cfg.n_kv_heads
        split = [_head_split(cfg, self.L.M, m) for m in range(self.L.M)]
        tp = self.L.M > 1 and all(s is not None for s in split)

        def run(q):
            kv0, kv1, g0, g1 = (split[self.L.member(q)] if tp
                                else (0, cfg.n_kv_heads, 0, G))
            return ((kv0, kv1), g1 - g0, ((kv0 * G + g0) * cfg.d_head,
                                          ((kv1 - 1) * G + g1) * cfg.d_head))

        return tp, run

    def head_weights(self, prefix, p, run) -> SimpleNamespace:
        """Position ``p``'s columns of ``wq`` / ``wk`` / ``wv`` (and biases)
        and rows of ``wo`` for its heads ``run``; the q / k norms whole."""
        cfg, mp, c = self.cfg, self.mp, self.c
        (kv0, kv1), _, (q_lo, q_hi) = run
        k_lo, k_hi = kv0 * cfg.d_head, kv1 * cfg.d_head
        ns = SimpleNamespace(
            wq=mp.cols(f"{prefix}.wq", c, p, q_lo, q_hi),
            wk=mp.cols(f"{prefix}.wk", c, p, k_lo, k_hi),
            wv=mp.cols(f"{prefix}.wv", c, p, k_lo, k_hi),
            wo=mp.rows(f"{prefix}.wo", c, p, q_lo, q_hi))
        if cfg.qkv_bias:
            ns.bq = mp.cols(f"{prefix}.bq", c, p, q_lo, q_hi)
            ns.bk = mp.cols(f"{prefix}.bk", c, p, k_lo, k_hi)
            ns.bv = mp.cols(f"{prefix}.bv", c, p, k_lo, k_hi)
        if cfg.qk_norm:
            ns.q_norm = mp.full(f"{prefix}.q_norm", c, p)
            ns.k_norm = mp.full(f"{prefix}.k_norm", c, p)
        return ns

    def attention(self, prefix, h: dict, rope, kv_src=None,
                  window: int = 0) -> dict:
        """The attention block's output on every position, summed over the
        members' heads (or computed whole on each member where the heads
        do not split)."""
        tp, run = self.head_runs()

        def part(p):
            (kv0, kv1), g, _ = run(p)
            return attention_block(
                h[p], self.head_weights(prefix, p, run(p)),
                _local_heads(self.cfg, kv1 - kv0, g), self.ec,
                rope_cache=rope[p],
                kv_src=None if kv_src is None else kv_src[p], window=window)

        out = self.each(part)
        return self.sum_members(out) if tp else self.own(out)

    def mlp(self, prefix, h: dict, d_ff: int) -> dict:
        mp = self.mp

        def part(p):
            lo, hi = _split(d_ff, self.L.M, self.L.member(p))
            ns = SimpleNamespace(
                w_gate=mp.cols(f"{prefix}.w_gate", self.c, p, lo, hi),
                w_up=mp.cols(f"{prefix}.w_up", self.c, p, lo, hi),
                w_down=mp.rows(f"{prefix}.w_down", self.c, p, lo, hi))
            return mlp_block(h[p], ns)

        return self.sum_members(self.each(part))

    def moe(self, prefix, h: dict) -> dict:
        """The MoE block, the reference's layout (``moe.py``'s constraints:
        the dispatch buffer's capacity over the batch axes, the expert FFN
        over ``model``).  Routing stays global: every position routes every
        row's tokens (the capacity counts them all).  Row ``r`` computes
        its capacity slots ``[r C / R, (r + 1) C / R)`` of every expert,
        member ``m`` its ``d_ff`` columns ``[m F / M, (m + 1) F / M)``; the
        members' partial outputs are summed over ``model``, the rows' slots
        gathered over the batch axes, and each row combines its own
        tokens (a member its own where the stream is sequence-split: ``h``
        is then the row's whole normed sequence).  A C or F the axes do not
        divide stays whole.  Only kept tokens are written (F8)."""
        cfg, mp, L, c = self.cfg, self.mp, self.L, self.c
        E, K, Fd = cfg.moe_experts, cfg.moe_top_k, cfg.d_ff
        full = c.all_gather(h, L.batch_axes, 0) if self.split else h
        B, S, D = full[self.active[0]].shape
        T = B * S
        n = _moe_chunks(T, self.ec)
        Tc = T // n
        C = max(8, int(Tc * K * cfg.moe_capacity) // E)
        c_split, f_split = _divides(C, L.n_rows), _divides(Fd, L.M)
        w, span = {}, {}
        for p in self.active:
            f0, f1 = _even(Fd, L.M, L.member(p))
            w[p] = SimpleNamespace(
                router=mp.full(f"{prefix}.router", c, p),
                w_gate=mp.cols(f"{prefix}.w_gate", c, p, f0, f1),
                w_up=mp.cols(f"{prefix}.w_up", c, p, f0, f1),
                w_down=mp.rows(f"{prefix}.w_down", c, p, f0, f1))
            T_r = h[p].shape[0] * S
            t0 = L.row(p) * T_r if self.split else 0
            span[p] = (t0, t0 + T_r)
        outs = {p: [] for p in self.active}
        for i in range(n):
            xc = {p: full[p].reshape(T, D)[i * Tc:(i + 1) * Tc]
                  for p in self.active}
            route = {p: _moe_route(xc[p], w[p].router, cfg, C)
                     for p in self.active}

            def part(p):
                r = route[p]
                c0, c1 = _even(C, L.n_rows, L.row(p))
                cs = torch.arange(c0, c1, device=xc[p].device)
                j = (r.start[:, None] + cs).clamp(max=Tc * K - 1)
                buf = torch.where((cs < r.sizes[:, None])[..., None],
                                  xc[p][r.tok[j]], 0)       # (E, C/R, D)
                g = mm(buf, w[p].w_gate)
                u = mm(buf, w[p].w_up)
                return mm(silu(g) * u, w[p].w_down)

            y = self.each(part)
            if f_split:
                y = c.all_reduce(y, ("model",))
            if c_split:
                y = c.all_gather(y, L.batch_axes, 1)
            for p in self.active:
                a = max(span[p][0], i * Tc) - i * Tc
                b = min(span[p][1], (i + 1) * Tc) - i * Tc
                if b > a:
                    outs[p].append(_moe_combine(y[p], route[p], K, a, b))
        shared = (self.mlp(f"{prefix}.shared", h, cfg.moe_shared * Fd)
                  if cfg.moe_shared else None)
        out = {}
        for p in self.active:
            o = torch.cat(outs[p]) if len(outs[p]) > 1 else outs[p][0]
            o = o.reshape(h[p].shape)
            if self.seq:
                o = self.tokens(o, p)
            if shared is not None:
                o = o + shared[p]
            out[p] = o.to(h[p].dtype)
        return out

    def _ssm_parts(self, prefix, width: int, names_cols, names_rows, p):
        """Member ``p``'s channels ``[c0, c1)`` of ``width`` (all of it where
        ``model`` does not divide it) and its slices of a recurrent block's
        per-channel leaves: columns of ``names_cols``, rows of
        ``names_rows``, and both ``in_proj`` column regions, one in each
        half (``in_proj`` is (D, 2 width): x branch, then z / gate
        branch)."""
        mp, c = self.mp, self.c
        c0, c1 = _even(width, self.L.M, self.L.member(p))
        ns = SimpleNamespace(
            in_x=mp.cols(f"{prefix}.in_proj", c, p, c0, c1),
            in_z=mp.cols(f"{prefix}.in_proj", c, p, width + c0, width + c1))
        for k in names_cols:
            setattr(ns, k, mp.cols(f"{prefix}.{k}", c, p, c0, c1))
        for k in names_rows:
            setattr(ns, k, mp.rows(f"{prefix}.{k}", c, p, c0, c1))
        return ns

    def mamba(self, prefix, h: dict, cache=None) -> dict:
        """The Mamba block with ``d_inner`` over ``model`` (the reference's
        ``ssm.py`` pins every (B, S, d_inner) intermediate there): each
        member runs the conv, the scan and the gating on its channels;
        ``x_proj``'s product (B, S, dt_rank + 2N) and ``out_proj``'s are
        summed over ``model``.  With ``cache`` (decode) each member reads
        and updates its own shard of ``conv`` and ``h`` in place, as
        ``cache_shardings`` lays them out."""
        cfg = self.cfg
        tp = _divides(cfg.d_inner, self.L.M)
        ns, stage = {}, {}
        for p in self.active:
            q = ns[p] = self._ssm_parts(
                prefix, cfg.d_inner, ("conv_w", "dt_proj", "dt_bias",
                                      "D_skip"),
                ("x_proj", "A_log", "out_proj"), p)
            state = None if cache is None else cache["conv"].shards[p]
            xc, new_conv = _mamba_conv(mm(h[p], q.in_x), q, state)
            stage[p] = (xc, mm(h[p], q.in_z), new_conv)
        proj = self.each(lambda p: mm(stage[p][0], ns[p].x_proj))
        if tp:
            proj = self.c.all_reduce(proj, ("model",))

        def part(p):
            xc, z, new_conv = stage[p]
            h0 = (cache["h"].shards[p] if cache is not None else
                  torch.zeros((xc.shape[0], xc.shape[2], cfg.ssm_state),
                              dtype=torch.float32, device=xc.device))
            y, h_last = _mamba_scan(xc, z, proj[p], ns[p], cfg, h0, self.ec)
            if cache is not None:
                cache["conv"].shards[p].copy_(new_conv)
                cache["h"].shards[p].copy_(h_last)
            return mm(y, ns[p].out_proj)

        out = self.each(part)
        return self.c.all_reduce(out, ("model",)) if tp else out

    def rglru(self, prefix, h: dict, cache=None) -> dict:
        """The RG-LRU block with its width W over ``model``: each member
        runs the conv, ``lambda_p``, the scan and the gelu gate on its
        channels.  The input and recurrence gates (W, W) read every
        channel: the members' conv outputs are all-gathered over ``model``
        (B, S, W, once for both gates), and each member computes its
        channels' columns of both, rather than summing two (B, S, W)
        partial products; ``out_proj``'s product is summed over ``model``.
        ``cache`` as :meth:`mamba`'s."""
        cfg = self.cfg
        W = cfg.lru_width or cfg.d_model
        tp = _divides(W, self.L.M)
        ns, stage = {}, {}
        for p in self.active:
            q = ns[p] = self._ssm_parts(
                prefix, W, ("conv_w", "w_input_gate", "w_rec_gate",
                            "lambda_p"), ("out_proj",), p)
            state = None if cache is None else cache["conv"].shards[p]
            xc, new_conv = _causal_conv1d(mm(h[p], q.in_x), q.conv_w, state)
            stage[p] = (xc, mm(h[p], q.in_z), new_conv)
        xc = {p: stage[p][0] for p in self.active}
        xc_all = self.c.all_gather(xc, ("model",), -1) if tp else xc

        def part(p):
            _, gate, new_conv = stage[p]
            h0 = (cache["h"].shards[p] if cache is not None else
                  torch.zeros(xc[p].shape[::2], dtype=torch.float32,
                              device=xc[p].device))
            y, h_last = _rglru_scan(xc_all[p], xc[p], gate, ns[p], h0,
                                    self.ec)
            if cache is not None:
                cache["conv"].shards[p].copy_(new_conv)
                cache["h"].shards[p].copy_(h_last)
            return mm(y, ns[p].out_proj)

        out = self.each(part)
        return self.c.all_reduce(out, ("model",)) if tp else out

    def block(self, xs: dict, prefix: str, kind: str, rope, vision) -> dict:
        """``x + f(norm(x))`` per sub-block on every position's residual
        (each member's tokens where the stream is sequence-split: the
        normed tokens gathered for ``f``, its sum scattered back)."""
        cfg, mp = self.cfg, self.mp
        ln = lambda name: self.whole({p: rmsnorm(  # noqa: E731
            xs[p], mp.full(f"{prefix}.{name}", self.c, p)) for p in xs})
        if kind in ("attn", "dense_attn", "cross", "moe"):
            window = cfg.window if (cfg.kind == "hybrid"
                                    and kind != "cross") else 0
            a = self.attention(f"{prefix}.attn", ln("ln1"),
                               rope if kind != "cross" else self._none(),
                               kv_src=vision if kind == "cross" else None,
                               window=window)
            xs = {p: xs[p] + a[p] for p in xs}
            h = ln("ln2")
            if kind == "moe":
                f = self.moe(f"{prefix}.moe", h)
            else:
                d_ff = cfg.dense_first_layer_ff if kind == "dense_attn" \
                    else cfg.d_ff
                f = self.mlp(f"{prefix}.mlp", h, d_ff)
            return {p: xs[p] + f[p] for p in xs}
        if kind == "mamba":
            m = self.mamba(f"{prefix}.mamba", ln("ln1"))
            return {p: xs[p] + m[p] for p in xs}
        if kind == "rglru":
            g = self.rglru(f"{prefix}.rglru", ln("ln1"))
            xs = {p: xs[p] + g[p] for p in xs}
            f = self.mlp(f"{prefix}.mlp", ln("ln2"), cfg.d_ff)
            return {p: xs[p] + f[p] for p in xs}
        raise ValueError(kind)

    def _none(self) -> dict:
        return {p: None for p in self.active}

    def _remat(self, fn, xs: dict) -> dict:
        """``fn`` over every position's residual, recomputed in the
        backward (the reference's per-unit ``jax.checkpoint``): its
        gathers run again there.  The inputs it keeps are counted into
        :attr:`saved` as autograd packs them."""
        ec = self.ec
        if not (ec.remat and torch.is_grad_enabled()):
            return fn(xs)
        order = list(xs)

        def body(*ts):
            out = fn(dict(zip(order, ts)))
            return tuple(out[p] for p in order)

        if ec.remat_policy == "nothing":
            kw = {}
        elif ec.remat_policy == "dots":
            kw = {"context_fn": functools.partial(
                create_selective_checkpoint_contexts, _save_dots)}
        else:
            raise ValueError(f"remat_policy {ec.remat_policy!r}")
        # the checkpoint packs each input (and, in some releases, an empty
        # tensor of its own): an input is known by its identity
        owner = {id(xs[p]): p for p in order}

        def pack(t):
            if id(t) in owner:
                self.saved[owner[id(t)]] += _nbytes(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = checkpoint(body, *(xs[p] for p in order),
                             use_reentrant=False, preserve_rng_state=False,
                             **kw)
        return dict(zip(order, out))

    def hidden(self, batch) -> dict:
        """Every position's final hidden states after ``ln_f``:
        ``forward_hidden`` on the mesh.  (B_r, S, D), or each member's
        tokens (B_r, S / M, D) where the stream is sequence-split
        (:attr:`seq`)."""
        cfg, mp = self.cfg, self.mp
        S = np.shape(batch["embeds" if cfg.input_embed_dim else "tokens"])[1]
        layout = seq_layout(cfg, self.ec, self.L.M, S)
        prelude = prelude_kinds(cfg)
        # without a prelude block the stream splits before the first unit:
        # the embedding's sums go to the tokens, or else the mixer's output
        early = layout and not prelude
        self.seq = early and not cfg.race_smooth_radius
        xs = self.embed(batch)
        if cfg.race_smooth_radius:
            xs = self.mixer(xs, scatter=early)
            self.seq = early
        rope = self.each(lambda p: _rope_cache(cfg, S, self.L.device(p)))
        vision = (self.rows(batch["vision"]) if batch.get("vision")
                  is not None else self._none())
        for i, kind in enumerate(prelude):
            xs = self.block(xs, f"prelude.{i}", kind, rope, vision)
        if layout and not self.seq:  # the first unit's input, in place
            xs = {p: self.tokens(x, p).contiguous() for p, x in xs.items()}
            self.seq = True
        uk = unit_kinds(cfg)
        for u in range(len(mp.structure.units) // len(uk)):
            def unit_body(xs, u=u):
                self.c.unit = u
                for j, kind in enumerate(uk):
                    xs = self.block(xs, f"units.{u * len(uk) + j}", kind,
                                    rope, vision)
                self.c.unit = None
                return xs

            xs = self._remat(unit_body, xs)
        for i, kind in enumerate(trailing_kinds(cfg)):
            xs = self.block(xs, f"trailing.{i}", kind, rope, vision)
        return {p: rmsnorm(xs[p], mp.full("ln_f", self.c, p)) for p in xs}

    # -- the loss and the logits -------------------------------------------

    def loss(self, batch) -> torch.Tensor:
        """``chunked_ce_loss`` on the mesh: each member's logits over its
        vocab columns of the row's whole sequence, chunk by chunk
        (recomputed in the backward), its log-sum-exp and gold logit
        combined over the members, the masked sum and count over every row,
        on the first position's device."""
        cfg, ec = self.cfg, self.ec
        h = self.whole(self.hidden(batch))
        labels = self.rows(batch["labels"], torch.long)
        mask = (self.rows(batch["mask"], torch.float32) if batch.get("mask")
                is not None else None)
        S = next(iter(h.values())).shape[1]
        if ec.unroll_scans:
            n_chunks = min(ec.probe_chunks, S)
        else:
            n_chunks = max(1, S // max(1, min(ec.loss_chunk, S)))
        while S % n_chunks:
            n_chunks -= 1
        C = S // n_chunks
        dt = torch_dtype(ec.logits_dtype)
        V = cfg.vocab
        w = {}
        for p in self.active:
            lo, hi = _split(V, self.L.M, self.L.member(p))
            w[p] = (self.mp.cols("head", self.c, p, lo, hi).float(), lo)
        dev0 = self.L.device(self.active[0])
        total = cnt = torch.zeros((), device=dev0)
        for i in range(n_chunks):
            sl = slice(i * C, (i + 1) * C)

            def part(p):
                args = (h[p][:, sl], w[p][0], labels[p][:, sl], w[p][1], dt)
                return (checkpoint(_ce_part, *args, use_reentrant=False,
                                   preserve_rng_state=False)
                        if torch.is_grad_enabled() else _ce_part(*args))

            parts = self.each(part)
            lse = self.c.all_gather({p: parts[p][0][None] for p in parts},
                                    ("model",), 0)
            gold = self.c.all_reduce({p: parts[p][1] for p in parts},
                                     ("model",))
            for p in self.active:
                if self.L.member(p) or (not self.split and self.L.row(p)):
                    # a row's sum is taken once, on its member 0; a batch
                    # every row holds is summed on the first row only
                    continue
                m = (torch.ones(labels[p][:, sl].shape, device=dev0)
                     if mask is None else mask[p][:, sl].to(dev0))
                row = ((torch.logsumexp(lse[p], 0) - gold[p]).to(dev0)
                       * m).sum()
                total = total + row
                cnt = cnt + m.sum()
        if self.L.n_rows > 1 and self.split:  # the rows' sums and counts
            for _ in range(self.L.n_rows):
                self.log.add("all-reduce", 8, self.L.n_rows, None)
        loss = total / torch.clamp(cnt, min=1.0)
        # on the meta device the positions that do not run send no
        # gradient back to the parts they read (a reduce-scatter's share of
        # another row's loss: a MoE chunk's slots of a row with no tokens in
        # it); a zero-weighted use stands in, so the backward runs whole
        for t in self.c.sent:
            loss = loss + 0 * t.sum().to(loss.device)
        return loss

    def last_logits(self, h: dict) -> torch.Tensor:
        """(B, V) float32 logits of the last position, on the first
        position's device (where the stream is sequence-split, member M -
        1's last token, gathered over ``model``)."""
        V = self.cfg.vocab
        if self.seq:
            last = self.c.all_gather({p: t[:, -1:] for p, t in h.items()},
                                     ("model",), 1)
            h = {p: t[:, -1:] for p, t in last.items()}

        def part(p):
            lo, hi = _split(V, self.L.M, self.L.member(p))
            return mm(h[p][:, -1], self.mp.cols("head", self.c, p, lo,
                                                hi)).float()

        full = self.c.all_gather(self.each(part), ("model",), -1)
        if self.split:
            full = self.c.all_gather(full, self.L.batch_axes, 0)
        return full[self.active[0]]


def _moe_chunks(T: int, exec_cfg: ExecConfig) -> int:
    """``moe_block``'s dispatch chunks over ``T`` tokens."""
    if exec_cfg.unroll_scans:
        n = min(exec_cfg.probe_chunks, T)
    elif exec_cfg.moe_chunk and T > exec_cfg.moe_chunk:
        n = T // exec_cfg.moe_chunk
    else:
        n = 1
    while T % n:
        n -= 1
    return n


def _moe_route(xc, router, cfg: ModelConfig, C: int) -> SimpleNamespace:
    """One dispatch chunk's routing, ``moe_block``'s ``"capacity"`` path
    up to its buffer: the entries (token, k) sorted by expert (``tok``,
    ``se``), each one's slot and whether it is kept (within C), its gate,
    the experts' sizes and first sorted entries, and each entry's sorted
    position (``inv``).  Every tensor has a static shape (no mask, no
    ``bincount``), so the meta device runs it too."""
    E = cfg.moe_experts
    _, expert_flat, token_flat, gate_flat, order = _route(
        xc[None], SimpleNamespace(router=router), cfg)
    se = expert_flat[order]
    sizes = torch.zeros(E, dtype=torch.long, device=xc.device).index_add_(
        0, expert_flat, torch.ones_like(expert_flat))
    start = torch.cumsum(sizes, 0) - sizes
    within = torch.arange(se.shape[0], device=xc.device) - start[se]
    keep = within < C
    return SimpleNamespace(
        tok=token_flat[order], se=se, slot=torch.clamp(within, 0, C - 1),
        gate=gate_flat[order] * keep, sizes=sizes, start=start,
        inv=torch.argsort(order))


def _moe_combine(y, r: SimpleNamespace, K: int, a: int, b: int):
    """Tokens ``[a, b)`` of a chunk from its experts' whole output ``y``
    (E, C, D): each token's kept entries, gated, added in sorted order (as
    ``moe_block``'s scatter-add adds them)."""
    sel = torch.sort(r.inv[a * K:b * K]).values
    y_tok = y[r.se[sel], r.slot[sel]] * r.gate[sel][:, None].to(y.dtype)
    out = torch.zeros((b - a, y.shape[-1]), dtype=y.dtype, device=y.device)
    return out.index_add_(0, r.tok[sel] - a, y_tok)


def _local_heads(cfg: ModelConfig, n_kv: int, g: int) -> ModelConfig:
    """``cfg`` seen by a member computing ``n_kv`` KV heads of ``g`` query
    heads each (``d_head`` kept)."""
    import dataclasses

    return dataclasses.replace(cfg, n_heads=n_kv * g, n_kv_heads=n_kv,
                               d_head=cfg.d_head)


def _ce_part(hc, w, lc, lo: int, logits_dtype):
    """One member's chunk: (log-sum-exp over its vocab columns, the gold
    logit where the label is one of them, else 0), each (B, C)."""
    logits = mm_f32(hc, w, "bcd,dv->bcv").to(logits_dtype).float()
    lse = torch.logsumexp(logits, dim=-1)
    local = lc - lo
    ok = (local >= 0) & (local < w.shape[1])
    gold = torch.gather(logits, -1, local.clamp(0, w.shape[1] - 1)[..., None]
                        )[..., 0]
    return lse, gold * ok


# ---------------------------------------------------------------------------
# the optimizer on the mesh
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _replica_axes(spec, mesh) -> tuple:
    used = {a for e in spec for a in _axes_of(e)}
    return tuple(a for a in mesh.axis_names if a not in used)


def adamw_init(mp: MeshLM, cfg) -> dict:
    """AdamW's state for ``mp``, placed by ``opt_state_shardings``: the
    reference's structure, every leaf a :class:`~.sharding.Placed` of
    zeros (``step`` replicated)."""
    from ..launch.specs import opt_shardings

    tree = mp.structure.param_tree()
    specs = opt_shardings(tree, mp.shardings(), cfg, mp.mesh)
    mdt = getattr(torch, cfg.m_dtype)
    from ..optim.adamw import _factorable

    mu = []
    for leaf, sh in zip(leaves(tree), specs["mu"], strict=True):
        shape = leaf_shape(leaf)
        d = {"m": _placed_empty(shape, mdt, sh["m"])}
        if cfg.factored and _factorable(shape):
            d["vr"] = _placed_empty(shape[:-1], torch.float32, sh["vr"])
            d["vc"] = _placed_empty(shape[:-2] + shape[-1:], torch.float32,
                                    sh["vc"])
        else:
            d["v"] = _placed_empty(shape, torch.float32, sh["v"])
        mu.append(d)
    step = _placed_empty((), torch.int32, specs["step"])
    return {"mu": tuple(mu), "step": step}


def _grads(mp: MeshLM, coll: Collectives, loss) -> dict:
    """name -> {position: gradient of the shard}, each replicated block's
    copies summed over the positions holding it."""
    names = sorted(mp.placed)
    flat = [(n, c) for n in names for c in mp.layout.positions]
    shards = [mp.placed[n].shards[c] for n, c in flat]
    if not shards[0].requires_grad:
        raise ValueError("the mesh model's shards are frozen: place a "
                         "trainable model (init_params(..., "
                         "trainable=True))")
    gs = torch.autograd.grad(loss, shards, allow_unused=True)
    # a unit's recompute stops once its saved tensors are back, before its
    # body resets the unit: the sums below run at top level
    coll.unit = None
    out = {n: {} for n in names}
    active = set(coll.active)
    for (n, c), s, g in zip(flat, shards, gs):
        if c in active:
            out[n][c] = torch.zeros_like(s) if g is None else g
    specs = {n: mp.placed[n].sharding.spec for n in names}
    with torch.no_grad():
        for n in names:
            out[n] = coll.all_reduce(out[n], _replica_axes(specs[n],
                                                           mp.mesh))
    return out


def _global_norm(mp: MeshLM, coll: Collectives, grads: dict):
    """The global norm of the gradient, each distinct block counted once,
    on the first position's device."""
    dev0 = mp.device
    total = torch.zeros((), device=dev0)
    for n in sorted(grads):
        like = next(iter(grads[n].values()))
        for _, holders in mp.blocks[n]:
            g = coll.value(grads[n], holders[0], like)
            total = total + torch.sum(torch.square(g.float())).to(dev0)
    n = len(mp.layout.positions)
    for _ in range(n):
        coll.log.add("all-reduce", 4, n, None)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(mp: MeshLM, coll: Collectives, grads: dict, state: dict,
                 cfg, lr) -> dict:
    """The reference's AdamW on every position's shards (in place): plain
    and ``m_bf16`` leaf by leaf as :func:`repro_torch.optim.adamw_update`
    computes them; a factored leaf's row and column means (and the mean of
    its row statistic) summed over the positions holding the other slices
    of the reduced dimension."""
    active = coll.active
    new_mu = []
    step_pl = state["step"]
    steps = {p: step_pl.shards[p] + 1 for p in active}
    for (path, names, stacked), s, spec in zip(
            mp.ref_leaves(), state["mu"], mp.specs().values(), strict=True):
        sp = tuple(spec) + (None,) * 8
        shape = (len(names),) + tuple(mp.placed[names[0]].shape) if stacked \
            else tuple(mp.placed[names[0]].shape)
        nd = len(shape)
        sp = sp[:nd]

        def param(p):
            ts = [mp.placed[n].shards[p] for n in names]
            return torch.stack(ts) if stacked else ts[0]

        def grad(p):
            gs = [grads[n][p] for n in names]
            return (torch.stack(gs) if stacked else gs[0]).float()

        gf = {p: grad(p) for p in active}
        vhat = {}
        new_s = {k: {} for k in s}
        if "v" in s:
            for p in active:
                v = cfg.b2 * s["v"].shards[p] + (1 - cfg.b2) * gf[p] * gf[p]
                new_s["v"][p] = v
                vhat[p] = v / (1.0 - cfg.b2 ** steps[p].float())
        else:
            sq = {p: gf[p] * gf[p] for p in active}
            mr = coll.all_reduce({p: sq[p].sum(-1) for p in sq},
                                 _axes_of(sp[-1]))
            mc = coll.all_reduce({p: sq[p].sum(-2) for p in sq},
                                 _axes_of(sp[-2]))
            for p in active:
                new_s["vr"][p] = (cfg.b2 * s["vr"].shards[p]
                                  + (1 - cfg.b2) * mr[p] / shape[-1])
                new_s["vc"][p] = (cfg.b2 * s["vc"].shards[p]
                                  + (1 - cfg.b2) * mc[p] / shape[-2])
            den = coll.all_reduce({p: new_s["vr"][p].sum(-1, keepdim=True)
                                   for p in active}, _axes_of(sp[-2]))
            for p in active:
                d = torch.clamp(den[p] / shape[-2], min=1e-30)
                vr, vc = new_s["vr"][p], new_s["vc"][p]
                vhat[p] = (vr[..., None] * vc[..., None, :] / d[..., None]) \
                    / (1.0 - cfg.b2 ** steps[p].float())
        for p in active:
            b1c = 1.0 - cfg.b1 ** steps[p].float()
            m = cfg.b1 * s["m"].shards[p].float() + (1 - cfg.b1) * gf[p]
            new_s["m"][p] = m.to(s["m"].dtype)
            w = param(p)
            upd = (m / b1c) / (torch.sqrt(vhat[p]) + cfg.eps)
            upd = upd + cfg.weight_decay * w.float()
            new_w = (w.float() - lr.to(w.device) * upd).to(w.dtype)
            for u, n in enumerate(names):
                mp.placed[n].shards[p].copy_(new_w[u] if stacked else new_w)
        out = {}
        for k, pl in s.items():
            shards = pl.shards.copy()
            for p in active:
                shards[p] = new_s[k][p]
            out[k] = Placed(pl.shape, pl.dtype, pl.sharding, shards)
        new_mu.append(out)
    sh = step_pl.shards.copy()
    for p in active:
        sh[p] = steps[p]
    return {"mu": tuple(new_mu),
            "step": Placed((), torch.int32, step_pl.sharding, sh)}


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, opt_cfg, exec_cfg: ExecConfig,
                    total_steps: int = 100_000, warmup: int = 1_000,
                    positions=None):
    """The reference's train step on the mesh of ``exec_cfg``: ``(mp,
    opt_state, batch) -> (mp, opt_state, {"loss", "gnorm", "lr"})`` with
    ``mp`` a trainable :class:`MeshLM` (updated in place) and
    ``opt_state`` from :func:`adamw_init`.  ``positions`` (on a mesh of
    meta devices only) runs those positions' programs alone."""
    from ..optim import cosine_schedule

    def train_step(mp, opt_state, batch):
        st = Step(mp, exec_cfg, positions)
        loss = st.loss(batch)
        mp.last_log, mp.last_meta_ops = st.log, st.meta_mixer_ops
        mp.last_saved = st.saved
        grads = _grads(mp, st.c, loss)
        with torch.no_grad():
            gnorm = _global_norm(mp, st.c, grads)
            scale = torch.clamp(opt_cfg.clip_norm / torch.clamp(gnorm,
                                                               min=1e-12),
                                max=1.0)
            for n in grads:
                for p, g in grads[n].items():
                    grads[n][p] = (g.float() * scale.to(g.device)).to(
                        g.dtype)
        step0 = opt_state["step"].shards[st.active[0]]
        lr = cosine_schedule(step0 + 1, opt_cfg.lr, warmup, total_steps)
        new_opt = adamw_update(mp, st.c, grads, opt_state, opt_cfg, lr)
        return mp, new_opt, {"loss": loss.detach(), "gnorm": gnorm,
                             "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, exec_cfg: ExecConfig,
                      positions=None):
    @torch.no_grad()
    def prefill_step(mp, batch):
        st = Step(mp, exec_cfg, positions)
        out = st.last_logits(st.hidden(batch))
        mp.last_log, mp.last_meta_ops = st.log, st.meta_mixer_ops
        mp.last_saved = st.saved
        return out

    return prefill_step


# ---------------------------------------------------------------------------
# decode on the mesh
# ---------------------------------------------------------------------------


def _layer_kinds(cfg: ModelConfig, n_units: int) -> list:
    uk = unit_kinds(cfg)
    return ([(f"prelude.{i}", k) for i, k in enumerate(prelude_kinds(cfg))]
            + [(f"units.{i}", uk[i % len(uk)])
               for i in range(n_units * len(uk))]
            + [(f"trailing.{i}", k)
               for i, k in enumerate(trailing_kinds(cfg))])


def init_caches(mp: MeshLM, batch: int, max_len: int,
                kv_quant: bool = False) -> dict:
    """The decode state on the mesh: ``{"prelude", "units", "trailing"}``
    as :func:`~.model.init_caches` gives it, every leaf a
    :class:`~.sharding.Placed` of zeros by ``cache_shardings``."""
    cfg = mp.cfg
    out = {"prelude": [], "units": [], "trailing": []}
    for prefix, kind in _layer_kinds(cfg, mp._n_units()):
        like = init_block_cache(cfg, kind, batch, max_len, kv_quant,
                                torch.device("meta"))
        sh = cache_shardings(like, mp.mesh, cfg)
        out[prefix.split(".")[0]].append(
            {k: _placed_empty(tuple(v.shape), v.dtype, sh[k])
             for k, v in like.items()})
    return out


def gather_caches(caches: dict, device=None) -> dict:
    """The mesh caches as :func:`~.model.init_caches`' tensors (bit for
    bit)."""
    from .sharding import gather

    return {part: [{k: gather(v, device) for k, v in c.items()}
                   for c in layers] for part, layers in caches.items()}


def _slot_range(pl: Placed, p) -> tuple:
    """The batch rows and sequence slots ``[lo, hi)`` of a k / v cache's
    shard at ``p`` (dims 0 and 1)."""
    for coords, sl in _blocks(pl.shape, pl.sharding):
        if coords == p:
            return sl[0], sl[1]
    raise MeshError(f"no shard at {p}")


class DecodeStep(Step):
    """One decode step on the mesh."""

    def row_cache(self, pl: Placed, p) -> torch.Tensor:
        """The whole of row ``p``'s batch rows of a cache leaf on ``p``."""
        rows, _ = _slot_range(pl, p)
        region = ((rows.start, rows.stop),) + tuple((0, n)
                                                    for n in pl.shape[1:])
        return self.c.fetch(pl, unique_blocks(pl), region, p)

    def self_attention(self, prefix, h: dict, cache: dict, pos: int, rope,
                       window: int) -> dict:
        """Split-K decode attention.  Each member projects the token's q, k
        and v for its own heads only (:func:`_head_split`'s runs; every
        head where they do not split), the members' q, k and v are
        gathered over ``model`` (one token: tiny), the member holding slot
        ``pos`` writes k and v, each member scores its slots for every
        head, the members' partial softmax sums merge by their maxima, and
        each member multiplies its heads' rows of ``wo``, summed over
        ``model``."""
        cfg = self.cfg
        dh = cfg.d_head
        G = cfg.n_heads // cfg.n_kv_heads
        quant = "k_scale" in cache
        kpl, vpl = cache["k"], cache["v"]
        Smax = kpl.shape[1]
        slot = pos % Smax if window > 0 else pos
        # the members scoring distinct slot ranges (a range held by more
        # than one member is scored by its first holder)
        owners = {}
        for coords, sl in _blocks(kpl.shape, kpl.sharding):
            owners.setdefault((self.L.row(coords), sl[1].start), coords)
        scorers = set(owners.values())
        tp, run = self.head_runs()
        wo = {}

        def project(p):
            (kv0, kv1), g, _ = run(p)
            ns = self.head_weights(prefix, p, run(p))
            wo[p] = ns.wo
            q, k, v = _project_qkv(h[p], h[p], ns,
                                   _local_heads(cfg, kv1 - kv0, g))
            B = q.shape[0]
            if rope[p] is not None:
                cos, sin = rope[p]
                pc = cos[pos].expand(B, 1, dh // 2)
                ps = sin[pos].expand(B, 1, dh // 2)
                q = apply_rope(q, pc, ps)
                k = apply_rope(k, pc, ps)
            return tuple(t.reshape(B, 1, -1) for t in (q, k, v))

        qkv = self.each(project)
        if tp:
            # the parts' widths follow the members' head runs (a position
            # that does not run, on the meta device, stands in by its own)
            t0 = next(iter(qkv.values()))

            def width(q, i):
                (kv0, kv1), _, (q_lo, q_hi) = run(q)
                return q_hi - q_lo if i == 0 else (kv1 - kv0) * dh

            g = [self.c.all_gather(
                {p: t[i] for p, t in qkv.items()}, ("model",), -1,
                lambda q, i=i: t0[i].new_empty(t0[i].shape[:-1]
                                               + (width(q, i),)))
                for i in range(3)]
            # where members split one KV group, each computed its group's
            # k and v: keep the first member's of each group
            kv_runs = [run(q)[0] for q in self.L.group(self.active[0],
                                                         ("model",))]
            at = np.cumsum([0] + [(b - a) * dh for a, b in kv_runs])
            keep = [i for i, r in enumerate(kv_runs) if r not in kv_runs[:i]]
            qkv = {p: (g[0][p],) + tuple(
                g[i][p] if len(keep) == len(kv_runs) else torch.cat(
                    [g[i][p][..., at[j]:at[j + 1]] for j in keep], -1)
                for i in (1, 2)) for p in qkv}

        def part(p):
            q, k, v = qkv[p]
            B = q.shape[0]
            q = q.reshape(B, 1, cfg.n_kv_heads, G, dh)
            k = k.reshape(B, 1, cfg.n_kv_heads, dh)
            v = v.reshape(B, 1, cfg.n_kv_heads, dh)
            _, seq = _slot_range(kpl, p)
            if seq.start <= slot < seq.stop:
                i = slot - seq.start
                if quant:
                    kq, ks = _quantize_kv(k)
                    vq, vs = _quantize_kv(v)
                    kpl.shards[p][:, i] = kq[:, 0]
                    vpl.shards[p][:, i] = vq[:, 0]
                    cache["k_scale"].shards[p][:, i] = ks[:, 0]
                    cache["v_scale"].shards[p][:, i] = vs[:, 0]
                else:
                    kpl.shards[p][:, i] = k[:, 0]
                    vpl.shards[p][:, i] = v[:, 0]
            if p not in scorers:
                return None
            if quant:
                k_eff = (kpl.shards[p].to(torch.bfloat16) * cache[
                    "k_scale"].shards[p][..., None].to(torch.bfloat16))
                v_eff = (vpl.shards[p].to(torch.bfloat16) * cache[
                    "v_scale"].shards[p][..., None].to(torch.bfloat16))
            else:
                k_eff, v_eff = kpl.shards[p], vpl.shards[p]
            idx = torch.arange(seq.start, seq.stop, device=q.device)
            if window > 0:
                valid = (idx <= slot) | (pos >= Smax)
            else:
                valid = idx <= pos
            s = mm_f32(q, k_eff, "bqkgd,bckd->bkgqc") * (dh ** -0.5)
            s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
            mx = s.amax(-1)
            e = torch.exp(s - mx[..., None])
            o = mm_f32(e.to(v_eff.dtype), v_eff, "bkgqc,bckd->bkgqd")
            return mx, e.sum(-1), o

        parts = self.each(part)
        like = next(st for st in parts.values() if st is not None)
        out = {}
        for p in self.active:
            grp = [q for q in self.L.group(p, ("model",)) if q in scorers]
            dev = self.L.device(p)
            stats = [tuple(t.to(dev) for t in (
                parts[q] if q in parts else
                tuple(self.c.value({}, q, t) for t in like))) for q in grp]
            if len(grp) > 1:
                self.log.add("all-gather", sum(_nbytes(t) for s in stats
                                               for t in s),
                             len(grp), self.c.unit)
            mx = functools.reduce(torch.maximum, [s[0] for s in stats])
            den = sum(s[1] * torch.exp(s[0] - mx) for s in stats)
            num = sum(s[2] * torch.exp(s[0] - mx)[..., None] for s in stats)
            o = (num / den[..., None]).permute(0, 3, 1, 2, 4)
            B = o.shape[0]
            q_lo, q_hi = run(p)[2]
            o = o.to(h[p].dtype).reshape(B, 1, cfg.n_heads * dh)
            out[p] = mm(o[..., q_lo:q_hi], wo[p])
        return self.c.all_reduce(out, ("model",)) if tp else out

    def layer(self, xs, prefix, kind, cache, pos, rope) -> dict:
        cfg, mp = self.cfg, self.mp
        ln = lambda name, xs: {p: rmsnorm(xs[p], mp.full(  # noqa: E731
            f"{prefix}.{name}", self.c, p)) for p in xs}
        if kind in ("attn", "dense_attn", "moe"):
            window = cfg.window if cfg.kind == "hybrid" else 0
            a = self.self_attention(f"{prefix}.attn", ln("ln1", xs), cache,
                                    pos, rope, window)
            xs = {p: xs[p] + a[p] for p in xs}
            h = ln("ln2", xs)
            if kind == "moe":
                f = self.moe(f"{prefix}.moe", h)
            else:
                d_ff = cfg.dense_first_layer_ff if kind == "dense_attn" \
                    else cfg.d_ff
                f = self.mlp(f"{prefix}.mlp", h, d_ff)
            return {p: xs[p] + f[p] for p in xs}
        if kind == "mamba":
            m = self.mamba(f"{prefix}.mamba", ln("ln1", xs), cache)
            return {p: xs[p] + m[p] for p in xs}
        if kind == "rglru":
            g = self.rglru(f"{prefix}.rglru", ln("ln1", xs), cache)
            xs = {p: xs[p] + g[p] for p in xs}
            f = self.mlp(f"{prefix}.mlp", ln("ln2", xs), cfg.d_ff)
            return {p: xs[p] + f[p] for p in xs}
        # cross-attention: the row's whole vision cache gathered, the
        # single-device layer run (its cache is not updated)
        out = {}
        for p in self.active:
            full = {k: self.row_cache(v, p) for k, v in cache.items()}
            out[p], _ = decode_block(
                xs[p], mp.module(prefix, self.c, p), cfg, self.ec, kind,
                full, pos, rope[p])
        return out


def make_decode_step(cfg: ModelConfig, exec_cfg: ExecConfig, max_len: int,
                     positions=None):
    """``decode_one(mp, caches, token, pos) -> (logits (B, V) float32 on
    the first position's device, caches)`` with ``caches`` from
    :func:`init_caches` (updated in place)."""

    @torch.no_grad()
    def decode_one(mp, caches, token, pos):
        st = DecodeStep(mp, exec_cfg, positions)
        pos = int(pos)
        xs = st.embed({"tokens": token})
        rope = st.each(lambda p: None if cfg.kind in ("ssm",) else
                       _rope_cache(cfg, max_len, st.L.device(p)))
        layers = caches["prelude"] + caches["units"] + caches["trailing"]
        nk = len(unit_kinds(cfg))
        for (prefix, kind), c in zip(_layer_kinds(cfg, mp._n_units()),
                                     layers, strict=True):
            if prefix.startswith("units."):
                st.c.unit = int(prefix.split(".")[1]) // nk
            xs = st.layer(xs, prefix, kind, c, pos, rope)
            st.c.unit = None
        h = {p: rmsnorm(xs[p], mp.full("ln_f", st.c, p)) for p in xs}
        out = st.last_logits(h)
        mp.last_log, mp.last_meta_ops = st.log, st.meta_mixer_ops
        return out, caches

    return decode_one
