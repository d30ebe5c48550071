"""The port's dry run (``repro_torch.launch.dryrun``) and its traffic
accounting (``repro_torch.launch.hlo_analysis``) against the reference's,
on the CPU: the analytic HBM model term for term, the collective wire
models on one op list, per-device bytes against the spec trees' shards, a
dense train cell's FLOPs against their closed form, the record's keys, and
no TPU v5e figure anywhere in the port."""
import ast
import dataclasses
import io
import json
import re
import tokenize
from math import prod
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config
from repro.launch import hlo_analysis as ref_hlo
from repro.models import SHAPES as REF_SHAPES

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, hlo_analysis, specs
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_BF16_FLOPS
from repro_torch.models import SHAPES, ShapeSpec
from repro_torch.models.sharding import _blocks
from repro_torch.models.spmd import Transfer, TransferLog
from repro_torch.tree import leaves

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_hbm_bytes_matches_the_reference(arch):
    for name, shape in SHAPES.items():
        for n, opt, lg, kv in ((256, 8, 4, 2), (512, 2.5, 2, 1.07)):
            want = ref_hlo.analytic_hbm_bytes(
                ref_get_config(arch), REF_SHAPES[name], n, opt,
                logits_bytes_per=lg, kv_bytes_per=kv)
            got = hlo_analysis.analytic_hbm_bytes(
                get_config(arch), shape, n, opt, logits_bytes_per=lg,
                kv_bytes_per=kv)
            assert got == want, (arch, name, n)


#: (op, dtype, result shape, group): one op list for both packages
OPS = [("all-gather", "bf16", (8, 64), 4), ("all-reduce", "f32", (16, 32), 2),
       ("reduce-scatter", "bf16", (4, 128), 4),
       ("all-to-all", "f32", (8, 8), 8),
       ("collective-permute", "bf16", (32,), 2),
       ("all-reduce", "bf16", (2, 3, 5), 16)]
_SIZE = {"bf16": 2, "f32": 4}


def test_collective_traffic_wire_models_match_the_reference():
    """The reference parses the ops from HLO text; the port reads them from
    a transfer log (a reduce-scatter's entry holds its operand, the
    result's group-fold).  Bytes, counts and bytes by op agree."""
    lines, log = [], TransferLog()
    for i, (op, dt, shape, g) in enumerate(OPS):
        dims = ",".join(map(str, shape))
        lines.append(f"  %x{i} = {dt}[{dims}]{{0}} {op}({dt}[{dims}] %p{i}), "
                     f"replica_groups=[{16 // g},{g}]<=[16]")
        nbytes = prod(shape) * _SIZE[dt]
        if op == "reduce-scatter":
            nbytes *= g
        log.entries.append(Transfer(op, nbytes, g, None, "forward"))
    want = ref_hlo.collective_traffic("\n".join(lines))
    got = hlo_analysis.collective_traffic(log)
    assert got["counts"] == pytest.approx(want["counts"])
    assert got["by_op"] == pytest.approx(want["by_op"])
    assert got["bytes"] == pytest.approx(want["bytes"])
    # per position: a log of four positions' entries is four programs
    four = TransferLog(log.entries * 4)
    assert hlo_analysis.collective_traffic(four, 4)["bytes"] == \
        pytest.approx(want["bytes"])


def test_collective_schedule_splits_units_from_the_top_level():
    log = TransferLog()
    for unit in (None, 0, 0, 1, 1, None):
        log.add("all-gather", 8, 2, unit)
    log.add("all-reduce", 8, 2, 0)
    log.add("all-reduce", 8, 2, 1)
    sched = hlo_analysis.collective_schedule(log)
    assert sched == {"per_layer": {"all-gather": 2, "all-reduce": 1},
                     "top_level": {"all-gather": 2}}


def test_roofline_takes_the_h100_data_sheet():
    t = hlo_analysis.roofline(989e12, 3.35e12, 450e9)
    assert (t.compute_s, t.memory_s, t.collective_s) == pytest.approx(
        (1.0, 1.0, 1.0))
    assert (PEAK_BF16_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    assert hlo_analysis.roofline(1, 0, 0).dominant == "compute"


#: the TPU v5e figures of the reference's roofline
#: (``repro/launch/hlo_analysis.py``: peak flop/s, HBM bytes/s, ICI bytes/s
#: per link)
V5E = ("197e12", "819e9", "50e9")


def _port_sources():
    yield from sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"
    yield from sorted((ROOT / "examples").glob("*_torch.py"))


def test_no_tpu_v5e_figure_in_the_port():
    """No number literal of the port, ``chip_smoke.py`` or the port's
    examples spells a v5e figure (197e12 flop/s, 819e9 B/s, 50e9 B/s a
    link, in any notation), and no text names the v5e.  The optimizer
    choice's threshold of 5e10 parameters (the reference dry run's, copied)
    is a count of parameters, not a rate, and is exempt."""
    bad = {float(v) for v in V5E}
    for path in _port_sources():
        text = path.read_text()
        assert "v5e" not in text.lower(), path
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.NUMBER:
                try:
                    value = float(tok.string.replace("_", ""))
                except ValueError:
                    continue
                assert value not in bad or "n_params" in tok.line, (
                    path, tok.start, tok.line)


# ---------------------------------------------------------------------------
# the dry run on a 2x2 meta mesh
# ---------------------------------------------------------------------------

CELLS = {"train": ShapeSpec("train_t", 32, 4, "train"),
         "decode": ShapeSpec("decode_t", 64, 4, "decode")}


def _small():
    """qwen2's reduced config at two KV heads (so the 2-member head split
    holds whole KV groups and every product splits four ways)."""
    return dataclasses.replace(get_config("qwen2_7b").reduced(),
                               n_kv_heads=2)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    return {mode: dryrun.run_cell("qwen2_7b", s.name, False, out,
                                  force=True, cfg=_small(), shape=s,
                                  mesh_shape=(2, 2))
            for mode, s in CELLS.items()}


def _position0_bytes(structs) -> int:
    """Bytes of every leaf's block at position (0, 0), by ``_blocks``."""
    total = 0
    for s in leaves(structs):
        for coords, sl in _blocks(s.shape, s.sharding):
            if coords == (0, 0):
                n = prod(x.stop - x.start for x in sl)
                total += n * torch.empty((), dtype=s.dtype).element_size()
    return total


def test_per_device_bytes_are_the_spec_shards(records):
    cfg = _small()
    mesh = dryrun.meta_mesh(False, (2, 2))
    p, o = specs.param_structs(cfg, mesh, opt_cfg=dryrun._opt_cfg(cfg))
    b = specs.batch_structs_sharded(cfg, mesh, CELLS["train"])
    mem = records["train"]["full"]["memory"]
    assert mem["argument_size_in_bytes"] == (
        _position0_bytes(p) + _position0_bytes(o) + _position0_bytes(b))
    p, _ = specs.param_structs(cfg, mesh)
    c = specs.cache_structs(cfg, mesh, CELLS["decode"])
    t = specs.decode_token_struct(cfg, mesh, CELLS["decode"])
    mem = records["decode"]["full"]["memory"]
    assert mem["argument_size_in_bytes"] == (
        _position0_bytes(p) + _position0_bytes(c) + _position0_bytes(t))
    assert mem["temp_is_analytic"] and mem["fits_h100_80gb"]


def test_dense_train_flops_match_their_closed_form(records):
    """Per position of the 2x2 mesh (two rows of the batch, two members
    splitting heads, ``d_ff`` and vocab), the flop counter's total over a
    train step is exactly ``[8 T N - 2 T F D + 8 T D V + 11 M] L / 4``
    per layer: N a layer's matrix weights and T = B S tokens: 6 N T, plus
    remat's recompute of the unit's forward, 2 N T, but for its last
    product (``w_down``: PyTorch's non-reentrant checkpoint stops
    recomputing once every saved tensor is back, and that product's output
    is not saved); the head 6 T D V plus the loss chunks' recomputed
    logits, 2 T D V; attention's products M = 2 B H S^2 d_head each,
    computed on every tile (the masked ones too), twice forward (QK^T, PV;
    again under remat) and seven times in the backward (scores and dP in
    each of its two passes, dK, dV, dQ).  That lies between 1.0 and 1.6
    times 6 N T plus attention's 6 M, the textbook count."""
    cfg = _small()
    s = CELLS["train"]
    T = s.global_batch * s.seq_len
    D, H, KV, dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.vocab, cfg.num_layers)
    N = D * H * dh * 2 + 2 * D * KV * dh + 3 * D * F
    M = 2 * s.global_batch * H * s.seq_len ** 2 * dh
    want = (L * (8 * T * N - 2 * T * F * D + 11 * M) + 8 * T * D * V) / 4
    got = records["train"]["totals"]["flops_per_device"]
    assert got == pytest.approx(want, rel=1e-9)
    textbook = (6 * T * (L * N + D * V) + 6 * M * L) / 4
    assert 1.0 <= got / textbook <= 1.6


def test_moe_train_flops_match_the_splits_closed_form(tmp_path):
    """deepseek-moe-16b's reduced config (d_model 64, 4 heads of 16, one
    dense first layer of d_ff 64, one MoE layer: 8 experts top-6 of d_ff
    F = 64, two shared, capacity 1.25) on the 2x2 meta mesh, T = 4 x 32
    tokens in the probe's 2 dispatch chunks of Tc = 64: C = 60 slots an
    expert.  One position's train FLOPs are exactly

    * the dense layer (outside remat): 6 T N_p / 4 and attention's 9 M / 4
      (forward 2, backward 7, ``test_dense_train_flops_match_their_closed_
      form``'s count);
    * the MoE layer's attention (under remat): 8 T N_a / 4 + 11 M / 4;
    * the router on every row's tokens: 2 T D E forward, again under remat,
      and its backward 4 Tc D E for the one chunk that holds the row's
      tokens (the other chunk's gates are combined, and differentiated, by
      the other row);
    * the experts: per chunk three (E, C / R, D) x (E, D, F / M) products,
      2 E (C / R) D (F / M) each, four times (forward, remat, two in the
      backward): the split's share, a quarter of the layer's whole
      dispatch;
    * the shared experts, split as the MLP: (24 - 2) T D Fs / 4 (remat
      skips the last product, as for the dense MLP);
    * the head and loss: 8 T D V / 4."""
    cfg = get_config("deepseek_moe_16b").reduced()
    s = CELLS["train"]
    rec = dryrun.run_cell("deepseek_moe_16b", s.name, False, tmp_path,
                          force=True, cfg=cfg, shape=s, mesh_shape=(2, 2))
    assert rec["ok"], rec.get("traceback")
    T = s.global_batch * s.seq_len
    D, H, KV, dh, F, V, E, K = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, cfg.d_ff, cfg.vocab,
                                cfg.moe_experts, cfg.moe_top_k)
    n = 2
    Tc = T // n
    C = max(8, int(Tc * K * cfg.moe_capacity) // E)
    assert (C, C % 2, F % 2) == (60, 0, 0)
    N_a = D * H * dh * 2 + 2 * D * KV * dh
    N_p = N_a + 3 * D * cfg.dense_first_layer_ff
    M = 2 * s.global_batch * H * s.seq_len ** 2 * dh
    Fs = cfg.moe_shared * F
    experts = n * 4 * 3 * 2 * E * (C // 2) * D * (F // 2)
    want = ((6 * T * N_p + 9 * M) / 4 + (8 * T * N_a + 11 * M) / 4
            + 4 * T * D * E + 4 * Tc * D * E + experts
            + 22 * T * D * Fs / 4 + 8 * T * D * V / 4)
    got = rec["totals"]["flops_per_device"]
    assert got == pytest.approx(want, rel=1e-9)
    # the whole dispatch on one position would be four times the experts'
    assert experts * 4 == n * 4 * 3 * 2 * E * C * D * F


def test_activation_term_of_the_pod_train_cell_by_hand():
    """qwen2-7b ``train_4k`` (256 x 4,096 tokens) on the 16x16 pod: 16 rows
    of B_r = 16, t = 65,536 tokens a row, M = 16, D = 3,584, 28 layers.
    Each unit's saved input is 28 t D 2 B = 13.15 GB a device replicated,
    0.82 GB sequence-split.  The layer's working set is what one unit saves
    for backward (``unit_parts``, fitted to ``measured_unit_bytes``): per
    norm (two) its float32 input, output and rstd over the member's
    t / 16 = 4,096 tokens sequence-split (the row's t replicated), 8 D + 4
    bytes a token, and its bf16 normed input over the row's t, gathered,
    2 D; attention at the member's 2 query heads (7 a KV group split over
    4 members) and 1 KV head of d_head 128: q, out, k and v at bf16,
    4 (2 + 1) 128, and the float32 log-sum-exp, 4 x 2; the MLP's seven
    bf16 (t, 1,184) tensors, 14 x 1,184 (18,944 / 16).  Flash attention
    saves no S x S scores, so Korthikanti's 5 H S term is gone.  That is
    2.36 GB split and 5.89 GB replicated (Korthikanti's formula gave 1.84
    and 4.04).  Two float32 logit chunks of 512 tokens over the member's
    9,504 vocab columns either way."""
    from repro_torch.models import SHAPES, ExecConfig

    cfg, shape = get_config("qwen2_7b"), SHAPES["train_4k"]
    mesh = dryrun.meta_mesh(False)
    t, D = 16 * 4096, 3584
    logits = 2 * 16 * 512 * 9504 * 4
    rest = 4 * 3 * 128 + 4 * 2 + 14 * 1184
    want = {True: {"saved": 28 * t * D * 2 / 16,
                   "layer": t * (2 * ((8 * D + 4) / 16 + 2 * D) + rest),
                   "logits": logits},
            False: {"saved": 28 * t * D * 2,
                    "layer": t * (2 * (8 * D + 4 + 2 * D) + rest),
                    "logits": logits}}
    for seq, parts in want.items():
        got = dryrun.activation_parts(cfg, shape, mesh,
                                      ExecConfig(seq_parallel=seq))
        assert got == pytest.approx(parts, rel=1e-12)
        assert dryrun.activation_bytes(
            cfg, shape, mesh, ExecConfig(seq_parallel=seq)) == \
            pytest.approx(sum(parts.values()), rel=1e-12)
    assert round(want[False]["saved"] / 1e9, 2) == 13.15
    assert round(want[True]["saved"] / 1e9, 2) == 0.82
    assert round(want[False]["layer"] / 1e9, 2) == 5.89
    assert round(want[True]["layer"] / 1e9, 2) == 2.36
    # the default is the reference's (seq_parallel on); a recurrent family
    # keeps its stream whole
    assert dryrun.activation_parts(cfg, shape, mesh) == pytest.approx(
        want[True], rel=1e-12)
    ssm = get_config("falcon_mamba_7b")
    assert dryrun.activation_parts(ssm, shape, mesh)["saved"] == \
        ssm.num_layers * t * ssm.d_model * 2


#: one architecture per family of the activation term, and two reduced
#: shapes that differ in S and in D (B = 4 on the 2x2 meta mesh: B_r = 2,
#: M = 2)
FAMILIES = {"dense": "qwen2_7b", "moe": "deepseek_moe_16b",
            "ssm": "falcon_mamba_7b", "hybrid": "recurrentgemma_9b"}
UNIT_SHAPES = [(40, 96), (64, 128)]
#: the parts a family's unit adds to ``layer``
OWN_PARTS = {"moe": {"moe_buffers"}, "ssm": {"scan"}, "hybrid": {"scan"}}


@pytest.mark.parametrize("S,D", UNIT_SHAPES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_unit_term_is_what_one_unit_saves_for_backward(family, S, D):
    """The train term's unit parts (``layer`` and the family's own) lie
    within 15% of what one reduced unit saves for backward, measured under
    ``saved_tensors_hooks`` with remat off (``measured_unit_bytes``)."""
    from repro_torch.models import ExecConfig
    from repro_torch.models.spmd import seq_layout

    cfg = dataclasses.replace(get_config(FAMILIES[family]).reduced(),
                              d_model=D)
    shape = ShapeSpec("unit_t", S, 4, "train")
    got = dryrun.measured_unit_bytes(cfg, shape, (2, 2))
    ec = ExecConfig()
    parts = dryrun.unit_parts(cfg, 2, S, 2, 2, seq_layout(cfg, ec, 2, S),
                              ec)
    assert set(parts) == {"layer"} | OWN_PARTS.get(family, set())
    assert sum(parts.values()) == pytest.approx(got, rel=0.15)
    full = dryrun.activation_parts(cfg, shape, dryrun.meta_mesh(False,
                                                                (2, 2)))
    assert {k: full[k] for k in parts} == parts


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pod_train_records_list_the_familys_parts(family):
    """At ``train_4k`` on the pod each family's record names its own
    terms: a MoE's routing and buffers, a recurrent family's scan."""
    from repro_torch.models import SHAPES

    parts = dryrun.activation_parts(get_config(FAMILIES[family]),
                                    SHAPES["train_4k"],
                                    dryrun.meta_mesh(False))
    assert set(parts) == ({"saved", "layer", "logits"}
                          | OWN_PARTS.get(family, set()))
    assert all(v > 0 for v in parts.values())


def test_records_carry_the_layouts_activation_parts(records):
    """The 2x2 train record's activation parts are the split layout's (S =
    32 divides over M = 2): each unit's saved input at a member's 16 of
    the row's 2 x 32 tokens."""
    cfg, s = _small(), CELLS["train"]
    parts = records["train"]["full"]["memory"]["temp_parts"]
    assert parts["saved"] == cfg.num_layers * 2 * s.seq_len * cfg.d_model
    assert records["train"]["full"]["memory"]["temp_size_in_bytes"] == (
        pytest.approx(sum(parts.values())))


def _reference_record_keys():
    """The keys the reference's ``run_cell`` writes (its source's ``rec``
    dict literal and ``rec[...]`` assignments) and its ``totals``'."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys, totals = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "rec" and isinstance(
                    node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(tgt, ast.Subscript) and isinstance(
                    tgt.value, ast.Name) and tgt.value.id == "rec":
                keys.add(tgt.slice.value)
                if tgt.slice.value == "totals":
                    totals = {k.value for k in node.value.keys}
    return keys, totals


def test_record_keys_are_the_references(records):
    keys, totals = _reference_record_keys()
    for rec in records.values():
        assert set(rec) == keys - {"error", "traceback"}
        assert set(rec["totals"]) == totals
        assert set(rec["full"]) >= {"compile_s", "cost", "memory"}
        assert set(rec["probes"]) == {1, 2}
        assert rec["ok"] and "one of 4" in rec["full"]["positions_run"]


def test_unrunnable_cells_carry_the_ports_reason(tmp_path):
    rec = dryrun.run_cell("qwen2_7b", "long_500k", False, tmp_path)
    assert rec["runnable"] is False and "quadratic" in rec["skip_reason"]
    assert json.loads((tmp_path / "qwen2_7b.long_500k.pod.json")
                      .read_text()) == rec


def test_the_cli_writes_under_build_by_default():
    assert dryrun.OUT_DEFAULT == ROOT / "build" / "dryrun_torch"
    assert re.search(r"experiments", str(dryrun.OUT_DEFAULT)) is None
