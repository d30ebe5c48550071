"""The sequence-parallel residual of ``repro_torch.models.spmd`` (the
reference's ``ExecConfig.seq_parallel``) on the 2x2 (``data``, ``model``)
mesh of ``cpu`` devices of ``tests/test_torch_mesh.py``, at ``reduced()``
configs and float32.

* Against the reference's jitted 2x2 step (whose ``ExecConfig(mesh=)``
  defaults to ``seq_parallel=True``): ``test_torch_mesh``'s tolerances.
* Against the port's replicated layout (``seq_parallel=False``): the
  layout moves where data lives and which collectives carry it, never the
  order of any sum of the forward, so the losses are **bit for bit** equal.
  The gradients are not: autograd sums a replicated stream's gradient over
  the members after each block, a split one inside the reduce-scatter's
  backward, so they agree **within 1e-6 of each leaf's largest
  magnitude** (8.2e-7 at worst over the archs here).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro_torch.models as P
from repro_torch import optim
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from test_torch_mesh import (B, EPS, EXEC, LR, REF_MESH, S, SRC, _batches,
                             _cfgs, _check, _mesh, _numpy_init)

pytestmark = pytest.mark.port

CPU = "cpu"
M = 2  # the mesh's model axis

#: arch -> config overrides (MoE at capacity E: the reference's drops
#: differ, ROADMAP F8)
LAYOUT_ARCHS = {
    "qwen2_7b": {"race_smooth_radius": 2},
    "deepseek_moe_16b": {"moe_capacity": 8.0},
    "hubert_xlarge": {},
    "llama_3_2_vision_90b": {},
}


def _batch(cfg, seed=0, b=B, s=S) -> dict:
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.input_embed_dim:
        out["embeds"] = rng.standard_normal(
            (b, s, cfg.input_embed_dim)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.kind == "vlm":
        out["vision"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def _placed(arch, mesh=None, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    params = _numpy_init(rcfg)
    model = P.from_reference(pcfg, params, device=CPU, trainable=True)
    return pcfg, params, spmd.place_model(model, mesh or _mesh())


def _ec(mesh, seq_parallel: bool) -> P.ExecConfig:
    return P.ExecConfig(mesh=mesh, seq_parallel=seq_parallel, **EXEC)


def _loss_and_grads(mp, cfg, batch, seq_parallel: bool):
    """One forward and backward on the mesh: (the loss, name -> {position:
    gradient}, the step)."""
    st = spmd.Step(mp, _ec(mp.mesh, seq_parallel))
    loss = st.loss(batch)
    return loss.detach(), spmd._grads(mp, st.c, loss), st


def _steps(pcfg, params, batches, seq_parallel: bool):
    """The port's two AdamW steps on the mesh: (losses, the reference's
    leaves gathered, the model)."""
    from repro_torch.tree import as_array, leaves

    opt = optim.AdamWConfig(lr=LR, eps=EPS)
    model = P.from_reference(pcfg, params, device=CPU, trainable=True)
    mp = spmd.place_model(model, _mesh())
    step = P.make_train_step(pcfg, opt, _ec(mp.mesh, seq_parallel),
                             total_steps=10, warmup=2)
    state = spmd.adamw_init(mp, opt)
    losses = []
    for b in batches:
        mp, state, m = step(mp, state, b)
        losses.append(float(m["loss"]))
    flat = [as_array(t).detach().numpy() for t in leaves(mp.gathered())]
    return losses, flat, mp


# ---------------------------------------------------------------------------
# against the reference and the replicated layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2_7b", "deepseek_moe_16b"])
def test_layout_steps_match_the_reference_mesh_step(arch, tmp_path,
                                                    monkeypatch):
    """Two train steps on the layout (the mixer on K1's emulator for qwen2)
    against the reference's own ``jax.jit(make_train_step(...,
    ExecConfig(mesh=2x2)))`` in a subprocess with four forced host
    devices: ``test_torch_mesh``'s tolerances; the step did run the layout
    (its sums are reduce-scatters)."""
    kw = LAYOUT_ARCHS[arch]
    rcfg, pcfg = _cfgs(arch, **kw)
    params = _numpy_init(rcfg)
    batches = _batches(pcfg, 2)
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({"arch": arch, "cfg": {"dtype": "float32", **kw},
                     "exec": EXEC, "lr": LR, "eps": EPS, "params": params,
                     "batches": batches}, f)
    r = subprocess.run(
        [sys.executable, "-c", REF_MESH, str(tmp_path / "in.pkl"),
         str(tmp_path / "out.pkl")], capture_output=True, text=True,
        env={"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", ""),
             "HOME": str(tmp_path)}, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        want = pickle.load(f)
    monkeypatch.setenv("RACE_BACKEND", "hopper")  # the port's name
    losses, flat, mp = _steps(pcfg, params, batches, True)
    _check(losses, flat, want["losses"], want["params"])
    kinds = mp.last_log.bytes_by_kind()
    assert kinds["reduce-scatter"] > 0
    if kw.get("race_smooth_radius"):
        assert kinds["all-to-all"] > 0  # the mixer's channels to tokens


@pytest.mark.parametrize("arch", sorted(LAYOUT_ARCHS))
def test_layout_equals_the_replicated_layout(arch):
    """One forward and backward on each layout from the same weights and
    batch: the losses bit for bit, every shard's gradient within 1e-6 of
    its largest magnitude (the module docstring)."""
    cfg, _, mp = _placed(arch, **LAYOUT_ARCHS[arch])
    batch = _batch(cfg)
    l0, g0, _ = _loss_and_grads(mp, cfg, batch, False)
    l1, g1, st = _loss_and_grads(mp, cfg, batch, True)
    assert st.seq and torch.equal(l0, l1)
    for name in g0:
        for p, a in g0[name].items():
            b = g1[name][p]
            bound = 1e-6 * max(float(a.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= bound, (name, p)


@pytest.mark.parametrize("arch", sorted(LAYOUT_ARCHS))
def test_unit_inputs_are_each_members_tokens(arch, monkeypatch):
    """Every layer unit's input on every position is its member's run of
    the row's tokens, (B_r, S / M, D) = (2, 8, 64) (member m: tokens [8 m,
    8 m + 8)), and what the units' remat saves a position falls by M."""
    cfg, _, mp = _placed(arch, **LAYOUT_ARCHS[arch])
    batch = _batch(cfg)
    seen = []
    inner = spmd.Step._remat

    def remat(self, fn, xs):
        seen.append({p: tuple(x.shape) for p, x in xs.items()})
        return inner(self, fn, xs)

    monkeypatch.setattr(spmd.Step, "_remat", remat)
    _, _, st = _loss_and_grads(mp, cfg, batch, True)
    n_units = mp._n_units()
    assert len(seen) == n_units
    for shapes in seen:
        assert shapes == {p: (B // 2, S // M, cfg.d_model)
                          for p in mp.layout.positions}
    _, _, rep = _loss_and_grads(mp, cfg, batch, False)
    assert len(seen) == 2 * n_units
    for shapes in seen[n_units:]:
        assert set(shapes.values()) == {(B // 2, S, cfg.d_model)}
    unit = (B // 2) * S * cfg.d_model * 4 * n_units
    for p in mp.layout.positions:
        assert (rep.saved[p], st.saved[p]) == (unit, unit // M)


def test_a_units_input_is_the_members_slice_of_the_replicated_stream():
    """The residual at a unit boundary is the member's slice of the
    replicated layout's, bit for bit (the first unit's input, after the
    mixer's all-to-all)."""
    cfg, _, mp = _placed("qwen2_7b", race_smooth_radius=2)
    batch = _batch(cfg, seed=3)
    got = {}
    for seq in (False, True):
        st = spmd.Step(mp, _ec(mp.mesh, seq))
        inner = st._remat
        st._remat = lambda fn, xs, seq=seq: (
            got.setdefault(seq, xs), inner(fn, xs))[1]
        with torch.no_grad():
            st.hidden(batch)
    for p, x in got[True].items():
        m = p[1]
        assert torch.equal(x, got[False][p][:, m * S // M:(m + 1) * S // M])


# ---------------------------------------------------------------------------
# where the layout does not apply
# ---------------------------------------------------------------------------


def _log_key(log) -> list:
    return [(e.kind, e.nbytes, e.group, e.unit, e.phase)
            for e in log.entries]


@pytest.mark.parametrize("case", ["falcon_mamba_7b", "recurrentgemma_9b",
                                  "qwen2_7b-S15", "qwen2_7b-M1"])
def test_todays_layout_where_the_layout_does_not_apply(case):
    """The recurrent families (time is the recurrence's axis), an S the
    ``model`` axis does not divide (15 on 2) and a mesh whose ``model``
    axis has one member (4 x 1) keep the replicated stream: ``seq_layout``
    is false, and ``seq_parallel`` on and off give one transfer log, loss
    and gradients, bit for bit."""
    arch, _, rest = case.partition("-")
    s, mesh = S, None
    if rest == "S15":
        s = 15
    if rest == "M1":
        mesh = make_mesh((4, 1), ("data", "model"), devices=[CPU] * 4)
    cfg, _, mp = _placed(arch, mesh)
    batch = _batch(cfg, s=s)
    assert not spmd.seq_layout(cfg, _ec(mp.mesh, True), mp.layout.M, s)
    l0, g0, st0 = _loss_and_grads(mp, cfg, batch, False)
    l1, g1, st1 = _loss_and_grads(mp, cfg, batch, True)
    assert not st1.seq and torch.equal(l0, l1)
    assert _log_key(st0.log) == _log_key(st1.log)
    assert st0.saved == st1.saved
    for name in g0:
        for p in g0[name]:
            assert torch.equal(g0[name][p], g1[name][p]), (name, p)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", [
    ("qwen2_7b", {}), ("qwen2_7b", {"race_smooth_radius": 2}),
    ("deepseek_moe_16b", {"moe_capacity": 8.0})])
def test_prefill_and_decode_on_the_layout(arch, kw):
    """The layout's prefill (the last token gathered from member M - 1)
    equals the replicated layout's bit for bit and one device's within
    1e-5; teacher-forced mesh decode (one token: the replicated stream)
    reproduces the layout's prefill within 1e-3 of the largest logit
    (without the mixer: decode does not run it, on one device either)."""
    rcfg, cfg = _cfgs(arch, **kw)
    model = P.from_reference(cfg, _numpy_init(rcfg), device=CPU)
    mp = spmd.place_model(model, _mesh())
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S))
    one = P.make_prefill_step(cfg, P.ExecConfig(**EXEC))(
        model, {"tokens": tokens})
    rep = P.make_prefill_step(cfg, _ec(mp.mesh, False))(
        mp, {"tokens": tokens})
    got = P.make_prefill_step(cfg, _ec(mp.mesh, True))(
        mp, {"tokens": tokens})
    assert mp.last_log.bytes_by_kind()["reduce-scatter"] > 0
    assert torch.equal(got, rep)
    scale = float(one.abs().max())
    assert float((got - one).abs().max()) <= 1e-5 * scale
    if cfg.race_smooth_radius:
        return
    caches = spmd.init_caches(mp, B, S)
    dec = P.make_decode_step(cfg, _ec(mp.mesh, True), max_len=S)
    for t in range(S):
        logits, caches = dec(mp, caches, tokens[:, t:t + 1], t)
    assert "reduce-scatter" not in mp.last_log.bytes_by_kind()
    assert float((logits - got).abs().max()) <= 1e-3 * scale


# ---------------------------------------------------------------------------
# the log, by hand
# ---------------------------------------------------------------------------


def test_a_dense_units_transfer_log_matches_a_hand_count():
    """One train step of a one-layer dense model (d_model 16, 2 heads of
    8, d_ff 32, vocab 64, ``race_smooth_radius`` 2, float32) on the 2x2
    mesh, batch 2 x 4 (one example a row, two tokens a member).  Per
    position, in the unit: its head's columns of ``wq``, ``wk``, ``wv``
    and rows of ``wo`` (16 x 8 x 4 B), its ``d_ff`` half of ``w_gate``,
    ``w_up``, ``w_down`` (16 x 16 x 4 B) and each block's normed tokens
    (1 x 4 x 16 x 4 B) gathered, in the forward and again under remat;
    the attention's and the MLP's sums reduce-scattered (logged at the
    whole 1 x 4 x 16 x 4 B), the MLP's not again under remat (the
    recompute stops once the saved tensors are back).  The backward: a
    reduce-scatter per gather of the forward, an all-gather per sum; no
    all-reduce in the unit.  Outside it, the mixer's channels reach the
    tokens by an all-to-all (1 x 2 x 16 x 4 B, and again in the backward)
    and ``ln_f``'s tokens are gathered for the loss (1 x 4 x 16 x 4 B).
    The unit's remat keeps 1 x 2 x 16 x 4 B a position."""
    cfg = ModelConfig(name="tiny", kind="dense", num_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=2, d_head=8, d_ff=32, vocab=64,
                      dtype="float32", race_smooth_radius=2)
    model = P.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU, trainable=True)
    mp = spmd.place_model(model, _mesh())
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (2, 4)),
             "labels": rng.integers(0, 64, (2, 4))}
    opt = optim.AdamWConfig()
    P.make_train_step(cfg, opt, _ec(mp.mesh, True))(
        mp, spmd.adamw_init(mp, opt), batch)
    log = mp.last_log

    def count(unit, phase, kind):
        return sorted(e.nbytes for e in log.entries if e.unit == unit
                      and e.phase == phase and e.kind == kind)

    weights = [16 * 8 * 4] * 4 + [16 * 16 * 4] * 3
    normed = [4 * 16 * 4] * 2
    assert count(0, "forward", "all-gather") == sorted(
        (weights + normed) * 2 * 4)
    assert count(0, "forward", "reduce-scatter") == [4 * 16 * 4] * 3 * 4
    assert count(0, "backward", "reduce-scatter") == sorted(
        (weights + normed) * 4)
    assert count(0, "backward", "all-gather") == [4 * 16 * 4] * 2 * 4
    assert count(0, "forward", "all-reduce") == []
    assert count(0, "backward", "all-reduce") == []
    assert count(None, "forward", "all-to-all") == [2 * 16 * 4] * 4
    assert count(None, "backward", "all-to-all") == [2 * 16 * 4] * 4
    assert (4 * 16 * 4) in count(None, "forward", "all-gather")
    assert {e.group for e in log.entries if e.unit == 0} == {2}
    assert mp.last_saved == {p: 2 * 16 * 4 for p in mp.layout.positions}


def test_the_layout_is_the_default_where_it_applies():
    """``ExecConfig(mesh=...)`` takes the reference's default,
    ``seq_parallel=True``: the dense, MoE, encoder and vlm families are laid
    out on the 2x2 mesh at S = 16, the recurrent ones are not."""
    ec = P.ExecConfig(mesh=_mesh())
    assert ec.seq_parallel
    want = {"dense": True, "moe": True, "encoder": True, "vlm": True,
            "ssm": False, "hybrid": False}
    for kind, laid in want.items():
        cfg = ModelConfig(name="k", kind=kind, num_layers=1, d_model=16,
                          n_heads=2, n_kv_heads=2, d_head=8, d_ff=32,
                          vocab=64)
        assert spmd.seq_layout(cfg, ec, M, S) is laid, kind
        assert not spmd.seq_layout(cfg, ec, M, S + 1)
        assert not spmd.seq_layout(cfg, ec, 1, S)
        assert not spmd.seq_layout(
            cfg, dataclasses.replace(ec, seq_parallel=False), M, S)
