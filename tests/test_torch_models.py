"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's (``repro.models``, ``repro.configs``) at reduced
size on the CPU: the reference's parameters carried across by
``from_reference``, the same numpy inputs, prefill and teacher-forced
decode for all ten architectures in float32 and bfloat16, the int8 KV
cache, the windowed ring buffer, MoE routing (and F8, where the port departs
from the reference on purpose), and the RACE mixer ``race_smooth`` on both
port backends.

Tolerances (relative to the largest reference logit): float32 1e-4;
bfloat16 3e-2 with the argmax equal on at least 90 % of rows."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import models as R
from repro.configs import ARCHS, all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro.models.moe import moe_block as ref_moe_block

import repro_torch.models as P
from repro_torch.configs import all_configs, get_config
from repro_torch.core.executor import executor_cache
from repro_torch.models import ssm
from repro_torch.models.moe import MoE, moe_block
from repro_torch.models.weights import to_tensor
from repro_torch.testing import default_tolerances

pytestmark = pytest.mark.port

CPU = "cpu"
B, S, STEPS = 2, 16, 3
R_EXEC = R.ExecConfig(attn_chunk_q=8, attn_chunk_k=8, ssm_chunk=8)
P_EXEC = P.ExecConfig(attn_chunk_q=8, attn_chunk_k=8, ssm_chunk=8)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PLAN = default_tolerances(np.float32)["plan"]


def _cfgs(arch, dtype="float32", **kw):
    """(reference, port) reduced configs; MoE at capacity E (no drops)."""
    out = []
    for get in (ref_get_config, get_config):
        cfg = get(arch).reduced()
        if cfg.kind == "moe":
            cfg = dataclasses.replace(cfg, moe_capacity=float(cfg.moe_experts))
        out.append(dataclasses.replace(cfg, dtype=dtype, **kw))
    return out


def _batch(cfg, rng, seq=S):
    batch = {}
    if cfg.input_embed_dim:
        batch["embeds"] = rng.standard_normal(
            (B, seq, cfg.input_embed_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    if cfg.kind == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_params(rcfg, seed=0):
    """The reference's random init, once per config in this process."""
    return R.init_params(jax.random.PRNGKey(seed), rcfg)


def _pair(arch, dtype="float32", seed=0, **kw):
    """Reference params and a fresh port LM holding them."""
    rcfg, pcfg = _cfgs(arch, dtype, **kw)
    params = _ref_params(rcfg, seed)
    model = P.from_reference(pcfg, jax.tree.map(np.asarray, params),
                             device=CPU)
    return rcfg, pcfg, params, model


def _check(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (err, scale)
    if dtype == "bfloat16" and got.ndim == 2:
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert agree >= 0.9, agree
    return err / scale


@pytest.fixture(scope="module", params=[
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """One arch and dtype: the reference's prefill, hidden states and
    STEPS teacher-forced decode steps (each step jitted once), and the
    port's, on the same tokens."""
    arch, dtype = request.param
    rcfg, pcfg, params, model = _pair(arch, dtype)
    rng = np.random.default_rng(1)
    batch = _batch(rcfg, rng)
    out = dict(arch=arch, dtype=dtype, rcfg=rcfg, pcfg=pcfg)
    prefill = R.make_prefill_step(rcfg, R_EXEC)
    hidden, logits = jax.jit(lambda p, b: (
        R.forward_hidden(p, rcfg, R_EXEC, b), prefill(p, b)))(
            params, _jnp(batch))
    out["want_logits"] = np.asarray(logits, np.float32)
    out["want_hidden"] = np.asarray(hidden, np.float32)
    out["got_logits"] = P.make_prefill_step(pcfg, P_EXEC)(model, batch)
    with torch.no_grad():
        out["got_hidden"] = P.forward_hidden(model, pcfg, P_EXEC, batch)
    if rcfg.supports_decode():
        tokens = batch["tokens"]
        rc = R.init_caches(rcfg, B, S)
        pc = P.init_caches(pcfg, B, S, device=CPU)
        rstep = jax.jit(R.make_decode_step(rcfg, R_EXEC, S))
        pstep = P.make_decode_step(pcfg, P_EXEC, S)
        out["decode"] = []
        for t in range(STEPS):
            want, rc = rstep(params, rc, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t))
            got, pc = pstep(model, pc, tokens[:, t:t + 1], t)
            out["decode"].append((got, np.asarray(want)))
    return out


# ---------------------------------------------------------------------------
# configuration: the own copy equals the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    for r, p in ((ref, port), (ref.reduced(), port.reduced()),
                 (ref.scaled(race_smooth_radius=2),
                  port.scaled(race_smooth_radius=2))):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.n_params() == r.n_params()
        assert p.n_active_params() == r.n_active_params()
        assert [p.layer_kind(i) for i in range(p.num_layers)] == [
            r.layer_kind(i) for i in range(r.num_layers)]
        assert (p.d_inner, p.dt_rank, p.supports_decode(),
                p.subquadratic()) == (r.d_inner, r.dt_rank,
                                      r.supports_decode(), r.subquadratic())
        assert (P.n_units(p), P.unit_kinds(p)) == (R.n_units(r),
                                                   R.unit_kinds(r))
    assert get_config(arch.replace("_", "-")) == port


def test_registry_and_shapes_match_reference():
    from repro.models import SHAPES as REF_SHAPES
    from repro.models import cell_is_runnable as ref_runnable

    assert sorted(all_configs()) == sorted(ref_all_configs()) == sorted(ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in P.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in ARCHS:
        for name in P.SHAPES:
            assert P.cell_is_runnable(get_config(arch), P.SHAPES[name]) == \
                ref_runnable(ref_get_config(arch), REF_SHAPES[name])


# ---------------------------------------------------------------------------
# prefill and decode, every arch
# ---------------------------------------------------------------------------


def test_prefill_matches_reference(run):
    _check(run["got_logits"], run["want_logits"], run["dtype"])
    assert run["got_logits"].dtype == torch.float32


def test_forward_hidden_matches_reference(run):
    got = run["got_hidden"].float().numpy()
    want = run["want_hidden"]
    assert run["got_hidden"].dtype == P.common.torch_dtype(run["dtype"])
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= TOL[run["dtype"]] * scale


def test_decode_matches_reference(run):
    if not run["rcfg"].supports_decode():
        assert run["arch"] == "hubert_xlarge"
        return
    assert len(run["decode"]) == STEPS
    for got, want in run["decode"]:
        _check(got, want, run["dtype"])


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference(arch, kv_quant):
    rcfg, pcfg = _cfgs(arch, "bfloat16")
    want = R.init_caches(rcfg, B, S, kv_quant=kv_quant)
    got = P.init_caches(pcfg, B, S, kv_quant=kv_quant, device=CPU)
    assert len(got["prelude"]) == len(want["prelude"])
    assert len(got["trailing"]) == len(want["trailing"])
    for g, w in zip(got["prelude"] + got["trailing"],
                    want["prelude"] + want["trailing"]):
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in g.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in w.items()}
    nk = len(R.unit_kinds(rcfg))
    assert len(got["units"]) == R.n_units(rcfg) * nk
    for i, g in enumerate(got["units"]):
        w = want["units"][i % nk]
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in g.items()} == {
            k: (tuple(v.shape[1:]), str(v.dtype)) for k, v in w.items()}
        assert all(not v.any() for v in g.values())


@pytest.mark.parametrize("arch", ["qwen2_7b", "recurrentgemma_9b",
                                  "deepseek_moe_16b"])
def test_kv_quant_decode_matches_reference(arch):
    """The int8 KV cache: quantized K/V, bfloat16 scales, dequantized
    scores; every step within the bfloat16 tolerance of the reference's."""
    rcfg, pcfg, params, model = _pair(arch, "bfloat16")
    tokens = np.random.default_rng(2).integers(0, rcfg.vocab, (B, 6))
    rc = R.init_caches(rcfg, B, 8, kv_quant=True)
    pc = P.init_caches(pcfg, B, 8, kv_quant=True, device=CPU)
    step = jax.jit(R.make_decode_step(rcfg, R_EXEC, 8))
    for t in range(tokens.shape[1]):
        want, rc = step(params, rc, jnp.asarray(tokens[:, t:t + 1],
                                                jnp.int32), jnp.int32(t))
        got, pc = P.decode_step(model, pc, pcfg, P_EXEC, tokens[:, t:t + 1],
                                t, max_len=8)
        _check(got, want, "bfloat16")
    attn = [c for c in pc["units"] + pc["prelude"] if "k_scale" in c]
    assert attn and all(c["k"].dtype == torch.int8 for c in attn)
    ref_attn = [c for c in jax.tree.leaves(rc["units"]) if c.dtype == jnp.int8]
    assert ref_attn


@pytest.mark.parametrize("kv_quant", [False, True])
def test_windowed_decode_past_the_window(kv_quant):
    """recurrentgemma's local attention (window 16 at reduced size) over 28
    steps: the ring buffer wraps, and every step stays within tolerance of
    the reference; the ring holds window slots only.  Without the int8
    cache the model's float32 tolerance holds; with it, the bfloat16 one,
    the dtype of the stored scales (the jitted reference keeps excess
    precision in the bfloat16 dequantization, up to 1.9e-3 of the largest
    logit here, where its op-by-op semantics agree with the port's to
    1e-6)."""
    rcfg, pcfg, params, model = _pair("recurrentgemma_9b")
    assert rcfg.window == 16
    steps = 28
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, (B, steps))
    rc = R.init_caches(rcfg, B, steps, kv_quant=kv_quant)
    pc = P.init_caches(pcfg, B, steps, kv_quant=kv_quant, device=CPU)
    step = jax.jit(R.make_decode_step(rcfg, R_EXEC, steps))
    for t in range(steps):
        want, rc = step(params, rc, jnp.asarray(tokens[:, t:t + 1],
                                                jnp.int32), jnp.int32(t))
        got, pc = P.decode_step(model, pc, pcfg, P_EXEC, tokens[:, t:t + 1],
                                t, max_len=steps)
        _check(got, want, "bfloat16" if kv_quant else "float32")
    rings = [c["k"] for c in pc["units"] if "k" in c]
    assert rings and all(k.shape[1] == rcfg.window for k in rings)


@pytest.mark.parametrize("arch", ["qwen2_7b", "falcon_mamba_7b",
                                  "recurrentgemma_9b", "grok_1_314b"])
def test_decode_reproduces_prefill(arch):
    """Teacher-forced decode of the whole prompt gives the prefill's
    last-position logits (the port against itself, float32)."""
    _, pcfg, _, model = _pair(arch)
    batch = _batch(pcfg, np.random.default_rng(4))
    want = P.prefill_logits(model, pcfg, P_EXEC, batch)
    caches = P.init_caches(pcfg, B, S, device=CPU)
    for t in range(S):
        got, caches = P.decode_step(model, caches, pcfg, P_EXEC,
                                    batch["tokens"][:, t:t + 1], t,
                                    max_len=S)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale


# ---------------------------------------------------------------------------
# MoE: no drops against the reference; F8 at overflow
# ---------------------------------------------------------------------------


def _moe_pair(capacity, impl="capacity", seed=5):
    rcfg, pcfg = _cfgs("grok_1_314b", "float32", moe_capacity=capacity)
    rp = R.init_params(jax.random.PRNGKey(seed), rcfg)
    leaf = rp["units"][0]["moe"]
    tree = {k: np.asarray(v[0]) for k, v in leaf.items()}
    moe = MoE(pcfg, torch.Generator().manual_seed(0), CPU)
    for k, v in tree.items():
        getattr(moe, k).data.copy_(to_tensor(v))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    want = np.asarray(ref_moe_block(jnp.asarray(x), tree, rcfg, impl=impl))
    got = moe_block(torch.from_numpy(x), moe, pcfg, impl=impl).numpy()
    return rcfg, tree, x, want, got


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_without_drops_matches_reference(impl):
    rcfg, _, _, want, got = _moe_pair(float(8), impl)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def _gshard(x, tree, cfg):
    """Plain GShard capacity dispatch in numpy: tokens sorted by expert
    (stably), the first C of each expert kept, each kept one weighted by
    its gate; plus the token order's (expert, slot) of every assignment."""
    T, D = B * S, cfg.d_model
    E, K = cfg.moe_experts, cfg.moe_top_k
    xf = x.reshape(T, D).astype(np.float64)
    logits = xf @ tree["router"].astype(np.float64)
    top = np.argsort(-logits, axis=1, kind="stable")[:, :K]
    vals = np.take_along_axis(logits, top, 1)
    gates = np.exp(vals - vals.max(1, keepdims=True))
    gates /= gates.sum(1, keepdims=True)
    C = max(8, int(T * K * cfg.moe_capacity) // E)
    flat = top.reshape(-1)
    order = np.argsort(flat, kind="stable")
    out = np.zeros((T, D))
    seen = np.zeros(E, int)
    slots = {}
    for idx in order:
        t, e = idx // K, flat[idx]
        slot = seen[e]
        seen[e] += 1
        slots[(t, e)] = slot
        if slot >= C:
            continue
        w = [tree[k][e].astype(np.float64) for k in ("w_gate", "w_up",
                                                     "w_down")]
        g, u = xf[t] @ w[0], xf[t] @ w[1]
        out[t] += gates.reshape(-1)[idx] * ((g / (1 + np.exp(-g)) * u) @ w[2])
    return out, slots, seen, C


def test_moe_overflow_f8_every_kept_token_gets_its_expert():
    """F8: at capacity 0.25 (C = 8 of 64 assignments per expert) experts
    overflow.  The port equals plain GShard dispatch (every kept token gets
    its expert's output); the reference differs only on the tokens kept at
    slot C-1 of an overflowing expert, whose output it overwrote."""
    rcfg, tree, x, want, got = _moe_pair(0.25)
    plain, slots, seen, C = _gshard(x, tree, rcfg)
    scale = float(np.abs(plain).max())
    assert float(np.abs(got - plain.reshape(got.shape)).max()) <= 1e-5 * scale
    wiped = {t for (t, e), s in slots.items() if s == C - 1 and seen[e] > C}
    assert wiped, "the case must overflow an expert"
    rows = np.abs(got - want).reshape(B * S, -1).max(1)
    assert set(np.nonzero(rows > 1e-5 * scale)[0]) == wiped


# ---------------------------------------------------------------------------
# the RACE mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_race_smooth_matches_reference(backend, radius):
    """Random stream and taps: the port on each backend (``"hopper"`` is
    the kernel's tile emulator on the CPU) against the reference's
    ``race_smooth(..., backend="xla")``, within ``plan``; the plan has
    the shared box sum as its aux."""
    rng = np.random.default_rng(radius)
    x = rng.standard_normal((B, S, 24)).astype(np.float32)
    taps = rng.standard_normal(radius + 1).astype(np.float32)
    want = np.asarray(ref_ssm.race_smooth(jnp.asarray(x), jnp.asarray(taps),
                                          radius=radius, backend="xla"))
    got = ssm.race_smooth(torch.from_numpy(x), torch.from_numpy(taps),
                          radius=radius, backend=backend)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= PLAN * scale
    res = ssm._smooth_result(S, B * 24, radius)
    assert res.n_aux_materialized() >= 1
    assert res.plan.aux_order[0].name == "aa_1_0"


def test_race_smooth_runs_through_one_executor(monkeypatch):
    """``"auto"`` on a CPU tensor: one cached executor per shape, the
    plan's ``"hopper"`` selection (its tile emulator here)."""
    monkeypatch.setattr(ssm, "_smooth_results", {})
    executor_cache().clear()
    x = torch.randn(B, S, 8, generator=torch.Generator().manual_seed(0))
    taps = torch.tensor([0.5, -0.25, 0.125])
    for _ in range(3):
        y = ssm.race_smooth(x, taps, radius=2)
    assert y.shape == x.shape and y.dtype == x.dtype
    (key,) = executor_cache().keys()
    assert key.backend == "hopper"


def test_prefill_with_race_smooth_matches_reference():
    """qwen2 reduced with ``race_smooth_radius=2`` and random taps: the
    mixer runs in the prefill (the reference on ``"xla"``, the port on
    ``"auto"``) and the logits agree in float32; decode has no mixer, as in
    the reference."""
    rcfg, pcfg, params, model = _pair("qwen2_7b", race_smooth_radius=2)
    taps = np.array([0.3, -0.2, 0.1], np.float32)
    params = dict(params, smooth_taps=jnp.asarray(taps))
    model.smooth_taps.data.copy_(torch.from_numpy(taps))
    batch = _batch(rcfg, np.random.default_rng(6))
    want = np.asarray(R.prefill_logits(params, rcfg, R_EXEC, _jnp(batch)))
    got = P.prefill_logits(model, pcfg, P_EXEC, batch)
    _check(got, want, "float32")
    plain = dataclasses.replace(pcfg, race_smooth_radius=0)
    assert float((P.prefill_logits(model, plain, P_EXEC, batch) - got)
                 .abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# device, weights and knobs
# ---------------------------------------------------------------------------


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2_7b").reduced()
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.init_params(cfg, generator=g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.init_caches(cfg, B, S)
    model = P.init_params(cfg, generator=g, device=CPU)
    assert {p.device.type for p in model.parameters()} == {"cpu"}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_structure_matches_reference(arch):
    """The port's own init has the reference's leaves, shapes and dtypes
    (``from_reference`` raises otherwise) and draws them from the generator
    alone: the same seed gives the same weights."""
    rcfg, pcfg = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, _ref_params(rcfg))
    P.from_reference(pcfg, tree, device=CPU)
    a, b = (P.init_params(pcfg, generator=torch.Generator().manual_seed(7),
                          device=CPU) for _ in range(2))
    assert sum(p.numel() for p in a.parameters()) == sum(
        v.size for v in jax.tree.leaves(tree))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    smooth = P.init_params(dataclasses.replace(pcfg, race_smooth_radius=2),
                           generator=torch.Generator(), device=CPU)
    assert smooth.smooth_taps.shape == (3,) and not smooth.smooth_taps.any()


def test_from_reference_refuses_a_mismatched_tree():
    rcfg, pcfg = _cfgs("qwen2_7b")
    tree = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(0),
                                                  rcfg))
    with pytest.raises(ValueError, match="lacks"):
        P.from_reference(pcfg, dict(tree, head=None), device=CPU)
    extra = dict(tree, ln_g=tree["ln_f"])
    with pytest.raises(ValueError, match="no parameter"):
        P.from_reference(pcfg, extra, device=CPU)
    with pytest.raises(ValueError, match="port"):
        P.from_reference(pcfg, dict(tree, ln_f=tree["ln_f"][:-1]),
                         device=CPU)


def test_from_reference_keeps_bfloat16_bits():
    rcfg, pcfg, params, model = _pair("qwen2_7b", "bfloat16")
    want = np.asarray(params["head"]).view(np.uint16)
    got = model.head.view(torch.int16).numpy().view(np.uint16)
    assert model.head.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want)


def test_exec_config_mesh_is_not_ported():
    assert P.ExecConfig().constrain(3, None) == 3
    assert P.ExecConfig().batch_axes() == ()
    with pytest.raises(ValueError, match="sharding.py"):
        P.ExecConfig(mesh=object())


@pytest.mark.parametrize("arch,dtype,knobs", [
    ("grok_1_314b", "float32", dict(moe_chunk=8)),
    ("deepseek_moe_16b", "bfloat16", dict(moe_chunk=16)),
    ("falcon_mamba_7b", "bfloat16", dict(ssm_bf16=True)),
    ("grok_1_314b", "float32", dict(unroll_scans=True, probe_chunks=2)),
], ids=["moe_chunk", "moe_chunk-bf16", "ssm_bf16", "moe-unroll"])
def test_exec_knobs_match_reference(arch, dtype, knobs):
    """The execution knobs that change the computation: token-chunked MoE
    dispatch (capacity per chunk), the bfloat16 gating chain after the SSM
    scan, and probe-mode chunk counts, each against the reference with the
    same knobs."""
    rcfg, pcfg, params, model = _pair(arch, dtype)
    batch = _batch(rcfg, np.random.default_rng(9))
    want = np.asarray(R.prefill_logits(
        params, rcfg, dataclasses.replace(R_EXEC, **knobs), _jnp(batch)))
    got = P.prefill_logits(model, pcfg, dataclasses.replace(P_EXEC, **knobs),
                           batch)
    _check(got, want, dtype)


def test_unroll_scans_keeps_chunk_counts():
    """``unroll_scans`` takes ``probe_chunks`` chunks in attention and the
    SSM scan, as the reference's probe mode does, with the same outputs."""
    rcfg, pcfg, params, model = _pair("falcon_mamba_7b")
    batch = _batch(rcfg, np.random.default_rng(8))
    probe = dataclasses.replace(P_EXEC, unroll_scans=True, probe_chunks=4)
    assert ssm._n_chunks(S, probe) == 4
    want = np.asarray(R.prefill_logits(params, rcfg, dataclasses.replace(
        R_EXEC, unroll_scans=True, probe_chunks=4), _jnp(batch)))
    _check(P.prefill_logits(model, pcfg, probe, batch), want, "float32")
