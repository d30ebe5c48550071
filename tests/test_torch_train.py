"""The port's training path against the reference's on the CPU: AdamW,
gradient clipping and the cosine schedule (``repro_torch.optim``), int8
error-feedback compression, the flash-attention backward, the chunked loss,
``make_train_step`` on every architecture's reduced config, a five-step
loss trajectory through the RACE mixer on both port backends, and remat.

The same seeded numpy inputs go to both packages; the reference's
parameters reach the port through ``from_reference``.  Tolerances are
relative to the largest reference value: optimizer 1e-6, flash attention
and the chunked loss 1e-5, a train step's loss 1e-5 and each gradient leaf
1e-4, the mixer's loss trajectory 1e-4."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import models as R
from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.models.attention import flash_attention as ref_flash
from repro.models.common import chunked_ce_loss as ref_ce
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from test_flash_attention import CASES as FLASH_CASES

import repro_torch.models as P
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core.executor import executor_cache
from repro_torch.models.attention import flash_attention
from repro_torch.models.common import chunked_ce_loss
from repro_torch.models.steps import grads_of
from repro_torch.optim import compression
from repro_torch.tree import Stack, as_array, leaves

pytestmark = pytest.mark.port

CPU = "cpu"
R_EXEC = R.ExecConfig(attn_chunk_q=8, attn_chunk_k=8, ssm_chunk=8,
                      loss_chunk=8)
P_EXEC = P.ExecConfig(attn_chunk_q=8, attn_chunk_k=8, ssm_chunk=8,
                      loss_chunk=8)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t) -> np.ndarray:
    return as_array(t).detach().float().numpy()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

#: name -> (shape, units): units > 0 is a per-unit leaf the reference
#: stacks (the port holds a Stack of that many tensors)
OPT_LEAVES = {"w": ((6, 5), 0), "b": ((7,), 0), "ln": ((4,), 3),
              "mlp": ((4, 6), 2), "one": ((3, 2), 1)}


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    ref, port = {}, {}
    for name, (shape, units) in OPT_LEAVES.items():
        full = (units,) + shape if units else shape
        a = rng.standard_normal(full).astype(np.float32)
        ref[name] = jnp.asarray(a)
        t = torch.from_numpy(a.copy())
        port[name] = Stack(t.unbind(0)) if units else t
    return ref, port


@pytest.mark.parametrize("mode", ["plain", "m_bf16", "factored"])
def test_adamw_clip_and_schedule_match_reference(mode):
    """Three clipped AdamW steps on a tree with stacked (unit) leaves:
    parameters, moments and norms within 1e-6 of the reference's."""
    kw = {"plain": {}, "m_bf16": {"m_dtype": "bfloat16"},
          "factored": {"factored": True, "m_dtype": "bfloat16"}}[mode]
    rcfg = ref_adamw.AdamWConfig(lr=1e-2, clip_norm=0.5, **kw)
    pcfg = optim.AdamWConfig(lr=1e-2, clip_norm=0.5, **kw)
    rp, pp = _opt_trees(0)
    rs, ps = ref_adamw.adamw_init(rp, rcfg), optim.adamw_init(pp, pcfg)
    assert [sorted(s) for s in rs["mu"]] == [sorted(s) for s in ps["mu"]]
    for step in range(3):
        rg, pg = _opt_trees(step + 1)
        rg, rn = ref_adamw.clip_by_global_norm(rg, rcfg.clip_norm)
        pg, pn = optim.clip_by_global_norm(pg, pcfg.clip_norm)
        assert _rel(pn, rn) <= 1e-6
        for a, b in zip(jax.tree.leaves(rg), leaves(pg)):
            assert _rel(_np(b), a) <= 1e-6
        rlr = ref_adamw.cosine_schedule(rs["step"] + 1, 1e-2, 2, 10)
        plr = optim.cosine_schedule(ps["step"] + 1, 1e-2, 2, 10)
        assert _rel(plr, rlr) <= 1e-6
        rp, rs = ref_adamw.adamw_update(rp, rg, rs, rcfg, rlr)
        pp2, ps = optim.adamw_update(pp, pg, ps, pcfg, plr)
        assert pp2 is pp  # in place
    for a, b in zip(jax.tree.leaves(rp), leaves(pp)):
        assert _rel(_np(b), a) <= 1e-6
    for ra, pa in zip(jax.tree.leaves(rs), leaves(ps)):
        assert _rel(_np(pa), ra) <= 1e-6
    assert int(ps["step"]) == int(rs["step"]) == 3


def test_factored_state_is_stacked_as_the_reference():
    """A per-unit vector of 3 units (the reference's (3, 4) leaf) is
    factored across its units; one unit's (1, 3, 2) leaf is factored on
    its own last two axes."""
    cfg = optim.AdamWConfig(factored=True)
    _, pp = _opt_trees(0)
    st = dict(zip(sorted(OPT_LEAVES), optim.adamw_init(pp, cfg)["mu"]))
    assert st["ln"]["vr"].shape == (3,) and st["ln"]["vc"].shape == (4,)
    assert st["one"]["vr"].shape == (1, 3) and st["b"]["v"].shape == (7,)


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 40)
    want = ref_adamw.cosine_schedule(jnp.asarray(steps), 3e-4, 5, 30)
    got = optim.cosine_schedule(torch.from_numpy(steps), 3e-4, 5, 30)
    assert _rel(got.numpy(), want) <= 1e-6


def test_ef_int8_compress_matches_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 48)).astype(np.float32)
    e = (1e-3 * rng.standard_normal((64, 48))).astype(np.float32)
    rq, rs, re = ref_comp.ef_int8_compress(jnp.asarray(g), jnp.asarray(e))
    q, s, ne = compression.ef_int8_compress(torch.from_numpy(g),
                                            torch.from_numpy(e))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert abs(float(s) - float(rs)) <= 1e-7
    assert np.abs(ne.numpy() - np.asarray(re)).max() <= 1e-7
    assert np.array_equal(compression.ef_int8_decompress(q, s).numpy(),
                          np.asarray(ref_comp.ef_int8_decompress(rq, rs)))


def test_compress_tree_error_feedback():
    """The reference's error-feedback test on a tree with a unit leaf: the
    residual is what quantization dropped, and a second step carries it."""
    _, g = _opt_trees(3)
    q, s, e = compression.compress_tree(g, None)
    assert all(as_array(x).dtype == torch.int8 for x in leaves(q))
    assert isinstance(q["ln"], Stack) and isinstance(e["ln"], Stack)
    deq = compression.decompress_tree(q, s)
    for d, r, x in zip(leaves(deq), leaves(e), leaves(g)):
        np.testing.assert_allclose(_np(d) + _np(r), _np(x), rtol=1e-6,
                                   atol=1e-6)
    q2, s2, e2 = compression.compress_tree(g, e)
    for d, r, x, r0 in zip(leaves(compression.decompress_tree(q2, s2)),
                           leaves(e2), leaves(g), leaves(e)):
        np.testing.assert_allclose(_np(d) + _np(r), _np(x) + _np(r0),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# flash attention's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,T,KV,G,dh,causal,window,cq,ck", FLASH_CASES)
def test_flash_attention_grads_match_reference(S, T, KV, G, dh, causal,
                                               window, cq, ck):
    """``tests/test_flash_attention.py``'s cases: the forward and ``dq``,
    ``dk``, ``dv`` against ``jax.grad`` of the reference's custom VJP."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, S, KV, G, dh)).astype(np.float32)
    k = rng.standard_normal((2, T, KV, dh)).astype(np.float32)
    v = rng.standard_normal((2, T, KV, dh)).astype(np.float32)
    w = np.arange(dh, dtype=np.float32)

    def ref_loss(q, k, v):
        return (ref_flash(q, k, v, causal, window, R.ExecConfig(
            attn_chunk_q=cq, attn_chunk_k=ck)) * w).sum()

    want_out = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, window, R.ExecConfig(attn_chunk_q=cq,
                                                      attn_chunk_k=ck))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal, window, P.ExecConfig(
        attn_chunk_q=cq, attn_chunk_k=ck))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    assert _rel(out.detach().numpy(), want_out) <= 1e-5
    for g, r, name in zip(got, want, "qkv"):
        assert _rel(g.numpy(), r) <= 1e-5, f"d{name}"


def test_flash_attention_backward_honours_q_offset():
    """Decode-style offsets: a shifted causal mask's gradients against the
    reference's VJP."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 8, 2, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    rec = R.ExecConfig(attn_chunk_q=4, attn_chunk_k=8)
    pec = P.ExecConfig(attn_chunk_q=4, attn_chunk_k=8)
    want = jax.grad(lambda *a: ref_flash(*a, True, 6, rec, 8).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*ts, True, 6, pec, 8).sum(), ts)
    for g, r in zip(got, want):
        assert _rel(g.numpy(), r) <= 1e-5


# ---------------------------------------------------------------------------
# chunked loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk,unroll", [(4, False), (5, False), (8, True)])
def test_chunked_ce_loss_matches_reference(masked, chunk, unroll):
    """Value and gradients (``h``, ``w_out``) within 1e-5; chunk 5 of S =
    12 takes the reference's shrinking chunk count."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) < 0.7).astype(np.float32) if masked else None
    rec = R.ExecConfig(loss_chunk=chunk, unroll_scans=unroll)
    pec = P.ExecConfig(loss_chunk=chunk, unroll_scans=unroll)
    rm = None if mask is None else jnp.asarray(mask)
    want, (gh, gw) = jax.value_and_grad(
        lambda h, w: ref_ce(h, w, jnp.asarray(labels), rec, mask=rm),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = chunked_ce_loss(th, tw, labels, pec, mask=mask)
    dh, dw = torch.autograd.grad(got, (th, tw))
    assert got.dtype == torch.float32
    assert _rel(got.item(), float(want)) <= 1e-5
    assert _rel(dh.numpy(), gh) <= 1e-5 and _rel(dw.numpy(), gw) <= 1e-5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [4, 12])
def test_chunked_ce_loss_at_bfloat16_logits_matches_reference(masked, chunk):
    """``logits_dtype="bfloat16"``: each chunk's logits rounded to bfloat16
    (the reference's ``preferred_element_type``), the reductions in
    float32.  The loss within 5e-7 of the reference's, relative (the
    sums' order); the gradients within 8e-3 of the largest, two units in
    the last place of bfloat16 (2 x 2^-8): both round each logit's
    cotangent to bfloat16, and a logit within rounding of a tie may round
    the other way."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) < 0.7).astype(np.float32) if masked else None
    rec = R.ExecConfig(loss_chunk=chunk, logits_dtype="bfloat16")
    pec = P.ExecConfig(loss_chunk=chunk, logits_dtype="bfloat16")
    rm = None if mask is None else jnp.asarray(mask)
    want, (gh, gw) = jax.value_and_grad(
        lambda h, w: ref_ce(h, w, jnp.asarray(labels), rec, mask=rm),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = chunked_ce_loss(th, tw, labels, pec, mask=mask)
    dh, dw = torch.autograd.grad(got, (th, tw))
    assert got.dtype == dh.dtype == dw.dtype == torch.float32
    assert _rel(got.item(), float(want)) <= 5e-7
    assert _rel(dh.numpy(), gh) <= 8e-3 and _rel(dw.numpy(), gw) <= 8e-3


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _cfgs(arch, **kw):
    """(reference, port) reduced float32 configs; MoE without drops."""
    out = []
    for get in (ref_get_config, get_config):
        cfg = dataclasses.replace(get(arch).reduced(), dtype="float32", **kw)
        if cfg.kind == "moe":
            cfg = dataclasses.replace(cfg, moe_capacity=float(cfg.moe_experts))
        out.append(cfg)
    return out


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.input_embed_dim:
        batch["embeds"] = rng.standard_normal(
            (B, S, cfg.input_embed_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.kind == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _ref_params(rcfg):
    params = R.init_params(jax.random.PRNGKey(0), rcfg)
    if rcfg.race_smooth_radius:
        params = dict(params, smooth_taps=jnp.asarray(
            [0.3, -0.2, 0.1, 0.05][:rcfg.race_smooth_radius + 1]))
    return params


def _model(pcfg, rcfg):
    return P.from_reference(pcfg, jax.tree.map(np.asarray, _ref_params(rcfg)),
                            device=CPU, trainable=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` on the reduced config: the loss within 1e-5,
    every gradient leaf (the reference's leaf order) within 1e-4 of its
    largest value, and the step's norm and learning rate."""
    rcfg, pcfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(rcfg, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(R.make_loss_fn(rcfg, R_EXEC)))(
        params, jb)
    model = _model(pcfg, rcfg)
    got = grads_of(P.make_loss_fn(pcfg, P_EXEC)(model, batch), model)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(leaves(got))
    for (path, want), g in zip(flat, leaves(got)):
        assert _rel(_np(g), want) <= 1e-4, jax.tree_util.keystr(path)
    # the reference's train step reports this loss, the norm of these
    # gradients and the schedule at step 1
    gnorm = ref_adamw.clip_by_global_norm(grads, 1.0)[1]
    lr = ref_adamw.cosine_schedule(1, 1e-3, 2, 10)
    popt = optim.AdamWConfig(lr=1e-3)
    step = P.make_train_step(pcfg, popt, P_EXEC, total_steps=10, warmup=2)
    _, opt, pm = step(model, optim.adamw_init(model, popt), batch)
    assert _rel(float(pm["loss"]), float(loss)) <= 1e-5
    assert _rel(float(pm["gnorm"]), float(gnorm)) <= 1e-5
    assert _rel(float(pm["lr"]), float(lr)) <= 1e-6
    assert int(opt["step"]) == 1


def test_train_step_refuses_a_frozen_model():
    rcfg, pcfg = _cfgs("qwen2_7b")
    model = P.init_params(pcfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    step = P.make_train_step(pcfg, optim.AdamWConfig(), P_EXEC)
    with pytest.raises(ValueError, match="trainable=True"):
        step(model, optim.adamw_init(model, optim.AdamWConfig()),
             _batch(rcfg, 0))


@pytest.fixture(scope="module")
def ref_trajectory():
    """The reference's five-step loss trajectory with the RACE mixer
    (radius 2, random taps) on its ``"xla"`` backend."""
    rcfg, _ = _cfgs("qwen2_7b", race_smooth_radius=2)
    params = _ref_params(rcfg)
    opt_cfg = ref_adamw.AdamWConfig(lr=1e-3)
    step = jax.jit(R.make_train_step(rcfg, opt_cfg, R_EXEC, total_steps=5,
                                     warmup=1))
    opt = ref_adamw.adamw_init(params, opt_cfg)
    losses = []
    for i in range(5):
        params, opt, m = step(params, opt, {
            k: jnp.asarray(v) for k, v in _batch(rcfg, 10 + i).items()})
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("backend", ["hopper", "torch"])
def test_mixer_trajectory_matches_reference(backend, ref_trajectory,
                                            monkeypatch):
    """Five train steps through ``race_smooth`` on each port backend (on the
    CPU ``"hopper"`` is K1's tile emulator, forward and every adjoint
    run): the losses within 1e-4 of the reference's."""
    monkeypatch.setenv("RACE_BACKEND", backend)
    executor_cache().clear()
    rcfg, pcfg = _cfgs("qwen2_7b", race_smooth_radius=2)
    model = _model(pcfg, rcfg)
    opt_cfg = optim.AdamWConfig(lr=1e-3)
    step = P.make_train_step(pcfg, opt_cfg, P_EXEC, total_steps=5, warmup=1)
    opt = optim.adamw_init(model, opt_cfg)
    losses = []
    for i in range(5):
        model, opt, m = step(model, opt, _batch(rcfg, 10 + i))
        losses.append(float(m["loss"]))
    assert _rel(losses, ref_trajectory) <= 1e-4, (losses, ref_trajectory)
    ran = {ex.backend for ex in executor_cache().executors()}
    assert ran == {backend}
    # the forward and the adjoints of sx and the three taps: on "hopper"
    # the taps run as one scalar group, on "torch" one by one
    assert len(executor_cache().executors()) >= (
        3 if backend == "hopper" else 5)


def test_remat_policies_give_equal_numbers():
    """``remat`` off, ``"nothing"`` and ``"dots"``: the same loss and
    gradients, bit for bit."""
    rcfg, pcfg = _cfgs("qwen2_7b", race_smooth_radius=2)
    model = _model(pcfg, rcfg)
    batch = _batch(rcfg, 3)
    out = []
    for knobs in ({"remat": False}, {"remat_policy": "nothing"},
                  {"remat_policy": "dots"}):
        ec = dataclasses.replace(P_EXEC, **knobs)
        loss = P.make_loss_fn(pcfg, ec)(model, batch)
        out.append((loss.detach(), [as_array(g) for g in
                                    leaves(grads_of(loss, model))]))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))
    with pytest.raises(ValueError, match="remat_policy"):
        P.make_loss_fn(pcfg, dataclasses.replace(
            P_EXEC, remat_policy="offload"))(model, batch)


def test_remat_recomputes_units_in_the_backward(monkeypatch):
    """Under ``"nothing"`` each unit's forward runs again in the backward
    pass; with ``remat=False`` once."""
    from repro_torch.models import model as model_mod

    rcfg, pcfg = _cfgs("qwen2_7b")
    m = _model(pcfg, rcfg)
    calls = []
    real = model_mod.apply_block
    monkeypatch.setattr(model_mod, "apply_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = _batch(rcfg, 4)
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        ec = dataclasses.replace(P_EXEC, remat=remat)
        grads_of(P.make_loss_fn(pcfg, ec)(m, batch), m)
        assert len(calls) == want * pcfg.num_layers
