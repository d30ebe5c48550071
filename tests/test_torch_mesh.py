"""The LM on a mesh (``repro_torch.models.spmd``) against the reference and
the port's single-device steps, on a 2x2 (``data``, ``model``) mesh of
``cpu`` devices.

Weights are drawn with numpy from a seed, in the reference's tree, and
reach the port through ``weights.from_reference``; configs are the
``reduced()`` ones at float32.  Tolerances:

* **losses 1e-5 relative.**  The mesh computes the same sums in another
  order: the members' partial products are added after the matmuls, the
  vocab's log-sum-exp is merged from the members' and the rows' sums are
  added last.  Each reordering costs float32 rounding (6e-8 relative) over
  a loss a few hundred sequential operations deep.
* **parameters after two AdamW steps: 2e-4 of each leaf's largest
  magnitude** (``testing/differential.py``'s float32 ``grad`` row).  The
  steps take AdamW's ``eps`` at 0.1, lr 1e-2: AdamW divides each moment by
  its root mean square plus ``eps``, and with the default 1e-8 an element
  whose gradient lies within rounding noise of zero moves by up to lr in
  either direction in either package (``bk``'s exact gradient is zero:
  softmax is invariant to a shift of every score of a query).  With
  ``eps`` above the gradients' noise the update is a smooth function of
  the gradient, so the parameters agree to the gradients' relative error
  times lr, while a wrong update (up to lr / 2 an element) stays 25 times
  the bound.
* **decode against prefill 1e-3 of the largest logit**, as phase 15's
  lm:parity holds them; prefill on the mesh against one device 1e-5.  With
  the int8 KV cache the dequantized cache is bfloat16 and the attention's
  probabilities are rounded to bfloat16 before the value product: after
  normalizing on one device, before merging the members' sums on the mesh,
  so the two decodes agree to bfloat16's rounding: 3e-2 of the largest
  logit, phase 15's bfloat16 gate.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.optim import adamw as ref_adamw

import repro_torch.models as P
from repro_torch import obs, optim
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.mesh import AbstractMeshError, make_mesh
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_block
from repro_torch.models.sharding import gather
from repro_torch.models.ssm import mamba_block, rglru_block
from repro_torch.tree import as_array, leaves

pytestmark = pytest.mark.port

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"
B, S = 4, 16
LR, EPS, STEPS = 1e-2, 0.1, 2
EXEC = dict(attn_chunk_q=8, attn_chunk_k=8, ssm_chunk=8, loss_chunk=8)


def _mesh():
    return make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)


def _cfgs(arch, **kw):
    return [dataclasses.replace(get(arch).reduced(), dtype="float32", **kw)
            for get in (ref_get_config, get_config)]


def _numpy_init(rcfg, seed: int = 0) -> dict:
    """The reference's parameter tree (its structure from
    ``jax.eval_shape``) with every leaf drawn by numpy: matrices
    N(0, 1/fan_in), the SSM's constants near their initial values, the
    rest N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda k: R.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    base = {"A_log": None, "dt_bias": -4.0, "D_skip": 1.0, "lambda_p": 2.0}

    def leaf(path, sds):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(sds.shape)
        noise = rng.standard_normal(shape)
        if name == "A_log":
            a = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * noise
        elif name in base:
            a = base[name] + 0.1 * noise
        elif len(shape) - (1 if path[0].key == "units" else 0) >= 2:
            a = noise / np.sqrt(shape[-2])
        else:
            a = 0.1 * noise
        return np.asarray(a, dtype=np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batches(cfg, n, seed=0):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        b = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        out.append(b)
    return out


def _ref_steps(rcfg, params, batches, exec_kw=EXEC):
    opt = ref_adamw.AdamWConfig(lr=LR, eps=EPS)
    step = jax.jit(R.make_train_step(rcfg, opt, R.ExecConfig(**exec_kw),
                                     total_steps=10, warmup=2))
    p = jax.tree.map(jnp.asarray, params)
    state = ref_adamw.adamw_init(p, opt)
    losses = []
    for b in batches:
        p, state, m = step(p, state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, p)


def _port_steps(pcfg, params, batches, mesh=None, opt_cfg=None):
    """The port's losses and final parameters (the reference's tree of
    numpy arrays), on one device or on ``mesh``."""
    opt_cfg = opt_cfg or optim.AdamWConfig(lr=LR, eps=EPS)
    model = P.from_reference(pcfg, params, device=CPU, trainable=True)
    ec = P.ExecConfig(mesh=mesh, **EXEC)
    step = P.make_train_step(pcfg, opt_cfg, ec, total_steps=10, warmup=2)
    if mesh is None:
        state = optim.adamw_init(model, opt_cfg)
    else:
        model = spmd.place_model(model, mesh)
        state = spmd.adamw_init(model, opt_cfg)
    losses = []
    for b in batches:
        model, state, m = step(model, state, b)
        losses.append(float(m["loss"]))
    tree = model.gathered() if mesh is not None else model.param_tree()
    flat = [as_array(t).detach().numpy() for t in leaves(tree)]
    return losses, flat, model, state


def _check(losses, flat, want_losses, want_params):
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
        want_params)[0]]
    want = jax.tree.leaves(want_params)
    assert len(flat) == len(want)
    for path, got, w in zip(paths, flat, want):
        err = np.abs(got.astype(np.float64) - w).max()
        bound = 2e-4 * np.abs(w).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


#: arch, config overrides, mesh-vs-one-device overrides (MoE with drops:
#: the reference drops differently, ROADMAP F8, so it is held there at
#: capacity E and against the port's own step with drops)
CASES = {
    "qwen2_7b": ({"race_smooth_radius": 2}, {}),
    "deepseek_moe_16b": ({"moe_capacity": 8.0}, {"moe_capacity": 0.5}),
    "falcon_mamba_7b": ({}, {}),
    "recurrentgemma_9b": ({}, {}),
}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_mesh_train_steps_match_the_reference_and_one_device(arch,
                                                             monkeypatch):
    """Two train steps on the 2x2 mesh: losses and parameters against the
    reference's single-device ``make_train_step`` and against the port's
    single-device step (the mixer on ``"hopper"``: K1's emulator)."""
    kw, drop_kw = CASES[arch]
    rcfg, pcfg = _cfgs(arch, **kw)
    params = _numpy_init(rcfg)
    batches = _batches(pcfg, STEPS)
    want_losses, want_params = _ref_steps(rcfg, params, batches)
    monkeypatch.setenv("RACE_BACKEND", "hopper")  # the port's name
    losses, flat, _, _ = _port_steps(pcfg, params, batches, _mesh())
    _check(losses, flat, want_losses, want_params)
    # against the port's own single-device step (with drops for MoE)
    pcfg = dataclasses.replace(pcfg, **drop_kw)
    one = _port_steps(pcfg, params, batches)
    mesh = _port_steps(pcfg, params, batches, _mesh())
    ref_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(want_params), one[1])
    _check(mesh[0], mesh[1], one[0], ref_tree)


def test_mesh_factored_adamw_matches_one_device():
    """grok-1's optimizer (factored second moment, bf16 first moment) on
    the mesh: the row and column means summed over the members holding the
    other slices give the single-device step's parameters."""
    rcfg, pcfg = _cfgs("grok_1_314b", moe_capacity=8.0)
    params = _numpy_init(rcfg)
    batches = _batches(pcfg, STEPS)
    opt = optim.AdamWConfig(lr=LR, eps=EPS, factored=True,
                            m_dtype="bfloat16")
    one = _port_steps(pcfg, params, batches, opt_cfg=opt)
    mesh = _port_steps(pcfg, params, batches, _mesh(), opt_cfg=opt)
    np.testing.assert_allclose(mesh[0], one[0], rtol=1e-5)
    for got, w in zip(mesh[1], one[1]):
        assert np.abs(got - w).max() <= 2e-4 * np.abs(w).max()
    st = mesh[3]
    assert any("vr" in mu for mu in st["mu"])


REF_MESH = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, pickle
import numpy as np
import jax, jax.numpy as jnp
from repro import models as R
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.optim import adamw as A

inp = pickle.load(open(sys.argv[1], "rb"))
cfg = dataclasses.replace(get_config(inp["arch"]).reduced(), **inp["cfg"])
mesh = make_mesh((2, 2), ("data", "model"))
ec = R.ExecConfig(mesh=mesh, **inp["exec"])
opt = A.AdamWConfig(lr=inp["lr"], eps=inp["eps"])
params = jax.tree.map(jnp.asarray, inp["params"])
state = A.adamw_init(params, opt)
step = jax.jit(R.make_train_step(cfg, opt, ec, total_steps=10, warmup=2))
losses = []
for b in inp["batches"]:
    params, state, m = step(params, state,
                            {k: jnp.asarray(v) for k, v in b.items()})
    losses.append(float(m["loss"]))
pickle.dump({"losses": losses, "params": jax.tree.map(np.asarray, params)},
            open(sys.argv[2], "wb"))
print("OK")
"""


#: the archs held against the reference's own 2x2 step, with their config
#: overrides (MoE at capacity E, ``CASES``' setting: the reference's drops
#: differ, ROADMAP F8)
REF_MESH_CASES = {
    "qwen2_7b": {"race_smooth_radius": 2},
    "deepseek_moe_16b": {"moe_capacity": 8.0},
    "falcon_mamba_7b": {},
    "recurrentgemma_9b": {},
}


@pytest.mark.parametrize("arch", sorted(REF_MESH_CASES))
def test_mesh_train_steps_match_the_reference_mesh_step(arch, tmp_path):
    """The reference's own ``jax.jit(make_train_step(..., ExecConfig(mesh=
    2x2)))`` over four forced host devices, in a subprocess: the port's
    mesh steps (MoE, Mamba and RG-LRU split the reference's way) give its
    losses and parameters."""
    kw = REF_MESH_CASES[arch]
    rcfg, pcfg = _cfgs(arch, **kw)
    params = _numpy_init(rcfg)
    batches = _batches(pcfg, STEPS)
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
    losses, flat, _, _ = _port_steps(pcfg, params, batches, _mesh())
    _check(losses, flat, want["losses"], want["params"])


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _frozen(arch, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    model = P.from_reference(pcfg, _numpy_init(rcfg), device=CPU)
    return pcfg, model, spmd.place_model(model, _mesh())


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen2_7b", False), ("qwen2_7b", True), ("deepseek_moe_16b", False),
    ("falcon_mamba_7b", False), ("recurrentgemma_9b", False)])
def test_mesh_prefill_and_decode(arch, kv_quant):
    """Prefill on the mesh against one device (1e-5); teacher-forced decode
    on the mesh against the mesh's prefill (1e-3 of the largest logit) and
    its caches, gathered, against the single-device decode's.  MoE runs at
    capacity E: a prefill's tokens can overflow an expert, a decode step's
    cannot (``tests/test_arch_smoke.py``'s condition)."""
    cfg, model, mp = _frozen(arch, **({"moe_capacity": 8.0}
                                      if "moe" in arch else {}))
    ec = P.ExecConfig(kv_quant=kv_quant, **EXEC)
    ecm = dataclasses.replace(ec, mesh=_mesh())
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S))
    want = P.make_prefill_step(cfg, ec)(model, {"tokens": tokens})
    got = P.make_prefill_step(cfg, ecm)(mp, {"tokens": tokens})
    assert got.shape == (B, cfg.vocab) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    caches = spmd.init_caches(mp, B, S, kv_quant=kv_quant)
    c1 = P.init_caches(cfg, B, S, kv_quant=kv_quant, device=CPU)
    dec = P.make_decode_step(cfg, ecm, max_len=S)
    dec1 = P.make_decode_step(cfg, ec, max_len=S)
    for t in range(S):
        logits, caches = dec(mp, caches, tokens[:, t:t + 1], t)
        one, c1 = dec1(model, c1, tokens[:, t:t + 1], t)
    if kv_quant:  # a quantized cache: not the prefill (module docstring)
        assert float((logits - one).abs().max()) <= 3e-2 * scale
    else:
        assert float((logits - got).abs().max()) <= 1e-3 * scale
        assert float((logits - one).abs().max()) <= 1e-3 * scale
    back = spmd.gather_caches(caches)
    tol = 3e-2 if kv_quant else 1e-4  # the logits' tolerance
    for part in ("prelude", "units", "trailing"):
        for a, b in zip(c1[part], back[part], strict=True):
            for k in a:
                assert a[k].dtype == b[k].dtype
                d = (a[k].float() - b[k].float()).abs().max()
                if a[k].dtype == torch.int8:  # 127 steps to the largest
                    assert d <= max(1, round(tol * 127))
                else:
                    assert d <= tol * max(1.0, float(a[k].abs().max()))


def test_mesh_prefill_cross_attention():
    """The vlm's cross-attention layers on the mesh (prefill; the
    reference's vlm has no decode test either)."""
    cfg, model, mp = _frozen("llama_3_2_vision_90b")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "vision": rng.standard_normal(
                 (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)}
    ec = P.ExecConfig(**EXEC)
    want = P.make_prefill_step(cfg, ec)(model, batch)
    got = P.make_prefill_step(cfg, dataclasses.replace(ec, mesh=_mesh()))(
        mp, batch)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------------------
# placement, checkpoints, K1 and the log
# ---------------------------------------------------------------------------


def test_shards_live_on_their_positions_and_copies_stay_equal():
    """Every shard (parameters and AdamW state) on its position's device
    (four distinct CPU device objects are one device, so the check is the
    mesh's own map); the replicated copies bit-equal after two steps."""
    rcfg, pcfg = _cfgs("qwen2_7b")
    params = _numpy_init(rcfg)
    _, _, mp, state = _port_steps(pcfg, params, _batches(pcfg, STEPS),
                                  _mesh())
    mesh = mp.mesh
    for name, pl in mp.placed.items():
        for coords in mp.layout.positions:
            assert pl.shards[coords].device == mesh.devices[coords]
        for _, holders in mp.blocks[name]:
            first = pl.shards[holders[0]]
            for h in holders[1:]:
                assert torch.equal(pl.shards[h], first), name
    for pl in leaves(state):
        for coords in mp.layout.positions:
            assert pl.shards[coords].device == mesh.devices[coords]
    ln = mp.placed["units.0.ln1"]  # replicated: four copies
    assert len(mp.blocks["units.0.ln1"][0][1]) == 4
    assert not torch.equal(ln.shards[0, 0].detach(),
                           torch.zeros_like(ln.shards[0, 0]))


def test_mesh_checkpoint_round_trip_and_resume(tmp_path):
    """``launch.train --mesh 2x2 --devices cpu,cpu,cpu,cpu``: 4 straight
    steps against 2, a restart from the checkpoint (gathered bit for bit,
    placed back by the shardings) and 2 more: parameters and AdamW state
    bit-equal."""
    argv = ["--arch", "qwen2_7b", "--reduced", "--mesh", "2x2", "--devices",
            "cpu,cpu,cpu,cpu", "--batch", "4", "--seq", "16", "--ckpt-every",
            "2"]

    def run(stop, d):
        args = train.parser().parse_args(argv + ["--steps", "4",
                                                 "--ckpt-dir", str(d)])
        _, tr = train.setup(args)
        tr.cfg.log_fn = lambda *a: None
        tr.cfg.total_steps = stop  # the schedule stays the 4-step one
        return tr, tr.run()

    a, out_a = run(4, tmp_path / "a")
    run(2, tmp_path / "b")
    b, out_b = run(4, tmp_path / "b")
    assert out_b["losses"] == out_a["losses"][2:]
    ga, gb = a.params.gathered(), b.params.gathered()
    for x, y in zip(leaves(ga), leaves(gb)):
        assert torch.equal(x, y)
    for x, y in zip(leaves(a.opt_state), leaves(b.opt_state)):
        assert torch.equal(gather(x), gather(y))
    # the final checkpoint holds the gathered state, bit for bit
    from repro_torch.checkpoint import restore_checkpoint

    like = b._state()
    state, step = restore_checkpoint(tmp_path / "b", like)
    assert step == 4
    for x, y in zip(leaves(state), leaves(like), strict=True):
        assert torch.equal(x, y)


def test_k1_runs_on_every_position_each_step(monkeypatch):
    """With the mixer on ``"hopper"`` (K1's emulator here), one mesh step
    runs the mixer once on each of the four positions (an ``spmd_mixer``
    span per position in ``repro_torch.obs``) and every executor run is on
    ``"hopper"``: the forward plan and each adjoint run (``sx``'s, and
    ``sw0..sw2`` as one scalar group) four times, once per position."""
    monkeypatch.setenv("RACE_BACKEND", "hopper")
    obs.configure(enabled=True)
    try:
        obs.reset()
        obs.configure(enabled=True)
        rcfg, pcfg = _cfgs("qwen2_7b", race_smooth_radius=2)
        _port_steps(pcfg, _numpy_init(rcfg), _batches(pcfg, 1), _mesh())
        spans = [r for r in obs.span_records() if r["name"] == "spmd_mixer"]
        assert sorted(r["labels"]["position"] for r in spans) == [
            "0,0", "0,1", "1,0", "1,1"]
        runs = {k: v for k, v in obs.snapshot()["counters"].items()
                if k.startswith("race_executor_runs_total")}
        assert runs and all("backend=hopper" in k for k in runs)
        assert sorted(runs.values()) == [4.0] * 3
    finally:
        obs.reset()


def _tiny() -> ModelConfig:
    return ModelConfig(name="tiny", kind="dense", num_layers=1, d_model=16,
                       n_heads=2, n_kv_heads=2, d_head=8, d_ff=32, vocab=64,
                       dtype="float32")


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_transfer_log_matches_a_hand_count(seq_parallel):
    """A one-layer dense model (d_model 16, 2 heads of 8, d_ff 32, vocab
    64, float32) prefilled on the 2x2 mesh, batch 2 x 4 (one example a
    row).  Per position: the embedding's vocab rows gathered over ``data``
    (32 x 16 x 4 B), its lookups summed over ``model`` (1 x 4 x 16 x 4 B);
    a member's head's columns of ``wq``, ``wk``, ``wv`` and rows of ``wo``
    (16 x 8 x 4 B each), the attention's sum; its ``d_ff`` half of
    ``w_gate``, ``w_up``, ``w_down`` (16 x 16 x 4 B each), the MLP's sum;
    the head's vocab half (16 x 32 x 4 B); the last logits gathered over
    ``model`` (1 x 64 x 4 B) and over ``data`` (2 x 64 x 4 B).  Every group
    has two positions; norms are replicated and read in place.

    With ``seq_parallel`` the three sums are reduce-scatters along S
    (logged at the whole summed tensor, 1 x 4 x 16 x 4 B), each block's
    normed tokens are all-gathered along S (1 x 4 x 16 x 4 B, twice in
    the unit) and the last token is gathered from the members (1 x 2 x
    16 x 4 B): no all-reduce is left."""
    cfg = _tiny()
    model = P.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    mp = spmd.place_model(model, _mesh())
    tokens = np.arange(8).reshape(2, 4)
    P.make_prefill_step(cfg, P.ExecConfig(mesh=mp.mesh,
                                          seq_parallel=seq_parallel))(
        mp, {"tokens": tokens})
    log = mp.last_log
    gathers = [32 * 16 * 4] + [16 * 8 * 4] * 4 + [16 * 16 * 4] * 3 + [
        16 * 32 * 4, 64 * 4, 2 * 64 * 4]
    sums = [4 * 16 * 4] * 3
    if seq_parallel:
        gathers += [4 * 16 * 4] * 2 + [2 * 16 * 4]
        want = {"all-gather": gathers, "reduce-scatter": sums}
    else:
        want = {"all-gather": gathers, "all-reduce": sums}
    for kind, nbytes in want.items():
        assert sorted(e.nbytes for e in log.entries
                      if e.kind == kind) == sorted(nbytes * 4)
    assert {e.group for e in log.entries} == {2}
    assert {e.phase for e in log.entries} == {"forward"}
    per_unit = [e for e in log.entries if e.unit == 0]
    # wq wk wv wo, attn sum, 3 MLP, MLP sum (and the two normed gathers)
    assert len(per_unit) == 4 * (11 if seq_parallel else 9)
    assert log.bytes_by_kind() == {k: 4 * sum(v) for k, v in want.items()}


class _Fetches:
    """Every ``Collectives.fetch`` of a step: (parameter name, position,
    the region's shape), and the cache leaves fetched."""

    def __init__(self, monkeypatch, mp, caches=None):
        self.names = {id(pl): n for n, pl in mp.placed.items()}
        self.cache_ids = {id(pl) for pl in leaves(caches or {})}
        self.got, self.cache_fetches = [], 0
        inner = spmd.Collectives.fetch

        def fetch(coll, placed, blocks, region, at):
            if id(placed) in self.cache_ids:
                self.cache_fetches += 1
            self.got.append((self.names.get(id(placed)), at,
                             tuple(hi - lo for lo, hi in region),
                             tuple(region)))
            return inner(coll, placed, blocks, region, at)

        monkeypatch.setattr(spmd.Collectives, "fetch", fetch)

    def shapes(self, suffix, at) -> list:
        return [sh for n, a, sh, _ in self.got
                if n and n.endswith(suffix) and a == at]


POSITIONS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _block_on_the_mesh(cfg, kind, run, monkeypatch, seq_parallel=False):
    """One ``kind`` block of a one-layer ``cfg`` (float32, weights from a
    seed) on the 2x2 mesh, batch 2 x 4 (one example a row): ``run(st, h)``
    calls the step's block method on the rows' whole sequences, as a
    block gives them to it; with ``seq_parallel`` (where ``seq_layout``
    holds for ``cfg``) the stream is sequence-split, so each member's
    output is its tokens' part.  Returns (the log, the fetches)."""
    model = P.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    with torch.no_grad():  # the unit-scale norms and SSM constants stay
        for n, t in model.named_parameters():
            if t.dim() >= 2:
                t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                    .manual_seed(len(n))) / t.shape[-2] ** .5)
    mp = spmd.place_model(model, _mesh())
    fetches = _Fetches(monkeypatch, mp)
    x = np.random.default_rng(0).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32)
    ec = P.ExecConfig(mesh=mp.mesh, seq_parallel=seq_parallel, **EXEC)
    st = spmd.Step(mp, ec)
    st.seq = spmd.seq_layout(cfg, ec, 2, x.shape[1])
    with torch.no_grad():
        got = run(st, st.rows(x))
        blk = model.units[0]
        xt = torch.as_tensor(x)
        if kind == "moe":
            want = moe_block(xt, blk.moe, cfg, exec_cfg=ec)
        elif kind == "mamba":
            want = mamba_block(xt, blk.mamba, cfg, ec)
        else:
            want = rglru_block(xt, blk.rglru, cfg, ec)
    for p, y in got.items():
        w = want[p[0]:p[0] + 1]
        if st.seq:
            w = w[:, 2 * p[1]:2 * p[1] + 2]
        np.testing.assert_allclose(y.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    return st.log, fetches


def _log_per_position(log, kind) -> list:
    return sorted(e.nbytes for e in log.entries if e.kind == kind)


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_moe_block_transfer_log_matches_a_hand_count(seq_parallel,
                                                     monkeypatch):
    """One MoE block (d_model 16, 4 experts top-2, expert ``d_ff`` 8, one
    shared expert of 8, float32; T = 8 tokens, capacity 1.0: C = 8) on the
    2x2 mesh.  Per position: every row's tokens gathered over ``data``
    (2 x 4 x 16 x 4 B); the router gathered whole over ``data`` (16 x 4 x
    4 B); its member's F / M = 4 columns of ``w_gate`` and ``w_up`` and
    rows of ``w_down``, each (E, D, F / M) = (4, 16, 4) with D gathered
    over ``data`` (1,024 B each); the experts' partial outputs at its row's
    C / R = 4 slots summed over ``model`` (4 x 4 x 16 x 4 B), the rows'
    slots gathered over ``data`` (4 x 8 x 16 x 4 B); the shared expert
    split as the MLP is (three 16 x 4 x 4 B fetches, its 4 x 16 x 4 B
    sum).  No position fetches a whole expert weight.  With
    ``seq_parallel`` the shared expert's sum is a reduce-scatter along S
    (each member combines its own tokens); the experts' sum stays an
    all-reduce."""
    cfg = ModelConfig(name="tiny-moe", kind="moe", num_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=2, d_head=8, d_ff=8, vocab=64,
                      moe_experts=4, moe_top_k=2, moe_shared=1,
                      moe_capacity=1.0, dtype="float32")
    log, f = _block_on_the_mesh(
        cfg, "moe", lambda st, h: st.moe("units.0.moe", h), monkeypatch,
        seq_parallel)
    gathers = [2 * 4 * 16 * 4, 16 * 4 * 4] + [4 * 16 * 4 * 4] * 3 + [
        4 * 8 * 16 * 4] + [16 * 4 * 4] * 3
    sums = [4 * 4 * 16 * 4, 4 * 16 * 4]
    scattered = [sums.pop()] if seq_parallel else []
    assert _log_per_position(log, "all-gather") == sorted(gathers * 4)
    assert _log_per_position(log, "all-reduce") == sorted(sums * 4)
    assert _log_per_position(log, "reduce-scatter") == sorted(scattered * 4)
    assert {e.group for e in log.entries} == {2}
    for p in POSITIONS:
        for w in ("moe.w_gate", "moe.w_up"):
            assert f.shapes(w, p) == [(4, 16, 4)]
        assert f.shapes("moe.w_down", p) == [(4, 4, 16)]
    regions = {(a, n): r for n, a, _, r in f.got if n.endswith("moe.w_gate")}
    assert regions[((0, 1), "units.0.moe.w_gate")][-1] == (4, 8)


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_mamba_block_transfer_log_matches_a_hand_count(seq_parallel,
                                                       monkeypatch):
    """One Mamba block (d_model 16, d_inner 32, state 4, dt_rank 1, conv 4,
    float32) on the 2x2 mesh, batch 2 x 4.  Member m computes channels
    [16 m, 16 m + 16).  Its two ``in_proj`` regions (16 x 16 each, one in
    the x half, one in the z half: at ``model`` = 2 the reference's
    column blocks are the two halves, so one of them lies in the other
    member's block) are gathered (1,024 B each), as are its ``out_proj``
    rows (16 x 16, d_model over ``data``: 1,024 B).  ``conv_w``, ``A_log``,
    ``dt_bias`` and ``D_skip`` are its own blocks (``model``); ``dt_proj``
    (1, 32) splits its columns over ``data`` and ``x_proj`` (32, 9) its
    rows (9 does not split over ``model``), so the positions whose
    channels lie in the other row's block fetch them: (0, 1) and (1, 0)
    fetch 1 x 16 x 4 and 16 x 9 x 4 B.  Summed over ``model``: ``x_proj``'s
    product (1 x 4 x 9 x 4 B) and ``out_proj``'s (1 x 4 x 16 x 4 B).
    ``seq_parallel`` changes nothing: time is the recurrence's axis, so
    ``seq_layout`` keeps the ``ssm`` family's stream whole."""
    cfg = ModelConfig(name="tiny-mamba", kind="ssm", num_layers=1,
                      d_model=16, n_heads=1, n_kv_heads=1, d_head=16,
                      d_ff=0, vocab=64, ssm_state=4, dtype="float32")
    log, f = _block_on_the_mesh(
        cfg, "mamba", lambda st, h: st.mamba("units.0.mamba", h),
        monkeypatch, seq_parallel)
    gathers = [16 * 16 * 4] * 3 * 4 + [1 * 16 * 4, 16 * 9 * 4] * 2
    sums = [4 * 9 * 4, 4 * 16 * 4] * 4
    assert _log_per_position(log, "all-gather") == sorted(gathers)
    assert _log_per_position(log, "all-reduce") == sorted(sums)
    for p in POSITIONS:
        assert f.shapes("mamba.in_proj", p) == [(16, 16), (16, 16)]
        m = p[1]
        ins = [r for n, a, _, r in f.got if a == p
               and n.endswith("mamba.in_proj")]
        assert [r[1] for r in ins] == [(16 * m, 16 * m + 16),
                                      (32 + 16 * m, 32 + 16 * m + 16)]
        for name, shape in (("conv_w", (4, 16)), ("x_proj", (16, 9)),
                            ("dt_proj", (1, 16)), ("A_log", (16, 4)),
                            ("D_skip", (16,)), ("out_proj", (16, 16))):
            assert f.shapes(f"mamba.{name}", p) == [shape], name


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_rglru_block_transfer_log_matches_a_hand_count(seq_parallel,
                                                       monkeypatch):
    """One RG-LRU block (d_model 16, width W 16, conv 4, float32) on the
    2x2 mesh, batch 2 x 4.  Member m computes channels [8 m, 8 m + 8): its
    two ``in_proj`` regions (16 x 8, one per half), its columns of
    ``w_input_gate`` and ``w_rec_gate`` (16 x 8, W over ``data``) and its
    ``out_proj`` rows (8 x 16) are gathered (512 B each); the conv's output
    is all-gathered over ``model`` (1 x 4 x 16 x 4 B, once for both
    gates), ``out_proj``'s product summed (1 x 4 x 16 x 4 B).  The same
    with ``seq_parallel``: the ``hybrid`` family keeps its stream whole."""
    cfg = ModelConfig(name="tiny-rglru", kind="hybrid", num_layers=1,
                      d_model=16, n_heads=2, n_kv_heads=1, d_head=8,
                      d_ff=32, vocab=64, pattern=("rglru",), window=16,
                      lru_width=16, dtype="float32")
    log, f = _block_on_the_mesh(
        cfg, "rglru", lambda st, h: st.rglru("units.0.rglru", h),
        monkeypatch, seq_parallel)
    gathers = [16 * 8 * 4] * 5 + [4 * 16 * 4]
    sums = [4 * 16 * 4]
    assert _log_per_position(log, "all-gather") == sorted(gathers * 4)
    assert _log_per_position(log, "all-reduce") == sorted(sums * 4)
    for p in POSITIONS:
        assert f.shapes("rglru.in_proj", p) == [(16, 8), (16, 8)]
        for name, shape in (("w_input_gate", (16, 8)),
                            ("w_rec_gate", (16, 8)), ("conv_w", (4, 8)),
                            ("lambda_p", (8,)), ("out_proj", (8, 16))):
            assert f.shapes(f"rglru.{name}", p) == [shape], name


@pytest.mark.parametrize("arch", ["qwen2_7b", "falcon_mamba_7b",
                                  "recurrentgemma_9b"])
def test_decode_members_project_only_their_heads_and_states(arch,
                                                            monkeypatch):
    """Four mesh decode steps: every ``wq`` / ``wk`` / ``wv`` fetch is its
    member's run of columns (``_head_split``'s: qwen2's reduced config has
    one KV group, so both members project that group's k and v and each
    its two query heads), every ``wo`` fetch its rows; no position fetches
    a cache leaf (the recurrent states are read and written in each
    member's shard), and the gathered caches equal the single device's."""
    cfg, model, mp = _frozen(arch)
    caches = spmd.init_caches(mp, B, S)
    f = _Fetches(monkeypatch, mp, caches)
    ec = P.ExecConfig(**EXEC)
    dec = P.make_decode_step(cfg, dataclasses.replace(ec, mesh=mp.mesh),
                             max_len=S)
    dec1 = P.make_decode_step(cfg, ec, max_len=S)
    c1 = P.init_caches(cfg, B, S, device=CPU)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, 4))
    for t in range(4):
        got, caches = dec(mp, caches, tokens[:, t:t + 1], t)
        want, c1 = dec1(model, c1, tokens[:, t:t + 1], t)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    assert f.cache_fetches == 0
    H, dh = cfg.n_heads, cfg.d_head
    seen = 0
    for n, at, _, region in f.got:
        if n and n.rsplit(".", 1)[-1] in ("wq", "wo"):
            kv0, kv1, g0, g1 = spmd._head_split(cfg, 2, at[1])
            G = H // cfg.n_kv_heads
            run = ((kv0 * G + g0) * dh, ((kv1 - 1) * G + g1) * dh)
            dim = -1 if n.endswith("wq") else 0
            assert region[dim] == run and run[1] - run[0] == H * dh // 2
            seen += 1
    n_attn = sum(k == "attn" for _, k in spmd._layer_kinds(
        cfg, mp._n_units()))
    assert seen == 2 * len(POSITIONS) * 4 * n_attn  # wq, wo; 4 steps
    back = spmd.gather_caches(caches)
    for part in ("prelude", "units", "trailing"):
        for a, b in zip(c1[part], back[part], strict=True):
            for k in a:
                d = (a[k].float() - b[k].float()).abs().max()
                assert d <= 1e-4 * max(1.0, float(a[k].abs().max())), k


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_the_backward_logs_the_gradients_collectives(seq_parallel):
    """A train step's log holds the forward's gathers and sums and, in the
    backward, a reduce-scatter per gather and an all-reduce per sum; remat
    gathers each unit's weights a second time (with ``seq_parallel`` also
    the two blocks' normed tokens, and an all-gather answers each
    reduce-scatter of a sum)."""
    cfg = _tiny()
    model = P.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU, trainable=True)
    mp = spmd.place_model(model, _mesh())
    ec = P.ExecConfig(mesh=mp.mesh, seq_parallel=seq_parallel, **EXEC)
    step = P.make_train_step(cfg, optim.AdamWConfig(), ec)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (2, 4)),
             "labels": rng.integers(0, 64, (2, 4))}
    step(mp, spmd.adamw_init(mp, optim.AdamWConfig()), batch)
    log = mp.last_log
    fwd = [e for e in log.entries if e.phase == "forward" and e.unit == 0
           and e.kind == "all-gather"]
    bwd = [e for e in log.entries if e.phase == "backward" and e.unit == 0
           and e.kind == "reduce-scatter"]
    # the forward and remat's re-gather
    assert len(fwd) == 2 * 4 * (9 if seq_parallel else 7)
    assert sorted(e.nbytes for e in bwd) == sorted(
        e.nbytes for e in fwd[:len(fwd) // 2])
    sums = [e for e in log.entries if e.unit == 0 and e.phase == "forward"
            and e.kind == ("reduce-scatter" if seq_parallel
                           else "all-reduce")]
    back = [e for e in log.entries if e.unit == 0 and e.phase == "backward"
            and e.kind == ("all-gather" if seq_parallel else "all-reduce")]
    # two sums a unit, the MLP's not recomputed (remat stops once its saved
    # tensors are back)
    assert (len(sums), len(back)) == (4 * 3, 4 * 2)


def test_launch_train_on_a_mesh_of_cpu_devices(capsys, tmp_path):
    import json

    train.main(["--arch", "qwen2_7b", "--reduced", "--mesh", "2x2",
                "--devices", "cpu,cpu,cpu,cpu", "--steps", "3", "--batch",
                "4", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])


def test_abstract_meshes_and_missing_cards_are_refused():
    """An abstract mesh (no devices) is refused by ``ExecConfig`` and by
    the placement; ``--mesh`` without that many cards raises rather than
    falling back to one device; ``--devices`` alone is refused."""
    abstract = make_mesh((2, 2), ("data", "model"))
    assert abstract.abstract  # no card here
    with pytest.raises(AbstractMeshError, match="abstract"):
        P.ExecConfig(mesh=abstract)
    cfg = _tiny()
    model = P.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    with pytest.raises(spmd.MeshError, match="abstract"):
        spmd.place_model(model, abstract)
    args = train.parser().parse_args(["--arch", "qwen2_7b", "--reduced",
                                      "--mesh", "2x2"])
    with pytest.raises(AbstractMeshError, match="CUDA cards"):
        train.setup(args)
    args = train.parser().parse_args(["--arch", "qwen2_7b", "--devices",
                                      "cpu"])
    with pytest.raises(ValueError, match="--mesh"):
        train.setup(args)


def test_a_batch_that_does_not_split_over_the_rows_is_replicated():
    """Batch 3 on two rows: ``batch_shardings`` leaves it replicated, so
    every row runs all of it; prefill and the train step's loss are the
    single device's, the loss counted once."""
    rcfg, pcfg = _cfgs("qwen2_7b")
    params = _numpy_init(rcfg)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, pcfg.vocab, (3, S)),
             "labels": rng.integers(0, pcfg.vocab, (3, S))}
    model = P.from_reference(pcfg, params, device=CPU, trainable=True)
    mp = spmd.place_model(model, _mesh())
    ec = P.ExecConfig(**EXEC)
    ecm = dataclasses.replace(ec, mesh=mp.mesh)
    with torch.no_grad():
        want = P.make_prefill_step(pcfg, ec)(model, batch)
        got = P.make_prefill_step(pcfg, ecm)(mp, batch)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    opt = optim.AdamWConfig(lr=LR, eps=EPS)
    _, _, m1 = P.make_train_step(pcfg, opt, ec)(
        model, optim.adamw_init(model, opt), batch)
    _, _, m2 = P.make_train_step(pcfg, opt, ecm)(
        mp, spmd.adamw_init(mp, opt), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["gnorm"]), float(m1["gnorm"]),
                               rtol=1e-5)


@pytest.mark.parametrize("M,want", [
    (2, [(0, 1, 0, 4), (0, 1, 4, 8)]),  # one KV group split in two
    (4, [(0, 1, 0, 2), (0, 1, 2, 4), (0, 1, 4, 6), (0, 1, 6, 8)]),
])
def test_head_split_within_one_kv_group(M, want):
    cfg = dataclasses.replace(_tiny(), n_heads=8, n_kv_heads=1)
    assert [spmd._head_split(cfg, M, m) for m in range(M)] == want


def test_head_split_of_qwen2_7b():
    """qwen2-7b (28 heads, 4 KV groups of 7): two KV groups a member at
    model=2; at model=8 each group splits 4 + 3 over two members; at
    model=3 the groups do not split and the attention is replicated."""
    cfg = get_config("qwen2_7b")
    assert [spmd._head_split(cfg, 2, m) for m in range(2)] == [
        (0, 2, 0, 7), (2, 4, 0, 7)]
    assert spmd._head_split(cfg, 8, 1) == (0, 1, 4, 7)
    assert spmd._head_split(cfg, 3, 0) == (0, 2, 0, 7)
    assert spmd._head_split(cfg, 6, 0) is None
