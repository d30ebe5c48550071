"""The port's training substrate (``repro_torch.{checkpoint,data,runtime}``,
``launch.train``) on the CPU: the cases of ``tests/test_runtime.py`` —
checkpoint round trip, integrity refusal and atomicity, the Trainer's runs,
kill-and-resume bit-identical, NaN quarantine and stragglers, deterministic
sharded data — plus parity with the reference: its batches bit for bit, and
its checkpoints, which either package restores leaf for leaf."""
import dataclasses
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import models as R
from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import ShardedTokenPipeline as RefPipeline
from repro.data import synth_corpus as ref_synth_corpus
from repro.optim import adamw as ref_adamw

import repro_torch.models as P
from repro_torch import optim
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, ShardedTokenPipeline, synth_corpus
from repro_torch.launch import train as launch_train
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import Stack, as_array, leaves

pytestmark = pytest.mark.port

CPU = "cpu"
EXEC = P.ExecConfig(attn_chunk_q=8, attn_chunk_k=8, ssm_chunk=8, loss_chunk=8)
QUIET = dict(async_save=False, log_fn=lambda *a: None)
#: name -> (arch, race_smooth_radius, dtype) of the trainer's models
SETUPS = {"qwen3": ("qwen3_14b", 0, "bfloat16"),
          "qwen2+race_smooth": ("qwen2_7b", 2, "float32")}


class Setup:
    """A fresh trainable model and optimizer state for every run (the step
    updates them in place), the jitless train step and the data."""

    def __init__(self, name):
        arch, radius, dtype = SETUPS[name]
        self.cfg = dataclasses.replace(get_config(arch).reduced(),
                                       race_smooth_radius=radius, dtype=dtype)
        self.opt_cfg = optim.AdamWConfig(lr=1e-3)
        self.step = P.make_train_step(self.cfg, self.opt_cfg, EXEC)
        self.data = ShardedTokenPipeline(DataConfig(
            seq_len=16, global_batch=2, vocab=self.cfg.vocab, seed=7))

    def fresh(self):
        model = P.init_params(self.cfg, generator=torch.Generator()
                              .manual_seed(0), device=CPU, trainable=True)
        if self.cfg.race_smooth_radius:
            with torch.no_grad():
                model.smooth_taps.copy_(torch.tensor([0.3, -0.2, 0.1]))
        return model, optim.adamw_init(model, self.opt_cfg)


@pytest.fixture()
def small():
    return Setup("qwen3")


def _equal(a, b) -> bool:
    a, b = as_array(a).detach(), as_array(b).detach()
    return a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_integrity(small, tmp_path):
    model, opt = small.fresh()
    state = {"params": model.param_tree(), "opt": opt}
    d = tmp_path / "ck"
    save_checkpoint(d, 3, state)
    restored, step = restore_checkpoint(d, state)
    assert step == 3
    assert all(_equal(a, b) for a, b in zip(leaves(state), leaves(restored)))
    assert isinstance(restored["params"]["units"][0]["ln1"], Stack)
    target = next((d / "step_00000003").glob("arr_00001.npy"))
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 0xFF
    target.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        restore_checkpoint(d, state)


def test_checkpoint_atomic_no_partial(tmp_path):
    d = tmp_path / "ck"
    (d / ".tmp_step_00000009").mkdir(parents=True)
    assert latest_step(d) is None


def test_checkpoint_manifest_is_the_references(small, tmp_path):
    """Keys are the reference's tree paths, files numbered in its leaf
    order, bfloat16 stored as uint16 with its crc32."""
    model, opt = small.fresh()
    save_checkpoint(tmp_path, 1, {"params": model.param_tree(), "opt": opt})
    man = json.loads((tmp_path / "step_00000001" / "manifest.json")
                     .read_text())
    rcfg = ref_get_config("qwen3_14b").reduced()
    rp = R.init_params(jax.random.PRNGKey(0), rcfg)
    want, _ = jax.tree_util.tree_flatten_with_path(
        {"params": rp, "opt": ref_adamw.adamw_init(rp, ref_adamw.AdamWConfig())})
    keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in want]
    assert list(man["arrays"]) == keys
    assert [m["file"] for m in man["arrays"].values()] == [
        f"arr_{i:05d}.npy" for i in range(len(keys))]
    meta = man["arrays"]["params/units/0/attn/wq"]
    arr = np.load(tmp_path / "step_00000001" / meta["file"])
    assert meta["dtype"] == "bfloat16" and arr.dtype == np.uint16
    assert meta["shape"] == [rcfg.num_layers, 64, 64]
    assert meta["crc32"] == zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def test_shape_mismatch_is_refused(small, tmp_path):
    model, opt = small.fresh()
    save_checkpoint(tmp_path, 1, {"opt": opt})
    bad = {"opt": dict(opt, step=torch.zeros((2,), dtype=torch.int32))}
    with pytest.raises(ValueError, match="opt/step"):
        restore_checkpoint(tmp_path, bad)


def _ref_state(rcfg):
    """The reference's params and an AdamW state after one update with
    random gradients (so no moment is zero)."""
    params = R.init_params(jax.random.PRNGKey(3), rcfg)
    params = dict(params, smooth_taps=jnp.asarray([0.3, -0.2, 0.1]))
    cfg = ref_adamw.AdamWConfig()
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), p.dtype), params)
    _, opt = ref_adamw.adamw_update(params, grads,
                                    ref_adamw.adamw_init(params, cfg), cfg,
                                    1e-3)
    return {"params": params, "opt": opt}


def _bits(a) -> np.ndarray:
    """An array's bytes as integers (bfloat16 by its bit pattern)."""
    if isinstance(a, (torch.Tensor, Stack)):
        a = as_array(a).detach().reshape(-1)
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy().view(np.uint8)
    return np.asarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_into_the_port(dtype, tmp_path):
    """A checkpoint of the reference's ``CheckpointManager`` (async) into
    the port's structure: every leaf bit for bit, unit leaves split."""
    rcfg = dataclasses.replace(ref_get_config("qwen2_7b").reduced(),
                               dtype=dtype, race_smooth_radius=2)
    pcfg = dataclasses.replace(get_config("qwen2_7b").reduced(),
                               dtype=dtype, race_smooth_radius=2)
    ref = _ref_state(rcfg)
    mgr = RefManager(tmp_path, async_save=True)
    mgr.save(5, ref)
    mgr.wait()
    model = P.init_params(pcfg, generator=torch.Generator().manual_seed(1),
                          device=CPU, trainable=True)
    like = {"params": model.param_tree(),
            "opt": optim.adamw_init(model, optim.AdamWConfig())}
    got, step = CheckpointManager(tmp_path).restore_latest(like)
    assert step == 5
    want = jax.tree.leaves(ref)
    assert len(want) == len(leaves(got))
    for w, g in zip(want, leaves(got)):
        assert tuple(as_array(g).shape) == w.shape
        assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_into_the_reference(dtype, tmp_path):
    """The reverse: the port's async ``CheckpointManager`` after two train
    steps, restored by the reference's ``restore_checkpoint`` into its own
    tree, leaf for leaf."""
    s = Setup("qwen2+race_smooth")
    s.cfg = dataclasses.replace(s.cfg, dtype=dtype)
    s.step = P.make_train_step(s.cfg, s.opt_cfg, EXEC)
    model, opt = s.fresh()
    for i in range(2):
        model, opt, _ = s.step(model, opt, s.data.batch_at(i))
    state = {"params": model.param_tree(), "opt": opt}
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(2, state)
    mgr.wait()
    rcfg = dataclasses.replace(ref_get_config("qwen2_7b").reduced(),
                               dtype=dtype, race_smooth_radius=2)
    restored, step = ref_restore(tmp_path, _ref_state(rcfg))
    assert step == 2
    for w, g in zip(jax.tree.leaves(restored), leaves(state)):
        assert np.array_equal(_bits(w), _bits(g))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_trainer_runs_and_checkpoints(small, tmp_path):
    model, opt = small.fresh()
    tc = TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=2, **QUIET)
    out = Trainer(tc, small.step, small.data, model, opt).run()
    assert out["step"] == 6
    assert latest_step(tmp_path / "ck") == 6
    assert all(np.isfinite(out["losses"]))
    assert {"hits", "misses"} <= set(out["race_cache"])


@pytest.mark.parametrize("name", list(SETUPS))
def test_kill_and_resume_bit_identical(name, tmp_path):
    """6 steps straight vs 3 + 'crash' + a new trainer on freshly made
    parameters resuming from the checkpoint: the final parameters and
    optimizer state are bit-identical (with the mixer: K1's tile emulator
    forward and backward)."""
    s = Setup(name)
    mA, oA = s.fresh()
    trA = Trainer(TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "A"),
                                ckpt_every=3, **QUIET), s.step, s.data, mA, oA)
    trA.run()
    Trainer(TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path / "B"),
                          ckpt_every=3, **QUIET), s.step, s.data,
            *s.fresh()).run()
    mB, oB = s.fresh()
    trB = Trainer(TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "B"),
                                ckpt_every=3, **QUIET), s.step, s.data, mB, oB)
    outB = trB.run()
    assert outB["losses"] and len(outB["losses"]) == 3
    assert all(_equal(a, b) for a, b in zip(
        leaves(mA.param_tree()), leaves(mB.param_tree())))
    assert all(_equal(a, b) for a, b in zip(leaves(trA.opt_state),
                                            leaves(trB.opt_state)))


def test_nan_quarantine(small, tmp_path):
    marker = int(small.data.batch_at(2)["tokens"][0, 0])

    def poisoned_step(p, o, batch):
        p2, o2, m = small.step(p, o, batch)
        bad = float("nan") if batch["tokens"][0, 0] == marker else 0.0
        return p2, o2, dict(m, loss=m["loss"] + bad)

    tc = TrainerConfig(total_steps=5, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=1, skip_on_nan=True, **QUIET)
    out = Trainer(tc, poisoned_step, small.data, *small.fresh()).run()
    assert out["restarts"] >= 1
    assert out["step"] == 5


def test_nan_past_max_restarts_raises(small, tmp_path):
    def nan_step(p, o, batch):
        p2, o2, m = small.step(p, o, batch)
        return p2, o2, dict(m, loss=m["loss"] + float("nan"))

    tc = TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=1, max_restarts=0, **QUIET)
    with pytest.raises(FloatingPointError):
        Trainer(tc, nan_step, small.data, *small.fresh()).run()


def test_straggler_detection(small, tmp_path):
    import time as _t

    model, opt = small.fresh()
    small.step(model, opt, small.data.batch_at(0))  # warm the executors
    t0 = _t.perf_counter()
    small.step(model, opt, small.data.batch_at(1))
    # the stall dwarfs a step however loaded the machine is
    stall = max(1.0, 20 * (_t.perf_counter() - t0))
    calls = {"n": 0}

    def slow_step(p, o, b):
        calls["n"] += 1
        if calls["n"] == 5:
            _t.sleep(stall)
        return small.step(p, o, b)

    model, opt = small.fresh()
    tc = TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=100, straggler_factor=3.0, **QUIET)
    out = Trainer(tc, slow_step, small.data, model, opt).run()
    assert len(out["stragglers"]) >= 1


def test_preemption_checkpoints_and_stops(small, tmp_path):
    """The SIGTERM/SIGINT hook's flag: checkpoint at once, then stop."""
    tr = None

    def step(p, o, b):
        tr._preempted = tr.step >= 1
        return small.step(p, o, b)

    tc = TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=100, **QUIET)
    tr = Trainer(tc, step, small.data, *small.fresh())
    out = tr.run()
    assert out["step"] == 2 and latest_step(tmp_path / "ck") == 2


def test_end_to_end_training_loss_decreases(tmp_path):
    """``tests/test_system.py``'s run on the port: a tiny model on a
    near-stationary corpus, AdamW, the checkpointing trainer; the loss
    drops."""
    cfg = dataclasses.replace(get_config("qwen3_14b").reduced(), vocab=64,
                              d_model=64, num_layers=2)
    ec = P.ExecConfig(attn_chunk_q=8, attn_chunk_k=8, loss_chunk=8)
    params = P.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device=CPU, trainable=True)
    opt_cfg = optim.AdamWConfig(lr=3e-3)
    step = P.make_train_step(cfg, opt_cfg, ec, total_steps=30, warmup=3)
    pipe = ShardedTokenPipeline(DataConfig(seq_len=32, global_batch=4,
                                           vocab=cfg.vocab, seed=1))

    class FixedPipe:
        def batch_at(self, step):
            return pipe.batch_at(step % 2)

    tc = TrainerConfig(total_steps=30, ckpt_dir=str(tmp_path), ckpt_every=100,
                       **QUIET)
    out = Trainer(tc, step, FixedPipe(), params,
                  optim.adamw_init(params, opt_cfg)).run()
    assert out["losses"][-1] < out["losses"][0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host", [0, 1])
def test_batches_equal_the_references(host, tmp_path):
    """Synthetic and memmapped batches, two hosts: bit for bit."""
    f = str(tmp_path / "toks.bin")
    synth_corpus(f, 10_000, vocab=50, seed=1)
    ref_f = str(tmp_path / "ref.bin")
    ref_synth_corpus(ref_f, 10_000, vocab=50, seed=1)
    assert open(f, "rb").read() == open(ref_f, "rb").read()
    for token_file in (None, f):
        kw = dict(seq_len=8, global_batch=4, vocab=50, seed=3, n_hosts=2,
                  host_id=host, token_file=token_file)
        mine = ShardedTokenPipeline(DataConfig(**kw))
        ref = RefPipeline(RefDataConfig(**kw))
        for step in (0, 5, 17):
            a, b = mine.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])


def test_data_determinism_and_sharding():
    cfg = DataConfig(seq_len=8, global_batch=4, vocab=100, seed=3, n_hosts=2,
                     host_id=0)
    cfg1 = dataclasses.replace(cfg, host_id=1)
    p0, p0b, p1 = (ShardedTokenPipeline(c) for c in (cfg, cfg, cfg1))
    a, b, c = p0.batch_at(5), p0b.batch_at(5), p1.batch_at(5)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (2, 8)


def test_memmap_pipeline(tmp_path):
    f = synth_corpus(str(tmp_path / "toks.bin"), 10_000, vocab=50, seed=1)
    p = ShardedTokenPipeline(DataConfig(seq_len=16, global_batch=2, vocab=50,
                                        token_file=f))
    b1, b2 = p.batch_at(0), p.batch_at(0)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert np.array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    it = p.iterator(0)
    nxt = next(it)
    p.close()
    assert np.array_equal(nxt["tokens"], b1["tokens"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_train_prints_the_reference_line(tmp_path, capsys):
    launch_train.main(["--arch", "qwen2_7b", "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16",
                       "--race-smooth", "2", "--ckpt-dir",
                       str(tmp_path / "ck")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"arch", "steps", "final_loss", "first_loss",
                         "tokens_per_s", "restarts"}
    assert line["arch"] == "qwen2-7b-reduced" and line["steps"] == 3
    assert np.isfinite(line["final_loss"]) and line["restarts"] == 0
    assert latest_step(tmp_path / "ck") == 3


def test_launch_train_mesh_is_not_ported(tmp_path):
    args = launch_train.parser().parse_args([
        "--arch", "qwen2_7b", "--reduced", "--device", "cpu", "--mesh", "2x2",
        "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="item 9.3"):
        launch_train.setup(args)
