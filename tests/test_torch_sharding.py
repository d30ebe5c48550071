"""The LM's placement layer of the port (``models/sharding``, the meshes,
``opt_state_shardings``, ``launch/specs``, ``runtime/elastic``,
``runtime/grad_sync``) against the reference on the CPU.

The reference's rules read only ``mesh.axis_names`` and ``mesh.shape``, so
they are called with the port's mesh objects (abstract for the production
meshes: no 256-device jax runtime is needed), on the leaf paths and shapes
of ``jax.eval_shape`` of its initializers; ``NamedSharding`` is replaced by
its spec while they run.  Placement round trips run on meshes of ``cpu``
devices; the reference's gradient sync runs in a subprocess with forced
host devices, as ``tests/test_grad_sync.py`` runs it."""
import functools
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.models import sharding as ref_sharding
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw as ref_adamw

from repro_torch import optim
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.launch.specs import (TensorStruct, batch_struct,
                                      batch_structs_sharded, cache_structs,
                                      decode_token_struct, meta_params,
                                      param_structs)
from repro_torch.models import SHAPES, init_params
from repro_torch.models.sharding import (P, Placed, Sharding, activation_spec,
                                         gather, gather_tree, param_spec,
                                         params_shardings, place, replicated)
from repro_torch.optim.adamw import opt_state_shardings
from repro_torch.runtime.elastic import reshard_checkpoint
from repro_torch.runtime.grad_sync import (compressed_pmean,
                                           compressed_pmean_tree, wire_bytes)
from repro_torch.tree import as_array, leaves, leaves_with_paths

pytestmark = pytest.mark.port

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"
#: (shape, axes) of every mesh the specs are held on
MESHES = {"prod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


def _mesh(name) -> Mesh:
    shape, axes = MESHES[name]
    if name == "prod":
        return make_production_mesh()
    if name == "multipod":
        return make_production_mesh(multi_pod=True)
    return make_mesh(shape, axes)  # abstract here: no card


@pytest.fixture()
def spec_only(monkeypatch):
    """The reference's rules return their specs instead of NamedShardings
    (which need a jax mesh of real devices)."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)


def _keys(path) -> tuple:
    return tuple(k.key if hasattr(k, "key") else k.idx for k in path)


def _ref_flat(tree) -> dict:
    """{path: leaf} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_keys(p): v for p, v in flat}


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    """(params, factored opt state, plain opt state) shape trees of the
    reference's full config, by ``jax.eval_shape``."""
    cfg = ref_get_config(arch)
    params = jax.eval_shape(lambda k: R.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    opts = [jax.eval_shape(lambda: ref_adamw.adamw_init(
        params, RefAdamWConfig(factored=f))) for f in (True, False)]
    return params, opts[0], opts[1]


def _spec(s) -> tuple:
    return tuple(s)


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name):
    """``param_structs``' shapes, dtypes and specs, and the optimizer
    state's (``opt_state_shardings``, factored and not), leaf for leaf."""
    mesh = _mesh(mesh_name)
    ref_p, ref_of, ref_op = _ref_shapes(arch)
    cfg = get_config(arch)
    for factored, ref_o in ((True, ref_of), (False, ref_op)):
        p_sds, o_sds = param_structs(cfg, mesh,
                                     opt_cfg=optim.AdamWConfig(
                                         factored=factored))
        want = _ref_flat(ref_p)
        got = dict(leaves_with_paths(p_sds))
        assert list(got) == list(want)
        ref_specs = []
        for path, leaf in want.items():
            spec = ref_sharding.param_spec(path, leaf.shape, mesh,
                                           ref_get_config(arch))
            ref_specs.append((spec, leaf.shape))
            g = got[path]
            assert g.shape == tuple(leaf.shape)
            assert _dtype(g.dtype) == leaf.dtype.name
            assert _spec(g.sharding.spec) == _spec(spec), path
            assert _spec(param_spec(path, leaf.shape, mesh, cfg)) == _spec(
                spec)
            assert g.sharding.mesh is mesh
        ref_os = ref_adamw.opt_state_shardings(ref_specs, "R",
                                               RefAdamWConfig(
                                                   factored=factored))
        ref_ospec = _ref_flat(ref_os["mu"])
        ref_oshape = _ref_flat(ref_o["mu"])
        got_o = dict(leaves_with_paths(o_sds["mu"]))
        assert list(got_o) == list(ref_oshape)
        for path, g in got_o.items():
            assert g.shape == tuple(ref_oshape[path].shape)
            assert _dtype(g.dtype) == ref_oshape[path].dtype.name
            assert _spec(g.sharding.spec) == _spec(ref_ospec[path]), path
        assert o_sds["step"].shape == () and o_sds["step"].sharding.spec == P()
        # the port's opt_state_shardings itself, on the same pairs
        mine = opt_state_shardings([(P(*s), sh) for s, sh in ref_specs],
                                   "R", optim.AdamWConfig(factored=factored))
        assert {k: _spec(v) for k, v in _ref_flat(mine["mu"]).items()} == {
            k: _spec(v) for k, v in ref_ospec.items()}
        assert mine["step"] == "R"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh_name,
                                                   spec_only):
    """``cache_structs`` (the reference's structure: units stacked),
    ``batch_structs_sharded`` and ``decode_token_struct`` against the
    reference's ``cache_shardings`` / ``batch_shardings`` on
    ``jax.eval_shape`` of its ``init_caches``."""
    mesh = _mesh(mesh_name)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    shape = SHAPES["decode_32k"]
    for kv_quant in (False, True):
        ref_c = jax.eval_shape(lambda: R.init_caches(
            rcfg, shape.global_batch, shape.seq_len, kv_quant=kv_quant))
        ref_s = _ref_flat(ref_sharding.cache_shardings(ref_c, mesh, rcfg))
        ref_c = _ref_flat(ref_c)
        got = dict(leaves_with_paths(cache_structs(cfg, mesh, shape,
                                                   kv_quant=kv_quant)))
        assert list(got) == list(ref_c)
        for path, g in got.items():
            assert g.shape == tuple(ref_c[path].shape)
            assert _dtype(g.dtype) == ref_c[path].dtype.name
            assert _spec(g.sharding.spec) == _spec(ref_s[path]), path
    for mode in ("train_4k", "prefill_32k"):
        sh = SHAPES[mode]
        b = batch_struct(cfg, sh)
        ref_b = {k: jax.ShapeDtypeStruct(v.shape, jnp.dtype(_dtype(v.dtype)))
                 for k, v in b.items()}
        ref_bs = ref_sharding.batch_shardings(ref_b, mesh, rcfg)
        got = batch_structs_sharded(cfg, mesh, sh)
        assert set(got) == set(ref_bs)
        for k, g in got.items():
            assert _spec(g.sharding.spec) == _spec(ref_bs[k])
    tok = decode_token_struct(cfg, mesh, shape)
    want = ref_sharding.batch_shardings(
        {"token": jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)},
        mesh, rcfg)["token"]
    assert tok.shape == (shape.global_batch, 1)
    assert _spec(tok.sharding.spec) == _spec(want)
    assert _spec(replicated(mesh).spec) == _spec(ref_sharding.replicated(mesh))
    assert _spec(activation_spec(mesh).spec) == _spec(
        ref_sharding.activation_spec(mesh))


def test_batch_struct_equals_the_reference():
    for arch in ARCHS:
        for sh in SHAPES.values():
            got = batch_struct(get_config(arch), sh)
            want = __import__("repro.launch.specs", fromlist=["x"]) \
                .batch_struct(ref_get_config(arch), sh)
            assert {k: (v.shape, _dtype(v.dtype)) for k, v in got.items()} \
                == {k: (tuple(v.shape), v.dtype.name)
                    for k, v in want.items()}


def test_param_structs_of_grok_allocate_nothing():
    """grok-1-314b's full config: every parameter and moment as a shape
    struct within seconds, without drawing or holding a weight."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    cfg = get_config("grok_1_314b")
    p_sds, o_sds = param_structs(cfg, make_production_mesh(multi_pod=True),
                                 opt_cfg=optim.AdamWConfig(factored=True))
    assert time.perf_counter() - t0 < 30
    n = sum(int(np.prod(s.shape)) for s in leaves(p_sds))
    assert n > 3e11  # 314 B parameters described
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    assert grown < 512 * 1024  # KiB: nothing near a weight was held
    assert all(isinstance(s, TensorStruct) for s in leaves(o_sds))
    model = meta_params(cfg)
    assert {p.device.type for p in model.parameters()} == {"meta"}


def test_meshes():
    prod = make_production_mesh()
    assert prod.abstract and prod.shape == {"data": 16, "model": 16}
    pods = make_production_mesh(multi_pod=True)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert pods.size == 512 and pods.key()[1] is None
    m = make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    assert not m.abstract and m.devices.shape == (2, 2)
    assert {str(d) for d in m.devices.flat} == {CPU}
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), [CPU] * 3)
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), [CPU] * 4)
    with pytest.raises(ValueError, match="abstract"):
        place(torch.zeros(4), Sharding(prod, P("data")))


@pytest.mark.parametrize("mesh_shape,axes", [
    ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))])
def test_place_gather_round_trip_is_bit_exact(mesh_shape, axes):
    mesh = make_mesh(mesh_shape, axes, [CPU] * int(np.prod(mesh_shape)))
    gen = torch.Generator().manual_seed(0)
    t = torch.randn((8, 12, 4), generator=gen).to(torch.bfloat16)
    specs = [P(), P("data"), P(None, "model"), P("model", "data"),
             P(("pod", "data") if "pod" in axes else ("data",), "model")]
    for spec in specs:
        s = Sharding(mesh, spec)
        placed = place(t, s)
        assert placed.shards.shape == mesh_shape
        back = gather(placed)
        assert back.dtype == t.dtype
        assert torch.equal(back.view(torch.int16), t.view(torch.int16))
        for sh in placed.shards.flat:  # copies, not views of t
            assert sh.untyped_storage().data_ptr() != \
                t.untyped_storage().data_ptr()
    # a block's position: data major over pod-less 2-axis splits
    placed = place(t, Sharding(mesh, P("data")))
    n = mesh.shape["data"]
    for idx in np.ndindex(mesh.devices.shape):
        d = idx[list(axes).index("data")]
        assert torch.equal(placed.shards[idx],
                           t[d * 8 // n:(d + 1) * 8 // n])


def _trained_state(arch, factored):
    cfg = get_config(arch).reduced()
    model = init_params(cfg, generator=torch.Generator().manual_seed(3),
                        device=CPU)
    tree = model.param_tree()
    opt = optim.adamw_init(tree, optim.AdamWConfig(factored=factored))
    gen = torch.Generator().manual_seed(4)
    for leaf in leaves(opt["mu"]):  # moments of some training
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    return cfg, {"params": tree, "opt": opt}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch,factored", [("qwen3_14b", False),
                                           ("deepseek_moe_16b", True),
                                           ("falcon_mamba_7b", False)])
def test_reshard_checkpoint_round_trip(tmp_path, arch, factored, mesh_shape):
    """A checkpoint the port wrote, restored re-sharded onto a mesh of
    ``cpu`` devices, gathers back bit-equal; every leaf is placed per
    ``params_shardings`` / ``opt_state_shardings``."""
    cfg, state = _trained_state(arch, factored)
    save_checkpoint(tmp_path, 5, state)
    meta = {"params": meta_params(cfg).param_tree(),
            "opt": optim.adamw_init(meta_params(cfg).param_tree(),
                                    optim.AdamWConfig(factored=factored))}
    got, step, mesh = reshard_checkpoint(tmp_path, meta, cfg, mesh_shape,
                                         ("data", "model"),
                                         devices=[CPU] * 4)
    assert step == 5 and mesh.shape == dict(zip(("data", "model"),
                                                mesh_shape))
    p_shard = params_shardings(state["params"], mesh, cfg)
    for (path, placed), s in zip(leaves_with_paths(got["params"]),
                                 leaves(p_shard)):
        assert isinstance(placed, Placed), path
        assert tuple(placed.sharding.spec) == tuple(s.spec)
    back = gather_tree(got)
    for (path, a), b in zip(leaves_with_paths(back), leaves(state)):
        b = as_array(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), path


REF_SYNC = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.runtime.grad_sync import compressed_pmean_tree

mesh_kw = ({"axis_types": (jax.sharding.AxisType.Auto,)}
           if hasattr(jax.sharding, "AxisType") else {})
mesh = jax.make_mesh((4,), ("data",), **mesh_kw)
data = np.load(sys.argv[1])
g_all = {k: jnp.asarray(data["g_" + k]) for k in ("w", "b")}
e_all = {k: jnp.zeros_like(v) for k, v in g_all.items()}

def sync(g, e):
    m, ne = compressed_pmean_tree({k: v[0] for k, v in g.items()},
                                  {k: v[0] for k, v in e.items()}, "data")
    return ({k: v[None] for k, v in m.items()},
            {k: v[None] for k, v in ne.items()})

f = jax.jit(shard_map(sync, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data"))))
m1, e1 = f(g_all, e_all)
m2, e2 = f(g_all, e1)
np.savez(sys.argv[2], **{f"{n}_{k}": np.asarray(t[k])
                         for n, t in (("m1", m1), ("e1", e1), ("m2", m2),
                                      ("e2", e2)) for k in ("w", "b")})
print("OK")
"""


def test_compressed_pmean_tree_matches_the_reference(tmp_path):
    """Four members' seeded local gradients: the port's compressed mean and
    carried error, two rounds, against the reference's in ``shard_map``
    over four forced host devices, to float32 rounding; the members agree
    bit for bit; the mean lies within 0.02 of the exact one."""
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((4, 64, 32)).astype(np.float32),
         "b": rng.standard_normal((4, 48)).astype(np.float32)}
    np.savez(tmp_path / "in.npz", **{"g_" + k: v for k, v in g.items()})
    r = subprocess.run(
        [sys.executable, "-c", REF_SYNC, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)}, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    grads = [{k: torch.from_numpy(v[i].copy()) for k, v in g.items()}
             for i in range(4)]
    m1, e1 = compressed_pmean_tree(grads)
    m2, e2 = compressed_pmean_tree(grads, e1)
    for name, got in (("m1", m1), ("e1", e1), ("m2", m2), ("e2", e2)):
        for i in range(4):
            for k in ("w", "b"):
                np.testing.assert_allclose(got[i][k].numpy(),
                                           want[f"{name}_{k}"][i],
                                           rtol=1e-6, atol=1e-6)
    for i in range(1, 4):  # every member forms the same mean
        for k in ("w", "b"):
            assert torch.equal(m1[i][k], m1[0][k])
    for k in ("w", "b"):
        exact = g[k].mean(0)
        rel = np.abs(m1[0][k].numpy() - exact).max() / np.abs(exact).max()
        assert rel < 0.02
    # the second round carried the first's error: it is not the first again
    assert not torch.equal(m2[0]["w"], m1[0]["w"])
    assert wire_bytes(grads) == (64 * 32 + 48 + 8, 4 * (64 * 32 + 48))


def test_compressed_pmean_keeps_each_member_on_its_device():
    gs = [torch.full((3,), float(i), dtype=torch.bfloat16) for i in range(4)]
    means, errs = compressed_pmean(gs)
    assert all(m.dtype == torch.bfloat16 and m.device.type == CPU
               for m in means)
    assert all(e.dtype == torch.float32 for e in errs)
    assert float(means[0][0]) == pytest.approx(1.5, rel=1e-2)
