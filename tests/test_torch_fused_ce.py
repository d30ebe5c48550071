"""The port's fused cross-entropy against the reference's
(``repro/kernels/fused_ce.py``), on the CPU: the plain forward (the kernel's
split and combine) against the Pallas kernel in interpret mode and the dense
loss, the gradients of ``fused_ce`` against ``jax.grad``, out-of-range
labels, and the wrapper's checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ce as ref

from repro_torch.kernels import fused_ce as fc

pytestmark = pytest.mark.port

SHAPES = [  # the reference's test shapes: T, D, V, t_blk, v_blk
    (64, 32, 256, 16, 64),
    (32, 16, 100, 8, 25),      # V not a multiple of the kernel's tile
    (48, 64, 512, 48, 512),    # single tile
    (128, 8, 64, 32, 16),
]


def _data(T, D, V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    labels = rng.integers(0, V, (T,)).astype(np.int32)
    return h, w, labels


def _port(*arrays, dtype=torch.float32):
    h, w, labels = (torch.from_numpy(a) for a in arrays)
    return h.to(dtype), w.to(dtype), labels


def _ref(*arrays, dtype=jnp.float32):
    h, w, labels = (jnp.asarray(a) for a in arrays)
    return h.astype(dtype), w.astype(dtype), labels


@pytest.mark.parametrize("T,D,V,tb,vb", SHAPES)
def test_forward_matches_reference(T, D, V, tb, vb):
    """f32 within 1e-5: both sum the D products in f32, in another order,
    and fold the vocab in other blocks; the online logsumexp is exact
    arithmetic up to that rounding."""
    data = _data(T, D, V)
    want = np.asarray(ref.fused_ce_forward(*_ref(*data), t_blk=tb, v_blk=vb,
                                           interpret=True))
    h, w, labels = _port(*data)
    for v_blk in (vb, None, 1):
        got = fc.fused_ce_forward(h, w, labels, t_blk=tb, v_blk=v_blk)
        assert got.dtype == torch.float32 and tuple(got.shape) == (T,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dense = float(ref._ce_ref(*_ref(*data)))
    assert abs(float(got.mean()) - dense) <= 1e-5 * max(1.0, abs(dense))
    assert abs(float(fc._ce_ref(h, w, labels)) - dense) <= 1e-5 * abs(dense)


def test_bf16_inputs_match_reference():
    """bf16 ``h`` and ``w``: the same rounded values on both sides, upcast
    before the product, so the per-token losses agree as in f32; the mean
    is also held to the reference's bf16 tolerance of 2e-2 against the
    dense loss."""
    data = _data(64, 32, 256, seed=1)
    h, w, labels = _port(*data, dtype=torch.bfloat16)
    got = fc.fused_ce_forward(h, w, labels, t_blk=16, v_blk=64)
    rh, rw, rl = _ref(*data, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(rh.astype(jnp.float32)))
    want = np.asarray(ref.fused_ce_forward(rh, rw, rl, t_blk=16, v_blk=64,
                                           interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dense = float(ref._ce_ref(rh, rw, rl))
    np.testing.assert_allclose(float(got.mean()), dense, rtol=2e-2)


def test_label_out_of_range_gives_zero_gold_logit():
    """The gold logit is found by comparing indices, as on the TPU: a label
    at or past V matches no column, so the loss is the logsumexp alone."""
    h, w, labels = _data(32, 16, 100, seed=3)
    labels[[0, 5]] = [100, 1000]
    want = np.asarray(ref.fused_ce_forward(*_ref(h, w, labels), t_blk=8,
                                           v_blk=25, interpret=True))
    got = fc.fused_ce_forward(*_port(h, w, labels), v_blk=25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    lse = torch.logsumexp(torch.from_numpy(h) @ torch.from_numpy(w), dim=1)
    np.testing.assert_allclose(got[[0, 5]], lse[[0, 5]].numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("bfloat16", 2 ** -7)])
def test_grads_match_reference(dtype, rtol):
    """f32 at the reference test's tolerance; bf16 gradients are f32 values
    rounded to bf16 on both sides (the port's after scaling by the
    cotangent), so they may differ by a rounding step: 2**-7 relative."""
    data = _data(32, 16, 128, seed=2)
    rh, rw, rl = _ref(*data, dtype=getattr(jnp, dtype))
    want = jax.grad(lambda h, w: ref.fused_ce(h, w, rl), argnums=(0, 1))(
        rh, rw)
    h, w, labels = _port(*data, dtype=getattr(torch, dtype))
    h.requires_grad_()
    w.requires_grad_()
    loss = fc.fused_ce(h, w, labels)
    dh, dw = torch.autograd.grad(loss * 3.0, (h, w))
    assert dh.dtype == h.dtype and dw.dtype == w.dtype
    for got, ref_g in zip((dh, dw), want):
        np.testing.assert_allclose(got.float().numpy() / 3.0,
                                   np.asarray(ref_g.astype(jnp.float32)),
                                   rtol=rtol, atol=1e-5)
    dense = torch.autograd.grad(fc._ce_ref(h, w, labels), (h, w))
    for got, d in zip((dh, dw), dense):
        torch.testing.assert_close(got.float() / 3.0, d.float(), rtol=rtol,
                                   atol=1e-5)


def test_split_width():
    assert fc.split_width(64, 256, 64) == 64
    assert fc.split_width(64, 256, 1) == fc.TILE_V
    assert fc.split_width(64, 256, 65) == 2 * fc.TILE_V
    # default: one token block, 4 vocab tiles -> one tile per split
    assert fc.split_width(64, 256) == fc.TILE_V
    # full width: 64 token blocks, 2376 vocab tiles -> 9 splits of 264 tiles
    assert fc.split_width(4096, 152064) == 264 * fc.TILE_V
    with pytest.raises(ValueError, match="v_blk"):
        fc.split_width(64, 256, 0)


def test_combine_ignores_an_empty_split():
    """A split with no columns keeps its initial ``m = -1e30, l = 0``."""
    m = torch.tensor([[1.0, 2.0], [-1e30, -1e30]])
    l = torch.tensor([[2.0, 3.0], [0.0, 0.0]])
    g = torch.tensor([[0.5, 0.0], [0.0, 0.0]])
    got = fc._combine(m, l, g)
    want = torch.tensor([1.0 + np.log(2.0) - 0.5, 2.0 + np.log(3.0)],
                        dtype=torch.float32)
    torch.testing.assert_close(got, want)


def test_wrapper_checks():
    h, w, labels = _port(*_data(8, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fc.KERNEL(h, w, labels)
    with pytest.raises(ValueError, match="int32"):
        fc.fused_ce_forward(h, w, labels.long())
    with pytest.raises(ValueError, match="share"):
        fc.fused_ce_forward(h, w.double(), labels)
    with pytest.raises(ValueError, match="disagree"):
        fc.fused_ce_forward(h, w[:3], labels)
    assert fc.KERNEL.launches == 0
