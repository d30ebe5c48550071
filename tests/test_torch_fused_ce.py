"""The port's fused cross-entropy against the reference's
(``repro/kernels/fused_ce.py``), on the CPU: the plain forward (the kernel's
split and combine) against the Pallas kernel in interpret mode and the dense
loss, the gradients of ``fused_ce`` against ``jax.grad``, out-of-range
labels, the wrapper's checks, and the 3xTF32 split of the float32 kernel
(its plain version and the precision of three TF32 passes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
    """``v_blk`` rounds up to the variant's tile width; ``None`` picks the
    split of the least makespan.  The expected full-width split changed
    with the tensor-core kernel's tile (128 x 256, one block per SM): 18
    tiles of 256 columns, where the FFMA tile (64 x 64, four blocks per
    SM) gave 264 tiles of 64 under the old rule."""
    ffma_v = fc.TILES["ffma"][1]
    assert fc.split_width(64, 256, 64, variant="ffma") == 64
    assert fc.split_width(64, 256, 1, variant="ffma") == ffma_v
    assert fc.split_width(64, 256, 65, variant="ffma") == 2 * ffma_v
    assert fc.split_width(64, 256, 1, variant="wgmma") == 256
    assert fc.split_width(64, 256, 300, variant="wgmma") == 512
    # default: one token block, 4 vocab tiles -> one tile per split
    assert fc.split_width(64, 256, variant="ffma") == ffma_v
    # full width: 32 token tiles, 594 vocab tiles -> 33 splits of 18 tiles
    assert fc.split_width(4096, 152064, variant="wgmma") == 18 * 256
    with pytest.raises(ValueError, match="v_blk"):
        fc.split_width(64, 256, 0, variant="wgmma")


@pytest.mark.parametrize("kind", ["wgmma", "tf32x3", "ffma"])
def test_split_width_gives_whole_waves_at_full_width(kind):
    """At the LM head of qwen2-7b every SM runs the same number of blocks,
    each over the same number of vocab tiles."""
    T, V = 4096, 152064
    tile_t, tile_v = fc.TILES[kind]
    width = fc.split_width(T, V, variant=kind)
    n_split = -(-V // width)
    blocks = -(-T // tile_t) * n_split
    assert width % tile_v == 0 and n_split * width == V
    assert blocks % (fc.SMS * fc.BLOCKS_PER_SM[kind]) == 0
    if kind in ("wgmma", "tf32x3"):
        assert (n_split, blocks) == (33, 1056)  # 8 waves of 132


def test_variant_picks_the_tensor_cores_where_tma_can_load():
    """bf16 with 16-byte aligned bases and rows of a multiple of 16 bytes
    goes to the tensor-core kernel, a 200-byte row (V = 100) or a base off
    16 bytes to the FFMA kernel; every float32 input goes to the 3xTF32
    kernel, whose pre-pass writes aligned, padded operands (D = 37, a base
    off 16 bytes)."""
    def bf16(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    assert fc.variant(bf16(8, 32), bf16(32, 256)) == "wgmma"
    assert fc.variant(bf16(8, 8), bf16(8, 64)) == "wgmma"
    assert fc.variant(bf16(8, 32).float(), bf16(32, 256).float()) == "tf32x3"
    assert fc.variant(bf16(8, 16), bf16(16, 100)) == "ffma"
    assert fc.variant(bf16(8, 12), bf16(12, 256)) == "ffma"
    shifted = bf16(8 * 32 + 1)[1:].view(8, 32)  # 2 bytes past the base
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    assert fc.variant(shifted, bf16(32, 256)) == "ffma"
    f32 = torch.zeros(8 * 37 + 1)[1:].view(8, 37)  # 4 bytes past the base
    assert f32.data_ptr() % 16 == 4
    assert fc.variant(f32, torch.zeros(37, 515)) == "tf32x3"


@pytest.mark.parametrize("dtype,V,kind", [(torch.bfloat16, 1000, "wgmma"),
                                          (torch.float32, 1000, "tf32x3"),
                                          (torch.bfloat16, 100, "ffma")])
def test_plain_version_splits_like_its_variant(dtype, V, kind):
    """The plain version's partials cover the vocab ranges of the kernel
    that would take the same tensors on the card."""
    T, D = 200, 96
    h, w, labels = _port(*_data(T, D, V, seed=4), dtype=dtype)
    assert fc.variant(h, w) == kind
    width = fc.split_width(T, V, variant=kind)
    m, l, g = fc.fused_ce_partials_ref(h, w, labels)
    assert m.shape == l.shape == g.shape == (-(-V // width), T)
    torch.testing.assert_close(fc._combine(m, l, g),
                               fc.fused_ce_forward_ref(h, w, labels))
    # the last split holds only the columns up to V
    z = h.float() @ w[:, (len(m) - 1) * width:].float()
    torch.testing.assert_close(m[-1], z.amax(1))


def _bits(x):
    return x.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def _split(x):
    """hi and lo of a 1-D float32 tensor through the plain pre-pass."""
    parts = fc.tf32_split_ref(x[None])
    return parts[0, 0, :len(x)], parts[1, 0, :len(x)]


def test_tf32_split_parts_are_tf32_values():
    """hi and lo keep 10 mantissa bits: their low 13 bits are zero, over
    many binades and both signs, so the tensor core takes them exactly."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * 2.0 ** rng.integers(-60, 60, 4096))
    hi, lo = _split(torch.from_numpy(x.astype(np.float32)))
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    assert (hi != 0).all() and torch.isfinite(lo).all()


def test_tf32_split_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 2.0 - ulp / 4],
                     dtype=torch.float32)
    hi, lo = _split(x)
    assert hi.tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp, 2.0]
    # lo is what hi left, rounded the same way (2**-11 - 2**-23 needs 13
    # bits: it rounds to 2**-11)
    assert lo.tolist() == [-ulp / 2, ulp / 2, ulp / 2, -ulp / 2, -ulp / 4]


def test_tf32_split_signed_zeros_subnormals_and_non_finite():
    """Zeros keep their sign in hi (lo is +0: x - hi); a subnormal rounds
    on its bit pattern like any other value (so below 2**-136 its parts
    lose what a TF32 subnormal cannot hold); inf and NaN give hi = x and
    lo = 0, so hi + lo is x again."""
    sub = 2.0 ** -130 + 2.0 ** -137 + 2.0 ** -149  # bits 0x80000 + 0x1001
    x = torch.tensor([0.0, -0.0, sub, -sub, float("inf"), float("-inf"),
                      float("nan")], dtype=torch.float32)
    assert _bits(x)[2] == 0x81001
    hi, lo = _split(x)
    assert _bits(hi)[:2].tolist() == [0, 0x80000000]
    assert _bits(lo)[:2].tolist() == [0, 0]
    assert _bits(hi)[2:4].tolist() == [0x82000, 0x80082000]
    # x - hi = -(2**-137 - 2**-149): 4095 in the low 13 bits, below the tie
    assert _bits(lo)[2:4].tolist() == [0x80000000, 0]
    assert hi[4:6].tolist() == [float("inf"), float("-inf")]
    assert torch.isnan(hi[6]) and lo[4:].tolist() == [0.0, 0.0, 0.0]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(min_value=2.0 ** -100, max_value=2.0 ** 126,
                          width=32), min_size=1, max_size=64),
       st.lists(st.booleans(), min_size=64, max_size=64))
def test_tf32_split_error_is_below_2_to_the_minus_22(mags, signs):
    """|x - hi - lo| <= 2**-22 |x| wherever hi and lo stay normal (the
    magnitudes drawn keep lo, about 2**-11 |x|, above the subnormals and
    hi below the float32 overflow)."""
    x = torch.tensor([m if s else -m for m, s in zip(mags, signs)],
                     dtype=torch.float32)
    hi, lo = _split(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


def test_tf32_split_layout_pads_and_transposes():
    """``tf32_split`` on a CPU tensor is the plain version: (2, R, Cp), or
    (2, C, Rp) transposed, rows padded with zeros to a multiple of 4."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 37)).astype(np.float32))
    parts = fc.tf32_split(x)
    tparts = fc.tf32_split(x, transpose=True)
    assert tuple(parts.shape) == (2, 5, 40) and tuple(tparts.shape) == (2,
                                                                        37, 8)
    assert not parts[:, :, 37:].any() and not tparts[:, :, 5:].any()
    assert torch.equal(tparts[:, :, :5], parts[:, :, :37].transpose(1, 2))
    err = (x.double() - parts[0, :, :37].double() - parts[1, :, :37].double())
    assert (err.abs() <= 2.0 ** -22 * x.double().abs()).all()
    with pytest.raises(ValueError, match="CUDA"):
        fc.KERNEL.split(x)


def test_three_tf32_passes_keep_float32_digits():
    """The kernel's arithmetic emulated in float64 from the split parts,
    hi@hi + hi@lo + lo@hi (exact products, sums rounded far below float32),
    gives the loss within 1e-6 of the float64 dense loss at qwen2-7b's D;
    one pass (hi@hi, TF32 alone) misses it by two orders of magnitude."""
    T, D, V = 64, 3584, 2048
    h, w, labels = _data(T, D, V, seed=7)
    hh, hl = fc.tf32_split_ref(torch.from_numpy(h)).double()
    wh, wl = fc.tf32_split_ref(torch.from_numpy(w)).double()
    lab = torch.from_numpy(labels).long()

    def loss(z):
        return torch.logsumexp(z, 1) - z[torch.arange(T), lab]

    dense = loss(torch.from_numpy(h).double() @ torch.from_numpy(w).double())
    scale = dense.abs().max()
    three = loss(hh @ wh + hh @ wl + hl @ wh)
    one = loss(hh @ wh)
    assert (three - dense).abs().max() <= 1e-6 * scale
    assert (one - dense).abs().max() > 1e-4 * scale


@pytest.mark.parametrize("T,D,V,tb,vb", SHAPES)
def test_bf16_forward_matches_reference_at_each_variant(T, D, V, tb, vb):
    """bf16 at the reference's shapes: the plain version at the split of
    the variant the card would run (the tensor-core kernel's 256-column
    tiles where TMA can load, else the FFMA kernel's) against the Pallas
    kernel in interpret mode, within 1e-5 as in f32: the same rounded
    inputs, products exact in f32, the f32 sums in another order."""
    data = _data(T, D, V, seed=5)
    rh, rw, rl = _ref(*data, dtype=jnp.bfloat16)
    want = np.asarray(ref.fused_ce_forward(rh, rw, rl, t_blk=tb, v_blk=vb,
                                           interpret=True))
    h, w, labels = _port(*data, dtype=torch.bfloat16)
    assert fc.variant(h, w) == ("ffma" if V * 2 % 16 else "wgmma")
    for v_blk in (vb, None):
        got = fc.fused_ce_forward(h, w, labels, t_blk=tb, v_blk=v_blk)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


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
