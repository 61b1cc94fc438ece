"""The port's quantized linear (autogptq_tpu_torch.ops.quantlinear / gemm)
against the JAX package's at 2, 3, 4 and 8 bits: dequantized weights exactly,
the plain matmul against matmul_xla, the kb32 Pallas kernel in interpret mode,
and every JAX runtime layout carried across by params_from_jax. Inputs are
made with NumPy from a seed and handed to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.ops import packing as jpacking
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu.ops.pallas import gemm as jgemm
from autogptq_tpu_torch.ops import gemm as tgemm
from autogptq_tpu_torch.ops import packing as tpacking
from autogptq_tpu_torch.ops import quantlinear as tqlin
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors


def _layers(seed, k, n, bits=4, gs=32, desc_act=False, bias=False):
    """The same random checkpoint layer as a JAX and a port QuantLinear."""
    rng = np.random.default_rng(seed)
    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    fields = dict(bits=bits, group_size=gs, in_features=k, out_features=n)
    jl = jqlin.from_packed(jqlin.PackedQuantLinear(
        qweight=jnp.asarray(t["qweight"]), qzeros=jnp.asarray(t["qzeros"]),
        scales=jnp.asarray(t["scales"]), g_idx=jnp.asarray(t["g_idx"]),
        bias=None if b is None else jnp.asarray(b), **fields))
    tl = tqlin.from_packed(tqlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=b, **fields), device="cpu", dtype=torch.float32)
    return jl, tl, t


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("gs, desc_act", [(32, False), (32, True), (-1, False), (64, False),
                                          (64, True), (128, False), (128, True)])
def test_logical_weight_exact(bits, gs, desc_act):
    jl, tl, _ = _layers(bits, 256, 128, bits, gs, desc_act)
    want = np.asarray(jqlin.logical_weight(jl, jnp.float32))
    got = tqlin.logical_weight(tl, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    assert tl.qweight.shape == (256 * tqlin.storage_bits(bits) // 32, 128)
    assert int(tqlin.codes(tl).max()) < 2 ** bits


def _with_stored_zero(t, bits, stored):
    """The layer's tensors with the stored zero point of (group 0, column 0)
    set to ``stored``."""
    raw = (tpacking.unpack_qzeros(t["qzeros"], bits).astype(np.int64) - 1) % (1 << bits)
    raw[0, 0] = stored
    return dict(t, qzeros=tpacking.pack_qzeros(raw + 1, bits))


@pytest.mark.parametrize("bits, stored, effective", [(3, 7, 8), (8, 255, 0), (2, 3, 0),
                                                     (4, 15, 0)])
def test_extreme_zero_points(bits, stored, effective):
    """A stored 3-bit zero of 7 is the effective zero 8 (not re-masked: it
    fits no nibble, so it lives in the uint8 zeros); a stored 8-bit 255 wraps
    to 0, as every power-of-two width's top value does."""
    _, _, t = _layers(bits, 128, 64, bits, 32)
    t = _with_stored_zero(t, bits, stored)
    fields = dict(bits=bits, group_size=32, in_features=128, out_features=64)
    jl = jqlin.from_packed(jqlin.PackedQuantLinear(
        qweight=jnp.asarray(t["qweight"]), qzeros=jnp.asarray(t["qzeros"]),
        scales=jnp.asarray(t["scales"]), g_idx=jnp.asarray(t["g_idx"]), bias=None, **fields))
    tl = tqlin.from_packed(tqlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=None, **fields), device="cpu", dtype=torch.float32)
    assert int(tl.zeros[0, 0]) == effective and tl.zeros.dtype == torch.uint8
    np.testing.assert_array_equal(tqlin.logical_weight(tl).numpy(),
                                  np.asarray(jqlin.logical_weight(jl, jnp.float32)))
    x = np.random.default_rng(0).standard_normal((3, 128)).astype(np.float32)
    np.testing.assert_allclose(tqlin.matmul(torch.from_numpy(x), tl).numpy(),
                               np.asarray(jqlin.matmul_xla(jnp.asarray(x), jl)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 3, 8])
@pytest.mark.parametrize("gs, desc_act", [(32, True), (128, False), (-1, False)])
def test_matmul_matches_xla_other_widths(bits, gs, desc_act):
    """f32 on both sides, the same dequantized weight: summation order only."""
    jl, tl, _ = _layers(bits + 20, 256, 128, bits, gs, desc_act, bias=True)
    x = np.random.default_rng(bits).standard_normal((5, 256)).astype(np.float32)
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x), jl))
    got = tqlin.matmul(torch.from_numpy(x), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, tqlin.matmul_plain(torch.from_numpy(x), tl).numpy())


@pytest.mark.parametrize("desc_act", [False, True])
@pytest.mark.parametrize("m", [1, 33])
@pytest.mark.parametrize("bias", [False, True])
def test_matmul_matches_xla(desc_act, m, bias):
    jl, tl, _ = _layers(7, 256, 128, 4, 32, desc_act, bias)
    x = np.random.default_rng(m).standard_normal((m, 256)).astype(np.float32)
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x), jl))
    got = tqlin.matmul(torch.from_numpy(x), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m, desc_act", [(1, False), (33, True)])
def test_matmul_matches_kb32_kernel_interpret(m, desc_act):
    jl, tl, _ = _layers(11, 1024, 128, 4, 128, desc_act)
    assert jl.layout == "kb32"
    x = np.random.default_rng(m).standard_normal((m, 1024)).astype(np.float32)
    want = np.asarray(jgemm.matmul_pallas(jnp.asarray(x), jl, interpret=True,
                                          dot_dtype=jnp.float32))
    got = tqlin.matmul(torch.from_numpy(x), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_trivial_order_keeps_checkpoint_words():
    _, tl, t = _layers(3, 512, 256, 4, 128)
    assert tl.kperm is None
    np.testing.assert_array_equal(tl.qweight.numpy(), t["qweight"])
    assert tl.scales.dtype == torch.float16 and tl.zeros.dtype == torch.uint8


def test_desc_act_sorts_rows_into_groups():
    jl, tl, t = _layers(4, 256, 128, 4, 32, desc_act=True)
    np.testing.assert_array_equal(tl.kperm.numpy(), np.asarray(jl.kperm)[:256])
    sorted_groups = t["g_idx"][tl.kperm.numpy()]
    np.testing.assert_array_equal(sorted_groups, np.arange(256) // 32)


@pytest.mark.parametrize("layout_k, desc_act", [(1024, False), (1024, True), (256, True)])
def test_params_from_jax_matches_from_packed(layout_k, desc_act):
    jl, tl, _ = _layers(5, layout_k, 128, 4, 128 if layout_k == 1024 else 32, desc_act)
    assert jl.layout == ("kb32" if layout_k == 1024 else "ki32")
    conv = params_from_jax({"layer": jl}, device="cpu", dtype=torch.float32)["layer"]
    for name in ("qweight", "scales", "zeros"):
        assert torch.equal(getattr(conv, name), getattr(tl, name)), name
    assert (conv.kperm is None) == (tl.kperm is None)
    if tl.kperm is not None:
        assert torch.equal(conv.kperm, tl.kperm)


@pytest.mark.parametrize("layout, bits, k, gs, desc_act", [
    ("kpair", 4, 256, 16, False),        # a group size that 32 does not divide
    ("kpair", 3, 256, 16, True),
    ("k2i32", 2, 256, 128, False),
    ("k2i32", 2, 256, 128, True),
    ("kquad", 2, 256, 32, True),
    ("planar", 8, 256, 32, True),
    ("planar", 8, 256, -1, False),
    ("planar", 2, 256, 2, False),        # the 2-bit rest class: a group size 4 does not divide
    ("koct", 8, 256, 64, False),
])
def test_params_from_jax_other_layouts(layout, bits, k, gs, desc_act):
    """Every JAX runtime layout the other widths produce carries across: the
    converted layer dequantizes to the JAX layer's logical weight exactly."""
    rng = np.random.default_rng(k + bits)
    n = 128
    g = 1 if gs == -1 else k // gs
    codes = rng.integers(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    zeros = rng.integers(1, 2 ** bits, size=(g, n))
    g_idx = (np.arange(k) // (k if gs == -1 else gs)).astype(np.int32)
    if desc_act:
        g_idx = rng.permutation(g_idx).astype(np.int32)
    qweight = jpacking.pack_qweight(codes, bits)
    jl = jqlin.from_packed(jqlin.PackedQuantLinear(
        qweight=jnp.asarray(qweight), qzeros=jnp.asarray(jpacking.pack_qzeros(zeros, bits)),
        scales=jnp.asarray((rng.random((g, n)) * 0.05 + 0.01).astype(np.float16)),
        g_idx=jnp.asarray(g_idx), bias=None, bits=bits, group_size=gs, in_features=k,
        out_features=n), layout=None if layout != "koct" else "koct")
    assert jl.layout == layout
    conv = params_from_jax({"layer": jl}, device="cpu", dtype=torch.float32)["layer"]
    assert conv.qweight.dtype == torch.int32 and conv.zeros.dtype == torch.uint8
    np.testing.assert_array_equal(tqlin.logical_weight(conv).numpy(),
                                  np.asarray(jqlin.logical_weight(jl, jnp.float32)))


def test_params_from_jax_carries_an_unquantized_node():
    from autogptq_tpu.models.arch import DenseLinear as JaxDense
    from autogptq_tpu_torch.models.arch import DenseLinear, apply_linear

    rng = np.random.default_rng(0)
    kernel = rng.standard_normal((16, 8)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    tree = {"lin": JaxDense(kernel=jnp.asarray(kernel), bias=jnp.asarray(bias)),
            "norm": {"weight": jnp.ones(16)}, "layers": [JaxDense(kernel=jnp.asarray(kernel),
                                                                   bias=None)]}
    conv = params_from_jax(tree, device="cpu", dtype=torch.float32)
    assert isinstance(conv["lin"], DenseLinear) and conv["layers"][0].bias is None
    x = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    np.testing.assert_allclose(apply_linear(conv["lin"], x).numpy(),
                               x.numpy() @ kernel + bias, rtol=1e-6, atol=1e-6)
    assert conv["norm"]["weight"].shape == (16,)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_wrapper_takes_plain_version_on_cpu(bits):
    _, tl, _ = _layers(6, 256, 128, bits, 32, desc_act=True, bias=True)
    x = torch.randn(5, 256, generator=torch.Generator().manual_seed(0))
    wrapper = {2: tgemm.w2a16_matmul, 4: tgemm.w4a16_matmul, 8: tgemm.w8a16_matmul}[bits]
    plain = {2: tgemm.w2a16_matmul_ref, 4: tgemm.w4a16_matmul_ref,
             8: tgemm.w8a16_matmul_ref}[bits]
    args = (x, tl.qweight, tl.scales, tl.zeros, tl.kperm, tl.bias, tl.group_size)
    assert torch.equal(wrapper(*args), plain(*args))
    assert tgemm.wna16_matmul(x[:0], *args[1:], bits).shape == (0, 128)


@pytest.mark.parametrize("bits, k, gs, word", [(4, 252, 12, "w4a16_gemm"), (3, 250, -1, "w4a16_gemm"),
                                               (2, 248, 8, "w2a16_gemm"), (8, 250, -1, "w8a16_gemm")])
def test_cuda_refuses_layers_without_a_kernel(bits, k, gs, word):
    """On the card a shape that no GPTQ checkpoint can hold (K or N not a
    whole number of 32-bit words at ``bits``) raises before anything is moved
    or launched; every group size is taken. On the CPU the plain version takes
    any shape."""
    packed = tqlin.PackedQuantLinear(
        qweight=np.zeros((1, 128), np.int32), qzeros=np.zeros((1, 1), np.int32),
        scales=np.ones((1, 128), np.float16), g_idx=np.zeros(k, np.int32), bias=None, bits=bits,
        group_size=gs, in_features=k, out_features=128)
    with pytest.raises(NotImplementedError, match=f"{word} takes {bits}-bit layers.*whole 32-bit"):
        tqlin.from_packed(packed, device="cuda")
    with pytest.raises(NotImplementedError, match="whole 32-bit words"):
        tqlin.check_card_shape(bits, k, 130, -1 if gs == -1 else 32)
    tqlin.check_card_shape(bits, 32 * k, 128, gs)   # the same group size, whole words


@pytest.mark.parametrize("pack", [8, 16, 4])
@pytest.mark.parametrize("k, n, gs", [(4096, 4096, 128), (4096, 11008, 128),
                                      (11008, 4096, 128), (4096, 4096, 4096), (256, 128, 32),
                                      (11008, 4096, 11008), (4096, 4096, 16), (4096, 4096, 64)])
def test_split_k_covers_k(k, n, gs, pack):
    kc, splits = tgemm.split_k(k, n, gs, 132, pack)
    assert kc % pack == 0 and kc <= tgemm.MAX_KCHUNK
    assert (splits - 1) * kc < k <= splits * kc
    if gs <= tgemm.MAX_KCHUNK:
        assert kc % gs == 0
