"""The rest shape classes of the port's quantized linear against the JAX
package on the CPU: group sizes that the codes per 32-bit word do not divide
(3/4-bit gs % 8, 2-bit gs % 16, 8-bit gs % 4, so a word straddles groups) and
a partial last group, which the JAX package lays out as kpair, kquad or
planar. The same packed words, made from a seed with NumPy through the port's
``ops/packing.py``, go through ``from_packed`` and ``matmul`` of both packages
(the plain version here; the card's kernels are held to it by the ``cuda``
tests). Also: the card's shape check takes these layers, and the static
choice between the tensor-core and the SIMT tile kernels (the tensor cores
for bf16/f16 at every group size)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu_torch.ops import gemm as tgemm
from autogptq_tpu_torch.ops import packing as tpacking
from autogptq_tpu_torch.ops import quantlinear as tqlin

# (bits, K, N, group size, desc_act, the JAX layout from_packed picks)
CASES = [(4, 64, 64, 4, False, "kpair"), (4, 96, 64, 12, False, "kpair"),
         (4, 256, 64, 100, False, "kpair"),        # groups of 100, 100 and 56 rows
         (3, 96, 64, 12, False, "kpair"), (2, 64, 64, 8, False, "kquad"),
         (2, 96, 64, 24, False, "kquad"), (8, 32, 64, 2, False, "planar"),
         (8, 60, 64, 6, False, "planar"), (4, 96, 64, 12, True, "kpair")]


def _packed(seed, bits, k, n, gs, desc_act):
    """Checkpoint tensors of one layer: codes, zero points and fp16 scales
    drawn from ``seed``, packed by the port's packing module."""
    rng = np.random.default_rng(seed)
    groups = -(-k // gs)
    g_idx = np.arange(k) // gs
    if desc_act:
        g_idx = rng.permutation(g_idx)
    return dict(
        qweight=tpacking.pack_qweight(rng.integers(0, 2 ** bits, size=(k, n)), bits),
        qzeros=tpacking.pack_qzeros(rng.integers(1, 2 ** bits, size=(groups, n)), bits),
        scales=(rng.uniform(0.5, 1.5, size=(groups, n)) / k).astype(np.float16),
        g_idx=g_idx.astype(np.int32), bias=rng.standard_normal(n).astype(np.float32))


def _layers(t, bits, k, n, gs):
    fields = dict(bits=bits, group_size=gs, in_features=k, out_features=n)
    jl = jqlin.from_packed(jqlin.PackedQuantLinear(
        **{name: jnp.asarray(v) for name, v in t.items()}, **fields))
    tl = tqlin.from_packed(tqlin.PackedQuantLinear(**t, **fields), device="cpu",
                           dtype=torch.float32)
    return jl, tl


@pytest.mark.parametrize("bits, k, n, gs, desc_act, layout", CASES)
def test_rest_class_matches_jax(bits, k, n, gs, desc_act, layout):
    """The dequantized weight equals JAX's ``logical_weight`` and ``matmul``
    (plain version) JAX's ``matmul_xla``, f32, within 1e-5 relative."""
    t = _packed(bits * 1000 + gs, bits, k, n, gs, desc_act)
    jl, tl = _layers(t, bits, k, n, gs)
    assert jl.layout == layout
    np.testing.assert_array_equal(tqlin.logical_weight(tl).numpy(),
                                  np.asarray(jqlin.logical_weight(jl, jnp.float32)))
    x = np.random.default_rng(gs).standard_normal((5, k)).astype(np.float32)
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x), jl))
    got = tqlin.matmul(torch.from_numpy(x), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_rest_class_gradient_matches_jax_grad():
    """The gradient through ``QuantMatmul`` (backward: K10's plain version) at
    a straddling desc_act layer equals ``jax.grad`` through JAX's XLA route."""
    bits, k, n, gs = 4, 96, 64, 12
    jl, tl = _layers(_packed(7, bits, k, n, gs, True), bits, k, n, gs)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    cot = rng.standard_normal((2, 3, n)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (tqlin.matmul(xt, tl) * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(jax.grad(lambda xx: jnp.sum(jqlin.matmul(xx, jl, backend="xla") * cot))(
        jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bits, k, n, gs, desc_act, layout", CASES)
def test_card_shape_check_takes_rest_classes(bits, k, n, gs, desc_act, layout):
    """Every group size a GPTQ checkpoint can hold passes the card's check,
    and the split-K plan of the decode regime cuts K into whole words."""
    tqlin.check_card_shape(bits, k, n, gs)
    pack = 32 // tqlin.storage_bits(bits)
    kc, splits = tgemm.split_k(k, n, gs, 132, pack)
    assert kc % pack == 0 and (splits - 1) * kc < k <= splits * kc


@pytest.mark.parametrize("dtype, m, gs, route", [
    (torch.bfloat16, 17, 128, "mma"), (torch.float16, 2048, 16, "mma"),
    (torch.bfloat16, 64, 4096, "mma"), (torch.float16, 129, 32, "mma"),
    (torch.float32, 2048, 128, "simt"), (torch.float32, 17, 16, "simt"),
    (torch.bfloat16, 16, 128, "mma"), (torch.float16, 1, 128, "mma"),
    (torch.bfloat16, 2048, 24, "mma"), (torch.float16, 70, 100, "mma"),
    (torch.bfloat16, 70, 12, "mma"), (torch.bfloat16, 1, 24, "mma"),
    (torch.float16, 16, 6, "mma"), (torch.bfloat16, 4, 172, "mma"),
    (torch.float32, 1, 128, "simt"), (torch.float32, 16, 100, "simt"),
    (torch.float32, 70, 12, "simt")])
def test_tile_kernel_plan(dtype, m, gs, route):
    """The tile kernel is the tensor cores' for bf16/f16 at every group size
    (``route`` "mma" here; over GPTQ words the wgmma/TMA one,
    ``"wgmma"``) and the SIMT kernel for f32; K1/K4/K5's forward takes it above
    16 rows (at M <= 16 :func:`route` sends it to a GEMV), and so does K10
    (:func:`t_route`), whose bf16/f16 cotangents of at most 16 rows take its
    decode regime, ``"gemv"``, at every group size."""
    tile = "wgmma" if route == "mma" else route
    assert tgemm.tile_kernel(dtype) == tile
    if m > tgemm.DECODE_MAX_M:
        assert tgemm.route(dtype, m, gs) == tile
    assert tgemm.t_route(dtype, m) == (
        "gemv" if route == "mma" and m <= tgemm.DECODE_MAX_M else tile)


def test_tile_kernel_override():
    """``kernel`` names a tile kernel whatever the plan (chip_smoke.py times
    both on the same weights); anything else raises."""
    assert tgemm.tile_kernel(torch.bfloat16, "simt") == "simt"
    assert tgemm.tile_kernel(torch.float32, "mma") == "mma"
    assert tgemm.tile_kernel(torch.float32, "wgmma") == "wgmma"
    with pytest.raises(ValueError, match="kernel must be"):
        tgemm.tile_kernel(torch.bfloat16, "tile")
