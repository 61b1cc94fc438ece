"""The port's GPTQ pack/unpack (autogptq_tpu_torch.ops.packing) is bit-exact
with the JAX package's and with the checked-in golden vectors."""

import os

import numpy as np
import pytest

from autogptq_tpu.ops import packing as jpacking
from autogptq_tpu_torch.ops import packing as tpacking
from autogptq_tpu_torch.ops import quantlinear as tqlin

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_quantlinear.npz")


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_unpack_bit_exact(bits):
    rng = np.random.default_rng(bits)
    k, n, g = 64, 32, 2
    iw = rng.integers(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    zeros = rng.integers(0, 2 ** bits, size=(g, n)).astype(np.int64)   # includes the 0 wrap
    qw = tpacking.pack_qweight(iw, bits)
    np.testing.assert_array_equal(qw, jpacking.pack_qweight(iw, bits))
    np.testing.assert_array_equal(tpacking.unpack_qweight(qw, bits), iw)
    qz = tpacking.pack_qzeros(zeros, bits)
    np.testing.assert_array_equal(qz, jpacking.pack_qzeros(zeros, bits))
    np.testing.assert_array_equal(tpacking.unpack_qzeros(qz, bits),
                                  jpacking.unpack_qzeros(qz, bits))
    scales = (rng.random((g, n)) * 0.05 + 0.01).astype(np.float16)
    g_idx = rng.permutation(np.arange(k) // (k // g)).astype(np.int32)
    np.testing.assert_array_equal(
        tpacking.dequantize(qw, qz, scales, g_idx, bits),
        jpacking.dequantize(qw, qz, scales, g_idx, bits))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_golden_vectors(bits):
    golden = np.load(FIXTURE)
    x = golden["x"]
    args = (golden[f"qweight_{bits}"], golden[f"qzeros_{bits}"], golden[f"scales_{bits}"],
            golden[f"g_idx_{bits}"], bits)
    w = tpacking.dequantize(*args)
    np.testing.assert_array_equal(w, jpacking.dequantize(*args))
    np.testing.assert_allclose(x @ w, golden[f"y_{bits}"], rtol=3e-5, atol=2e-5)
    # the runtime layout's plain matmul reproduces the golden outputs too
    k, n = x.shape[1], golden[f"scales_{bits}"].shape[1]
    layer = tqlin.from_packed(tqlin.PackedQuantLinear(
        qweight=args[0], qzeros=args[1], scales=args[2], g_idx=args[3], bias=None,
        bits=bits, group_size=32, in_features=k, out_features=n), device="cpu")
    import torch

    y = tqlin.matmul(torch.from_numpy(x), layer).numpy()
    np.testing.assert_allclose(y, golden[f"y_{bits}"], rtol=3e-5, atol=2e-4)


def _solver_outputs(bits, k=96, n=64, gs=32, seed=0):
    """Fake-quantized weights [K, N] with per-group params, as the solver
    leaves them, some of them on rounding edges (code + 0.5)."""
    rng = np.random.default_rng(seed)
    g = k // gs
    scales = (rng.random((g, n)) * 0.05 + 0.01).astype(np.float32)
    zeros = rng.integers(0, 2 ** bits, size=(g, n)).astype(np.float32)
    g_idx = rng.permutation(np.arange(k) // gs).astype(np.int32)
    q = rng.integers(0, 2 ** bits, size=(k, n)).astype(np.float32)
    q[::7] += 0.5
    q[3] = 1000.0                      # clips to maxq
    w = (scales[g_idx] * (q - zeros[g_idx])).astype(np.float32)
    return w, scales, zeros, g_idx


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_layer_and_rtn_bit_exact(bits):
    w, scales, zeros, g_idx = _solver_outputs(bits)
    np.testing.assert_array_equal(
        tpacking.quantize_weight_rtn(w, scales, zeros, g_idx, bits),
        jpacking.quantize_weight_rtn(w, scales, zeros, g_idx, bits))
    for gi in (g_idx, None):
        got = tpacking.pack_layer(w, scales, zeros, gi, bits, 32)
        want = jpacking.pack_layer(w, scales, zeros, gi, bits, 32)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_from_solver_bit_exact(bits):
    """The port computes the codes with torch in float64 (on the card during
    quantize) and packs on the host; the JAX package does both in NumPy."""
    import jax.numpy as jnp
    import torch
    from autogptq_tpu.ops import quantlinear as jqlin

    w, scales, zeros, g_idx = _solver_outputs(bits, seed=bits)
    zeros = zeros + np.float32(1e-3)          # the solver's zeros are rounded by the pack
    bias = np.arange(w.shape[1], dtype=np.float32)
    want = jqlin.pack_from_solver(np.ascontiguousarray(w.T), scales, zeros, g_idx, bits, 32, bias)
    for conv in (np.asarray, torch.from_numpy):
        got = tqlin.pack_from_solver(conv(np.ascontiguousarray(w.T)), conv(scales), conv(zeros),
                                     conv(g_idx), bits, 32, bias)
        for name in ("qweight", "qzeros", "scales", "g_idx", "bias"):
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)
        assert (got.in_features, got.out_features) == (96, 64)
    layer = tqlin.from_packed(got, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(
        tqlin.logical_weight(layer).numpy(),
        np.asarray(jqlin.logical_weight(jqlin.from_packed(want), jnp.float32)))
