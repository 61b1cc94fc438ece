"""The port's scale/zero search (autogptq_tpu_torch.quantization.quantizer)
against the JAX package's on the same NumPy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.quantization import quantizer as jq
from autogptq_tpu_torch.quantization import quantizer as tq


def _weights(seed, rows=24, cols=64):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((rows, cols)).astype(np.float32)
    w[3] = 0.0                    # a degenerate all-zero row
    w[5] = np.abs(w[5])           # a row without negatives
    return w


def _codes(w, scale, zero, maxq):
    return np.clip(np.round(w / scale[:, None]) + zero[:, None], 0, maxq)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("mse", [False, True])
def test_find_params_matches_jax(bits, sym, mse):
    w = _weights(bits * 4 + sym * 2 + mse)
    js, jz = jq.find_params(jnp.asarray(w), jq.QuantizerConfig(bits=bits, sym=sym, mse=mse))
    ts, tz = tq.find_params(torch.from_numpy(w), tq.QuantizerConfig(bits=bits, sym=sym, mse=mse))
    assert ts.dtype == torch.float32 and ts.shape == (w.shape[0],)
    # the same f32 arithmetic in the same order; XLA's division may differ in the last bit
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=0)
    maxq = (1 << bits) - 1
    np.testing.assert_array_equal(_codes(w, ts.numpy(), tz.numpy(), maxq),
                                  _codes(w, np.asarray(js), np.asarray(jz), maxq))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quantize_rtn_matches_jax(bits):
    w = _weights(bits)
    maxq = (1 << bits) - 1
    scale, zero = tq.find_params(torch.from_numpy(w), tq.QuantizerConfig(bits=bits, sym=False))
    got = tq.quantize_rtn(torch.from_numpy(w), scale[:, None], zero[:, None], maxq).numpy()
    want = np.asarray(jq.quantize_rtn(jnp.asarray(w), jnp.asarray(scale.numpy())[:, None],
                                      jnp.asarray(zero.numpy())[:, None], maxq))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    codes = got / scale.numpy()[:, None] + zero.numpy()[:, None]
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-3)
    assert codes.min() >= -1e-3 and codes.max() <= maxq + 1e-3


@pytest.mark.parametrize("sym", [True, False])
def test_find_params_tensor_matches_jax(sym):
    w = _weights(11)
    js, jz = jq.find_params_tensor(jnp.asarray(w), jq.QuantizerConfig(bits=4, sym=sym))
    ts, tz = tq.find_params_tensor(torch.from_numpy(w), tq.QuantizerConfig(bits=4, sym=sym))
    assert ts.dim() == 0
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-6)
