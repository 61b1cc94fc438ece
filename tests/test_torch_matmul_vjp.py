"""The backward of the port's quantized matmul (``quantlinear.matmul_t``, the
plain version of K10 ``gemm.wna16_matmul_t_ref`` and the autograd Function
``quantlinear.QuantMatmul``) against the JAX package: its XLA transpose in
f32, and its K10 Pallas kernels run in interpret mode on the kb32, ki32 and
kpair layouts (those dot in bf16, hence the JAX tests' own 2e-2). Inputs are
made with NumPy from a seed and handed to both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu_torch.ops import gemm as tgemm
from autogptq_tpu_torch.ops import quantlinear as tqlin
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors


def _layers(seed, k, n, bits=4, gs=32, desc_act=False, bias=False, layout=None):
    """The same random checkpoint layer as a JAX and a port QuantLinear."""
    rng = np.random.default_rng(seed)
    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    fields = dict(bits=bits, group_size=gs, in_features=k, out_features=n)
    jl = jqlin.from_packed(jqlin.PackedQuantLinear(
        qweight=jnp.asarray(t["qweight"]), qzeros=jnp.asarray(t["qzeros"]),
        scales=jnp.asarray(t["scales"]), g_idx=jnp.asarray(t["g_idx"]),
        bias=None if b is None else jnp.asarray(b), **fields), layout=layout)
    tl = tqlin.from_packed(tqlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=b, **fields), device="cpu", dtype=torch.float32)
    return jl, tl


def _cotangent(seed, m, n):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("gs, desc_act", [(32, False), (32, True), (-1, False)])
def test_matmul_t_matches_xla(bits, gs, desc_act):
    """f32 on both sides and the same dequantized weight: summation order
    only. desc_act undoes kperm (the JAX scatter-add, the port's store)."""
    k, n = 256, 128
    jl, tl = _layers(bits * 7 + gs, k, n, bits, gs, desc_act)
    g = _cotangent(bits, 5, n)
    want = np.asarray(jqlin.matmul_t(jnp.asarray(g), jl, k, backend="xla"))
    got = tqlin.matmul_t(torch.from_numpy(g), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("layout, k, n, gs", [("kb32", 1024, 128, 128), ("ki32", 256, 128, 64),
                                              ("kpair", 256, 128, 16)])
@pytest.mark.parametrize("desc_act", [False, True])
def test_matmul_t_matches_pallas_interpret(layout, k, n, gs, desc_act):
    """The JAX K10 kernels of each 4-bit layout, run as the JAX package's own
    tests run them on the CPU: their dot is bf16, so 2e-2 of the largest
    output, as ``tests/test_kb32.py`` and ``tests/test_ki32.py`` allow."""
    jl, tl = _layers(k + gs, k, n, 4, gs, desc_act)
    assert jl.layout == layout
    g = _cotangent(gs, 6, n)
    want = np.asarray(jqlin.matmul_t(jnp.asarray(g), jl, k, backend="pallas_interpret"))
    got = tqlin.matmul_t(torch.from_numpy(g), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("desc_act", [False, True])
def test_autograd_function_matches_plain_autograd(bits, desc_act):
    """The gradient through ``matmul`` (the autograd Function, backward
    ``matmul_t``) equals autograd through ``matmul_plain``, and JAX's
    ``jax.grad`` through ``matmul(backend="xla")``; the layer's tensors
    take no gradient."""
    k, n = 256, 128
    jl, tl = _layers(bits + 40, k, n, bits, 32, desc_act, bias=True)
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    cot = rng.standard_normal((2, 3, n)).astype(np.float32)
    grads = []
    for fn in (tqlin.matmul, tqlin.matmul_plain):
        xt = torch.from_numpy(x).requires_grad_()
        (fn(xt, tl) * torch.from_numpy(cot)).sum().backward()
        grads.append(xt.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    want = jax.grad(lambda xx: jnp.sum(jqlin.matmul(xx, jl, backend="xla") * cot))(
        jnp.asarray(x))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    assert tl.bias.grad is None and not tl.scales.requires_grad


def test_no_graph_without_a_gradient():
    """An input that needs no gradient records nothing (generate, quantize)."""
    _, tl = _layers(1, 256, 128)
    x = torch.randn(3, 256)
    assert not tqlin.matmul(x, tl).requires_grad
    with torch.inference_mode():
        assert not tqlin.matmul(x.requires_grad_(), tl).requires_grad


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_wrapper_takes_plain_version_on_cpu(bits):
    _, tl = _layers(6, 256, 128, bits, 32, desc_act=True)
    g = torch.randn(5, 128, generator=torch.Generator().manual_seed(0))
    wrapper = {2: tgemm.w2a16_matmul_t, 4: tgemm.w4a16_matmul_t, 8: tgemm.w8a16_matmul_t}[bits]
    args = (tl.qweight, tl.scales, tl.zeros, tl.kperm, tl.group_size)
    got = wrapper(g, *args)
    assert torch.equal(got, tgemm.wna16_matmul_t_ref(g, *args, bits))
    assert got.shape == (5, 256) and got.dtype == g.dtype
    assert tgemm.wna16_matmul_t(g[:0], *args, bits).shape == (0, 256)
    assert tgemm.wna16_matmul_t(g.bfloat16(), *args, bits).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="2-, 4- or 8-bit"):
        tgemm.wna16_matmul_t(g, *args, 3)
