"""K1's fused RMS-norm prologue (``AUTOGPTQ_TPU_FUSE_NORM``) in the port, on the
CPU against the JAX package (f32, inputs from a numpy seed).

* The port's plain fused matmul (``quantlinear.matmul(prenorm=)``) against the
  JAX kernel ``matmul_pallas(..., interpret=True, prenorm=)`` dotting in f32,
  at ``tests/test_fuse_norm.py``'s eligible shapes (kb32 K 1024 g128, with
  ``plus_one``; ki32 K 256 g64) and a 3-bit case: within 2e-5 of the largest
  output (the two sum the K products in different orders), and bit for bit the
  port's own unfused route.
* ``gemm.prenorm_eligible`` against the JAX rule, case by case: desc_act,
  gs % 32 != 0, 2- and 8-bit, kb32l, M = 32 and 64 and a norm weight shorter
  than K are ineligible in both packages (the JAX ``matmul_pallas`` takes its
  unfused ``rms_apply``), and the port's result there is its unfused result.
* ``gemm.rms_apply`` equals ``arch.rms_norm`` bit for bit, and the JAX
  ``rms_apply`` to 1e-6 (XLA sums the squares in another order: 1 ulp apart).
* A tiny random 2-layer Llama (g32, no desc_act): greedy and paged beam-2
  tokens with the switch on equal those with it off and the JAX package's
  with ``FUSE_NORM = "1"`` (its interpret-mode kernels); a spy shows the
  port's fused route fired on eligible calls only. A tiny Mixtral never takes it.
* The fused route raises under autograd rather than drop a gradient.
* ``cuda``-marked: each route's fused kernel against its plain version on the
  card (bf16/f16 1% of the largest output, f32 1e-5 of it, bit-equal on a
  second call, one launch of its own key); skipped without a card. On the
  card: ``python -m pytest tests/test_torch_fuse_norm.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu.ops.pallas import gemm as jgemm
from autogptq_tpu.utils import generation as jgen
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.models import params as params_lib
from autogptq_tpu_torch.ops import build, gemm
from autogptq_tpu_torch.ops import quantlinear as qlin
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors, \
    write_random_checkpoint

from test_torch_llama import TINY
from test_torch_moe import TINY as TINY_MIXTRAL

EPS = 1e-6
RTOL = 2e-5     # of the largest output: f32 on both sides, the K products summed in another order


def _pair(k, n, bits, gs, desc_act=False, layout=None, seed=0):
    """One layer from the same checkpoint tensors in both packages, f32 on the CPU."""
    rng = np.random.default_rng(seed + k + n + bits + gs)
    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    kw = dict(bits=bits, group_size=gs, in_features=k, out_features=n)
    port = qlin.PackedQuantLinear(qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"],
                                  g_idx=t["g_idx"], bias=None, **kw)
    ref = jqlin.PackedQuantLinear(qweight=jnp.asarray(t["qweight"]),
                                  qzeros=jnp.asarray(t["qzeros"]),
                                  scales=jnp.asarray(t["scales"]), g_idx=jnp.asarray(t["g_idx"]),
                                  bias=None, **kw)
    ref = jqlin.from_packed(ref, layout=layout) if layout else jqlin.from_packed(ref)
    return qlin.from_packed(port, device="cpu", dtype=torch.float32,
                            layout=layout or "gptq"), ref


def _inputs(m, k, norm_len=None, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 3.0).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(norm_len or k)).astype(np.float32)
    return x, w


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _jax_prenorm(monkeypatch, x, ref, w, plus_one):
    """The JAX kernel's result and whether it took its unfused branch."""
    unfused = []
    real = jgemm.rms_apply
    monkeypatch.setattr(jgemm, "rms_apply", lambda *a: unfused.append(1) or real(*a))
    out = jgemm.matmul_pallas(jnp.asarray(x), ref, interpret=True, dot_dtype=jnp.float32,
                              prenorm=(jnp.asarray(w), EPS, plus_one))
    return np.asarray(out), bool(unfused)


@pytest.mark.parametrize("k, gs, bits, plus_one, layout", [
    (1024, 128, 4, False, "kb32"),     # tests/test_fuse_norm.py's shapes
    (1024, 128, 4, True, "kb32"),      # gemma's 1 + w
    (256, 64, 4, False, "ki32"),
    (256, 64, 3, False, "ki32"),       # 3-bit codes in nibbles
])
def test_fused_matmul_matches_the_jax_kernel(monkeypatch, k, gs, bits, plus_one, layout):
    port, ref = _pair(k, 2 * k, bits, gs)
    assert ref.layout == layout
    x, w = _inputs(2, k)
    assert gemm.prenorm_eligible(2, k, gs, bits, port.kperm, port.layout, len(w))
    want, unfused = _jax_prenorm(monkeypatch, x, ref, w, plus_one)
    assert not unfused                      # the JAX kernel fused the norm
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(build.launches)
    got = qlin.matmul(tx, port, prenorm=(tw, EPS, plus_one))
    assert dict(build.launches) == before   # a CPU tensor launches nothing
    _close(got.numpy(), want)
    assert torch.equal(got, qlin.matmul(gemm.rms_apply(tx, tw, EPS, plus_one), port))


# (K, N, bits, group size, desc_act, layout, M, norm length)
INELIGIBLE = {
    "desc_act": (1024, 256, 4, 128, True, None, 2, None),
    "gs16": (256, 256, 4, 16, False, None, 2, None),
    "2-bit": (256, 256, 2, 128, False, None, 2, None),
    "8-bit": (256, 256, 8, 64, False, None, 2, None),
    "kb32l": (1024, 256, 4, 128, False, "kb32l", 2, None),
    "M=32": (256, 256, 4, 64, False, None, 32, None),
    "M=64": (256, 256, 4, 64, False, None, 64, None),
    "norm length": (256, 256, 4, 64, False, None, 2, 1),
}


@pytest.mark.parametrize("case", list(INELIGIBLE))
def test_ineligible_calls_take_the_unfused_norm_in_both_packages(monkeypatch, case):
    k, n, bits, gs, desc_act, layout, m, norm_len = INELIGIBLE[case]
    port, ref = _pair(k, n, bits, gs, desc_act, layout)
    x, w = _inputs(m, k, norm_len)
    assert not gemm.prenorm_eligible(m, k, gs, bits, port.kperm, port.layout, len(w))
    want, unfused = _jax_prenorm(monkeypatch, x, ref, w, False)
    assert unfused                          # the JAX rule refuses it too
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = qlin.matmul(tx, port, prenorm=(tw, EPS, False))
    assert torch.equal(got, qlin.matmul(gemm.rms_apply(tx, tw, EPS, False), port))
    _close(got.numpy(), want)


def test_eligibility_rule_by_shape():
    """The rule's own edges, without a layer: eligible 3/4-bit g32..g256 (and one
    group) at M < 32; not 2- or 8-bit, gs 16 or 48, K % 8, a group size not
    dividing K, kperm, kb32l, 32 rows or a norm of another length."""
    ok = gemm.prenorm_eligible
    assert all(ok(m, 4096, gs, bits) for m in (1, 4, 16, 31) for gs in (32, 64, 128, 256, -1)
               for bits in (3, 4))
    assert not any(ok(1, 4096, 128, bits) for bits in (2, 8))
    assert not ok(1, 4096, 16, 4) and not ok(1, 4096, 48, 4) and not ok(1, 4100, -1, 4)
    assert not ok(1, 4128, 128, 4)          # 128 does not divide K
    assert not ok(1, 4096, 128, 4, kperm=torch.arange(4096))
    assert not ok(1, 4096, 128, 4, layout="kb32l") and not ok(32, 4096, 128, 4)
    assert not ok(1, 4096, 128, 4, norm_len=4095)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_apply_equals_rms_norm_and_jax(dtype):
    x, w = _inputs(3, 256)
    tx, tw = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    assert torch.equal(gemm.rms_apply(tx, tw, 1e-5, False), arch.rms_norm(tx, tw, 1e-5))
    assert torch.equal(gemm.rms_apply(tx, tw, 1e-5, True),
                       arch.rms_norm(tx, 1.0 + tw.float(), 1e-5))
    if dtype == torch.float32:
        for plus_one in (False, True):
            want = jgemm.rms_apply(jnp.asarray(x), jnp.asarray(w), 1e-5, plus_one)
            np.testing.assert_allclose(gemm.rms_apply(tx, tw, 1e-5, plus_one).numpy(),
                                       np.asarray(want), rtol=1e-6, atol=1e-6)


def test_prenorm_route_raises_under_autograd():
    port, _ = _pair(256, 128, 4, 64)
    x, w = _inputs(2, 256)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(RuntimeError, match="inference-only"):
        qlin.matmul(tx.clone().requires_grad_(), port, prenorm=(tw, EPS, False))
    with pytest.raises(RuntimeError, match="inference-only"):
        qlin.matmul(tx, port, prenorm=(tw.clone().requires_grad_(), EPS, False))
    with torch.no_grad():
        y = qlin.matmul(tx.clone().requires_grad_(), port, prenorm=(tw, EPS, False))
    assert torch.equal(y, qlin.matmul(gemm.rms_apply(tx, tw, EPS, False), port))


@pytest.fixture
def fuse(monkeypatch):
    """Sets both packages' switch; the JAX jit caches are cleared at each flip and
    at the end, as tests/test_fuse_norm.py does (the JAX switch is read while
    tracing)."""
    def flip(on):
        monkeypatch.setattr(arch, "FUSE_NORM", "1" if on else "0")
        monkeypatch.setattr(jarch, "FUSE_NORM", "1" if on else "0")
        jax.clear_caches()

    yield flip
    jax.clear_caches()


def _spy(monkeypatch):
    """Each port ``wna16_matmul`` call given a prenorm: whether it was eligible."""
    fired = []
    real = gemm.wna16_matmul

    def spy(x2d, qweight, scales, zeros, kperm, bias, group_size, bits, *a, prenorm=None, **kw):
        if prenorm is not None:
            fired.append(gemm.prenorm_eligible(x2d.shape[0], x2d.shape[1], group_size, bits,
                                               kperm, norm_len=prenorm[0].shape[-1]))
        return real(x2d, qweight, scales, zeros, kperm, bias, group_size, bits, *a,
                    prenorm=prenorm, **kw)

    monkeypatch.setattr(gemm, "wna16_matmul", spy)
    return fired


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_fuse_norm")), TINY,
                                   bits=4, group_size=32, desc_act=False, seed=3)
    port = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(path, dtype=jnp.float32, backend="pallas_interpret")
    return port, ref


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("kw", [dict(max_new_tokens=6),
                                dict(max_new_tokens=6, num_beams=2, eos_token_id=12)],
                         ids=["greedy", "paged beam 2"])
def test_tokens_with_the_switch_on_equal_unfused_and_jax(models, fuse, monkeypatch, kw):
    port, ref = models
    prompts = _prompts((4, 9))
    monkeypatch.setattr(jgen, "BEAM_PAGED", "always")
    fuse(False)
    off = port.generate(prompts, **kw)
    fuse(True)
    fired = _spy(monkeypatch)
    on = port.generate(prompts, **kw)
    jax_fused = []
    real = jqlin.matmul
    monkeypatch.setattr(jqlin, "matmul", lambda x, ql, backend="auto", prenorm=None: (
        jax_fused.append(prenorm is not None) or real(x, ql, backend, prenorm)))
    want = ref.generate(prompts, **kw)
    # q/k/v and gate/up of 2 layers in each of the 5 one-token steps
    assert len(fired) == 5 * 2 * 5 and all(fired)
    assert any(jax_fused)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, want)


def test_mixtral_never_takes_the_fused_route(tmp_path, fuse, monkeypatch):
    path = write_random_checkpoint(str(tmp_path), TINY_MIXTRAL, bits=4, group_size=32, seed=3)
    port = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
    port.params = params_lib.stack_moe_experts(port.params)
    prompts = _prompts((5,), seed=2)
    fuse(False)
    off = [port.generate(prompts, max_new_tokens=5, num_beams=b) for b in (1, 2)]
    fuse(True)
    fired = _spy(monkeypatch)
    on = [port.generate(prompts, max_new_tokens=5, num_beams=b) for b in (1, 2)]
    assert not fired
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    x = torch.zeros((1, 1, TINY_MIXTRAL["hidden_size"]))
    with pytest.raises(ValueError, match="MoE"):
        arch.mlp(port.params["layers"][0]["mlp"], x, port.cfg,
                 prenorm=port.params["layers"][0]["post_norm"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m, dtype, bits, plus_one", [
    (1, torch.bfloat16, 4, False), (4, torch.float16, 4, False), (16, torch.bfloat16, 4, False),
    (1, torch.float32, 4, False), (24, torch.bfloat16, 4, False), (24, torch.float32, 4, False),
    (1, torch.bfloat16, 3, False), (4, torch.bfloat16, 4, True)])
def test_fused_route_matches_its_plain_version_on_the_card(card, m, dtype, bits, plus_one):
    k, n = 4096, 4096
    rng = np.random.default_rng(m + bits)
    t = random_quant_tensors(rng, k, n, bits, 128, False)
    layer = qlin.from_packed(qlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=None, bits=bits, group_size=128, in_features=k, out_features=n), device=card,
        dtype=dtype)
    x, w = _inputs(m, k, seed=m)
    tx = torch.from_numpy(x).to(card, dtype)
    pn = (torch.from_numpy(w).to(card, dtype), 1e-5, plus_one)
    key = {"gemv": "w4a16_gemm_gemv_norm", "wgmma": "w4a16_gemm_wgmma_norm",
           "mma": "w4a16_gemm_mma_norm",
           "simt": "w4a16_gemm_norm"}[gemm.route(dtype, m, 128, k=k, n=n)]
    before = build.launches[key]
    y = qlin.matmul(tx, layer, prenorm=pn)
    assert build.launches[key] == before + 1
    ref = qlin.matmul_plain(gemm.rms_apply(tx, *pn), layer).float()
    torch.cuda.synchronize()
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (y.float() - ref).abs().max().item() <= tol
    assert torch.equal(qlin.matmul(tx, layer, prenorm=pn), y)
