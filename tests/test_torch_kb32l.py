"""The port's tile-contiguous kb32l layout (K6's words) on the CPU against the
JAX package's kb32l layout, in f32.

* Layout parity at ``tests/test_kb32.py``'s shapes plus a 3-bit and a desc_act
  case: the port's kb32l codes and dequantized weight equal its GPTQ-layout
  ones bit for bit; its plain matmul agrees with the JAX ``matmul_xla`` of the
  JAX kb32l node (1e-5), with the JAX ``_matmul_kb32l`` kernel in interpret
  mode at M = 1 and 64, and with ``_matmul_kb32l_manual``
  (``AUTOGPTQ_TPU_KB32L_MANUAL=3``) at M = 1 and 8 (2e-2 of the largest
  output: the JAX kernels dot in bf16).
* ``from_packed(layout="kb32l")`` refuses what the JAX rule refuses;
  ``stack_experts`` refuses kb32l layers.
* ``params_from_jax`` carries a JAX kb32l node across as a port kb32l node.
* ``dx`` through a desc_act kb32l layer against ``jax.grad`` (1e-4).
* K6's decode GEMV on the host: its plan on the true K and N (K not a whole
  number of tiles, N = 1312) covers K once, each stage inside one tile, the
  padding never read; the plain version at the GEMV's 1, 4 and 16 rows against
  the JAX ``matmul_xla`` (1e-5); the route (the GEMV for bf16/f16, the ring
  for f32).
* A tiny random Llama checkpoint (2 layers, desc_act, g32) loaded with
  ``from_quantized(layout="kb32l")`` against the JAX model whose quantized
  layers are rebuilt with the JAX ``from_packed(layout="kb32l")``: logits
  (1e-4), greedy tokens (equal, and equal to the port's default layout), and
  ``params_from_jax`` of the JAX tree (1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.models import params as jparams
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu.ops.pallas import gemm as jgemm
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.models.registry import get_family
from autogptq_tpu_torch.ops import build, gemm
from autogptq_tpu_torch.ops import quantlinear as qlin
from autogptq_tpu_torch.utils import hf_io
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors, \
    write_random_checkpoint

TINY = dict(model_type="llama", vocab_size=512, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
            hidden_act="silu", tie_word_embeddings=False)

# (K, N, group size, bits, desc_act): test_kb32.py's kb32l shapes (N = 1312 pads to the
# JAX package's 2048 and the port's 1408), a 3-bit and a desc_act case
CASES = [(1024, 128, 128, 4, False), (2048, 1024, 64, 4, False), (1024, 1312, 256, 4, False),
         (1024, 256, 128, 3, False), (1024, 256, 128, 4, True)]


def _packed(seed, k, n, gs, bits=4, desc_act=False, bias=False):
    """The same checkpoint tensors as both packages' PackedQuantLinear."""
    rng = np.random.default_rng(seed)
    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    kw = dict(bits=bits, group_size=gs, in_features=k, out_features=n)
    port = qlin.PackedQuantLinear(qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"],
                                  g_idx=t["g_idx"], bias=b, **kw)
    ref = jqlin.PackedQuantLinear(
        qweight=jnp.asarray(t["qweight"]), qzeros=jnp.asarray(t["qzeros"]),
        scales=jnp.asarray(t["scales"]), g_idx=jnp.asarray(t["g_idx"]),
        bias=None if b is None else jnp.asarray(b), **kw)
    return port, ref


def _x(m, k, seed=1):
    return (np.random.default_rng(seed).standard_normal((m, k)) * 0.1).astype(np.float32)


def _close(got, want, rtol):
    """Within ``rtol`` of the largest output."""
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("k, n, gs, bits, desc_act", CASES)
def test_kb32l_layout_matches_gptq_layout_and_jax_xla(k, n, gs, bits, desc_act):
    p, j = _packed(k + n, k, n, gs, bits, desc_act, bias=True)
    port = qlin.from_packed(p, device="cpu", dtype=torch.float32, layout="kb32l")
    gptq = qlin.from_packed(p, device="cpu", dtype=torch.float32)
    assert port.layout == "kb32l" and gptq.layout == "gptq"
    nbn, nbk = -(-n // 128), -(-k // 256)
    assert tuple(port.qweight.shape) == (nbn * nbk, 32, 128)
    assert tuple(port.scales.shape) == (nbk * 256 // gs, nbn * 128)
    assert torch.equal(qlin.codes(port), qlin.codes(gptq))
    assert torch.equal(qlin.dequantize(port), qlin.dequantize(gptq))
    assert torch.equal(qlin.logical_weight(port), qlin.logical_weight(gptq))
    ref = jqlin.from_packed(j, layout="kb32l")
    assert ref.layout == "kb32l"
    for m in (1, 64):
        x = _x(m, k)
        got = qlin.matmul(torch.from_numpy(x), port).numpy()
        np.testing.assert_array_equal(got, qlin.matmul(torch.from_numpy(x), gptq).numpy())
        _close(got, np.asarray(jqlin.matmul_xla(jnp.asarray(x), ref)), 1e-5)


@pytest.mark.parametrize("k, n, gs, bits, desc_act", CASES)
@pytest.mark.parametrize("manual", [False, True])
def test_kb32l_plain_matches_jax_interpret_kernels(monkeypatch, k, n, gs, bits, desc_act,
                                                   manual):
    """Row 2 (``_matmul_kb32l``, M = 1 and 64: both regimes) and row 3
    (``_matmul_kb32l_manual``, M = 1 and 8) in interpret mode."""
    p, j = _packed(k + n, k, n, gs, bits, desc_act)
    port = qlin.from_packed(p, device="cpu", dtype=torch.float32, layout="kb32l")
    ref = jqlin.from_packed(j, layout="kb32l")
    if manual:
        monkeypatch.setenv("AUTOGPTQ_TPU_KB32L_MANUAL", "3")
    for m in ((1, 8) if manual else (1, 64)):
        x = _x(m, k, seed=m)
        got = qlin.matmul_plain(torch.from_numpy(x), port).numpy()
        _close(got, np.asarray(jgemm.matmul_pallas(jnp.asarray(x), ref, interpret=True)), 2e-2)


def test_kb32l_refuses_what_the_jax_rule_refuses():
    p, j = _packed(0, 1152, 128, 96)
    with pytest.raises(ValueError, match="kb32l"):
        qlin.from_packed(p, device="cpu", layout="kb32l")
    with pytest.raises(ValueError, match="kb32l"):
        jqlin.from_packed(j, layout="kb32l")
    p2, _ = _packed(1, 1024, 128, 128, bits=2)
    with pytest.raises(ValueError, match="kb32l"):
        qlin.from_packed(p2, device="cpu", layout="kb32l")
    with pytest.raises(ValueError, match="layout"):
        qlin.from_packed(_packed(2, 1024, 128, 128)[0], device="cpu", layout="kb32")
    layer = qlin.from_packed(_packed(3, 256, 128, 64)[0], device="cpu", layout="kb32l")
    with pytest.raises(NotImplementedError, match="kb32l"):
        qlin.stack_experts([layer, layer])


@pytest.mark.parametrize("k, n, gs, bits, desc_act", [CASES[2], CASES[4]])
def test_params_from_jax_kb32l_node(k, n, gs, bits, desc_act):
    p, j = _packed(k, k, n, gs, bits, desc_act, bias=True)
    got = params_from_jax({"q": jqlin.from_packed(j, layout="kb32l")}, device="cpu",
                          dtype=torch.float32)["q"]
    own = qlin.from_packed(p, device="cpu", dtype=torch.float32, layout="kb32l")
    assert got.layout == "kb32l"
    for field in ("qweight", "scales", "zeros", "kperm", "bias"):
        a, b = getattr(got, field), getattr(own, field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert torch.equal(qlin.logical_weight(got), qlin.logical_weight(own))


def test_grad_through_desc_act_kb32l_matches_jax_grad():
    p, j = _packed(5, 1024, 256, 128, desc_act=True, bias=True)
    port = qlin.from_packed(p, device="cpu", dtype=torch.float32, layout="kb32l")
    ref = jqlin.from_packed(j, layout="kb32l")
    assert port.kperm is not None and ref.kperm is not None
    x = _x(6, 1024)
    cot = np.random.default_rng(7).standard_normal((6, 256)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad((qlin.matmul(xt, port) * torch.from_numpy(cot)).sum(), xt)
    want = jax.grad(lambda xx: jnp.sum(jqlin.matmul(xx, ref, backend="xla") * cot))(
        jnp.asarray(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# K6's decode GEMV (csrc/wna16_gemv.cuh over the kb32l address) is planned by gemm.gemv_plan
# on the true K and N: (K, N, group size) of Llama-2-7B's projections, N = 1312 (1408 padded)
# and K = 1312, 1056 (not a whole number of 256-row tiles)
GEMV_CASES = [(4096, 4096, 128), (4096, 11008, 128), (11008, 4096, 128), (1024, 1312, 32),
              (1312, 1312, 32), (1056, 544, 32), (2048, 1312, 256)]


def _gemv_stage_words(tiles, k, n, plan):
    """The words the GEMV's stages copy, as the kernel addresses them (word row
    kw of column n at tile (n / 128, kw / 32), offset (kw % 32) * 128 + n %
    128; a copy of a row past K or a column past N is zero-filled, not read),
    put back as [K_pad / 8, N] rows; and whether every (stage, 64-column
    tile) copies from one kb32l tile. Every stage of every split is addressed
    at once: stage j of split s starts at K row s * kc + j * stage_k, while
    that lies below the split's end."""
    nbk = -(-k // 256)
    flat = tiles.reshape(-1)
    nb = plan["col_blocks"]
    wrows = plan["stage_k"] // 8
    kc, splits = plan["kc"], plan["splits"]
    starts = (torch.arange(splits)[:, None] * kc
              + torch.arange(-(-kc // plan["stage_k"]))[None, :] * plan["stage_k"])
    ends = torch.clamp(torch.arange(1, splits + 1) * kc, max=k)[:, None]
    kt = starts[starts < ends]                                       # [stages]
    kws = ((kt // 8)[:, None] + torch.arange(wrows)[None, :]).to(torch.int32)   # [stages, wrows]
    cols = torch.arange(nb * gemm.GEMV_BN, dtype=torch.int32)
    tile = (cols // 128 * nbk)[None, None, :] + (kws // 32)[:, :, None]
    addr = tile * 4096 + (kws % 32 * 128)[:, :, None] + (cols % 128)[None, None, :]
    ok = (kws < k // 8)[:, :, None] & (cols < n)[None, None, :]
    tile = torch.where(ok, tile, -1).view(-1, wrows, nb, gemm.GEMV_BN)
    big = torch.where(tile < 0, 1 << 30, tile).amin(dim=(1, 3))
    one_tile = bool(((tile == big[:, None, :, None]) | (tile < 0)).all())
    out = torch.zeros((splits * kc // 8, nb * gemm.GEMV_BN), dtype=torch.int32)
    out[kws.reshape(-1).long()] = torch.where(ok, flat[addr.clamp(max=flat.numel() - 1)],
                                              0).reshape(-1, nb * gemm.GEMV_BN)
    return out[:, :n], one_tile


@pytest.mark.parametrize("k, n, gs", GEMV_CASES)
def test_kb32l_gemv_plan_reads_the_true_k_and_n(k, n, gs):
    """The plan of the true K and N covers K once and N with 64-column tiles
    (none of them wholly in the padding); every stage's copies lie inside one
    32 x 128 kb32l tile; the words they gather are the GPTQ words, the tiles'
    padding (rows past K, columns past N) never read."""
    p, _ = _packed(k + n, k, n, gs)
    port = qlin.from_packed(p, device="cpu", dtype=torch.float32, layout="kb32l")
    gptq = qlin.from_packed(p, device="cpu", dtype=torch.float32)
    for m in (1, 4, 16):
        plan = gemm.gemv_plan(k, n, m, gs, 4, 132)
        assert (plan["splits"] - 1) * plan["kc"] < k <= plan["splits"] * plan["kc"]
        assert plan["col_blocks"] == -(-n // gemm.GEMV_BN) and plan["kc"] % 256 in (0, 128)
        assert plan["weight_bytes"] == k * n // 2 + 3 * (k // gs) * n
        words, one_tile = _gemv_stage_words(port.qweight, k, n, plan)
        assert one_tile
        assert torch.equal(words[:k // 8], gptq.qweight) and not words[k // 8:].any()


@pytest.mark.parametrize("k, n, gs, bits, desc_act",
                         [(1312, 1312, 32, 4, False), (1056, 544, 32, 3, True)] + CASES[1:3])
def test_kb32l_plain_matches_jax_xla_at_gemv_rows(k, n, gs, bits, desc_act):
    """The plain K6 that the GEMV is held to on the card, at the GEMV's row
    counts (1, 4 and 16) against the JAX package's ``matmul_xla`` of its kb32l
    node (f32, 1e-5), including K not a whole number of 256-row tiles and
    N = 1312; a CPU tensor launches nothing."""
    p, j = _packed(k * bits + n, k, n, gs, bits, desc_act, bias=True)
    port = qlin.from_packed(p, device="cpu", dtype=torch.float32, layout="kb32l")
    ref = jqlin.from_packed(j, layout="kb32l")
    for m in (1, 4, 16):
        x = _x(m, k, seed=m + k)
        before = dict(build.launches)
        got = qlin.matmul(torch.from_numpy(x), port).numpy()
        assert dict(build.launches) == before
        _close(got, np.asarray(jqlin.matmul_xla(jnp.asarray(x), ref)), 1e-5)


@pytest.mark.parametrize("gs", [32, 64, 128, 256])
def test_kb32l_route_takes_the_gemv_for_bf16_and_the_ring_for_f32(gs):
    """Every kb32l group size is a multiple of 16: bf16 and f16 take the GEMV at
    M <= 16, f32 the ring ("simt"); above 16 rows the tile kernels."""
    for m in (1, 4, 16):
        assert gemm.route(torch.bfloat16, m, gs) == gemm.route(torch.float16, m, gs) == "gemv"
        assert gemm.route(torch.float32, m, gs) == "simt"
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        assert gemm.route(dtype, 17, gs) == gemm.tile_kernel(dtype)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_llama_kb32l"))
    return write_random_checkpoint(path, TINY, bits=4, group_size=32, desc_act=True, seed=3)


@pytest.fixture(scope="module")
def models(ckpt):
    """The port's kb32l and default-layout models, and the JAX model with every
    quantized layer rebuilt by the JAX ``from_packed(layout="kb32l")``."""
    port = AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32,
                                              layout="kb32l")
    default = AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(ckpt, dtype=jnp.float32)
    spec = get_family("llama")
    tensors = hf_io.open_tensors(ckpt)
    for i, block in enumerate(ref.params["layers"]):
        for our in (p for sub in spec.quant_layers for p in sub):
            base = f"{spec.layers_prefix}.{i}.{spec.block_linears[our]}"
            qweight = tensors[f"{base}.qweight"].numpy()
            packed = jqlin.PackedQuantLinear(
                qweight=qweight, qzeros=tensors[f"{base}.qzeros"].numpy(),
                scales=tensors[f"{base}.scales"].numpy(), g_idx=tensors[f"{base}.g_idx"].numpy(),
                bias=None, bits=4, group_size=32, in_features=qweight.shape[0] * 8,
                out_features=qweight.shape[1])
            jparams.set_in_block(block, our, jqlin.from_packed(packed, layout="kb32l"))
    assert ref.params["layers"][1]["mlp"]["down_proj"].layout == "kb32l"
    return port, default, ref


def test_tiny_llama_kb32l_logits_match_jax(models):
    port, _, ref = models
    assert all(block["attn"]["q_proj"].layout == "kb32l" for block in port.params["layers"])
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 9)).astype(np.int32)
    got, _ = arch.forward(port.params, torch.from_numpy(tokens), port.cfg)
    want, _ = jarch.forward(ref.params, jnp.asarray(tokens), ref.cfg, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    carried = params_from_jax(ref.params, device="cpu", dtype=torch.float32)
    assert carried["layers"][0]["mlp"]["down_proj"].layout == "kb32l"
    again, _ = arch.forward(carried, torch.from_numpy(tokens), port.cfg)
    torch.testing.assert_close(again, got, rtol=1e-6, atol=1e-6)


def test_tiny_llama_kb32l_greedy_tokens(models):
    port, default, ref = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, size=7), rng.integers(1, 512, size=4)]
    got = port.generate(prompts, max_new_tokens=12)
    assert got.shape == (2, 7 + 12)
    np.testing.assert_array_equal(got, ref.generate(prompts, max_new_tokens=12))
    np.testing.assert_array_equal(got, default.generate(prompts, max_new_tokens=12))
