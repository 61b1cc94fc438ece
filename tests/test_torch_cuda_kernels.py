"""K1 (w4a16 GEMM), K2 (flash-decode), K7 (paged attention), K8a (page row
write) and K8b (page copy) on the card against their plain PyTorch versions.
Marked ``cuda``: without a CUDA device every test skips
(the ``card`` fixture decides, so every worker collects the same tests). On
the card: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q``."""

import numpy as np
import pytest
import torch

from autogptq_tpu_torch.ops import build
from autogptq_tpu_torch.ops import flash_decode as fdm
from autogptq_tpu_torch.ops import paged_attn as pam
from autogptq_tpu_torch.ops import quantlinear as qlin
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors, \
    write_random_checkpoint

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _layer(seed, k, n, gs=128, desc_act=False, bias=False, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    t = random_quant_tensors(rng, k, n, 4, gs, desc_act)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return qlin.from_packed(qlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=b, bits=4, group_size=gs, in_features=k, out_features=n), device="cuda",
        dtype=dtype)


@pytest.mark.parametrize("m", [1, 3, 16, 17, 70])
@pytest.mark.parametrize("k, n, gs, desc_act, bias", [
    (4096, 4096, 128, False, False),
    (11008, 4096, 128, True, False),
    (1024, 520, 32, False, True),
    (2048, 512, -1, False, False),
])
def test_k1_matches_plain(card, m, k, n, gs, desc_act, bias):
    layer = _layer(m + k, k, n, gs, desc_act, bias)
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=torch.bfloat16)
    before = build.launches["w4a16_gemm"]
    y = qlin.matmul(x, layer)
    assert build.launches["w4a16_gemm"] == before + 1
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    # f32 dequantization and accumulation on both sides, one bf16 rounding:
    # 1% of the largest output
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


def test_k1_f32_activations(card):
    layer = _layer(0, 1024, 256, 64, desc_act=True, dtype=torch.float32)
    x = torch.randn((5, 1024), generator=torch.Generator(card).manual_seed(0), device=card)
    torch.testing.assert_close(qlin.matmul(x, layer), qlin.matmul_plain(x, layer),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [17, 70])
def test_k1_f32_prefill_keeps_f32_weights(card, m):
    """The tile kernel (M > 16) dequantizes to f32, as the plain version does,
    so an f32 model computes at f32 in prefill too."""
    layer = _layer(m, 1024, 256, 64, desc_act=True, dtype=torch.float32)
    x = torch.randn((m, 1024), generator=torch.Generator(card).manual_seed(m), device=card)
    torch.testing.assert_close(qlin.matmul(x, layer), qlin.matmul_plain(x, layer),
                               rtol=1e-5, atol=1e-4)


def test_k1_refuses_unsupported_shapes(card):
    layer = _layer(1, 256, 128, 32)
    x = torch.randn((2, 256), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        qlin.gemm.w4a16_matmul(x, layer.qweight, layer.scales.float(), layer.zeros, None, None,
                               32)


@pytest.mark.parametrize("b, h, hkv, d, s", [(1, 32, 32, 128, 528), (3, 32, 8, 128, 300),
                                             (2, 8, 2, 64, 77), (2, 16, 4, 256, 40)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_matches_plain(card, b, h, hkv, d, s, dtype):
    gen = torch.Generator(card).manual_seed(b * h + d)
    q = torch.randn((b, h, d), generator=gen, device=card).to(dtype)
    kc = torch.randn((2, b, s, hkv, d), generator=gen, device=card).to(dtype)
    vc = torch.randn((2, b, s, hkv, d), generator=gen, device=card).to(dtype)
    lo = torch.tensor([0, 5, 3][:b], dtype=torch.int32, device=card)
    hi = torch.tensor([s, s + 100, 3][:b], dtype=torch.int32, device=card)  # parked, empty
    before = build.launches["flash_decode"]
    o = fdm.flash_decode(q, kc, vc, lo, hi, layer=1, sm_scale=d ** -0.5)
    assert build.launches["flash_decode"] == before + 1
    ref = fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=1, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all()
    # f32 on both sides from the same inputs; only summation order and exp differ
    torch.testing.assert_close(o, ref, rtol=0, atol=1e-4)


def test_tiny_model_card_matches_cpu(card, tmp_path):
    cfg = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu")
    path = write_random_checkpoint(str(tmp_path), cfg, bits=4, group_size=64, desc_act=True)
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models.arch import KVCache, forward

    outs = {}
    for dev in ("cuda", "cpu"):
        model = AutoGPTQForCausalLM.from_quantized(path, device=dev, dtype=torch.float32)
        tokens = torch.arange(1, 10)[None].to(dev)
        cache = KVCache.create(model.cfg, 1, 12, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            pre, cache = forward(model.params, tokens, model.cfg, cache=cache)
            dec, _ = forward(model.params, torch.tensor([[7]], device=dev), model.cfg,
                             cache=cache)
        outs[dev] = (pre.cpu(), dec.cpu())
    for card_out, cpu_out in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(card_out, cpu_out, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b, h, hkv, d, ps", [(4, 32, 32, 128, 16), (3, 32, 8, 128, 16),
                                              (2, 8, 2, 64, 8), (2, 16, 4, 256, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_k7_matches_plain(card, b, h, hkv, d, ps, dtype):
    gen = torch.Generator(card).manual_seed(b * h + d)
    n_layers, n_pages, w = 2, 23, 9
    act = torch.float32 if dtype == torch.float32 else torch.bfloat16
    q = torch.randn((b, h, d), generator=gen, device=card).to(act)
    shape = (n_layers, n_pages, hkv, ps, d)
    ks = vs = None
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=card) + 0.1
        vs = torch.rand(shape[:-1], generator=gen, device=card) + 0.1
    else:
        kp = torch.randn(shape, generator=gen, device=card).to(dtype)
        vp = torch.randn(shape, generator=gen, device=card).to(dtype)
    # a full table, a mid-page end, one token, an empty row
    lengths = torch.tensor([w * ps, 2 * ps + 5, 1, 0][:b], dtype=torch.int32, device=card)
    tables = torch.randint(0, n_pages, (b, w), generator=gen, device=card, dtype=torch.int32)
    before = build.launches["paged_attention_mh"]
    o = pam.paged_attention_mh(q, kp, vp, lengths, tables, ks, vs, sm_scale=d ** -0.5, layer=1)
    assert build.launches["paged_attention_mh"] == before + 1
    ref = pam.paged_attention_mh_ref(q, kp, vp, lengths, tables, ks, vs, sm_scale=d ** -0.5,
                                     layer=1)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all()
    # f32 on both sides from the same inputs; only summation order and exp differ
    torch.testing.assert_close(o, ref, rtol=0, atol=1e-4)


def test_k7_refuses_unsupported(card):
    q = torch.zeros((1, 8, 96), device=card, dtype=torch.bfloat16)
    kp = torch.zeros((1, 3, 2, 16, 96), device=card, dtype=torch.bfloat16)
    lengths = torch.ones(1, dtype=torch.int32, device=card)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError):
        pam.paged_attention_mh(q, kp, kp, lengths, tables, sm_scale=0.1, layer=0)
    with pytest.raises(ValueError, match="out of range"):
        pam.paged_attention_mh(q, kp, kp, lengths, tables, sm_scale=0.1, layer=1)


def _pools(card, dtype, rank, seed, n_layers=3, n_pages=12, hkv=4, ps=16, d=128):
    gen = torch.Generator(card).manual_seed(seed)
    shape = (n_layers, n_pages, hkv, ps) + ((d,) if rank == 5 else ())
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=card).to(dtype)


@pytest.mark.parametrize("dtype, rank", [(torch.bfloat16, 5), (torch.int8, 5),
                                         (torch.float32, 4), (torch.float32, 5)])
def test_k8a_is_bit_exact(card, dtype, rank):
    kp, vp = _pools(card, dtype, rank, 1), _pools(card, dtype, rank, 2)
    b = 4
    rows_k = _pools(card, dtype, rank, 3, n_layers=1, n_pages=b, ps=1)[0, :, :, 0]
    rows_v = _pools(card, dtype, rank, 4, n_layers=1, n_pages=b, ps=1)[0, :, :, 0]
    page_of = torch.tensor([3, 7, 0, 11], dtype=torch.int32, device=card)
    off = torch.tensor([0, 15, 6, 9], dtype=torch.int32, device=card)
    want_k = pam.write_token_pages(kp.clone(), 2, page_of, off, rows_k)
    want_v = pam.write_token_pages(vp.clone(), 2, page_of, off, rows_v)
    before = build.launches["write_token_pages"]
    pam.write_token_pages_kernel(kp, vp, 2, page_of, off, rows_k.contiguous(),
                                 rows_v.contiguous())
    assert build.launches["write_token_pages"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)


@pytest.mark.parametrize("dtype, rank", [(torch.bfloat16, 5), (torch.int8, 5),
                                         (torch.float32, 4)])
def test_k8b_is_bit_exact_with_aliasing(card, dtype, rank):
    kp, vp = _pools(card, dtype, rank, 5), _pools(card, dtype, rank, 6)
    # src[1] is dst[0] and src[2] is dst[1]; src[3] == dst[3]
    src = torch.tensor([2, 5, 7, 4], dtype=torch.int32, device=card)
    dst = torch.tensor([5, 7, 1, 4], dtype=torch.int32, device=card)
    want_k = pam.copy_pages(kp.clone(), src, dst)
    want_v = pam.copy_pages(vp.clone(), src, dst)
    before = build.launches["copy_pages_pair"]
    pam.copy_pages_pair(kp, vp, src, dst)
    assert build.launches["copy_pages_pair"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)
    with pytest.raises(ValueError, match="unique"):
        pam.copy_pages_pair(kp, vp, src, torch.tensor([1, 1, 2, 3], dtype=torch.int32,
                                                      device=card))
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)     # nothing copied


@pytest.mark.parametrize("op, page, slot, match", [
    ("write", -1, 0, "write targets"), ("write", 12, 0, "write targets"),
    ("write", 3, 16, "write targets"), ("copy", -1, 0, "page ids"), ("copy", 12, 0, "page ids"),
])
def test_k8_bad_ids_raise_and_write_nothing(card, op, page, slot, match):
    """As the plain versions: a bad id raises ValueError and the launch writes
    nothing, read at once (check=True) or later through check_page_errors."""
    kp, vp = _pools(card, torch.bfloat16, 5, 7), _pools(card, torch.bfloat16, 5, 8)
    want_k, want_v = kp.clone(), vp.clone()
    ids = torch.tensor([2, page, 5], dtype=torch.int32, device=card)
    off = torch.tensor([0, slot, 1], dtype=torch.int32, device=card)
    rows = torch.randn((3, 4, 128), device=card).to(torch.bfloat16)
    dst = torch.tensor([1, 4, 6], dtype=torch.int32, device=card)
    for check in (True, False):
        with pytest.raises(ValueError, match=match):
            if op == "write":
                pam.write_token_pages_kernel(kp, vp, 1, ids, off, rows, rows, check=check)
            else:
                pam.copy_pages_pair(kp, vp, ids, dst, check=check)
            if not check:
                pam.check_page_errors(card)
        assert torch.equal(kp, want_k) and torch.equal(vp, want_v)
    pam.check_page_errors(card)     # the flag was cleared


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tiny_model_paged_beam_step_card_matches_cpu(card, tmp_path, kv_quant):
    cfg = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu")
    path = write_random_checkpoint(str(tmp_path), cfg, bits=4, group_size=64, desc_act=True)
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.utils import generation

    outs = {}
    for dev in ("cuda", "cpu"):
        model = AutoGPTQForCausalLM.from_quantized(path, device=dev, dtype=torch.float32)
        # 20 prompt tokens take K1's prefill tile kernel (M > 16)
        tokens = torch.arange(1, 21)[None].to(dev)
        mask = torch.ones_like(tokens, dtype=torch.int32)
        with torch.inference_mode():
            _, cache = generation.beam_paged_prefill(model.params, tokens, mask, model.cfg, 4,
                                                     8, torch.float32, kv_quant=kv_quant)
            nxt = torch.tensor([5, 6, 7, 8], dtype=torch.int32, device=dev)
            logits = generation.paged_decode_step(model.params, model.cfg, cache, nxt,
                                                  cache.plen, torch.float32)
        outs[dev] = logits.cpu()
        if dev == "cuda":
            out = model.generate([list(range(1, 20)), [3, 4]], max_new_tokens=20, num_beams=4,
                                 kv_quant=kv_quant)
            assert out.shape == (2, 39) and ((out >= 0) & (out < 512)).all()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4, atol=1e-4)
