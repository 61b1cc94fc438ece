"""K1 (w4a16 GEMM, also 3-bit codes in nibbles), K4 (w8a16), K5 (w2a16), K6
(w4a16 over the tile-contiguous kb32l words), K10 (their backward,
wna16_gemm_t, also over kb32l words), K2 (flash-decode), K7 (paged
attention), K8a (page row write, and the fused RoPE + K/V write over paged
pools, int8 ones too, and the contiguous cache), K8b (page copy: its cluster
and its gather-and-scatter shapes) and K9 (routed experts) on
the card against their plain PyTorch versions, a tiny model quantized on the
card, and gradients through the quantized and the routed matmul on the card
against the CPU's.
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


def _layer(seed, k, n, gs=128, desc_act=False, bias=False, dtype=torch.bfloat16, bits=4,
           layout=None):
    rng = np.random.default_rng(seed)
    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return qlin.from_packed(qlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=b, bits=bits, group_size=gs, in_features=k, out_features=n), device="cuda",
        dtype=dtype, layout=layout)


KERNEL_OF_BITS = {2: "w2a16_gemm", 3: "w4a16_gemm", 4: "w4a16_gemm", 8: "w8a16_gemm"}


def _key(name, dtype, m, k, gs, n, layout="gptq"):
    """The launch-count key of library ``name`` for a product of ``m`` rows of
    a ``[K/P, N]`` layer of ``layout`` (K6's library is kb32l's): its
    tensor-core GEMV's (K1/K4/K5 and K6 forward, ``gemm.route``; K10's decode
    regime, ``gemm.t_route``), its wgmma/TMA or mma.sync tile kernel's (by
    layout and shape; K10's wgmma one over kb32l words has a key of its own)
    or its SIMT kernels'."""
    gs = k if gs == -1 else gs
    if name == qlin.gemm.KB32L_KERNEL:
        layout = "kb32l"
    if name == qlin.gemm.T_KERNEL:   # K10, also over kb32l words
        route = qlin.gemm.t_route(dtype, m, k=k, n=n, layout=layout)
        if route == "wgmma" and layout == "kb32l":
            return qlin.gemm.KB32L_T_WGMMA
    elif layout == "kb32l":
        route = qlin.gemm.kb32l_route(dtype, m, gs, k=k, n=n)
    else:
        route = qlin.gemm.route(dtype, m, gs, k=k, n=n)
    return name + {"gemv": qlin.gemm.GEMV_SUFFIX, "wgmma": qlin.gemm.WGMMA_SUFFIX,
                   "mma": qlin.gemm.MMA_SUFFIX, "simt": ""}[route]


@pytest.mark.parametrize("bits", [2, 3, 8])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 70])
@pytest.mark.parametrize("k, n, gs, desc_act, bias", [
    (4096, 4096, 128, False, False),
    (11008, 4096, 128, True, False),
    (1024, 544, 32, False, True),
    (2048, 512, -1, False, False),
    (1024, 256, 16, True, True),
])
def test_k4_k5_and_3bit_match_plain(card, bits, m, k, n, gs, desc_act, bias):
    """Both regimes (GEMV for M <= 16, tile kernel above) of K5 (2-bit), K4
    (8-bit) and K1 carrying 3-bit codes in nibbles."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bias, bits=bits)
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=torch.bfloat16)
    name = _key(KERNEL_OF_BITS[bits], x.dtype, m, k, gs, n)
    before = build.launches[name]
    y = qlin.matmul(x, layer)
    assert build.launches[name] == before + 1
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    # f32 dequantization and accumulation on both sides, one bf16 rounding:
    # 1% of the largest output
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [5, 17, 70])
@pytest.mark.parametrize("gs, desc_act", [(64, True), (-1, False), (16, False)])
def test_wna16_f32_activations(card, bits, m, gs, desc_act):
    """f32 activations keep f32 weights in both regimes: 1e-4 against the
    plain version (the calibration re-forward of quantize runs here)."""
    layer = _layer(bits + m, 1024, 256, gs, desc_act, bias=True, dtype=torch.float32, bits=bits)
    x = torch.randn((m, 1024), generator=torch.Generator(card).manual_seed(m), device=card)
    torch.testing.assert_close(qlin.matmul(x, layer), qlin.matmul_plain(x, layer),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bits, stored, effective", [(3, 7, 8), (8, 255, 0)])
def test_extreme_zero_points_on_the_card(card, bits, stored, effective):
    """A 3-bit effective zero of 8 (it fits no nibble) and an 8-bit stored 255
    that wraps to 0 go through the kernels as through the plain versions."""
    from autogptq_tpu_torch.ops import packing

    rng = np.random.default_rng(bits)
    t = random_quant_tensors(rng, 256, 128, bits, 32)
    t["qzeros"] = packing.pack_qzeros(np.full((8, 128), stored + 1, np.int64), bits)
    layer = qlin.from_packed(qlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=None, bits=bits, group_size=32, in_features=256, out_features=128),
        device="cuda", dtype=torch.float32)
    assert int(layer.zeros.min()) == int(layer.zeros.max()) == effective
    for m in (3, 40):
        x = torch.randn((m, 256), generator=torch.Generator(card).manual_seed(m), device=card)
        torch.testing.assert_close(qlin.matmul(x, layer), qlin.matmul_plain(x, layer),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bits", [2, 8])
def test_k4_k5_edge_cases(card, bits):
    layer = _layer(1, 256, 128, 32, bits=bits)
    assert qlin.matmul(torch.zeros((0, 256), device=card, dtype=torch.bfloat16),
                       layer).shape == (0, 128)
    x = torch.randn((2, 256), device=card, dtype=torch.bfloat16)
    wrapper = {2: qlin.gemm.w2a16_matmul, 8: qlin.gemm.w8a16_matmul}[bits]
    with pytest.raises(ValueError, match="scales"):
        wrapper(x, layer.qweight, layer.scales.float(), layer.zeros, None, None, 32)
    with pytest.raises(ValueError, match="qweight"):
        wrapper(x, layer.qweight[:-1], layer.scales, layer.zeros, None, None, 32)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(x.t().contiguous().t(), layer.qweight, layer.scales, layer.zeros, None, None, 32)
    with pytest.raises(NotImplementedError, match="group size"):   # every size > 0 is taken
        wrapper(x, layer.qweight, layer.scales[:1].repeat(128, 1).contiguous(),
                layer.zeros[:1].repeat(128, 1).contiguous(), None, None, 0)
    with pytest.raises(ValueError, match="bias"):
        wrapper(x, layer.qweight, layer.scales, layer.zeros, None,
                torch.zeros(128, device=card), 32)


@pytest.mark.parametrize("bits, desc_act", [(4, True), (2, False), (3, False), (8, False)])
def test_tiny_model_quantized_on_the_card(card, tmp_path, bits, desc_act):
    """quantize on the card (Hessians, solver and the re-forward through the
    kernels in f32) gives the codes of the same run on the CPU, up to weights
    on rounding edges, and the saved checkpoint reloads bit for bit."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM, BaseQuantizeConfig
    from autogptq_tpu_torch.ops import packing
    from autogptq_tpu_torch.utils.data import random_calibration_examples
    from autogptq_tpu_torch.utils.random_checkpoint import write_random_fp_checkpoint

    cfg = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu")
    fp = write_random_fp_checkpoint(str(tmp_path / "fp"), cfg, seed=1)
    examples = random_calibration_examples(512, n=16, seqlen=64, seed=2)
    models = {}
    for dev in ("cuda", "cpu"):
        model = AutoGPTQForCausalLM.from_pretrained(
            fp, BaseQuantizeConfig(bits=bits, group_size=64, desc_act=desc_act, sym=False),
            device=dev, dtype=torch.float32)
        before = build.launches[KERNEL_OF_BITS[bits]]
        model.quantize(examples, batch_size=4)
        if dev == "cuda":      # the re-forward ran through the kernel
            assert build.launches[KERNEL_OF_BITS[bits]] > before
        models[dev] = model
    card_model, cpu_model = models["cuda"], models["cpu"]
    key = "0.attn.q_proj"      # nothing quantized precedes it
    a = packing.unpack_qweight(card_model.packed_layers[key].qweight, bits)
    b = packing.unpack_qweight(cpu_model.packed_layers[key].qweight, bits)
    assert np.mean(a == b) >= 0.99
    loss_card = np.mean(list(card_model.quantize_stats["losses"].values()))
    loss_cpu = np.mean(list(cpu_model.quantize_stats["losses"].values()))
    assert np.isfinite(loss_card) and abs(loss_card - loss_cpu) <= 0.05 * loss_cpu
    card_model.save_quantized(str(tmp_path / "q"))
    reloaded = AutoGPTQForCausalLM.from_quantized(str(tmp_path / "q"), device="cuda",
                                                  dtype=torch.float32)
    tokens = np.arange(1, 21)[None]
    assert torch.equal(reloaded.forward(tokens), card_model.forward(tokens))
    out = reloaded.generate([list(range(1, 9))], max_new_tokens=8)
    assert out.shape == (1, 16) and ((out >= 0) & (out < 512)).all()


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
    name = _key("w4a16_gemm", x.dtype, m, k, gs, n)
    before = build.launches[name]
    y = qlin.matmul(x, layer)
    assert build.launches[name] == before + 1
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


def _k2_inputs(card, dtype, b, h, hkv, d, s, seed):
    gen = torch.Generator(card).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=card).to(dtype)
    kc = torch.randn((2, b, s, hkv, d), generator=gen, device=card).to(dtype)
    vc = torch.randn((2, b, s, hkv, d), generator=gen, device=card).to(dtype)
    return q, kc, vc


def _k2_twice(q, kc, vc, lo, hi, d):
    """Two K2 calls: each launches once, and the second is bit-equal to the first."""
    outs = []
    for _ in range(2):
        before = build.launches["flash_decode"]
        outs.append(fdm.flash_decode(q, kc, vc, lo, hi, layer=1, sm_scale=d ** -0.5))
        assert build.launches["flash_decode"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    return outs[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b, h, hkv, d, s", [(1, 32, 32, 128, 528), (2, 32, 8, 128, 144),
                                             (1, 8, 2, 256, 300)])
def test_k2_split_windows_on_chunk_edges(card, dtype, b, h, hkv, d, s):
    chunk, n_split = fdm.split_plan(b, hkv, s)
    assert n_split > 1
    q, kc, vc = _k2_inputs(card, dtype, b, h, hkv, d, s, s + d)
    for window in (chunk, chunk + 1, s):
        lo = torch.tensor([0, 3][:b], dtype=torch.int32, device=card)
        hi = torch.full((b,), window, dtype=torch.int32, device=card)
        o = _k2_twice(q, kc, vc, lo, hi, d)
        ref = fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=1, sm_scale=d ** -0.5)
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.int8])
def test_k7_split_lengths_on_chunk_edges(card, dtype):
    b, h, hkv, d, ps, w, n_pages = 4, 32, 32, 128, 16, 40, 170
    chunk, n_split = pam.split_plan(b, hkv, w, ps)
    assert n_split > 1
    gen = torch.Generator(card).manual_seed(17)
    act = torch.float32 if dtype == torch.float32 else \
        (torch.float16 if dtype == torch.float16 else torch.bfloat16)
    q = torch.randn((b, h, d), generator=gen, device=card).to(act)
    shape = (2, n_pages, hkv, ps, d)
    ks = vs = None
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=card) + 0.1
        vs = torch.rand(shape[:-1], generator=gen, device=card) + 0.1
    else:
        kp = torch.randn(shape, generator=gen, device=card).to(dtype)
        vp = torch.randn(shape, generator=gen, device=card).to(dtype)
    tables = torch.randperm(n_pages, generator=gen, device=card)[:b * w].reshape(b, w)
    tables = tables.to(torch.int32).contiguous()
    for lens in ([chunk] * b, [chunk + 1] * b, [w * ps] * b, [w * ps, chunk + 1, 1, 0]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=card)
        outs = []
        for _ in range(2):
            before = build.launches["paged_attention_mh"]
            outs.append(pam.paged_attention_mh(q, kp, vp, lengths, tables, ks, vs,
                                               sm_scale=d ** -0.5, layer=1))
            assert build.launches["paged_attention_mh"] == before + 1
        ref = pam.paged_attention_mh_ref(q, kp, vp, lengths, tables, ks, vs, sm_scale=d ** -0.5,
                                         layer=1)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert torch.isfinite(outs[0]).all()
        torch.testing.assert_close(outs[0], ref, rtol=0, atol=1e-4)


def test_split_counters_reset_between_shapes(card):
    """Calls at other shapes on one stream, an empty row, a live range that
    starts past the first chunks and all-empty chunks among them, leave every
    result right: each launch resets its tickets."""
    shapes = [(1, 32, 32, 128, 528, [0], [528]), (3, 32, 8, 128, 144, [0, 5, 9], [144, 9, 144]),
              (1, 32, 32, 128, 528, [0], [17]), (2, 8, 2, 64, 1000, [0, 0], [1000, 0]),
              (1, 32, 32, 128, 528, [100], [300]), (1, 32, 32, 128, 528, [0], [528])]
    for i, (b, h, hkv, d, s, lo_l, hi_l) in enumerate(shapes):
        q, kc, vc = _k2_inputs(card, torch.bfloat16, b, h, hkv, d, s, i)
        lo = torch.tensor(lo_l, dtype=torch.int32, device=card)
        hi = torch.tensor(hi_l, dtype=torch.int32, device=card)
        o = _k2_twice(q, kc, vc, lo, hi, d)
        ref = fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=1, sm_scale=d ** -0.5)
        torch.testing.assert_close(o, ref, rtol=0, atol=1e-4)
    _, counters = build.split_scratch("flash_decode", card, 0, 0)
    assert int(counters.abs().sum()) == 0


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


MANTISSA = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}


def _ulp_off(got, want, dtype=None):
    """How many elements of ``got`` lie more than one ulp of ``dtype`` (its
    own by default) from ``want``."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 1 - MANTISSA[dtype or got.dtype])
    return int(((g - w).abs() > ulp).sum())


@pytest.mark.parametrize("layout, dtype, quant, h, hkv, d", [
    ("paged", torch.bfloat16, False, 32, 32, 128), ("paged", torch.bfloat16, True, 32, 32, 128),
    ("paged", torch.float16, False, 32, 8, 128), ("paged", torch.float32, True, 32, 8, 64),
    ("cursor", torch.bfloat16, False, 32, 8, 128), ("cursor", torch.float32, False, 32, 32, 128),
    ("cursor", torch.float16, False, 8, 8, 64)])
def test_k8a_fused_matches_plain(card, layout, dtype, quant, h, hkv, d):
    """The fused RoPE + K/V write against ``rope_write_kv_ref`` on the card:
    q and the caches within one ulp of the activations' dtype (the kernel's
    sincosf against torch's sin and cos), int8 codes within one, one launch."""
    gen = torch.Generator(card).manual_seed(d + h)
    b, layer = 4, 1
    q, k, v = (torch.randn((b, n, d), generator=gen, device=card).to(dtype) for n in (h, hkv, hkv))
    inv = pam.rope_inv_freq(10000.0, d, card)
    kw = {}
    if layout == "paged":
        w, ps = 40, 16
        tables = (1 + torch.arange(b, device=card)[:, None] * w
                  + torch.arange(w, device=card)[None]).to(torch.int32)
        pos = torch.tensor([0, 599, 257, 16], dtype=torch.int32, device=card)
        shape = (2, b * w + 1, hkv, ps, d)
        if quant:
            kc = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
            kw = dict(k_scale=torch.rand(shape[:-1], generator=gen, device=card) + 0.1)
            kw["v_scale"] = kw["k_scale"].clone()
        else:
            kc = torch.randn(shape, generator=gen, device=card).to(dtype)
        kw["tables"] = tables
    else:
        kc = torch.randn((2, b, 640, hkv, d), generator=gen, device=card).to(dtype)
        pos = torch.tensor([599, 580, 17, 0], dtype=torch.int64, device=card)
        kw["cursor"] = torch.tensor([599], device=card)
    vc = kc.clone()
    want = {name: t.clone() for name, t in dict(k=kc, v=vc, **kw).items()}
    want_q = pam.rope_write_kv_ref(q, k, v, pos, inv, want["k"], want["v"], layer,
                                   kw.get("tables"), kw.get("cursor"), want.get("k_scale"),
                                   want.get("v_scale"))
    before = build.launches["rope_write_kv"]
    got_q = pam.rope_write_kv(q, k, v, pos, inv, kc, vc, layer, **kw)
    torch.cuda.synchronize()
    assert build.launches["rope_write_kv"] == before + 1
    assert got_q.shape == (b, h, d) and got_q.dtype == dtype
    assert _ulp_off(got_q, want_q) == 0
    if quant:
        for got, ref in ((kc, want["k"]), (vc, want["v"])):
            assert int((got.int() - ref.int()).abs().max()) <= 1
        for name in ("k_scale", "v_scale"):
            assert _ulp_off(kw[name], want[name], dtype) == 0
    else:
        assert _ulp_off(kc, want["k"]) == 0 and torch.equal(vc, want["v"])


@pytest.mark.parametrize("layout", ["paged", "cursor"])
def test_k8a_fused_bad_targets_write_nothing(card, layout):
    b, h, hkv, d = 3, 8, 4, 64
    q, k, v = (torch.randn((b, n, d), device=card) for n in (h, hkv, hkv))
    inv = pam.rope_inv_freq(10000.0, d, card)
    if layout == "paged":
        kc = torch.randn((2, 13, hkv, 16, d), device=card)
        tables = torch.arange(1, 13, dtype=torch.int32, device=card).reshape(3, 4)
        pos = torch.tensor([0, 64, 5], dtype=torch.int32, device=card)   # past the table
        kw = dict(tables=tables)
    else:
        kc = torch.randn((2, b, 32, hkv, d), device=card)
        pos = torch.zeros(b, dtype=torch.int64, device=card)
        kw = dict(cursor=torch.tensor([32], device=card))
    vc = kc.clone()
    want = kc.clone()
    with pytest.raises(ValueError, match="write targets"):
        pam.rope_write_kv(q, k, v, pos, inv, kc, vc, 1, **kw)
    assert torch.equal(kc, want) and torch.equal(vc, want)
    pam.check_page_errors(card)


@pytest.mark.parametrize("t, dtype, quant, win", [
    (1, torch.bfloat16, False, None), (5, torch.bfloat16, False, 24), (1, torch.bfloat16, True, 24),
    (5, torch.float32, True, None), (4, torch.float16, False, None)])
def test_k8a_per_row_matches_plain_and_drops(card, t, dtype, quant, win):
    """K8a's per-row cursor mode (the slot engine's step, T = 1, and the
    verify window, T > 1) on a window view of the cache or the whole of it:
    rows parked at the last slot, at it and past it (dropped) beside live
    ones, one launch, against ``rope_write_kv_ref(cursors=)`` within one ulp
    (int8 codes within one); a negative cursor flags and writes nothing."""
    gen = torch.Generator(card).manual_seed(t + 7 * quant)
    h, hkv, d, s, layer = 32, 8, 128, 40, 1
    top = win or s
    cursors = torch.tensor([3, 0, top - 1, top, top + 7, 10], device=card)
    b = cursors.shape[0]
    q, k, v = (torch.randn((b * t, n, d), generator=gen, device=card).to(dtype)
               for n in (h, hkv, hkv))
    pos = (cursors[:, None] + torch.arange(t, device=card)[None]).reshape(-1)
    inv = pam.rope_inv_freq(10000.0, d, card)
    shape = (2, b, s, hkv, d)
    if quant:
        full = {"k": torch.randint(-127, 128, shape, generator=gen, device=card,
                                   dtype=torch.int8),
                "k_scale": torch.rand(shape[:-1] + (1,), generator=gen, device=card) + 0.1}
        full["v"], full["v_scale"] = full["k"].clone(), full["k_scale"].clone()
    else:
        full = {"k": torch.randn(shape, generator=gen, device=card).to(dtype)}
        full["v"] = full["k"].clone()
    want = {name: x.clone() for name, x in full.items()}

    def views(d_):
        return {n: (x if win is None else x[:, :, :win]) for n, x in d_.items()}

    got_v, want_v = views(full), views(want)
    want_q = pam.rope_write_kv_ref(q, k, v, pos, inv, want_v["k"], want_v["v"], layer,
                                   k_scale=want_v.get("k_scale"), v_scale=want_v.get("v_scale"),
                                   cursors=cursors)
    before = build.launches["rope_write_kv"]
    got_q = pam.rope_write_kv(q, k, v, pos, inv, got_v["k"], got_v["v"], layer, cursors=cursors,
                              k_scale=got_v.get("k_scale"), v_scale=got_v.get("v_scale"))
    torch.cuda.synchronize()
    assert build.launches["rope_write_kv"] == before + 1
    assert _ulp_off(got_q, want_q) == 0
    for name in full:
        g, w = full[name], want[name]
        if g.dtype == torch.int8:
            assert int((g.int() - w.int()).abs().max()) <= 1
        else:
            assert _ulp_off(g, w, dtype if name.endswith("scale") else None) == 0
    before = {name: x.clone() for name, x in full.items()}
    with pytest.raises(ValueError, match="write targets"):
        pam.rope_write_kv(q, k, v, pos, inv, got_v["k"], got_v["v"], layer,
                          cursors=cursors - 4, k_scale=got_v.get("k_scale"),
                          v_scale=got_v.get("v_scale"))
    assert all(torch.equal(full[n], before[n]) for n in full)


@pytest.mark.parametrize("hkv, d, dtype, src, dst, key", [
    # 128 KiB pages in two slices: a swap cycle, a self-copy, a src read twice
    (32, 128, torch.bfloat16, [2, 5, 7, 2], [5, 2, 7, 9], "copy_pages_pair"),
    (32, 128, torch.int8, [3, 4, 6, 1], [4, 6, 3, 1], "copy_pages_pair"),
    (32, None, torch.float32, [2, 5, 7, 2], [5, 2, 7, 9], "copy_pages_pair"),
    # 12 pages x 2 slices: more than a cluster holds, the gather and scatter kernels
    (32, 128, torch.bfloat16, list(range(1, 13)), list(range(2, 14)), "copy_pages_pair_gather"),
])
def test_k8b_cluster_and_gather_paths(card, hkv, d, dtype, src, dst, key):
    rank = 5 if d else 4
    kp = _pools(card, dtype, rank, 9, n_layers=2, n_pages=16, hkv=hkv, d=d or 1)
    vp = _pools(card, dtype, rank, 10, n_layers=2, n_pages=16, hkv=hkv, d=d or 1)
    src = torch.tensor(src, dtype=torch.int32, device=card)
    dst = torch.tensor(dst, dtype=torch.int32, device=card)
    page_bytes = kp[0, 0].numel() * kp.element_size()
    assert bool(pam.copy_plan(src.numel(), page_bytes)) == (key == "copy_pages_pair")
    want_k = pam.copy_pages(kp.clone(), src, dst)
    want_v = pam.copy_pages(vp.clone(), src, dst)
    before = build.launches[key]
    pam.copy_pages_pair(kp, vp, src, dst)
    assert build.launches[key] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)


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


K10_SHAPES = [(4096, 4096, 128, False), (4096, 11008, 128, False), (11008, 4096, 128, True),
              (1024, 544, 32, False)]
# M = 10 (an adaption prompt's rows), 17, 128; the training shape M = 2048 at
# one projection here (chip_smoke.py holds it at all three)
K10_CASES = ([(bits, m) + shape for bits in (2, 3, 4, 8) for m in (10, 17, 128)
              for shape in K10_SHAPES] + [(4, 2048, 4096, 4096, 128, False)])


@pytest.mark.parametrize("bits, m, k, n, gs, desc_act", K10_CASES)
def test_k10_matches_plain(card, bits, m, k, n, gs, desc_act):
    """K10 against wna16_matmul_t_ref at the Llama-2-7B projection shapes:
    bf16 to 1% of the largest output (f32 weights and accumulation on both
    sides, one bf16 rounding), f32 to 1e-4 (summation order only)."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bits=bits)
    sbits = qlin.storage_bits(bits)
    args = (layer.qweight, layer.scales, layer.zeros, layer.kperm, gs)
    for dtype, tol in ((torch.bfloat16, None), (torch.float32, 1e-4)):
        g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m), device=card,
                        dtype=dtype)
        name = _key("wna16_gemm_t", dtype, m, k, gs, n)
        before = build.launches[name]
        dx = qlin.gemm.wna16_matmul_t(g, *args, sbits)
        assert build.launches[name] == before + 1
        ref = qlin.gemm.wna16_matmul_t_ref(g, *args, sbits)
        torch.cuda.synchronize()
        assert dx.shape == (m, k) and dx.dtype == dtype
        err = (dx.float() - ref.float()).abs().max()
        scale = ref.float().abs().max()
        assert err <= (1e-2 * scale if tol is None else tol * max(1.0, float(scale)))


@pytest.mark.parametrize("desc_act", [False, True])
@pytest.mark.parametrize("bits", [3, 4])
def test_grad_through_matmul_card_matches_cpu(card, desc_act, bits):
    """torch.autograd.grad through quantlinear.matmul on the card (K1 forward,
    K10 backward) equals the CPU's (plain versions), in f32."""
    rng = np.random.default_rng(bits)
    t = random_quant_tensors(rng, 1024, 512, bits, 64, desc_act)
    packed = qlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=rng.standard_normal(512).astype(np.float32), bits=bits, group_size=64,
        in_features=1024, out_features=512)
    x = rng.standard_normal((3, 40, 1024)).astype(np.float32)
    cot = rng.standard_normal((3, 40, 512)).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        layer = qlin.from_packed(packed, device=dev, dtype=torch.float32)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        before = build.launches["wna16_gemm_t"]
        (dx,) = torch.autograd.grad((qlin.matmul(xt, layer) * torch.from_numpy(cot).to(dev)).sum(),
                                    xt)
        assert build.launches["wna16_gemm_t"] == before + (dev == "cuda")
        grads[dev] = dx.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=1e-5, atol=1e-4)


def test_k10_refuses_operands_and_launches_nothing(card):
    layer = _layer(2, 1024, 512, 64)
    g = torch.randn((8, 512), device=card, dtype=torch.bfloat16)
    args = (layer.qweight, layer.scales, layer.zeros, layer.kperm, 64, 4)
    before = build.launches["wna16_gemm_t"]
    with pytest.raises(ValueError, match="g must be"):
        qlin.gemm.wna16_matmul_t(g[:, :256].contiguous(), *args)
    with pytest.raises(ValueError, match="f32/f16/bf16"):
        qlin.gemm.wna16_matmul_t(g.to(torch.int32), *args)
    with pytest.raises(ValueError, match="contiguous"):
        qlin.gemm.wna16_matmul_t(torch.randn((512, 8), device=card).t(), *args)
    with pytest.raises(ValueError, match="scales"):
        qlin.gemm.wna16_matmul_t(g, layer.qweight, layer.scales.float(), layer.zeros, None, 64,
                                 4)
    with pytest.raises(ValueError, match="kperm"):
        qlin.gemm.wna16_matmul_t(g, layer.qweight, layer.scales, layer.zeros,
                                 torch.arange(1024, device=card, dtype=torch.int32), 64, 4)
    assert build.launches["wna16_gemm_t"] == before
    assert qlin.gemm.wna16_matmul_t(g[:0], *args).shape == (0, 1024)


@pytest.fixture(scope="module")
def expert_stacks():
    """Stacks of 8 random 4-bit experts, keyed by (K, N, group size): Mixtral's
    4096 x 14336 and 14336 x 4096 at g128, and 1024 x 1000 at g32 (N % 512 != 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return {(k, n, gs): qlin.stack_experts([_layer(7 * e + k, k, n, gs) for e in range(8)])
            for k, n, gs in ((4096, 14336, 128), (14336, 4096, 128), (1024, 1000, 32))}


K9_SELS = {1: [5], 2: [3, 6], 8: [0, 7, 7, 2, 0, 5, 1, 7]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("shape", [(4096, 14336, 128), (14336, 4096, 128), (1024, 1000, 32)])
def test_k9_matches_plain(card, expert_stacks, dtype, p, shape):
    """K9 at the decode pair counts of Mixtral (P = 2 at batch 1, P = 8 at
    beam 4, with repeated experts): bf16 and f16 through the expert-major
    tensor-core GEMV (one launch, no SIMT routed kernel, bit-equal on a second
    call), f32 through the SIMT routed kernel."""
    from autogptq_tpu_torch.ops import gemm

    sql = expert_stacks[shape]
    k = shape[0]
    x = torch.randn((p, k), generator=torch.Generator(card).manual_seed(p + k), device=card,
                    dtype=dtype)
    sel = torch.tensor(K9_SELS[p], dtype=torch.int32, device=card)
    key = gemm.ROUTED_KERNEL + ("" if dtype == torch.float32 else gemm.GEMV_SUFFIX)
    other = gemm.ROUTED_KERNEL + (gemm.GEMV_SUFFIX if dtype == torch.float32 else "")
    before = dict(build.launches)
    y = qlin.matmul_routed(x, sql, sel)
    assert build.launches[key] == before.get(key, 0) + 1
    assert build.launches[other] == before.get(other, 0)
    ref = gemm.wna16_routed_matmul_ref(x, sel, sql.qweight, sql.scales, sql.zeros,
                                       sql.group_size)
    again = qlin.matmul_routed(x, sql, sel)
    torch.cuda.synchronize()
    assert y.shape == (p, shape[1]) and y.dtype == dtype
    assert torch.equal(y, again)
    if dtype == torch.float32:
        # f32 weights and accumulation on both sides: summation order only
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
    else:
        # one bf16/f16 rounding on both sides: 1% of the largest output
        assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits, gs", [(4, 64), (3, 32)])
@pytest.mark.parametrize("sel", [[5], [3, 3], [0, 7, 7, 2, 0, 5, 1, 7], [6] * 8,
                                 [1, 4, 1, 0, 2, 3, 7, 6, 5, 4, 4, 1]])
def test_k9_gemv_serves_each_pair_once(card, dtype, bits, gs, sel):
    """The expert-major routed GEMV against the plain version at 1 to 12
    pairs: repeated experts, every pair on one expert (8 rows of one slice),
    more than 8 pairs (16-row operands), 3-bit codes in nibbles; bit-equal on
    a second call and its counters back at 0."""
    from autogptq_tpu_torch.ops import gemm

    sql = qlin.stack_experts([_layer(11 * e + bits, 1056, 544, gs, dtype=dtype, bits=bits)
                              for e in range(8)])
    p = len(sel)
    x = torch.randn((p, 1056), generator=torch.Generator(card).manual_seed(p), device=card,
                    dtype=dtype)
    s = torch.tensor(sel, dtype=torch.int32, device=card)
    before = dict(build.launches)
    y = gemm.wna16_routed_matmul(x, s, sql.qweight, sql.scales, sql.zeros, gs)
    again = gemm.wna16_routed_matmul(x, s, sql.qweight, sql.scales, sql.zeros, gs)
    assert build.launches["w4a16_routed_gemm_gemv"] == before.get("w4a16_routed_gemm_gemv", 0) + 2
    assert build.launches["w4a16_routed_gemm"] == before.get("w4a16_routed_gemm", 0)
    ref = gemm.wna16_routed_matmul_ref(x, s, sql.qweight, sql.scales, sql.zeros, gs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert torch.equal(y, again)
    _, counters = build.split_scratch("w4a16_routed_gemm_gemv", card, 0, 0)
    assert int(counters.abs().sum()) == 0


def test_k9_bad_expert_ids_write_nothing_and_raise(card, expert_stacks):
    from autogptq_tpu_torch.ops import gemm

    sql = expert_stacks[(1024, 1000, 32)]
    x = torch.randn((3, 1024), generator=torch.Generator(card).manual_seed(9), device=card)
    for bad in (-1, 8):
        sel = torch.tensor([2, bad, 6], dtype=torch.int32, device=card)
        out = torch.full((3, 1000), 7.0, device=card)
        gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 32, check=False,
                                 out=out)
        torch.cuda.synchronize()
        assert bool((out[1] == 7.0).all())
        good = torch.tensor([0, 2], device=card)
        ref = gemm.wna16_routed_matmul_ref(x[good], sel[good], sql.qweight, sql.scales,
                                           sql.zeros, 32)
        torch.testing.assert_close(out[good], ref, rtol=1e-5, atol=1e-4)
        with pytest.raises(ValueError, match="expert id"):
            gemm.check_routed_errors(card)
        gemm.check_routed_errors(card)          # the flag was cleared
        with pytest.raises(ValueError, match="expert id"):
            gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 32)
    with pytest.raises(ValueError, match="sel must be"):
        gemm.wna16_routed_matmul(x, torch.tensor([1, 2, 3], device=card), sql.qweight,
                                 sql.scales, sql.zeros, 32)


def test_k9_gemv_bad_expert_ids_leave_rows_and_set_the_flag(card, expert_stacks):
    """The routed GEMV serves no pair whose id lies outside the stack: its row
    keeps what it held, the other pairs of the launch are right, the flag is
    set (check=True raises); kernel="simt" and forced_kernel("simt") name the
    SIMT routed kernel on the same operands."""
    from autogptq_tpu_torch.ops import gemm

    sql = expert_stacks[(1024, 1000, 32)]
    x = torch.randn((4, 1024), generator=torch.Generator(card).manual_seed(9), device=card,
                    dtype=torch.bfloat16)
    for bad in (-1, 8, 1 << 20):
        sel = torch.tensor([2, bad, 6, 2], dtype=torch.int32, device=card)
        out = torch.full((4, 1000), 7.0, device=card, dtype=torch.bfloat16)
        before = build.launches["w4a16_routed_gemm_gemv"]
        gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 32, check=False,
                                 out=out)
        assert build.launches["w4a16_routed_gemm_gemv"] == before + 1
        torch.cuda.synchronize()
        assert bool((out[1] == 7.0).all())
        good = torch.tensor([0, 2, 3], device=card)
        ref = gemm.wna16_routed_matmul_ref(x[good], sel[good], sql.qweight, sql.scales,
                                           sql.zeros, 32)
        assert (out[good].float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
        with pytest.raises(ValueError, match="expert id"):
            gemm.check_routed_errors(card)
        gemm.check_routed_errors(card)
        with pytest.raises(ValueError, match="expert id"):
            gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 32)
    sel = torch.tensor([2, 5, 6, 2], dtype=torch.int32, device=card)
    before = dict(build.launches)
    ys = gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 32, kernel="simt")
    with gemm.forced_kernel("simt"):
        yf = qlin.matmul_routed(x, sql, sel)
    yg = qlin.matmul_routed(x, sql, sel)
    assert build.launches["w4a16_routed_gemm"] == before.get("w4a16_routed_gemm", 0) + 2
    assert build.launches["w4a16_routed_gemm_gemv"] == before.get("w4a16_routed_gemm_gemv", 0) + 1
    torch.cuda.synchronize()
    assert torch.equal(ys, yf)
    assert (ys.float() - yg.float()).abs().max() <= 1e-2 * ys.float().abs().max()


def test_tiny_mixtral_card_matches_cpu(card, tmp_path):
    """A tiny random Mixtral on the card (f32, K9 for routed decode, K1 for
    the dense prefill) against the CPU's plain versions: logits and greedy
    and beam-4 tokens."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import params as params_lib

    cfg = dict(model_type="mixtral", vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               num_local_experts=8, num_experts_per_tok=2, rms_norm_eps=1e-5, rope_theta=1e6,
               hidden_act="silu", tie_word_embeddings=False, sliding_window=None)
    path = write_random_checkpoint(str(tmp_path), cfg, bits=4, group_size=32, seed=2)
    models = {}
    for dev in ("cuda", "cpu"):
        m = AutoGPTQForCausalLM.from_quantized(path, device=dev, dtype=torch.float32)
        m.params = params_lib.stack_moe_experts(m.params)
        models[dev] = m
    tokens = np.random.default_rng(0).integers(1, 512, size=(2, 12))
    torch.testing.assert_close(models["cuda"].forward(tokens).cpu(), models["cpu"].forward(tokens),
                               rtol=1e-4, atol=1e-4)
    prompt = tokens[:1, :6]
    build.launches.clear()
    got = models["cuda"].generate(prompt, max_new_tokens=8)
    assert build.launches["w4a16_routed_gemm"] == 3 * 2 * 7
    np.testing.assert_array_equal(got, models["cpu"].generate(prompt, max_new_tokens=8))
    np.testing.assert_array_equal(models["cuda"].generate(prompt, max_new_tokens=6, num_beams=4),
                                  models["cpu"].generate(prompt, max_new_tokens=6, num_beams=4))


# (K, N, group size, bits, desc_act, bias): Llama-2-7B's projections (down with desc_act,
# 43 K tiles: a K split longer than the ring), N = 1312 padded to 1408, group sizes 32 and
# 256, 3-bit codes
K6_SHAPES = [(4096, 4096, 128, 4, False, False), (4096, 11008, 128, 4, False, True),
             (11008, 4096, 128, 4, True, False), (1024, 1312, 32, 4, False, True),
             (2048, 1312, 256, 3, True, True), (1312, 1312, 32, 3, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 17, 64])
@pytest.mark.parametrize("k, n, gs, bits, desc_act, bias", K6_SHAPES)
def test_k6_matches_plain(card, dtype, m, k, n, gs, bits, desc_act, bias):
    """K6 in both regimes against its plain version (at M <= 16 the
    tensor-core GEMV over the kb32l tiles for f16/bf16, the cp.async ring
    for f32; the tile kernels above): f32 to 1e-5 of the largest output
    (summation order only), f16/bf16 to 1% (one rounding on both sides).
    The last shape's K (1312) is not a whole number of 256-row tiles."""
    layer = _layer(k + n + bits, k, n, gs, desc_act, bias, dtype, bits, layout="kb32l")
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    name = _key("w4a16_kb32l_gemm", dtype, m, k, gs, n)
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    assert build.launches[name] == before.get(name, 0) + 1
    for other in ("w4a16_gemm", "w4a16_gemm_wgmma", "w4a16_gemm_mma", "w4a16_gemm_gemv"):
        assert build.launches[other] == before.get(other, 0)
    if dtype != torch.float32 and m <= 16:    # no ring launch beside the GEMV
        assert build.launches["w4a16_kb32l_gemm"] == before.get("w4a16_kb32l_gemm", 0)
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == dtype and bool(torch.isfinite(y).all())
    scale = ref.float().abs().max()
    tol = 1e-5 * max(1.0, float(scale)) if dtype == torch.float32 else 1e-2 * scale
    assert (y.float() - ref.float()).abs().max() <= tol
    torch.testing.assert_close(qlin.matmul(x, layer), y, rtol=0, atol=0)   # deterministic


def test_k6_refuses_operands_and_launches_nothing(card):
    layer = _layer(3, 1024, 256, 64, layout="kb32l")
    from autogptq_tpu_torch.ops import gemm

    x = torch.randn((4, 1024), device=card, dtype=torch.bfloat16)
    args = (layer.qweight, layer.scales, layer.zeros, None, None, 64, 256)
    before = build.launches["w4a16_kb32l_gemm"]
    with pytest.raises(ValueError, match="f32/f16/bf16"):
        gemm.w4a16_kb32l_matmul(x.to(torch.int32), *args)
    with pytest.raises(ValueError, match="qweight"):     # K comes from x: 512 rows, 2 tiles
        gemm.w4a16_kb32l_matmul(x[:, :512].contiguous(), *args)
    with pytest.raises(ValueError, match="qweight"):
        gemm.w4a16_kb32l_matmul(x, layer.qweight[:2].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="scales"):
        gemm.w4a16_kb32l_matmul(x, layer.qweight, layer.scales.float(), *args[2:])
    with pytest.raises(NotImplementedError, match="kb32l"):
        gemm.w4a16_kb32l_matmul(x, *args[:5], 96, 256)
    assert build.launches["w4a16_kb32l_gemm"] == before
    assert gemm.w4a16_kb32l_matmul(x[:0], *args).shape == (0, 256)


def test_k6_gemv_ring_and_counters(card):
    """At M <= 16 bf16 takes the GEMV over the kb32l tiles and f32 the ring;
    kernel="simt" and forced_kernel("simt") name the ring on bf16 operands;
    layers of other shapes back to back leave the GEMV's counters at 0 and
    repeat the first result bit for bit."""
    from autogptq_tpu_torch.ops import gemm

    layer = _layer(4, 4096, 1312, 128, bias=True, layout="kb32l")
    x = torch.randn((5, 4096), generator=torch.Generator(card).manual_seed(4), device=card,
                    dtype=torch.bfloat16)
    before = dict(build.launches)
    yg = qlin.matmul(x, layer)
    ys = gemm.w4a16_kb32l_matmul(x, layer.qweight, layer.scales, layer.zeros, None, layer.bias,
                                 128, 1312, kernel="simt")
    with gemm.forced_kernel("simt"):
        yf = qlin.matmul(x, layer)
    assert build.launches["w4a16_kb32l_gemm_gemv"] == before.get("w4a16_kb32l_gemm_gemv", 0) + 1
    assert build.launches["w4a16_kb32l_gemm"] == before.get("w4a16_kb32l_gemm", 0) + 2
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    assert torch.equal(ys, yf)
    for y in (yg, ys):
        assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    first = yg
    for k, n, gs, m in ((1024, 1312, 32, 16), (1312, 1312, 32, 3), (11008, 4096, 128, 1)):
        other = _layer(k + m, k, n, gs, layout="kb32l")
        xo = torch.randn((m, k), device=card, dtype=torch.bfloat16)
        yo = qlin.matmul(xo, other)
        ro = qlin.matmul_plain(xo, other)
        torch.cuda.synchronize()
        assert (yo.float() - ro.float()).abs().max() <= 1e-2 * ro.float().abs().max()
    assert torch.equal(qlin.matmul(x, layer), first)
    _, counters = build.split_scratch("w4a16_kb32l_gemm_gemv", card, 0, 0)
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("m", [10, 64, 2048])
@pytest.mark.parametrize("k, n, gs, bits, desc_act, bias", K6_SHAPES[1:])
def test_k10_over_kb32l_matches_plain(card, m, k, n, gs, bits, desc_act, bias):
    """K10 reading K6's kb32l words against its plain version, bf16 to 1% and
    f32 to 1e-4 (as test_k10_matches_plain), and a backward through a kb32l
    layer launches it."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, False, bits=bits, layout="kb32l")
    for dtype, tol in ((torch.bfloat16, None), (torch.float32, 1e-4)):
        g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m), device=card,
                        dtype=dtype)
        name = _key("wna16_gemm_t", dtype, m, k, gs, n, layout="kb32l")
        before = build.launches[name]
        dx = qlin.matmul_t(g, layer)
        assert build.launches[name] == before + 1
        ref = qlin.gemm.wna16_matmul_t_ref(g, *qlin.gptq_tensors(layer), layer.kperm, gs, 4)
        torch.cuda.synchronize()
        assert dx.shape == (m, k) and dx.dtype == dtype
        err = (dx.float() - ref.float()).abs().max()
        scale = ref.float().abs().max()
        assert err <= (1e-2 * scale if tol is None else tol * max(1.0, float(scale)))
    x = torch.randn((3, k), device=card, requires_grad=True)
    before = build.launches["wna16_gemm_t"]
    qlin.matmul(x, layer).float().sum().backward()
    assert build.launches["wna16_gemm_t"] == before + 1 and x.grad is not None



@pytest.mark.parametrize("p", [2, 8])
def test_routed_gradient_card_matches_cpu(card, p):
    """dx through quantlinear.matmul_routed on the card (K9 forward, K10 per
    selected expert backward) equals the CPU's (plain versions), in f32."""
    rng = np.random.default_rng(p)
    packs = []
    for _ in range(8):
        t = random_quant_tensors(rng, 1024, 512, 4, 64, False)
        packs.append(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=None, bits=4, group_size=64, in_features=1024, out_features=512))
    sel = np.array(K9_SELS[p], np.int32)
    x = rng.standard_normal((p, 1024)).astype(np.float32)
    cot = rng.standard_normal((p, 512)).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        sql = qlin.stack_experts([qlin.from_packed(pk, device=dev, dtype=torch.float32)
                                  for pk in packs])
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        before = dict(build.launches)
        y = qlin.matmul_routed(xt, sql, torch.from_numpy(sel).to(dev))
        (dx,) = torch.autograd.grad((y * torch.from_numpy(cot).to(dev)).sum(), xt)
        if dev == "cuda":
            assert build.launches["w4a16_routed_gemm"] == before.get("w4a16_routed_gemm", 0) + 1
            assert build.launches["wna16_gemm_t"] == before.get("wna16_gemm_t", 0) + len(set(sel))
        grads[dev] = dx.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=1e-5, atol=1e-4)


def test_tiny_llama_kb32l_card_matches_cpu(card, tmp_path):
    """A tiny random Llama loaded with layout="kb32l" on the card (f32, K6) against
    the CPU (plain versions): logits and greedy tokens; no K1 launch."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM

    cfg = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
               tie_word_embeddings=False)
    path = write_random_checkpoint(str(tmp_path), cfg, bits=4, group_size=64, desc_act=True,
                                   seed=6)
    models = {dev: AutoGPTQForCausalLM.from_quantized(path, device=dev, dtype=torch.float32,
                                                      layout="kb32l") for dev in ("cuda", "cpu")}
    tokens = np.random.default_rng(0).integers(1, 512, size=(2, 12))
    torch.testing.assert_close(models["cuda"].forward(tokens).cpu(), models["cpu"].forward(tokens),
                               rtol=1e-4, atol=1e-4)
    prompt = tokens[:1, :6]
    build.launches.clear()
    got = models["cuda"].generate(prompt, max_new_tokens=8)
    assert build.launches["w4a16_kb32l_gemm"] == 7 * 2 * 8 and build.launches["w4a16_gemm"] == 0
    assert build.launches["w4a16_kb32l_gemm_gemv"] == 0     # f32 takes the ring
    np.testing.assert_array_equal(got, models["cpu"].generate(prompt, max_new_tokens=8))


def test_bf16_kb32l_and_mixtral_paths_take_the_gemvs(card, tmp_path):
    """bf16 greedy decode of a tiny kb32l Llama and a tiny Mixtral on the
    card: exact launch counts of K6's and K9's tensor-core GEMVs, no K6 ring
    and no SIMT routed kernel (so no split-K reduce of either), and the tokens
    of the same models forced through those SIMT kernels."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import params as params_lib

    llama = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                 rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
                 tie_word_embeddings=False)
    mixtral = dict(llama, model_type="mixtral", num_local_experts=8, num_experts_per_tok=2,
                   rope_theta=1e6, sliding_window=None)
    prompt = np.random.default_rng(0).integers(1, 512, size=(1, 6))
    for cfg, kw, key, simt in ((llama, dict(layout="kb32l"), "w4a16_kb32l_gemm_gemv",
                                "w4a16_kb32l_gemm"),
                               (mixtral, {}, "w4a16_routed_gemm_gemv", "w4a16_routed_gemm")):
        path = write_random_checkpoint(str(tmp_path / cfg["model_type"]), cfg, bits=4,
                                       group_size=64, seed=3)
        model = AutoGPTQForCausalLM.from_quantized(path, device="cuda", dtype=torch.bfloat16,
                                                   **kw)
        if cfg is mixtral:
            model.params = params_lib.stack_moe_experts(model.params)
        build.launches.clear()
        got = model.generate(prompt, max_new_tokens=8)
        # kb32l: 7 projections x 2 layers for the prefill and each of 7 decode steps; Mixtral:
        # gate, up and down x 2 layers per decode step (the 12-pair prefill is dense)
        want = 7 * 2 * 8 if cfg is llama else 3 * 2 * 7
        assert build.launches[key] == want and build.launches[simt] == 0, dict(build.launches)
        with qlin.gemm.forced_kernel("simt"):
            build.launches.clear()
            forced = model.generate(prompt, max_new_tokens=8)
            assert build.launches[simt] == want and build.launches[key] == 0
        assert got.shape == forced.shape == (1, 14)
        # bf16 sums in another order may flip a near tie: the first decoded token must agree
        np.testing.assert_array_equal(got[:, :7], forced[:, :7])


# The tensor-core tile kernels (csrc/wna16_mma.cuh): (K, N, group size, desc_act, bias), N not
# a multiple of the 128-column block tile (544, 1056), K not a multiple of the 128-row dx tile
# (1056), group sizes 16, 32, 128 and one group (-1).
MMA_SHAPES = [(1024, 544, 16, False, False), (1024, 1056, 32, True, True),
              (2048, 4096, 128, False, True), (1056, 544, -1, False, False),
              (4096, 4096, 128, True, False)]
MMA_DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [17, 70, 129, 2048])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k, n, gs, desc_act, bias", MMA_SHAPES)
def test_mma_tile_kernel_matches_plain(card, dtype, m, bits, k, n, gs, desc_act, bias):
    """K1/K4/K5's mma.sync tile kernel (``kernel="mma"`` names it since
    the wgmma kernel took its route) against the plain version: f32
    accumulation of the exact (q - z) and the f32 scale fold against the f32
    product, one rounding on both sides: 1% of the largest output (K1_REL_TOL)."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bias, dtype, bits)
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    name = KERNEL_OF_BITS[bits] + qlin.gemm.MMA_SUFFIX
    before = dict(build.launches)
    with qlin.gemm.forced_kernel("mma"):
        y = qlin.matmul(x, layer)
    assert build.launches[name] == before.get(name, 0) + 1
    assert build.launches[KERNEL_OF_BITS[bits]] == before.get(KERNEL_OF_BITS[bits], 0)
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == dtype and bool(torch.isfinite(y).all())
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    with qlin.gemm.forced_kernel("mma"):
        torch.testing.assert_close(qlin.matmul(x, layer), y, rtol=0, atol=0)   # deterministic


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [1, 4, 16, 17, 70, 129, 2048])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k, n, gs, desc_act", [s[:4] for s in MMA_SHAPES])
def test_mma_k10_matches_plain(card, dtype, m, bits, k, n, gs, desc_act):
    """K10's tensor-core tile kernel at every M (1, 4 and 16 too, where
    ``kernel="mma"`` names it: K10's decode regime takes those rows) against
    wna16_matmul_t_ref: the scaled weight as a hi/lo pair of the cotangent's
    type, f32 accumulation: 1% of the largest output (K10_REL_TOL)."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bits=bits)
    sbits = qlin.storage_bits(bits)
    args = (layer.qweight, layer.scales, layer.zeros, layer.kperm, gs)
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    before = dict(build.launches)
    dx = qlin.gemm.wna16_matmul_t(g, *args, sbits, kernel="mma")
    assert build.launches["wna16_gemm_t_mma"] == before.get("wna16_gemm_t_mma", 0) + 1
    assert build.launches["wna16_gemm_t"] == before.get("wna16_gemm_t", 0)
    ref = qlin.gemm.wna16_matmul_t_ref(g, *args, sbits)
    torch.cuda.synchronize()
    assert dx.shape == (m, k) and dx.dtype == dtype and bool(torch.isfinite(dx).all())
    assert (dx.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [17, 129, 2048])
@pytest.mark.parametrize("k, n, gs, bits, desc_act, bias", [K6_SHAPES[0], K6_SHAPES[3],
                                                            K6_SHAPES[4]])
def test_mma_over_kb32l_words_matches_plain(card, dtype, m, k, n, gs, bits, desc_act, bias):
    """K6's mma.sync tile kernel (``kernel="mma"`` names it since the wgmma
    kernel took K6's route) and K10 over kb32l words (its route) take the
    tensor-core kernels (Kb32lWords address, scales and zeros of the padded
    width)."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bias, dtype, bits, layout="kb32l")
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m + 1), device=card,
                    dtype=dtype)
    before = dict(build.launches)
    with qlin.gemm.forced_kernel("mma"):
        y = qlin.matmul(x, layer)
    dx = qlin.matmul_t(g, layer)
    assert build.launches["w4a16_kb32l_gemm_mma"] == before.get("w4a16_kb32l_gemm_mma", 0) + 1
    assert build.launches["wna16_gemm_t_mma"] == before.get("wna16_gemm_t_mma", 0) + 1
    ref = qlin.matmul_plain(x, layer)
    ref_t = qlin.gemm.wna16_matmul_t_ref(g, *qlin.gptq_tensors(layer), layer.kperm, gs, 4)
    torch.cuda.synchronize()
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert (dx.float() - ref_t.float()).abs().max() <= 1e-2 * ref_t.float().abs().max()


def test_f32_stays_on_the_simt_tile_kernels(card):
    """f32 activations and cotangents at M > 16 take the SIMT kernels (f32
    weights); bf16 takes the tensor-core kernels (the wgmma/TMA
    ones), also at a group size that 16 does not divide; their counters say so."""
    for bits in (2, 4, 8):
        name = KERNEL_OF_BITS[bits]
        for dtype, gs, route in ((torch.float32, 32, ""), (torch.bfloat16, 24, "_wgmma"),
                                 (torch.bfloat16, 32, "_wgmma")):
            layer = _layer(bits, 768, 256, gs, dtype=dtype, bits=bits)
            before = dict(build.launches)
            qlin.matmul(torch.randn((64, 768), device=card, dtype=dtype), layer)
            qlin.matmul_t(torch.randn((64, 256), device=card, dtype=dtype), layer)
            assert build.launches[name + route] == before.get(name + route, 0) + 1
            assert build.launches["wna16_gemm_t" + route] == \
                before.get("wna16_gemm_t" + route, 0) + 1
            for other in {"", "_mma", "_wgmma"} - {route}:
                assert build.launches[name + other] == before.get(name + other, 0)
                assert build.launches["wna16_gemm_t" + other] == \
                    before.get("wna16_gemm_t" + other, 0)


# The rest classes: group sizes that the codes per word do not divide (a word straddles
# groups), and a partial last group (gs 100, K 4096: 41 groups). (bits, K, N, gs, desc_act)
REST_CASES = [(4, 1024, 256, 4, False), (4, 1032, 256, 12, True), (4, 4096, 512, 100, False),
              (3, 1056, 256, 12, False), (2, 1024, 256, 8, False), (2, 1056, 256, 24, True),
              (8, 1024, 256, 2, False), (8, 1020, 256, 6, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 70])
@pytest.mark.parametrize("bits, k, n, gs, desc_act", REST_CASES)
def test_rest_classes_match_plain(card, dtype, m, bits, k, n, gs, desc_act):
    """K1/K4/K5 (in bf16 the tensor-core GEMV's ANY_GS instance at M <= 16
    from group size 16 on, the SIMT GEMV below, and the tile kernel's ANY_GS
    instance above 16 rows; the SIMT GEMV and tile kernel in f32) and K10 (in
    bf16 its decode regime at M <= 16 and the tensor-core ANY_GS instance
    above; the SIMT kernel in f32) at the rest classes, against the plain
    versions: f32 to 1e-4, bf16 to 1% of the largest output, each bit-equal on
    a second call; in bf16 the SIMT kernels on the same weights
    (``gemm.forced_kernel("simt")``) within 1% of the largest output of the
    tensor-core kernels', and below group size 16 at M <= 16 the GEMV's
    ANY_GS instance, asked for (``kernel="gemv"``), likewise and bit-equal."""
    layer = _layer(m + k + bits + gs, k, n, gs, desc_act, True, dtype, bits)
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m + 1), device=card,
                    dtype=dtype)
    name = KERNEL_OF_BITS[bits]
    fwd = _key(name, dtype, m, k, gs, n)
    k10 = _key("wna16_gemm_t", dtype, m, k, gs, n)
    tile = "_wgmma" if qlin.gemm.wgmma_shape_ok(k, n) else "_mma"   # K = 1020: by shape
    tc = "" if dtype == torch.float32 else "_gemv" if m <= 16 else tile
    assert fwd == name + (tc if gs >= 16 or m > 16 else "") and k10 == "wna16_gemm_t" + tc
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    dx = qlin.matmul_t(g, layer)
    for key in {name, name + "_mma", name + "_wgmma", name + "_gemv", "wna16_gemm_t",
                "wna16_gemm_t_mma", "wna16_gemm_t_wgmma", "wna16_gemm_t_gemv"}:
        assert build.launches[key] == before.get(key, 0) + (key in (fwd, k10)), key
    ref = qlin.matmul_plain(x, layer)
    ref_t = qlin.gemm.wna16_matmul_t_ref(g, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm, gs, qlin.storage_bits(bits))
    torch.cuda.synchronize()
    for got, want in ((y, ref), (dx, ref_t)):
        scale = float(want.float().abs().max())
        tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 1e-2 * scale
        assert bool(torch.isfinite(got).all()) and (got.float() - want.float()).abs().max() <= tol
    torch.testing.assert_close(qlin.matmul(x, layer), y, rtol=0, atol=0)   # deterministic
    torch.testing.assert_close(qlin.matmul_t(g, layer), dx, rtol=0, atol=0)
    if dtype == torch.bfloat16:
        with qlin.gemm.forced_kernel("simt"):
            ys, dxs = qlin.matmul(x, layer), qlin.matmul_t(g, layer)
        for got, simt in ((y, ys), (dx, dxs)):
            assert (got.float() - simt.float()).abs().max() <= 1e-2 * got.float().abs().max()
        if m <= 16 and gs < 16:
            args = (layer.qweight, layer.scales, layer.zeros, layer.kperm, qlin._bias(layer, x),
                    gs, qlin.storage_bits(bits))
            yg = qlin.gemm.wna16_matmul(x, *args, kernel="gemv")
            scale = float(ref.float().abs().max())
            assert (yg.float() - ref.float()).abs().max() <= 1e-2 * scale
            assert torch.equal(qlin.gemm.wna16_matmul(x, *args, kernel="gemv"), yg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gs", [12, 100])
def test_k9_rest_classes_match_plain(card, gs, dtype):
    """K9 at the rest classes (4-bit, gs % 8 != 0) against its plain version:
    f32, and bf16 below group size 16, through the SIMT routed kernel's
    per-code group instance (f32 to 1e-5 relative), bf16 from group size 16
    on through the routed GEMV's ANY_GS instance (one launch, 1% of the
    largest output, bit-equal on a second call; below 16 asked for with
    ``kernel="gemv"``)."""
    from autogptq_tpu_torch.ops import gemm

    rng = np.random.default_rng(gs)
    qls = []
    for _ in range(4):
        t = random_quant_tensors(rng, 1200, 512, 4, gs, False)
        qls.append(qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=None, bits=4, group_size=gs, in_features=1200, out_features=512),
            device="cuda", dtype=dtype))
    sql = qlin.stack_experts(qls)
    sel = torch.tensor([3, 0, 3], dtype=torch.int32, device=card)
    x = torch.randn((3, 1200), generator=torch.Generator(card).manual_seed(gs), device=card,
                    dtype=dtype)
    key = gemm.ROUTED_KERNEL + ("_gemv" if dtype == torch.bfloat16 and gs >= 16 else "")
    before = dict(build.launches)
    y = gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, gs)
    assert build.launches[key] == before.get(key, 0) + 1
    ref = gemm.wna16_routed_matmul_ref(x, sel, sql.qweight, sql.scales, sql.zeros, gs)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
    else:
        assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
        assert torch.equal(gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales,
                                                    sql.zeros, gs), y)
        yg = gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, gs,
                                      kernel="gemv")
        assert (yg.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
        assert torch.equal(gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales,
                                                    sql.zeros, gs, kernel="gemv"), yg)


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [1, 4, 10, 16])
@pytest.mark.parametrize("bits, k, n, gs, desc_act", REST_CASES + [
    (4, 4096, 4096, 128, False), (3, 4096, 1024, 128, True)])
def test_k10_gemv_matches_plain(card, dtype, m, bits, k, n, gs, desc_act):
    """K10's decode regime (split N, the weight as a hi/lo pair) at every rest
    class and g128: one launch of ``wna16_gemm_t_gemv``, within 1% of the
    largest output of the plain version and of the tile K10 on the same
    operands (``kernel="mma"``), bit-equal on a second call."""
    layer = _layer(m + k + bits + gs, k, n, gs, desc_act, dtype=dtype, bits=bits)
    args = (layer.qweight, layer.scales, layer.zeros, layer.kperm, gs, qlin.storage_bits(bits))
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m + k), device=card,
                    dtype=dtype)
    before = dict(build.launches)
    dx = qlin.gemm.wna16_matmul_t(g, *args)
    assert build.launches["wna16_gemm_t_gemv"] == before.get("wna16_gemm_t_gemv", 0) + 1
    assert build.launches["wna16_gemm_t_mma"] == before.get("wna16_gemm_t_mma", 0)
    again = qlin.gemm.wna16_matmul_t(g, *args)
    tile = qlin.gemm.wna16_matmul_t(g, *args, kernel="mma")
    ref = qlin.gemm.wna16_matmul_t_ref(g, *args)
    torch.cuda.synchronize()
    scale = ref.float().abs().max()
    assert dx.shape == (m, k) and bool(torch.isfinite(dx).all())
    assert (dx.float() - ref.float()).abs().max() <= 1e-2 * scale
    assert (dx.float() - tile.float()).abs().max() <= 1e-2 * scale
    assert torch.equal(dx, again)


# The tensor-core decode GEMV (csrc/wna16_gemv.cuh). (K, N, group size, desc_act, bias):
# group sizes 32, 64, 128 and one group (-1), N = 1312 (not a whole number of 64-column
# tiles) and Mixtral-8x7B's k/v projection (N = 1024: 32 splits of one stage each).
GEMV_SHAPES = [(4096, 4096, 128, False, False), (11008, 4096, 128, True, True),
               (1024, 1312, 32, True, True), (2048, 1024, 64, False, True),
               (4096, 1024, 128, False, False), (1056, 544, -1, False, True)]


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 16])
def test_gemv_matches_plain(card, dtype, bits, m):
    """K1/K4/K5's tensor-core GEMV against the plain version at every shape
    of GEMV_SHAPES: one launch of ``<name>_gemv`` and no SIMT GEMV, 1% of the
    largest output (f32 accumulation of the exact q - z and one rounding on
    both sides), and bit-equal on a second call (the split order is fixed)."""
    name = KERNEL_OF_BITS[bits]
    for i, (k, n, gs, desc_act, bias) in enumerate(GEMV_SHAPES):
        if k % (32 // qlin.storage_bits(bits)):
            continue
        layer = _layer(m + k + n + bits + i, k, n, gs, desc_act, bias, dtype, bits)
        x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m + i), device=card,
                        dtype=dtype)
        before = dict(build.launches)
        y = qlin.matmul(x, layer)
        assert build.launches[name + "_gemv"] == before.get(name + "_gemv", 0) + 1
        assert build.launches[name] == before.get(name, 0)
        ref = qlin.matmul_plain(x, layer)
        again = qlin.matmul(x, layer)
        torch.cuda.synchronize()
        assert y.shape == (m, n) and y.dtype == dtype and bool(torch.isfinite(y).all())
        assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max(), (k, n, gs)
        assert torch.equal(y, again), (k, n, gs)


def test_gemv_counters_reset_between_shapes(card):
    """Layers of other shapes, widths and row counts back to back on one
    stream share the workspace and the ticket counters: every result stays
    right, the first layer's is bit-equal when it comes again, and every
    counter is back at 0."""
    cases = [(4, 4096, 4096, 128, 1), (4, 1024, 1312, 32, 16), (8, 2048, 1024, 64, 5),
             (2, 4096, 1024, 128, 3), (3, 11008, 4096, 128, 9), (4, 4096, 4096, 128, 1)]
    first = None
    for i, (bits, k, n, gs, m) in enumerate(cases):
        layer = _layer(bits + k + n, k, n, gs, bias=True, bits=bits)
        x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(k + m), device=card,
                        dtype=torch.bfloat16)
        y = qlin.matmul(x, layer)
        ref = qlin.matmul_plain(x, layer)
        torch.cuda.synchronize()
        assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
        if i == 0:
            first = y
        elif i == len(cases) - 1:
            assert torch.equal(y, first)
    for bits in (2, 4, 8):
        _, counters = build.split_scratch(KERNEL_OF_BITS[bits] + "_gemv", card, 0, 0)
        assert int(counters.abs().sum()) == 0


def test_f32_and_rest_classes_take_the_simt_gemv(card):
    """At M <= 16, f32 activations launch the SIMT GEMV and no ``_gemv``
    kernel, while bf16/f16 at group sizes of 16 or more that 16 does not
    divide (24, 100) launch the tensor-core GEMV's ANY_GS instance; ``kernel="simt"`` forces the SIMT
    GEMV for bf16 with 16 | gs, and ``gemm.forced_kernel`` does so for every
    call inside it."""
    for bits in (2, 4, 8):
        name = KERNEL_OF_BITS[bits]
        for dtype, gs in ((torch.float32, 32), (torch.bfloat16, 24), (torch.float16, 100)):
            layer = _layer(bits + gs, 1200, 256, gs, dtype=dtype, bits=bits)
            x = torch.randn((4, 1200), device=card, dtype=dtype)
            key = name + ("" if dtype == torch.float32 else "_gemv")
            other = name + ("_gemv" if dtype == torch.float32 else "")
            before = dict(build.launches)
            y = qlin.matmul(x, layer)
            assert build.launches[key] == before.get(key, 0) + 1
            assert build.launches[other] == before.get(other, 0)
            ref = qlin.matmul_plain(x, layer)
            tol = 1e-4 * max(1.0, float(ref.abs().max())) if dtype == torch.float32 \
                else 1e-2 * float(ref.float().abs().max())
            assert (y.float() - ref.float()).abs().max() <= tol
        layer = _layer(bits, 1024, 256, 64, bits=bits)
        x = torch.randn((3, 1024), device=card, dtype=torch.bfloat16)
        before = dict(build.launches)
        ys = qlin.gemm.wna16_matmul(x, layer.qweight, layer.scales, layer.zeros, None, None, 64,
                                    qlin.storage_bits(bits), kernel="simt")
        with qlin.gemm.forced_kernel("simt"):
            yf = qlin.matmul(x, layer)
        yg = qlin.matmul(x, layer)
        assert build.launches[name] == before.get(name, 0) + 2
        assert build.launches[name + "_gemv"] == before.get(name + "_gemv", 0) + 1
        torch.cuda.synchronize()
        assert torch.equal(ys, yf)
        assert (ys.float() - yg.float()).abs().max() <= 1e-2 * ys.float().abs().max()


# The wgmma/TMA tile kernels (csrc/wna16_wgmma.cuh): the shapes of the mma.sync tests (N off the
# 128-column block, K off the 64-row tile, group sizes 16, 32, 128 and one group) and the rest
# classes: 8-bit gs 6, 4-bit gs 12 desc_act, gs 100 (a partial last group), gs 172 desc_act.
WGMMA_SHAPES = MMA_SHAPES + [(1024, 512, 6, False, True), (1032, 256, 12, True, True),
                             (4096, 512, 100, False, False), (11008, 512, 172, True, False)]
WGMMA_KEYS = ("", "_mma", "_wgmma", "_gemv")
PACK_ROWS = {2: 16, 3: 32, 4: 8, 8: 4}   # K rows a checkpoint packs together


def _one_launch(before, name, suffix):
    """Exactly one launch of ``name + suffix`` and none of its other kernels."""
    for sfx in WGMMA_KEYS:
        assert build.launches[name + sfx] == before.get(name + sfx, 0) + (sfx == suffix), sfx


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [17, 64, 65, 129, 2048])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k, n, gs, desc_act, bias", WGMMA_SHAPES)
def test_wgmma_forward_matches_plain(card, dtype, m, bits, k, n, gs, desc_act, bias):
    """K1/K4/K5's wgmma/TMA kernel, the route above 16 rows, against the plain
    version: the weight as a hi/lo pair of the activation type (about 16
    significant bits) and f32 sums against the f32 weight and product, one
    rounding of the output on both sides: 1% of the largest output
    (K1_REL_TOL); one launch of its key and no other K1 kernel; bit-equal on a
    second call (a split reduction's partials are added in a fixed order)."""
    if k % PACK_ROWS[bits]:
        pytest.skip(f"no {bits}-bit checkpoint holds K = {k}")
    layer = _layer(m + k + bits + gs, k, n, gs, desc_act, bias, dtype, bits)
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    name = KERNEL_OF_BITS[bits]
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    _one_launch(before, name, "_wgmma")
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == dtype and bool(torch.isfinite(y).all())
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert torch.equal(qlin.matmul(x, layer), y)


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [17, 64, 65, 129, 2048])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k, n, gs, desc_act, bias", WGMMA_SHAPES)
def test_wgmma_k10_matches_plain(card, dtype, m, bits, k, n, gs, desc_act, bias):
    """K10's wgmma/TMA kernel, the route above 16 rows, against
    wna16_matmul_t_ref: the weight as a hi/lo pair of the cotangent's type (as
    the forward's), f32 sums, dx through kperm, against the f32 weight and
    product, one rounding of dx on both sides: 1% of the largest output
    (K10_REL_TOL); one launch of its key and no other K10 kernel; bit-equal on
    a second call."""
    if k % PACK_ROWS[bits]:
        pytest.skip(f"no {bits}-bit checkpoint holds K = {k}")
    layer = _layer(m + k + bits + gs, k, n, gs, desc_act, dtype=dtype, bits=bits)
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m + 1), device=card,
                    dtype=dtype)
    before = dict(build.launches)
    dx = qlin.matmul_t(g, layer)
    _one_launch(before, "wna16_gemm_t", "_wgmma")
    ref = qlin.gemm.wna16_matmul_t_ref(g, layer.qweight, layer.scales, layer.zeros, layer.kperm,
                                       gs, qlin.storage_bits(bits))
    torch.cuda.synchronize()
    assert dx.shape == (m, k) and dx.dtype == dtype and bool(torch.isfinite(dx).all())
    assert (dx.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert torch.equal(qlin.matmul_t(g, layer), dx)


@pytest.mark.parametrize("k, n, bits", [(1020, 256, 8), (1024, 520, 4), (1024, 260, 8)])
def test_wgmma_misaligned_shapes_take_mma_by_shape(card, k, n, bits):
    """A K or N whose rows TMA cannot address (K % 8, N % 16) goes to the
    mma.sync kernels by the route's shape rule, forward and K10, with results
    within 1% of the plain versions; naming the wgmma kernel for it raises
    and launches nothing."""
    layer = _layer(k + n, k, n, 4 if k % 32 else 32, bits=bits)
    x = torch.randn((70, k), device=card, dtype=torch.bfloat16)
    g = torch.randn((70, n), device=card, dtype=torch.bfloat16)
    name = KERNEL_OF_BITS[bits]
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    dx = qlin.matmul_t(g, layer)
    _one_launch(before, name, "_mma")
    _one_launch(before, "wna16_gemm_t", "_mma")
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    before = dict(build.launches)
    with qlin.gemm.forced_kernel("wgmma"), pytest.raises(NotImplementedError, match="TMA"):
        qlin.matmul(x, layer)
    assert dict(build.launches) == before


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [17, 64, 128, 2048])
@pytest.mark.parametrize("k, n, gs, bits, desc_act, bias",
                         K6_SHAPES + [(4096, 4104, 128, 4, False, True)])
def test_kb32l_wgmma_matches_plain(card, dtype, m, k, n, gs, bits, desc_act, bias):
    """K6's tile regime on the wgmma/TMA kernel (the words through the 3-D map
    of the kb32l tiles, the scales and zeros of the padded width, x gathered
    by kperm; K 1312 is not a whole number of 256-row tiles, N 1312 not of
    128 columns, N 4104 not of 16) against the plain version: 1% of the largest output
    (K1_REL_TOL), one launch of ``w4a16_kb32l_gemm_wgmma`` and no other K6 or
    K1 kernel, bit-equal on a second call."""
    layer = _layer(m + k + n + bits, k, n, gs, desc_act, bias, dtype, bits, layout="kb32l")
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    _one_launch(before, "w4a16_kb32l_gemm", "_wgmma")
    _one_launch(before, "w4a16_gemm", None)
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == dtype and bool(torch.isfinite(y).all())
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert torch.equal(qlin.matmul(x, layer), y)


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m, k", [(17, 4096), (24, 11008), (31, 1056), (1, 64)])
def test_prenorm_rstd_matches_plain(card, dtype, m, k):
    """The wgmma prologue's rstd (``wg_rstd_kernel``) against its plain
    version on the CPU: 1e-5 relative (f32 sums in another order), one launch
    of its key, bit-equal on a second call."""
    x = 4.0 * torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                          dtype=dtype)
    key = qlin.gemm.RSTD_KERNEL
    before = build.launches[key]
    got = qlin.gemm.prenorm_rstd(x, 1e-5)
    assert build.launches[key] == before + 1
    want = qlin.gemm.prenorm_rstd(x.cpu(), 1e-5)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    assert torch.equal(qlin.gemm.prenorm_rstd(x, 1e-5), got)


# (M, dtype, bits, plus_one, norm weight dtype, K, N): the fused prologue's rows above the
# GEMV's (17-31), 3-bit codes, gemma's 1 + w, an f32 norm weight, K off the 64-row tile
PRENORM_CASES = [(17, torch.bfloat16, 4, False, None, 4096, 4096),
                 (24, torch.bfloat16, 4, False, None, 4096, 11008),
                 (31, torch.bfloat16, 4, False, None, 4096, 4096),
                 (24, torch.float16, 4, False, None, 4096, 4096),
                 (24, torch.bfloat16, 3, False, None, 4096, 4096),
                 (20, torch.bfloat16, 4, True, None, 4096, 4096),
                 (31, torch.float16, 4, False, torch.float32, 1056, 544)]


@pytest.mark.parametrize("m, dtype, bits, plus_one, wdt, k, n", PRENORM_CASES)
def test_prenorm_wgmma_matches_plain(card, m, dtype, bits, plus_one, wdt, k, n):
    """K1's fused RMS-norm prologue on the wgmma/TMA kernel (17-31 rows)
    against ``rms_apply`` and the plain matmul: 1% of the largest output
    (K1_REL_TOL), one launch of ``w4a16_gemm_wgmma_norm`` and no other K1
    kernel, bit-equal on a second call; a norm weight off 16-byte alignment
    gives the same result."""
    layer = _layer(m + k + bits, k, n, 32 if k % 128 else 128, dtype=dtype, bits=bits)
    gen = torch.Generator(card).manual_seed(m)
    x = 4.0 * torch.randn((m, k), generator=gen, device=card, dtype=dtype)
    w = (1.0 + 0.1 * torch.randn((k,), generator=gen, device=card)).to(wdt or dtype)
    pn = (w, 1e-5, plus_one)
    assert qlin.gemm.route(dtype, m, layer.group_size, k=k, n=n) == "wgmma"
    before = dict(build.launches)
    y = qlin.matmul(x, layer, prenorm=pn)
    assert build.launches["w4a16_gemm_wgmma_norm"] == before.get("w4a16_gemm_wgmma_norm", 0) + 1
    rstd = qlin.gemm.RSTD_KERNEL
    assert build.launches[rstd] == before.get(rstd, 0) + 1
    for sfx in WGMMA_KEYS + ("_mma_norm", "_gemv_norm", "_norm"):
        assert build.launches["w4a16_gemm" + sfx] == before.get("w4a16_gemm" + sfx, 0)
    ref = qlin.matmul_plain(qlin.gemm.rms_apply(x, *pn), layer)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and bool(torch.isfinite(y).all())
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert torch.equal(qlin.matmul(x, layer, prenorm=pn), y)
    shifted = torch.empty(k + 1, device=card, dtype=w.dtype)[1:]   # 2 or 4 bytes off
    shifted.copy_(w)
    assert torch.equal(qlin.matmul(x, layer, prenorm=(shifted, 1e-5, plus_one)), y)


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [17, 64, 128, 2048])
@pytest.mark.parametrize("k, n, gs, bits, desc_act", [s[:5] for s in K6_SHAPES]
                         + [(4096, 4104, 128, 4, False)])
def test_kb32l_t_wgmma_matches_plain(card, dtype, m, k, n, gs, bits, desc_act):
    """K10 over kb32l words on the wgmma/TMA K10 (the words through the 3-D
    map of the tiles with K10's box, the scales and zeros of the padded width,
    dx through kperm; K 1312 is not a whole number of 256-row tiles, N 1312
    not of 128 columns, N 4104 not of 16) against the plain version on
    ``kb32l_as_gptq``'s words: 1% of the largest output, one
    launch of ``w4a16_kb32l_gemm_t_wgmma`` and no other K10 kernel, bit-equal
    on a second call; the mma.sync K10 on the same words
    (``kernel="mma"``) within 1% of it; a backward through a kb32l layer
    above 16 rows launches it."""
    layer = _layer(m + k + n + bits, k, n, gs, desc_act, False, dtype, bits, layout="kb32l")
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m + n), device=card,
                    dtype=dtype)
    key = qlin.gemm.KB32L_T_WGMMA
    assert qlin.gemm.t_route(dtype, m, k=k, n=n, layout="kb32l") == "wgmma"
    assert _key("wna16_gemm_t", dtype, m, k, gs, n, layout="kb32l") == key
    before = dict(build.launches)
    dx = qlin.matmul_t(g, layer)
    assert build.launches[key] == before.get(key, 0) + 1
    for sfx in WGMMA_KEYS:
        assert build.launches["wna16_gemm_t" + sfx] == before.get("wna16_gemm_t" + sfx, 0), sfx
    again = qlin.matmul_t(g, layer)
    mma = qlin.gemm.wna16_matmul_t(g, layer.qweight, layer.scales, layer.zeros, layer.kperm,
                                   gs, 4, k=k, kernel="mma")
    ref = qlin.gemm.wna16_matmul_t_ref(g, *qlin.gptq_tensors(layer), layer.kperm, gs, 4)
    torch.cuda.synchronize()
    scale = ref.float().abs().max()
    assert dx.shape == (m, k) and dx.dtype == dtype and bool(torch.isfinite(dx).all())
    assert (dx.float() - ref.float()).abs().max() <= 1e-2 * scale
    assert (dx.float() - mma.float()).abs().max() <= 1e-2 * scale
    assert torch.equal(again, dx)
    x = torch.randn((m, k), device=card, dtype=dtype, requires_grad=True)
    before = build.launches[key]
    qlin.matmul(x, layer).float().sum().backward()
    assert build.launches[key] == before + 1 and x.grad is not None


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [1, 4, 8, 9, 16])
def test_prenorm_gemv_rstd_launch_matches_plain(card, dtype, m):
    """K1's fused decode GEMV, which takes the rows' rstd from one
    ``wg_rstd_kernel`` launch its entry makes just before the GEMV (overlapped
    by programmatic dependent launch), against ``rms_apply`` and the plain
    matmul: 1% of the largest output, exactly one ``w4a16_gemm_gemv_norm``
    and one rstd launch per call, no unfused GEMV, bit-equal on a second
    call; and from an x whose base is not 16-byte aligned (copied for the
    rstd kernel) the same output."""
    k, n = 4096, 11008
    layer = _layer(m + k, k, n, 128, dtype=dtype)
    gen = torch.Generator(card).manual_seed(m)
    x = 4.0 * torch.randn((m, k), generator=gen, device=card, dtype=dtype)
    pn = ((1.0 + 0.1 * torch.randn((k,), generator=gen, device=card)).to(dtype), 1e-5, False)
    rstd, key = qlin.gemm.RSTD_KERNEL, "w4a16_gemm_gemv_norm"
    ref = qlin.matmul_plain(qlin.gemm.rms_apply(x, *pn), layer).float()
    before = dict(build.launches)
    y = qlin.matmul(x, layer, prenorm=pn)
    assert build.launches[key] == before.get(key, 0) + 1
    assert build.launches[rstd] == before.get(rstd, 0) + 1
    assert build.launches["w4a16_gemm_gemv"] == before.get("w4a16_gemm_gemv", 0)
    again = qlin.matmul(x, layer, prenorm=pn)
    shifted = torch.empty(m * k + 1, device=card, dtype=dtype)[1:].view(m, k)
    shifted.copy_(x)
    moved = qlin.matmul(shifted, layer, prenorm=pn)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and bool(torch.isfinite(y).all())
    assert (y.float() - ref).abs().max() <= 1e-2 * ref.abs().max()
    assert torch.equal(again, y) and torch.equal(moved, y)
