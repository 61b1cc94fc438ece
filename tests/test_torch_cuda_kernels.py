"""K1 (w4a16 GEMM, also 3-bit codes in nibbles), K4 (w8a16), K5 (w2a16), K6
(w4a16 over the tile-contiguous kb32l words), K10 (their backward,
wna16_gemm_t, also over kb32l words), K2 (flash-decode), K7 (paged
attention), K8a (page row write), K8b (page copy) and K9 (routed experts) on
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


def _key(name, dtype, m, k, gs):
    """The launch-count key of library ``name`` for a product of ``m`` rows:
    its tensor-core kernel's or its SIMT kernels' (``gemm.tile_kernel``)."""
    route = qlin.gemm.tile_kernel(dtype, m, k if gs == -1 else gs)
    return name + (qlin.gemm.MMA_SUFFIX if route == "mma" else "")


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
    name = _key(KERNEL_OF_BITS[bits], x.dtype, m, k, gs)
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
    name = _key("w4a16_gemm", x.dtype, m, k, gs)
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
        name = _key("wna16_gemm_t", dtype, m, k, gs)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("shape", [(4096, 14336, 128), (14336, 4096, 128), (1024, 1000, 32)])
def test_k9_matches_plain(card, expert_stacks, dtype, p, shape):
    """K9 (routed-expert GEMV) at the decode pair counts of Mixtral (P = 2 at
    batch 1, P = 8 at beam 4, with repeated experts)."""
    from autogptq_tpu_torch.ops import gemm

    sql = expert_stacks[shape]
    k = shape[0]
    x = torch.randn((p, k), generator=torch.Generator(card).manual_seed(p + k), device=card,
                    dtype=dtype)
    sel = torch.tensor(K9_SELS[p], dtype=torch.int32, device=card)
    before = build.launches[gemm.ROUTED_KERNEL]
    y = qlin.matmul_routed(x, sql, sel)
    assert build.launches[gemm.ROUTED_KERNEL] == before + 1
    ref = gemm.wna16_routed_matmul_ref(x, sel, sql.qweight, sql.scales, sql.zeros,
                                       sql.group_size)
    torch.cuda.synchronize()
    assert y.shape == (p, shape[1]) and y.dtype == dtype
    if dtype == torch.float32:
        # f32 weights and accumulation on both sides: summation order only
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
    else:
        # one bf16 rounding on both sides: 1% of the largest output
        assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


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
             (2048, 1312, 256, 3, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 17, 64])
@pytest.mark.parametrize("k, n, gs, bits, desc_act, bias", K6_SHAPES)
def test_k6_matches_plain(card, dtype, m, k, n, gs, bits, desc_act, bias):
    """K6 in both regimes (the pipelined GEMV at M <= 16, the tile kernel
    above) against its plain version: f32 to 1e-5 of the largest output
    (summation order only), f16/bf16 to 1% (one rounding on both sides)."""
    layer = _layer(k + n + bits, k, n, gs, desc_act, bias, dtype, bits, layout="kb32l")
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    name = _key("w4a16_kb32l_gemm", dtype, m, k, gs)
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    assert build.launches[name] == before.get(name, 0) + 1
    assert build.launches["w4a16_gemm"] == before.get("w4a16_gemm", 0)
    assert build.launches["w4a16_gemm_mma"] == before.get("w4a16_gemm_mma", 0)
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
        name = _key("wna16_gemm_t", dtype, m, k, gs)
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
    np.testing.assert_array_equal(got, models["cpu"].generate(prompt, max_new_tokens=8))


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
    """K1/K4/K5's tensor-core tile kernel against the plain version: f32
    accumulation of the exact (q - z) and the f32 scale fold against the f32
    product, one rounding on both sides: 1% of the largest output (K1_REL_TOL)."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bias, dtype, bits)
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    name = KERNEL_OF_BITS[bits] + qlin.gemm.MMA_SUFFIX
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    assert build.launches[name] == before.get(name, 0) + 1
    assert build.launches[KERNEL_OF_BITS[bits]] == before.get(KERNEL_OF_BITS[bits], 0)
    ref = qlin.matmul_plain(x, layer)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == dtype and bool(torch.isfinite(y).all())
    assert (y.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    torch.testing.assert_close(qlin.matmul(x, layer), y, rtol=0, atol=0)   # deterministic


@pytest.mark.parametrize("dtype", MMA_DTYPES)
@pytest.mark.parametrize("m", [17, 70, 129, 2048])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k, n, gs, desc_act", [s[:4] for s in MMA_SHAPES])
def test_mma_k10_matches_plain(card, dtype, m, bits, k, n, gs, desc_act):
    """K10's tensor-core kernel against wna16_matmul_t_ref: the scaled weight
    rounded once to the cotangent's type (the JAX kernels' rounding), f32
    accumulation: 1% of the largest output (K10_REL_TOL)."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bits=bits)
    sbits = qlin.storage_bits(bits)
    args = (layer.qweight, layer.scales, layer.zeros, layer.kperm, gs)
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    before = dict(build.launches)
    dx = qlin.gemm.wna16_matmul_t(g, *args, sbits)
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
    """K6's tile regime and K10 over kb32l words take the tensor-core kernels
    (Kb32lWords address, scales and zeros of the padded width)."""
    layer = _layer(m + k + bits, k, n, gs, desc_act, bias, dtype, bits, layout="kb32l")
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m + 1), device=card,
                    dtype=dtype)
    before = dict(build.launches)
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
    weights), as does a group size that 16 does not divide; their counters
    say so."""
    for bits in (2, 4, 8):
        name = KERNEL_OF_BITS[bits]
        for dtype, gs, route in ((torch.float32, 32, ""), (torch.bfloat16, 24, ""),
                                 (torch.bfloat16, 32, "_mma")):
            layer = _layer(bits, 768, 256, gs, dtype=dtype, bits=bits)
            before = dict(build.launches)
            qlin.matmul(torch.randn((64, 768), device=card, dtype=dtype), layer)
            qlin.matmul_t(torch.randn((64, 256), device=card, dtype=dtype), layer)
            assert build.launches[name + route] == before.get(name + route, 0) + 1
            assert build.launches["wna16_gemm_t" + route] == \
                before.get("wna16_gemm_t" + route, 0) + 1
            other = "_mma" if route == "" else ""
            assert build.launches[name + other] == before.get(name + other, 0)
            assert build.launches["wna16_gemm_t" + other] == before.get("wna16_gemm_t" + other, 0)


# The rest classes: group sizes that the codes per word do not divide (a word straddles
# groups), and a partial last group (gs 100, K 4096: 41 groups). (bits, K, N, gs, desc_act)
REST_CASES = [(4, 1024, 256, 4, False), (4, 1032, 256, 12, True), (4, 4096, 512, 100, False),
              (3, 1056, 256, 12, False), (2, 1024, 256, 8, False), (2, 1056, 256, 24, True),
              (8, 1024, 256, 2, False), (8, 1020, 256, 6, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 70])
@pytest.mark.parametrize("bits, k, n, gs, desc_act", REST_CASES)
def test_rest_classes_match_plain(card, dtype, m, bits, k, n, gs, desc_act):
    """Both regimes of K1/K4/K5 (the per-code group GEMV at M <= 16, the SIMT
    tile kernel above) and K10 at the rest classes, against the plain
    versions: f32 to 1e-4, bf16 to 1% of the largest output."""
    layer = _layer(m + k + bits + gs, k, n, gs, desc_act, True, dtype, bits)
    x = torch.randn((m, k), generator=torch.Generator(card).manual_seed(m), device=card,
                    dtype=dtype)
    g = torch.randn((m, n), generator=torch.Generator(card).manual_seed(m + 1), device=card,
                    dtype=dtype)
    before = dict(build.launches)
    y = qlin.matmul(x, layer)
    dx = qlin.matmul_t(g, layer)
    assert build.launches[KERNEL_OF_BITS[bits]] == before.get(KERNEL_OF_BITS[bits], 0) + 1
    assert build.launches["wna16_gemm_t"] == before.get("wna16_gemm_t", 0) + 1
    ref = qlin.matmul_plain(x, layer)
    ref_t = qlin.gemm.wna16_matmul_t_ref(g, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm, gs, qlin.storage_bits(bits))
    torch.cuda.synchronize()
    for got, want in ((y, ref), (dx, ref_t)):
        scale = float(want.float().abs().max())
        tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 1e-2 * scale
        assert bool(torch.isfinite(got).all()) and (got.float() - want.float()).abs().max() <= tol
    torch.testing.assert_close(qlin.matmul(x, layer), y, rtol=0, atol=0)   # deterministic


@pytest.mark.parametrize("gs", [12, 100])
def test_k9_rest_classes_match_plain(card, gs):
    """K9's per-code group instance (4-bit, gs % 8 != 0) against its plain version."""
    from autogptq_tpu_torch.ops import gemm

    rng = np.random.default_rng(gs)
    qls = []
    for _ in range(4):
        t = random_quant_tensors(rng, 1200, 512, 4, gs, False)
        qls.append(qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=None, bits=4, group_size=gs, in_features=1200, out_features=512),
            device="cuda", dtype=torch.float32))
    sql = qlin.stack_experts(qls)
    sel = torch.tensor([3, 0, 3], dtype=torch.int32, device=card)
    x = torch.randn((3, 1200), generator=torch.Generator(card).manual_seed(gs), device=card)
    y = gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, gs)
    ref = gemm.wna16_routed_matmul_ref(x, sel, sql.qweight, sql.scales, sql.zeros, gs)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
