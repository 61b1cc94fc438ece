"""K10 over kb32l words on the wgmma/TMA K10 (``csrc/wna16_wgmma.cuh``:
``kb32l_t_wgmma_kernel``, entry and launch count ``w4a16_kb32l_gemm_t_wgmma``)
and K1's fused decode GEMV taking the rows' rstd from one launch before it
(``csrc/wna16_gemv.cuh`` with ``wg_rstd_kernel``), checked on the CPU. The
kernels run only on the card (``tests/test_torch_cuda_kernels.py``:
``test_kb32l_t_wgmma_matches_plain``,
``test_prenorm_gemv_rstd_launch_matches_plain``); here, what they are built on:

* the 3-D tensor map of the kb32l tiles with K10's box (``gemm.kb32l_word_map(k,
  n, transpose=True)``: 64 columns of N by the 16 word rows of K10's 128 K
  rows) modelled in torch, TMA's reading of a box from dims and byte strides
  with zeros past the dims: for every output block i and reduction tile t the
  box at ``(64 (t % 2), 16 i, t // 2)`` equals word rows ``16i..16i+15`` of
  columns ``64t..64t+63`` of ``gemm.kb32l_delinearize`` (the packer's zeros on
  the padding), at Llama-2-7B's widths, N = 1312 (padded to 1408) and K = 1312
  (padded to 1536), 3-bit codes;
* ``gemm.wgmma_plan(transpose=True, layout="kb32l")``: GPTQ's K10 plan with
  the map, inside the 227 KB a block may take;
* the routes: K10 over kb32l words above 16 rows to ``"wgmma"`` in bf16 and
  f16 wherever K % 8 and N % 8 hold (N = 1312, 4104, 11008), ``"mma"`` for
  other N, ``"gemv"`` at 16 rows and fewer, ``"simt"`` for f32;
* K10's arithmetic emulated as ``tests/test_torch_wgmma.py`` does (the weight
  ``s * (q - z)`` in f32 as the hi/lo pair of the activation type, f32 sums
  over 64-column tiles of N in the plan's split order, one rounding, dx
  through kperm) but reading the words through the modelled map and the
  scales and zeros at their padded width, against the JAX package's
  ``quantlinear.matmul_t`` of the layer ``from_packed(layout="kb32l")`` builds,
  at M = 17, 64 and 128: within two ulps of the activation type at the
  largest output;
* the fused GEMV's prologue in the order of the launch design: rstd summed
  as ``wg_rstd_kernel`` sums it (per row 256 threads over 16-byte runs, a
  warp's butterfly, the 8 warps in order), each element of x times rstd
  times its norm weight rounded once to bf16, then the GEMV's splits and
  groups (``tests/test_torch_rest_gemv.py``'s emulation), against JAX's
  interpret-mode ``matmul_pallas(prenorm=)`` (dotting in f32) at M = 1, 4, 9
  and 16 (the GEMV takes the rstd launch at every M it serves): within two
  bf16 ulps at the largest output.

Inputs are made with NumPy from a seed and handed to both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu.ops.pallas import gemm as jgemm
from autogptq_tpu_torch.ops import gemm
from autogptq_tpu_torch.ops import quantlinear as qlin
from test_torch_fuse_norm import _pair as _norm_pair
from test_torch_kb32l import _packed
from test_torch_rest_gemv import gemv_emulation
from test_torch_wgmma import SMEM_PER_BLOCK, SMS, T_EPS, _pair, _tile_sums
from test_torch_wgmma_kb32l_norm import BF16_2ULP, _tma_box

LLAMA = [(4096, 4096), (4096, 11008), (11008, 4096)]


def _kb32l_words(seed, k, n, bits, gs):
    """Random kb32l tiles of a ``[K, N]`` layer at group size ``gs`` (4-bit
    storage) and the GPTQ words ``[K/8, N]`` they hold."""
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(k // 8, n), dtype=np.int64)
                             .astype(np.int32))
    if bits == 3:
        words &= 0x77777777                 # 3-bit codes ride in nibbles
    g = k // gs
    tiles, _, _ = qlin.kb32l_pack(words, torch.ones((g, n), dtype=torch.float16),
                                  torch.zeros((g, n), dtype=torch.uint8), k, gs)
    return tiles, words


def _t_box(flat, wmap, i, t):
    """The words K10's box of output block i and reduction tile t reads."""
    return _tma_box(flat, wmap["dims"], wmap["strides"], wmap["box"],
                    (64 * (t % 2), 16 * i, t // 2))[0]


@pytest.mark.parametrize("k, n, bits, gs", [(k, n, 4, 128) for k, n in LLAMA]
                         + [(4096, 1312, 4, 128), (1312, 1312, 3, 32)])
def test_kb32l_t_map_reads_the_delinearized_words(k, n, bits, gs):
    tiles, words = _kb32l_words(k + n + bits, k, n, bits, gs)
    wmap = gemm.kb32l_word_map(k, n, transpose=True)
    nbk, nbn = -(-k // 256), -(-n // 128)
    assert wmap["dims"] == (128, nbk * 32, nbn) and wmap["box"] == (64, 16, 1)
    assert wmap["strides"] == (512, nbk * 32 * 512)
    assert {key: v for key, v in wmap.items() if key != "box"} == \
        {key: v for key, v in gemm.kb32l_word_map(k, n).items() if key != "box"}
    assert torch.equal(gemm.kb32l_delinearize(tiles, k, n), words)
    padded = torch.zeros((nbk * 32, nbn * 128), dtype=torch.int32)
    padded[:k // 8, :n] = words
    flat = tiles.reshape(-1)
    ktiles, blocks = -(-n // 64), -(-k // 128)
    for i in range(blocks):
        for t in range(ktiles):
            assert torch.equal(_t_box(flat, wmap, i, t),
                               padded[16 * i:16 * i + 16, 64 * t:64 * t + 64]), (i, t)
    # every box lies inside the tiles: the padding it reads is the packer's zeros
    assert 16 * blocks <= wmap["dims"][1] and -(-ktiles // 2) <= wmap["dims"][2]


@pytest.mark.parametrize("m", [17, 64, 128, 2048])
@pytest.mark.parametrize("k, n", LLAMA + [(4096, 1312), (1312, 1312)])
def test_t_plan_fits_the_block(k, n, m):
    """GPTQ's K10 plan (the same block height, stages, split and boxes: the
    map's box holds as many words as GPTQ's) plus the map, within 227 KB."""
    for gs in (32, 64, 128, 256):
        if k % gs:
            continue
        plan = gemm.wgmma_plan(m, k, n, gs, 4, SMS, transpose=True, layout="kb32l")
        wmap = plan.pop("words_map")
        assert wmap == gemm.kb32l_word_map(k, n, transpose=True)
        assert plan == gemm.wgmma_plan(m, k, n, gs, 4, SMS, transpose=True)
        inner, rows, size = plan["boxes"]["words"]
        assert (inner, rows) == wmap["box"][:2] and size == 4
        assert plan["ktiles"] == -(-n // 64) and plan["col_blocks"] == -(-k // 128)
        assert plan["smem_bytes"] <= gemm.MMA_SMEM_LIMIT < SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="layout"):
        gemm.wgmma_plan(m, k, n, 128, 4, SMS, transpose=True, layout="kb32")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [17, 64, 128, 2048])
def test_t_routes(dtype, m):
    """Above 16 rows K10 over kb32l words takes the wgmma kernel wherever K %
    8 and N % 8 hold (its scales and zeros are N_pad wide), the mma.sync one
    for other N; its decode regime at 16 rows and fewer; f32 the SIMT K10;
    ``kernel=`` and ``forced_kernel`` name each."""
    for n in (1312, 4104, 11008, 4096):
        assert gemm.t_route(dtype, m, k=4096, n=n, layout="kb32l") == "wgmma"
        assert gemm.t_route(dtype, 16, k=4096, n=n, layout="kb32l") == "gemv"
        assert gemm.t_route(torch.float32, m, k=4096, n=n, layout="kb32l") == "simt"
    assert gemm.t_route(dtype, m, layout="kb32l") == "wgmma"
    assert gemm.t_route(dtype, m, k=4096, n=4100, layout="kb32l") == "mma"      # N % 8
    assert gemm.t_route(dtype, m, k=4096, n=4104) == "mma"        # GPTQ's zeros need N % 16
    assert gemm.t_route(dtype, m, "mma", 4096, 4096, layout="kb32l") == "mma"
    with gemm.forced_kernel("mma"):
        assert gemm.t_route(dtype, m, gemm._t_kernel(None), 4096, 4096, "kb32l") == "mma"
    with gemm.forced_kernel("wgmma"):
        assert gemm.t_route(dtype, 4, gemm._t_kernel(None), 4096, 4096, "kb32l") == "wgmma"


def test_cpu_tensors_take_the_plain_version():
    """On the CPU K10 over kb32l words answers with the plain version
    whatever kernel is named, and launches nothing."""
    port, _ = _packed(3, 1024, 256, 128)
    layer = qlin.from_packed(port, device="cpu", dtype=torch.float32, layout="kb32l")
    g = torch.randn((20, 256))
    want = gemm.wna16_matmul_t_ref(g, *qlin.gptq_tensors(layer), layer.kperm, 128, 4)
    from autogptq_tpu_torch.ops import build
    before = dict(build.launches)
    for kernel in ("wgmma", None):
        dx = gemm.wna16_matmul_t(g, layer.qweight, layer.scales, layer.zeros, layer.kperm, 128,
                                 4, k=1024, kernel=kernel)
        torch.testing.assert_close(dx, want, rtol=0, atol=0)
    assert dict(build.launches) == before


def _kb32l_t_emulation(g: torch.Tensor, layer, dtype, sms: int) -> torch.Tensor:
    """The kb32l wgmma K10: each box's words read through the modelled 3-D
    map, the weight ``s * (q - z)`` of the padded scales and zeros in f32 as
    the pair of ``dtype``, f32 sums over 64-column tiles of N in the plan's
    split order, one rounding, dx's columns through kperm."""
    k, n = layer.in_features, layer.out_features
    gs = k if layer.group_size == -1 else layer.group_size
    plan = gemm.wgmma_plan(g.shape[0], k, n, gs, layer.bits, sms, transpose=True,
                           layout="kb32l")
    wmap, flat = plan["words_map"], layer.qweight.reshape(-1)
    rows = torch.cat([torch.cat([_t_box(flat, wmap, i, t) for t in range(plan["ktiles"])], dim=1)
                      for i in range(plan["col_blocks"])])      # [16 * blocks, 64 * ktiles]
    codes = gemm.unpack_words(rows, 4)[:k]                      # [K, 64 * ktiles]
    grp = torch.arange(k) // gs
    cols = codes.shape[1]
    s = torch.zeros((layer.scales.shape[0], cols))
    z = torch.zeros_like(s)
    w_cols = min(cols, layer.scales.shape[1])
    s[:, :w_cols] = layer.scales.float()[:, :w_cols]
    z[:, :w_cols] = layer.zeros.float()[:, :w_cols]
    w = s[grp] * (codes.float() - z[grp])                       # [K, cols]
    gp = torch.zeros((g.shape[0], cols))
    gp[:, :n] = g.to(dtype).float()                             # TMA's zeros past N
    hi, lo = _pair(w, dtype)
    dxs = _tile_sums(gp, hi.t(), lo.t(), plan).to(dtype)
    if layer.kperm is None:
        return dxs
    dx = torch.empty_like(dxs)
    dx[:, layer.kperm] = dxs
    return dx


# (K, N, group size, bits, desc_act, dtype, SMs for the plan): N = 1312 off the 128-column
# tile, K = 1312 off the 256-row tile, 3-bit, desc_act, group sizes 32 to 256; 132 SMs split
# the reduction at these sizes, 1 leaves it whole
T_CASES = [(1024, 1312, 256, 4, False, torch.bfloat16, 132),
           (2048, 1024, 64, 4, False, torch.float16, 132),
           (1024, 256, 128, 3, False, torch.bfloat16, 1),
           (1024, 256, 128, 4, True, torch.bfloat16, 132),
           (1312, 272, 32, 4, True, torch.float16, 1)]


@pytest.mark.parametrize("m", [17, 64, 128])
@pytest.mark.parametrize("k, n, gs, bits, desc_act, dtype, sms", T_CASES)
def test_kb32l_t_emulation_matches_jax_matmul_t(k, n, gs, bits, desc_act, dtype, sms, m):
    """The emulated kb32l K10 against JAX's ``quantlinear.matmul_t`` in f32 on
    the layer ``from_packed(layout="kb32l")`` builds (the same cotangent,
    values of ``dtype``): the pair carries the weight to about 16
    significant bits and the sums are f32, so the one rounding of dx to
    ``dtype`` is the difference: within two ulps of ``dtype`` at the largest
    output."""
    port, ref = _packed(k + n + gs + bits + 7, k, n, gs, bits, desc_act)
    layer = qlin.from_packed(port, device="cpu", dtype=torch.float32, layout="kb32l")
    jl = jqlin.from_packed(ref, layout="kb32l")
    assert jl.layout == "kb32l"
    g = torch.from_numpy(np.random.default_rng(m + n).standard_normal((m, n)).astype(
        np.float32)).to(dtype)
    got = _kb32l_t_emulation(g, layer, dtype, sms).float().numpy()
    want = np.asarray(jqlin.matmul_t(jnp.asarray(g.float().numpy()), jl, k))
    assert want.shape == (m, k)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * T_EPS[dtype] * np.abs(want).max())


def _rstd_launch_order(x: torch.Tensor, eps: float) -> torch.Tensor:
    """rstd of each row of bf16/f16 ``x`` summed as ``wg_rstd_kernel`` sums
    it: each 16-byte run's squares by fmaf in element order (emulated in
    f64, where a square is exact, one rounding to f32), thread t adding runs
    t, t + 256, ... in order, each warp's 32 sums by its butterfly
    (``__shfl_xor_sync`` 16, 8, 4, 2, 1), the 8 warps' in order, then
    ``rsqrt(t / K + eps)``."""
    m, k = x.shape
    vec = 16 // x.element_size()
    runs = k // vec
    sq = x.double().pow(2).reshape(m, runs, vec)
    run = torch.zeros((m, runs), dtype=torch.float32)
    for e in range(vec):
        run = (run.double() + sq[:, :, e]).float()
    j = -(-runs // 256)
    per = torch.zeros((m, j * 256))
    per[:, :runs] = run
    s = torch.zeros((m, 256))
    for i in range(j):
        s = s + per[:, 256 * i:256 * i + 256]
    s = s.view(m, 8, 32)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, :, lanes ^ o]
    t = torch.zeros(m)
    for w in range(8):
        t = t + s[:, w, 0]
    return torch.rsqrt(t / k + eps)


# (K, group size, bits, plus_one): tests/test_fuse_norm.py's eligible shapes (a kb32 layer at
# K 1024 g128, a ki32 one at K 256 g64), 3-bit, gemma's 1 + w
GEMV_FUSED_CASES = [(1024, 128, 4, False), (1024, 128, 4, True), (256, 64, 3, False),
                    (256, 64, 4, True)]


@pytest.mark.parametrize("m", [1, 4, 9, 16])
@pytest.mark.parametrize("k, gs, bits, plus_one", GEMV_FUSED_CASES)
def test_gemv_prologue_order_matches_the_jax_kernel(monkeypatch, k, gs, bits, plus_one, m):
    """The fused GEMV with the rstd launch, emulated (rstd in the launch's
    order, within 4 f32 ulps of its plain version; x_n rounded once per
    element to bf16; the GEMV's splits and groups in f32; one rounding of the
    output), against JAX's interpret-mode ``matmul_pallas(prenorm=)`` on the
    same bf16 activations and norm weight: within two bf16 ulps at the
    largest output (both round x_n to bf16 and the output once)."""
    layer, ref = _norm_pair(k, 256, bits, gs)
    rng = np.random.default_rng(m + k + bits)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 3.0).astype(np.float32)).bfloat16()
    w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)).bfloat16()
    assert gemm.prenorm_eligible(m, k, gs, bits, layer.kperm, layer.layout, k)
    assert gemm.route(torch.bfloat16, m, gs, k=k, n=256) == "gemv"
    rstd = _rstd_launch_order(x, 1e-6)
    torch.testing.assert_close(rstd, gemm.prenorm_rstd(x, 1e-6), rtol=2.0 ** -21, atol=0)
    wf = w.float() + 1.0 if plus_one else w.float()
    xn = (x.float() * rstd[:, None] * wf).to(torch.bfloat16)
    unbiased = dataclasses.replace(layer, bias=torch.zeros(256))
    got = gemv_emulation(xn.float(), unbiased).to(torch.bfloat16).float().numpy()
    unfused = []
    real = jgemm.rms_apply
    monkeypatch.setattr(jgemm, "rms_apply", lambda *a: unfused.append(1) or real(*a))
    want = jgemm.matmul_pallas(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16), ref,
                               interpret=True, dot_dtype=jnp.float32,
                               prenorm=(jnp.asarray(w.float().numpy(), dtype=jnp.bfloat16),
                                        1e-6, plus_one))
    assert not unfused                                   # the JAX kernel fused the norm
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_2ULP * np.abs(want).max())
