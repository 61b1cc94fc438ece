"""K6's kb32l tile regime and K1's fused RMS-norm prologue on the wgmma/TMA
forward (``csrc/wna16_wgmma.cuh``: ``kb32l_wgmma_kernel``,
``wna16_prenorm_wgmma_kernel``) checked on the CPU. The kernels run only on
the card (``tests/test_torch_cuda_kernels.py``: ``test_kb32l_wgmma_matches_plain``,
``test_prenorm_wgmma_matches_plain``); here, what they are built on:

* the 3-D tensor map of the kb32l tiles (``gemm.kb32l_word_map``) modelled in
  torch, TMA's reading of a box from dims and byte strides with zeros past
  the dims: for every column block j and reduction tile t, the box at
  ``(0, 8t, j)`` equals word rows ``8t..8t+7`` of columns ``128j..`` of
  ``gemm.kb32l_delinearize`` (zeros on the padding), at Llama-2-7B's widths, N
  = 1312 (padded to 1408), K = 11008 (padded to 11264) and 3-bit codes;
* ``gemm.wgmma_plan`` for kb32l words (the GPTQ plan with the map) and for
  the prologue (the norm weights' slot in every stage, their box), inside the
  227 KB a block may take;
* the routes: bf16/f16 above 16 rows over kb32l words (``gemm.kb32l_route``:
  any N % 4, the maps being N_pad wide) and with the prologue to
  ``"wgmma"``, K10 over kb32l words too, other shapes to ``"mma"``,
  f32 to ``"simt"``, the GEMVs at 16 rows and fewer;
* the prologue's rstd (``gemm.prenorm_rstd``, the plain version of
  ``wg_rstd_kernel``) against the JAX package's ``rms_apply``;
* the kb32l forward's arithmetic emulated as ``tests/test_torch_wgmma.py``
  does (the weight as the hi/lo pair of the activation type, f32 sums over
  64-row tiles in the plan's split order, one rounding) but reading the words
  through the modelled map, against the JAX package's ``matmul_xla`` of a
  kb32l node at M = 17, 64 and 128: within two ulps of the activation type at
  the largest output (the pair carries about 16 significant bits, so the one
  rounding of the output is the difference);
* the fused forward's arithmetic: rstd over the full K in f32, each 64-row
  x tile normalized and rounded once to the activation type with its 64 norm
  weights, the hi/lo pair, the 64-row tile sums and the split order, against
  JAX's interpret-mode ``matmul_pallas(prenorm=)`` (as
  ``tests/test_torch_fuse_norm.py`` runs it, dotting in f32) on the same bf16
  activations and norm weight at M = 17, 24 and 31, with 3-bit codes,
  ``plus_one``, one split and several: within two bf16 ulps at the largest
  output (both round x_n to bf16 and the output once).

Inputs are made with NumPy from a seed and handed to both packages."""

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
from test_torch_wgmma import SMEM_PER_BLOCK, SMS, T_EPS, _pair, _tile_sums

LLAMA = [(4096, 4096), (4096, 11008), (11008, 4096)]
BF16_2ULP = 4 * T_EPS[torch.bfloat16]   # two ulps of bf16 at 1, of the largest output


def _tma_box(flat: torch.Tensor, dims, strides, box, origin) -> torch.Tensor:
    """What a TMA tiled map of ``dims`` (innermost first) and byte ``strides``
    (of dims 1..) over the int32 storage ``flat`` reads for the box ``box`` at
    ``origin``, outermost first as it lands in shared memory; zeros where the
    box leaves the dims."""
    out = torch.zeros(tuple(reversed(box)), dtype=flat.dtype)
    idx = [torch.arange(o, o + b) for o, b in zip(origin, box)]
    ok = [i < d for i, d in zip(idx, dims)]
    step = (1,) + tuple(s // flat.element_size() for s in strides)
    addr = (idx[2][:, None, None] * step[2] + idx[1][None, :, None] * step[1]
            + idx[0][None, None, :] * step[0])
    inside = ok[2][:, None, None] & ok[1][None, :, None] & ok[0][None, None, :]
    out[inside] = flat[addr[inside]]
    return out


def _kb32l_words(seed, k, n, bits):
    """Random kb32l tiles of a ``[K, N]`` layer (4-bit storage) and the padded
    GPTQ words ``[K_pad/8, N_pad]`` they hold."""
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(k // 8, n), dtype=np.int64)
                             .astype(np.int32))
    if bits == 3:
        words &= 0x77777777                 # 3-bit codes ride in nibbles
    g = k // 128
    tiles, _, _ = qlin.kb32l_pack(words, torch.ones((g, n), dtype=torch.float16),
                                  torch.zeros((g, n), dtype=torch.uint8), k, 128)
    return tiles, words


@pytest.mark.parametrize("k, n, bits", [(k, n, 4) for k, n in LLAMA]
                         + [(4096, 1312, 4), (11008, 1312, 3)])
def test_kb32l_map_reads_the_delinearized_words(k, n, bits):
    tiles, words = _kb32l_words(k + n + bits, k, n, bits)
    wmap = gemm.kb32l_word_map(k, n)
    nbk, nbn = -(-k // 256), -(-n // 128)
    assert wmap["dims"] == (128, nbk * 32, nbn) and wmap["box"] == (128, 8, 1)
    assert wmap["strides"] == (512, nbk * 32 * 512)
    assert torch.equal(gemm.kb32l_delinearize(tiles, k, n), words)
    padded = torch.zeros((nbk * 32, nbn * 128), dtype=torch.int32)
    padded[:k // 8, :n] = words
    flat = tiles.reshape(-1)
    ktiles = -(-k // 64)
    for j in range(nbn):
        for t in range(ktiles):
            got = _tma_box(flat, wmap["dims"], wmap["strides"], wmap["box"], (0, 8 * t, j))
            assert torch.equal(got[0], padded[8 * t:8 * t + 8, 128 * j:128 * j + 128]), (j, t)
    # every box of the forward lies inside the tiles: the padding it reads is the packer's zeros
    assert 8 * ktiles <= wmap["dims"][1]


@pytest.mark.parametrize("m", [17, 64, 128, 2048])
@pytest.mark.parametrize("k, n", LLAMA + [(4096, 1312)])
def test_plans_fit_the_block(k, n, m):
    """kb32l: GPTQ's plan (the same stages, split and boxes: the map's box
    holds GPTQ's words) and the map; the prologue (M < 32): each stage holds
    every box of a tile and the 64 norm weights at f32 width, 1024-aligned,
    at least 2 stages within 227 KB."""
    for gs in (32, 64, 128, 256):
        plan = gemm.wgmma_plan(m, k, n, gs, 4, SMS, layout="kb32l")
        assert plan.pop("words_map") == gemm.kb32l_word_map(k, n)
        assert plan == gemm.wgmma_plan(m, k, n, gs, 4, SMS)
        assert plan["smem_bytes"] <= gemm.MMA_SMEM_LIMIT < SMEM_PER_BLOCK
    if m >= gemm.PRENORM_MAX_M:
        with pytest.raises(ValueError, match="prologue"):
            gemm.wgmma_plan(m, k, n, 128, 4, SMS, prenorm=True)
        return
    for gs in (32, 128, -1):
        for bits in (3, 4):
            plan = gemm.wgmma_plan(m, k, n, gs, bits, SMS, prenorm=True)
            assert plan["bm"] == 64 and plan["stages"] >= 2
            assert plan["stage_bytes"] % 1024 == 0
            assert plan["boxes"]["norm"] == (64, 1, 4)
            need = sum(inner * rows * size for inner, rows, size in plan["boxes"].values())
            assert plan["stage_bytes"] >= need + 64
            assert plan["smem_bytes"] == 1024 + 3 * 2 * 128 * 64 * 2 + plan["stages"] * \
                plan["stage_bytes"] <= gemm.MMA_SMEM_LIMIT
            # the norm slot fits the stage's padding or adds one 1024-byte step
            assert plan["stage_bytes"] - gemm.wgmma_stage_bytes(4, 64, plan["stage_groups"]) \
                in (0, 1024)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [17, 24, 31, 64, 2048])
def test_routes(dtype, m):
    """kb32l words above 16 rows take the wgmma kernel wherever K % 8 and N %
    4 hold (its maps are N_pad wide: N = 1312 and 4104 too), the mma.sync
    kernel for other N; K10 over them takes the wgmma K10 (N % 8); the
    prologue's calls route as the unfused product does."""
    for gs in (32, 64, 128, 256):
        for n in (1312, 4104, 4100):
            assert gemm.kb32l_route(dtype, m, gs, k=4096, n=n) == "wgmma"
            assert gemm.kb32l_route(dtype, 16, gs, k=4096, n=n) == "gemv"
            assert gemm.kb32l_route(torch.float32, m, gs, k=4096, n=n) == "simt"
        assert gemm.kb32l_route(dtype, m, gs, k=4096, n=4102) == "mma"   # N % 4
        assert gemm.t_route(dtype, m, k=4096, n=1312, layout="kb32l") == "wgmma"
        assert gemm.t_route(dtype, m, k=4096, n=1312) == "wgmma"
        if m < gemm.PRENORM_MAX_M:
            assert gemm.prenorm_eligible(m, 4096, gs, 4)
            assert gemm.route(dtype, m, gs, k=4096, n=11008) == "wgmma"
            assert gemm.route(dtype, 16, gs, k=4096, n=11008) == "gemv"
            assert gemm.route(dtype, m, gs, k=4096, n=4100) == "mma"
            assert gemm.route(torch.float32, m, gs, k=4096, n=11008) == "simt"
    with gemm.forced_kernel("mma"):
        assert gemm.kb32l_route(dtype, m, 128, gemm._forced[0], 4096, 4096) == "mma"
    assert gemm.kb32l_route(dtype, m, 128, "simt", 4096, 4102) == "simt"


@pytest.mark.parametrize("m", [17, 24, 31])
@pytest.mark.parametrize("k", [1024, 4096])
def test_prenorm_rstd_matches_jax_rms_apply(m, k):
    """The prologue's rstd (``gemm.prenorm_rstd``: ``wg_rstd_kernel``'s plain
    version) times x and the norm weight, rounded once to bf16, against the
    JAX package's ``rms_apply``: within one bf16 ulp of each value (rsqrt may
    differ in the last f32 bit, which can flip a rounding); a tensor neither
    on the CPU nor on CUDA raises."""
    rng = np.random.default_rng(m * k)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 3.0).astype(np.float32)).bfloat16()
    w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)).bfloat16()
    rstd = gemm.prenorm_rstd(x, 1e-6)
    assert rstd.shape == (m,) and rstd.dtype == torch.float32
    got = (x.float() * rstd[:, None] * w.float()).to(torch.bfloat16).float().numpy()
    want = np.asarray(jgemm.rms_apply(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16),
                                      jnp.asarray(w.float().numpy(), dtype=jnp.bfloat16), 1e-6,
                                      False).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    out = torch.empty(m)
    assert gemm.prenorm_rstd(x, 1e-6, out) is out and torch.equal(out, rstd)
    with pytest.raises(ValueError, match="rstd"):
        gemm.prenorm_rstd(torch.empty((m, k), dtype=torch.bfloat16, device="meta"), 1e-6)


def _kb32l_emulation(x: torch.Tensor, layer, dtype, sms: int) -> torch.Tensor:
    """The kb32l wgmma forward: x gathered by kperm (the wrapper), each
    reduction tile's words read through the modelled 3-D map, the weight
    ``s * (q - z)`` of the padded scales and zeros in f32 as the pair of
    ``dtype``, the plan's tile sums, the bias, one rounding."""
    k, n = layer.in_features, layer.out_features
    gs = k if layer.group_size == -1 else layer.group_size
    plan = gemm.wgmma_plan(x.shape[0], k, n, gs, layer.bits, sms, layout="kb32l")
    wmap, flat = plan["words_map"], layer.qweight.reshape(-1)
    rows = torch.cat([torch.cat([_tma_box(flat, wmap["dims"], wmap["strides"], wmap["box"],
                                          (0, 8 * t, j))[0]
                                 for j in range(wmap["dims"][2])], dim=1)
                      for t in range(plan["ktiles"])])            # [8 * ktiles, N_pad]
    codes = gemm.unpack_words(rows, 4)[:k]
    grp = torch.arange(k) // gs
    w = layer.scales.float()[grp] * (codes.float() - layer.zeros.float()[grp])
    xs = x.index_select(1, layer.kperm) if layer.kperm is not None else x
    y = _tile_sums(xs.to(dtype).float(), *_pair(w, dtype), plan)[:, :n]
    if layer.bias is not None:
        y = y + layer.bias.to(dtype).float()
    return y.to(dtype)


# (K, N, group size, bits, desc_act, bias, dtype, SMs for the plan): test_torch_kb32l.py's
# shapes (N = 1312 off the 128-column block, K 1312 off the 256-row tile), 3-bit, desc_act with
# a bias, group sizes 32 to 256; 132 SMs split the reduction, 1 leaves it whole
KB32L_CASES = [(1024, 1312, 256, 4, False, False, torch.bfloat16, 132),
               (2048, 1024, 64, 4, False, True, torch.float16, 132),
               (1024, 256, 128, 3, False, False, torch.bfloat16, 1),
               (1024, 256, 128, 4, True, True, torch.bfloat16, 132),
               (1312, 272, 32, 4, True, False, torch.float16, 1)]


@pytest.mark.parametrize("m", [17, 64, 128])
@pytest.mark.parametrize("k, n, gs, bits, desc_act, bias, dtype, sms", KB32L_CASES)
def test_kb32l_forward_emulation_matches_jax(k, n, gs, bits, desc_act, bias, dtype, sms, m):
    port, ref = _packed(k + n + gs + bits, k, n, gs, bits, desc_act, bias)
    layer = qlin.from_packed(port, device="cpu", dtype=torch.float32, layout="kb32l")
    jl = jqlin.from_packed(ref, layout="kb32l")
    x = torch.from_numpy(np.random.default_rng(m + k).standard_normal((m, k)).astype(
        np.float32)).to(dtype)
    got = _kb32l_emulation(x, layer, dtype, sms).float().numpy()
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x.float().numpy()), jl))
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * T_EPS[dtype] * np.abs(want).max())


def _fused_emulation(x: torch.Tensor, w: torch.Tensor, eps: float, plus_one: bool, layer,
                     sms: int) -> torch.Tensor:
    """The fused wgmma forward on bf16 ``x`` and norm weight ``w``: rstd =
    rsqrt(mean(x^2) + eps) over the full K in f32; each 64-row x tile times
    rstd times its 64 norm weights (``1 + w`` under ``plus_one``), rounded
    once to bf16; the weight's pair, the plan's tile sums and split order; one
    rounding of the output."""
    m, k = x.shape
    gs = k if layer.group_size == -1 else layer.group_size
    plan = gemm.wgmma_plan(m, k, layer.out_features, gs, layer.bits, sms, prenorm=True)
    xf = x.float()
    rstd = gemm.prenorm_rstd(x, eps)[:, None]   # wg_rstd_kernel's plain version
    wf = w.float() + 1.0 if plus_one else w.float()
    xn = torch.cat([(xf[:, r0:r0 + 64] * rstd * wf[r0:r0 + 64]).to(torch.bfloat16)
                    for r0 in range(0, k, 64)], dim=1)
    grp = torch.arange(k) // gs
    wq = layer.scales.float()[grp] * (qlin.codes(layer).float() - layer.zeros.float()[grp])
    return _tile_sums(xn.float(), *_pair(wq, torch.bfloat16), plan).to(torch.bfloat16)


# (K, group size, bits, plus_one, SMs): tests/test_fuse_norm.py's eligible shapes (a kb32
# layer at K 1024 g128, a ki32 one at K 256 g64), 3-bit, gemma's 1 + w, one split and several
FUSED_CASES = [(1024, 128, 4, False, 132), (1024, 128, 4, True, 1), (256, 64, 3, False, 132),
               (256, 64, 4, True, 132)]


@pytest.mark.parametrize("m", [17, 24, 31])
@pytest.mark.parametrize("k, gs, bits, plus_one, sms", FUSED_CASES)
def test_fused_emulation_matches_the_jax_kernel(monkeypatch, k, gs, bits, plus_one, sms, m):
    layer, ref = _norm_pair(k, 256, bits, gs)
    rng = np.random.default_rng(m + k + bits)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 3.0).astype(np.float32)).bfloat16()
    w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)).bfloat16()
    assert gemm.prenorm_eligible(m, k, gs, bits, layer.kperm, layer.layout, k)
    plan = gemm.wgmma_plan(m, k, 256, gs, bits, sms, prenorm=True)
    assert (plan["splits"] > 1) == (sms > 1)
    unfused = []
    real = jgemm.rms_apply
    monkeypatch.setattr(jgemm, "rms_apply", lambda *a: unfused.append(1) or real(*a))
    want = jgemm.matmul_pallas(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16), ref,
                               interpret=True, dot_dtype=jnp.float32,
                               prenorm=(jnp.asarray(w.float().numpy(), dtype=jnp.bfloat16),
                                        1e-6, plus_one))
    assert not unfused                                   # the JAX kernel fused the norm
    want = np.asarray(want.astype(jnp.float32))
    got = _fused_emulation(x, w, 1e-6, plus_one, layer, sms).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_2ULP * np.abs(want).max())
