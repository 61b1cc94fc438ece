"""K10's decode regime (``csrc/wna16_gemv_t.cuh``), checked on the CPU: at M <= 16 bf16
and f16 cotangents take a split-N tensor-core kernel, ``dx = g @ ((q - z) * s)^T`` with
the weight fed to the MMA as a hi/lo pair of the cotangent's type. The kernel runs only
on the card (``tests/test_torch_cuda_kernels.py``); here, what it is built on:

* its arithmetic in the kernel's order, emulated in plain torch: the K tiles and N splits
  of ``gemm.t_gemv_plan``, 128-column stages, 16-column steps dealt to the warps in turn,
  each step's ``g @ hi^T`` and ``g @ lo^T`` accumulated in f32, the warps added in order,
  the splits' partials added in split order, ``kperm`` undone by the store; held against
  the JAX package's ``matmul_t`` (XLA, f32) on g128, g32, gs 100 and desc_act layers;
* the plan from shapes alone, within its workspace share and shared memory;
* the route: bf16/f16 at M <= 16 take ``"gemv"``, above 16 rows the tile K10, f32 the SIMT
  K10; ``forced_kernel("gemv")`` reaches K10.

Inputs are made with NumPy from a seed and handed to both packages."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu_torch.ops import gemm
from autogptq_tpu_torch.ops import quantlinear as tqlin
from test_torch_shape_classes import _layers, _packed

SMS = 132   # an H100 SXM
LLAMA = [(4096, 4096), (4096, 11008), (11008, 4096)]
WARPS = 4
# (bits, K, N, group size, desc_act): g128, g32, gs 100 (words straddling groups, a partial
# last group), desc_act, at every storage width
LAYERS = [(4, 512, 384, 128, False), (4, 512, 384, 32, False), (4, 600, 384, 100, False),
          (4, 512, 384, 128, True), (8, 300, 384, 100, False), (2, 512, 384, 32, True),
          (3, 512, 384, 100, False)]


def code_split(bits: int, m: int) -> int:
    """``csrc/wna16_gemv_t.cuh:tg_code_split``: the parts the warps split a
    word's codes into, so that a warp holds at most 4 accumulator fragments."""
    frags = 32 // tqlin.storage_bits(bits) // 2 * (1 if m <= 8 else 2)
    return frags // 4 if frags > 4 else 1


def k10_gemv_emulation(g: torch.Tensor, tl, hi_lo: bool = True) -> torch.Tensor:
    """The decode regime's f32 result before its one cast, in the kernel's
    order: per K tile and split, step i of 16 columns accumulates ``g @ hi^T``
    then ``g @ lo^T`` into warp ``i % NW``'s sum, the warps are added in order,
    the splits in split order (``hi_lo=False``: ``hi`` alone, one rounding of
    the weight). ``g`` holds values of the cotangent's type."""
    m, n = g.shape
    k = tl.in_features
    gs = k if tl.group_size == -1 else tl.group_size
    plan = gemm.t_gemv_plan(k, n, m, gs, tl.bits, SMS)
    w = tqlin.logical_weight(tl).float()          # (q - z) * s, exact in f32
    if tl.kperm is not None:
        w = w[tl.kperm]                           # the sorted rows the kernel walks
    hi = w.to(g.dtype).float()
    lo = (w - hi).to(g.dtype).float() if hi_lo else torch.zeros_like(w)
    gf = g.float()
    nw = WARPS // code_split(tl.bits, m)
    dxs = torch.zeros((m, k))
    for k0 in range(0, k, plan["kt"]):
        rows = slice(k0, min(k, k0 + plan["kt"]))
        for split in range(plan["splits"]):
            n0, n1 = split * plan["nc"], min(n, (split + 1) * plan["nc"])
            warps = [torch.zeros((m, rows.stop - rows.start)) for _ in range(nw)]
            for i, c in enumerate(range(n0, n1, 16)):
                cols = slice(c, min(c + 16, n1))
                warps[i % nw] += gf[:, cols] @ hi[rows, cols].t()
                warps[i % nw] += gf[:, cols] @ lo[rows, cols].t()
            block = torch.zeros_like(warps[0])
            for acc in warps:
                block += acc
            dxs[:, rows] += block
    if tl.kperm is None:
        return dxs
    dx = torch.empty_like(dxs)
    dx[:, tl.kperm] = dxs
    return dx


def _case(bits, k, n, gs, desc_act, m, dtype):
    t = _packed(bits * 100 + gs + m, bits, k, n, gs, desc_act)
    jl, tl = _layers(t, bits, k, n, gs)
    g = torch.from_numpy(np.random.default_rng(k + m).standard_normal((m, n)).astype(np.float32))
    g = g.to(dtype)
    want = np.asarray(jqlin.matmul_t(jnp.asarray(g.float().numpy()), jl, k, backend="xla"))
    # |w - hi - lo| <= 2^-18 |w| per weight (two roundings to 8 significant bits): dx within
    # 2^-18 sum |g| |w|; 2^-16 leaves room for the f32 sums' own roundings
    bound = 2.0 ** -16 * float((g.float().abs() @ tqlin.logical_weight(tl).abs().t()).max())
    return tl, g, want, bound


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 10, 16])
@pytest.mark.parametrize("bits, k, n, gs, desc_act", LAYERS)
def test_k10_gemv_order_matches_jax(bits, k, n, gs, desc_act, m, dtype):
    """The emulated decode regime equals JAX's ``matmul_t`` (XLA, f32) on
    the same cotangent within the hi/lo pair's bound,
    ``2^-16 max(|g| @ |W|^T)`` (stated in ``_case``), with more than one K
    tile, and more than one split at M = 1."""
    tl, g, want, bound = _case(bits, k, n, gs, desc_act, m, dtype)
    plan = gemm.t_gemv_plan(k, n, m, gs, bits, SMS)
    assert plan["k_tiles"] > 1 and (m > 1 or plan["splits"] > 1)
    np.testing.assert_allclose(k10_gemv_emulation(g, tl).numpy(), want, rtol=0, atol=bound)


@pytest.mark.parametrize("bits, k, n, gs, desc_act", LAYERS[:4])
def test_one_rounding_of_the_weight_misses_the_bound(bits, k, n, gs, desc_act):
    """The weight rounded once to bf16 (``hi`` alone, K10's rejected design)
    lies outside the bound the pair holds: the pair is what the comparison
    above checks."""
    tl, g, want, bound = _case(bits, k, n, gs, desc_act, 16, torch.bfloat16)
    assert np.abs(k10_gemv_emulation(g, tl, hi_lo=False).numpy() - want).max() > bound


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("gs", [128, 32, 100, 12, 6, -1])
def test_t_gemv_plan_covers_k_and_n_within_its_limits(bits, gs):
    """At Llama-2-7B's projections and 1, 10 and 16 rows: K tiles of 8 word
    rows cover K, whole 128-column stages per split cover N once, at most 32
    splits and about 4 blocks per SM, the f32 partials within a quarter of the
    weight's bytes, the block's shared memory the ring (or the warps' partials)
    within the limit; the same shapes give the same plan."""
    assert list(inspect.signature(gemm.t_gemv_plan).parameters) == [
        "k", "n", "m", "group_size", "bits", "sms"]
    p_rows = 32 // gemm.storage_bits(bits)
    for k, n in LLAMA:
        for m in (1, 10, 16):
            p = gemm.t_gemv_plan(k, n, m, gs, bits, SMS)
            g = k if gs == -1 else gs
            assert p["kt"] == 8 * p_rows and p["k_tiles"] == -(-k // p["kt"])
            assert p["nc"] % gemm.T_GEMV_BN == 0
            assert (p["splits"] - 1) * p["nc"] < n <= p["splits"] * p["nc"]
            assert 1 <= p["splits"] <= gemm.GEMV_MAX_SPLITS
            assert p["blocks"] == p["k_tiles"] * p["splits"]
            assert p["splits"] == 1 or p["blocks"] <= 2 * gemm.GEMV_BLOCKS_PER_SM * SMS
            assert p["workspace_bytes"] <= gemm.GEMV_WS_SHARE * p["weight_bytes"]
            assert p["workspace_bytes"] == (4 * m * k * p["splits"] if p["splits"] > 1 else 0)
            assert p["stage_groups"] == gemm.mma_stage_groups(g, p["kt"])
            mt = 8 if m <= 8 else 16
            ring = 4 * (-(-(8 * 144 * 4 + mt * 144 * 2 + p["stage_groups"] * 128 * 3) // 16) * 16)
            assert p["smem_bytes"] == max(ring, 4 * mt * (p["kt"] + 4) * 4)
            assert p["smem_bytes"] <= gemm.GEMV_SMEM_LIMIT
            assert gemm.t_gemv_plan(k, n, m, gs, bits, SMS) == p


def test_t_gemv_plan_fills_the_card_at_llama_shapes():
    """At 4-bit g128 and 16 rows each Llama-2-7B projection's backward has
    512-516 blocks: 64 or 172 K tiles times 8 or 3 splits."""
    got = [(p["k_tiles"], p["splits"], p["blocks"])
           for p in (gemm.t_gemv_plan(k, n, 16, 128, 4, SMS) for k, n in LLAMA)]
    assert got == [(64, 8, 512), (64, 8, 512), (172, 3, 516)]


def test_t_gemv_plan_refuses_a_stage_above_the_limit():
    """2-bit codes at group size 1 would stage 129 group rows per stage: the
    plan raises, so the wrapper launches nothing; 4-bit at group size 1 fits."""
    with pytest.raises(NotImplementedError, match="shared memory"):
        gemm.t_gemv_plan(4096, 4096, 16, 1, 2, SMS)
    gemm.t_gemv_plan(4096, 4096, 16, 1, 4, SMS)


@pytest.mark.parametrize("m", [1, 4, 10, 16, 17, 128, 2048])
def test_k10_route_by_dtype_and_rows(m):
    """K10 takes its decode regime for bf16/f16 at M <= 16 and the tile K10
    above (the wgmma/TMA one), at every group size; f32 takes the
    SIMT K10 at every M."""
    for dtype in (torch.bfloat16, torch.float16):
        assert gemm.t_route(dtype, m) == ("gemv" if m <= 16 else "wgmma")
    assert gemm.t_route(torch.float32, m) == "simt"
    # the tile kernel, the one K10 takes above 16 rows, is the wgmma/TMA one
    assert gemm.tile_kernel(torch.bfloat16) == "wgmma"


def test_forced_kernel_reaches_k10():
    """``forced_kernel("gemv")`` names K10's decode regime for every K10 call
    inside it (and "mma", "simt" the others); a call's own ``kernel`` wins; on
    the CPU the plain version still answers."""
    assert gemm._t_kernel(None) is None
    for kernel in ("gemv", "mma", "simt"):
        with gemm.forced_kernel(kernel):
            assert gemm.t_route(torch.bfloat16, 4, gemm._t_kernel(None)) == kernel
            assert gemm._t_kernel("mma") == "mma"
    assert gemm._t_kernel(None) is None
    t = _packed(7, 4, 256, 128, 128, False)
    _, tl = _layers(t, 4, 256, 128, 128)
    g = torch.randn((4, 128))
    with gemm.forced_kernel("gemv"):
        got = tqlin.matmul_t(g, tl)
    torch.testing.assert_close(got, gemm.wna16_matmul_t_ref(
        g, tl.qweight, tl.scales, tl.zeros, tl.kperm, 128, 4), rtol=0, atol=0)
