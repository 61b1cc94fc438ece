"""The rest classes on the tensor-core decode GEMV, checked on the CPU: at M <= 16 the
group sizes of 16 rows or more that 16 does not divide take the ``ANY_GS`` instance of
``csrc/wna16_gemv.cuh`` (K1/K4/K5's ``<name>_gemv``, and K9's expert-major
``w4a16_routed_gemm_gemv``) in bf16 and f16; below 16 rows per group they keep the SIMT
kernels, though the instance takes them when asked. The kernel runs only on the card (``tests/test_torch_cuda_kernels.py``); here,
what it is built on:

* its arithmetic in the kernel's order, emulated in plain f32 torch: the splits of
  ``gemm.gemv_plan``, 16-row steps whose MMA slots stand for the K rows ``perm_slot``
  names, the exact ``q - z`` of each slot's own group, one product per group a step
  touches with x of the slots of other groups' rows masked to 0, each group's scale
  folded in at its last row or the split's end (a step inside one group accumulates into
  the group's part; a set that ends its group folds in from a zero accumulator with that
  part), the partials added in split order; held
  against the JAX package's ``matmul_xla`` on layers of every storage width;
* the stage's group rows (``gemm.gemv_plan``'s ``stage_groups``) against a brute-force
  count of the groups a stage touches, and the plan at the rest group sizes;
* the routes: bf16 and f16 take the GEMV from group size 16 on, f32 and smaller groups
  the SIMT GEMV.

Inputs are made with NumPy from a seed and handed to both packages."""

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
# (bits, K, N, group size, desc_act): words straddling groups, steps spanning two or more
# groups, a partial last group; K not a whole number of 16-row steps at 8 bits (K % 16 == 12);
# K large enough at 2 bits that the workspace share allows two splits at 16 rows; 3-bit
# checkpoints pack 32 rows to three words
REST = [(2, 2112, 64, 6, False), (2, 2048, 64, 12, False), (2, 2112, 64, 24, False),
        (2, 2048, 64, 100, False), (2, 2064, 64, 172, True),
        (3, 1056, 64, 6, False), (3, 1088, 64, 12, False), (3, 1056, 64, 24, False),
        (3, 1024, 128, 100, False), (3, 1376, 64, 172, True),
        (4, 1032, 64, 6, False), (4, 1032, 64, 12, False), (4, 1048, 64, 24, False),
        (4, 1024, 128, 100, False), (4, 1376, 64, 172, True),
        (8, 1020, 64, 6, False), (8, 1020, 64, 12, False), (8, 1044, 64, 24, False),
        (8, 2020, 64, 100, False), (8, 1376, 64, 172, True)]


def perm_slot(s: int, sb: int) -> int:
    """``csrc/wna16_gemv.cuh:perm_slot``: the K row, within a 16-row step, that
    MMA slot ``s`` stands for with ``sb``-bit storage."""
    p = 32 // sb
    q = p // 4
    t = (s % 8) // 2
    return (t // q) * p + t % q + (s // 8) * q + (s % 2) * (p // 2)


def gemv_emulation(x: torch.Tensor, tl, sms: int = SMS, mask_by_slot: bool = False):
    """The ANY_GS GEMV's arithmetic in its order, f32. ``mask_by_slot`` masks
    slot s by K row s instead of ``perm_slot(s)`` (a wrong mask, to show the
    comparison sees it)."""
    m, k = x.shape
    n = tl.out_features
    sb = tqlin.storage_bits(tl.bits)
    gs = k if tl.group_size == -1 else tl.group_size
    plan = gemm.gemv_plan(k, n, m, gs, tl.bits, sms)
    q = torch.cat([tqlin.codes(tl).float(), torch.zeros((16, n))])   # rows past K: zero words
    z, s = tl.zeros.float(), tl.scales.float()
    xs = x.index_select(1, tl.kperm) if tl.kperm is not None else x
    xs = torch.cat([xs, torch.zeros((m, 16))], 1)                     # staged x past K: zero
    rows = torch.tensor([perm_slot(i, sb) for i in range(16)])
    by = torch.arange(16) if mask_by_slot else rows
    gidx = (torch.arange(k + 16) // gs).clamp(max=z.shape[0] - 1)   # each row's group
    partials = []
    for split in range(plan["splits"]):
        k0 = split * plan["kc"]
        k1 = min(k, k0 + plan["kc"])
        acc = torch.zeros((m, n))
        part = [torch.zeros((m, n))]
        for k16 in range(k0, k1, 16):
            xr, qr = xs[:, k16 + rows], q[k16 + rows]         # the step's slots
            g = k16 // gs
            if (g + 1) * gs >= k16 + 16 and k16 + 16 <= k:     # the step lies in one group
                part[0] += xr @ (qr - z[g])
                if (g + 1) * gs == k16 + 16 or k16 + 16 >= k1:  # the group or the split ends
                    acc += part[0] * s[g]
                    part = [torch.zeros((m, n))]
                continue
            a = qr - z[gidx[(k16 + rows).clamp(max=k - 1)]]    # each slot its own group's zero
            while g * gs < min(k16 + 16, k1):
                lo, hi = g * gs, min(g * gs + gs, k)
                mask = ((k16 + by >= lo) & (k16 + by < hi)).float()
                d = (xr * mask) @ a
                if hi <= k16 + 16 or k16 + 16 >= k1:           # the group or the split ends
                    acc += (d + part[0]) * s[g]
                    part = [torch.zeros((m, n))]
                else:                                          # it goes on: its first part
                    part[0] += d
                g += 1
        partials.append(acc)
    out = torch.zeros((m, n))
    for p in partials:                                         # split order
        out += p
    return out + tl.bias.float()


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("bits, k, n, gs, desc_act", REST)
def test_gemv_order_matches_jax(bits, k, n, gs, desc_act, m):
    """The emulated ANY_GS GEMV equals JAX's ``matmul_xla`` within 1e-5 of
    the largest output, f32 (both exact products summed in f32, in other
    orders), with more than one split, at every group size: below 16 too,
    where a step takes up to ceil(15/gs) + 1 masked sets."""
    t = _packed(bits * 1000 + gs + m, bits, k, n, gs, desc_act)
    jl, tl = _layers(t, bits, k, n, gs)
    x = np.random.default_rng(gs + k + m).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x), jl))
    got = gemv_emulation(torch.from_numpy(x), tl).numpy()
    assert gemm.gemv_plan(k, n, m, gs, bits, SMS)["splits"] > 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bits, gs", [(2, 24), (4, 20), (8, 100), (8, 6)])
def test_mask_must_follow_perm_slot(bits, gs):
    """Masking the slots by their own index instead of the K row they stand
    for gives another product where a step spans groups: the comparison of
    the test above sees a wrong mask."""
    k, n = 1024 if bits != 8 else 1020, 64
    t = _packed(bits + gs, bits, k, n, gs, False)
    jl, tl = _layers(t, bits, k, n, gs)
    x = torch.from_numpy(np.random.default_rng(gs).standard_normal((4, k)).astype(np.float32))
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x.numpy()), jl))
    right = gemv_emulation(x, tl).numpy()
    wrong = gemv_emulation(x, tl, mask_by_slot=True).numpy()
    np.testing.assert_allclose(right, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(wrong - want).max() > 1e-2 * np.abs(want).max()


def _touched(a: int, rows: int, gs: int) -> int:
    """Groups that ``rows`` consecutive K rows from row ``a`` touch."""
    return (a + rows - 1) // gs - a // gs + 1


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_stage_group_rows_cover_every_stage(bits):
    """A stage holds 16 word rows (512 / storage bits K rows). For every group
    size 1..256 the plan's stage group rows hold every group such a stage
    touches at any offset (splits start on whole stages, so a stage starts on
    a multiple of its rows; the ANY_GS rule holds at every offset), the 16 | gs
    instance's fixed bk / 16 rows every group of a stage at a multiple of bk,
    and the plan's shared memory is the ring of that layout plus the x
    stage."""
    sb = tqlin.storage_bits(bits)
    bk = 16 * 32 // sb
    for gs in range(1, 257):
        try:
            plan = gemm.gemv_plan(4096, 4096, 16, gs, bits, SMS)
        except NotImplementedError:
            assert (bits, gs) == (2, 1)
            continue
        ng = plan["stage_groups"]
        assert plan["stage_k"] == bk
        assert max(_touched(t * bk, bk, gs) for t in range(gs)) <= ng
        if gs % 16 == 0:
            assert ng == bk // 16
        else:
            assert ng == gemm.mma_stage_groups(gs, bk)
            assert max(_touched(a, bk, gs) for a in range(gs + bk)) <= ng
        # the ANY_GS stage also holds each K row's group row, a byte per row
        stage = -(-(16 * (64 + 16) * 4 + ng * 64 * 3 + (bk if gs % 16 else 0)) // 16) * 16
        assert plan["smem_bytes"] == 4 * stage + 16 * (plan["kc"] + 8) * 2 <= gemm.GEMV_SMEM_LIMIT


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("gs", [2, 6, 12, 24, 100, 172])
def test_plan_at_rest_group_sizes(bits, gs):
    """At Llama-2-7B's projections and 1, 4 and 16 rows the plan of a rest
    group size cuts K into whole stages (not whole groups: the ANY_GS
    instance folds a group a split cuts in each of its splits, so the plan
    takes at least as many splits as at g128, where the scales' bytes are
    fewer), covers K once, keeps its workspace within its share and its
    shared memory within the limit, and depends on the shapes alone (the same
    call, the same plan)."""
    for k, n in LLAMA:
        for m in (1, 4, 16):
            p = gemm.gemv_plan(k, n, m, gs, bits, SMS)
            assert p["kc"] % p["stage_k"] == 0 and p["kc"] % 16 == 0
            g128 = gemm.gemv_plan(k, n, m, 128, bits, SMS)
            assert p["splits"] >= g128["splits"]
            assert (p["splits"] - 1) * p["kc"] < k <= p["splits"] * p["kc"]
            assert 1 <= p["splits"] <= gemm.GEMV_MAX_SPLITS
            assert p["workspace_bytes"] <= gemm.GEMV_WS_SHARE * p["weight_bytes"]
            assert p["smem_bytes"] <= gemm.GEMV_SMEM_LIMIT
            assert gemm.gemv_plan(k, n, m, gs, bits, SMS) == p


def test_plan_refuses_a_stage_above_the_limit():
    """2-bit codes at group size 1 would stage 257 group rows per 256-row
    stage: the plan raises, so the wrappers launch nothing."""
    with pytest.raises(NotImplementedError, match="shared memory"):
        gemm.gemv_plan(4096, 4096, 1, 1, 2, SMS)
    gemm.gemv_plan(4096, 4096, 1, 2, 2, SMS)


@pytest.mark.parametrize("m", [1, 2, 4, 9, 16])
@pytest.mark.parametrize("gs", [1, 2, 4, 6, 8, 12, 15, 17, 24, 100, 172, 16, 128, 4096])
def test_route_takes_the_gemv_from_group_size_16(m, gs):
    """At M <= 16 bf16 and f16 take the tensor-core GEMV at a group size of
    16 or more (``ANY_GS`` where 16 does not divide it) and the SIMT GEMV
    below (the exact masked sets lost to it on the H100), and f32 the SIMT
    GEMV; the routed product (K9) likewise up to 16 pairs."""
    want = "gemv" if gs >= 16 else "simt"
    for dtype in (torch.bfloat16, torch.float16):
        assert gemm.route(dtype, m, gs) == want
        assert gemm.routed_route(dtype, m, gs) == want
    assert gemm.route(torch.float32, m, gs) == "simt"
    assert gemm.routed_route(torch.float32, m, gs) == "simt"


@pytest.mark.parametrize("gs", [6, 12, 100])
def test_rest_routes_above_16_rows_and_pairs(gs):
    """Above 16 rows the rest classes take the tile kernels (the
    wgmma/TMA one), and above 16 pairs K9 the SIMT routed kernel; ``kernel``
    still names either GEMV for a timing beside the other, below group size 16
    too."""
    assert gemm.route(torch.bfloat16, 17, gs) == "wgmma"
    assert gemm.routed_route(torch.bfloat16, 17, gs) == "simt"
    assert gemm.route(torch.bfloat16, 1, gs, "simt") == "simt"
    assert gemm.route(torch.bfloat16, 1, gs, "gemv") == "gemv"
    assert gemm.routed_route(torch.bfloat16, 2, gs, "gemv") == "gemv"
    assert gemm.routed_route(torch.float16, 2, gs, "simt") == "simt"
    with gemm.forced_kernel("simt"):
        assert gemm.route(torch.bfloat16, 1, gs, gemm._forced[0]) == "simt"
