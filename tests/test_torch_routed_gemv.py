"""The host side of K9's expert-major tensor-core GEMV (autogptq_tpu_torch.ops.gemm):
its launch plan from shapes alone (``routed_plan``), the assignment of pairs to the
expert slices of its grid (``routed_slices``, the plain model of the kernel's ballot),
the static route that picks it (``routed_route``), and the plain version the kernel is
held to on the card against the JAX package's ``matmul_routed`` at Mixtral's decode pair
counts, with repeated experts (inputs made with NumPy from a seed and handed to both).
The kernel itself runs only on the card: ``tests/test_torch_cuda_kernels.py``."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu_torch.ops import build, gemm
from autogptq_tpu_torch.ops import quantlinear as qlin
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors

SMS = 132   # an H100 SXM
# (K, N) of Mixtral-8x7B's expert projections (w1/w3, w2) and a narrow one
SHAPES = [(4096, 14336), (14336, 4096), (1024, 1000)]
# Mixtral's decode selections: batch 1 (top 2), beam 4 (8 pairs, 5 distinct experts), and
# two more with repeats and an expert every pair chose
SELS = {1: [3], 2: [1, 6], 8: [0, 7, 7, 2, 0, 5, 1, 7], 9: [4] * 9,
        16: [1, 4, 1, 0, 2, 3, 7, 6, 5, 4, 4, 1, 0, 0, 2, 6]}


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("group_size", [32, 64, 128, -1])
@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
def test_routed_plan_covers_k_within_the_gemv_limits(bits, group_size, p):
    """The splits cover K once in whole stages (and whole groups where a group
    fits a split); at most GEMV_MAX_SPLITS; f32 partials [splits, P, N]
    within GEMV_WS_SHARE of the bytes of the min(P, E) experts a call can
    stream; shared memory (an x stage of P rows) within the GEMV's limit;
    the grid holds min(P, E) expert slices, one ticket counter per slice and
    column tile."""
    e = 8
    for k, n in SHAPES:
        plan = gemm.routed_plan(k, n, p, e, group_size, bits, SMS)
        gs = k if group_size == -1 else group_size
        active = min(p, e)
        assert (plan["splits"] - 1) * plan["kc"] < k <= plan["splits"] * plan["kc"]
        assert plan["kc"] % plan["stage_k"] == 0
        if gs <= plan["kc"]:
            assert plan["kc"] % gs == 0
        assert 1 <= plan["splits"] <= gemm.GEMV_MAX_SPLITS
        per_expert = k * n // 2 + 3 * -(-k // gs) * n
        assert plan["weight_bytes"] == active * per_expert
        assert plan["workspace_bytes"] == (4 * p * n * plan["splits"] if plan["splits"] > 1
                                           else 0)
        assert plan["workspace_bytes"] <= gemm.GEMV_WS_SHARE * plan["weight_bytes"]
        assert plan["smem_bytes"] <= gemm.GEMV_SMEM_LIMIT
        one = gemm.gemv_plan(k, n, 1, group_size, bits, SMS)    # its x stage: 8 rows
        stages = one["smem_bytes"] - 8 * (one["kc"] + 8) * 2
        assert plan["smem_bytes"] == stages + p * (plan["kc"] + 8) * 2
        assert plan["col_blocks"] == -(-n // gemm.GEMV_BN)
        assert plan["slices"] == active
        assert plan["blocks"] == plan["col_blocks"] * plan["splits"] * active
        assert plan["counters"] == active * plan["col_blocks"]


def test_routed_plan_depends_on_shapes_alone():
    """The plan takes no selection: the grid is the same for every ``sel`` of
    the same P (a decode step is planned without a read of the card); 3-bit
    codes plan as the nibbles they ride in; one expert is K1's GEMV plan but
    for its x stage of P rows; more than 16 pairs raise (the block's operand
    holds 16 rows)."""
    assert list(inspect.signature(gemm.routed_plan).parameters) == [
        "k", "n", "p", "e", "group_size", "bits", "sms"]
    a = gemm.routed_plan(4096, 14336, 2, 8, 128, 4, SMS)
    gemm.routed_plan(14336, 4096, 8, 8, 64, 3, SMS)
    assert gemm.routed_plan(4096, 14336, 2, 8, 128, 4, SMS) == a
    assert gemm.routed_plan(4096, 14336, 2, 8, 128, 3, SMS) == a
    one = gemm.routed_plan(4096, 4096, 4, 1, 128, 4, SMS)
    dense = gemm.gemv_plan(4096, 4096, 4, 128, 4, SMS)
    assert {key: one[key] for key in dense if key != "smem_bytes"} == {
        key: v for key, v in dense.items() if key != "smem_bytes"}
    assert dense["smem_bytes"] - one["smem_bytes"] == (8 - 4) * (dense["kc"] + 8) * 2
    # Mixtral at batch 1: 2 splits of 2048 rows (w1/w3) and 7 (w2), 896 blocks each
    assert [(gemm.routed_plan(k, n, 2, 8, 128, 4, SMS)["splits"],
             gemm.routed_plan(k, n, 2, 8, 128, 4, SMS)["blocks"]) for k, n in SHAPES[:2]] == [
        (2, 896), (7, 896)]
    for p in (0, 17):
        with pytest.raises(ValueError, match="pairs"):
            gemm.routed_plan(4096, 4096, p, 8, 128, 4, SMS)


def _popc(v):
    return bin(v).count("1")


def _kernel_slice(sel, e, z):
    """Slice z's expert and rows as the kernel computes them, bit for bit: a
    lane per pair, a match of the lanes holding the same valid id (the first
    of each is its lowest lane), a ballot of the first lanes, the one whose
    rank among them is z, then a ballot of the pairs that chose its id, each
    pair's row its rank among the set bits."""
    ok = [0 <= s < e for s in sel]
    keys = [s if ok[p] else -1 - p for p, s in enumerate(sel)]
    first = [ok[p] and min(q for q in range(len(sel)) if keys[q] == keys[p]) == p
             for p in range(len(sel))]
    firsts = sum(1 << p for p in range(len(sel)) if first[p])
    mine = [p for p in range(len(sel)) if first[p] and _popc(firsts & ((1 << p) - 1)) == z]
    if not mine:
        return None, []
    ex = sel[mine[0]]
    chose = sum(1 << p for p in range(len(sel)) if ok[p] and sel[p] == ex)
    rows = [None] * _popc(chose)
    for p in range(len(sel)):
        if chose >> p & 1:
            rows[_popc(chose & ((1 << p) - 1))] = p
    return ex, rows


@pytest.mark.parametrize("sel", list(SELS.values()) + [[2, -1, 6, 2], [8, 3], [1 << 20],
                                                       [5, 5, 5, 9, 0, -3, 0, 5]])
def test_expert_major_assignment_serves_each_valid_pair_once(sel):
    """Every pair whose id lies in [0, E) is served by exactly one of the
    min(P, E) expert slices, the one of its id, in pair order; the slices
    take the distinct experts in order of first appearance, each once, and
    the rest do nothing; a bad id is served by none; the kernel's match and
    ballots give the same slices."""
    e = 8
    slices = gemm.routed_slices(torch.tensor(sel, dtype=torch.int32), e)
    assert len(slices) == min(len(sel), e)
    served = [p for _, rows in slices for p in rows]
    assert sorted(served) == [p for p, s in enumerate(sel) if 0 <= s < e]
    experts = [ex for ex, _ in slices if ex is not None]
    assert experts == list(dict.fromkeys(s for s in sel if 0 <= s < e))
    for z, (ex, rows) in enumerate(slices):
        assert (ex is None) == (not rows)
        assert rows == sorted(rows) and all(sel[p] == ex for p in rows)
        assert (ex, rows) == _kernel_slice(sel, e, z)
        assert len(rows) <= gemm.ROUTED_GEMV_MAX_P
    assert gemm.routed_slices(sel, e) == slices


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("p", [1, 2, 8, 16])
@pytest.mark.parametrize("gs", [16, 32, 128, 14336])
def test_routed_route_takes_the_gemv(dtype, p, gs):
    assert gemm.routed_route(dtype, p, gs) == "gemv"


def test_routed_route_keeps_the_simt_kernel():
    """f32 pairs, group sizes below 16 (held on the card at 12) and more
    pairs than a block's operand holds take the SIMT routed kernel; bf16/f16
    pairs at the larger group sizes 16 does not divide (held on the card at
    100) take the GEMV's ANY_GS instance; ``kernel`` names either; the tile
    kernel is no routed kernel."""
    for p in (1, 2, 8, 16):
        assert gemm.routed_route(torch.float32, p, 128) == "simt"
        for gs in (8, 12, 24, 100):
            for dtype in (torch.bfloat16, torch.float16, torch.float32):
                want = "gemv" if dtype != torch.float32 and gs >= 16 else "simt"
                assert gemm.routed_route(dtype, p, gs) == want
        assert gemm.routed_route(torch.float16, 17, 12) == "simt"
    assert gemm.routed_route(torch.bfloat16, 17, 128) == "simt"
    assert gemm.routed_route(torch.float32, 2, 100, "gemv") == "gemv"
    assert gemm.routed_route(torch.bfloat16, 2, 128, "simt") == "simt"
    with pytest.raises(ValueError, match="gemv"):
        gemm.routed_route(torch.bfloat16, 2, 128, "mma")


def _stacks(seed, e, k, n, gs, bits=4):
    """(port StackedQuantLinear, JAX StackedQuantLinear) of the same experts."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for _ in range(e):
        t = random_quant_tensors(rng, k, n, bits, gs, False)
        kw = dict(bias=None, bits=bits, group_size=gs, in_features=k, out_features=n)
        port.append(qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"], **kw),
            device="cpu", dtype=torch.float32))
        ref.append(jqlin.from_packed(jqlin.PackedQuantLinear(
            qweight=jnp.asarray(t["qweight"]), qzeros=jnp.asarray(t["qzeros"]),
            scales=jnp.asarray(t["scales"]), g_idx=jnp.asarray(t["g_idx"]), **kw)))
    return qlin.stack_experts(port), jqlin.stack_experts(ref)


@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("backend, rtol", [("pallas_interpret", 2e-2), ("xla", 1e-5)])
def test_plain_k9_matches_jax_matmul_routed(p, backend, rtol):
    """The plain K9 (the slices of ``routed_slices``) against the JAX
    ``matmul_routed`` on its XLA route (f32, 1e-5) and its TPU kernel in
    interpret mode (it dots in bf16: 2e-2 of the largest output), E = 8,
    Mixtral's pair counts with repeated experts. A CPU tensor launches
    nothing."""
    port, ref = _stacks(p, 8, 1024, 256, 128)
    sel = np.array(SELS[p], np.int32)
    x = (np.random.default_rng(p + 1).standard_normal((p, 1024)) * 0.1).astype(np.float32)
    before = dict(build.launches)
    got = qlin.matmul_routed(torch.from_numpy(x), port, torch.from_numpy(sel)).numpy()
    assert dict(build.launches) == before
    want = np.asarray(jqlin.matmul_routed(jnp.asarray(x), ref, jnp.asarray(sel), backend=backend))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    for row, e in enumerate(sel):      # row p is x[p] @ W[sel[p]] of its own expert
        w = qlin.logical_weight(port.expert(int(e)))
        np.testing.assert_allclose(got[row], x[row] @ w.numpy(), rtol=1e-5, atol=1e-5)


def test_plain_k9_3bit_matches_jax_xla():
    """3-bit experts (codes in nibbles, as the routed GEMV reads them) at 8
    pairs with repeats against the JAX XLA route."""
    port, ref = _stacks(3, 8, 1024, 128, 64, bits=3)
    sel = np.array(SELS[8], np.int32)
    x = (np.random.default_rng(4).standard_normal((8, 1024)) * 0.1).astype(np.float32)
    got = qlin.matmul_routed(torch.from_numpy(x), port, torch.from_numpy(sel)).numpy()
    want = np.asarray(jqlin.matmul_routed(jnp.asarray(x), ref, jnp.asarray(sel), backend="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
