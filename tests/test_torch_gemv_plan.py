"""The host side of K1/K4/K5's tensor-core decode GEMV (autogptq_tpu_torch.ops.gemm):
its launch plan from shapes alone (``gemv_plan``, which K6 and K9 share), the static
route that picks it (``route``, ``forced_kernel``), and the plain version the kernel is
held to on the card, against the JAX package's ``quantlinear.matmul_xla`` at the GEMV's
row counts (inputs made with NumPy from a seed and handed to both). The kernel itself
runs only on the card: ``tests/test_torch_cuda_kernels.py``."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu_torch.ops import build, gemm
from autogptq_tpu_torch.ops import quantlinear as tqlin
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors

SMS = 132   # an H100 SXM
# (K, N) of the projections: Llama-2-7B's q/k/v/o, gate/up and down; Mixtral-8x7B's k/v,
# expert w1/w3 and expert w2
LLAMA = [(4096, 4096), (4096, 11008), (11008, 4096)]
MIXTRAL = [(4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("group_size", [32, 64, 128, -1])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_plan_covers_k_within_its_limits(bits, group_size, m):
    """The splits cover K once, in whole stages and, where a group fits a
    split, in whole groups; at most GEMV_MAX_SPLITS of them (the last
    block's merge), the f32 partials within GEMV_WS_SHARE of the weight's
    bytes, the block's shared memory within its limit."""
    for k, n in LLAMA + MIXTRAL:
        p = gemm.gemv_plan(k, n, m, group_size, bits, SMS)
        gs = k if group_size == -1 else group_size
        assert (p["splits"] - 1) * p["kc"] < k <= p["splits"] * p["kc"]
        assert p["kc"] % p["stage_k"] == 0 and p["stage_k"] == 16 * 32 // gemm.storage_bits(bits)
        if gs <= p["kc"]:
            assert p["kc"] % gs == 0, (k, n, p)
        assert 1 <= p["splits"] <= gemm.GEMV_MAX_SPLITS
        assert p["workspace_bytes"] <= gemm.GEMV_WS_SHARE * p["weight_bytes"], (k, n, p)
        assert p["workspace_bytes"] == (4 * m * n * p["splits"] if p["splits"] > 1 else 0)
        assert p["col_blocks"] == -(-n // gemm.GEMV_BN)
        assert p["blocks"] == p["col_blocks"] * p["splits"]
        assert p["smem_bytes"] <= gemm.GEMV_SMEM_LIMIT


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_plan_fills_the_card_at_llama_shapes(bits, m):
    """At Llama-2-7B's projections the grid holds at least 2 blocks per SM;
    up to 8 rows it takes no more than GEMV_BLOCKS_PER_SM per SM (one wave),
    while at 16 rows the staged x caps a split at 1024 rows, which can take
    more. The one shape held below 2 per SM is 2-bit q/k/v/o at 16 rows: the
    workspace share allows 4 splits of 1024 rows there, 256 blocks."""
    for k, n in LLAMA:
        p = gemm.gemv_plan(k, n, m, 128, bits, SMS)
        if m <= 8:
            assert p["blocks"] <= gemm.GEMV_BLOCKS_PER_SM * SMS
        else:
            assert p["kc"] <= gemm.GEMV_X_SMEM // (2 * 16)
        if bits == 2 and m > 8 and (k, n) == (4096, 4096):
            assert (p["splits"], p["blocks"]) == (4, 256)
        else:
            assert p["blocks"] >= 2 * SMS, (k, n, p)


def test_plan_depends_on_shapes_alone():
    """The plan is a function of the shapes (and the SM count): the same
    shapes give the same plan whatever came before, 3-bit codes plan as the
    nibbles they ride in, group size -1 as one group of K rows, and a caller
    that edits its copy changes nothing."""
    assert list(inspect.signature(gemm.gemv_plan).parameters) == [
        "k", "n", "m", "group_size", "bits", "sms"]
    a = gemm.gemv_plan(4096, 4096, 1, 128, 4, SMS)
    gemm.gemv_plan(11008, 4096, 16, 32, 8, SMS)
    assert gemm.gemv_plan(4096, 4096, 1, 128, 4, SMS) == a
    assert gemm.gemv_plan(4096, 4096, 1, 128, 3, SMS) == a
    assert gemm.gemv_plan(4096, 4096, 1, -1, 4, SMS) == gemm.gemv_plan(4096, 4096, 1, 4096, 4,
                                                                        SMS)
    a["kc"] = 0
    assert gemm.gemv_plan(4096, 4096, 1, 128, 4, SMS)["kc"] == 512
    # Llama-2-7B's decode step: 8, 3 and 8 splits, 512-516 blocks of 64 columns
    assert [gemm.gemv_plan(k, n, 1, 128, 4, SMS)["splits"] for k, n in LLAMA] == [8, 3, 8]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 2, 4, 9, 16])
@pytest.mark.parametrize("gs", [16, 32, 128, 4096])
def test_route_takes_the_gemv(dtype, m, gs):
    assert gemm.route(dtype, m, gs) == "gemv"


@pytest.mark.parametrize("m", [1, 4, 16, 17, 128])
def test_route_keeps_the_simt_kernels_for_f32_and_rest_classes(m):
    """f32 activations keep the SIMT kernels at any row count; the group sizes
    16 does not divide (a word straddling groups, or 8 | gs alone) take, in
    bf16/f16, the tensor-core GEMV's ANY_GS instance at M <= 16 from group
    size 16 on and the SIMT GEMV below it, and the tensor-core tile kernel
    above 16 rows, as 16 | gs does."""
    assert gemm.route(torch.float32, m, 128) == "simt"
    for gs in (4, 8, 24, 100, 172):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            if dtype == torch.float32:
                want = "simt"
            elif m > 16:
                want = "wgmma"
            else:
                want = "gemv" if gs >= 16 else "simt"
            assert gemm.route(dtype, m, gs) == want


@pytest.mark.parametrize("m", [17, 32, 2048])
def test_route_above_16_rows_is_the_tile_kernels(m):
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for gs in (16, 32, 128, 100):
            assert gemm.route(dtype, m, gs) == gemm.tile_kernel(dtype)


def test_route_names_a_kernel_and_forced_kernel_restores():
    """``kernel`` overrides the route; ``forced_kernel`` sets it for every
    call inside and restores the previous setting on the way out, also
    after an exception; an unknown name raises."""
    for kernel in ("gemv", "mma", "simt"):
        assert gemm.route(torch.float32, 1, 100, kernel) == kernel
    with pytest.raises(ValueError):
        gemm.route(torch.bfloat16, 1, 128, "tile")
    with pytest.raises(ValueError):
        with gemm.forced_kernel("fast"):
            pass
    assert gemm._forced[0] is None
    with gemm.forced_kernel("simt"):
        assert gemm._forced[0] == "simt"
        with pytest.raises(RuntimeError):
            with gemm.forced_kernel("mma"):
                assert gemm._forced[0] == "mma"
                raise RuntimeError
        assert gemm._forced[0] == "simt"
    assert gemm._forced[0] is None


@pytest.mark.parametrize("m", [1, 4, 16])
def test_k6_and_k9_take_the_gemv_plan(m):
    """K6's GEMV over kb32l tiles is planned as K1's on the same true K and N
    (the tiles' padding adds nothing), and K9's routed GEMV with one active
    expert is K1's plan too (its x stage holds P rows, not 8 or 16); with
    min(P, E) active experts it takes as many
    splits as the blocks of that many experts allow, never more than one
    expert's."""
    for k, n in LLAMA + MIXTRAL:
        dense = gemm.gemv_plan(k, n, m, 128, 4, SMS)
        routed = gemm.routed_plan(k, n, m, 1, 128, 4, SMS)
        assert {key: routed[key] for key in dense if key != "smem_bytes"} == {
            key: v for key, v in dense.items() if key != "smem_bytes"}
        wide = gemm.routed_plan(k, n, m, 8, 128, 4, SMS)
        assert wide["splits"] <= dense["splits"] and wide["kc"] >= dense["kc"]
        assert wide["blocks"] == min(m, 8) * wide["col_blocks"] * wide["splits"]


def _layers(seed, k, n, bits, gs, desc_act):
    """The same random checkpoint layer (with a bias) as a JAX and a port QuantLinear."""
    rng = np.random.default_rng(seed)
    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    b = rng.standard_normal(n).astype(np.float32)
    fields = dict(bits=bits, group_size=gs, in_features=k, out_features=n)
    jl = jqlin.from_packed(jqlin.PackedQuantLinear(
        qweight=jnp.asarray(t["qweight"]), qzeros=jnp.asarray(t["qzeros"]),
        scales=jnp.asarray(t["scales"]), g_idx=jnp.asarray(t["g_idx"]), bias=jnp.asarray(b),
        **fields))
    tl = tqlin.from_packed(tqlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=b, **fields), device="cpu", dtype=torch.float32)
    return jl, tl


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("gs, desc_act", [(128, False), (32, True)])
def test_plain_matches_xla_at_gemv_rows(bits, m, gs, desc_act):
    """The plain version the GEMV is held to on the card, at the beam step's
    4 rows and the prefill's 16, against the JAX package's XLA route: f32
    on both sides, the same dequantized weight, summation order only. A CPU
    tensor takes the plain version and launches nothing."""
    jl, tl = _layers(bits * 10 + m + gs, 512, 192, bits, gs, desc_act)
    x = np.random.default_rng(m + bits).standard_normal((m, 512)).astype(np.float32)
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x), jl))
    before = dict(build.launches)
    got = tqlin.matmul(torch.from_numpy(x), tl).numpy()
    assert dict(build.launches) == before
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = gemm.wna16_matmul_ref(torch.from_numpy(x), tl.qweight, tl.scales, tl.zeros, tl.kperm,
                                  tl.bias, gs, tqlin.storage_bits(bits))
    np.testing.assert_array_equal(got, plain.numpy())
