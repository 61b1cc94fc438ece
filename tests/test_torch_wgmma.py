"""The wgmma/TMA tile kernels (``csrc/wna16_wgmma.cuh``: K1/K4/K5's forward and
K10 above 16 rows, bf16 and f16) checked on the CPU. The kernels run only on
the card (``tests/test_torch_cuda_kernels.py``); here, what they are built on:

* ``gemm.wgmma_plan`` at the Llama-2-7B and Mixtral-8x7B shapes: enough blocks
  for the card or one reduction tile per split, no empty split, the stage
  layout inside the 227 KB a block may take at every bit width and at group
  sizes 2 to -1, TMA boxes of at most 256 per dimension with whole 16-byte
  inner rows;
* the static routes: bf16/f16 above 16 rows to ``"wgmma"`` over GPTQ words
  (the fused RMS-norm prologue's calls too) and over K6's kb32l words, K10
  over kb32l words too; shapes TMA cannot address to the mma.sync kernel,
  ``"mma"``, f32 to ``"simt"``; ``kernel=`` names each;
* each kernel's arithmetic emulated in plain torch (the weight
  ``s * (q - z)`` in f32 carried as the pair hi = round(w), lo = round(w -
  hi) of the activation type, f32 sums over 64-row reduction tiles, the
  split of the reduction the plan makes and the fixed order its partials are
  added in), held against the JAX package's ``matmul_xla`` and its VJP in
  f32 on small layers: 2/3/4/8 bits,
  group sizes 16/32/128/-1/12/100, desc_act with a bias, K and N off the tile.

Inputs are made with NumPy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu_torch.ops import gemm
from autogptq_tpu_torch.ops import quantlinear as tqlin
from test_torch_shape_classes import _packed

SMS = 132                      # the H100's SMs
SMEM_PER_BLOCK = 232448        # 227 KB: what one block may take on the H100
LLAMA = [(4096, 4096), (4096, 11008), (11008, 4096)]   # (K, N) of q/k/v/o, gate/up, down
MIXTRAL = [(4096, 14336), (14336, 4096)]                 # an expert's gate/up and down
T_EPS = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}   # half an ulp at 1
J_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.mark.parametrize("m", [17, 64, 65, 128, 2048])
@pytest.mark.parametrize("k, n", LLAMA + MIXTRAL)
def test_plan_fills_the_card_and_splits_whole_tiles(k, n, m):
    """Forward and K10: a block height by rows (64 up to 64 rows, 128 up to
    128, 256 above), at least ``sms`` blocks or one reduction tile per split,
    every split non-empty, the workspace of the split's f32 partials, and the
    same plan for 3- and 4-bit codes (both ride in nibbles)."""
    for transpose in (False, True):
        plan = gemm.wgmma_plan(m, k, n, 128, 4, SMS, transpose)
        red, cols = (n, k) if transpose else (k, n)
        assert plan["bm"] == (64 if m <= 64 else 128 if m <= 128 else 256)
        assert plan["ktiles"] == -(-red // 64)
        assert plan["tiles"] == -(-m // plan["bm"]) * -(-cols // 128)
        assert plan["blocks"] == plan["tiles"] * plan["splits"]
        assert plan["blocks"] >= SMS or plan["splits"] == plan["ktiles"]
        assert (plan["splits"] - 1) * plan["per"] < plan["ktiles"] <= plan["splits"] * plan["per"]
        assert plan["workspace_bytes"] == (4 * plan["splits"] * m * cols
                                           if plan["splits"] > 1 else 0)
        assert plan == gemm.wgmma_plan(m, k, n, 128, 3, SMS, transpose)
    # a training step's rows fill the card unsplit; M = 128 splits the reduction
    assert gemm.wgmma_plan(2048, k, n, 128, 4, SMS)["splits"] == 1
    assert gemm.wgmma_plan(128, k, n, 128, 4, SMS)["splits"] > 1


@pytest.mark.parametrize("gs", [2, 6, 12, 16, 100, 128, -1])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_plan_fits_shared_memory_and_tma_boxes(bits, gs):
    """Every bit width and group size: the ring holds at least 2 stages (4 or
    more from group size 12 on) beside the B tiles within 227 KB; each stage
    is 1024-aligned and holds the bytes of every TMA box of a tile (the
    activation tile, the words, ``mma_stage_groups`` group rows of scales and
    zeros, the forward's table of 64 group rows); each box is at most 256 per
    dimension with an inner row of whole 16-byte units, the activation tile
    exactly one 128-byte swizzle row."""
    for m in (17, 128, 2048):
        for transpose in (False, True):
            plan = gemm.wgmma_plan(m, 4096, 4096, gs, bits, SMS, transpose)
            g = 4096 if gs == -1 else gs
            assert plan["stage_groups"] == gemm.mma_stage_groups(g, 128 if transpose else 64)
            btiles = 3 * 2 * 128 * 64 * 2          # three pairs of hi/lo B tiles
            assert plan["smem_bytes"] == 1024 + btiles + plan["stages"] * plan["stage_bytes"]
            assert plan["smem_bytes"] <= gemm.MMA_SMEM_LIMIT < SMEM_PER_BLOCK
            assert plan["stages"] >= (4 if g >= 12 and m <= 128 else 2)
            assert plan["stage_bytes"] % 1024 == 0
            boxes = plan["boxes"]
            need = sum(inner * rows * size for inner, rows, size in boxes.values())
            assert plan["stage_bytes"] >= need + (0 if transpose else 64)
            assert boxes["a"] == (64, plan["bm"], 2)
            for inner, rows, size in boxes.values():
                assert 0 < inner <= 256 and 0 < rows <= 256 and inner * size % 16 == 0


@pytest.mark.parametrize("transpose", [False, True])
def test_plan_at_small_shapes(transpose):
    """Layers of a few column blocks (the card tests' shapes, N or K off the
    tile): every row count and width gets a plan with no empty split, at
    least ``sms`` blocks or one reduction tile per split."""
    for k, n in ((1024, 544), (1024, 1056), (1056, 544), (2048, 4096), (1032, 256), (128, 16)):
        for m in (17, 64, 65, 129, 300, 2048):
            for bits in (2, 4, 8):
                if k % (32 // bits):
                    continue
                plan = gemm.wgmma_plan(m, k, n, 32, bits, SMS, transpose)
                assert (plan["splits"] - 1) * plan["per"] < plan["ktiles"] <= (plan["splits"]
                                                                             * plan["per"])
                assert plan["blocks"] >= SMS or plan["splits"] == plan["ktiles"]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plan_takes_group_size_1(bits):
    """Group size 1, the largest stage (129 group rows for K10's 128 K rows,
    65 for the forward's 64): two or more stages still fit, of 256 rows or,
    at 8 bits, of 128, so no shape the wrappers can be given raises; each
    group row fits a byte of the group table."""
    for transpose in (False, True):
        plan = gemm.wgmma_plan(2048, 4096, 4096, 1, bits, SMS, transpose)
        assert plan["bm"] == (128 if bits == 8 else 256) and plan["stages"] >= 2
        assert plan["stage_groups"] == (129 if transpose else 65) <= 255


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [17, 128, 2048])
def test_routes_send_words_above_16_rows_to_wgmma(dtype, m):
    """bf16 and f16 above 16 rows over GPTQ words take the wgmma kernels at
    every group size (desc_act too: the wrapper gathers x; the fused RMS-norm
    prologue's calls route alike), and so does K6's forward over kb32l words
    (``kb32l_route``) and K10 over kb32l words (``t_route``,
    ``w4a16_kb32l_gemm_t_wgmma``); f32 the SIMT kernels; a K or N TMA
    cannot address goes to the mma.sync kernel by shape."""
    for gs in (16, 32, 128, 100, 12, 6, 4096):
        assert gemm.route(dtype, m, gs, k=4096, n=11008) == "wgmma"
        assert gemm.route(dtype, m, gs) == "wgmma"
        assert gemm.kb32l_route(dtype, m, gs, k=4096, n=4096) == "wgmma"
        assert gemm.route(torch.float32, m, gs, k=4096, n=4096) == "simt"
    assert gemm.t_route(dtype, m, k=11008, n=4096) == "wgmma"
    assert gemm.t_route(dtype, m, k=4096, n=4096, layout="kb32l") == "wgmma"
    assert gemm.t_route(torch.float32, m, k=4096, n=4096) == "simt"
    # TMA's 16-byte rows: K % 8 for x, N % 8 for g and scales, N % 16 for zeros
    for k, n in ((4100, 4096), (4096, 4104), (4096, 4100), (20, 16)):
        assert not gemm.wgmma_shape_ok(k, n)
        assert gemm.route(dtype, m, 128, k=k, n=n) == "mma"
        assert gemm.t_route(dtype, m, k=k, n=n) == "mma"
    assert gemm.wgmma_shape_ok(4104, 4112) and gemm.wgmma_shape_ok(16, 16)


def test_kernel_names_each_tile_kernel():
    """``kernel=`` and ``forced_kernel`` name the mma.sync kernel, the
    wgmma kernel or the SIMT one whatever the route (chip_smoke.py times them
    side by side); below 16 rows the routes keep the GEMVs."""
    for kernel in ("wgmma", "mma", "simt"):
        assert gemm.tile_kernel(torch.bfloat16, kernel) == kernel
        assert gemm.route(torch.bfloat16, 128, 128, kernel) == kernel
        assert gemm.t_route(torch.float16, 2048, kernel) == kernel
        with gemm.forced_kernel(kernel):
            assert gemm.route(torch.bfloat16, 1, 128, gemm._forced[0]) == kernel
            assert gemm.t_route(torch.bfloat16, 4, gemm._t_kernel(None)) == kernel
    assert gemm.route(torch.bfloat16, 16, 128, k=4096, n=4096) == "gemv"
    assert gemm.t_route(torch.bfloat16, 16, k=4096, n=4096) == "gemv"
    with pytest.raises(ValueError, match="kernel must be"):
        gemm.tile_kernel(torch.bfloat16, "tma")


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers answer with the plain versions whatever kernel
    is named: the wgmma code is never reached without a card."""
    t = _packed(5, 4, 128, 64, 32, True)
    _, tl = _layers(t, 4, 128, 64, 32)
    x = torch.randn((20, 128))
    g = torch.randn((20, 64))
    for kernel in ("wgmma", None):
        y = gemm.wna16_matmul(x, tl.qweight, tl.scales, tl.zeros, tl.kperm, tl.bias, 32, 4,
                              kernel=kernel)
        torch.testing.assert_close(y, gemm.wna16_matmul_ref(x, tl.qweight, tl.scales, tl.zeros,
                                                            tl.kperm, tl.bias, 32, 4),
                                   rtol=0, atol=0)
        dx = gemm.wna16_matmul_t(g, tl.qweight, tl.scales, tl.zeros, tl.kperm, 32, 4,
                                 kernel=kernel)
        torch.testing.assert_close(dx, gemm.wna16_matmul_t_ref(g, tl.qweight, tl.scales,
                                                                tl.zeros, tl.kperm, 32, 4),
                                   rtol=0, atol=0)


def _layers(t, bits, k, n, gs):
    """The same packed layer in both packages (the port's in f32 on the CPU),
    a ``None`` bias kept as none."""
    fields = dict(bits=bits, group_size=gs, in_features=k, out_features=n)
    jl = jqlin.from_packed(jqlin.PackedQuantLinear(
        **{name: None if v is None else jnp.asarray(v) for name, v in t.items()}, **fields))
    tl = tqlin.from_packed(tqlin.PackedQuantLinear(**t, **fields), device="cpu",
                           dtype=torch.float32)
    return jl, tl


def _weight(tl) -> torch.Tensor:
    """``s[g(k), n] * (q - z[g(k), n])`` in f32 over the sorted rows, each row
    its own group (a partial last group included): exact, as in the kernels."""
    k = tl.in_features
    gs = k if tl.group_size == -1 else tl.group_size
    grp = torch.arange(k) // gs
    q = tqlin.codes(tl).float()
    return tl.scales.float()[grp] * (q - tl.zeros.float()[grp])


def _tile_sums(a: torch.Tensor, bhi: torch.Tensor, blo: torch.Tensor,
               plan: dict) -> torch.Tensor:
    """``a [M, R] @ (bhi + blo) [R, C]`` as the kernels sum it: f32 over
    64-row tiles of the reduction, each tile's hi product then its lo, each
    split's run of ``per`` tiles from zero, the partials then added in split
    order (one split: the tiles in order)."""
    r = a.shape[1]
    out = torch.zeros((a.shape[0], bhi.shape[1]))
    for z in range(plan["splits"]):
        part = torch.zeros_like(out)
        for t in range(z * plan["per"], min((z + 1) * plan["per"], plan["ktiles"])):
            r0, r1 = 64 * t, min(64 * t + 64, r)
            part = part + a[:, r0:r1] @ bhi[r0:r1]
            part = part + a[:, r0:r1] @ blo[r0:r1]
        out = out + part
    return out


def _pair(w: torch.Tensor, dtype) -> tuple:
    """The weight as the pair of ``dtype`` both kernels multiply by: hi =
    round(w), lo = round(w - hi), in f32."""
    hi = w.to(dtype).float()
    return hi, (w - hi).to(dtype).float()


def _forward_emulation(x: torch.Tensor, tl, dtype, sms: int) -> torch.Tensor:
    """The wgmma forward: x gathered by kperm (the wrapper), the weight's pair,
    the plan's tile sums (each tile's hi product, then its lo), the bias, one
    rounding."""
    k, n = tl.in_features, tl.out_features
    gs = k if tl.group_size == -1 else tl.group_size
    plan = gemm.wgmma_plan(x.shape[0], k, n, gs, tl.bits, sms)
    xs = x.index_select(1, tl.kperm) if tl.kperm is not None else x
    y = _tile_sums(xs.to(dtype).float(), *_pair(_weight(tl), dtype), plan)
    if tl.bias is not None:
        y = y + tl.bias.to(dtype).float()
    return y.to(dtype)


def _t_emulation(g: torch.Tensor, tl, dtype, sms: int) -> torch.Tensor:
    """The wgmma K10: the weight's pair, as the forward's, f32 sums per
    64-column tile of N in the plan's split of N, one rounding, dx's columns
    through kperm."""
    k, n = tl.in_features, tl.out_features
    gs = k if tl.group_size == -1 else tl.group_size
    plan = gemm.wgmma_plan(g.shape[0], k, n, gs, tl.bits, sms, transpose=True)
    hi, lo = _pair(_weight(tl), dtype)
    dxs = _tile_sums(g.to(dtype).float(), hi.t(), lo.t(), plan).to(dtype)
    if tl.kperm is None:
        return dxs
    dx = torch.empty_like(dxs)
    dx[:, tl.kperm] = dxs
    return dx


# (bits, K, N, group size, desc_act, bias, M, dtype, SMs for the plan): K and N off the 64-row
# tile and the 128-column block, rest classes (words straddling groups, a partial last group),
# desc_act with a bias; SMs 132 split the reduction at these sizes, 1 leaves it whole
CASES = [
    (4, 256, 144, 128, False, False, 17, torch.bfloat16, 132),
    (4, 320, 128, 32, False, True, 70, torch.float16, 132),
    (3, 256, 160, 16, False, False, 130, torch.bfloat16, 1),
    (2, 208, 144, 16, False, False, 40, torch.bfloat16, 132),
    (8, 200, 128, -1, False, False, 65, torch.float16, 1),
    (4, 264, 128, 12, False, False, 33, torch.bfloat16, 132),
    (4, 256, 144, 100, False, True, 129, torch.bfloat16, 132),
    (8, 96, 128, 12, False, False, 20, torch.bfloat16, 1),
    (4, 240, 128, 12, True, True, 50, torch.bfloat16, 132),
    (2, 256, 128, 32, True, True, 300, torch.float16, 1),
]


@pytest.mark.parametrize("bits, k, n, gs, desc_act, bias, m, dtype, sms", CASES)
def test_forward_emulation_matches_jax_matmul_xla(bits, k, n, gs, desc_act, bias, m, dtype, sms):
    """The emulated wgmma forward against the JAX package's ``matmul_xla`` in
    f32 on the same activations (values of ``dtype``): the pair carries the
    weight to about 16 significant bits and the sums are f32, so the one
    rounding of the output to ``dtype`` is the difference: within two ulps of
    ``dtype`` at the largest output."""
    t = _packed(bits * 100 + k + n, bits, k, n, k if gs == -1 else gs, desc_act)
    if not bias:
        t["bias"] = None
    jl, tl = _layers(t, bits, k, n, gs)
    x = torch.from_numpy(np.random.default_rng(m + gs).standard_normal((m, k)).astype(
        np.float32)).to(dtype)
    got = _forward_emulation(x, tl, dtype, sms).float().numpy()
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x.float().numpy()), jl))
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * T_EPS[dtype] * np.abs(want).max())


@pytest.mark.parametrize("bits, k, n, gs, desc_act, bias, m, dtype, sms", CASES)
def test_t_emulation_matches_the_jax_vjp(bits, k, n, gs, desc_act, bias, m, dtype, sms):
    """The emulated wgmma K10 against the VJP of JAX's ``matmul_xla`` in f32
    (``jax.vjp`` with the same cotangent, values of ``dtype``): the pair
    carries the weight to about 16 significant bits, the forward's too, so the
    one rounding of dx to ``dtype`` is the difference: within two ulps of
    ``dtype`` at the largest output."""
    t = _packed(bits * 100 + k + n, bits, k, n, k if gs == -1 else gs, desc_act)
    jl, tl = _layers(t, bits, k, n, gs)
    g = torch.from_numpy(np.random.default_rng(m + gs + 1).standard_normal((m, n)).astype(
        np.float32)).to(dtype)
    _, vjp = jax.vjp(lambda xx: jqlin.matmul_xla(xx, jl), jnp.zeros((m, k), jnp.float32))
    want = np.asarray(vjp(jnp.asarray(g.float().numpy()))[0])
    got = _t_emulation(g, tl, dtype, sms).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * T_EPS[dtype] * np.abs(want).max())
