"""K1, K4 and K5: the wNa16 dequant-matmuls, ``y = x @ ((q - z) * s) (+ bias)``.

One CUDA template (``csrc/wna16_gemm.cuh``, whose header note gives the design
and the bound) is built into three libraries:

* K1 ``w4a16_gemm`` (4-bit codes, and 3-bit codes kept in nibbles) replaces the
  TPU kernels ``autogptq_tpu/ops/pallas/gemm.py:_kernel_kb32``, ``_kernel_ki32``
  and the nibble part of ``_kernel_kpair``;
* K4 ``w8a16_gemm`` (8-bit codes) replaces the planar ``_kernel`` and the
  ``koct`` variant of ``_kernel_kpair``;
* K5 ``w2a16_gemm`` (2-bit codes) replaces ``_kernel_k2i32``, ``_kernel_kquad``
  and the 2-bit class of the planar ``_kernel``.

``w4a16_matmul`` / ``w8a16_matmul`` / ``w2a16_matmul`` launch them for CUDA
tensors and run the plain versions (``*_matmul_ref``) for CPU tensors; nothing
else picks between them.

Each library holds three kernels besides its SIMT ones (``csrc/wna16_gemm.cuh``:
the split-K GEMV at M <= 16, the tile kernel above): :func:`route` sends bf16
and f16 activations at M <= 16 to the tensor-core decode GEMV
(``csrc/wna16_gemv.cuh``, entry and launch count ``<name>_gemv``, one launch
per call, its split-K combine folded into the last block, planned by
:func:`gemv_plan`; its ``ANY_GS`` instance where 16 does not divide a group
size of 16 rows or more), and below 16 rows per group to the SIMT GEMV; above
16 rows bf16 and f16 at any group size take the warp-specialized wgmma/TMA
tile kernel (``csrc/wna16_wgmma.cuh``, ``<name>_wgmma``; :func:`tile_kernel`,
planned by :func:`wgmma_plan`; x gathered by kperm once per call), or the
``mma.sync`` tile kernel (``csrc/wna16_mma.cuh``, ``<name>_mma``; its
``ANY_GS`` instance where 16 does not divide the group size, whose stage
:func:`mma_smem_bytes` sizes) where TMA cannot address the shape
(:func:`wgmma_shape_ok`); f32 activations take the SIMT kernels at any M
(launch count ``<name>``). The choice is static,
by dtype and shape; a launch that fails raises, whichever kernel it was.

K10, their backward ``dx = g @ ((q - z) * s)^T`` (``csrc/wna16_gemm_t.cuh``),
is one library, ``wna16_gemm_t``, with an entry point per storage width; it
replaces the TPU kernels ``_kernel_kb32_t``, ``_kernel_ki32_t`` and
``_kernel_kpair_t`` behind ``matmul_t_pallas``. ``w4a16_matmul_t`` /
``w8a16_matmul_t`` / ``w2a16_matmul_t`` launch it for CUDA tensors and run
``wna16_matmul_t_ref`` for CPU tensors; :func:`t_route` routes it: bf16 and
f16 cotangents of at most 16 rows to K10's decode regime
(``csrc/wna16_gemv_t.cuh``, split N, launch count ``wna16_gemm_t_gemv``,
planned by :func:`t_gemv_plan`), above 16 rows to the wgmma/TMA K10
(``wna16_gemm_t_wgmma``; over kb32l words ``w4a16_kb32l_gemm_t_wgmma``; the
mma.sync ``wna16_gemm_t_mma`` for shapes TMA cannot address), at every group
size; f32 to the SIMT kernel (``wna16_gemm_t``).

K9, the routed-expert product of MoE decode ``y[p] = x[p] @ W[sel[p]]``
(``csrc/w4a16_routed_gemm.cu``), replaces the TPU kernel
``_kernel_routed_kb32`` behind ``matmul_routed_pallas``.
``wna16_routed_matmul`` launches it for CUDA tensors and runs
``wna16_routed_matmul_ref`` for CPU tensors. :func:`routed_route` sends bf16
and f16 pairs (at most 16) to the expert-major tensor-core GEMV
(``<name>_gemv``, planned by :func:`routed_plan`: each selected expert streams
once per call; its ``ANY_GS`` instance where 16 does not divide a group size
of 16 rows or more), f32, more pairs and group sizes below 16 to the SIMT
routed kernel and its reduce.

K1's fused RMS-norm prologue (``csrc/wna16_gemm.cuh``, the ``PRENORM``
instances of its GEMVs and tile kernels, in ``w4a16_gemm`` only) replaces the
TPU prologue ``_prenorm_x`` that ``_kernel_kb32`` and ``_kernel_ki32`` run for
``matmul_pallas(prenorm=)``: ``wna16_matmul(..., prenorm=(w, eps, plus_one))``
multiplies ``rms_apply(x, w, eps, plus_one)`` by the weight. A call
:func:`prenorm_eligible` admits launches the fused instance of the kernel
:func:`route` names (launch counts ``w4a16_gemm_gemv_norm`` at M <= 16,
``w4a16_gemm_wgmma_norm`` at 17-31 rows, ``w4a16_gemm_mma_norm`` where TMA
cannot address the shape, ``w4a16_gemm_norm`` for f32; the wgmma one and the
GEMV after one launch of the rows' rstd, ``w4a16_gemm_wgmma_norm_rstd``: by
:func:`prenorm_rstd` before the wgmma kernel, by the GEMV's own entry before
the GEMV); any other call applies
:func:`rms_apply` and then the usual kernel, the JAX package's unfused branch;
a CPU tensor takes :func:`rms_apply` and the plain version.

K6, K1's function over the tile-contiguous ``kb32l`` words
(``csrc/w4a16_kb32l_gemm.cu``, address in ``csrc/kb32l_tile.cuh``), replaces
the TPU kernels ``_matmul_kb32l`` and ``_kernel_kb32l_manual``.
``w4a16_kb32l_matmul`` launches it for CUDA tensors and runs
``w4a16_kb32l_matmul_ref`` for CPU tensors; ``wna16_matmul_t`` takes the same
words for K10. It routes as K1 does (:func:`route`): the tensor-core GEMV over
the kb32l tiles at M <= 16 for bf16 and f16 (``<name>_gemv``), the cp.async
ring (``<name>``) for f32, above 16 rows the wgmma/TMA tile kernel over a 3-D
tensor map of the tiles (``<name>_wgmma``, :func:`kb32l_word_map`; the
mma.sync one, ``<name>_mma``, where TMA cannot address the shape). K10 over
kb32l words takes the wgmma/TMA K10 over the same map with K10's box above 16
rows (``w4a16_kb32l_gemm_t_wgmma``, :func:`t_route`).

Weight layout (see ``quantlinear.from_packed``), with ``P = 32 / bits`` codes
per word: ``qweight`` int32 [K/P, N] GPTQ words of the group-sorted rows,
``scales`` fp16 [G, N], ``zeros`` uint8 [G, N] effective zero points,
``kperm`` int64 [K] or None (desc_act: sorted row k reads ``x[..., kperm[k]]``).
The kb32l layout (``quantlinear.kb32l_pack``) keeps the 4-bit words of K rows
padded to ``KB32L_KB`` and columns padded to ``KB32L_BN`` as tiles
``qweight`` int32 [N_pad/128 * K_pad/256, 32, 128], column tile first, with
``scales`` and ``zeros`` [K_pad/gs, N_pad] zero on the padding.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional

import torch

from . import build

KERNEL_NAMES = {4: "w4a16_gemm", 8: "w8a16_gemm", 2: "w2a16_gemm"}   # storage bits -> kernel
T_KERNEL = "wna16_gemm_t"      # K10's library and launch-count key
T_ENTRIES = {4: "w4a16_gemm_t", 8: "w8a16_gemm_t", 2: "w2a16_gemm_t"}   # storage bits -> entry
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
DECODE_MAX_M = 16       # rows at or below this take the split-K GEMV kernel
DECODE_THREADS = 128    # decode block size, 4 output columns per thread
MAX_KCHUNK = 512        # K rows per split: bounds the shared x stage at 16 * 512 * 4 B
MMA_SUFFIX = "_mma"     # entry point and launch-count key of a library's tensor-core kernel
MMA_DTYPES = (torch.float16, torch.bfloat16)
MMA_K = 16              # depth of one mma.sync step (16 | gs: no step spans two groups)
MMA_FW_ROWS = 64        # K rows of a tensor-core forward stage (csrc/wna16_mma.cuh: FW_BK)
MMA_T_ROWS = 128        # K rows of a tensor-core K10 block (MMA_BN)
MMA_SMEM_LIMIT = 226 * 1024   # dynamic shared memory a tile-kernel block may take (csrc)
GEMV_SUFFIX = "_gemv"   # entry point and launch-count key of a library's tensor-core GEMV
GEMV_BN = 64            # output columns per GEMV block (4 warps of 16)
GEMV_STAGES = 4         # its cp.async ring: 3 stages in flight while one is consumed
GEMV_STAGE_WORDS = 16   # word rows per stage (512 / bits K rows: 4 KB of words)
GEMV_BLOCKS_PER_SM = 4  # the plan's aim, in one wave
GEMV_MAX_SPLITS = 32    # partials the last block adds, at most
GEMV_WS_SHARE = 0.25    # f32 partials at most this share of the weight's bytes
GEMV_X_SMEM = 32768     # bytes of a block's staged x [8 or 16, K chunk] the plan aims under
GEMV_SMEM_LIMIT = 200 * 1024   # dynamic shared memory a GEMV block may take (csrc)
T_GEMV_WORD_ROWS = 8    # K10's decode regime: word rows (8 * P output K rows) per block
T_GEMV_BN = 128         # its N (the reduction) per stage
NORM_SUFFIX = "_norm"   # entry point and launch-count key of a kernel's fused RMS-norm prologue
PRENORM_MAX_M = 32      # the fused prologue takes fewer rows than this (the JAX kernel's assert)
WGMMA_SUFFIX = "_wgmma"  # entry point and launch-count key of a library's wgmma/TMA tile kernel
WGMMA_BK = 64           # reduction rows per stage (csrc/wna16_wgmma.cuh: WG_BK)
WGMMA_BN = 128          # output columns per block (WG_BN; K10: K rows)
WGMMA_MAX_STAGES = 8    # its TMA ring (WG_MAX_STAGES)
WGMMA_BTILES = 3        # dequantized B tile pairs (hi, lo) in rotation (WG_BTILES)
WGMMA_MAX_SPLITS = 16   # reduction splits the plan considers
WGMMA_SPLIT_STEPS = 4   # a block's fixed cost in tile steps: ring fill, partials, combine
WGMMA_ENCODE_ERROR = 100000   # an entry's code above this: cuTensorMapEncodeTiled failed
WGMMA_NW_BYTES = WGMMA_BK * 4  # the prologue's norm weights per stage, room for f32 (WG_NW_BYTES)
RSTD_KERNEL = "w4a16_gemm_wgmma_norm_rstd"   # entry and launch-count key of that prologue's rstd


KB32L_KERNEL = "w4a16_kb32l_gemm"   # K6's library and launch-count key
KB32L_T_ENTRY = "w4a16_kb32l_gemm_t"  # K10's entry over kb32l words (library T_KERNEL)
KB32L_T_WGMMA = KB32L_T_ENTRY + WGMMA_SUFFIX   # its wgmma/TMA entry and launch-count key
KB32L_KB = 256          # K rows per tile (csrc/kb32l_tile.cuh)
KB32L_BN = 128          # columns per tile
KB32L_NBUF = 4          # K6's ring of shared-memory stages (f32 activations)
KB32L_X_SMEM = 32768    # bytes of f32 x a K6 ring block may stage: bounds its K run
ROUTED_GEMV_MAX_P = 16  # pairs the routed GEMV takes: its block's MMA operand holds 16 rows


def unpack_words(qweight: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 [K/P, N] words -> int32 codes [K, N] (row P*r+j in bits
    ``bits*j .. bits*j + bits - 1``), for bits in {2, 4, 8}."""
    shifts = torch.arange(0, 32, bits, dtype=torch.int32, device=qweight.device)
    codes = (qweight.unsqueeze(1) >> shifts[None, :, None]) & ((1 << bits) - 1)
    return codes.reshape(-1, qweight.shape[1])


def dequantize_codes(codes: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                     group_size: int, dtype=torch.float32) -> torch.Tensor:
    """Integer codes [K, N] -> ``q * s - s * z`` per group, in f32 then
    ``dtype`` (the JAX ``dequantize_xla`` arithmetic; every product is exact,
    so the one rounding is that of the subtraction)."""
    k, n = codes.shape
    g = scales.shape[0]
    gs = k if group_size == -1 else group_size
    s = scales.float()
    sz = s * zeros.float()
    q = codes.float()
    if k == g * gs:
        w = (q.view(g, gs, n) * s[:, None, :] - sz[:, None, :]).view(k, n)
    else:
        gi = (torch.arange(k, device=codes.device) // gs).clamp(max=g - 1)
        w = q * s[gi] - sz[gi]
    return w.to(dtype)


def wna16_matmul_ref(x2d: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                     zeros: torch.Tensor, kperm: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], group_size: int, bits: int) -> torch.Tensor:
    """Plain version of K1/K4/K5: unpack, f32 dequantized weight, f32 product,
    one cast."""
    if kperm is not None:
        x2d = x2d.index_select(1, kperm)
    w = dequantize_codes(unpack_words(qweight, bits), scales, zeros, group_size)
    y = x2d.float() @ w
    if bias is not None:
        y = y + bias.float()
    return y.to(x2d.dtype)


def rms_apply(x: torch.Tensor, w: torch.Tensor, eps: float, plus_one: bool) -> torch.Tensor:
    """The unfused RMS norm of a prenorm request (the JAX ``rms_apply``,
    ``autogptq_tpu/ops/pallas/gemm.py:1583``): f32 statistics over the last
    axis, ``1 + w`` when ``plus_one``, one cast to ``x``'s dtype; the same
    operations as ``models.arch.rms_norm``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    wf = w.float()
    if plus_one:
        wf = 1.0 + wf
    return (xf * torch.rsqrt(var + eps) * wf).to(x.dtype)


def prenorm_eligible(m: int, k: int, group_size: int, bits: int,
                     kperm: Optional[torch.Tensor] = None, layout: str = "gptq",
                     norm_len: Optional[int] = None) -> bool:
    """Whether a product of ``m`` rows takes K1's fused RMS-norm prologue on
    the card: the JAX rule of ``matmul_pallas`` (``gemm.py:1612-1620``: a
    kb32 or ki32 layer, no kperm, fewer than 32 rows, a norm weight of K) with
    its layout choice (``quantlinear.from_packed``, ``quantlinear.py:312-341``:
    4-bit storage, so 3- and 4-bit codes, a group size that is a multiple of
    32 and divides K, K % 8 == 0) in the port's terms; kb32l layers are not
    eligible. ``bits`` is the code width or the storage width. (Where the JAX
    kb32 layout pads K to 1024 it unfuses too; the port's words are never
    padded, so that case has no counterpart.)"""
    gs = k if group_size == -1 else group_size
    return (STORAGE_BITS.get(bits) == 4 and gs > 0 and gs % 32 == 0 and k % gs == 0
            and k % 8 == 0 and kperm is None and layout != "kb32l" and m < PRENORM_MAX_M
            and (k if norm_len is None else norm_len) == k)


def wgmma_shape_ok(k: int, n: int) -> bool:
    """Whether TMA can address the operands of a ``[K/P, N]`` layer: 16-byte
    row strides for x ``[M, K]`` (K % 8), K10's g ``[M, N]`` and the fp16
    scales (N % 8) and the uint8 zeros (N % 16); every Llama and Mixtral
    width passes."""
    return k % 8 == 0 and n % 16 == 0


def tile_kernel(dtype: torch.dtype, kernel: Optional[str] = None, k: Optional[int] = None,
                n: Optional[int] = None) -> str:
    """The tile kernel a product in ``dtype`` takes on the card: K1/K4/K5's
    and K6's above 16 rows (:func:`route` and :func:`kb32l_route` decide
    below), K10's above 16 rows (:func:`t_route`). For bf16 and f16
    ``"wgmma"``, the warp-specialized wgmma/TMA kernel
    (``csrc/wna16_wgmma.cuh``), at every group size, over GPTQ words and
    kb32l words, with the fused RMS-norm prologue too; ``"mma"``,
    the ``mma.sync`` tile kernel (``csrc/wna16_mma.cuh``), for a ``K`` or
    ``N`` TMA cannot address (:func:`wgmma_shape_ok`; decided from the
    shapes, never by trying); ``"simt"``, the SIMT kernels, for f32 (the f32
    model path and ``quantize``'s re-forward). Without ``k`` and ``n`` the
    shape is taken as aligned. ``kernel`` ("wgmma", "mma" or "simt") names
    one instead, to time them on the same operands; a tensor-core kernel
    raises for operands it does not take."""
    if kernel is not None:
        if kernel not in ("wgmma", "mma", "simt"):
            raise ValueError(f"kernel must be 'wgmma', 'mma', 'simt' or None, got {kernel!r}")
        return kernel
    if dtype not in MMA_DTYPES:
        return "simt"
    if k is not None and n is not None and not wgmma_shape_ok(k, n):
        return "mma"
    return "wgmma"


def t_route(dtype: torch.dtype, m: int, kernel: Optional[str] = None, k: Optional[int] = None,
            n: Optional[int] = None, layout: str = "gptq") -> str:
    """The kernel K10 takes on the card for a cotangent of ``m`` rows in
    ``dtype``: ``"gemv"``, its split-N decode regime
    (``csrc/wna16_gemv_t.cuh``, :func:`t_gemv_plan`), for bf16 and f16 at
    ``m <= 16`` and any group size; above 16 rows :func:`tile_kernel`'s
    choice for the layer's ``k``, ``n`` and ``layout`` (``"wgmma"`` for bf16
    and f16 where TMA can address the operands, ``"mma"`` for other shapes,
    ``"simt"`` for f32, which takes the SIMT K10 at every ``m``). Over GPTQ
    words TMA needs :func:`wgmma_shape_ok`; over kb32l words the scales and
    zeros are N_pad wide and the words a 3-D map of whole tiles
    (:func:`kb32l_word_map`), so only K % 8 (the pairs of dx's columns the
    epilogue stores; kb32l's group sizes make it hold) and N % 8 (16-byte rows
    of g ``[M, N]``) are left. ``kernel`` ("gemv", "wgmma", "mma" or "simt")
    names one instead; the decode regime raises above 16 rows."""
    _check_kernel(kernel)
    if kernel is not None:
        return kernel
    if dtype in MMA_DTYPES and m <= DECODE_MAX_M:
        return "gemv"
    if layout == "kb32l":
        chosen = tile_kernel(dtype)
        if chosen == "wgmma" and k is not None and n is not None and (k % 8 or n % 8):
            return "mma"
        return chosen
    return tile_kernel(dtype, None, k, n)


def mma_stage_groups(gs: int, rows: int) -> int:
    """Group rows of scales and zeros a tensor-core stage holds for ``rows``
    consecutive K rows at group size ``gs`` (the ``ANY_GS`` instances): every
    group such rows can touch at any offset, ``(rows - 1) // gs + 2`` (33 for
    a 64-row forward tile at gs 2). ``csrc/wna16_mma.cuh:stage_groups`` is the
    same rule."""
    return (rows - 1) // gs + 2


def mma_smem_bytes(bits: int, gs: int, transpose: bool = False) -> int:
    """Dynamic shared memory of one tensor-core tile-kernel block for
    ``bits``-bit storage (2, 4 or 8) at group size ``gs``: the forward's 4
    stages of an x tile [128][72] halves, ``64 / P`` word rows of 128 words and
    the scales and zeros of its group rows; with ``transpose`` K10's 4 stages
    of a g tile [128][72], ``128 / P`` word rows of 64 words and its group
    rows, plus two hi/lo pairs of B tiles [128][72]. The group rows are fixed
    where 16 divides ``gs`` (4 and 8: the tiles hold whole 16-row steps of one
    group each), else :func:`mma_stage_groups`. Raises NotImplementedError
    above :data:`MMA_SMEM_LIMIT` (K10 at gs 1): the wrappers never launch
    another kernel instead."""
    p = 32 // bits
    x_tile = 128 * 72 * 2
    if transpose:
        ng = 8 if gs % MMA_K == 0 else mma_stage_groups(gs, MMA_T_ROWS)
        stage = x_tile + (MMA_T_ROWS // p) * 64 * 4 + ng * 64 * 3
        smem = 4 * (-(-stage // 16) * 16) + 2 * 2 * x_tile
    else:
        ng = 4 if gs % MMA_K == 0 else mma_stage_groups(gs, MMA_FW_ROWS)
        stage = x_tile + (MMA_FW_ROWS // p) * 128 * 4 + ng * 128 * 3
        smem = 4 * (-(-stage // 16) * 16)
    if smem > MMA_SMEM_LIMIT:
        raise NotImplementedError(
            f"the tensor-core {'K10' if transpose else 'tile kernel'} at group size {gs} stages "
            f"{ng} groups per block: {smem} B of shared memory, above {MMA_SMEM_LIMIT}")
    return smem


def _up(v: int, a: int) -> int:
    return -(-v // a) * a


def wgmma_stage_bytes(bits: int, bm: int, ng: int, transpose: bool = False,
                      prenorm: bool = False) -> int:
    """Bytes of one stage of the wgmma kernels' ring for ``bits``-bit storage
    (2, 4 or 8): the activation tile ``[bm][64]`` (x, or K10's g) in 128-byte
    swizzled rows, the words of 64 reduction rows (K10: of its 128 K rows),
    ``ng`` group rows of fp16 scales and uint8 zeros over 128 columns (K10:
    64), each region 128-byte aligned, the forward's 64-byte table of group
    rows, with ``prenorm`` the tile's 64 norm weights (:data:`WGMMA_NW_BYTES`,
    room for f32, 128-aligned), the whole 1024-aligned
    (``csrc/wna16_wgmma.cuh:WgStage``)."""
    sw = 64 if transpose else WGMMA_BN
    size = bm * 128 + 1024 * bits + _up(ng * sw * 2, 128) + _up(ng * sw, 128)
    size = _up(size + (0 if transpose else 64), 128)
    return _up(size + (WGMMA_NW_BYTES if prenorm else 0), 1024)


def wgmma_plan(m: int, k: int, n: int, group_size: int, bits: int, sms: int,
               transpose: bool = False, layout: str = "gptq", prenorm: bool = False) -> dict:
    """The wgmma/TMA tile kernel's launch for ``m`` rows of a ``[K/P, N]``
    layer (``transpose``: K10, ``dx [m, K] = g [m, N] @ W^T``), from shapes
    alone; ``bits`` is the code width (3 rides in nibbles). ``layout="kb32l"``
    (K6's forward, or K10 over kb32l words with ``transpose``) reads the words
    through :func:`kb32l_word_map`, whose box holds the same words as GPTQ's,
    so only ``words_map`` is added; ``prenorm``
    (K1's fused prologue, ``m`` < 32) adds the norm weights' slot to each
    stage and their box.

    * ``bm``: 256 above 128 rows (two consumer warpgroups of 128 rows, so
      each dequantized weight tile pair feeds 256 rows; 128 where two stages
      of 256 rows do not fit, 8-bit codes at group size 1), 128 up to 128 rows
      (two of 64), 64 up to 64 rows (the two split the 128 columns); ``bn``
      128 output columns (K10: K rows); the reduction (K; K10: N) in
      ``ktiles`` tiles of 64.
    * ``stages``: as many as fit beside the B tiles in
      :data:`MMA_SMEM_LIMIT`, at most :data:`WGMMA_MAX_STAGES`;
      NotImplementedError below 2.
    * ``splits`` runs of ``per`` reduction tiles, none empty, where the output
      has fewer ``tiles`` than ``sms``: at least ``sms`` blocks or one tile per
      split, and among those the split with the fewest tile steps on the
      busiest SM (waves of one block per SM times ``per`` plus
      :data:`WGMMA_SPLIT_STEPS`: 160 blocks on 132 SMs take two waves, as 256
      do), at most :data:`WGMMA_MAX_SPLITS` unless more are needed to fill the
      card. Their f32 partials ``[splits, m, out columns]``
      (``workspace_bytes``) are added in split order by the block drawing the
      last ticket.
    * ``boxes``: each TMA box as (inner elements, rows, element bytes), the
      norm weights' (``prenorm``) at the most bytes (f32) an element takes."""
    if layout not in ("gptq", "kb32l"):
        raise ValueError(f"the wgmma kernels read GPTQ or kb32l words, got layout={layout!r}")
    if prenorm and (transpose or layout != "gptq" or m >= PRENORM_MAX_M):
        raise ValueError(f"the fused prologue is a forward over GPTQ words at fewer than "
                         f"{PRENORM_MAX_M} rows, got m={m}, transpose={transpose}, "
                         f"layout={layout!r}")
    plan = dict(_wgmma_plan(m, k, n, group_size, bits, sms, transpose, prenorm))
    if layout == "kb32l":
        plan["words_map"] = kb32l_word_map(k, n, transpose)
    return plan


@functools.lru_cache(maxsize=None)
def _wgmma_plan(m: int, k: int, n: int, group_size: int, bits: int, sms: int,
                transpose: bool, prenorm: bool = False) -> dict:
    sb = storage_bits(bits)
    p = 32 // sb
    gs = k if group_size == -1 else group_size
    red, cols = (n, k) if transpose else (k, n)
    ng = mma_stage_groups(gs, WGMMA_BN if transpose else WGMMA_BK)
    fixed = 1024 + WGMMA_BTILES * 2 * WGMMA_BN * WGMMA_BK * 2   # slack, the hi/lo B tiles
    for bm in ((64,) if m <= 64 else (128,) if m <= 128 else (256, 128)):
        stage = wgmma_stage_bytes(sb, bm, ng, transpose, prenorm)   # the tallest two stages fit
        stages = min(WGMMA_MAX_STAGES, (MMA_SMEM_LIMIT - fixed) // stage)
        if stages >= 2:
            break
    if stages < 2 or ng > 255:
        raise NotImplementedError(
            f"the wgmma {'K10' if transpose else 'tile kernel'} at group size {gs} stages {ng} "
            f"groups: two stages of {stage} B and the B tiles exceed {MMA_SMEM_LIMIT} B")
    ktiles = -(-red // WGMMA_BK)
    col_blocks, row_blocks = -(-cols // WGMMA_BN), -(-m // bm)
    if row_blocks > 65535:
        raise NotImplementedError(f"the wgmma kernels take at most {65535 * bm} rows, got {m}")
    tiles = col_blocks * row_blocks
    splits = 1
    if tiles < sms:   # the split with the fewest tile steps on the busiest SM: waves x run
        low, best = -(-sms // tiles), None
        for s in range(min(low, ktiles), ktiles + 1):
            if s > WGMMA_MAX_SPLITS and best is not None:
                break
            per = -(-ktiles // s)
            s = -(-ktiles // per)                  # no empty split
            if s < low and s != ktiles:
                continue
            cost = -(-tiles * s // sms) * (per + WGMMA_SPLIT_STEPS)
            if best is None or cost < best[0]:
                best = (cost, s)
        splits = best[1]
    per = -(-ktiles // splits)
    sw = 64 if transpose else WGMMA_BN
    boxes = {"a": (WGMMA_BK, bm, 2), "scales": (sw, ng, 2), "zeros": (sw, ng, 1),
             "words": (64, WGMMA_BN // p, 4) if transpose else (WGMMA_BN, WGMMA_BK // p, 4)}
    if prenorm:
        boxes["norm"] = (WGMMA_BK, 1, WGMMA_NW_BYTES // WGMMA_BK)
    return dict(bm=bm, bn=WGMMA_BN, warpgroups_n=2 if bm == 64 else 1, stages=stages,
                stage_groups=ng, stage_bytes=stage,
                smem_bytes=fixed + stages * stage, ktiles=ktiles, col_blocks=col_blocks,
                row_blocks=row_blocks, tiles=tiles, splits=splits, per=per,
                blocks=tiles * splits, boxes=boxes,
                workspace_bytes=4 * splits * m * cols if splits > 1 else 0)


_forced = [None]    # the kernel every wrapper call takes inside forced_kernel


@contextlib.contextmanager
def forced_kernel(kernel: Optional[str]):
    """Inside, every :func:`wna16_matmul`, :func:`w4a16_kb32l_matmul`,
    :func:`wna16_routed_matmul` and :func:`wna16_matmul_t` (K10, also over
    kb32l words) call without its own ``kernel`` takes ``kernel`` ("gemv",
    "mma", "simt" or None; K10 takes "gemv", its decode regime, too), so that
    a whole path (a model's ``generate``, a training step) can be run through
    another kernel on the same weights, as chip_smoke.py does to hold the
    tensor-core kernels against the SIMT kernels and K6's ring."""
    _check_kernel(kernel)
    before = _forced[0]
    _forced[0] = kernel
    try:
        yield
    finally:
        _forced[0] = before


def _check_kernel(kernel: Optional[str]) -> None:
    if kernel not in (None, "gemv", "wgmma", "mma", "simt"):
        raise ValueError(f"kernel must be 'gemv', 'wgmma', 'mma', 'simt' or None, got {kernel!r}")


def route(dtype: torch.dtype, m: int, gs: int, kernel: Optional[str] = None,
          k: Optional[int] = None, n: Optional[int] = None) -> str:
    """The kernel K1/K4/K5's forward takes on the card for ``m`` rows with
    group size ``gs`` (in rows: ``K`` for one group): at ``m <= 16``
    ``"gemv"``, the tensor-core decode GEMV, for bf16 and f16 at a group size
    of 16 rows or more (its ``ANY_GS`` instance where 16 does not divide
    ``gs``), and ``"simt"``, the SIMT GEMV, for f32 and for group sizes below
    16 (there every 16-row step spans groups, and the GEMV's exact masked MMA
    sets, one per group, were slower than the SIMT GEMV on the H100:
    PERF.md); above 16 rows :func:`tile_kernel`'s choice for the layer's
    ``k`` and ``n`` (``"wgmma"`` for bf16 and f16 at any group size, desc_act
    and the fused prologue included; ``"mma"`` for shapes TMA cannot address;
    ``"simt"`` for f32). ``kernel`` names one instead (the tensor-core
    kernels raise for operands they do not take). K6 takes
    :func:`kb32l_route` (its "simt" at ``m <= 16`` is its cp.async ring); K10
    :func:`t_route`."""
    _check_kernel(kernel)
    if kernel is not None:
        return kernel
    if m <= DECODE_MAX_M:
        return "gemv" if dtype in MMA_DTYPES and gs >= MMA_K else "simt"
    return tile_kernel(dtype, None, k, n)


def kb32l_route(dtype: torch.dtype, m: int, gs: int, kernel: Optional[str] = None,
                k: Optional[int] = None, n: Optional[int] = None) -> str:
    """:func:`route` for K6's forward over kb32l words of ``n`` columns: TMA
    reads the words, scales and zeros at the padded width (a multiple of
    128), so only K % 8 and the epilogue's column pairs (N % 4, as K1's words
    need) keep a shape off the wgmma kernel."""
    chosen = route(dtype, m, gs, kernel, k, None if n is None else -(-n // KB32L_BN) * KB32L_BN)
    if kernel is None and chosen == "wgmma" and n is not None and n % 4:
        return "mma"
    return chosen


STORAGE_BITS = {2: 2, 3: 4, 4: 4, 8: 8}     # bits per weight of the runtime words


def storage_bits(bits: int) -> int:
    """Bits a code takes in the words: 3-bit codes ride in nibbles."""
    return STORAGE_BITS[bits]


def gemv_plan(k: int, n: int, m: int, group_size: int, bits: int, sms: int) -> dict:
    """The tensor-core GEMV's launch, from shapes alone (no value on the card,
    so the grid is fixed for a given layer and row count): column tiles of
    ``GEMV_BN``; K in ``splits`` chunks of ``kc`` rows, a whole number of
    stages and, where 16 divides the group size and that fits the staged x, of
    groups (the ``ANY_GS`` instance folds a group a split cuts in each of its
    splits, so its splits are whole stages alone); blocks for at most
    about ``GEMV_BLOCKS_PER_SM`` per SM, at most ``GEMV_MAX_SPLITS`` splits,
    and f32 partials ``[splits, m, n]`` within ``GEMV_WS_SHARE`` of the
    weight's bytes (so they stay in L2). ``bits`` is the code width (3 rides in
    nibbles). Also the stage's K rows and group rows (``bk / 16`` where 16
    divides the group size, else :func:`mma_stage_groups` of the stage, the
    ``ANY_GS`` instance's), the blocks, the shared-memory, weight and
    workspace bytes; NotImplementedError above :data:`GEMV_SMEM_LIMIT` (2-bit
    codes at group size 1), where the wrappers launch nothing. K6 takes the
    plan of its true K and N: the kb32l tiles' padding is never read."""
    return dict(_gemv_plan(k, n, m, group_size, bits, sms))


def routed_plan(k: int, n: int, p: int, e: int, group_size: int, bits: int, sms: int) -> dict:
    """K9's tensor-core GEMV launch for ``p`` pairs over a stack of ``e``
    experts, from shapes alone (never from ``sel``'s values, so the grid is
    the same for any selection): :func:`gemv_plan`'s column tiles and K
    splits, sized for ``min(p, e)`` expert slices (at most that many distinct
    experts: their blocks and the bytes they stream), over a grid of
    ``(col_blocks, splits, min(p, e))`` (``blocks``; a slice beyond the
    distinct experts exits at once); an x stage of ``p`` rows; f32 partials
    ``[splits, p, n]`` (one row per pair) and ``min(p, e) * col_blocks``
    ticket counters."""
    if not 0 < p <= ROUTED_GEMV_MAX_P:
        raise ValueError(f"the routed GEMV takes 1 to {ROUTED_GEMV_MAX_P} pairs, got {p}")
    slices = min(p, e)
    plan = dict(_gemv_plan(k, n, p, group_size, bits, sms, slices, p))
    plan.update(slices=slices, counters=slices * plan["col_blocks"])
    return plan


@functools.lru_cache(maxsize=None)
def _gemv_plan(k: int, n: int, m: int, group_size: int, bits: int, sms: int,
               active: int = 1, xrows: Optional[int] = None) -> dict:
    sb = storage_bits(bits)
    gs = k if group_size == -1 else group_size
    bk = GEMV_STAGE_WORDS * 32 // sb                     # K rows per stage
    mt = 8 if m <= 8 else 16
    col_blocks = -(-n // GEMV_BN)
    weight_bytes = active * (k * n * sb // 8 + 3 * -(-k // gs) * n)
    kc_max = max(bk, GEMV_X_SMEM // (2 * mt) // bk * bk)
    unit = math.lcm(gs, bk)
    if unit > kc_max or gs % MMA_K:  # a group longer than the x stage, or the ANY_GS instance
        unit = bk                    # (a group cut by a split folds in each): whole stages
    cap = max(1, int(GEMV_WS_SHARE * weight_bytes // (4 * m * n)))
    want = max(1, min(GEMV_BLOCKS_PER_SM * sms // (col_blocks * active), GEMV_MAX_SPLITS, cap))
    kc = -(-k // want // unit) * unit
    kc = min(kc, max(unit, kc_max // unit * unit))
    splits = -(-k // kc)
    if splits > min(cap, GEMV_MAX_SPLITS):   # the x stage grows rather than the workspace
        kc = -(-k // min(cap, GEMV_MAX_SPLITS) // unit) * unit
        splits = -(-k // kc)
    groups = bk // 16 if gs % MMA_K == 0 else mma_stage_groups(gs, bk)
    stage_bytes = GEMV_STAGE_WORDS * (GEMV_BN + 16) * 4 + groups * GEMV_BN * 3
    if gs % MMA_K:                  # ANY_GS: each K row's group row, one byte per row
        stage_bytes += bk
    stage_bytes = -(-stage_bytes // 16) * 16
    smem = GEMV_STAGES * stage_bytes + (xrows or mt) * (kc + 8) * 2
    if smem > GEMV_SMEM_LIMIT:
        raise NotImplementedError(f"the decode GEMV's plan for K={k}, N={n}, M={m}, group size "
                                  f"{gs} needs {smem} B of shared memory per block")
    return dict(kc=kc, splits=splits, col_blocks=col_blocks, blocks=col_blocks * splits * active,
                stage_k=bk, stage_groups=groups, stage_word_bytes=GEMV_STAGE_WORDS * GEMV_BN * 4,
                smem_bytes=smem, weight_bytes=weight_bytes,
                workspace_bytes=4 * m * n * splits if splits > 1 else 0)


def split_k(k: int, n: int, gs: int, sms: int, pack: int = 8) -> tuple[int, int]:
    """(K rows per split, number of splits) for the decode kernel: enough
    blocks for about two per SM, whole groups per split where a group fits
    and is whole words, whole words (``pack`` rows) otherwise (a rest-class
    group size, which the kernel looks up per code)."""
    col_blocks = -(-(n // 4) // DECODE_THREADS)
    want = max(1, -(-2 * sms // col_blocks))
    step = gs if gs <= MAX_KCHUNK and gs % pack == 0 else pack
    kc = -(-k // want)
    kc = -(-kc // step) * step
    kc = min(kc, MAX_KCHUNK // step * step)
    return kc, -(-k // kc)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


# the fused prologue's arguments before the stream: the norm weight, its dtype code, eps, plus_one
NORM_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int]


def _bind(name: str, entry: str, argtypes: list):
    fn = getattr(build.load(name), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib(name: str, norm: bool = False):
    """Library ``name``'s SIMT kernels ``<name>(x, kperm, qweight, scales,
    zeros, bias, out, partial, dtype, M, K, N, gs, kc, splits, stream)``;
    ``norm``: ``<name>_norm``, with :data:`NORM_ARGTYPES` before the stream."""
    tail = NORM_ARGTYPES if norm else []
    return _bind(name, name + (NORM_SUFFIX if norm else ""),
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + tail + [ctypes.c_void_p])


def _lib_mma(name: str, norm: bool = False):
    """Library ``name``'s tensor-core forward ``<name>_mma(x, kperm, qweight,
    scales, zeros, bias, out, dtype, M, K, N, gs, stream)``; ``norm``:
    ``<name>_mma_norm``."""
    tail = NORM_ARGTYPES if norm else []
    return _bind(name, name + MMA_SUFFIX + (NORM_SUFFIX if norm else ""),
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + tail + [ctypes.c_void_p])


def _lib_gemv(name: str, norm: bool = False):
    """Library ``name``'s tensor-core decode GEMV ``<name>_gemv(x, kperm,
    qweight, scales, zeros, bias, out, ws, counters, dtype, M, K, N, gs, kc,
    splits, stream)``; ``norm``: ``<name>_gemv_norm``, with room for the rows'
    rstd after the counters (it launches the rstd kernel into it, then the
    GEMV) and :data:`NORM_ARGTYPES` before the stream."""
    if norm:
        return _bind(name, name + GEMV_SUFFIX + NORM_SUFFIX, [ctypes.c_void_p] * 10
                     + [ctypes.c_int] * 7 + NORM_ARGTYPES + [ctypes.c_void_p])
    return _bind(name, name + GEMV_SUFFIX, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p])


def _lib_wgmma(name: str):
    """Library ``name``'s wgmma/TMA forward ``<name>_wgmma(x, qweight, scales,
    zeros, bias, out, ws, counters, dtype, M, K, N, gs, bm, stages, splits,
    stream)``, x already gathered by kperm."""
    return _bind(name, name + WGMMA_SUFFIX, [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                 + [ctypes.c_void_p])


def _lib_wgmma_norm():
    """K1's wgmma/TMA forward with the fused prologue ``w4a16_gemm_wgmma_norm``:
    the arguments of :func:`_lib_wgmma`'s entry with the rows' rstd after the
    counters and :data:`NORM_ARGTYPES` before the stream."""
    name = KERNEL_NAMES[4]
    return _bind(name, name + WGMMA_SUFFIX + NORM_SUFFIX, [ctypes.c_void_p] * 9
                 + [ctypes.c_int] * 8 + NORM_ARGTYPES + [ctypes.c_void_p])


def _lib_wgmma_rstd():
    """The rows' rstd of that prologue, ``w4a16_gemm_wgmma_norm_rstd(x, rstd,
    dtype, M, K, eps, stream)``."""
    name = KERNEL_NAMES[4]
    return _bind(name, RSTD_KERNEL, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p])


def prenorm_rstd(x2d: torch.Tensor, eps: float, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """``rsqrt(mean(f32(x)^2) + eps)`` of each row of ``x2d [M, K]`` over its
    full K, f32 ``[M]`` (into ``out`` where given): what the wgmma and GEMV
    prologues scale each row by (:func:`rms_apply`'s rstd; the GEMV's entry
    launches the same kernel itself). A CPU tensor takes the
    plain version; a bf16 or f16 CUDA tensor launches ``wg_rstd_kernel``
    (key ``w4a16_gemm_wgmma_norm_rstd``), anything else raises."""
    if x2d.device.type == "cpu":
        r = torch.rsqrt(x2d.float().pow(2).mean(-1) + eps)
        return r if out is None else out.copy_(r)
    m, k = x2d.shape
    if (x2d.device.type != "cuda" or x2d.dtype not in MMA_DTYPES or not x2d.is_contiguous()
            or k % 8 or x2d.data_ptr() % 16):
        raise ValueError(f"{RSTD_KERNEL} takes a contiguous, 16-byte aligned bf16/f16 [M, K] "
                         f"CUDA tensor with K % 8 == 0, got {tuple(x2d.shape)} {x2d.dtype} on "
                         f"{x2d.device}")
    if out is None:
        out = torch.empty(m, dtype=torch.float32, device=x2d.device)
    if m:
        build.check(KERNEL_NAMES[4], _lib_wgmma_rstd()(_ptr(x2d), _ptr(out),
                                                       DTYPE_CODES[x2d.dtype], m, k,
                                                       float(eps), _stream(x2d)))
        build.launches[RSTD_KERNEL] += 1
    return out


def _lib_kb32l_wgmma():
    """K6's wgmma/TMA forward ``w4a16_kb32l_gemm_wgmma(x, qweight, scales, zeros,
    bias, out, ws, counters, dtype, M, K, N, n_pad, gs, bm, stages, splits,
    stream)``, x already gathered by kperm."""
    return _bind(KB32L_KERNEL, KB32L_KERNEL + WGMMA_SUFFIX, [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def _launch_wgmma(name: str, entry, a, kperm, qweight, scales, zeros, bias, out, m, k, n, gs,
                  bits, transpose: bool = False, layout: str = "gptq",
                  norm: tuple = (), key: Optional[str] = None) -> None:
    """One launch of the wgmma/TMA tile kernel on :func:`wgmma_plan`'s plan:
    the forward (``a`` = x, ``bias``) or with ``transpose`` K10 (``a`` = g,
    ``kperm`` undone on the store), counted under ``key`` (by default
    ``<name>_wgmma``); over kb32l words with ``layout="kb32l"`` (K6's
    forward, or K10 with ``transpose``; ``n_pad``, the scales' width, before
    ``gs``), the fused prologue with ``norm`` (the :data:`NORM_ARGTYPES`
    values, counted under ``<name>_wgmma_norm``, after :func:`prenorm_rstd` of
    the rows into the workspace, counted under its own key). Raises for a
    shape TMA cannot address (:func:`wgmma_shape_ok`; over kb32l words K % 8
    and N % 4, K10's N % 8; :func:`route`, :func:`kb32l_route` and
    :func:`t_route` never send one here), a failed descriptor encode or
    launch."""
    ok = (k % 8 == 0 and n % (8 if transpose else 4) == 0 if layout == "kb32l"
          else wgmma_shape_ok(k, n))
    if not ok:
        raise NotImplementedError(f"{name}{WGMMA_SUFFIX} needs K % 8 == 0 and N % 16 == 0 "
                                  f"(kb32l: N % 4 == 0, K10 N % 8 == 0) for TMA, got K={k}, "
                                  f"N={n}")
    if a.data_ptr() % 16:          # TMA reads from a 16-byte aligned base
        a = a.clone()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = wgmma_plan(m, k, n, gs, bits, sms, transpose, layout, bool(norm))
    cols = k if transpose else n
    key = key or name + WGMMA_SUFFIX + (NORM_SUFFIX if norm else "")
    partials = plan["splits"] * m * cols if plan["splits"] > 1 else 0
    ws, counters = build.split_scratch(   # the prologue's rstd after the partials
        key, a.device, partials + (PRENORM_MAX_M if norm else 0), plan["tiles"])
    lead = (_ptr(a), _ptr(kperm)) if transpose else (_ptr(a),)
    tail = () if transpose else (_ptr(bias),)
    n_pad = (scales.shape[1],) if layout == "kb32l" else ()
    rstd = ()
    if norm:
        rstd = (_ptr(prenorm_rstd(a, norm[2], ws[partials:partials + m])),)
    code = entry(*lead, _ptr(qweight), _ptr(scales), _ptr(zeros), *tail, _ptr(out), _ptr(ws),
                 _ptr(counters), *rstd, DTYPE_CODES[a.dtype], m, k, n, *n_pad, gs, plan["bm"],
                 plan["stages"], plan["splits"], *norm, _stream(a))
    if code >= WGMMA_ENCODE_ERROR:
        raise RuntimeError(f"{key}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{code - WGMMA_ENCODE_ERROR}")
    build.check(name, code)
    build.launches[key] += 1


def gemv_blocks_per_sm(dtype: torch.dtype, m: int, bits: int, kc: int,
                       library: Optional[str] = None, group_size: int = 128) -> int:
    """How many GEMV blocks of ``bits``-bit codes (3 in nibbles) one SM holds
    at once for ``m`` rows, a K chunk of ``kc`` rows and ``group_size`` (the
    ``ANY_GS`` instance and its larger stage where 16 does not divide it; the
    CUDA occupancy calculator over the kernel's registers and shared memory);
    ``library`` names K6's or K9's GEMV (``KB32L_KERNEL``, ``ROUTED_KERNEL``)
    in place of K1/K4/K5's."""
    name = library or KERNEL_NAMES[storage_bits(bits)]
    fn = getattr(build.load(name), name + GEMV_SUFFIX + "_occupancy")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    build.check(name, fn(DTYPE_CODES[dtype], m, kc, group_size, ctypes.byref(blocks)))
    return blocks.value


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_operands(x2d, qweight, scales, zeros, kperm, bias, group_size, bits,
                    transpose: bool = False) -> int:
    """Raise on what the kernels do not take. ``x2d`` is the activation
    ``[M, K]``, or with ``transpose`` the cotangent ``g [M, N]`` of K10, whose
    K comes from ``qweight``. Returns the group size in rows."""
    dev = x2d.device
    pack = 32 // bits
    kernel = T_KERNEL if transpose else KERNEL_NAMES[bits]
    what = "g" if transpose else "x"
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.dtype not in DTYPE_CODES:
        raise ValueError(f"{what} must be a contiguous 2-D f32/f16/bf16 tensor, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    kw, n = qweight.shape
    if transpose:
        k = kw * pack
        if x2d.shape[1] != n:
            raise ValueError(f"g must be [M, N] = [M, {n}], got {tuple(x2d.shape)}")
    else:
        k = x2d.shape[1]
    gs = k if group_size == -1 else group_size
    if qweight.dtype != torch.int32 or kw * pack != k:
        raise ValueError(f"qweight must be int32 [K/{pack}, N] = [{k // pack}, N], got "
                         f"{tuple(qweight.shape)} {qweight.dtype}")
    if k % pack or n % 4 or gs <= 0:
        raise NotImplementedError(f"{kernel} needs K % {pack} == 0, N % 4 == 0 and a positive "
                                  f"group size (K={k}, N={n}, group size={gs})")
    g = -(-k // gs)
    if scales.dtype != torch.float16 or tuple(scales.shape) != (g, n):
        raise ValueError(f"scales must be fp16 [{g}, {n}], got {tuple(scales.shape)} {scales.dtype}")
    if zeros.dtype != torch.uint8 or tuple(zeros.shape) != (g, n):
        raise ValueError(f"zeros must be uint8 [{g}, {n}], got {tuple(zeros.shape)} {zeros.dtype}")
    if kperm is not None and (kperm.dtype != torch.int64 or tuple(kperm.shape) != (k,)):
        raise ValueError(f"kperm must be int64 [{k}], got {tuple(kperm.shape)} {kperm.dtype}")
    if bias is not None and (bias.dtype != x2d.dtype or tuple(bias.shape) != (n,)):
        raise ValueError(f"bias must be {x2d.dtype} [{n}], got {tuple(bias.shape)} {bias.dtype}")
    for name, t in (("qweight", qweight), ("scales", scales), ("zeros", zeros),
                    ("kperm", kperm), ("bias", bias)):
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return gs


def _check_norm(w: torch.Tensor, k: int, dev) -> None:
    if (w.dim() != 1 or w.shape[0] != k or w.dtype not in DTYPE_CODES or w.device != dev
            or not w.is_contiguous()):
        raise ValueError(f"the norm weight must be a contiguous f32/f16/bf16 [{k}] tensor on "
                         f"{dev}, got {tuple(w.shape)} {w.dtype} on {w.device}")


def wna16_matmul(x2d: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                 zeros: torch.Tensor, kperm: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], group_size: int, bits: int,
                 kernel: Optional[str] = None, prenorm: Optional[tuple] = None) -> torch.Tensor:
    """``x2d [M, K] @ W -> [M, N]`` in ``x2d``'s dtype for ``bits``-bit words
    (2, 4 or 8). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel of that width that :func:`route` names (``kernel``, or the one
    :func:`forced_kernel` sets, passed on to it), or raises.

    ``prenorm=(w, eps, plus_one)`` multiplies ``rms_apply(x2d, w, eps,
    plus_one)`` instead (the JAX ``matmul_pallas(prenorm=)``): on the card a
    call :func:`prenorm_eligible` admits launches that kernel's fused
    instance (key ``<name>[_gemv|_wgmma|_mma]_norm``), any other applies
    :func:`rms_apply` first; on the CPU :func:`rms_apply` and the plain
    version."""
    if bits not in KERNEL_NAMES:
        raise ValueError(f"words hold 2-, 4- or 8-bit codes, got bits={bits}")
    if x2d.device.type == "cpu":
        if prenorm is not None:
            x2d = rms_apply(x2d, *prenorm)
        return wna16_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size, bits)
    name = KERNEL_NAMES[bits]
    if x2d.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or, through its plain version, on the CPU; "
                         f"got a tensor on {x2d.device}")
    if prenorm is not None and not prenorm_eligible(x2d.shape[0], x2d.shape[-1], group_size,
                                                    bits, kperm, norm_len=prenorm[0].shape[-1]):
        x2d, prenorm = rms_apply(x2d, *prenorm), None     # the JAX package's unfused branch
    gs = _check_operands(x2d, qweight, scales, zeros, kperm, bias, group_size, bits)
    m, k = x2d.shape
    n = qweight.shape[1]
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    if m == 0:
        return out
    norm, suffix, extra = prenorm is not None, "", ()
    chosen = route(x2d.dtype, m, gs, kernel if kernel is not None else _forced[0], k, n)
    if norm:
        w, eps, plus_one = prenorm
        _check_norm(w, k, x2d.device)
        if chosen == "wgmma" and w.data_ptr() % 16:   # TMA reads from a 16-byte aligned base
            w = w.clone()
        suffix, extra = NORM_SUFFIX, (_ptr(w), DTYPE_CODES[w.dtype], float(eps), int(plus_one))
    if chosen == "wgmma":
        if kperm is not None:          # desc_act: x gathered once, as matmul_pallas does
            x2d = x2d.index_select(1, kperm)
        _launch_wgmma(name, _lib_wgmma_norm() if norm else _lib_wgmma(name), x2d, None, qweight,
                      scales, zeros, bias, out, m, k, n, gs, bits, norm=extra)
        return out
    if chosen == "gemv":
        sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
        plan = gemv_plan(k, n, m, gs, bits, sms)
        partials = plan["splits"] * m * n
        ws, counters = build.split_scratch(name + GEMV_SUFFIX, x2d.device,
                                           partials + (PRENORM_MAX_M if norm else 0),
                                           plan["col_blocks"])
        rstd = ()
        if norm:   # room for the rows' rstd after the partials, written by the entry's launch
            if x2d.data_ptr() % 16:    # the rstd kernel reads 16-byte runs
                x2d = x2d.clone()
            rstd = (ctypes.c_void_p(ws.data_ptr() + 4 * partials),)
        code = _lib_gemv(name, norm)(_ptr(x2d), _ptr(kperm), _ptr(qweight), _ptr(scales),
                                     _ptr(zeros), _ptr(bias), _ptr(out), _ptr(ws),
                                     _ptr(counters), *rstd, DTYPE_CODES[x2d.dtype], m, k, n, gs,
                                     plan["kc"], plan["splits"], *extra, _stream(x2d))
        build.check(name, code)
        if norm:                   # the entry launches wg_rstd_kernel, then the GEMV
            build.launches[RSTD_KERNEL] += 1
        build.launches[name + GEMV_SUFFIX + suffix] += 1
        return out
    if chosen == "mma":
        mma_smem_bytes(bits, gs)
        code = _lib_mma(name, norm)(_ptr(x2d), _ptr(kperm), _ptr(qweight), _ptr(scales),
                                    _ptr(zeros), _ptr(bias), _ptr(out), DTYPE_CODES[x2d.dtype],
                                    m, k, n, gs, *extra, _stream(x2d))
        build.check(name, code)
        build.launches[name + MMA_SUFFIX + suffix] += 1
        return out
    kc, splits, partial = 0, 0, None
    if m <= DECODE_MAX_M:
        sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
        kc, splits = split_k(k, n, gs, sms, 32 // bits)
        if splits > 1:
            partial = torch.empty((splits, m, n), dtype=torch.float32, device=x2d.device)
    code = _lib(name, norm)(_ptr(x2d), _ptr(kperm), _ptr(qweight), _ptr(scales), _ptr(zeros),
                            _ptr(bias), _ptr(out), _ptr(partial), DTYPE_CODES[x2d.dtype], m, k, n,
                            gs, kc, splits, *extra, _stream(x2d))
    build.check(name, code)
    build.launches[name + suffix] += 1
    return out


def wna16_matmul_t_ref(g2d: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                       zeros: torch.Tensor, kperm: Optional[torch.Tensor], group_size: int,
                       bits: int) -> torch.Tensor:
    """Plain version of K10: unpack, f32 dequantized weight, f32 product
    ``g @ W^T`` (the JAX ``matmul_t`` fallback, ``quantlinear.py:733-742``),
    ``kperm`` undone by a store (a permutation, so the JAX scatter-add at
    ``:743-748`` adds into distinct columns), one cast to ``g``'s dtype."""
    w = dequantize_codes(unpack_words(qweight, bits), scales, zeros, group_size)
    dxs = g2d.float() @ w.t()
    if kperm is None:
        return dxs.to(g2d.dtype)
    dx = torch.empty_like(dxs)
    dx[:, kperm] = dxs
    return dx.to(g2d.dtype)


def t_gemv_plan(k: int, n: int, m: int, group_size: int, bits: int, sms: int) -> dict:
    """K10's decode regime's launch (``csrc/wna16_gemv_t.cuh``), from shapes
    alone: blocks of ``T_GEMV_WORD_ROWS`` word rows (``kt`` = 8 * P output K
    rows each, ``k_tiles`` of them); N in ``splits`` chunks of ``nc`` columns,
    a whole number of ``T_GEMV_BN``-column stages; about ``GEMV_BLOCKS_PER_SM``
    blocks per SM, at most ``GEMV_MAX_SPLITS`` splits, and the f32 partials
    ``[splits, m, k]`` within ``GEMV_WS_SHARE`` of the weight's bytes. ``bits``
    is the code width (3 rides in nibbles). Also the stage's group rows
    (:func:`mma_stage_groups` of a block's K rows), the blocks, the
    shared-memory, weight and workspace bytes; NotImplementedError above
    :data:`GEMV_SMEM_LIMIT` (2-bit codes at group size 1)."""
    return dict(_t_gemv_plan(k, n, m, group_size, bits, sms))


@functools.lru_cache(maxsize=None)
def _t_gemv_plan(k: int, n: int, m: int, group_size: int, bits: int, sms: int) -> dict:
    sb = storage_bits(bits)
    gs = k if group_size == -1 else group_size
    kt = T_GEMV_WORD_ROWS * 32 // sb
    k_tiles = -(-k // kt)
    mt = 8 if m <= 8 else 16
    weight_bytes = k * n * sb // 8 + 3 * -(-k // gs) * n
    cap = max(1, int(GEMV_WS_SHARE * weight_bytes // (4 * m * k)))
    want = max(1, min(GEMV_BLOCKS_PER_SM * sms // k_tiles, GEMV_MAX_SPLITS, cap))
    nc = -(-n // want // T_GEMV_BN) * T_GEMV_BN
    splits = -(-n // nc)
    groups = mma_stage_groups(gs, kt)
    ld = T_GEMV_BN + 16
    stage = T_GEMV_WORD_ROWS * ld * 4 + mt * ld * 2 + groups * T_GEMV_BN * 3
    smem = max(GEMV_STAGES * (-(-stage // 16) * 16), 4 * mt * (kt + 4) * 4)
    if smem > GEMV_SMEM_LIMIT:
        raise NotImplementedError(f"K10's decode regime for K={k}, N={n}, M={m}, group size {gs} "
                                  f"needs {smem} B of shared memory per block")
    return dict(kt=kt, k_tiles=k_tiles, nc=nc, splits=splits, blocks=k_tiles * splits,
                stage_n=T_GEMV_BN, stage_groups=groups, smem_bytes=smem,
                weight_bytes=weight_bytes, workspace_bytes=4 * m * k * splits if splits > 1 else 0)


def _t_kernel(kernel: Optional[str]) -> Optional[str]:
    """K10's kernel for a call: its own ``kernel``, else the one
    :func:`forced_kernel` sets."""
    return kernel if kernel is not None else _forced[0]


def _lib_t(bits: int, route: str = "simt"):
    """K10's entry of ``bits``-bit storage on ``route``: ``<entry>`` (SIMT) and
    ``<entry>_mma`` ``(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N,
    gs, stream)``, ``<entry>_gemv`` with ``ws, counters`` after ``dx`` and
    ``nc, splits`` after ``gs``, ``<entry>_wgmma`` with ``ws, counters`` after
    ``dx`` and ``bm, stages, splits`` after ``gs``."""
    suffix = {"simt": "", "mma": MMA_SUFFIX, "gemv": GEMV_SUFFIX, "wgmma": WGMMA_SUFFIX}[route]
    fn = getattr(build.load(T_KERNEL), T_ENTRIES[bits] + suffix)
    if fn.argtypes is None:
        ptrs = 8 if route in ("gemv", "wgmma") else 6
        ints = {"gemv": 7, "wgmma": 8}.get(route, 5)
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_t_kb32l(route: str = "simt"):
    """K10's entry over kb32l words: as :func:`_lib_t`'s with ``n_pad`` before
    ``gs``."""
    suffix = {"simt": "", "mma": MMA_SUFFIX, "gemv": GEMV_SUFFIX, "wgmma": WGMMA_SUFFIX}[route]
    fn = getattr(build.load(T_KERNEL), KB32L_T_ENTRY + suffix)
    if fn.argtypes is None:
        ptrs = 8 if route in ("gemv", "wgmma") else 6
        ints = {"gemv": 8, "wgmma": 9}.get(route, 6)
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_t(route: str, entry, g2d, qweight, scales, zeros, kperm, dx, m, k, n, gs, bits,
              *n_pad) -> None:
    """Launch K10 on ``route`` (``entry`` from :func:`_lib_t` or
    :func:`_lib_t_kb32l`, whose ``n_pad`` follows ``n``) and count it."""
    tail = ()
    if route == "gemv":
        sms = torch.cuda.get_device_properties(g2d.device).multi_processor_count
        plan = t_gemv_plan(k, n, m, gs, bits, sms)
        ws, counters = build.split_scratch(T_KERNEL + GEMV_SUFFIX, g2d.device,
                                           plan["splits"] * m * k, plan["k_tiles"])
        tail = (_ptr(ws), _ptr(counters))
    elif route == "mma":
        mma_smem_bytes(bits, gs, transpose=True)
    args = [_ptr(g2d), _ptr(kperm), _ptr(qweight), _ptr(scales), _ptr(zeros), _ptr(dx), *tail,
            DTYPE_CODES[g2d.dtype], m, k, n, *n_pad, gs]
    if route == "gemv":
        args += [plan["nc"], plan["splits"]]
    build.check(T_KERNEL, entry(*args, _stream(g2d)))
    build.launches[T_KERNEL + {"simt": "", "mma": MMA_SUFFIX, "gemv": GEMV_SUFFIX}[route]] += 1


def _kb32l_matmul_t(g2d, qweight, scales, zeros, kperm, group_size, k,
                    kernel=None) -> torch.Tensor:
    """K10 over kb32l words (see :func:`wna16_matmul_t`)."""
    n = g2d.shape[1]
    if g2d.device.type == "cpu":
        gs = k if group_size == -1 else group_size
        words, s, z = kb32l_as_gptq(qweight, scales, zeros, k, n, gs)
        return wna16_matmul_t_ref(g2d, words, s, z, kperm, gs, 4)
    if g2d.device.type != "cuda":
        raise ValueError(f"{T_KERNEL} runs on CUDA or, through its plain version, on the CPU; "
                         f"got a tensor on {g2d.device}")
    gs = _check_kb32l(g2d, qweight, scales, zeros, kperm, None, group_size, k, n,
                      transpose=True)
    m = g2d.shape[0]
    dx = torch.empty((m, k), dtype=g2d.dtype, device=g2d.device)
    if m == 0:
        return dx
    route = t_route(g2d.dtype, m, _t_kernel(kernel), k, n, layout="kb32l")
    if route == "wgmma":
        _launch_wgmma(T_KERNEL, _lib_t_kb32l(route), g2d, kperm, qweight, scales, zeros, None,
                      dx, m, k, n, gs, 4, transpose=True, layout="kb32l", key=KB32L_T_WGMMA)
        return dx
    _launch_t(route, _lib_t_kb32l(route), g2d, qweight, scales, zeros, kperm, dx, m, k, n, gs, 4,
              scales.shape[1])
    return dx


def wna16_matmul_t(g2d: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                   zeros: torch.Tensor, kperm: Optional[torch.Tensor], group_size: int,
                   bits: int, k: Optional[int] = None,
                   kernel: Optional[str] = None) -> torch.Tensor:
    """K10: ``dx = g2d [M, N] @ W^T -> [M, K]`` in ``g2d``'s dtype for
    ``bits``-bit words (2, 4 or 8), with ``kperm`` undone (dx column
    ``kperm[k]`` takes sorted row ``k``; ``kperm`` must be a permutation, as
    ``quantlinear.group_order`` makes it). 3-D ``qweight`` is K6's kb32l
    tiles (4-bit), whose padding hides K: ``k`` gives it. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel :func:`t_route`
    names for its row count (``kernel``, or the one :func:`forced_kernel`
    sets, passed on to it), or raises."""
    if bits not in T_ENTRIES:
        raise ValueError(f"words hold 2-, 4- or 8-bit codes, got bits={bits}")
    if qweight.dim() == 3:
        if bits != 4 or k is None:
            raise ValueError(f"kb32l words hold 4-bit codes and need k, got bits={bits}, k={k}")
        return _kb32l_matmul_t(g2d, qweight, scales, zeros, kperm, group_size, k, kernel)
    if g2d.device.type == "cpu":
        return wna16_matmul_t_ref(g2d, qweight, scales, zeros, kperm, group_size, bits)
    if g2d.device.type != "cuda":
        raise ValueError(f"{T_KERNEL} runs on CUDA or, through its plain version, on the CPU; "
                         f"got a tensor on {g2d.device}")
    gs = _check_operands(g2d, qweight, scales, zeros, kperm, None, group_size, bits,
                         transpose=True)
    m, n = g2d.shape
    k = qweight.shape[0] * (32 // bits)
    dx = torch.empty((m, k), dtype=g2d.dtype, device=g2d.device)
    if m == 0:
        return dx
    route = t_route(g2d.dtype, m, _t_kernel(kernel), k, n)
    if route == "wgmma":
        _launch_wgmma(T_KERNEL, _lib_t(bits, route), g2d, kperm, qweight, scales, zeros, None, dx,
                      m, k, n, gs, bits, transpose=True)
        return dx
    _launch_t(route, _lib_t(bits, route), g2d, qweight, scales, zeros, kperm, dx, m, k, n, gs,
              bits)
    return dx


def kb32l_delinearize(qweight: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """kb32l tiles ``[N_pad/128 * K_pad/256, 32, 128]`` -> the GPTQ words
    ``[K/8, N]`` they hold (tile ``(j, kb)`` is word rows ``32 kb..`` of
    columns ``128 j..``), padding cut."""
    nbn = -(-n // KB32L_BN)
    nbk = qweight.shape[0] // nbn
    words = qweight.reshape(nbn, nbk * qweight.shape[1], KB32L_BN).permute(1, 0, 2)
    return words.reshape(nbk * qweight.shape[1], nbn * KB32L_BN)[:k // 8, :n]


def kb32l_word_map(k: int, n: int, transpose: bool = False) -> dict:
    """The 3-D TMA map the wgmma kernels read kb32l words through
    (``csrc/wna16_wgmma.cuh:wg_encode_kb32l``): the tiles as one row-major
    int32 tensor ``[N_pad/128][K_pad/8][128]`` (:func:`kb32l_delinearize`'s
    reading), ``dims`` innermost first (128 columns, ``K_pad/8`` word rows,
    ``N_pad/128`` column tiles), the byte ``strides`` of dims 1 and 2, the
    ``box``. K6's forward: (128, 8, 1); the box at ``(0, 8t, j)``, reduction
    tile t of column block j, holds the ``[8][128]`` words of K rows
    ``64t..64t+63`` and columns ``128j..``. With ``transpose`` K10's: (64,
    16, 1); the box at ``(64 (t % 2), 16 i, t // 2)``, reduction tile t (N
    columns ``64t..64t+63``) of output block i (K rows ``128i..128i+127``),
    holds those ``[16][64]`` words. Each as GPTQ's map gives them."""
    nbk, nbn = -(-k // KB32L_KB), -(-n // KB32L_BN)
    rows = nbk * KB32L_KB // 8
    box = (64, WGMMA_BN // 8, 1) if transpose else (KB32L_BN, WGMMA_BK // 8, 1)
    return dict(dims=(KB32L_BN, rows, nbn), strides=(KB32L_BN * 4, rows * KB32L_BN * 4), box=box)


def kb32l_as_gptq(qweight, scales, zeros, k: int, n: int, gs: int):
    """GPTQ words ``[K/8, N]``, scales and zeros ``[G, N]`` of kb32l operands
    (views where the padding allows)."""
    g = k // gs
    return kb32l_delinearize(qweight, k, n), scales[:g, :n], zeros[:g, :n]


def kb32l_shape_ok(k: int, gs: int) -> bool:
    """The kb32l rule of the JAX package (``quantlinear.py:380-390``): a group
    size dividing 256, a multiple of 32, dividing K, so every tile holds
    whole groups and no word straddles two."""
    return gs <= KB32L_KB and KB32L_KB % gs == 0 and gs % 32 == 0 and k % gs == 0


def w4a16_kb32l_matmul_ref(x2d: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                           zeros: torch.Tensor, kperm: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], group_size: int,
                           n: int) -> torch.Tensor:
    """Plain version of K6: de-linearize the kb32l tiles, then K1's plain
    version (the JAX ``matmul_xla`` of a kb32l node, ``dequantize_xla``'s
    de-linearize at ``quantlinear.py:575-583``)."""
    k = x2d.shape[1]
    gs = k if group_size == -1 else group_size
    words, s, z = kb32l_as_gptq(qweight, scales, zeros, k, n, gs)
    return wna16_matmul_ref(x2d, words, s, z, kperm, bias, gs, 4)


def kb32l_plan(k: int, n: int, m: int, group_size: int, sms: int) -> dict:
    """K6's ring launch at ``m`` rows (the f32 decode regime and what
    ``kernel="simt"`` names at ``m <= 16``; bf16/f16 take :func:`gemv_plan`):
    tiles per K split and splits, enough blocks for about two per SM (as
    :func:`split_k` sizes K1) with the f32 x stage of a block within
    ``KB32L_X_SMEM``; the blocks, a stage's and a block's shared-memory bytes."""
    gs = k if group_size == -1 else group_size
    nbk = -(-k // KB32L_KB)
    nbn = -(-n // KB32L_BN)
    stage = KB32L_KB * KB32L_BN // 2 + (KB32L_KB // gs) * KB32L_BN * 3
    if m > DECODE_MAX_M:
        return dict(regime="tile", nbk=nbk, nbn=nbn, tiles_per_split=0, splits=0,
                    blocks=-(-n // 64) * -(-m // 64), stage_bytes=stage, smem_bytes=0)
    mt = 1 << (m - 1).bit_length()
    cap = max(1, KB32L_X_SMEM // (mt * KB32L_KB * 4))
    want = max(1, -(-2 * sms // nbn))
    tps = min(cap, -(-nbk // want))
    splits = -(-nbk // tps)
    return dict(regime="decode", nbk=nbk, nbn=nbn, tiles_per_split=tps, splits=splits,
                blocks=nbn * splits, stage_bytes=stage,
                smem_bytes=KB32L_NBUF * stage + 4 * mt * tps * KB32L_KB)


def _check_kb32l(x2d, qweight, scales, zeros, kperm, bias, group_size, k, n,
                 transpose: bool = False) -> int:
    """Raise on kb32l operands K6 (or, with ``transpose``, K10) does not
    take; ``x2d`` is ``x [M, K]`` or the cotangent ``g [M, N]``. Returns the
    group size in rows."""
    what = "g" if transpose else "x"
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.dtype not in DTYPE_CODES:
        raise ValueError(f"{what} must be a contiguous 2-D f32/f16/bf16 tensor, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    if x2d.shape[1] != (n if transpose else k):
        raise ValueError(f"{what} must be [M, {n if transpose else k}], got {tuple(x2d.shape)}")
    gs = k if group_size == -1 else group_size
    if not kb32l_shape_ok(k, gs):
        raise NotImplementedError(f"kb32l needs a group size dividing {KB32L_KB}, a multiple "
                                  f"of 32 and dividing K (K={k}, group size={gs})")
    nbk, nbn = -(-k // KB32L_KB), -(-n // KB32L_BN)
    g_pad, n_pad = nbk * KB32L_KB // gs, nbn * KB32L_BN
    if qweight.dtype != torch.int32 or tuple(qweight.shape) != (nbn * nbk, KB32L_KB // 8,
                                                                 KB32L_BN):
        raise ValueError(f"qweight must be int32 kb32l tiles [{nbn * nbk}, {KB32L_KB // 8}, "
                         f"{KB32L_BN}], got {tuple(qweight.shape)} {qweight.dtype}")
    if scales.dtype != torch.float16 or tuple(scales.shape) != (g_pad, n_pad):
        raise ValueError(f"scales must be fp16 [{g_pad}, {n_pad}], got {tuple(scales.shape)} "
                         f"{scales.dtype}")
    if zeros.dtype != torch.uint8 or tuple(zeros.shape) != (g_pad, n_pad):
        raise ValueError(f"zeros must be uint8 [{g_pad}, {n_pad}], got {tuple(zeros.shape)} "
                         f"{zeros.dtype}")
    if kperm is not None and (kperm.dtype != torch.int64 or tuple(kperm.shape) != (k,)):
        raise ValueError(f"kperm must be int64 [{k}], got {tuple(kperm.shape)} {kperm.dtype}")
    if bias is not None and (bias.dtype != x2d.dtype or tuple(bias.shape) != (n,)):
        raise ValueError(f"bias must be {x2d.dtype} [{n}], got {tuple(bias.shape)} {bias.dtype}")
    for name, t in (("qweight", qweight), ("scales", scales), ("zeros", zeros),
                    ("kperm", kperm), ("bias", bias)):
        if t is None:
            continue
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x2d.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return gs


def _lib_kb32l():
    fn = getattr(build.load(KB32L_KERNEL), KB32L_KERNEL)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_kb32l_gemv():
    """K6's tensor-core GEMV ``w4a16_kb32l_gemm_gemv(x, kperm, qweight, scales,
    zeros, bias, out, ws, counters, dtype, M, K, N, n_pad, gs, kc, splits,
    stream)``."""
    fn = getattr(build.load(KB32L_KERNEL), KB32L_KERNEL + GEMV_SUFFIX)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_kb32l_mma():
    fn = getattr(build.load(KB32L_KERNEL), KB32L_KERNEL + MMA_SUFFIX)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kb32l_blocks_per_sm(dtype: torch.dtype, m: int, group_size: int, tiles_per_split: int) -> int:
    """How many K6 decode blocks fit on one SM at once (the CUDA occupancy
    calculator over the kernel's registers and shared memory)."""
    fn = getattr(build.load(KB32L_KERNEL), "w4a16_kb32l_gemm_occupancy")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    build.check(KB32L_KERNEL, fn(DTYPE_CODES[dtype], m, group_size, tiles_per_split,
                                 ctypes.byref(blocks)))
    return blocks.value


def w4a16_kb32l_matmul(x2d: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                       zeros: torch.Tensor, kperm: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor], group_size: int, n: int,
                       kernel: Optional[str] = None) -> torch.Tensor:
    """K6: ``x2d [M, K] @ W -> [M, n]`` in ``x2d``'s dtype over kb32l words
    (4-bit storage: 3- and 4-bit layers). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel :func:`route` names (``kernel``,
    or the one :func:`forced_kernel` sets, passed on to it: the tensor-core
    GEMV, the wgmma/TMA or mma.sync tile kernel, or the ring at ``m <= 16``
    and the SIMT tile kernel above), or raises."""
    if x2d.device.type == "cpu":
        return w4a16_kb32l_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size, n)
    if x2d.device.type != "cuda":
        raise ValueError(f"{KB32L_KERNEL} runs on CUDA or, through its plain version, on the "
                         f"CPU; got a tensor on {x2d.device}")
    m, k = x2d.shape
    gs = _check_kb32l(x2d, qweight, scales, zeros, kperm, bias, group_size, k, n)
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    if m == 0:
        return out
    chosen = kb32l_route(x2d.dtype, m, gs, kernel if kernel is not None else _forced[0], k, n)
    if chosen == "wgmma":
        if kperm is not None:          # desc_act: x gathered once, as K1's wgmma route does
            x2d = x2d.index_select(1, kperm)
        _launch_wgmma(KB32L_KERNEL, _lib_kb32l_wgmma(), x2d, None, qweight, scales, zeros, bias,
                      out, m, k, n, gs, 4, layout="kb32l")
        return out
    if chosen == "gemv":
        sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
        plan = gemv_plan(k, n, m, gs, 4, sms)
        ws, counters = build.split_scratch(KB32L_KERNEL + GEMV_SUFFIX, x2d.device,
                                           plan["splits"] * m * n, plan["col_blocks"])
        code = _lib_kb32l_gemv()(_ptr(x2d), _ptr(kperm), _ptr(qweight), _ptr(scales),
                                 _ptr(zeros), _ptr(bias), _ptr(out), _ptr(ws), _ptr(counters),
                                 DTYPE_CODES[x2d.dtype], m, k, n, scales.shape[1], gs,
                                 plan["kc"], plan["splits"], _stream(x2d))
        build.check(KB32L_KERNEL, code)
        build.launches[KB32L_KERNEL + GEMV_SUFFIX] += 1
        return out
    if chosen == "mma":
        code = _lib_kb32l_mma()(_ptr(x2d), _ptr(kperm), _ptr(qweight), _ptr(scales),
                                _ptr(zeros), _ptr(bias), _ptr(out), DTYPE_CODES[x2d.dtype], m, k,
                                n, scales.shape[1], gs, _stream(x2d))
        build.check(KB32L_KERNEL, code)
        build.launches[KB32L_KERNEL + MMA_SUFFIX] += 1
        return out
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    plan = kb32l_plan(k, n, m, gs, sms)
    partial = None
    if plan["splits"] > 1:
        partial = torch.empty((plan["splits"], m, n), dtype=torch.float32, device=x2d.device)
    code = _lib_kb32l()(_ptr(x2d), _ptr(kperm), _ptr(qweight), _ptr(scales), _ptr(zeros),
                        _ptr(bias), _ptr(out), _ptr(partial), DTYPE_CODES[x2d.dtype], m, k, n,
                        scales.shape[1], gs, plan["tiles_per_split"], plan["splits"],
                        _stream(x2d))
    build.check(KB32L_KERNEL, code)
    build.launches[KB32L_KERNEL] += 1
    return out


def routed_slices(sel, e: int) -> list[tuple[Optional[int], list[int]]]:
    """The plain model of the routed GEMV's expert-major assignment, one
    ``(expert, pairs)`` per slice of its grid (``min(P, e)`` of them): slice
    z serves the z-th distinct expert of ``sel`` in order of first appearance
    and takes, in pair order, the pairs that chose it; a slice beyond the
    distinct experts is ``(None, [])`` and does nothing; a pair whose id lies
    outside ``[0, e)`` is served by no slice. ``sel`` is any sequence of ints
    (a tensor's values are read on the host)."""
    ids = [int(v) for v in (sel.tolist() if isinstance(sel, torch.Tensor) else sel)]
    experts = list(dict.fromkeys(s for s in ids if 0 <= s < e))
    return [(experts[z], [p for p, s in enumerate(ids) if s == experts[z]])
            if z < len(experts) else (None, []) for z in range(min(len(ids), e))]


def wna16_routed_matmul_ref(x2d: torch.Tensor, sel: torch.Tensor, qweight: torch.Tensor,
                            scales: torch.Tensor, zeros: torch.Tensor, group_size: int,
                            bits: int = 4) -> torch.Tensor:
    """Plain version of K9: row p is ``x2d[p] @ dequant(W[sel[p]])``, with an
    f32 dequantized weight per selected expert (the slices of
    :func:`routed_slices`), an f32 product and one cast to ``x2d``'s dtype
    (the JAX ``matmul_routed`` XLA fallback). An expert id outside ``[0, E)``
    raises ValueError."""
    e = qweight.shape[0]
    ids = sel.long().cpu()
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= e):
        raise ValueError(f"expert ids must lie in [0, {e}), got {ids.tolist()}")
    y = torch.empty((x2d.shape[0], qweight.shape[2]), dtype=torch.float32, device=x2d.device)
    for ex, pairs in routed_slices(ids, e):
        if ex is None:
            continue
        rows = torch.tensor(pairs, device=x2d.device)
        w = dequantize_codes(unpack_words(qweight[ex], bits), scales[ex], zeros[ex], group_size)
        y[rows] = x2d[rows].float() @ w
    return y.to(x2d.dtype)


ROUTED_KERNEL = "w4a16_routed_gemm"     # K9's library and launch-count key


def check_routed_errors(device) -> None:
    """Raise ValueError if a K9 launch on ``device`` since the last check was
    given an expert id outside the stack; such a pair wrote nothing. Reading
    the flag waits for the card, so ``moe_mlp`` never does and ``generate``
    checks once per call. On the CPU the plain version raises at once and
    this does nothing."""
    if build.take_error_bits(ROUTED_KERNEL, device):
        raise ValueError(f"{ROUTED_KERNEL}: an expert id outside the stack was given; the "
                         "pairs that named it wrote nothing")


def routed_route(dtype: torch.dtype, p: int, gs: int, kernel: Optional[str] = None) -> str:
    """The kernel K9 takes on the card for ``p`` pairs with group size ``gs``
    (in rows): ``"gemv"``, the expert-major tensor-core GEMV, for bf16 and
    f16 at a group size of 16 rows or more (its ``ANY_GS`` instance where 16
    does not divide ``gs``) and at most ``ROUTED_GEMV_MAX_P`` pairs (the
    routed path sends at most E, 8 for Mixtral); ``"simt"``, the SIMT routed
    kernel and its reduce, for f32, group sizes below 16 (as :func:`route`)
    and more pairs. ``kernel`` ("gemv" or "simt") names one instead."""
    if kernel not in (None, "gemv", "simt"):
        raise ValueError(f"{ROUTED_KERNEL} has the kernels 'gemv' and 'simt', got {kernel!r}")
    if kernel is not None:
        return kernel
    if dtype in MMA_DTYPES and gs >= MMA_K and p <= ROUTED_GEMV_MAX_P:
        return "gemv"
    return "simt"


def _lib_routed():
    fn = getattr(build.load(ROUTED_KERNEL), ROUTED_KERNEL)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_routed_gemv():
    """K9's tensor-core GEMV ``w4a16_routed_gemm_gemv(x, sel, qweight, scales,
    zeros, out, ws, counters, err, dtype, E, P, K, N, gs, kc, splits,
    stream)``."""
    fn = getattr(build.load(ROUTED_KERNEL), ROUTED_KERNEL + GEMV_SUFFIX)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def wna16_routed_matmul(x2d: torch.Tensor, sel: torch.Tensor, qweight: torch.Tensor,
                        scales: torch.Tensor, zeros: torch.Tensor, group_size: int,
                        bits: int = 4, check: bool = True,
                        out: Optional[torch.Tensor] = None,
                        kernel: Optional[str] = None) -> torch.Tensor:
    """K9: ``x2d [P, K]``, ``sel`` int32 ``[P]`` and a stack of 4-bit
    experts (``qweight`` int32 ``[E, K/8, N]``, ``scales`` fp16 ``[E, G, N]``,
    ``zeros`` uint8 ``[E, G, N]``) -> ``[P, N]`` in ``x2d``'s dtype, row p
    ``x2d[p] @ dequant(W[sel[p]])``. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel :func:`routed_route` names (``kernel``, or
    the one :func:`forced_kernel` sets, passed on to it) or raises. The
    kernels read ``sel`` on the card; a pair naming an expert outside the
    stack writes nothing and sets a device flag, which ``check=True`` reads at
    once (a wait for the card) and ``check=False`` leaves to
    :func:`check_routed_errors`. ``out``, a contiguous ``[P, N]`` tensor of
    ``x2d``'s dtype on the card, is written in place of a new one (the rows of
    such pairs keep what they held)."""
    if bits != 4:
        raise ValueError(f"{ROUTED_KERNEL} takes 4-bit words (3-bit codes in nibbles), "
                         f"got bits={bits}")
    if x2d.device.type == "cpu":
        return wna16_routed_matmul_ref(x2d, sel, qweight, scales, zeros, group_size, bits)
    if x2d.device.type != "cuda":
        raise ValueError(f"{ROUTED_KERNEL} runs on CUDA or, through its plain version, on the "
                         f"CPU; got a tensor on {x2d.device}")
    if qweight.dim() != 3 or scales.dim() != 3 or zeros.dim() != 3 or not (
            qweight.shape[0] == scales.shape[0] == zeros.shape[0]):
        raise ValueError(f"qweight, scales and zeros must be stacked [E, ...] tensors, got "
                         f"{tuple(qweight.shape)}, {tuple(scales.shape)}, {tuple(zeros.shape)}")
    gs = _check_operands(x2d, qweight[0], scales[0], zeros[0], None, None, group_size, bits)
    for name, t in (("qweight", qweight), ("scales", scales), ("zeros", zeros)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p, k = x2d.shape
    e, _, n = qweight.shape
    if sel.dtype != torch.int32 or tuple(sel.shape) != (p,) or sel.device != x2d.device \
            or not sel.is_contiguous():
        raise ValueError(f"sel must be a contiguous int32 [{p}] tensor on {x2d.device}, got "
                         f"{tuple(sel.shape)} {sel.dtype} on {sel.device}")
    if out is None:
        out = torch.empty((p, n), dtype=x2d.dtype, device=x2d.device)
    elif (out.dtype != x2d.dtype or tuple(out.shape) != (p, n) or out.device != x2d.device
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {x2d.dtype} [{p}, {n}] tensor on "
                         f"{x2d.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if p == 0:
        return out
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    flag = build.error_flag(ROUTED_KERNEL, x2d.device)
    if routed_route(x2d.dtype, p, gs, kernel if kernel is not None else _forced[0]) == "gemv":
        plan = routed_plan(k, n, p, e, gs, bits, sms)
        ws, counters = build.split_scratch(ROUTED_KERNEL + GEMV_SUFFIX, x2d.device,
                                           plan["splits"] * p * n, plan["counters"])
        code = _lib_routed_gemv()(_ptr(x2d), _ptr(sel), _ptr(qweight), _ptr(scales), _ptr(zeros),
                                  _ptr(out), _ptr(ws), _ptr(counters), _ptr(flag),
                                  DTYPE_CODES[x2d.dtype], e, p, k, n, gs, plan["kc"],
                                  plan["splits"], _stream(x2d))
        build.check(ROUTED_KERNEL, code)
        build.launches[ROUTED_KERNEL + GEMV_SUFFIX] += 1
        if check:
            check_routed_errors(x2d.device)
        return out
    kc, splits = split_k(k, n, gs, sms)
    partial = None
    if splits > 1:
        partial = torch.empty((splits, p, n), dtype=torch.float32, device=x2d.device)
    code = _lib_routed()(_ptr(x2d), _ptr(sel), _ptr(qweight), _ptr(scales), _ptr(zeros),
                         _ptr(out), _ptr(partial), _ptr(flag), DTYPE_CODES[x2d.dtype], e, p, k,
                         n, gs, kc, splits,
                         _stream(x2d))
    build.check(ROUTED_KERNEL, code)
    build.launches[ROUTED_KERNEL] += 1
    if check:
        check_routed_errors(x2d.device)
    return out


def w4a16_matmul(x2d, qweight, scales, zeros, kperm, bias, group_size) -> torch.Tensor:
    """K1: 4-bit words (3-bit codes ride in nibbles)."""
    return wna16_matmul(x2d, qweight, scales, zeros, kperm, bias, group_size, 4)


def w8a16_matmul(x2d, qweight, scales, zeros, kperm, bias, group_size) -> torch.Tensor:
    """K4: 8-bit words, int32 [K/4, N]."""
    return wna16_matmul(x2d, qweight, scales, zeros, kperm, bias, group_size, 8)


def w2a16_matmul(x2d, qweight, scales, zeros, kperm, bias, group_size) -> torch.Tensor:
    """K5: 2-bit words, int32 [K/16, N]."""
    return wna16_matmul(x2d, qweight, scales, zeros, kperm, bias, group_size, 2)


def w4a16_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size) -> torch.Tensor:
    """Plain version of K1."""
    return wna16_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size, 4)


def w8a16_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size) -> torch.Tensor:
    """Plain version of K4."""
    return wna16_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size, 8)


def w2a16_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size) -> torch.Tensor:
    """Plain version of K5."""
    return wna16_matmul_ref(x2d, qweight, scales, zeros, kperm, bias, group_size, 2)


def w4a16_matmul_t(g2d, qweight, scales, zeros, kperm, group_size) -> torch.Tensor:
    """K10 for 4-bit words (3-bit codes ride in nibbles)."""
    return wna16_matmul_t(g2d, qweight, scales, zeros, kperm, group_size, 4)


def w8a16_matmul_t(g2d, qweight, scales, zeros, kperm, group_size) -> torch.Tensor:
    """K10 for 8-bit words."""
    return wna16_matmul_t(g2d, qweight, scales, zeros, kperm, group_size, 8)


def w2a16_matmul_t(g2d, qweight, scales, zeros, kperm, group_size) -> torch.Tensor:
    """K10 for 2-bit words."""
    return wna16_matmul_t(g2d, qweight, scales, zeros, kperm, group_size, 2)


__all__ = [
    "KERNEL_NAMES", "T_KERNEL", "wna16_matmul", "wna16_matmul_ref", "wna16_matmul_t",
    "wna16_matmul_t_ref", "w4a16_matmul_t", "w8a16_matmul_t", "w2a16_matmul_t",
    "w4a16_matmul", "w4a16_matmul_ref", "w8a16_matmul", "w8a16_matmul_ref",
    "w2a16_matmul", "w2a16_matmul_ref", "dequantize_codes", "unpack_words",
    "split_k", "tile_kernel", "t_route", "mma_stage_groups", "mma_smem_bytes", "route",
    "kb32l_route", "prenorm_rstd", "RSTD_KERNEL", "wgmma_shape_ok", "wgmma_stage_bytes", "wgmma_plan", "WGMMA_SUFFIX",
    "gemv_plan", "t_gemv_plan",
    "gemv_blocks_per_sm", "forced_kernel",
    "storage_bits", "MMA_SUFFIX", "GEMV_SUFFIX", "NORM_SUFFIX", "rms_apply", "prenorm_eligible", "ROUTED_KERNEL", "wna16_routed_matmul",
    "wna16_routed_matmul_ref", "routed_route", "routed_plan", "routed_slices",
    "check_routed_errors", "KB32L_KERNEL", "KB32L_KB", "KB32L_BN", "KB32L_NBUF",
    "kb32l_delinearize", "kb32l_word_map", "kb32l_as_gptq", "kb32l_shape_ok", "kb32l_plan", "kb32l_blocks_per_sm",
    "w4a16_kb32l_matmul", "w4a16_kb32l_matmul_ref",
]
