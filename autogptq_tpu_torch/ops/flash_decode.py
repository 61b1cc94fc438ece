"""K2: flash-decode attention over one layer of the stacked KV cache.

Replaces the TPU kernel ``autogptq_tpu/ops/pallas/flash_decode.py:_kernel``.
The CUDA source is ``csrc/flash_decode.cu`` (its header note gives the design
and the bound). ``flash_decode`` launches it for CUDA tensors and runs the
plain version, ``flash_decode_ref``, for CPU tensors.

Semantics: query row ``b`` (one token, ``H`` heads) attends cache slots
``[lo[b], min(hi[b], S))`` of ``layer``; query head ``h`` reads KV head
``h // (H // Hkv)``; all math is f32 and the result is f32 ``[B, H, D]``. A
row with nothing to attend (``hi <= lo``) yields zeros, as the TPU kernel
does.

K2 is split-KV attention in one launch: :func:`split_plan` cuts the ``S``
slots of a row into chunks from the shapes alone, the chunks run as separate
blocks, and the last block of each (row, KV head) merges their partials as
:func:`merge_partials` does.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "flash_decode"
NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128, 256)
REPS = (1, 2, 4, 8)
MAX_REP_TIMES_D = 1024    # a lane holds rep x D / 32 query and rep x D / 32 sum floats
SMS = 132                 # streaming multiprocessors of an H100 SXM
CHUNK_UNIT = 32           # csrc/split_kv.cuh: 4 warps x a batch of 8 positions each
TARGET_BLOCKS = 4 * SMS   # 4 blocks of 4 warps per SM, each warp with a batch of loads in flight
MAX_SPLITS = 32           # csrc/split_kv.cuh: the partials the last block merges at most


def chunk_plan(rows: int, positions: int, unit: int) -> tuple[int, int]:
    """``(C, n_split)`` for ``rows`` (row, KV head) pairs of ``positions``
    slots: ``C`` a multiple of ``unit``, as short as makes ``rows * n_split``
    reach ``TARGET_BLOCKS`` (never below ``unit``), one chunk per row when
    the rows alone reach it, and long enough for ``n_split = ceil(positions
    / C)`` to stay within ``MAX_SPLITS``."""
    want = -(-TARGET_BLOCKS // rows)
    units = -(-positions // unit)
    per_chunk = max(units // want if want > 1 else units, -(-units // MAX_SPLITS), 1)
    c = unit * per_chunk
    return c, -(-positions // c)


def split_plan(b: int, hkv: int, s: int) -> tuple[int, int]:
    """K2's split of a row's ``s`` cache slots: ``(C, n_split)``, chunk ``c``
    covering slots ``[c * C, (c + 1) * C)``. Shapes only: the live bounds
    stay on the card, so the grid is fixed for a cache capacity."""
    return chunk_plan(b * hkv, s, CHUNK_UNIT)


def merge_partials(m: torch.Tensor, denom: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' combine step. Chunk ``c``'s partial is
    its max score ``m[..., c]``, its sum of ``exp(score - m)``
    ``denom[..., c]`` and its sum of ``exp(score - m) * v`` ``acc[..., c, :]``
    (an empty chunk: ``-1e30``, 0, 0). Returns the attention ``[..., D]``,
    zeros where every chunk is empty."""
    mx = m.amax(dim=-1, keepdim=True)
    f = torch.exp(m - mx)
    den = (denom * f).sum(dim=-1)
    num = (acc * f[..., None]).sum(dim=-2)
    return num / den.clamp_min(1e-30)[..., None]


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor, *, layer: int,
                     sm_scale: float) -> torch.Tensor:
    """Plain version of K2 (dense f32 attention with a ``[lo, hi)`` mask)."""
    b, h, d = q.shape
    hkv = k_cache.shape[3]
    rep = h // hkv
    keys = k_cache[layer].float()                        # [B, S, Hkv, D]
    vals = v_cache[layer].float()
    s = keys.shape[1]
    qh = q.reshape(b, hkv, rep, d).float()
    sc = torch.einsum("bhrd,bshd->bhrs", qh, keys) * sm_scale
    pos = torch.arange(s, device=q.device)[None, :]
    mask = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None, None, :]
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.where(mask, torch.exp(sc - sc.amax(dim=-1, keepdim=True)), 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhrs,bshd->bhrd", p / den, vals)
    return o.reshape(b, h, d)


def _lib():
    fn = build.load(NAME).flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _check_operands(q, k_cache, v_cache, lo, hi, layer) -> int:
    if q.dim() != 3 or k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be [B, H, D] and both caches [L, B, S, Hkv, D]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    n_layers, cb, _, hkv, cd = k_cache.shape
    if cb != b or cd != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for a {n_layers}-layer cache")
    rep = h // hkv
    if d not in HEAD_DIMS or rep not in REPS or rep * d > MAX_REP_TIMES_D:
        raise NotImplementedError(f"K2 supports head_dim in {HEAD_DIMS} and H/Hkv in {REPS} "
                                  f"with (H/Hkv) * head_dim <= {MAX_REP_TIMES_D}; got "
                                  f"head_dim={d}, H/Hkv={rep}")
    if q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q and the caches must share one f32/f16/bf16 dtype, got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be int32 [{b}], got {tuple(t.shape)} {t.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("lo", lo), ("hi", hi)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return rep


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, *, layer: int,
                 sm_scale: float) -> torch.Tensor:
    """Decode attention, ``[B, H, D]`` f32. A CPU tensor takes the plain
    version; a CUDA tensor launches K2 (one launch) or raises."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lo, hi, layer=layer, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or, through its plain version, on the CPU; "
                         f"got a tensor on {q.device}")
    rep = _check_operands(q, k_cache, v_cache, lo, hi, layer)
    b, h, d = q.shape
    _, _, s, hkv, _ = k_cache.shape
    chunk, n_split = split_plan(b, hkv, s)
    ws, counters = build.split_scratch(NAME, q.device, b * hkv * n_split * rep * (d + 2), b * hkv)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    fn = _lib()
    code = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_cache.data_ptr()),
              ctypes.c_void_p(v_cache.data_ptr()), ctypes.c_void_p(lo.data_ptr()),
              ctypes.c_void_p(hi.data_ptr()), ctypes.c_void_p(out.data_ptr()),
              DTYPE_CODES[q.dtype], b, s, hkv, d, rep, layer, float(sm_scale),
              ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
              ctypes.c_void_p(ws.data_ptr()), ctypes.c_void_p(counters.data_ptr()), chunk,
              n_split)
    build.check(NAME, code)
    build.launches[NAME] += 1
    return out


__all__ = ["chunk_plan", "flash_decode", "flash_decode_ref", "merge_partials", "split_plan"]
