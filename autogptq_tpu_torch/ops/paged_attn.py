"""K7 and K8: decode attention over a paged KV cache, and the KV cache updates.

Counterpart of the JAX package's ``ops/pallas/paged_attn.py``, with its layouts:

* pools are page-major, ``[L, P, Hkv, ps, D]`` (stacked, read at ``layer=``)
  or ``[P, Hkv, ps, D]``; bf16/f16/f32, or int8 with f32 scale pools of the
  same shape without ``D`` (``[L, P, Hkv, ps]``), dequantized as
  ``q * s / 127.5``;
* page tables are int32 ``[B, W]`` and lengths int32 ``[B]``: row ``b``
  attends its positions ``[0, lengths[b])``, position ``s`` living in page
  ``tables[b, s // ps]`` at slot ``s % ps``.

Three kernels, each with its plain version in this module:

* K7 ``paged_attention_mh`` (``csrc/paged_attn.cu``; plain:
  ``paged_attention_mh_ref``) replaces ``paged_attn.py:paged_attention_mh``;
  it is split-KV attention in one launch, its chunks whole pages
  (:func:`split_plan`), combined as ``flash_decode.merge_partials`` does;
* K8a ``kv_write`` (``csrc/page_ops.cu``) replaces
  ``paged_attn.py:write_token_pages_kernel``, and takes in the RoPE that XLA
  fuses around that write under the JAX package's jit: :func:`rope_write_kv`
  (plain: :func:`rope_write_kv_ref`, ``arch.apply_rope``'s rotation then
  ``write_token_pages`` or ``index_copy_``, with :func:`quant_rows` for an
  int8 pool, :func:`kv_quantize` for an int8 contiguous cache) turns q and k
  by their positions and writes K and V into the paged pools through the page
  tables or into the contiguous cache at the device cursor, one launch per
  layer and decode step;
  :func:`write_token_pages_kernel` (plain: ``write_token_pages``) is the same
  kernel with the rotation off;
* K8b ``copy_pages_pair`` (``csrc/page_ops.cu``; plain: ``copy_pages``)
  replaces ``paged_attn.py:copy_pages_pair``: one thread-block cluster per
  (layer, pool) holds every copied page in shared memory between its loads
  and its stores (:func:`copy_plan`), a gather and a scatter kernel kept
  for the shapes no cluster holds.

A wrapper runs the plain version for CPU tensors and launches its kernel, or
raises, for CUDA tensors. The JAX functions return new arrays; the port's
writes and copies update the caches in place and return them as well. Unlike
the JAX package, the kernels also take int8 pools and 4-D scale pools, so no
plain version runs on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build
from .flash_decode import CHUNK_UNIT, chunk_plan

ATTN = "paged_attn"
PAGE_OPS = "page_ops"
NEG_INF = -1e30
FLOAT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
INT8_CODE = 3
HEAD_DIMS = (64, 128, 256)
REPS = (1, 2, 4, 8)
MAX_REP_TIMES_D = 1024    # a lane holds rep x D / 32 query and rep x D / 32 sum floats


def split_plan(b: int, hkv: int, w: int, ps: int) -> tuple[int, int]:
    """K7's split of a row's ``w * ps`` table positions: ``(C, n_split)``,
    ``C`` a whole number of pages, chunk ``c`` covering positions
    ``[c * C, (c + 1) * C)``. Shapes only: the lengths stay on the card, so
    the grid is fixed for a table width."""
    return chunk_plan(b * hkv, w * ps, math.lcm(CHUNK_UNIT, ps))


def _layer_pools(k_pages, v_pages, k_scales, v_scales, layer):
    """Check the pool ranks against ``layer`` and return the 4-D pools of
    that layer. The JAX kernel ignores ``layer=`` for 4-D pools and never
    checks its range; the port raises on both."""
    if k_pages.dim() == 5:
        if layer is None:
            raise ValueError("layer= is required for stacked [L, P, Hkv, ps, D] pools")
        if not 0 <= layer < k_pages.shape[0]:
            raise ValueError(f"layer {layer} out of range for {k_pages.shape[0]}-layer pools")
    elif k_pages.dim() == 4:
        if layer is not None:
            raise ValueError("layer= is given but the pools are 4-D [P, Hkv, ps, D]; pass "
                             "stacked [L, P, Hkv, ps, D] pools or no layer")
    else:
        raise ValueError(f"pools must be [P, Hkv, ps, D] or [L, P, Hkv, ps, D], got "
                         f"{tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k and v pools differ: {tuple(k_pages.shape)} vs {tuple(v_pages.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    if (k_pages.dtype == torch.int8) != (k_scales is not None):
        raise ValueError("int8 pools need k_scales/v_scales, and only int8 pools take them")
    if k_scales is not None:
        want = tuple(k_pages.shape[:-1])
        for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(s.shape) != want or s.dtype != torch.float32:
                raise ValueError(f"{name} must be f32 {want}, got {tuple(s.shape)} {s.dtype}")
    if layer is None:
        return k_pages, v_pages, k_scales, v_scales
    pick = (lambda a: None if a is None else a[layer])
    return pick(k_pages), pick(v_pages), pick(k_scales), pick(v_scales)


def paged_attention_mh_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           lengths: torch.Tensor, tables: torch.Tensor,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None, *, sm_scale: float,
                           layer: Optional[int] = None) -> torch.Tensor:
    """Plain version of K7: gathers every page of the tables and runs masked
    f32 softmax attention, ``[B, H, D]`` f32. A row of length 0 yields zeros,
    as the kernel does (the JAX reference returns the mean of its values)."""
    kp, vp, ks, vs = _layer_pools(k_pages, v_pages, k_scales, v_scales, layer)
    b, h, d = q.shape
    n_pages, hkv, ps, _ = kp.shape
    w = tables.shape[1]
    rep = h // hkv
    idx = tables.long().clamp(0, n_pages - 1)
    kg = kp[idx].float()                                  # [B, W, Hkv, ps, D]
    vg = vp[idx].float()
    if ks is not None:
        kg = kg * (ks[idx] / 127.5)[..., None]
        vg = vg * (vs[idx] / 127.5)[..., None]
    kg = kg.permute(0, 2, 1, 3, 4).reshape(b, hkv, w * ps, d)
    vg = vg.permute(0, 2, 1, 3, 4).reshape(b, hkv, w * ps, d)
    qh = q.reshape(b, hkv, rep, d).float()
    s = torch.einsum("bhrd,bhtd->bhrt", qh, kg) * sm_scale
    pos = torch.arange(w * ps, device=q.device)[None, :]
    mask = (pos < lengths[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhrt,bhtd->bhrd", p / den, vg)
    return o.reshape(b, h, d)


WRITE_TARGET_MSG = ("write targets must lie in the cache: page_of in [0, P) and off in [0, ps), a "
                    "position inside the page table, the cursor in [0, S), per-row cursors >= 0")
COPY_ID_MSG = "page ids must lie in [0, P)"
COPY_DUP_MSG = "dst page ids must be unique"
_ERR_MESSAGES = ((1, WRITE_TARGET_MSG), (2, COPY_ID_MSG), (4, COPY_DUP_MSG))   # page_ops.cu ERR_*


def _outside(t: torch.Tensor, hi: int) -> bool:
    return t.numel() > 0 and (int(t.min()) < 0 or int(t.max()) >= hi)


def write_token_pages(pool: torch.Tensor, layer: int, page_of: torch.Tensor,
                      off: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K8a for one pool: ``pool[layer, page_of[b], :, off[b]]
    = rows[b]``. 5-D pools take ``rows`` ``[B, Hkv, D]``; 4-D scale pools
    ``[L, P, Hkv, ps]`` take ``[B, Hkv]`` (or ``[B, Hkv, 1]``). Every
    sequence writes its own page, so no two rows share a target. Writes in
    place and returns ``pool``; a target outside the pool raises ValueError
    before anything is written, as K8a then writes nothing."""
    if _outside(page_of, pool.shape[1]) or _outside(off, pool.shape[3]):
        raise ValueError(WRITE_TARGET_MSG)
    if pool.dim() == 4 and rows.dim() == 3:
        rows = rows[..., 0]
    pool[layer, page_of.long(), :, off.long()] = rows.to(pool.dtype)
    return pool


def copy_pages(pool: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain version of K8b for one pool: ``pool[:, dst[i]] = pool[:, src[i]]``
    for every ``i``, all reads before any write (a ``src`` may be another
    copy's ``dst``). Works on 5-D pools and 4-D scale pools; in place, returns
    ``pool``. A page id outside the pool or a repeated ``dst`` raises
    ValueError before anything is written, as K8b then writes nothing."""
    if _outside(src, pool.shape[1]) or _outside(dst, pool.shape[1]):
        raise ValueError(COPY_ID_MSG)
    if torch.unique(dst).numel() != dst.numel():
        raise ValueError(COPY_DUP_MSG)
    pages = pool[:, src.long()].clone()
    pool[:, dst.long()] = pages
    return pool


def rope_inv_freq(theta: float, d: int, device) -> torch.Tensor:
    """RoPE's inverse frequencies ``[d / 2]`` f32, ``1 / theta ** (2i / d)``
    as the JAX package computes them (``arch.apply_rope`` and K8a take them
    from here)."""
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exponents / d))


def rope_rows(pos: torch.Tensor, inv_freq: torch.Tensor, *xs: torch.Tensor) -> tuple:
    """Rotate-halves RoPE: each ``x [..., n, D]`` turned by the angles
    ``pos[...] * inv_freq`` in f32 and rounded once to ``x``'s dtype (the
    plain rotation of ``arch.apply_rope`` and of the fused K8a)."""
    angles = pos.float()[..., None] * inv_freq
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return tuple(rot(x) for x in xs)


def quant_rows(x: torch.Tensor):
    """Per-(slot, head) int8 over the last axis: ``(codes, scale [..., 1])``
    with value = code * scale / 127.5 (the JAX package's paged int8 scheme).
    The contiguous cache takes :func:`kv_quantize`'s scheme instead; the two
    round differently and are never mixed."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    q = torch.round(xf * (127.5 / s))
    return q.clamp(-127, 127).to(torch.int8), s


def kv_quantize(x: torch.Tensor):
    """Per-(token, head) symmetric int8 over the last axis, the contiguous
    cache's scheme (the JAX package's ``models/arch.py:_kv_quantize``, bit for
    bit): ``scale = max|x| / 127`` in f32, ``code = round(x / max(scale,
    1e-10))`` half to even; returns ``(codes, scale [..., 1])`` with value =
    code * scale, the scale unfloored (0 for an all-zero row)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on the card torch divides by a Python scalar through its reciprocal,
    # which rounds otherwise than the division the JAX package and K8a make
    scale = amax / torch.full_like(amax, 127.0)
    return torch.round(xf / scale.clamp_min(1e-10)).to(torch.int8), scale


def rope_write_kv_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                      inv_freq: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      layer: int, tables: Optional[torch.Tensor] = None,
                      cursor: Optional[torch.Tensor] = None,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      cursors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the fused K8a: q and k turned by :func:`rope_rows`,
    then K and V written into the paged pools through ``tables`` (page
    ``tables[b, pos[b] // ps]``, slot ``pos[b] % ps``; int8 pools take
    :func:`quant_rows`' codes and scales), into the contiguous cache at
    ``cursor`` (an int8 cache :func:`kv_quantize`'s, its scales ``[L, B, S,
    Hkv, 1]``) or at one cursor per cache row, ``cursors [Bc]``: input row
    ``b`` of ``Bc * T`` to cache row ``b // T``, slot ``cursors[b // T] + b %
    T``, a slot at or past S dropped (the JAX package's scatter with
    ``mode="drop"``). Returns q turned, ``[B, H, D]``. A target outside the
    cache (a negative per-row cursor) raises ValueError before anything is
    written."""
    qr, kr = rope_rows(pos, inv_freq, q, k)
    if cursors is not None:
        if cursors.numel() and int(cursors.min()) < 0:
            raise ValueError(WRITE_TARGET_MSG)
        bc, s = k_cache.shape[1], k_cache.shape[2]
        t = pos.shape[0] // bc
        flat = torch.arange(bc * t, device=pos.device)
        row = flat // t
        slot = cursors[row] + flat % t
        keep = slot < s
        rows = ((k_cache, kr), (v_cache, v))
        if k_scale is not None:
            (kq, ks), (vq, vs) = kv_quantize(kr), kv_quantize(v)
            rows = ((k_cache, kq), (v_cache, vq), (k_scale, ks), (v_scale, vs))
        for cache, r in rows:
            cache[layer, row[keep], slot[keep]] = r[keep].to(cache.dtype)
        return qr
    if cursor is not None:
        if not 0 <= int(cursor[0]) < k_cache.shape[2]:
            raise ValueError(WRITE_TARGET_MSG)
        rows = ((k_cache, kr), (v_cache, v))
        if k_scale is not None:
            (kq, ks), (vq, vs) = kv_quantize(kr), kv_quantize(v)
            rows = ((k_cache, kq), (v_cache, vq), (k_scale, ks), (v_scale, vs))
        for cache, r in rows:
            cache[layer].index_copy_(1, cursor, r[:, None].to(cache.dtype))
        return qr
    ps = k_cache.shape[3]
    p = pos.long()
    if _outside(p, tables.shape[1] * ps):
        raise ValueError(WRITE_TARGET_MSG)
    page_of = tables[torch.arange(p.shape[0], device=p.device), p // ps]
    off = (p % ps).to(torch.int32)
    if _outside(page_of, k_cache.shape[1]):
        raise ValueError(WRITE_TARGET_MSG)
    if k_scale is not None:
        (kq, ks), (vq, vs) = quant_rows(kr), quant_rows(v)
        for pool, rows in ((k_cache, kq), (v_cache, vq), (k_scale, ks), (v_scale, vs)):
            write_token_pages(pool, layer, page_of, off, rows)
    else:
        write_token_pages(k_cache, layer, page_of, off, kr)
        write_token_pages(v_cache, layer, page_of, off, v)
    return qr


COPY_SLICE_MAX = 64 << 10   # csrc/page_ops.cu SLICE_MAX: bytes of a page slice in one block
COPY_MAX_CLUSTER = 16       # MAX_CLUSTER: the non-portable cluster size


def copy_plan(n: int, page_bytes: int) -> int:
    """K8b's slices per page, from shapes alone: a (layer, pool) is one
    cluster of ``n * slices`` blocks, each holding a slice of at most
    ``COPY_SLICE_MAX`` bytes (a multiple of 16, TMA's bulk unit). 0 where no
    cluster holds the shape (more than ``COPY_MAX_CLUSTER`` blocks): the
    gather and scatter kernels take it."""
    slices = max(1, -(-page_bytes // COPY_SLICE_MAX))
    if n * slices > COPY_MAX_CLUSTER or page_bytes % (16 * slices):
        return 0
    return slices


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or, through its plain version, on the CPU; "
                         f"got a tensor on {t.device}")


def _check_on(device, **tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def _unit(nbytes: int, *tensors) -> int:
    """Widest access (16, 8, 4, 2 or 1 bytes) that divides ``nbytes`` and
    every pointer."""
    for u in (16, 8, 4, 2, 1):
        if nbytes % u == 0 and all(t.data_ptr() % u == 0 for t in tensors):
            return u
    return 1


def _check_pool_pair(k_pool: torch.Tensor, v_pool: torch.Tensor) -> None:
    if k_pool.dim() not in (4, 5) or k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"pools must be one dtype and shape, [L, P, Hkv, ps(, D)]; got "
                         f"{tuple(k_pool.shape)} {k_pool.dtype} and {tuple(v_pool.shape)} "
                         f"{v_pool.dtype}")


def _attn_fn():
    fn = build.load(ATTN).paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def paged_attention_mh(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                       lengths: torch.Tensor, tables: torch.Tensor,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None, *, sm_scale: float,
                       layer: Optional[int] = None) -> torch.Tensor:
    """Decode attention of one query token per row over page tables, ``[B, H,
    D]`` f32. ``q`` is ``[B, H, D]``; query head ``h`` reads KV head
    ``h // (H // Hkv)``. A CPU tensor takes the plain version; a CUDA tensor
    launches K7 (one launch) or raises. K7 reads only each row's live pages
    ``ceil(lengths[b] / ps)`` (at most ``W``), so the table need not be cut to
    a window first."""
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    _layer_pools(k_pages, v_pages, k_scales, v_scales, layer)
    b, h, d = q.shape
    hkv, ps, pd = k_pages.shape[-3:]
    if pd != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)} "
                         "(head_dim must match and Hkv must divide H)")
    if tables.dim() != 2 or tables.shape[0] != b or tables.dtype != torch.int32:
        raise ValueError(f"tables must be int32 [{b}, W], got {tuple(tables.shape)} {tables.dtype}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{b}], got {tuple(lengths.shape)} {lengths.dtype}")
    if q.device.type == "cpu":
        return paged_attention_mh_ref(q, k_pages, v_pages, lengths, tables, k_scales, v_scales,
                                      sm_scale=sm_scale, layer=layer)
    _require_cuda("K7", q)
    rep = h // hkv
    if d not in HEAD_DIMS or rep not in REPS or rep * d > MAX_REP_TIMES_D:
        raise NotImplementedError(f"K7 supports head_dim in {HEAD_DIMS} and H/Hkv in {REPS} with "
                                  f"(H/Hkv) * head_dim <= {MAX_REP_TIMES_D}; got head_dim={d}, "
                                  f"H/Hkv={rep}")
    if q.dtype not in FLOAT_CODES:
        raise ValueError(f"q must be f32, f16 or bf16, got {q.dtype}")
    if k_pages.dtype == torch.int8:
        kv_code = INT8_CODE
    elif k_pages.dtype == q.dtype:
        kv_code = FLOAT_CODES[q.dtype]
    else:
        raise ValueError(f"float pools must have q's dtype {q.dtype}, got {k_pages.dtype}")
    _check_on(q.device, q=q, k_pages=k_pages, v_pages=v_pages, k_scales=k_scales,
              v_scales=v_scales, lengths=lengths, tables=tables)
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pools must be 16-byte aligned")
    stacked = k_pages.dim() == 5
    n_layers = k_pages.shape[0] if stacked else 1
    n_pages = k_pages.shape[-4]
    w = tables.shape[1]
    chunk, n_split = split_plan(b, hkv, w, ps)
    ws, counters = build.split_scratch(ATTN, q.device, b * hkv * n_split * rep * (d + 2), b * hkv)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    null = ctypes.c_void_p(0)
    code = _attn_fn()(
        _ptr(q), _ptr(k_pages), _ptr(v_pages),
        null if k_scales is None else _ptr(k_scales), null if v_scales is None else _ptr(v_scales),
        _ptr(lengths), _ptr(tables), _ptr(out),
        FLOAT_CODES[q.dtype], kv_code, b, n_layers, n_pages, hkv, ps, d, rep, w,
        layer if stacked else 0, float(sm_scale), _stream(q), _ptr(ws), _ptr(counters), chunk,
        n_split)
    build.check(ATTN, code)
    build.launches["paged_attention_mh"] += 1
    return out


def check_page_errors(device) -> None:
    """Raise ValueError if a K8a or K8b launch on ``device`` since the last
    check was given a bad id (a write target outside the cache, a page id
    outside the pool, a repeated ``dst``); such a launch wrote nothing.
    Reading the flag waits for the card, so the decode paths check once per
    generate. On the CPU the plain versions raise at once and this does
    nothing."""
    bits = build.take_error_bits(PAGE_OPS, device)
    if bits:
        raise ValueError("; ".join(msg for bit, msg in _ERR_MESSAGES if bits & bit))


_PAGE_ARGTYPES = {
    "kv_write": ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 14 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2),
    "copy_pages_cluster": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2),
    "copy_pages": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2),
}
MODE_ROWS, MODE_TABLES, MODE_CURSOR, MODE_ROW_CURSOR = 0, 1, 2, 3   # page_ops.cu MODE_*
QUANT_NONE, QUANT_PAGED, QUANT_CONTIG = 0, 1, 2  # page_ops.cu QUANT_*: -, quant_rows, kv_quantize


def _page_fn(name: str):
    fn = getattr(build.load(PAGE_OPS), name)
    if fn.argtypes is None:
        fn.argtypes = _PAGE_ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _kv_write(mode: int, k_dst: torch.Tensor, v_dst: torch.Tensor, layer: int, k, v, *, q=None,
              pos=None, inv_freq=None, page_of=None, off=None, tables=None, cursor=None,
              k_scale=None, v_scale=None, quant: int = QUANT_NONE, n_slots: int, w: int = 0,
              t: int = 1):
    """One launch of ``kv_write`` over caches whose dims 0, 2, 3 are (layer,
    head, slot) and dim 1 the page or row; returns q turned, or None."""
    null = ctypes.c_void_p(0)

    def ptr(t):
        return null if t is None else _ptr(t)

    rope = inv_freq is not None
    q_out = torch.empty_like(q) if q is not None else None
    b, hkv = k.shape[:2]
    d = k_dst.shape[4] if k_dst.dim() == 5 else 1
    strides = [k_dst.stride(i) for i in range(4)]
    code = _page_fn("kv_write")(
        ptr(q), _ptr(k), _ptr(v), ptr(q_out), _ptr(k_dst), _ptr(v_dst), ptr(k_scale), ptr(v_scale),
        ptr(pos), int(pos is not None and pos.dtype == torch.int64),
        pos.stride(0) if pos is not None else 0, ptr(inv_freq), ptr(page_of), ptr(off), ptr(tables),
        ptr(cursor), mode, int(rope), quant,
        FLOAT_CODES.get(k.dtype, 0) if rope else 0, k_dst.element_size(), b,
        q.shape[1] if q is not None else 0, hkv, d, k_dst.shape[1], n_slots, w, layer, t, *strides,
        _ptr(build.error_flag(PAGE_OPS, k_dst.device)), _stream(k_dst))
    build.check(PAGE_OPS, code)
    return q_out


def rope_write_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                  inv_freq: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  layer: int, *, tables: Optional[torch.Tensor] = None,
                  cursor: Optional[torch.Tensor] = None, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None, check: bool = True,
                  cursors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode token's RoPE and K/V write for one layer: q ``[B, H, D]``
    and k ``[B, Hkv, D]`` turned by ``pos [B]`` (int32 or int64, any stride)
    and ``inv_freq [D / 2]`` (:func:`rope_inv_freq`), K and v ``[B, Hkv, D]``
    written in place either into the paged pools ``[L, P, Hkv, ps, D]``
    through ``tables [B, W]`` at the slot ``pos`` (int8 pools with their f32
    scale pools ``[L, P, Hkv, ps]``, quantized by :func:`quant_rows`) or into
    the contiguous cache ``[L, B, S, Hkv, D]`` at ``cursor`` (int64 ``[1]``;
    an int8 cache with its f32 scales ``[L, B, S, Hkv, 1]``, quantized by
    :func:`kv_quantize`) or at one cursor per cache row, ``cursors`` (int64
    ``[Bc]``, the slot engine's): ``B = Bc * T`` rows, ``T`` tokens of each
    cache row at slots ``cursors + [0, T)``, the cache ``[L, Bc, S, Hkv, D]``
    any view whose rows are ``D`` contiguous elements (a window ``[:, :, :W]``
    of it), a slot at or past its ``S`` dropped: not written, no error, the
    other rows written. Returns q turned,
    ``[B, H, D]`` contiguous. A CPU tensor takes :func:`rope_write_kv_ref`; a
    CUDA tensor launches K8a (one launch) or raises. A target outside the
    cache raises ValueError and nothing is written: on the card K8a flags it,
    read as ``check`` says (see :func:`write_token_pages_kernel`)."""
    if sum(x is not None for x in (tables, cursor, cursors)) != 1:
        raise ValueError("give tables= (paged pools), cursors= (the contiguous cache's per-row "
                         "cursors) or cursor= (its shared one)")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or q.shape[::2] != k.shape[::2]:
        raise ValueError(f"q must be [B, H, D] and k, v [B, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hkv, d = k.shape
    if q.shape[1] % hkv or d % 2:
        raise ValueError(f"Hkv must divide H and D be even, got H={q.shape[1]}, Hkv={hkv}, D={d}")
    head_dim = 2 if tables is not None else 3   # [L, P, Hkv, ps, D] or [L, B, S, Hkv, D]
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape or \
            (k_cache.shape[head_dim], k_cache.shape[4]) != (hkv, d):
        raise ValueError(f"caches must be [L, P, Hkv, ps, D] pools or an [L, B, S, Hkv, D] cache "
                         f"with Hkv={hkv}, D={d}; got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    if tables is not None:
        _layer_pools(k_cache, v_cache, k_scale, v_scale, layer)
        if tables.dim() != 2 or tables.shape[0] != b or tables.dtype != torch.int32:
            raise ValueError(f"tables must be int32 [{b}, W], got {tuple(tables.shape)} "
                             f"{tables.dtype}")
    else:
        if (k_scale is None) != (v_scale is None) or \
                (k_cache.dtype == torch.int8) != (k_scale is not None):
            raise ValueError("an int8 contiguous cache needs k_scale/v_scale, and only an int8 "
                             "cache takes them")
        if k_scale is not None:
            want = tuple(k_cache.shape[:4]) + (1,)
            for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
                if tuple(sc.shape) != want or sc.dtype != torch.float32:
                    raise ValueError(f"{name} must be f32 {want}, got {tuple(sc.shape)} "
                                     f"{sc.dtype}")
        if cursors is not None:
            bc = k_cache.shape[1]
            if tuple(cursors.shape) != (bc,) or cursors.dtype != torch.int64 or b % bc or \
                    k_cache.stride(4) != 1 or v_cache.stride(4) != 1:
                raise ValueError(f"per-row cursors: int64 [Bc] for an [L, Bc, S, Hkv, D] cache "
                                 f"with unit-stride rows and Bc dividing the {b} rows, got "
                                 f"{tuple(cursors.shape)} {cursors.dtype} and "
                                 f"{tuple(k_cache.shape)}")
        elif k_cache.shape[1] != b or tuple(cursor.shape) != (1,) or cursor.dtype != torch.int64:
            raise ValueError(f"a [L, {b}, S, Hkv, D] cache and an int64 [1] cursor, got "
                             f"{tuple(k_cache.shape)} and {tuple(cursor.shape)} {cursor.dtype}")
        if not 0 <= layer < k_cache.shape[0]:
            raise ValueError(f"layer {layer} out of range for {k_cache.shape[0]}-layer caches")
    if pos.dim() != 1 or pos.shape[0] != b or pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"pos must be int32 or int64 [{b}], got {tuple(pos.shape)} {pos.dtype}")
    if tuple(inv_freq.shape) != (d // 2,) or inv_freq.dtype != torch.float32:
        raise ValueError(f"inv_freq must be f32 [{d // 2}], got {tuple(inv_freq.shape)} "
                         f"{inv_freq.dtype}")
    if q.device.type == "cpu":
        return rope_write_kv_ref(q, k, v, pos, inv_freq, k_cache, v_cache, layer, tables, cursor,
                                 k_scale, v_scale, cursors)
    _require_cuda("K8a", q)
    if q.dtype not in FLOAT_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must be one of f32, f16, bf16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k_cache.dtype != q.dtype and k_cache.dtype != torch.int8:
        raise ValueError(f"caches must have q's dtype {q.dtype} (or int8), got "
                         f"{k_cache.dtype}")
    if d > 256:
        raise NotImplementedError(f"K8a turns head dims up to 256, got {d}")
    if cursors is None:
        _check_on(q.device, q=q, k=k, v=v, inv_freq=inv_freq, k_cache=k_cache, v_cache=v_cache,
                  k_scale=k_scale, v_scale=v_scale, tables=tables, cursor=cursor)
    else:   # a window of the cache: one set of strides for K and V, the scales' those over D
        _check_on(q.device, q=q, k=k, v=v, inv_freq=inv_freq, cursors=cursors)
        st = k_cache.stride()
        sc = None if k_scale is None else tuple(x // d for x in st[:4]) + (1,)
        if v_cache.stride() != st or any(x % d for x in st[:4]) or (sc is not None and (
                k_scale.stride() != sc or v_scale.stride() != sc)):
            raise ValueError("per-row cursors take K and V caches of one layout (a window of "
                             "contiguous caches) and scales laid out as the caches over D")
        for name, x in (("k_cache", k_cache), ("v_cache", v_cache), ("k_scale", k_scale),
                        ("v_scale", v_scale)):
            if x is not None and x.device != q.device:
                raise ValueError(f"{name} must be on {q.device}")
    if pos.device != q.device:
        raise ValueError(f"pos must be on {q.device}")
    if tables is not None:   # the kernel's (layer, page, head, slot) strides: the pools' own
        q_out = _kv_write(MODE_TABLES, k_cache, v_cache, layer, k, v, q=q, pos=pos,
                          inv_freq=inv_freq, tables=tables, k_scale=k_scale, v_scale=v_scale,
                          quant=QUANT_PAGED if k_scale is not None else QUANT_NONE,
                          n_slots=k_cache.shape[3], w=tables.shape[1])
    else:   # [L, B, S, Hkv, D]: (layer, row, head, slot) strides; the scales index as D = 1
        rows = cursors is not None
        q_out = _kv_write(MODE_ROW_CURSOR if rows else MODE_CURSOR, k_cache.transpose(2, 3),
                          v_cache.transpose(2, 3), layer, k, v, q=q, pos=pos, inv_freq=inv_freq,
                          cursor=cursors if rows else cursor, k_scale=k_scale, v_scale=v_scale,
                          quant=QUANT_CONTIG if k_scale is not None else QUANT_NONE,
                          n_slots=k_cache.shape[2], t=b // k_cache.shape[1] if rows else 1)
    build.launches["rope_write_kv"] += 1
    if check:
        check_page_errors(q.device)
    return q_out


def write_token_pages_kernel(k_pool: torch.Tensor, v_pool: torch.Tensor, layer: int,
                             page_of: torch.Tensor, off: torch.Tensor, krows: torch.Tensor,
                             vrows: torch.Tensor, *, check: bool = True):
    """``pool[layer, page_of[b], :, off[b]] = rows[b]`` for both pools of one
    layer, in place; returns ``(k_pool, v_pool)``. Pools are 5-D K/V pools
    (rows ``[B, Hkv, D]``) or 4-D scale pools (rows ``[B, Hkv]``), of any
    dtype; rows are cast to it. A CPU tensor takes the plain version; a CUDA
    tensor launches K8a with the rotation off (one launch for both pools) or
    raises. A target outside the pool raises ValueError and nothing is
    written: on the card K8a flags it, ``check=True`` reads the flag at once
    (a wait for the card), and with ``check=False`` the caller reads it later
    through :func:`check_page_errors`."""
    _check_pool_pair(k_pool, v_pool)
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range for {k_pool.shape[0]}-layer pools")
    b = page_of.shape[0]
    hkv = k_pool.shape[2]
    want = (b, hkv) if k_pool.dim() == 4 else (b, hkv, k_pool.shape[4])
    if tuple(krows.shape) != want or tuple(vrows.shape) != want:
        raise ValueError(f"rows must be {want}, got {tuple(krows.shape)} and {tuple(vrows.shape)}")
    for name, t in (("page_of", page_of), ("off", off)):
        if tuple(t.shape) != (b,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{b}], got {tuple(t.shape)} {t.dtype}")
    if k_pool.device.type == "cpu":
        write_token_pages(k_pool, layer, page_of, off, krows)
        write_token_pages(v_pool, layer, page_of, off, vrows)
        return k_pool, v_pool
    _require_cuda("K8a", k_pool)
    krows = krows.to(k_pool.dtype).contiguous()
    vrows = vrows.to(v_pool.dtype).contiguous()
    _check_on(k_pool.device, k_pool=k_pool, v_pool=v_pool, krows=krows, vrows=vrows,
              page_of=page_of, off=off)
    _kv_write(MODE_ROWS, k_pool, v_pool, layer, krows, vrows, page_of=page_of, off=off,
              n_slots=k_pool.shape[3])
    build.launches["write_token_pages"] += 1
    if check:
        check_page_errors(k_pool.device)
    return k_pool, v_pool


def copy_pages_pair(k_pool: torch.Tensor, v_pool: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, *, check: bool = True):
    """``pool[:, dst[i]] = pool[:, src[i]]`` for both pools, every read before
    any write, so a ``src`` may name another copy's ``dst``. Pools are 5-D
    K/V pools or 4-D scale pools, in place; returns ``(k_pool, v_pool)``. A
    CPU tensor takes the plain version; a CUDA tensor launches K8b or raises:
    one launch of a cluster per (layer, pool) where :func:`copy_plan` finds
    one (launch key ``copy_pages_pair``; the pools 16-byte aligned), else a
    gather of every ``src`` page into scratch and a scatter to ``dst`` (key
    ``copy_pages_pair_gather``). A page id outside the pool or a repeated
    ``dst`` raises ValueError and nothing is copied; ``check`` is as for
    :func:`write_token_pages_kernel`."""
    _check_pool_pair(k_pool, v_pool)
    if src.dim() != 1 or src.shape != dst.shape or src.dtype != torch.int32 \
            or dst.dtype != torch.int32:
        raise ValueError(f"src and dst must be int32 [n], got {tuple(src.shape)} {src.dtype} "
                         f"and {tuple(dst.shape)} {dst.dtype}")
    if k_pool.device.type == "cpu":
        return copy_pages(k_pool, src, dst), copy_pages(v_pool, src, dst)
    _require_cuda("K8b", k_pool)
    _check_on(k_pool.device, k_pool=k_pool, v_pool=v_pool, src=src, dst=dst)
    n_layers, n_pages = k_pool.shape[:2]
    n = src.shape[0]
    page_bytes = k_pool[0, 0].numel() * k_pool.element_size()
    err = _ptr(build.error_flag(PAGE_OPS, k_pool.device))
    slices = copy_plan(n, page_bytes)
    if slices:
        if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
            raise ValueError("K8b's pools must be 16-byte aligned")
        code = _page_fn("copy_pages_cluster")(
            _ptr(k_pool), _ptr(v_pool), _ptr(src), _ptr(dst), n_layers, n_pages, n, page_bytes,
            slices, err, _stream(k_pool))
        key = "copy_pages_pair"
    else:
        k_scr = torch.empty((n_layers, n, page_bytes), dtype=torch.uint8, device=k_pool.device)
        v_scr = torch.empty_like(k_scr)
        unit = _unit(page_bytes, k_pool, v_pool, k_scr, v_scr)
        code = _page_fn("copy_pages")(
            _ptr(k_pool), _ptr(v_pool), _ptr(k_scr), _ptr(v_scr), _ptr(src), _ptr(dst), n_layers,
            n_pages, n, page_bytes, unit, err, _stream(k_pool))
        key = "copy_pages_pair_gather"
    build.check(PAGE_OPS, code)
    build.launches[key] += 1
    if check:
        check_page_errors(k_pool.device)
    return k_pool, v_pool


__all__ = [
    "check_page_errors",
    "copy_pages",
    "copy_pages_pair",
    "copy_plan",
    "kv_quantize",
    "paged_attention_mh",
    "paged_attention_mh_ref",
    "quant_rows",
    "rope_inv_freq",
    "rope_rows",
    "rope_write_kv",
    "rope_write_kv_ref",
    "split_plan",
    "write_token_pages",
    "write_token_pages_kernel",
]
