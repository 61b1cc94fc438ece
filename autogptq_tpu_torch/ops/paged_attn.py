"""K7 and K8: decode attention over a paged KV cache, and the page-pool updates.

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
* K8a ``write_token_pages_kernel`` (``csrc/page_ops.cu``; plain:
  ``write_token_pages``) replaces ``paged_attn.py:write_token_pages_kernel``;
* K8b ``copy_pages_pair`` (``csrc/page_ops.cu``; plain: ``copy_pages``)
  replaces ``paged_attn.py:copy_pages_pair``.

A wrapper runs the plain version for CPU tensors and launches its kernel, or
raises, for CUDA tensors. The JAX functions return new arrays; the port's
writes and copies update the pools in place and return them as well. Unlike
the JAX package, the kernels also take int8 pools and 4-D scale pools, so no
plain version runs on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

ATTN = "paged_attn"
PAGE_OPS = "page_ops"
NEG_INF = -1e30
FLOAT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
INT8_CODE = 3
HEAD_DIMS = (64, 128, 256)
REPS = (1, 2, 4, 8)
MAX_REP_TIMES_D = 1024    # the kernel's shared merge buffer holds 8 warps x rep x D floats


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


WRITE_TARGET_MSG = "write targets must lie in the pool: page_of in [0, P) and off in [0, ps)"
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
                       + [ctypes.c_float, ctypes.c_void_p])
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
    launches K7 or raises. K7 reads only each row's live pages
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
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    null = ctypes.c_void_p(0)
    code = _attn_fn()(
        _ptr(q), _ptr(k_pages), _ptr(v_pages),
        null if k_scales is None else _ptr(k_scales), null if v_scales is None else _ptr(v_scales),
        _ptr(lengths), _ptr(tables), _ptr(out),
        FLOAT_CODES[q.dtype], kv_code, b, n_layers, n_pages, hkv, ps, d, rep, tables.shape[1],
        layer if stacked else 0, float(sm_scale), _stream(q))
    build.check(ATTN, code)
    build.launches["paged_attention_mh"] += 1
    return out


def check_page_errors(device) -> None:
    """Raise ValueError if a K8a or K8b launch on ``device`` since the last
    check was given a bad id (a write target outside the pool, a page id
    outside it, a repeated ``dst``); such a launch wrote nothing. Reading the
    flag waits for the card, so the beam path checks once per generate. On
    the CPU the plain versions raise at once and this does nothing."""
    bits = build.take_error_bits(PAGE_OPS, device)
    if bits:
        raise ValueError("; ".join(msg for bit, msg in _ERR_MESSAGES if bits & bit))


def _page_fn(name: str):
    fn = getattr(build.load(PAGE_OPS), name)
    if fn.argtypes is None:
        if name == "write_token_rows":
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        else:   # copy_pages
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def write_token_pages_kernel(k_pool: torch.Tensor, v_pool: torch.Tensor, layer: int,
                             page_of: torch.Tensor, off: torch.Tensor, krows: torch.Tensor,
                             vrows: torch.Tensor, *, check: bool = True):
    """``pool[layer, page_of[b], :, off[b]] = rows[b]`` for both pools of one
    layer, in place; returns ``(k_pool, v_pool)``. Pools are 5-D K/V pools
    (rows ``[B, Hkv, D]``) or 4-D scale pools (rows ``[B, Hkv]``), of any
    dtype; rows are cast to it. A CPU tensor takes the plain version; a CUDA
    tensor launches K8a (one launch for both pools) or raises. A target
    outside the pool raises ValueError and nothing is written: on the card
    K8a flags it, ``check=True`` reads the flag at once (a wait for the
    card), and with ``check=False`` the caller reads it later through
    :func:`check_page_errors`."""
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
    row_bytes = (k_pool.shape[4] if k_pool.dim() == 5 else 1) * k_pool.element_size()
    unit = _unit(row_bytes, k_pool, v_pool, krows, vrows)
    code = _page_fn("write_token_rows")(
        _ptr(k_pool), _ptr(v_pool), _ptr(krows), _ptr(vrows), _ptr(page_of), _ptr(off),
        b, k_pool.shape[1], hkv, k_pool.shape[3], row_bytes, layer, unit,
        _ptr(build.error_flag(PAGE_OPS, k_pool.device)), _stream(k_pool))
    build.check(PAGE_OPS, code)
    build.launches["write_token_pages"] += 1
    if check:
        check_page_errors(k_pool.device)
    return k_pool, v_pool


def copy_pages_pair(k_pool: torch.Tensor, v_pool: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, *, check: bool = True):
    """``pool[:, dst[i]] = pool[:, src[i]]`` for both pools, every read before
    any write, so a ``src`` may name another copy's ``dst``. Pools are 5-D
    K/V pools or 4-D scale pools, in place; returns ``(k_pool, v_pool)``. A
    CPU tensor takes the plain version; a CUDA tensor launches K8b (a gather
    of every ``src`` page into scratch, then a scatter to ``dst``) or
    raises. A page id outside the pool or a repeated ``dst`` raises
    ValueError and nothing is copied; ``check`` is as for
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
    k_scr = torch.empty((n_layers, n, page_bytes), dtype=torch.uint8, device=k_pool.device)
    v_scr = torch.empty_like(k_scr)
    unit = _unit(page_bytes, k_pool, v_pool, k_scr, v_scr)
    code = _page_fn("copy_pages")(
        _ptr(k_pool), _ptr(v_pool), _ptr(k_scr), _ptr(v_scr), _ptr(src), _ptr(dst), n_layers,
        n_pages, n, page_bytes, unit, _ptr(build.error_flag(PAGE_OPS, k_pool.device)),
        _stream(k_pool))
    build.check(PAGE_OPS, code)
    build.launches["copy_pages_pair"] += 1
    if check:
        check_page_errors(k_pool.device)
    return k_pool, v_pool


__all__ = [
    "check_page_errors",
    "copy_pages",
    "copy_pages_pair",
    "paged_attention_mh",
    "paged_attention_mh_ref",
    "write_token_pages",
    "write_token_pages_kernel",
]
