"""K8a's fused RoPE + K/V write and K8b's plain page copy
(``autogptq_tpu_torch.ops.paged_attn``) on the CPU against the JAX package.

The port's plain fused function (``rope_write_kv_ref``, which
``rope_write_kv`` runs for CPU tensors) against JAX's ``arch.apply_rope``
followed by ``paged_attn.write_token_pages`` (paged pools, through the page
tables) or a slot assignment (the contiguous cache at the cursor), and for int8
pools against the JAX package's paged int8 scheme (``_quant`` inside
``utils/generation.py:_generate_beam_paged``, restated here with jnp): GQA
(H/Hkv 32/8) and MHA, head dims 64 and 128, positions up to 600. Tolerances:
f32 rows within 1e-5 (the two frameworks' f32 sin and cos at angles up to
600 rad differ in the last bits; the rotation is a few f32 products); bf16 rows
within one bf16 ulp of the rotated value (those bits can move one rounding);
int8 codes within one code, scales within 1e-6 relative (the same bits); V rows
and every untouched element exact. K8b's plain ``copy_pages`` with a
self-copy and a swap cycle against JAX's ``copy_pages`` and its Pallas pair in
interpret mode, bit for bit. ``copy_plan`` from shapes alone. The kernels'
own checks on the card are in ``tests/test_torch_cuda_kernels.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.ops.pallas import paged_attn as jpa
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.ops import paged_attn as tpa

THETA = 10000.0
PS = 16
SHAPES = [(32, 8, 128), (32, 8, 64), (4, 4, 64)]   # (H, Hkv, D)


def _rows(rng, b, h, hkv, d, dtype):
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32) for n in (h, hkv, hkv))
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return t, [a.float().numpy() for a in t]        # the rounded values, for JAX in f32


def _jax_rope(q, k, pos, d):
    jcfg = jarch.ArchConfig(head_dim=d, rope_theta=THETA)
    jq, jk = jarch.apply_rope(jnp.asarray(q)[:, None], jnp.asarray(k)[:, None],
                              jnp.asarray(pos)[:, None], jcfg)
    return np.asarray(jq[:, 0]), np.asarray(jk[:, 0])


def _jax_quant(x):
    """The JAX package's paged int8 scheme (utils/generation.py:613-617)."""
    s = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True), 1e-8)
    q = jnp.rint(x.astype(jnp.float32) * (127.5 / s))
    return np.asarray(jnp.clip(q, -127, 127).astype(jnp.int8)), np.asarray(s)


def _paged_case(rng, b, hkv, d, w=40, layers=2):
    """Pools of ``b * w + 1`` pages (page 0 the null page), row b owning pages
    1 + b * w .. (b + 1) * w, positions up to 600."""
    n_pages = b * w + 1
    tables = (1 + np.arange(b)[:, None] * w + np.arange(w)[None]).astype(np.int32)
    pos = np.array([0, 599, 257, 16, 31, 600, 3, 100][:b], np.int32)
    shape = (layers, n_pages, hkv, PS, d)
    return shape, tables, pos


def _close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:   # one bf16 ulp of the value
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("h, hkv, d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_paged_write_matches_jax(h, hkv, d, dtype):
    rng = np.random.default_rng(h + d)
    b, layer = 4, 1
    (q, k, v), (qf, kf, vf) = _rows(rng, b, h, hkv, d, dtype)
    shape, tables, pos = _paged_case(rng, b, hkv, d)
    kpool = rng.standard_normal(shape).astype(np.float32)
    vpool = rng.standard_normal(shape).astype(np.float32)
    tk, tv = (torch.from_numpy(a).to(dtype) for a in (kpool, vpool))
    before_k, before_v = tk.clone(), tv.clone()
    inv = tpa.rope_inv_freq(THETA, d, "cpu")
    qr = tpa.rope_write_kv(q, k, v, torch.from_numpy(pos), inv, tk, tv, layer,
                           tables=torch.from_numpy(tables))
    jq, jk = _jax_rope(qf, kf, pos, d)
    page_of, off = tables[np.arange(b), pos // PS], (pos % PS).astype(np.int32)
    want_k = np.asarray(jpa.write_token_pages(jnp.asarray(before_k.float().numpy()), layer,
                                              jnp.asarray(page_of), jnp.asarray(off),
                                              jnp.asarray(jk)))
    want_v = np.asarray(jpa.write_token_pages(jnp.asarray(before_v.float().numpy()), layer,
                                              jnp.asarray(page_of), jnp.asarray(off),
                                              jnp.asarray(vf)))
    assert qr.shape == (b, h, d) and qr.dtype == dtype and qr.is_contiguous()
    _close(qr.float().numpy(), jq, dtype)
    _close(tk.float().numpy(), want_k, dtype)
    np.testing.assert_array_equal(tv.float().numpy(), want_v)      # V copied, not turned
    written = np.zeros(shape, bool)
    written[layer, page_of, :, off] = True
    np.testing.assert_array_equal(tk.float().numpy()[~written], before_k.float().numpy()[~written])


@pytest.mark.parametrize("h, hkv, d", SHAPES[:2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_int8_write_matches_jax_quant(h, hkv, d, dtype):
    rng = np.random.default_rng(7 + d)
    b, layer = 4, 0
    (q, k, v), (qf, kf, vf) = _rows(rng, b, h, hkv, d, dtype)
    shape, tables, pos = _paged_case(rng, b, hkv, d)
    kpool = rng.integers(-127, 128, size=shape).astype(np.int8)
    vpool = rng.integers(-127, 128, size=shape).astype(np.int8)
    kscale = rng.uniform(0.1, 2.0, size=shape[:-1]).astype(np.float32)
    vscale = rng.uniform(0.1, 2.0, size=shape[:-1]).astype(np.float32)
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (kpool, vpool, kscale, vscale))
    inv = tpa.rope_inv_freq(THETA, d, "cpu")
    tpa.rope_write_kv(q, k, v, torch.from_numpy(pos), inv, tk, tv, layer,
                      tables=torch.from_numpy(tables), k_scale=tks, v_scale=tvs)
    _, jk = _jax_rope(qf, kf, pos, d)
    jk = np.asarray(jnp.asarray(jk).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                           else jnp.float32))     # rounded as the cache rows
    page_of, off = tables[np.arange(b), pos // PS], (pos % PS).astype(np.int32)
    for got, got_s, pool, scale, rows in ((tk, tks, kpool, kscale, jk), (tv, tvs, vpool, vscale, vf)):
        codes, s = _jax_quant(jnp.asarray(rows))
        want = np.asarray(jpa.write_token_pages(jnp.asarray(pool), layer, jnp.asarray(page_of),
                                                jnp.asarray(off), jnp.asarray(codes)))
        want_s = np.asarray(jpa.write_token_pages(jnp.asarray(scale), layer, jnp.asarray(page_of),
                                                  jnp.asarray(off), jnp.asarray(s)))
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        rows_diff = diff[layer, page_of, :, off]         # the written rows; the rest exact
        assert diff.max() <= 1 and diff.sum() == rows_diff.sum() and (rows_diff > 0).mean() < 0.02
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6, atol=0)


@pytest.mark.parametrize("h, hkv, d", SHAPES)
@pytest.mark.parametrize("pos_dtype", [torch.int64, torch.int32])
def test_fused_cursor_write_matches_jax(h, hkv, d, pos_dtype):
    rng = np.random.default_rng(3 * h + d)
    b, s, layer, cursor = 3, 640, 1, 599
    (q, k, v), (qf, kf, vf) = _rows(rng, b, h, hkv, d, torch.float32)
    cache_k = rng.standard_normal((2, b, s, hkv, d)).astype(np.float32)
    cache_v = rng.standard_normal((2, b, s, hkv, d)).astype(np.float32)
    tk, tv = torch.from_numpy(cache_k.copy()), torch.from_numpy(cache_v.copy())
    pos = np.array([599, 580, 17])              # left padding: positions below the slot
    qr = tpa.rope_write_kv(q, k, v, torch.from_numpy(pos).to(pos_dtype),
                           tpa.rope_inv_freq(THETA, d, "cpu"), tk, tv, layer,
                           cursor=torch.tensor([cursor]))
    jq, jk = _jax_rope(qf, kf, pos, d)
    cache_k[layer, :, cursor], cache_v[layer, :, cursor] = jk, vf
    _close(qr.numpy(), jq, torch.float32)
    _close(tk.numpy(), cache_k, torch.float32)
    np.testing.assert_array_equal(tv.numpy(), cache_v)


def test_fused_rotation_is_apply_rope():
    """The fused function's rotation is ``arch.apply_rope``'s, bit for bit
    (one plain version for the decode steps and the prefill)."""
    rng = np.random.default_rng(11)
    (q, k, _), _ = _rows(rng, 4, 32, 8, 128, torch.bfloat16)
    pos = torch.tensor([0, 7, 300, 600])
    cfg = arch.ArchConfig(num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=THETA)
    want_q, want_k = arch.apply_rope(q[:, None], k[:, None], pos[:, None], cfg)
    inv = tpa.rope_inv_freq(THETA, 128, "cpu")
    got_q, got_k = tpa.rope_rows(pos, inv, q, k)
    assert torch.equal(got_q, want_q[:, 0]) and torch.equal(got_k, want_k[:, 0])


def test_fused_write_refuses_bad_targets():
    rng = np.random.default_rng(5)
    b, h, hkv, d = 4, 8, 4, 64
    (q, k, v), _ = _rows(rng, b, h, hkv, d, torch.float32)
    shape, tables, pos = _paged_case(rng, b, hkv, d, w=4)
    inv = tpa.rope_inv_freq(THETA, d, "cpu")
    pos = np.array([0, 5, 63, 17], np.int32)
    kp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vp = kp.clone()
    want = kp.clone()
    bad_table = tables.copy()
    bad_table[2, 3] = shape[1]                  # row 2 writes ordinal 3: a page past the pool
    cases = [(np.array([0, 5, 64, 17], np.int32), tables),     # past the table's 4 pages
             (np.array([0, -1, 3, 17], np.int32), tables),
             (pos, bad_table)]
    for p, t in cases:
        with pytest.raises(ValueError, match="write targets"):
            tpa.rope_write_kv(q, k, v, torch.from_numpy(p), inv, kp, vp, 1,
                              tables=torch.from_numpy(t))
        assert torch.equal(kp, want) and torch.equal(vp, want)
    cache = torch.zeros((2, b, 8, hkv, d))
    with pytest.raises(ValueError, match="write targets"):
        tpa.rope_write_kv(q, k, v, torch.zeros(b, dtype=torch.int64), inv, cache, cache.clone(),
                          0, cursor=torch.tensor([8]))
    with pytest.raises(ValueError, match="tables= .* or cursor="):
        tpa.rope_write_kv(q, k, v, torch.from_numpy(pos), inv, kp, vp, 1)
    with pytest.raises(ValueError, match="Hkv=4, D=64"):
        tpa.rope_write_kv(q, k, v, torch.from_numpy(pos), inv, cache, cache, 1,
                          tables=torch.from_numpy(tables))
    with pytest.raises(ValueError, match="inv_freq"):
        tpa.rope_write_kv(q, k, v, torch.from_numpy(pos), inv[:-1], kp, vp, 1,
                          tables=torch.from_numpy(tables))


@pytest.mark.parametrize("src, dst", [
    ([3, 5, 7], [5, 3, 7]),                     # a swap cycle and a self-copy
    ([2, 4, 6, 2], [4, 6, 2, 8]),               # a 3-cycle through dst, and a src read twice
    ([1, 1, 1], [1, 2, 3]),                     # a self-copy whose page is another copy's src
])
@pytest.mark.parametrize("dtype, rank", [(np.float32, 5), (np.int8, 5), (np.float32, 4)])
def test_page_copy_cycles_match_jax(src, dst, dtype, rank):
    rng = np.random.default_rng(len(src) + rank)
    shape = (3, 9, 4, 8) + ((16,) if rank == 5 else ())
    if dtype == np.int8:
        kpool = rng.integers(-127, 128, size=shape).astype(np.int8)
    else:
        kpool = rng.standard_normal(shape).astype(dtype)
    vpool = kpool[:, ::-1].copy()
    s, d = np.array(src, np.int32), np.array(dst, np.int32)
    tk, tv = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    tpa.copy_pages_pair(tk, tv, torch.from_numpy(s), torch.from_numpy(d))
    want_k = np.asarray(jpa.copy_pages(jnp.asarray(kpool), jnp.asarray(s), jnp.asarray(d)))
    want_v = np.asarray(jpa.copy_pages(jnp.asarray(vpool), jnp.asarray(s), jnp.asarray(d)))
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tv.numpy(), want_v)
    np.testing.assert_array_equal(want_k[:, d], kpool[:, s])        # every read before a write
    if rank == 5:
        jk, jv = jpa.copy_pages_pair(jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(s),
                                     jnp.asarray(d), interpret=True)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n, page_bytes, slices", [
    (4, 32 * 16 * 128 * 2, 2),      # Llama-2-7B bf16 pools at beam 4: 8 blocks of 64 KiB
    (4, 32 * 16 * 128, 1),          # its int8 pools: 4 blocks of 64 KiB
    (4, 32 * 16 * 4, 1),            # its f32 scale pools
    (4, 8 * 16 * 128 * 2, 1),       # Mixtral-8x7B's 8 KV heads
    (8, 32 * 16 * 128 * 2, 2),      # beam 8 (or batch 2 at beam 4): 16 blocks, non-portable
    (16, 8 * 16 * 128 * 2, 1),
    (12, 32 * 16 * 128 * 2, 0),     # 24 blocks: the gather and scatter kernels
    (17, 4 * 16 * 16 * 4, 0),
    (4, 24, 0),                     # not a whole number of 16-byte units
    (2, 240 << 10, 4),              # 240 KiB pages: 4 slices of 60 KiB, 8 blocks
])
def test_copy_plan(n, page_bytes, slices):
    assert tpa.copy_plan(n, page_bytes) == slices
    if slices:
        assert n * slices <= tpa.COPY_MAX_CLUSTER
        assert page_bytes % (16 * slices) == 0 and page_bytes // slices <= tpa.COPY_SLICE_MAX
