"""The port's paged attention and page-pool updates
(autogptq_tpu_torch.ops.paged_attn) on the CPU against the JAX package's
ops/pallas/paged_attn.py: the plain versions against JAX's references and its
Pallas kernels in interpret mode. Attention within 1e-5 (f32 on both sides,
summation order differs); writes and copies bit-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.ops.pallas import paged_attn as jpa
from autogptq_tpu_torch.ops import paged_attn as tpa


def _attn_case(seed, b=3, h=8, hkv=4, d=64, ps=8, n_pages=11, w=4, layers=None, quant=False):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    q = (rng.standard_normal((b, h, d)) * 0.5).astype(np.float32)
    shape = lead + (n_pages, hkv, ps, d)
    if quant:
        kp = rng.integers(-127, 128, size=shape).astype(np.int8)
        vp = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.1, 2.0, size=shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.1, 2.0, size=shape[:-1]).astype(np.float32)
    else:
        kp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        vp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        ks = vs = None
    # unequal lengths: one token into a page, a full table, a mid-page end
    lengths = np.array([1, w * ps, 2 * ps + 3][:b], np.int32)
    tables = rng.integers(0, n_pages, size=(b, w)).astype(np.int32)
    return q, kp, vp, lengths, tables, ks, vs


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("h, hkv", [(8, 8), (8, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("quant", [False, True])
def test_attention_matches_jax_reference_and_kernel(h, hkv, quant):
    q, kp, vp, lengths, tables, ks, vs = _attn_case(h * 10 + hkv, h=h, hkv=hkv, quant=quant)
    scale = 64 ** -0.5
    got = tpa.paged_attention_mh(*map(_t, (q, kp, vp, lengths, tables, ks, vs)),
                                 sm_scale=scale).numpy()
    ref = np.asarray(jpa.paged_attention_mh_ref(*map(_j, (q, kp, vp, lengths, tables, ks, vs)),
                                                sm_scale=scale))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    kern = np.asarray(jpa.paged_attention_mh(*map(_j, (q, kp, vp, lengths, tables, ks, vs)),
                                             sm_scale=scale, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_stacked_pools_read_the_given_layer(quant):
    q, kp, vp, lengths, tables, ks, vs = _attn_case(7, layers=3, quant=quant)
    scale = 0.2
    for layer in range(3):
        got = tpa.paged_attention_mh(*map(_t, (q, kp, vp, lengths, tables, ks, vs)),
                                     sm_scale=scale, layer=layer).numpy()
        sl = [None if a is None else a[layer] for a in (kp, vp, ks, vs)]
        ref = np.asarray(jpa.paged_attention_mh_ref(_j(q), _j(sl[0]), _j(sl[1]), _j(lengths),
                                                    _j(tables), _j(sl[2]), _j(sl[3]),
                                                    sm_scale=scale))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    kern = np.asarray(jpa.paged_attention_mh(*map(_j, (q, kp, vp, lengths, tables, ks, vs)),
                                             sm_scale=scale, interpret=True, layer=layer))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


def test_attention_refuses_what_the_kernel_would_misread():
    q, kp, vp, lengths, tables, _, _ = _attn_case(1, layers=2)
    args = [torch.from_numpy(a) for a in (q, kp, vp, lengths, tables)]
    with pytest.raises(ValueError, match="out of range"):
        tpa.paged_attention_mh(*args, sm_scale=0.1, layer=2)
    with pytest.raises(ValueError, match="required"):
        tpa.paged_attention_mh(*args, sm_scale=0.1)
    flat = [args[0], args[1][0], args[2][0], args[3], args[4]]
    with pytest.raises(ValueError, match="4-D"):       # the JAX kernel ignores layer= here
        tpa.paged_attention_mh(*flat, sm_scale=0.1, layer=0)
    with pytest.raises(ValueError, match="divide"):
        tpa.paged_attention_mh(args[0][:, :6], *flat[1:], sm_scale=0.1)
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_attention_mh(*flat, flat[1][..., 0], flat[1][..., 0], sm_scale=0.1)


def _pool_case(seed, dtype, rank=5, layers=3, n_pages=9, hkv=4, ps=8, d=16, b=4):
    rng = np.random.default_rng(seed)
    shape = (layers, n_pages, hkv, ps) + ((d,) if rank == 5 else ())
    row_shape = (b, hkv) + ((d,) if rank == 5 else ())
    if dtype == np.int8:
        pool = rng.integers(-127, 128, size=shape).astype(np.int8)
        rows = rng.integers(-127, 128, size=row_shape).astype(np.int8)
    else:
        pool = rng.standard_normal(shape).astype(dtype)
        rows = rng.standard_normal(row_shape).astype(dtype)
    page_of = rng.permutation(n_pages)[:b].astype(np.int32)     # each row owns its page
    off = rng.integers(0, ps, size=b).astype(np.int32)
    return pool, rows, page_of, off


@pytest.mark.parametrize("dtype, rank", [(np.float32, 5), (np.int8, 5), (np.float32, 4)])
def test_token_writes_are_bit_exact(dtype, rank):
    kpool, krows, page_of, off = _pool_case(3, dtype, rank)
    vpool, vrows, _, _ = _pool_case(4, dtype, rank)
    layer = 1
    want_k = np.asarray(jpa.write_token_pages(jnp.asarray(kpool), layer, jnp.asarray(page_of),
                                              jnp.asarray(off), jnp.asarray(krows)))
    got = tpa.write_token_pages(torch.from_numpy(kpool.copy()), layer,
                                torch.from_numpy(page_of), torch.from_numpy(off),
                                torch.from_numpy(krows)).numpy()
    np.testing.assert_array_equal(got, want_k)
    # both pools through the kernel wrapper's CPU route
    tk, tv = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    out_k, out_v = tpa.write_token_pages_kernel(tk, tv, layer, torch.from_numpy(page_of),
                                                torch.from_numpy(off), torch.from_numpy(krows),
                                                torch.from_numpy(vrows))
    assert out_k is tk and out_v is tv                    # in place
    want_v = np.asarray(jpa.write_token_pages(jnp.asarray(vpool), layer, jnp.asarray(page_of),
                                              jnp.asarray(off), jnp.asarray(vrows)))
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tv.numpy(), want_v)
    if rank == 5 and dtype == np.float32:                 # the Pallas write, in interpret mode
        jk, jv = jpa.write_token_pages_kernel(jnp.asarray(kpool), jnp.asarray(vpool), layer,
                                              jnp.asarray(page_of), jnp.asarray(off),
                                              jnp.asarray(krows), jnp.asarray(vrows),
                                              interpret=True)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# src[1] is dst[0] and src[2] is dst[1]: every read must see the pool before
# any copy; src[3] == dst[3] copies a page onto itself
SRC = np.array([2, 5, 7, 4], np.int32)
DST = np.array([5, 7, 1, 4], np.int32)


@pytest.mark.parametrize("dtype, rank", [(np.float32, 5), (np.int8, 5), (np.float32, 4)])
def test_page_copies_are_bit_exact_with_aliasing(dtype, rank):
    kpool, _, _, _ = _pool_case(5, dtype, rank)
    vpool, _, _, _ = _pool_case(6, dtype, rank)
    src, dst = torch.from_numpy(SRC), torch.from_numpy(DST)
    want_k = np.asarray(jpa.copy_pages(jnp.asarray(kpool), jnp.asarray(SRC), jnp.asarray(DST)))
    got = tpa.copy_pages(torch.from_numpy(kpool.copy()), src, dst).numpy()
    np.testing.assert_array_equal(got, want_k)
    np.testing.assert_array_equal(want_k[:, DST[1]], kpool[:, SRC[1]])   # not the copied page
    tk, tv = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    tpa.copy_pages_pair(tk, tv, src, dst)
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(
        tv.numpy(), np.asarray(jpa.copy_pages(jnp.asarray(vpool), jnp.asarray(SRC),
                                              jnp.asarray(DST))))
    if rank == 5:                                         # the Pallas pair, in interpret mode
        jk, jv = jpa.copy_pages_pair(jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(SRC),
                                     jnp.asarray(DST), interpret=True)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_page_updates_refuse_bad_indices():
    kpool, krows, page_of, off = _pool_case(8, np.float32)
    tk, tv = torch.from_numpy(kpool), torch.from_numpy(kpool.copy())
    with pytest.raises(ValueError, match="unique"):
        tpa.copy_pages_pair(tk, tv, torch.tensor([1, 2], dtype=torch.int32),
                            torch.tensor([3, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="page ids"):
        tpa.copy_pages_pair(tk, tv, torch.tensor([1, 99], dtype=torch.int32),
                            torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="out of range"):
        tpa.write_token_pages_kernel(tk, tv, 3, torch.from_numpy(page_of), torch.from_numpy(off),
                                     torch.from_numpy(krows), torch.from_numpy(krows))


BAD_IDS = [   # (op, index tensor to spoil, position, value, error); pools have 9 pages of 8 slots
    ("write", "page_of", 0, -1, "write targets"),
    ("write", "page_of", 3, 9, "write targets"),
    ("write", "off", 1, -1, "write targets"),
    ("write", "off", 2, 8, "write targets"),
    ("copy", "src", 0, -1, "page ids"),
    ("copy", "dst", 2, 9, "page ids"),
    ("copy", "dst", 3, 5, "unique"),
]


@pytest.mark.parametrize("op, name, pos, value, match", BAD_IDS)
def test_bad_ids_raise_and_write_nothing(op, name, pos, value, match):
    """A bad id raises before anything is written, in the plain versions and
    the wrappers' CPU routes alike (as the kernels refuse the whole launch);
    a negative id is not read Python-style from the end of the pool."""
    kpool, krows, page_of, off = _pool_case(9, np.float32)
    ids = dict(page_of=page_of, off=off, src=SRC.copy(), dst=DST.copy())
    ids[name][pos] = value
    t = {k: torch.from_numpy(v) for k, v in ids.items()}
    tk, tv = torch.from_numpy(kpool.copy()), torch.from_numpy(kpool.copy())
    rows = torch.from_numpy(krows)
    with pytest.raises(ValueError, match=match):
        if op == "write":
            tpa.write_token_pages_kernel(tk, tv, 1, t["page_of"], t["off"], rows, rows)
        else:
            tpa.copy_pages_pair(tk, tv, t["src"], t["dst"])
    with pytest.raises(ValueError, match=match):
        if op == "write":
            tpa.write_token_pages(tk, 1, t["page_of"], t["off"], rows)
        else:
            tpa.copy_pages(tk, t["src"], t["dst"])
    np.testing.assert_array_equal(tk.numpy(), kpool)
    np.testing.assert_array_equal(tv.numpy(), kpool)
