"""Split-KV decode attention (K2 and K7) on the CPU: the split plans, chosen
from shapes alone, cover every slot once; the plain combine step
(``flash_decode.merge_partials``) fed per-chunk partials computed by plain
torch equals the port's plain versions and the JAX package's Pallas kernels in
interpret mode within 1e-5 (f32 on every side; summation order differs).
Cases: left padding, a parked row (hi > S), chunks wholly outside the live
range, an empty row (zeros), int8 pools and unequal lengths."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.ops.pallas import flash_decode as jfd
from autogptq_tpu.ops.pallas import paged_attn as jpa
from autogptq_tpu_torch.ops import flash_decode as tfd
from autogptq_tpu_torch.ops import paged_attn as tpa

NEG_INF = -1e30


def _chunks(c, n):
    return [(i * c, (i + 1) * c) for i in range(n)]


@pytest.mark.parametrize("b, hkv", [(1, 32), (1, 8), (2, 32), (4, 32), (64, 32)])
def test_k2_plan_covers_every_slot_once(b, hkv):
    for s in range(1, 2049):
        c, n = tfd.split_plan(b, hkv, s)
        assert c > 0 and c % tfd.CHUNK_UNIT == 0 and n <= tfd.MAX_SPLITS
        spans = _chunks(c, n)
        # chunks are disjoint, in order, and together hold [0, s): the last one reaches s
        assert spans[-1][0] < s <= spans[-1][1], (s, c, n)


@pytest.mark.parametrize("ps", [8, 16, 12, 64])
@pytest.mark.parametrize("b, hkv", [(4, 32), (4, 8), (1, 32), (16, 32)])
def test_k7_plan_covers_every_position_in_whole_pages(b, hkv, ps):
    for w in range(1, 2049 // ps + 2):
        c, n = tpa.split_plan(b, hkv, w, ps)
        assert c % ps == 0 and c % tfd.CHUNK_UNIT == 0 and n <= tfd.MAX_SPLITS
        assert (n - 1) * c < w * ps <= n * c, (w, ps, c, n)


def test_plans_take_shapes_only():
    assert list(inspect.signature(tfd.split_plan).parameters) == ["b", "hkv", "s"]
    assert list(inspect.signature(tpa.split_plan).parameters) == ["b", "hkv", "w", "ps"]


def test_plans_fill_the_card_at_the_main_path_shapes_and_not_at_tiny_s():
    two_per_sm = 2 * tfd.SMS
    c, n = tfd.split_plan(1, 32, 16 + 512)            # greedy Llama-2-7B, 528 slots
    assert 1 * 32 * n >= two_per_sm
    c, n = tpa.split_plan(4, 32, 40, 16)              # beam 4: 40 pages of 16 per row
    assert 4 * 32 * n >= two_per_sm and c % 16 == 0
    assert tfd.split_plan(1, 32, 16)[1] == 1
    assert tfd.split_plan(3, 4, tfd.CHUNK_UNIT)[1] == 1
    assert tpa.split_plan(1, 8, 1, 16)[1] == 1


def _partials(scores, mask, vals, c, n):
    """Per-chunk (m, l, acc) of masked f32 softmax attention: ``scores`` and
    ``mask`` [..., S], ``vals`` [..., S, D] (broadcast), chunks of ``c``
    positions; an empty chunk gives (-1e30, 0, 0)."""
    pad = n * c - scores.shape[-1]
    scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    vals = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    sc = scores.unflatten(-1, (n, c))
    mk = mask.unflatten(-1, (n, c))
    m = torch.where(mk, sc, NEG_INF).amax(dim=-1)
    p = torch.where(mk, torch.exp(sc - m[..., None]), 0.0)
    acc = torch.einsum("...nc,...ncd->...nd", p, vals.unflatten(-2, (n, c)))
    return m, p.sum(dim=-1), acc


def _k2_case(seed, b=3, s=96, h=8, hkv=4, d=64, layers=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((layers, b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((layers, b, s, hkv, d)).astype(np.float32)
    lo = np.array([5, 0, 40][:b], np.int32)          # left padding; row 2 starts in chunk 1
    hi = np.array([30, 10_000, 41][:b], np.int32)    # chunks past 30 dead; parked; one slot
    return q, k, v, lo, hi


def _k2_split(q, k, v, lo, hi, layer, scale, c, n):
    b, h, d = q.shape
    hkv = k.shape[3]
    qh = torch.from_numpy(q).reshape(b, hkv, h // hkv, d)
    keys = torch.from_numpy(k[layer]).permute(0, 2, 1, 3)          # [B, Hkv, S, D]
    vals = torch.from_numpy(v[layer]).permute(0, 2, 1, 3)[:, :, None]
    sc = torch.einsum("bhrd,bhsd->bhrs", qh, keys) * scale
    pos = torch.arange(k.shape[2])
    mask = (pos >= torch.from_numpy(lo)[:, None]) & (pos < torch.from_numpy(hi)[:, None])
    m, den, acc = _partials(sc, mask[:, None, None, :].expand_as(sc), vals, c, n)
    return m, den, tfd.merge_partials(m, den, acc).reshape(b, h, d)


@pytest.mark.parametrize("h, hkv", [(8, 4), (8, 8), (8, 1)])
def test_k2_merged_partials_match_plain_and_jax(h, hkv):
    q, k, v, lo, hi = _k2_case(h * 10 + hkv, h=h, hkv=hkv)
    b, s = q.shape[0], k.shape[2]
    c, n = tfd.split_plan(b, hkv, s)
    assert n > 1 and s % c == 0
    scale = 0.15
    m, den, got = _k2_split(q, k, v, lo, hi, 1, scale, c, n)
    assert (den[0, :, :, 1:] == 0).all() and (m[0, :, :, 1:] == NEG_INF).all()  # dead chunks
    assert (den[2, :, :, 0] == 0).all()                                         # before lo
    t = [torch.from_numpy(a) for a in (q, k, v, lo, hi)]
    plain = tfd.flash_decode(*t, layer=1, sm_scale=scale)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    j = [jnp.asarray(a) for a in (q, k, v, lo, hi)]
    kern = np.asarray(jfd.flash_decode(*j, layer=1, sm_scale=scale, sblk=c, hkv=hkv,
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jfd.flash_decode_ref(*j[:3], j[3], jnp.minimum(j[4], s), layer=1,
                                          sm_scale=scale))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_k2_empty_row_merges_to_zeros():
    q, k, v, lo, hi = _k2_case(5)
    lo[1], hi[1] = 50, 50                                   # nothing to attend
    b, s = q.shape[0], k.shape[2]
    c, n = tfd.split_plan(b, 4, s)
    m, den, got = _k2_split(q, k, v, lo, hi, 0, 0.2, c, n)
    assert (m[1] == NEG_INF).all() and (den[1] == 0).all()
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all()
    t = [torch.from_numpy(a) for a in (q, k, v, lo, hi)]
    torch.testing.assert_close(got, tfd.flash_decode(*t, layer=0, sm_scale=0.2), rtol=1e-5,
                               atol=1e-5)
    kern = np.asarray(jfd.flash_decode(*[jnp.asarray(a) for a in (q, k, v, lo, hi)], layer=0,
                                       sm_scale=0.2, sblk=c, hkv=4, interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)


def _k7_case(seed, quant, b=4, h=8, hkv=4, d=64, ps=16, w=6, n_pages=19):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, d)) * 0.5).astype(np.float32)
    shape = (2, n_pages, hkv, ps, d)
    if quant:
        kp = rng.integers(-127, 128, size=shape).astype(np.int8)
        vp = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.1, 2.0, size=shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.1, 2.0, size=shape[:-1]).astype(np.float32)
    else:
        kp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        vp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        ks = vs = None
    # unequal lengths: a full table, a mid-page end in chunk 1, one token, an empty row
    lengths = np.array([w * ps, 2 * ps + 5, 1, 0][:b], np.int32)
    tables = rng.integers(0, n_pages, size=(b, w)).astype(np.int32)
    return q, kp, vp, lengths, tables, ks, vs


def _k7_split(q, kp, vp, lengths, tables, ks, vs, layer, scale, c, n):
    b, h, d = q.shape
    _, n_pages, hkv, ps, _ = kp.shape
    w = tables.shape[1]
    idx = torch.from_numpy(tables).long()
    kg = torch.from_numpy(kp[layer]).float()[idx]                    # [B, W, Hkv, ps, D]
    vg = torch.from_numpy(vp[layer]).float()[idx]
    if ks is not None:
        kg = kg * (torch.from_numpy(ks[layer])[idx] / 127.5)[..., None]
        vg = vg * (torch.from_numpy(vs[layer])[idx] / 127.5)[..., None]
    kg = kg.permute(0, 2, 1, 3, 4).reshape(b, hkv, w * ps, d)
    vg = vg.permute(0, 2, 1, 3, 4).reshape(b, hkv, w * ps, d)[:, :, None]
    sc = torch.einsum("bhrd,bhtd->bhrt", torch.from_numpy(q).reshape(b, hkv, h // hkv, d),
                      kg) * scale
    mask = torch.arange(w * ps)[None, :] < torch.from_numpy(lengths)[:, None]
    m, den, acc = _partials(sc, mask[:, None, None, :].expand_as(sc), vg, c, n)
    return m, den, tfd.merge_partials(m, den, acc).reshape(b, h, d)


def _opt(a, f):
    return None if a is None else f(a)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h, hkv", [(8, 4), (8, 8)])
def test_k7_merged_partials_match_plain_and_jax(quant, h, hkv):
    q, kp, vp, lengths, tables, ks, vs = _k7_case(h + hkv + quant, quant, h=h, hkv=hkv)
    b, ps, w = q.shape[0], kp.shape[3], tables.shape[1]
    c, n = tpa.split_plan(b, hkv, w, ps)
    assert n > 1 and c % ps == 0
    scale = 64 ** -0.5
    m, den, got = _k7_split(q, kp, vp, lengths, tables, ks, vs, 1, scale, c, n)
    assert (den[1, :, :, 2:] == 0).all() and (den[2, :, :, 1:] == 0).all()   # dead chunks
    assert (den[3] == 0).all()                                                 # empty row
    assert torch.isfinite(got).all() and (got[3] == 0).all()
    args = [_opt(a, torch.from_numpy) for a in (q, kp, vp, lengths, tables, ks, vs)]
    plain = tpa.paged_attention_mh(*args, sm_scale=scale, layer=1)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    kern = np.asarray(jpa.paged_attention_mh(*[_opt(a, jnp.asarray) for a in
                                               (q, kp, vp, lengths, tables, ks, vs)],
                                             sm_scale=scale, interpret=True, layer=1))
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)
