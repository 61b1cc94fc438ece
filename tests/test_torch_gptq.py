"""The port's GPTQ solver (autogptq_tpu_torch.quantization.gptq) against the
JAX package's on the same ``w`` and Hessian, made with NumPy from a seed.

XLA on the CPU and LAPACK round the Cholesky factors differently, so a weight
on a rounding edge may take the neighbouring code and push its error onto the
later columns: codes agree on at least 99% of the entries (measured: all of
them at these sizes on most configurations) and the loss within 1%, while
``g_idx`` is equal and scales and zeros agree to 1e-5 on at least 99% of
their entries (a flipped code upstream moves a later group's range)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu.quantization import gptq as jg
from autogptq_tpu_torch.models.base import _check_solver_loss
from autogptq_tpu_torch.quantization import gptq as tg
from autogptq_tpu_torch.quantization.quantizer import find_params, quantize_rtn


def _problem(seed, n=24, k=128, batches=2, dead=()):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    xs = [rng.standard_normal((3, 40, k)).astype(np.float32) for _ in range(batches)]
    for x in xs:
        x[..., list(dead)] = 0.0
    return w, xs


def _hessians(xs, k):
    jh, jn = jg.hessian_init(k)
    th, tn = tg.hessian_init(k, device="cpu")
    for x in xs:
        jh, jn = jg.hessian_update(jh, jn, jnp.asarray(x))
        th, tn = tg.hessian_update(th, tn, torch.from_numpy(x))
    return jh, int(jn), th, tn


def test_hessian_update_matches_jax():
    _, xs = _problem(0, batches=3)
    xs.append(xs[0][0])              # a 2-D batch counts as one sequence
    jh, jn, th, tn = _hessians(xs, 128)
    assert tn == jn == 10
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    all_x = np.concatenate([x.reshape(-1, 128) for x in xs])
    np.testing.assert_allclose(th.numpy(), 2.0 / 10 * (all_x.T @ all_x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("group_size, desc_act, static_groups, sym", [
    (-1, False, False, True), (-1, True, False, False),
    (32, False, False, True), (32, False, False, False),
    (32, True, False, True), (32, True, False, False),
    (32, True, True, True), (32, False, True, False),
    (128, False, False, False), (128, True, False, True),
    (48, False, False, True),            # a group size that does not divide the block
])
@pytest.mark.parametrize("bits", [4, 3])
def test_gptq_quantize_matches_jax(group_size, desc_act, static_groups, sym, bits):
    k = 144 if group_size == 48 else 128
    w, xs = _problem(bits * 100 + abs(group_size) + desc_act, k=k, dead=(5, 77))
    jh, _, th, _ = _hessians(xs, k)
    kw = dict(bits=bits, group_size=group_size, sym=sym, desc_act=desc_act,
              static_groups=static_groups, blocksize=32)
    want = jg.gptq_quantize(jnp.asarray(w), jh, jg.GPTQConfig(**kw))
    got = tg.gptq_quantize(torch.from_numpy(w), torch.from_numpy(np.asarray(jh)),
                           tg.GPTQConfig(**kw))
    np.testing.assert_array_equal(got.g_idx.numpy(), np.asarray(want.g_idx))
    assert got.g_idx.dtype == torch.int32
    for name in ("scale", "zero"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape
        assert np.mean(np.isclose(a, b, rtol=1e-5, atol=1e-6)) >= 0.99, name
    q, jq_ = got.qweight.numpy(), np.asarray(want.qweight)
    assert np.mean(np.isclose(q, jq_, rtol=1e-4, atol=1e-5)) >= 0.99
    np.testing.assert_allclose(float(got.total_loss), float(want.total_loss), rtol=1e-2)
    np.testing.assert_allclose(got.row_loss.numpy().sum(), float(got.total_loss), rtol=1e-5)
    assert np.all(q[:, [5, 77]] == 0.0)           # dead columns quantize to zero


@pytest.mark.parametrize("bits", [2, 8])
def test_gptq_quantize_mse_matches_jax(bits):
    w, xs = _problem(bits, n=8, k=64)
    jh, _, _, _ = _hessians(xs, 64)
    kw = dict(bits=bits, group_size=32, sym=False, mse=True, blocksize=32)
    want = jg.gptq_quantize(jnp.asarray(w), jh, jg.GPTQConfig(**kw))
    got = tg.gptq_quantize(torch.from_numpy(w), torch.from_numpy(np.asarray(jh)),
                           tg.GPTQConfig(**kw))
    assert np.mean(np.isclose(got.qweight.numpy(), np.asarray(want.qweight),
                              rtol=1e-4, atol=1e-5)) >= 0.99
    np.testing.assert_allclose(float(got.total_loss), float(want.total_loss), rtol=1e-2)


@pytest.mark.parametrize("bits, group_size, desc_act", [(3, -1, False), (4, 32, True),
                                                        (2, 32, False)])
def test_gptq_beats_rtn(bits, group_size, desc_act):
    """GPTQ's Hessian-weighted objective is no worse than round-to-nearest on
    the same grid search."""
    w, xs = _problem(7, n=16, k=64, batches=1)
    _, _, th, _ = _hessians(xs, 64)
    cfg = tg.GPTQConfig(bits=bits, group_size=group_size, sym=False, desc_act=desc_act)
    res = tg.gptq_quantize(torch.from_numpy(w), th.clone(), cfg)
    gs = 64 if group_size == -1 else group_size
    wt = torch.from_numpy(w)
    rtn = torch.cat([quantize_rtn(c, *[p[:, None] for p in find_params(c, cfg.quantizer())],
                                  cfg.maxq) for c in wt.split(gs, dim=1)], dim=1)

    def obj(q):
        e = (q - wt).double()
        return float(torch.trace(e @ th.double() @ e.t()))

    assert obj(res.qweight) <= obj(rtn) * 1.001


def test_grouped_solve_matches_solo():
    """An N-concatenated solve (q/k/v share one Hessian) equals solving each
    member alone: every step is row-parallel given H."""
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal((n, 96)).astype(np.float32) for n in (24, 16)]
    _, xs = _problem(4, k=96, batches=1)
    _, _, th, _ = _hessians(xs, 96)
    cfg = tg.GPTQConfig(bits=4, group_size=32, sym=False, desc_act=True, blocksize=32)
    both = tg.gptq_quantize(torch.from_numpy(np.concatenate(ws)), th.clone(), cfg)
    r0 = 0
    for w in ws:
        solo = tg.gptq_quantize(torch.from_numpy(w), th.clone(), cfg)
        r1 = r0 + w.shape[0]
        torch.testing.assert_close(both.qweight[r0:r1], solo.qweight, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(both.scale[:, r0:r1], solo.scale, rtol=1e-6, atol=0)
        torch.testing.assert_close(both.row_loss[r0:r1].sum(), solo.total_loss, rtol=1e-4,
                                   atol=0)
        r0 = r1


def test_non_finite_solver_loss_raises():
    """A Hessian that is not positive definite gives a NaN loss, not an
    exception inside the solve; the quantize loop's check raises."""
    w, _ = _problem(1, n=4, k=32)
    h = -torch.eye(32)
    res = tg.gptq_quantize(torch.from_numpy(w), h, tg.GPTQConfig(bits=4, group_size=-1))
    assert not torch.isfinite(res.total_loss)
    assert _check_solver_loss(1.25, "layer 0 q") == 1.25
    with pytest.raises(ValueError, match="positive definite"):
        _check_solver_loss(res.total_loss, "layer 0 attn.q_proj")


def test_inputs_are_not_modified_and_tf32_setting_is_restored():
    w, xs = _problem(9, n=8, k=64, batches=1)
    _, _, th, _ = _hessians(xs, 64)
    wt, h0 = torch.from_numpy(w.copy()), th.clone()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tg.gptq_quantize(wt, th, tg.GPTQConfig(bits=4, group_size=32))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(th, h0) and np.array_equal(wt.numpy(), w)
