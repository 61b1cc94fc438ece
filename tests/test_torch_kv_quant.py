"""The port's contiguous int8 KV cache on the CPU against the JAX package, in f32.

* ``kv_quantize`` bit-equal to the JAX ``_kv_quantize`` (codes and scales, an
  all-zero row included), from f32 and from bf16 rows; the plain K8a's
  contiguous int8 mode (``rope_write_kv_ref(cursor=, k_scale=)``) writes
  JAX's codes and scales of JAX's rotated K and V.
* The forward over an int8 cache, a left-padded prefill and one decode step,
  against the JAX forward over its int8 cache (logits within 1e-5), with the
  cache codes and scales equal.
* Greedy ``generate(kv_quant=True)`` tokens equal to JAX's; the contiguous int8
  beam (``_generate_beam``) of an adaption-prompt model equal to JAX's; the
  tiny Mixtral's int8 beam 4, which the JAX package routes to the contiguous
  cache (its ``_beam_paged_ok`` refuses MoE) and the port now routes the
  same way (``generation._beam_paged_ok``), equal to JAX's.
* The captured greedy int8 step (``GreedyStep``) through a stub graph whose
  replays run the step, with the host cursor raising on read and a tensor's
  host reads raising inside the step: JAX's tokens.

The checkpoints are test_torch_llama.py's tiny Llama (desc_act, g32) and
test_torch_moe.py's tiny Mixtral, loaded by both packages.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.models import params as jparams
from autogptq_tpu.utils import generation as jgen
from autogptq_tpu.utils import peft as jpeft
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.models import params as params_lib
from autogptq_tpu_torch.ops import build, paged_attn
from autogptq_tpu_torch.utils import generation
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import write_random_checkpoint

from test_torch_decode_graph import _NoHostCursor, _NoHostReads, _ReplayingStub
from test_torch_llama import TINY
from test_torch_moe import TINY as MIXTRAL_TINY


def _load(path, stack=False):
    port = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(path, dtype=jnp.float32)
    if stack:
        port.params = params_lib.stack_moe_experts(port.params)
        ref.params = jparams.stack_moe_experts(ref.params)
    return port, ref


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_kvq")), TINY, bits=4,
                                   group_size=32, desc_act=True, seed=3)
    return _load(path)


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_kvq_moe")), MIXTRAL_TINY,
                                   bits=4, group_size=32, seed=3)
    return _load(path, stack=True)


def _prompts(lengths=(7, 4), seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n) for n in lengths]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 64)) * rng.uniform(1e-3, 30, (3, 5, 2, 1)))
    x[0, 0, 1] = 0.0                                    # an all-zero row: scale 0, codes 0
    x[2, 4, 0, :3] = [1.0, -1.0, 0.5]                   # ties of round-half-even
    xt = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    codes, scale = arch.kv_quantize(xt)
    jcodes, jscale = jarch._kv_quantize(jnp.asarray(xt.float().numpy()).astype(getattr(jnp,
                                                                                        dtype)))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy().view(np.int32), np.asarray(jscale).view(np.int32))
    assert scale[0, 0, 1, 0] == 0 and not codes[0, 0, 1].any()
    assert paged_attn.kv_quantize is arch.kv_quantize   # one scheme, named apart from quant_rows


def test_plain_k8a_int8_contiguous_write_matches_jax():
    """rope_write_kv at the cursor into an int8 [L, B, S, Hkv, D] cache: the
    codes and scales of JAX's apply_rope + _kv_quantize, and q turned."""
    rng = np.random.default_rng(1)
    n_layers, b, s, h, hkv, d = 2, 3, 6, 8, 2, 64
    cfg = jarch.ArchConfig(head_dim=d, rope_theta=10000.0)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, d)).astype(np.float32)
    pos = np.array([5, 3, 0], np.int32)
    k_cache = torch.zeros((n_layers, b, s, hkv, d), dtype=torch.int8)
    v_cache = torch.zeros_like(k_cache)
    k_scale = torch.zeros((n_layers, b, s, hkv, 1))
    v_scale = torch.zeros_like(k_scale)
    cursor = torch.tensor([4])
    qr = paged_attn.rope_write_kv(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        paged_attn.rope_inv_freq(10000.0, d, "cpu"), k_cache, v_cache, 1, cursor=cursor,
        k_scale=k_scale, v_scale=v_scale)
    jq, jk = jarch.apply_rope(jnp.asarray(q)[:, None], jnp.asarray(k)[:, None],
                              jnp.asarray(pos)[:, None], cfg)
    np.testing.assert_allclose(qr.numpy(), np.asarray(jq)[:, 0], rtol=1e-6, atol=1e-6)
    for cache, scale, rows in ((k_cache, k_scale, jk[:, 0]), (v_cache, v_scale, v)):
        jcodes, jscale = jarch._kv_quantize(jnp.asarray(rows))
        np.testing.assert_array_equal(cache[1, :, 4].numpy(), np.asarray(jcodes))
        np.testing.assert_allclose(scale[1, :, 4].numpy(), np.asarray(jscale), rtol=1e-6, atol=0)
        assert not cache[0].any() and not cache[1, :, :4].any() and not cache[1, :, 5].any()
    with pytest.raises(ValueError, match="k_scale/v_scale"):
        paged_attn.rope_write_kv(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(pos), paged_attn.rope_inv_freq(10000.0, d, "cpu"),
                                 k_cache, v_cache, 1, cursor=cursor)


def test_int8_forward_matches_jax(models):
    """A left-padded prefill into an int8 cache, then one decode step, against
    the JAX forward over its int8 cache: logits within 1e-5, and the codes and
    scales the two wrote equal."""
    port, ref = models
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, :3] = 0
    mask[:, 12:] = 0
    positions = np.maximum(np.cumsum(mask[:, :12], -1) - 1, 0).astype(np.int32)
    cache = arch.KVCache.create(port.cfg, 2, 16, dtype=torch.float32, device="cpu",
                                quantized=True)
    jcache = jarch.KVCache.create(ref.cfg, 2, 16, quantized=True)
    assert cache.k.dtype == torch.int8 and cache.k_scale.shape == (2, 2, 16, 2, 1)
    got, cache = arch.forward(port.params, torch.from_numpy(tokens), port.cfg, cache=cache,
                              positions=torch.from_numpy(positions),
                              attn_mask=torch.from_numpy(mask), dtype=torch.float32)
    want, jcache = jarch.forward(ref.params, jnp.asarray(tokens), ref.cfg, cache=jcache,
                                 positions=jnp.asarray(positions), attn_mask=jnp.asarray(mask),
                                 backend="xla", dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy()[:, 3:], np.asarray(want)[:, 3:], rtol=1e-5, atol=1e-5)
    mask[:, 12] = 1
    nxt = rng.integers(0, 512, size=(2, 1)).astype(np.int32)
    pos = positions[:, -1:] + 1
    got, cache = arch.forward(port.params, torch.from_numpy(nxt), port.cfg, cache=cache,
                              positions=torch.from_numpy(pos), attn_mask=torch.from_numpy(mask),
                              dtype=torch.float32, mask_contig=True)
    want, jcache = jarch.forward(ref.params, jnp.asarray(nxt), ref.cfg, cache=jcache,
                                 positions=jnp.asarray(pos), attn_mask=jnp.asarray(mask),
                                 backend="xla", dtype=jnp.float32, mask_contig=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert cache.length == int(jcache.length) == 13
    # the valid slots: a left-pad slot's rows above layer 0 come from a query with no valid
    # key, whose softmax averages every slot of the window, and the windows differ
    valid = mask.astype(bool)
    for mine, theirs in ((cache.k, jcache.k), (cache.v, jcache.v), (cache.k_scale, jcache.k_scale),
                         (cache.v_scale, jcache.v_scale)):
        mine, theirs = mine.numpy()[:, valid], np.asarray(theirs)[:, valid]
        if mine.dtype == np.int8:
            np.testing.assert_array_equal(mine, theirs)
        else:
            np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=0)


def test_greedy_kv_quant_tokens_match_jax(models):
    port, ref = models
    kw = dict(max_new_tokens=12, kv_quant=True)
    got = port.generate(_prompts(), **kw)
    np.testing.assert_array_equal(got, ref.generate(_prompts(), **kw))
    sampled = port.generate(_prompts(), temperature=0.8, seed=4, **kw)
    np.testing.assert_array_equal(sampled, port.generate(_prompts(), temperature=0.8, seed=4,
                                                         **kw))


def _adaption_models(ref):
    """JAX params with an adaption prompt whose leaves were redrawn with
    NumPy (a nonzero gate), and the same tree carried across to the port."""
    jp = jpeft.inject_adaption_prompt(ref.params, jpeft.AdaptionPromptConfig(4, 2))
    trainable, _ = jpeft.split_lora_params(jp)
    leaves, treedef = jax.tree_util.tree_flatten(trainable)
    rng = np.random.default_rng(7)
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32) * 0.1)
              for x in leaves]
    jp = jpeft.merge_lora_params(jp, jax.tree_util.tree_unflatten(treedef, leaves))
    jmodel = SimpleNamespace(params=jp, cfg=ref.cfg, backend=ref.backend, dtype=ref.dtype)
    return jmodel, params_from_jax(jp, device="cpu", dtype=torch.float32)


def test_contiguous_int8_beam_of_an_adaption_model_matches_jax(models, monkeypatch):
    port, ref = models
    jmodel, params = _adaption_models(ref)
    pmodel = SimpleNamespace(params=params, cfg=port.cfg, dtype=torch.float32,
                             device=torch.device("cpu"))
    calls = []
    real = generation._generate_beam
    monkeypatch.setattr(generation, "_generate_beam", lambda *a, **kw: calls.append(kw) or
                        real(*a, **kw))
    kw = dict(max_new_tokens=10, num_beams=3, eos_token_id=12, kv_quant=True)
    got = generation.generate(pmodel, _prompts((6, 9)), **kw)
    assert len(calls) == 1 and calls[0]["kv_quant"] is True
    np.testing.assert_array_equal(got, jgen.generate(jmodel, _prompts((6, 9)), **kw))


def test_mixtral_int8_beam4_matches_jax(mixtral, monkeypatch):
    """The fault the int8 beam had: the port sent every beam to the paged
    cache, whose int8 scheme rounds differently from the contiguous cache's,
    where the JAX package routes Mixtral."""
    port, ref = mixtral
    assert not generation._beam_paged_ok(port)
    calls = []
    real = generation._generate_beam
    monkeypatch.setattr(generation, "_generate_beam", lambda *a, **kw: calls.append(1) or
                        real(*a, **kw))
    kw = dict(max_new_tokens=12, num_beams=4, kv_quant=True)
    got = port.generate(_prompts(), **kw)
    assert calls == [1]
    np.testing.assert_array_equal(got, ref.generate(_prompts(), **kw))
    # a float beam keeps the paged route, whose tokens equal the contiguous route's
    monkeypatch.setattr(generation, "_generate_beam", real)
    np.testing.assert_array_equal(port.generate(_prompts(), max_new_tokens=6, num_beams=4),
                                  ref.generate(_prompts(), max_new_tokens=6, num_beams=4))


def test_greedy_int8_step_replays_without_host_reads(models, monkeypatch):
    """The captured int8 greedy step (K8a's contiguous int8 mode, then the
    einsum over every slot) through a stub graph whose replays run the step,
    its cache's host cursor raising on read and a tensor's host reads raising
    inside the step (the plain K8a checks its cursor on the host, as the
    kernel does on the card, so it runs unguarded): JAX's tokens."""
    port, ref = models
    graphs = []

    def stepper(step, device, capturable=True):
        assert capturable
        step.cache.__class__ = _NoHostCursor
        graphs.append(_ReplayingStub())
        return build.StepGraph(_NoHostReads.around(step), graph=graphs[-1])

    _NoHostReads.install(monkeypatch)
    monkeypatch.setattr(paged_attn, "rope_write_kv_ref",
                        _NoHostReads.around(paged_attn.rope_write_kv_ref, on=False))
    monkeypatch.setattr(generation, "_stepper", stepper)
    prompts = _prompts((7, 3), seed=1)
    kw = dict(max_new_tokens=9, kv_quant=True, eos_token_id=int(prompts[0][2]),
              min_new_tokens=2)
    got = port.generate(prompts, **kw)
    assert len(graphs) == 1 and graphs[0].replays == 9 - 2
    np.testing.assert_array_equal(got, ref.generate(prompts, **kw))
