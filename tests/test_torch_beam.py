"""The port's beam search on the CPU against the JAX package: the tiny random
GPTQ checkpoint of test_torch_llama.py (2 layers, hidden 128, 4/2 heads,
vocab 512, desc_act, g32) loaded by both packages in f32. Tokens must be
identical, for the paged cache (the route ``generate`` takes) and the
contiguous one (``_generate_beam``, the paged path's oracle)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.utils import generation
from autogptq_tpu_torch.utils.random_checkpoint import write_random_checkpoint

from test_torch_llama import TINY

# A token the beams of this checkpoint emit within 12 steps (7 never shows up),
# so the done-hypothesis pool fills and rows freeze.
EOS = 12


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_beam")), TINY, bits=4,
                                   group_size=32, desc_act=True, seed=3)
    port = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(path, dtype=jnp.float32)
    return port, ref


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).astype(np.int32) for n in lengths]


def _both_routes(port, prompts, monkeypatch, **kw):
    paged = port.generate(prompts, **kw)
    with monkeypatch.context() as m:
        m.setattr(generation, "_generate_beam_paged", generation._generate_beam)
        contiguous = port.generate(prompts, **kw)
    np.testing.assert_array_equal(paged, contiguous)
    return paged


@pytest.mark.parametrize("kwargs", [
    dict(num_beams=4, eos_token_id=7),
    dict(num_beams=4, eos_token_id=EOS),
    dict(num_beams=3, eos_token_id=EOS, length_penalty=1.3),
    dict(num_beams=4, eos_token_id=EOS, early_stopping=True, num_return_sequences=3),
    dict(num_beams=2, eos_token_id=EOS, min_new_tokens=4),
])
def test_beam_tokens_match_jax(models, kwargs, monkeypatch):
    port, ref = models
    prompts = _prompts((5, 9, 17))
    got = _both_routes(port, prompts, monkeypatch, max_new_tokens=12, **kwargs)
    want = ref.generate(prompts, max_new_tokens=12, **kwargs)
    assert got.shape == (3 * kwargs.get("num_return_sequences", 1), 17 + 12)
    np.testing.assert_array_equal(got, want)


def test_long_beam_run_across_page_boundaries(models, monkeypatch):
    port, ref = models
    prompts = _prompts((3, 30), seed=1)
    kw = dict(max_new_tokens=40, num_beams=3, eos_token_id=EOS)
    got = _both_routes(port, prompts, monkeypatch, **kw)
    np.testing.assert_array_equal(got, ref.generate(prompts, **kw))


def test_page_aligned_prompt(models, monkeypatch):
    port, ref = models
    prompts = _prompts((16,), seed=2)
    kw = dict(max_new_tokens=12, num_beams=4, eos_token_id=EOS, num_return_sequences=2)
    got = _both_routes(port, prompts, monkeypatch, **kw)
    np.testing.assert_array_equal(got, ref.generate(prompts, **kw))


def test_int8_paged_cache_matches_jax(models):
    port, ref = models
    prompts = _prompts((5, 9, 17))
    kw = dict(max_new_tokens=12, num_beams=4, eos_token_id=EOS, kv_quant=True)
    got = port.generate(prompts, **kw)
    np.testing.assert_array_equal(got, ref.generate(prompts, **kw))
    ids, mask = generation._prep_inputs(prompts)
    _, cache = generation.beam_paged_prefill(port.params, torch.from_numpy(ids),
                                             torch.from_numpy(mask), port.cfg, 4, 12,
                                             torch.float32, kv_quant=True)
    assert cache.k_pool.dtype == torch.int8 and cache.k_scale.dtype == torch.float32
    assert cache.k_scale.shape == cache.k_pool.shape[:-1]


def test_top_k_orders_ties_like_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, size=(3, 2, 50)).astype(np.float32)   # many equal values
    x[0, 0, 10:] = -1e30
    for k in (1, 4, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = generation._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    from autogptq_tpu.utils import generation as jgen

    jv, ji = jgen._flat_top2k(jnp.asarray(x))
    tv, ti = generation._flat_top2k(torch.from_numpy(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_paged_step_matches_the_forward(models):
    """One paged decode step's logits equal the contiguous forward's for the
    same prompt and token (f32, CPU)."""
    port, _ = models
    ids, mask = generation._prep_inputs(_prompts((7, 20), seed=5))
    tokens, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    logits_b, cache = generation.beam_paged_prefill(port.params, tokens, mask, port.cfg, 2, 4,
                                                    torch.float32)
    nxt = torch.tensor([11, 11, 300, 300], dtype=torch.int32)
    step = generation.paged_decode_step(port.params, port.cfg, cache, nxt, cache.plen,
                                        torch.float32)
    from autogptq_tpu_torch.models import arch

    full = torch.cat([tokens, torch.tensor([[11], [300]])], dim=1)
    full_mask = torch.cat([mask, torch.ones((2, 1), dtype=mask.dtype)], dim=1)
    want, _ = arch.forward(port.params, full, port.cfg, attn_mask=full_mask)
    torch.testing.assert_close(step[::2], want[:, -1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logits_b, want[:, -2], rtol=1e-4, atol=1e-4)


def test_beam_argument_errors(models, monkeypatch):
    from autogptq_tpu.utils import generation as jgen

    port, ref = models
    p = _prompts((5,))
    with pytest.raises(ValueError, match="num_return_sequences"):
        port.generate(p, max_new_tokens=2, num_beams=2, num_return_sequences=3)
    with pytest.raises(ValueError, match="early_stopping"):
        port.generate(p, max_new_tokens=2, num_beams=2, early_stopping="sometimes")
    with pytest.raises(NotImplementedError, match="beam-sample"):
        port.generate(p, max_new_tokens=2, num_beams=2, temperature=0.7)
    with pytest.raises(ValueError, match="requires sampling"):
        port.generate(p, max_new_tokens=2, num_return_sequences=2)
    # the contiguous int8 cache, greedy and beam, once refused here: JAX's tokens
    np.testing.assert_array_equal(port.generate(p, max_new_tokens=2, kv_quant=True),
                                  ref.generate(p, max_new_tokens=2, kv_quant=True))
    ids, mask = generation._prep_inputs(p)
    with torch.inference_mode():
        got = generation._generate_beam(port.params, torch.from_numpy(ids),
                                         torch.from_numpy(mask), port.cfg, 2, 0, None, 2,
                                         torch.float32, kv_quant=True)
    monkeypatch.setattr(jgen, "BEAM_PAGED", "never")      # JAX's _generate_beam
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  ref.generate(p, max_new_tokens=2, num_beams=2,
                                               kv_quant=True)[:, 5:])
