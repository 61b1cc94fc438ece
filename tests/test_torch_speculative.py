"""The port's speculative decoding (``utils/speculative.py``) on the CPU
against the JAX package's, on the same tiny random quantized Llamas
(``tests/test_speculative.py``'s: 2 layers, hidden 128, g32, f32; the draft
1 layer from another seed), carried across with ``utils/convert.params_from_jax``.

* draft == target at gamma 1, 3 and 5: every draft accepted, the tokens equal
  the port's plain greedy ``generate``;
* a different draft: JAX's tokens, and the port's plain greedy;
* EOS padding equal to JAX's and to plain greedy with the same EOS;
* ``GPTQModel.generate(draft_model=)`` routes there and refuses what the JAX
  package refuses (beams, sampling, ``min_new_tokens``, ``kv_quant``,
  ``num_return_sequences``) and a vocabulary mismatch.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autogptq_tpu.utils.speculative import generate_speculative as jspec
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.models.base import GPTQModel
from autogptq_tpu_torch.utils import generation
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.speculative import generate_speculative

from test_speculative import Shim, _tiny


def port_of(jm):
    """The JAX shim's model in the port: the same parameters, on the CPU in f32."""
    c = jm.cfg
    cfg = arch.ArchConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                          num_layers=c.num_layers, num_heads=c.num_heads,
                          num_kv_heads=c.num_kv_heads, head_dim=c.head_dim,
                          intermediate_size=c.intermediate_size, norm_eps=c.norm_eps,
                          rope_theta=c.rope_theta, tie_word_embeddings=c.tie_word_embeddings)
    return SimpleNamespace(params=params_from_jax(jm.params, device="cpu", dtype=torch.float32),
                           cfg=cfg, dtype=torch.float32, device=torch.device("cpu"))


@pytest.fixture(scope="module")
def target():
    jm = Shim(*_tiny(seed=0))
    return jm, port_of(jm)


@pytest.fixture(scope="module")
def draft():
    jm = Shim(*_tiny(seed=7, layers=1, hidden=128))
    return jm, port_of(jm)


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(n,)).astype(np.int32)


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_draft_equals_target_all_accepted(target, gamma):
    _, pm = target
    prompt = _prompt(pm.cfg.vocab_size, 6, gamma)
    ref = generation.generate(pm, prompt[None], max_new_tokens=12)
    stats = {}
    got = generate_speculative(pm, pm, prompt[None], max_new_tokens=12, gamma=gamma,
                               stats=stats)
    np.testing.assert_array_equal(got, ref)
    # every draft accepted: each target forward emits gamma + 1 tokens
    assert stats["accepted_drafts"] == gamma * stats["target_forwards"]
    assert stats["target_forwards"] == -(-11 // (gamma + 1))


def test_different_draft_matches_jax_and_greedy(target, draft):
    (jm, pm), (jd, pd) = target, draft
    prompt = _prompt(pm.cfg.vocab_size, 5, 11)
    got = generate_speculative(pm, pd, prompt[None], max_new_tokens=10, gamma=4)
    np.testing.assert_array_equal(got, jspec(jm, jd, prompt[None], max_new_tokens=10, gamma=4))
    np.testing.assert_array_equal(got, generation.generate(pm, prompt[None], max_new_tokens=10))


def test_eos_padding_matches_jax_and_generate(target):
    jm, pm = target
    prompt = _prompt(pm.cfg.vocab_size, 5, 12)
    base = generation.generate(pm, prompt[None], max_new_tokens=8)
    eos = int(base[0, len(prompt) + 2])   # the token greedy emits at step 2
    ref = generation.generate(pm, prompt[None], max_new_tokens=8, eos_token_id=eos)
    got = generate_speculative(pm, pm, prompt[None], max_new_tokens=8, gamma=3,
                               eos_token_id=eos)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jspec(jm, jm, prompt[None], max_new_tokens=8, gamma=3,
                                             eos_token_id=eos))


def test_generate_routes_and_refuses(target):
    _, pm = target
    prompt = _prompt(pm.cfg.vocab_size, 4, 13)
    np.testing.assert_array_equal(
        GPTQModel.generate(pm, prompt[None], max_new_tokens=6, draft_model=pm,
                           speculative_gamma=2),
        generation.generate(pm, prompt[None], max_new_tokens=6))
    for kw, match in ((dict(num_beams=2), "greedy-only"), (dict(temperature=0.7), "greedy-only"),
                      (dict(min_new_tokens=2), "min_new_tokens"),
                      (dict(kv_quant=True), "kv_quant"),
                      (dict(num_return_sequences=2), "num_return_sequences")):
        with pytest.raises(ValueError, match=match):
            GPTQModel.generate(pm, prompt[None], max_new_tokens=4, draft_model=pm, **kw)
    bad = port_of(Shim(*_tiny(seed=1, vocab=128)))
    with pytest.raises(ValueError, match="vocabulary"):
        generate_speculative(pm, bad, np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="batch-1"):
        generate_speculative(pm, pm, np.zeros((2, 4), np.int32))
