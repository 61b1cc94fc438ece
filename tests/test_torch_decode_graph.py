"""The port's captured decode steps (``generation.GreedyStep``,
``generation.PagedBeamStep``, ``build.StepGraph``; the counterpart of the JAX
package's ``JIT_GENERATE``).

On the CPU the step objects run eagerly, every line that the card captures
but the capture itself, and are held against the JAX package's ``generate``
on tiny random checkpoints written here (a 2-layer Llama of hidden size 64
and the 2-layer Mixtral of ``test_torch_moe.py``, f32, both packages loaded
from one checkpoint): greedy tokens of a left-padded batch with EOS and
``min_new_tokens``, paged beam-4 tokens across a page boundary, Mixtral's
greedy tokens, each also against the port with ``JIT_GENERATE`` off; a
decode step whose ``KVCache.length`` raises on read gives the host cursor's
logits, and a paged beam step whose advance and reorder read no host value
(a tensor's ``item``, ``bool``, ``int`` ... raise there) gives JAX's tokens;
the replay accounting of ``build.StepGraph`` through a stub graph. The whole
paged beam step (forward, ``_Beams.advance``, ``_paged_reorder``) through a
stub graph whose capture records the step and whose replays run it, as a
CUDA graph's do, so that the host loop does nothing between replays: tokens
equal to JAX's ``_generate_beam_paged`` in every case of
``tests/test_torch_beam.py`` (its checkpoint: hidden size 128, desc_act).

Marked ``cuda`` (skipped without a card; on the card
``python -m pytest tests/test_torch_decode_graph.py -m cuda -q``): on a
2-layer full-width Llama-2-7B cut in bf16, the replayed greedy and paged beam
steps give the eager steps' logits bit for bit, also with the fused norm
(``AUTOGPTQ_TPU_FUSE_NORM=1``, whose GEMV the capture records with its
programmatic dependent launch), and the paged beam step over int8 pools; a
host read planted in the step makes the capture raise, and ``generate``
raises with it. The JAX package is imported
inside the CPU tests' fixtures, so the card's run needs none of it."""

import collections

import numpy as np
import pytest
import torch

from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.models import params as params_lib
from autogptq_tpu_torch.ops import build
from autogptq_tpu_torch.utils import generation
from autogptq_tpu_torch.utils.random_checkpoint import write_random_checkpoint

# test_torch_llama.py's tiny Llama at hidden size 64, and test_torch_moe.py's tiny Mixtral (their
# modules import the JAX package, which the card's run of this file goes without)
TINY = dict(model_type="llama", vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
            hidden_act="silu", tie_word_embeddings=False)
MIXTRAL_TINY = dict(TINY, model_type="mixtral", hidden_size=128, intermediate_size=256,
                    num_local_experts=8, num_experts_per_tok=2, rope_theta=1e6,
                    sliding_window=None)
NEW = 9
# test_torch_beam.py's checkpoint (test_torch_llama.py's TINY, desc_act, g32, seed 3), its EOS
# and its cases
BEAM_TINY = dict(TINY, hidden_size=128, intermediate_size=256)
BEAM_EOS = 12
BEAM_CASES = [
    dict(num_beams=4, eos_token_id=7),
    dict(num_beams=4, eos_token_id=BEAM_EOS),
    dict(num_beams=3, eos_token_id=BEAM_EOS, length_penalty=1.3),
    dict(num_beams=4, eos_token_id=BEAM_EOS, early_stopping=True, num_return_sequences=3),
    dict(num_beams=2, eos_token_id=BEAM_EOS, min_new_tokens=4),
]


def _load_both(path, stack=False):
    import jax.numpy as jnp
    from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
    from autogptq_tpu.models import params as jparams

    port = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(path, dtype=jnp.float32)
    if stack:
        port.params = params_lib.stack_moe_experts(port.params)
        ref.params = jparams.stack_moe_experts(ref.params)
    return port, ref


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_graph")), TINY, bits=4,
                                   group_size=32, seed=7)
    return _load_both(path)


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_graph_moe")),
                                   MIXTRAL_TINY, bits=4, group_size=32, seed=3)
    return _load_both(path, stack=True)


@pytest.fixture(scope="module")
def beam_models(tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_graph_beam")), BEAM_TINY,
                                   bits=4, group_size=32, desc_act=True, seed=3)
    return _load_both(path)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).astype(np.int32) for n in lengths]


def _eager(port, prompts, monkeypatch, **kw):
    """The port's generate with ``JIT_GENERATE`` off."""
    with monkeypatch.context() as m:
        m.setattr(generation, "JIT_GENERATE", False)
        return port.generate(prompts, **kw)


def _counted(monkeypatch, cls):
    """Count the calls of ``cls``'s step."""
    calls = []
    real = cls.__call__
    monkeypatch.setattr(cls, "__call__", lambda self: calls.append(1) or real(self))
    return calls


def test_greedy_step_matches_jax(llama, monkeypatch):
    port, ref = llama
    prompts = _prompts((7, 3), seed=1)
    free = port.generate(prompts, max_new_tokens=NEW)
    eos = int(free[0, 7 + 5])          # a token row 0 emits at step 5: it ends row 0 there
    kw = dict(max_new_tokens=NEW, eos_token_id=eos, min_new_tokens=3, pad_token_id=0)
    calls = _counted(monkeypatch, generation.GreedyStep)
    got = port.generate(prompts, **kw)
    assert len(calls) == NEW - 1
    np.testing.assert_array_equal(got, ref.generate(prompts, **kw))
    np.testing.assert_array_equal(got, _eager(port, prompts, monkeypatch, **kw))
    assert (got[0, 7 + 6:] == 0).all() and eos in got[0, 7:]


def test_paged_beam_step_matches_jax(llama, monkeypatch):
    port, ref = llama
    prompts = _prompts((12, 5), seed=2)     # row 0 writes slots 12..19: across page 16
    kw = dict(max_new_tokens=NEW, num_beams=4, eos_token_id=int(prompts[0][3]))
    addresses = set()
    real = generation._paged_reorder

    def reorder(cache, parent, next_pos):
        addresses.add(cache.tables.data_ptr())
        real(cache, parent, next_pos)
        addresses.add(cache.tables.data_ptr())

    monkeypatch.setattr(generation, "_paged_reorder", reorder)
    calls = _counted(monkeypatch, generation.PagedBeamStep)
    got = port.generate(prompts, **kw)
    assert len(calls) == NEW - 1 and len(addresses) == 1      # the tables written in place
    np.testing.assert_array_equal(got, ref.generate(prompts, **kw))
    np.testing.assert_array_equal(got, _eager(port, prompts, monkeypatch, **kw))


def test_mixtral_greedy_step_matches_jax(mixtral, monkeypatch):
    port, ref = mixtral
    prompts = _prompts((7, 4), seed=5)
    calls = _counted(monkeypatch, generation.GreedyStep)
    got = port.generate(prompts, max_new_tokens=NEW)
    assert len(calls) == NEW - 1
    np.testing.assert_array_equal(got, ref.generate(prompts, max_new_tokens=NEW))
    np.testing.assert_array_equal(got, _eager(port, prompts, monkeypatch, max_new_tokens=NEW))


class _NoHostCursor(arch.KVCache):
    """A cache whose host cursor raises on read and on write."""

    @property
    def length(self):
        raise AssertionError("a decode step read KVCache.length")

    @length.setter
    def length(self, value):
        raise AssertionError("a decode step wrote KVCache.length")


_HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


class _NoHostReads:
    """While :attr:`on`, a tensor's host reads raise (patched onto
    ``torch.Tensor`` by :meth:`install`)."""

    on = False

    @classmethod
    def install(cls, monkeypatch):
        for name in _HOST_READS:
            real = getattr(torch.Tensor, name)

            def guarded(self, *a, _real=real, _name=name, **kw):
                if cls.on:
                    raise AssertionError(f"a host read (Tensor.{_name}) in the beam step")
                return _real(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, guarded)

    @classmethod
    def around(cls, fn, on=True):
        def wrapped(*a, **kw):
            was, cls.on = cls.on, on
            try:
                return fn(*a, **kw)
            finally:
                cls.on = was
        return wrapped


def _beam_step_reads_no_host_value(port, ref, monkeypatch):
    """The paged beam step's advance and reorder under the guard (K8b's plain
    version checks its ids on the host, as the kernel does on the card, so
    it runs unguarded): JAX's tokens, and the step counter advanced."""
    _NoHostReads.install(monkeypatch)
    monkeypatch.setattr(generation._Beams, "advance",
                        _NoHostReads.around(generation._Beams.advance))
    monkeypatch.setattr(generation, "_paged_reorder",
                        _NoHostReads.around(generation._paged_reorder))
    monkeypatch.setattr(generation.PagedBeamCache, "copy_pages",
                        _NoHostReads.around(generation.PagedBeamCache.copy_pages, on=False))
    steps = []
    real_start = generation._Beams.start
    monkeypatch.setattr(generation._Beams, "start",
                        lambda self, lb: steps.append(self) or real_start(self, lb))
    prompts = _prompts((6, 13), seed=4)
    kw = dict(max_new_tokens=NEW, num_beams=3, eos_token_id=int(prompts[1][2]), min_new_tokens=2,
              length_penalty=0.8)
    got = port.generate(prompts, **kw)
    np.testing.assert_array_equal(got, ref.generate(prompts, **kw))
    assert int(steps[0].step) == NEW


@pytest.mark.parametrize("which", ["llama", "mixtral", "llama-beam"])
def test_decode_step_reads_no_host_cursor(which, request, monkeypatch):
    if which == "llama-beam":
        return _beam_step_reads_no_host_value(*request.getfixturevalue("llama"), monkeypatch)
    port, _ = request.getfixturevalue(which)
    cfg, params = port.cfg, port.params
    ids, mask = generation._prep_inputs(_prompts((6, 4), seed=3))
    tokens, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    b, t = tokens.shape
    total = t + 4
    validity = torch.zeros((b, total), dtype=torch.int32)
    validity[:, :t] = mask
    positions = (torch.cumsum(mask, dim=-1) - 1).clamp_min(0)
    caches = []
    for _ in range(2):
        cache = arch.KVCache.create(cfg, b, total, dtype=torch.float32, device="cpu")
        logits, _ = arch.forward(params, tokens, cfg, cache=cache, positions=positions,
                                 attn_mask=validity, logits_last_only=True)
        caches.append(cache)
    host, dev = caches
    step = generation.GreedyStep(params, cfg, dev, validity.clone(), positions[:, -1:] + 1,
                                 torch.float32)
    dev.__class__ = _NoHostCursor
    host_validity, pos = validity.clone(), positions[:, -1:] + 1
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    for _ in range(3):
        host_validity[:, host.length] = 1
        want, _ = arch.forward(params, tok[:, None], cfg, cache=host, positions=pos,
                               attn_mask=host_validity, mask_contig=True)
        step.tok.copy_(tok[:, None])
        got = step()
        torch.testing.assert_close(got, want[:, -1], rtol=1e-6, atol=1e-6)
        tok, pos = want[:, -1].argmax(-1).to(torch.int32), pos + 1
    assert int(dev.cursor) == host.length
    torch.testing.assert_close(step.validity, host_validity, rtol=0, atol=0)


class _StubGraph:
    """Stands in for the CUDA graph on the CPU: the warm-up runs the step,
    the capture records it without running a kernel, a replay runs no Python
    (so no wrapper counts)."""

    def __init__(self):
        self.replays = 0

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        return fn()

    def replay(self):
        self.replays += 1


class _ReplayingStub(_StubGraph):
    """A stub whose capture records the step without running it and whose
    replays run it, as a CUDA graph's do; the capture's output is a tensor
    that every replay overwrites."""

    def capture(self, fn):
        self.fn, self.out = fn, torch.empty(0)
        return self.out

    def replay(self):
        super().replay()
        out = self.fn()
        self.out.resize_(out.shape).copy_(out)


@pytest.mark.parametrize("kw", BEAM_CASES, ids=[str(i) for i in range(len(BEAM_CASES))])
def test_whole_beam_step_replays_to_jax_tokens(beam_models, kw, monkeypatch):
    from autogptq_tpu.utils import generation as jgen

    port, ref = beam_models
    graphs = []

    def stepper(step, device, capturable=True):
        graphs.append(_ReplayingStub())
        return build.StepGraph(step, graph=graphs[-1])

    prompts = _prompts((5, 9, 17))
    monkeypatch.setattr(generation, "_stepper", stepper)
    got = port.generate(prompts, max_new_tokens=12, **kw)
    assert len(graphs) == 1 and graphs[0].replays == 12 - 2
    monkeypatch.setattr(jgen, "BEAM_PAGED", "always")      # JAX's _generate_beam_paged
    np.testing.assert_array_equal(got, ref.generate(prompts, max_new_tokens=12, **kw))


def test_replay_accounting_gives_the_eager_counts(monkeypatch):
    monkeypatch.setattr(build, "launches", collections.Counter({"earlier": 5}))
    monkeypatch.setattr(build, "replayed", collections.Counter())
    monkeypatch.setattr(build, "graphs", collections.Counter())
    out = torch.zeros(2)

    def step():                           # what the kernel wrappers count in one step
        build.launches["w4a16_gemm_gemv"] += 7
        build.launches["flash_decode"] += 1
        return out

    steps = 6
    for _ in range(steps):
        step()
    eager = dict(build.launches)
    build.launches.clear()
    build.launches["earlier"] = 5
    graph = _StubGraph()
    run = build.StepGraph(step, graph=graph)
    assert all(run() is out for _ in range(steps))
    assert dict(build.launches) == eager == {"earlier": 5, "w4a16_gemm_gemv": 7 * steps,
                                             "flash_decode": steps}
    assert graph.replays == steps - 1 and run.delta == {"w4a16_gemm_gemv": 7, "flash_decode": 1}
    assert dict(build.replayed) == {"w4a16_gemm_gemv": 7 * (steps - 1),
                                    "flash_decode": steps - 1}
    assert build.graphs["captures"] == 1 and build.graphs["replays"] == steps - 1
    two = build.StepGraph(step, graph=_StubGraph())    # one warm-up, no capture
    build.launches.clear()
    two()
    assert dict(build.launches) == {"w4a16_gemm_gemv": 7, "flash_decode": 1}
    assert build.graphs["captures"] == 1


def test_capture_failure_restores_the_counts_and_raises(monkeypatch):
    monkeypatch.setattr(build, "launches", collections.Counter({"x": 1}))

    class Failing(_StubGraph):
        def capture(self, fn):
            fn()
            raise RuntimeError("operation not permitted when stream is capturing")

    def step():
        build.launches["x"] += 1
        return torch.zeros(1)

    run = build.StepGraph(step, graph=Failing())
    run()
    with pytest.raises(RuntimeError, match="capturing"):
        run()
    assert dict(build.launches) == {"x": 2}


def test_switch_reads_the_environment():
    import os
    import subprocess
    import sys

    assert generation.JIT_GENERATE is (os.environ.get("AUTOGPTQ_TPU_JIT_GENERATE", "1") != "0")
    code = "from autogptq_tpu_torch.utils import generation as g; print(g.JIT_GENERATE)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, AUTOGPTQ_TPU_JIT_GENERATE="0"),
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"


# ------------------------------------------------------------------ on the card

@pytest.fixture(scope="module")
def card_model(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B

    path = write_random_checkpoint(str(tmp_path_factory.mktemp("cut_7b")),
                                   dict(LLAMA2_7B, num_hidden_layers=2), bits=4, group_size=128,
                                   seed=0)
    return AutoGPTQForCausalLM.from_quantized(path)


def _step_logits(model, monkeypatch, graphs: bool, fused: bool, **kw):
    """The logits of every decode step of a generate (from the loop's
    sampling or the beams' choice) and its tokens."""
    seen = []
    real = generation._stepper

    def stepper(step, device, capturable=True):   # each step's (or replay's) output
        run = real(step, device, capturable)

        def recorded():
            out = run()
            seen.append(out.clone())
            return out

        return recorded

    prompt = (np.arange(16) % 1000)[None].astype(np.int32)
    with monkeypatch.context() as m:
        m.setattr(generation, "_stepper", stepper)
        m.setattr(generation, "JIT_GENERATE", graphs)
        m.setattr(arch, "FUSE_NORM", "1" if fused else "0")
        build.launches.clear()
        build.graphs.clear()
        out = model.generate(prompt, max_new_tokens=12, **kw)
        return out, seen, dict(build.launches), dict(build.graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("beams", [1, 4])
def test_replayed_step_is_the_eager_step(card_model, monkeypatch, beams, fused):
    out, logits, counts, graphs = _step_logits(card_model, monkeypatch, True, fused,
                                               num_beams=beams)
    ref, ref_logits, ref_counts, _ = _step_logits(card_model, monkeypatch, False, fused,
                                                  num_beams=beams)
    assert graphs["captures"] == 1 and graphs["replays"] == 12 - 2
    np.testing.assert_array_equal(out, ref)
    assert counts == ref_counts
    if fused:
        assert counts["w4a16_gemm_gemv_norm"] == 5 * 2 * 11
    # one fused RoPE + K/V write per layer and step; one K8b per beam step and one at setup
    assert counts["rope_write_kv"] == 2 * 11 and "write_token_pages" not in counts
    if beams > 1:
        assert counts["copy_pages_pair"] == 12 and "copy_pages_pair_gather" not in counts
    assert len(logits) == len(ref_logits) == 11
    for a, b in zip(logits, ref_logits):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_replayed_int8_beam_step_is_the_eager_step(card_model, monkeypatch):
    out, logits, counts, graphs = _step_logits(card_model, monkeypatch, True, False, num_beams=4,
                                               kv_quant=True)
    ref, ref_logits, ref_counts, _ = _step_logits(card_model, monkeypatch, False, False,
                                                  num_beams=4, kv_quant=True)
    assert graphs["captures"] == 1 and graphs["replays"] == 12 - 2
    np.testing.assert_array_equal(out, ref)
    assert counts == ref_counts
    assert counts["rope_write_kv"] == 2 * 11 and counts["copy_pages_pair"] == 2 * 12
    assert len(logits) == len(ref_logits) == 11
    for a, b in zip(logits, ref_logits):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_host_read_in_the_step_fails_the_capture(card_model, monkeypatch, fused):
    real = generation.GreedyStep.__call__

    def planted(self):
        int(self.cache.cursor.item())      # a host read: the capture cannot record it
        return real(self)

    prompt = (np.arange(16) % 1000)[None].astype(np.int32)
    with monkeypatch.context() as m:
        m.setattr(generation.GreedyStep, "__call__", planted)
        m.setattr(generation, "JIT_GENERATE", True)
        m.setattr(arch, "FUSE_NORM", "1" if fused else "0")
        eager_calls = []
        m.setattr(generation, "_sample", lambda *a, real=generation._sample:
                  eager_calls.append(1) or real(*a))
        with pytest.raises(RuntimeError):
            card_model.generate(prompt, max_new_tokens=6)
        assert len(eager_calls) == 2             # the prefill's and the warm-up's, no more
    torch.cuda.synchronize()
    assert card_model.generate(prompt, max_new_tokens=3).shape == (1, 19)
