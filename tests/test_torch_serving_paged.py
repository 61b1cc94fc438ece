"""The port's paged continuous-batching engine on the CPU against the JAX
package's ``PagedContinuousBatchEngine`` (``use_kernel=False``, its jnp
references), on the same tiny random quantized Llama (``tests/
test_serving_paged.py``'s ``Shim``: 2 layers, hidden 128, 4/2 heads, g32, f32,
carried across with ``utils/convert.params_from_jax``) and the same request
traces: the cases of ``tests/test_serving_paged.py`` and
``tests/test_serving_paged_block.py`` whose results the JAX engine defines.
Greedy streams and ``EngineStats`` (all but the wall time) are equal, and both
engines end with every page free (``pages_in_use() == 0``) but the prefix
cache's evictable ones.

* Growth and reuse, recompute preemption, a page size that does not divide
  the prefill bucket, streaming with no duplicates under preemption, the
  stats, the refusals, the prefix cache (shared pages, reuse after
  retirement, a partial prefix, eviction, preemption) and ``decode_block``
  (greedy, EOS inside a block, preemption, the near-cap tail, the prefix
  cache).
* ``warmup()`` through a stub graph: every decode step captured, the engine's
  state untouched, and a run after it captures nothing new.
* Sampling keeps the JAX contract, not its bits: ``top_k=1`` and a tiny
  ``top_p`` give JAX's tokens; over 4096 seeds at fixed logits (V = 16) the
  port's draws have JAX's support and frequencies within 0.03; a request's
  stream does not change with other traffic, a preemption or a decode block.

JAX engines of one geometry share their compiled functions
(``_jax_engine``), which depend only on the model, ``max_slots``,
``page_size`` and ``decode_block``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu import serving as jserving
from autogptq_tpu.serving_paged import PagedContinuousBatchEngine as JaxEngine
from autogptq_tpu_torch import serving
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.ops import build
from autogptq_tpu_torch.serving import Request
from autogptq_tpu_torch.serving_paged import PagedContinuousBatchEngine, paged_cfg_ok
from autogptq_tpu_torch.utils import generation
from autogptq_tpu_torch.utils.convert import params_from_jax

from test_serving_paged import Shim

_JIT_CACHES = ("_prefill_fns", "_decode_fns", "_block_fns", "_gather_fns", "_suffix_fns")
_donors: dict = {}


@pytest.fixture(scope="module")
def models():
    jm = Shim()
    c = jm.cfg
    cfg = arch.ArchConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                          num_layers=c.num_layers, num_heads=c.num_heads,
                          num_kv_heads=c.num_kv_heads, head_dim=c.head_dim,
                          intermediate_size=c.intermediate_size, norm_eps=c.norm_eps,
                          rope_theta=c.rope_theta, tie_word_embeddings=c.tie_word_embeddings)
    pm = SimpleNamespace(params=params_from_jax(jm.params, device="cpu", dtype=torch.float32),
                         cfg=cfg, dtype=torch.float32, device=torch.device("cpu"))
    return jm, pm


def _jax_engine(jm, **kw):
    eng = JaxEngine(jm, use_kernel=False, **kw)
    key = (kw.get("max_slots", 4), kw.get("page_size", 16), kw.get("decode_block", 1))
    donor = _donors.setdefault(key, eng)
    for name in _JIT_CACHES:
        setattr(eng, name, getattr(donor, name))
    return eng


def _jax_reqs(reqs):
    return [jserving.Request(**dataclasses.asdict(r)) for r in reqs]


def _stats(eng):
    d = dataclasses.asdict(eng.stats)
    d.pop("step_time_s")
    return d


def _both(models, reqs, runs=1, **kw):
    """Both engines over ``reqs`` (a list of runs with ``runs`` > 1, each
    ``run`` on the same engine): outputs and stats equal, every page free."""
    jm, pm = models
    jeng, peng = _jax_engine(jm, **kw), PagedContinuousBatchEngine(pm, **kw)
    outs = []
    for batch in (reqs if runs > 1 else [reqs]):
        want = jeng.run(_jax_reqs(batch))
        got = peng.run(list(batch))
        assert set(got) == set(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"request {rid}")
        outs.append(got)
    assert _stats(peng) == _stats(jeng)
    # every page is free but the prefix cache's (refcount-0, evictable)
    assert peng.pages_in_use() == jeng.pages_in_use() == peng.pages_cached() \
        == jeng.pages_cached()
    assert peng.pages_cached() == 0 or kw.get("enable_prefix_cache")
    return (outs if runs > 1 else outs[0]), peng


def _prompts(models, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, models[0].cfg.vocab_size, size=(p,)).astype(np.int32)
            for p in lengths]


def test_paged_matches_jax_engine(models):
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(_prompts(models, (5, 11, 17)))]
    _both(models, reqs, max_slots=2, total_pages=32, page_size=8, pages_per_seq=8)


def test_paged_on_demand_growth_and_reuse(models):
    reqs = [Request(i, p, max_new_tokens=5)
            for i, p in enumerate(_prompts(models, (6, 9, 5, 7), seed=1))]
    _, eng = _both(models, reqs, max_slots=2, total_pages=9, page_size=4, pages_per_seq=8)
    assert eng.stats.pages_high_water <= 8


@pytest.mark.parametrize("block", [1, 4])
def test_paged_preemption_and_stream(models, block):
    """Recompute preemption of the youngest sequence; the streams, which a
    replayed request must not repeat, equal the outputs and JAX's."""
    streams = {}
    p1, p2 = _prompts(models, (7, 6), seed=2)
    reqs = [Request(0, p1, max_new_tokens=8), Request(1, p2, max_new_tokens=8)]
    jm, pm = models
    kw = dict(max_slots=2, total_pages=5, page_size=4, pages_per_seq=8, decode_block=block)
    out, eng = _both(models, reqs, **kw)
    assert eng.stats.preemptions >= 1
    eng = PagedContinuousBatchEngine(
        pm, on_token=lambda rid, tok: streams.setdefault(rid, []).append(tok), **kw)
    out = eng.run(reqs)
    for rid in out:
        np.testing.assert_array_equal(np.asarray(streams[rid], np.int32), out[rid])


def test_paged_nondividing_page_size(models):
    reqs = [Request(0, _prompts(models, (60,), seed=3)[0], max_new_tokens=6)]
    _both(models, reqs, max_slots=1, total_pages=8, page_size=48, pages_per_seq=4)


def test_paged_engine_stats(models):
    reqs = [Request(i, p, max_new_tokens=14) for i, p in enumerate(_prompts(models, (7, 9), 4))]
    _, eng = _both(models, reqs, max_slots=2, total_pages=6, page_size=8, pages_per_seq=4)
    st = eng.stats
    assert st.requests_completed == 2 and st.preemptions >= 1
    assert st.prefills == 2 + st.preemptions              # each preempted prompt re-prefills
    assert st.tokens_generated >= 28 and 0 < st.pages_high_water <= 5
    assert st.steps > 0 and st.step_time_s > 0 and st.decode_tok_s() > 0
    snap = st.snapshot()
    assert snap["decode_tok_s"] == round(st.decode_tok_s(), 2) and snap["steps"] == st.steps


def test_paged_refusals(models):
    jm, pm = models
    eng = PagedContinuousBatchEngine(pm, max_slots=1, total_pages=8, page_size=4,
                                     pages_per_seq=4)
    with pytest.raises(ValueError, match="exceed"):
        eng.submit(Request(0, np.arange(10, dtype=np.int32), max_new_tokens=10))
    eng = PagedContinuousBatchEngine(pm, max_slots=1, total_pages=8, page_size=4,
                                     pages_per_seq=16)
    with pytest.raises(ValueError, match="pool"):
        eng.submit(Request(0, np.arange(29, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(ValueError, match="decode_block"):
        PagedContinuousBatchEngine(pm, page_size=4, pages_per_seq=2, decode_block=8)
    moe = SimpleNamespace(**vars(pm), )
    moe.cfg = dataclasses.replace(pm.cfg, moe_num_experts=8)
    assert paged_cfg_ok(pm.cfg) and not paged_cfg_ok(moe.cfg)
    with pytest.raises(NotImplementedError, match="rope/GQA"):
        PagedContinuousBatchEngine(moe)
    adapted = SimpleNamespace(**vars(pm))
    adapted.params = dict(pm.params, layers=[dict(b, attn=dict(b["attn"], adaption=None))
                                             for b in pm.params["layers"]])
    with pytest.raises(NotImplementedError, match="adaption"):
        PagedContinuousBatchEngine(adapted)
    with pytest.raises(ValueError, match="use_kernel"):
        PagedContinuousBatchEngine(pm, use_kernel=True)
    # the engine runs on the card unless its model is on the CPU
    carded = SimpleNamespace(params=pm.params, cfg=pm.cfg, dtype=pm.dtype)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedContinuousBatchEngine(carded)


def test_prefix_cache_shares_pages_and_matches(models):
    p = _prompts(models, (21,), seed=5)[0]
    reqs = [Request(0, p, max_new_tokens=6), Request(1, p.copy(), max_new_tokens=6)]
    out, eng = _both(models, reqs, max_slots=2, total_pages=32, page_size=8, pages_per_seq=8,
                     enable_prefix_cache=True)
    np.testing.assert_array_equal(out[0], out[1])
    assert eng.stats.prefix_hit_tokens == 16 and eng.pages_cached() > 0


def test_prefix_cache_reuse_after_retirement_and_eviction(models):
    """A retired request's prompt pages serve a later identical prompt (only
    the suffix prefilled), then pool pressure evicts cached pages (LRU)."""
    p = _prompts(models, (19,), seed=6)[0]
    others = _prompts(models, (17, 17), seed=7)
    runs = [[Request(0, p, max_new_tokens=5)], [Request(1, p.copy(), max_new_tokens=5)],
            [Request(2, others[0], max_new_tokens=8)], [Request(3, others[1], max_new_tokens=8)]]
    outs, eng = _both(models, runs, runs=4, max_slots=1, total_pages=8, page_size=8,
                      pages_per_seq=6, enable_prefix_cache=True)
    np.testing.assert_array_equal(outs[0][0], outs[1][1])
    assert eng.stats.prefix_hit_tokens == 16 and eng.stats.prefill_tokens == 19 + 3 + 34


def test_prefix_cache_partial_prefix_and_preemption(models):
    base = _prompts(models, (20,), seed=8)[0]
    other = base.copy()
    other[10:] = _prompts(models, (10,), seed=9)[0]
    reqs = [Request(0, base, max_new_tokens=6), Request(1, other, max_new_tokens=6)]
    _, eng = _both(models, reqs, max_slots=2, total_pages=32, page_size=8, pages_per_seq=8,
                   enable_prefix_cache=True)
    assert eng.stats.prefix_hit_tokens == 8
    p1, p2 = _prompts(models, (7, 6), seed=10)
    reqs = [Request(0, p1, max_new_tokens=8), Request(1, p2, max_new_tokens=8)]
    _, eng = _both(models, reqs, max_slots=2, total_pages=6, page_size=4, pages_per_seq=8,
                   enable_prefix_cache=True)
    assert eng.stats.preemptions >= 1


def _block_reqs(models, seed, n=3, max_new=9, lengths=(5, 11, 17), **kw):
    return [Request(i, p, max_new_tokens=max_new, **kw)
            for i, p in enumerate(_prompts(models, lengths[:n], seed))]


@pytest.mark.parametrize("case", ["greedy", "eos", "preempt", "near_cap", "prefix"])
def test_paged_block_matches_jax(models, case):
    """``decode_block`` > 1 against the JAX block engine, and against the
    port's one-step engine."""
    kw = dict(max_slots=2, total_pages=32, page_size=8, pages_per_seq=8)
    block = 4
    if case == "greedy":
        reqs = _block_reqs(models, 2)
    elif case == "eos":
        prompt = _prompts(models, (6,), 5)[0]
        probe = PagedContinuousBatchEngine(models[1], **kw).run([Request(0, prompt,
                                                                         max_new_tokens=10)])
        reqs = [Request(0, prompt, max_new_tokens=10, eos_token_id=int(probe[0][4]),
                        min_new_tokens=2)]
        kw["max_slots"] = 1
    elif case == "preempt":
        reqs = _block_reqs(models, 7, max_new=12, lengths=(9, 9, 9))
        kw.update(max_slots=3, total_pages=8)   # 7 usable pages for 3 x 3: preempts
    elif case == "near_cap":   # prompt 11 + 12 new = 23 of a 24-token cap
        reqs = [Request(0, _prompts(models, (11,), 9)[0], max_new_tokens=12)]
        kw.update(max_slots=1, total_pages=8, pages_per_seq=3)
    else:
        r = np.random.default_rng(11)
        shared = r.integers(0, 256, size=(16,)).astype(np.int32)
        reqs = [Request(i, np.concatenate([shared, r.integers(0, 256, size=(3 + i,))
                                           .astype(np.int32)]), max_new_tokens=7)
                for i in range(3)]
        kw["enable_prefix_cache"] = True
        block = 3
    out, eng = _both(models, reqs, decode_block=block, **kw)
    one = PagedContinuousBatchEngine(models[1], **kw).run(list(reqs))
    for rid in one:
        np.testing.assert_array_equal(out[rid], one[rid])
    if case == "preempt":
        assert eng.stats.preemptions >= 1
    if case == "prefix":
        assert eng.stats.prefix_hit_tokens > 0


class _TupleReplayingStub:
    """A stub CUDA graph for the engine's step, whose output is ``(tokens,
    logits)``: the warm-up runs the step, the capture records it without
    running it, each replay runs it and overwrites the capture's output."""

    def __init__(self):
        self.replays = self.captures = 0

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.captures += 1
        self.fn = fn
        self.out = (torch.empty(0, dtype=torch.int32), torch.empty(0))
        return self.out

    def replay(self):
        self.replays += 1
        for held, new in zip(self.out, self.fn()):
            held.resize_(new.shape).copy_(new)


def test_warmup_captures_every_step_and_the_run_no_more(models, monkeypatch):
    kw = dict(max_slots=2, total_pages=32, page_size=8, pages_per_seq=8, decode_block=3,
              enable_prefix_cache=True)
    r = np.random.default_rng(13)
    reqs = [Request(i, r.integers(0, 256, size=(6 + 9 * i,)).astype(np.int32),
                    max_new_tokens=8) for i in range(3)]
    reqs.append(Request(3, reqs[2].prompt.copy(), max_new_tokens=5, temperature=0.7, seed=2))
    want = PagedContinuousBatchEngine(models[1], **kw).run(list(reqs))
    graphs = []

    def stepper(step, device, capturable=True):
        graphs.append(_TupleReplayingStub())
        return build.StepGraph(step, graph=graphs[-1])

    monkeypatch.setattr(generation, "_stepper", stepper)
    eng = PagedContinuousBatchEngine(models[1], **kw)
    eng.warmup()
    assert sorted(eng._steps) == [(False, 1), (False, 3), (True, 1), (True, 3)]
    assert len(graphs) == 4 and all(g.captures == 1 for g in graphs)
    assert all(st.req is None for st in eng.slots) and eng.pages_in_use() == 0
    assert eng.stats == serving.EngineStats() and not eng.tables.any()
    got = eng.run(reqs)
    assert len(graphs) == 4 and all(g.captures == 1 for g in graphs)
    assert sum(g.replays for g in graphs) > 4
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_sampling_top_k1_and_tiny_top_p_match_jax(models):
    p = _prompts(models, (5, 9, 6), seed=14)
    reqs = [Request(0, p[0], max_new_tokens=6, temperature=0.8, top_k=1, seed=11),
            Request(1, p[1], max_new_tokens=6, temperature=0.9, top_p=1e-6, seed=3),
            Request(2, p[2], max_new_tokens=6, temperature=1.3, top_k=1, top_p=0.5, seed=5,
                    eos_token_id=7, min_new_tokens=3)]
    _both(models, reqs, max_slots=2, total_pages=16, page_size=8, pages_per_seq=8)


def test_sampler_draws_match_jax_distribution():
    """4096 rows of one [16] logits row, each its own seed: the port's draws
    and JAX's have the same support (top-k 10, then the top-p 0.9 nucleus,
    EOS masked) and frequencies within 0.03 of each other."""
    n, v = 4096, 16
    rng = np.random.default_rng(15)
    row = (rng.standard_normal(v) * 1.5).astype(np.float32)
    logits = np.tile(row, (n, 1))
    args = dict(temps=np.full(n, 0.9, np.float32), top_ps=np.full(n, 0.9, np.float32),
                top_ks=np.full(n, 10, np.int32), seeds=np.arange(n, dtype=np.int32),
                steps=np.full(n, 3, np.int32), eos_ids=np.full(n, int(np.argmax(row)), np.int32),
                min_left=np.ones(n, np.int32))
    got = serving._sample_tokens(torch.from_numpy(logits),
                                 *(torch.from_numpy(a) for a in args.values())).numpy()
    want = np.asarray(jserving._sample_tokens(jnp.asarray(logits),
                                              *(jnp.asarray(a) for a in args.values())))
    assert set(np.unique(got)) == set(np.unique(want)) and int(np.argmax(row)) not in got
    freq = lambda t: np.bincount(t, minlength=v) / n
    assert np.abs(freq(got) - freq(want)).max() < 0.03
    # the draw is keyed by (seed, step, vocabulary index) alone
    again = serving._sample_tokens(torch.from_numpy(logits[:8]),
                                   *(torch.from_numpy(a[:8]) for a in args.values()))
    np.testing.assert_array_equal(again.numpy(), got[:8])


def test_sampled_stream_ignores_traffic_preemption_and_blocks(models):
    p1, p2 = _prompts(models, (7, 6), seed=16)
    sampled = Request(1, p2, max_new_tokens=8, temperature=0.9, top_k=13, top_p=0.95, seed=41)
    pm = models[1]
    alone = PagedContinuousBatchEngine(pm, max_slots=2, total_pages=32, page_size=4,
                                       pages_per_seq=8).run([sampled])
    busy = PagedContinuousBatchEngine(pm, max_slots=2, total_pages=5, page_size=4,
                                      pages_per_seq=8)
    out = busy.run([Request(0, p1, max_new_tokens=8), sampled])
    assert busy.stats.preemptions >= 1
    np.testing.assert_array_equal(out[1], alone[1])
    blocked = PagedContinuousBatchEngine(pm, max_slots=2, total_pages=32, page_size=4,
                                         pages_per_seq=8, decode_block=3).run([sampled])
    np.testing.assert_array_equal(blocked[1], alone[1])
