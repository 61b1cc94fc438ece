"""The port's slot engine (``serving.ContinuousBatchEngine``) on the CPU against
the JAX package's ``ContinuousBatchEngine`` on the same tiny random quantized
Llama (``tests/test_serving.py``'s ``Shim``: 2 layers, hidden 128, 4/2 heads,
g32, f32; the draft the same shape from another seed), carried across with
``utils/convert.params_from_jax``, on the request traces of
``tests/test_serving.py``, ``test_serving_v2.py`` and ``test_serving_block.py``.
Token streams and ``EngineStats`` (all but the wall time) are equal.

* Greedy mixed lengths with slot reuse and EOS; ``kv_quant``; chunked
  prefill with chunks that do not divide the prompts, interleaved with
  decode; ``decode_block`` (greedy, sampled, EOS with ``min_new_tokens``,
  chunked, slot reuse); speculative serving (draft == target, a different
  draft, int8, chunked prefill, EOS with streaming, and the fall-back to the
  plain step when a sampled slot is present); ``cancel``, streaming,
  ``min_new_tokens`` and the refusals; a tiny Mixtral and an adaption-prompt
  model on one short trace each.
* Sampled requests keep the port's contract (``serving.py``), not JAX's bits: ``top_k = 1``
  equals greedy, and a stream does not change with the traffic beside it or
  under ``decode_block``.
* ``warmup()`` through a stub graph: every decode step captured, and a run
  after it captures nothing new.
* K8a's plain version in its per-row cursor mode (``rope_write_kv_ref(cursors=)``)
  against JAX's ``.at[layer, rows, idx].set(..., mode="drop")`` scatter of
  ``apply_rope``'s K and V (``_kv_quantize``'s codes and scales for int8), at
  T = 1 and T = 4, with a row parked at S - 1 and rows at and past S
  (dropped); a negative cursor refused.

JAX engines share their compiled functions wherever these do not depend on
the engine's configuration (``_jax_engine``).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu import serving as jserving
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.models import params as jparams
from autogptq_tpu.utils import peft as jpeft
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch import serving
from autogptq_tpu_torch.models import params as params_lib
from autogptq_tpu_torch.ops import build, paged_attn
from autogptq_tpu_torch.serving import ContinuousBatchEngine, Request
from autogptq_tpu_torch.serving_paged import PagedContinuousBatchEngine
from autogptq_tpu_torch.utils import generation
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import write_random_checkpoint

from test_serving import Shim
from test_torch_moe import TINY as MIXTRAL_TINY
from test_torch_serving_paged import _TupleReplayingStub
from test_torch_speculative import port_of

_shared: dict = {}
S128 = dict(max_slots=2, max_seq_len=128)


@pytest.fixture(scope="module")
def models():
    jm, jd = Shim(), Shim(seed=123)
    return SimpleNamespace(jm=jm, pm=port_of(jm), jd=jd, pd=port_of(jd))


def _jax_engine(jm, **kw):
    """A JAX engine whose compiled functions are shared with every engine that
    builds them alike: each cache of jitted functions is keyed by what its
    functions read of the engine beside their arguments (a jitted function
    retraces for new argument shapes by itself)."""
    eng = jserving.ContinuousBatchEngine(jm, **kw)
    # a draft's functions read its configuration, its weights come in as arguments
    draft = getattr(kw.get("draft_model"), "cfg", None)
    keys = {"_decode_fns": (), "_block_fns": (), "_prefill_fns": (eng.kv_quant,),
            "_chunk_fns": (eng.kv_quant, eng.prefill_chunk), "_spec_fns": (draft, eng.spec_gamma),
            "_draft_prefill_fns": (draft,)}
    for name, key in keys.items():
        setattr(eng, name, _shared.setdefault((name, id(jm)) + key, getattr(eng, name)))
    return eng


def _jax_reqs(reqs):
    return [jserving.Request(**dataclasses.asdict(r)) for r in reqs]


def _stats(eng):
    d = dataclasses.asdict(eng.stats)
    d.pop("step_time_s")
    return d


def _draft_kw(m, kw):
    """kw with the draft named by "target" / "other" resolved to the JAX and
    the port model."""
    d = kw.pop("draft", None)
    if d is None:
        return kw, kw
    jd, pd = (m.jm, m.pm) if d == "target" else (m.jd, m.pd)
    return dict(kw, draft_model=jd), dict(kw, draft_model=pd)


def _both(m, reqs, jm=None, pm=None, **kw):
    """Both engines over ``reqs``: outputs and stats equal. Returns the port's
    outputs and engine."""
    jkw, pkw = _draft_kw(m, dict(kw))
    jeng = _jax_engine(jm or m.jm, **jkw)
    peng = ContinuousBatchEngine(pm or m.pm, **pkw)
    want = jeng.run(_jax_reqs(reqs))
    got = peng.run(list(reqs))
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"request {rid}")
    assert _stats(peng) == _stats(jeng)
    assert all(st.req is None for st in peng.slots)
    return got, peng


def _prompts(lengths, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(p,)).astype(np.int32) for p in lengths]


def _greedy(m, prompt, n, **kw):
    """The port's plain engine, one request alone: its greedy stream."""
    return ContinuousBatchEngine(m.pm, **dict(S128, **kw)).run(
        [Request(0, prompt, max_new_tokens=n)])[0]


# -- greedy, int8, chunked, blocks --------------------------------------------

@pytest.mark.parametrize("case", ["mixed", "reuse_eos", "kv_quant"])
def test_greedy_matches_jax_engine(models, case):
    if case == "reuse_eos":
        p1, p2, p3 = _prompts((4, 6, 5), 1)
        eos = int(_greedy(models, p3, 8)[2])
        reqs = [Request(0, p1, max_new_tokens=4), Request(1, p2, max_new_tokens=3),
                Request(2, p3, max_new_tokens=8, eos_token_id=eos)]
        got, _ = _both(models, reqs, max_slots=1, max_seq_len=64)
        assert len(got[2]) == 3 and got[2][-1] == eos
        return
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(_prompts((5, 9, 17), 0))]
    got, eng = _both(models, reqs, kv_quant=case == "kv_quant", **S128)
    assert eng._cache.k.dtype == (torch.int8 if case == "kv_quant" else torch.float32)
    if case == "mixed":
        for i, r in enumerate(reqs):   # each equals the request decoded alone
            np.testing.assert_array_equal(got[i], _greedy(models, r.prompt, 6))


@pytest.mark.parametrize("case", ["mixed", "nondividing", "kv_quant"])
def test_chunked_prefill_matches_jax_engine(models, case):
    if case == "mixed":
        reqs = [Request(i, p, max_new_tokens=6)
                for i, p in enumerate(_prompts((21, 5, 13, 30), 2))]
        _both(models, reqs, prefill_chunk=8, **S128)
    elif case == "nondividing":
        _both(models, [Request(0, _prompts((100,), 3)[0], max_new_tokens=6)], prefill_chunk=48,
              **S128)
    else:
        _both(models, [Request(0, _prompts((19,), 4)[0], max_new_tokens=6)], kv_quant=True,
              prefill_chunk=8, **S128)


def test_chunked_prefill_interleaves_with_decode(models):
    """A long prompt arriving while another slot decodes does not stall it:
    the decoding slot advances on every step, one chunk per step, exactly as
    the JAX engine schedules it."""
    short, long = _prompts((4, 40), 5)
    engines = (_jax_engine(models.jm, prefill_chunk=8, **S128),
               ContinuousBatchEngine(models.pm, prefill_chunk=8, **S128))
    progress = []
    for eng, req in zip(engines, (jserving.Request, Request)):
        eng.submit(req(0, short, max_new_tokens=10))
        eng.step()
        eng.submit(req(1, long, max_new_tokens=3))
        prog = []
        for _ in range(6):
            eng.step()
            prog.append((len(eng.slots[0].generated), eng.slots[1].pf_pos))
        while eng.queue or any(st.req is not None for st in eng.slots):
            eng.step()
        progress.append(prog)
    assert progress[0] == progress[1]
    assert [g for g, _ in progress[1]] == list(range(3, 9))
    for rid in (0, 1):
        np.testing.assert_array_equal(engines[1].finished[rid], engines[0].finished[rid])


@pytest.mark.parametrize("case", ["greedy", "sampled", "eos_min_new", "chunked", "reuse"])
def test_decode_block_matches_jax_engine(models, case):
    if case in ("greedy", "sampled"):
        kw = (dict(temperature=0.8, top_p=0.9, top_k=17) if case == "sampled" else {})
        reqs = [Request(i, p, max_new_tokens=9 if kw else 11, seed=100 + i, **kw)
                for i, p in enumerate(_prompts((5, 9, 17) if not kw else (8, 8, 8), 7))]
        if not kw:
            _both(models, reqs, decode_block=4, **S128)
            return
        # sampling keeps the contract, not JAX's bits: the block stream equals the one-step one
        plain = ContinuousBatchEngine(models.pm, **S128).run(list(reqs))
        blk = ContinuousBatchEngine(models.pm, decode_block=4, **S128)
        got = blk.run(list(reqs))
        for rid in plain:
            np.testing.assert_array_equal(got[rid], plain[rid])
        assert blk.stats.steps > blk.stats.tokens_generated / 3
        return
    if case == "eos_min_new":
        prompt = _prompts((6,), 8)[0]
        eos = int(_greedy(models, prompt, 12)[4])
        _both(models, [Request(0, prompt, max_new_tokens=12, eos_token_id=eos,
                                min_new_tokens=3)], max_slots=1, max_seq_len=128,
              decode_block=4)
    elif case == "chunked":
        long_p, short_p = _prompts((40, 4), 11)
        _both(models, [Request(0, short_p, max_new_tokens=10), Request(1, long_p,
                                                                        max_new_tokens=10)],
              prefill_chunk=16, decode_block=4, **S128)
    else:
        reqs = [Request(i, p, max_new_tokens=5 + i)
                for i, p in enumerate(_prompts((5, 7, 9, 11), 13))]
        _both(models, reqs, decode_block=3, **S128)


# -- speculative serving --------------------------------------------------------

@pytest.mark.parametrize("draft", ["target", "other"])
def test_spec_serving_matches_jax_and_plain_engine(models, draft):
    prompts = _prompts((5, 9, 3), 14)
    reqs = [Request(i, p, max_new_tokens=n) for i, (p, n) in enumerate(zip(prompts, (12, 7, 9)))]
    plain = ContinuousBatchEngine(models.pm, **S128).run(list(reqs))
    got, eng = _both(models, reqs, draft=draft, spec_gamma=3, **S128)
    for rid in plain:
        np.testing.assert_array_equal(got[rid], plain[rid])
    assert eng.spec_steps == eng.stats.steps and eng.stats.tokens_generated >= 28
    if draft == "target":   # near-full acceptance: fewer steps than tokens
        assert eng.stats.steps < 28


@pytest.mark.parametrize("case", ["kv_quant", "chunked", "eos_stream"])
def test_spec_serving_variants_match_jax_engine(models, case):
    if case == "kv_quant":
        reqs = [Request(i, p, max_new_tokens=9) for i, p in enumerate(_prompts((5, 8), 15))]
        _both(models, reqs, kv_quant=True, draft="other", spec_gamma=3, **S128)
        return
    if case == "chunked":
        reqs = [Request(0, _prompts((40,), 16)[0], max_new_tokens=10)]
        _, eng = _both(models, reqs, prefill_chunk=16, draft="other", spec_gamma=3, **S128)
        assert eng.spec_steps > 0
        return
    p = _prompts((6,), 17)[0]
    eos = int(_greedy(models, p, 12)[4])
    req = Request(0, p, max_new_tokens=12, eos_token_id=eos)
    streams = {"jax": [], "port": []}
    kw = dict(spec_gamma=3, **S128)
    want = _jax_engine(models.jm, draft_model=models.jd, **kw)
    want.on_token = lambda rid, t: streams["jax"].append(t)
    want = want.run(_jax_reqs([req]))
    got = ContinuousBatchEngine(models.pm, draft_model=models.pd,
                                on_token=lambda rid, t: streams["port"].append(t), **kw).run([req])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(np.asarray(streams["port"], np.int32), got[0])
    assert streams["port"] == [int(t) for t in streams["jax"]]


def test_spec_serving_falls_back_for_sampling(models):
    """A sampled slot beside a greedy one: the plain step runs every time
    (never the speculative one), and the streams are the plain engine's."""
    p0, p1 = _prompts((5, 7), 18)
    reqs = [Request(0, p0, max_new_tokens=8),
            Request(1, p1, max_new_tokens=8, temperature=0.9, seed=7)]
    plain = ContinuousBatchEngine(models.pm, **S128).run(list(reqs))
    eng = ContinuousBatchEngine(models.pm, draft_model=models.pm, **S128)
    got = eng.run(list(reqs))
    for rid in plain:
        np.testing.assert_array_equal(got[rid], plain[rid])
    assert eng.spec_steps == 0
    np.testing.assert_array_equal(got[0], _jax_engine(models.jm, **S128).run(
        _jax_reqs(reqs[:1]))[0])


# -- cancel, streaming, min_new_tokens, refusals -------------------------------

def test_cancel_streaming_and_min_new_match_jax(models):
    p = _prompts((5,), 19)[0]
    finished, streams = [], []
    for eng, req in ((_jax_engine(models.jm, max_slots=1, max_seq_len=64), jserving.Request),
                     (ContinuousBatchEngine(models.pm, max_slots=1, max_seq_len=64), Request)):
        stream = []
        eng.on_token = lambda rid, tok, stream=stream: stream.append((rid, int(tok)))
        eng.submit(req(0, p, max_new_tokens=30))
        eng.submit(req(1, p, max_new_tokens=5))    # queued behind request 0
        eng.submit(req(2, p, max_new_tokens=5))
        eng.step()
        eng.step()
        assert eng.cancel(0) and eng.cancel(2) and not eng.cancel(99)
        while eng.queue or any(st.req is not None for st in eng.slots):
            eng.step()
        finished.append(eng.finished)
        streams.append(stream)
    assert set(finished[0]) == set(finished[1]) == {0, 1, 2}
    for rid in finished[0]:
        np.testing.assert_array_equal(finished[1][rid], finished[0][rid])
    assert len(finished[1][0]) == 3 and len(finished[1][2]) == 0
    assert streams[1] == streams[0]
    np.testing.assert_array_equal([t for rid, t in streams[1] if rid == 1], finished[1][1])
    eos = int(_greedy(models, p, 8, max_slots=1)[1])
    got, _ = _both(models, [Request(0, p, max_new_tokens=8, eos_token_id=eos, min_new_tokens=5),
                            Request(1, p, max_new_tokens=8, eos_token_id=eos)],
                   max_slots=1, max_seq_len=64)
    assert eos not in list(got[0][:5]) and len(got[1]) == 2 and got[1][-1] == eos


def test_refusals(models):
    pm = models.pm
    eng = ContinuousBatchEngine(pm, max_slots=1, max_seq_len=32)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(Request(0, np.arange(20, dtype=np.int32), max_new_tokens=20))
    eng = ContinuousBatchEngine(pm, max_slots=1, max_seq_len=48, prefill_chunk=None)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(Request(0, np.arange(40, dtype=np.int32), max_new_tokens=8))
    eng = ContinuousBatchEngine(pm, max_slots=1, max_seq_len=48, prefill_chunk=8)
    with pytest.raises(ValueError, match="chunked request needs"):   # _start_chunked's
        eng._start_chunked(0, Request(0, np.arange(40, dtype=np.int32), max_new_tokens=8))
    for block in (0, 48):
        with pytest.raises(ValueError, match="decode_block"):
            ContinuousBatchEngine(pm, max_slots=1, max_seq_len=48, decode_block=block)
    bad = SimpleNamespace(params=pm.params, cfg=dataclasses.replace(pm.cfg, vocab_size=128),
                          dtype=pm.dtype, device=pm.device)
    with pytest.raises(ValueError, match="vocabulary"):
        ContinuousBatchEngine(pm, draft_model=bad)
    with pytest.raises(NotImplementedError, match="Parallelism"):
        ContinuousBatchEngine(SimpleNamespace(**vars(pm), is_tp=True))
    mla = SimpleNamespace(**dict(vars(pm), cfg=SimpleNamespace(**dict(
        dataclasses.asdict(pm.cfg), attn_variant="mla"))))
    with pytest.raises(NotImplementedError, match="Other families"):
        ContinuousBatchEngine(mla)


# -- other models ---------------------------------------------------------------

def test_mixtral_and_adaption_prompt_match_jax(models, tmp_path_factory):
    path = write_random_checkpoint(str(tmp_path_factory.mktemp("tiny_serve_moe")), MIXTRAL_TINY,
                                   bits=4, group_size=32, seed=3)
    port = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(path, dtype=jnp.float32)
    port.params = params_lib.stack_moe_experts(port.params)
    ref.params = jparams.stack_moe_experts(ref.params)
    # a 32-slot cache: one prefill bucket and one decode window for JAX to compile
    reqs = [Request(i, p, max_new_tokens=5) for i, p in enumerate(_prompts((5, 9), 20, 512))]
    _both(models, reqs, jm=ref, pm=port, max_slots=2, max_seq_len=32)

    jp = jpeft.inject_adaption_prompt(models.jm.params, jpeft.AdaptionPromptConfig(4, 2))
    trainable, _ = jpeft.split_lora_params(jp)
    leaves, treedef = jax.tree_util.tree_flatten(trainable)
    rng = np.random.default_rng(21)
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32))
              for x in leaves]
    jp = jpeft.merge_lora_params(jp, jax.tree_util.tree_unflatten(treedef, leaves))
    jad = SimpleNamespace(params=jp, cfg=models.jm.cfg, backend="xla", dtype=jnp.float32)
    pad = SimpleNamespace(params=params_from_jax(jp, device="cpu", dtype=torch.float32),
                          cfg=models.pm.cfg, dtype=torch.float32, device=torch.device("cpu"))
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(_prompts((5, 9, 17), 22))]
    got, _ = _both(models, reqs, jm=jad, pm=pad, max_slots=2, max_seq_len=32)
    plain = ContinuousBatchEngine(models.pm, **S128).run(list(reqs))
    assert any(not np.array_equal(got[r], plain[r]) for r in plain)   # the prompt took part
    # the paged engine refuses an adaption prompt and names this engine
    with pytest.raises(NotImplementedError, match="ContinuousBatchEngine"):
        PagedContinuousBatchEngine(pad)


# -- sampling -------------------------------------------------------------------

def test_sampling_contract(models):
    """``top_k = 1`` gives the greedy stream; a sampled stream does not
    change with the traffic beside it, nor under a decode block."""
    p, other = _prompts((7, 6), 23)
    top1 = ContinuousBatchEngine(models.pm, max_slots=1, max_seq_len=64).run(
        [Request(0, p, max_new_tokens=6, temperature=1.0, top_k=1)])
    np.testing.assert_array_equal(top1[0], _greedy(models, p, 6))
    req = Request(0, p, max_new_tokens=8, temperature=0.9, top_k=13, top_p=0.95, seed=42)
    solo = ContinuousBatchEngine(models.pm, **S128).run([req])
    busy = ContinuousBatchEngine(models.pm, **S128).run(
        [req, Request(1, other, max_new_tokens=8, temperature=1.3, seed=7)])
    blocked = ContinuousBatchEngine(models.pm, decode_block=3, **S128).run([req])
    np.testing.assert_array_equal(busy[0], solo[0])
    np.testing.assert_array_equal(blocked[0], solo[0])


# -- capture ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True])
def test_warmup_captures_every_step_and_the_run_no_more(models, monkeypatch, kv_quant):
    """One graph per (sampling, block) for a float cache (K2 reads each
    row's live slots); an int8 cache's einsum takes one per window bucket
    as well, 32 and the whole 64-slot cache."""
    kw = dict(max_slots=2, max_seq_len=64, decode_block=3, prefill_chunk=8, kv_quant=kv_quant)
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(_prompts((6, 15, 24), 24))]
    reqs.append(Request(3, reqs[2].prompt.copy(), max_new_tokens=5, temperature=0.7, seed=2))
    want = ContinuousBatchEngine(models.pm, **kw).run(list(reqs))
    graphs = []

    def stepper(step, device, capturable=True):
        graphs.append(_TupleReplayingStub())
        return build.StepGraph(step, graph=graphs[-1])

    monkeypatch.setattr(generation, "_stepper", stepper)
    eng = ContinuousBatchEngine(models.pm, **kw)
    eng.warmup()
    wins = (32, None) if kv_quant else (None,)
    assert set(eng._steps) == {(s, n, w) for s in (False, True) for n in (1, 3) for w in wins}
    assert len(graphs) == len(eng._steps) and all(g.captures == 1 for g in graphs)
    assert all(st.req is None for st in eng.slots) and not eng.lengths.any()
    assert eng.stats == serving.EngineStats()
    got = eng.run(list(reqs))
    assert len(graphs) == len(eng._steps) and all(g.captures == 1 for g in graphs)
    assert sum(g.replays for g in graphs) > len(graphs)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


# -- K8a's per-row mode ---------------------------------------------------------

@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_k8a_per_row_matches_jax_drop_scatter(t, int8):
    """Rows at cursors 3, 0, S - 1 (parked: at T > 1 its later tokens fall
    past S), S and S + 5 (dropped whole): the plain K8a writes JAX's rows
    into a bf16 cache (within one bf16 ulp: the rotations' f32 roundings may
    part by one) or an int8 one where JAX's drop scatter writes, and nothing
    elsewhere; q turned for every row."""
    rng = np.random.default_rng(25 + t + 10 * int8)
    n_layers, h, hkv, d, s = 2, 4, 2, 64, 16
    cursors = np.array([3, 0, s - 1, s, s + 5], np.int64)
    b = len(cursors)
    cfg = jarch.ArchConfig(head_dim=d, rope_theta=10000.0)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    pos = (cursors[:, None] + np.arange(t)[None, :])
    shape = (n_layers, b, s, hkv, d)
    if int8:
        caches = [torch.zeros(shape, dtype=torch.int8) for _ in range(2)]
        scales = [torch.zeros(shape[:-1] + (1,)) for _ in range(2)]
    else:
        caches = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]
        scales = [None, None]
    qr = paged_attn.rope_write_kv(
        torch.from_numpy(q.reshape(b * t, h, d)), torch.from_numpy(k.reshape(b * t, hkv, d)),
        torch.from_numpy(v.reshape(b * t, hkv, d)), torch.from_numpy(pos.reshape(-1)),
        paged_attn.rope_inv_freq(10000.0, d, "cpu"), *caches, 1,
        cursors=torch.from_numpy(cursors), k_scale=scales[0], v_scale=scales[1])
    jq, jk = jarch.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), cfg)
    np.testing.assert_allclose(qr.numpy().reshape(b, t, h, d), np.asarray(jq), rtol=1e-6,
                               atol=1e-6)
    rows, idx = jnp.arange(b)[:, None], jnp.asarray(pos)
    for cache, scale, new in ((caches[0], scales[0], jk), (caches[1], scales[1], jnp.asarray(v))):
        if int8:
            codes, sc = jarch._kv_quantize(new)
            want = jnp.zeros(shape, jnp.int8).at[1, rows, idx].set(codes, mode="drop")
            want_sc = jnp.zeros(shape[:-1] + (1,)).at[1, rows, idx].set(sc, mode="drop")
            # the scales of rows rotated apart by an f32 rounding: as test_torch_kv_quant holds them
            np.testing.assert_allclose(scale.numpy(), np.asarray(want_sc), rtol=1e-6, atol=0)
            np.testing.assert_array_equal(cache.numpy(), np.asarray(want))
        else:
            want = jnp.zeros(shape, jnp.bfloat16).at[1, rows, idx].set(
                new.astype(jnp.bfloat16), mode="drop")
            np.testing.assert_allclose(cache.float().numpy(), np.asarray(want, np.float32),
                                       rtol=2 ** -8, atol=0)
    assert caches[0][1, 2, s - 1].any() and not caches[0][1, 3:].any()
    with pytest.raises(ValueError, match="cursors >= 0"):
        paged_attn.rope_write_kv(
            torch.from_numpy(q.reshape(b * t, h, d)), torch.from_numpy(k.reshape(b * t, hkv, d)),
            torch.from_numpy(v.reshape(b * t, hkv, d)), torch.from_numpy(pos.reshape(-1)),
            paged_attn.rope_inv_freq(10000.0, d, "cpu"), *caches, 1,
            cursors=torch.from_numpy(cursors - 4), k_scale=scales[0], v_scale=scales[1])
