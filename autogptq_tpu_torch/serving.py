"""Continuous-batching inference on PyTorch and CUDA: the slot engine
(:class:`ContinuousBatchEngine`), and what the paged engine
(``serving_paged.py``) shares with it: the request, the engine's counters,
the prefill buckets and the per-row samplers.

Counterpart of the JAX package's ``serving.py``, with its constructor
arguments, public methods, ``EngineStats`` fields and refusals. A fixed pool
of ``max_slots`` slots shares one preallocated KV cache ``[L, slots,
max_seq_len, Hkv, D]`` (int8 with f32 scales under ``kv_quant``) with one
write cursor per slot (``arch.KVCache.cursors``):

* a prompt of at most ``prefill_chunk`` tokens is prefilled eagerly at its
  ``_bucket`` size (right-padded) and its K/V copied into a free slot; a
  longer one is prefilled chunk by chunk into the slot's own cache (the
  host-cursor path on the slot's ``[L, 1, S, Hkv, D]`` view), one chunk per
  engine step, round-robin, interleaved with decode, its decode cursor parked
  on the reserved last cell;
* the decode step (:class:`SlotStep`) runs every slot: the quantized
  projections at M = ``max_slots`` (K1's GEMV), RoPE and the K/V write at
  each slot's cursor in one K8a launch per layer (its per-row mode), K2 over
  ``[0, cursor + 1)`` (the einsum for an int8 cache and an adaption prompt,
  as in the JAX package), then the sampler, all on the device. It reads
  persistent buffers only, refilled from the host mirrors by one
  host-to-device copy per step; its cursors advance inside it. On the card
  with ``generation.JIT_GENERATE`` on, each (sampling flag, block length) is
  one CUDA graph (``build.StepGraph``), captured once; K2 reads only each
  slot's live slots, so the JAX engine's per-window retrace has no
  counterpart there, but a step that attends through the einsum (an int8
  cache, an adaption prompt) is captured once per window bucket and reads
  only that window, as the JAX engine's. ``decode_block`` > 1 runs that many
  steps per graph and per host sync;
* with ``draft_model``, when every active slot is greedy, owes no
  ``min_new_tokens`` and nothing is mid-prefill, the speculative step runs:
  ``spec_gamma + 1`` draft steps at the slots' cursors over the draft's own
  cache, one target forward over each slot's ``[cur, d_1..d_g]`` window,
  greedy acceptance, and the plain step's append and retire logic replayed
  over the accepted tokens. It runs eagerly, its steps window-bucketed as in
  the JAX engine (a ``KVCache.win`` view: writes past it dropped, the einsum
  over it), since its cursors advance by the accepted count.

Tensor parallelism waits for ROADMAP Queue 1's 'Parallelism' item and MLA
for its family ('Other families'); both are refused.

Sampling keeps the JAX package's contract, not its bits: a request's stream
depends only on its seed, its token index and its logits, never on the
traffic scheduled beside it or on a preemption. The JAX engine draws with
``jax.random.categorical`` keyed by ``fold_in(PRNGKey(seed), step)``, which
PyTorch cannot reproduce. :func:`_sample_tokens` draws by Gumbel-max over
noise hashed from (seed, step, vocabulary index) with integer tensor ops,
so the draw runs on the device, reads no host value and can be captured in
a CUDA graph; a ``torch.Generator`` per row is neither keyed that way nor
capturable. The filter follows HF's warper order exactly, as the JAX one
does: EOS masked while the row owes ``min_new_tokens``, then top-k, then
top-p over the renormalized rest, the token that crosses ``top_p`` kept.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .models import arch
from .models.arch import KVCache
from .ops.gemm import check_routed_errors
from .ops.paged_attn import check_page_errors, rope_inv_freq

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    # sampling (HF generate semantics): temperature 0 => greedy;
    # top_p/top_k filter the proposal distribution when temperature > 0
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    min_new_tokens: int = 0


@dataclasses.dataclass
class EngineStats:
    """Host-side serving counters. Times are host-perceived: each engine
    step's wall time from its inputs' copy to the card to its tokens back on
    the host, which is what a deployment's request clock sees."""

    steps: int = 0                 # decode steps dispatched
    step_time_s: float = 0.0       # wall time inside step()'s decode
    tokens_generated: int = 0      # decode tokens appended to live slots
    prefills: int = 0              # whole prompts ingested
    prefill_tokens: int = 0        # prompt tokens ingested
    requests_completed: int = 0
    preemptions: int = 0           # paged engine: recompute-preempted requests
    pages_high_water: int = 0      # paged engine: max pages in use at once
    prefix_hit_tokens: int = 0     # paged engine: prompt tokens served from the prefix cache

    def decode_tok_s(self) -> float:
        """Aggregate decode throughput (tokens per second of step() wall)."""
        return self.tokens_generated / self.step_time_s if self.step_time_s else 0.0

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["decode_tok_s"] = round(self.decode_tok_s(), 2)
        return d


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply) of int64 lanes holding
    values below 2**32; every product stays below 2**63."""
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    return h ^ (h >> 16)


def _gumbel(seeds: torch.Tensor, steps: torch.Tensor, v: int) -> torch.Tensor:
    """Gumbel noise ``[B, V]`` f32 keyed by each row's (seed, step) and the
    vocabulary index alone: 24 hashed bits per entry make a uniform in (0, 1)
    exactly, then ``-log(-log(u))``."""
    h = _mix32((seeds.long() & _M32) ^ 0x9E3779B9)
    h = _mix32(h ^ (steps.long() & _M32))
    idx = _mix32(torch.arange(v, dtype=torch.int64, device=seeds.device) + 0x7F4A7C15)
    bits = _mix32(h[:, None] ^ idx[None, :]) >> 8
    u = (bits.float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _suppress_eos(logits: torch.Tensor, eos_ids: torch.Tensor, min_left: torch.Tensor):
    v = logits.shape[-1]
    suppress = (min_left > 0)[:, None] & (
        torch.arange(v, device=logits.device)[None, :] == eos_ids[:, None])
    return torch.where(suppress, NEG_INF, logits.float())


def _sample_tokens(logits, temps, top_ps, top_ks, seeds, steps, eos_ids, min_left):
    """Per-row sampling ``[B, V] -> [B]`` int32 on the logits' device.

    Greedy rows (temperature 0) take the argmax; sampling rows draw from the
    temperature-scaled distribution restricted to the top-k set and then the
    top-p nucleus, in the sorted domain (a stable descending sort, as
    ``jnp.argsort(-x)`` orders ties). EOS is masked while the row still owes
    ``min_new_tokens``. The draw is Gumbel-max over :func:`_gumbel`'s noise,
    so a row's token depends on its seed, its step and its logits only."""
    b, v = logits.shape
    logits = _suppress_eos(logits, eos_ids, min_left)
    greedy = logits.argmax(dim=-1).to(torch.int32)

    scaled = logits / temps.clamp_min(1e-6)[:, None]
    sl, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    rank = torch.arange(v, device=logits.device)[None, :]
    # HF warper order: top-k first, then top-p over the renormalized rest
    k_eff = torch.where(top_ks > 0, top_ks, v)
    keep = rank < k_eff[:, None]
    sl_k = torch.where(keep, sl, NEG_INF)
    probs = torch.softmax(sl_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: the smallest prefix whose mass reaches top_p (the crossing token stays in)
    keep = keep & ((cum - probs) < top_ps[:, None])
    slf = torch.where(keep, sl_k, NEG_INF)
    noise = torch.gather(_gumbel(seeds, steps, v), 1, order)
    pos = (slf + noise).argmax(dim=-1, keepdim=True)
    sampled = torch.gather(order, 1, pos)[:, 0].to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


def _greedy_tokens(logits, eos_ids, min_left):
    return _suppress_eos(logits, eos_ids, min_left).argmax(dim=-1).to(torch.int32)


def first_token(req: Request, lrow: torch.Tensor) -> int:
    """Sample the first generated token from the prefill logits ``lrow [V]``
    with the request's sampling params (token index 0 keys the draw)."""
    def col(x, dt):
        return torch.tensor([x], dtype=dt, device=lrow.device)

    tok = _sample_tokens(lrow.reshape(1, -1), col(req.temperature, torch.float32),
                         col(req.top_p, torch.float32), col(req.top_k, torch.int32),
                         col(req.seed, torch.int32), col(0, torch.int32),
                         col(-1 if req.eos_token_id is None else req.eos_token_id, torch.int32),
                         col(req.min_new_tokens, torch.int32))
    return int(tok[0])


def prefill_bucket(model, prompt, bucket: int, device, cache_dtype=None, quantized: bool = False,
                   logits: bool = True):
    """A right-padded ``prompt`` through ``arch.forward`` into a one-row cache
    of ``bucket`` slots on ``device`` (``cache_dtype``, the model's by default,
    or int8 with ``quantized``): ``(the cache, the last prompt position's
    logits [V], or None without ``logits``)``."""
    p = len(prompt)
    tokens = torch.zeros((1, bucket), dtype=torch.int32)
    mask = torch.zeros((1, bucket), dtype=torch.int32)
    tokens[0, :p] = torch.as_tensor(np.asarray(prompt, np.int32))
    mask[0, :p] = 1
    tokens, mask = tokens.to(device), mask.to(device)
    cache = KVCache.create(model.cfg, 1, bucket, dtype=cache_dtype or model.dtype, device=device,
                           quantized=quantized)
    lg, cache = arch.forward(model.params, tokens, model.cfg, cache=cache, attn_mask=mask,
                             dtype=model.dtype, positions=(torch.cumsum(mask, -1) - 1).clamp_min(0),
                             logits_last_only=not logits)
    return cache, (lg[0, max(p, 1) - 1] if logits else None)


# The decode step's per-slot inputs: one run of max_slots values per field, read as its dtype.
STEP_FIELDS = (("lengths", torch.int32), ("cur", torch.int32), ("eos", torch.int32),
               ("min_left", torch.int32), ("temps", torch.float32), ("top_ps", torch.float32),
               ("top_ks", torch.int32), ("seeds", torch.int32), ("steps", torch.int32))


class StepInputs:
    """A decode step's persistent inputs: one int32 buffer on ``device``, the
    paged engine's tables first (``tables``, their shape) and then one run of
    ``slots`` values per :data:`STEP_FIELDS` field, read as the field's dtype
    (``dev``); :meth:`stage` refills it from the host mirrors by one
    host-to-device copy, so that a CUDA graph of the step reads it at fixed
    addresses."""

    def __init__(self, slots: int, device, tables: tuple = ()):
        self.slots, self.n_tables = slots, int(np.prod(tables)) if tables else 0
        n = self.n_tables + slots * len(STEP_FIELDS)
        self._host = torch.zeros(n, dtype=torch.int32, pin_memory=device.type == "cuda")
        self._host_np = self._host.numpy()
        self._buf = torch.zeros(n, dtype=torch.int32, device=device)
        views = {"tables": self._buf[:self.n_tables].view(*tables)} if tables else {}
        for i, (name, dt) in enumerate(STEP_FIELDS):
            part = self._buf[self.n_tables + i * slots:self.n_tables + (i + 1) * slots]
            views[name] = part if dt == torch.int32 else part.view(dt)
        self.dev = SimpleNamespace(**views)

    def stage(self, parts, tables: Optional[np.ndarray] = None) -> None:
        """``parts`` (host arrays in :data:`STEP_FIELDS` order) and the tables
        into the device buffer, one copy."""
        host, s, o = self._host_np, self.slots, self.n_tables
        if tables is not None:
            host[:o] = tables.reshape(-1)
        for i, part in enumerate(parts):
            host[o + i * s:o + (i + 1) * s] = np.ascontiguousarray(part).view(np.int32)
        self._buf.copy_(self._host, non_blocking=True)


# ---------------------------------------------------------------- the slot engine

@dataclasses.dataclass
class _SlotState:
    req: Optional[Request] = None
    generated: list = dataclasses.field(default_factory=list)
    pf_pos: int = 0          # chunked prefill: prompt tokens consumed so far
    prefilling: bool = False


class SlotStep:
    """``nblk`` decode steps of every slot over the persistent buffers of a
    :class:`ContinuousBatchEngine`: the cursors start at the staged
    ``lengths`` and advance inside ``arch.forward``; step ``j`` samples with
    ``min_left - j`` (floored at 0) and ``steps + j``, the tokens of one step
    feeding the next. ``win`` narrows the slots written and attended (the
    einsum's window). Returns ``(tokens [nblk, S] int32, the last step's
    logits [S, V] f32)``, which a CUDA graph's replays overwrite."""

    def __init__(self, engine: "ContinuousBatchEngine", sampling: bool, nblk: int,
                 win: Optional[int] = None):
        self.engine, self.sampling, self.nblk = engine, sampling, nblk
        self.cache = dataclasses.replace(engine._cache, win=win)   # the engine's tensors

    def __call__(self):
        e = self.engine
        d, cache = e._dev, self.cache
        cache.cursors.copy_(d.lengths)
        cur, toks, logits = d.cur, [], None
        for j in range(self.nblk):
            min_left = d.min_left if j == 0 else (d.min_left - j).clamp_min(0)
            logits = arch.forward(e.model.params, cur[:, None], e.cfg, cache=cache,
                                  dtype=e.dtype)[0][:, -1]
            if self.sampling:
                cur = _sample_tokens(logits, d.temps, d.top_ps, d.top_ks, d.seeds, d.steps + j,
                                     d.eos, min_left)
            else:
                cur = _greedy_tokens(logits, d.eos, min_left)
            toks.append(cur)
        return torch.stack(toks), logits


class ContinuousBatchEngine:
    """Slot-based continuous batching (see the module docstring).

    ``model`` has ``params``, ``cfg``, ``dtype`` and ``device`` (a
    ``GPTQModel``, as is ``draft_model``); the caches live on that device,
    the card unless the model is on the CPU. ``cache_dtype`` is the float
    cache's dtype (the model's by default), ``kv_quant`` takes an int8 cache
    instead; the draft's cache is always of its own dtype. ``on_token(req_id,
    token_id)`` streams every generated token as its engine step retires.
    ``decode_block`` > 1 runs that many decode steps per host sync when every
    active slot decodes; a slot that retires inside a block keeps writing
    into its own cache and its surplus tokens are dropped at emission."""

    def __init__(self, model, max_slots: int = 4, max_seq_len: int = 1024, cache_dtype=None,
                 kv_quant: bool = False, prefill_chunk: Optional[int] = 512, on_token=None,
                 draft_model=None, spec_gamma: int = 4, decode_block: int = 1):
        from .models.base import resolve_device

        if getattr(model, "is_tp", False):
            raise NotImplementedError("ContinuousBatchEngine: tensor parallelism is not ported yet "
                                      "(ROADMAP Queue 1, 'Parallelism'); use one device")
        if "mla" in (getattr(model.cfg, "attn_variant", None),
                     getattr(getattr(draft_model, "cfg", None), "attn_variant", None)):
            raise NotImplementedError("ContinuousBatchEngine: MLA models are not ported yet "
                                      "(ROADMAP Queue 1, 'Other families')")
        self.on_token = on_token
        self.model = model
        self.cfg = cfg = model.cfg
        self.dtype = model.dtype
        self.device = resolve_device(getattr(model, "device", "cuda"))
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.kv_quant = kv_quant
        self.prefill_chunk = prefill_chunk
        self.cache_dtype = torch.int8 if kv_quant else (cache_dtype or model.dtype)
        # the engine's cache, its per-slot cursors and K2's lo (0: a slot's cache starts at 0)
        self._cache = KVCache.create(cfg, max_slots, max_seq_len, dtype=self.cache_dtype,
                                     device=self.device, quantized=kv_quant)
        self._cache.cursors = torch.zeros(max_slots, dtype=torch.int64, device=self.device)
        self._cache.lo = torch.zeros(max_slots, dtype=torch.int32, device=self.device)
        self._cache.inv_freq = rope_inv_freq(cfg.rope_theta, cfg.head_dim, self.device)
        # a step that attends through the einsum (an int8 cache, an adaption prompt) is captured
        # once per window bucket, as the JAX engine compiles it, and reads only that window; K2
        # reads only each row's live slots, so a float step's one graph serves every length
        self._windowed = kv_quant or any("adaption" in b.get("attn", {})
                                         for b in model.params["layers"])
        # host mirrors of the cursors and tokens: both evolve deterministically (+1 per plain
        # step, + the accepted count per speculative step), so the host never reads them back
        self.lengths = np.zeros((max_slots,), np.int32)
        self.cur_tokens = np.zeros((max_slots,), np.int32)
        self._temps = np.zeros((max_slots,), np.float32)
        self._top_ps = np.ones((max_slots,), np.float32)
        self._top_ks = np.zeros((max_slots,), np.int32)
        self._seeds = np.zeros((max_slots,), np.int32)
        self._eos = np.full((max_slots,), -1, np.int32)
        self._min_new = np.zeros((max_slots,), np.int32)
        self.slots = [_SlotState() for _ in range(max_slots)]
        self.queue: deque[Request] = deque()
        self.finished: dict[int, np.ndarray] = {}
        self.stats = EngineStats()
        if not 1 <= decode_block < max_seq_len:
            raise ValueError("decode_block must be in [1, max_seq_len)")
        self.decode_block = decode_block
        self._pf_rr = 0   # round-robin over mid-prefill slots
        self.draft = draft_model
        self.spec_gamma = spec_gamma
        self.spec_steps = 0   # speculative steps taken (each one target forward)
        if draft_model is not None:
            if model.cfg.vocab_size != draft_model.cfg.vocab_size:
                raise ValueError("draft and target models must share a vocabulary")
            dcfg = draft_model.cfg
            self._d_cache = KVCache.create(dcfg, max_slots, max_seq_len, dtype=draft_model.dtype,
                                           device=self.device)
            self._d_cache.inv_freq = rope_inv_freq(dcfg.rope_theta, dcfg.head_dim, self.device)

        self._inputs = StepInputs(max_slots, self.device)
        self._dev = self._inputs.dev
        self._steps: dict[tuple, object] = {}   # (sampling, nblk) -> the step, or its graph

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        # prompt + generation must fit the slot cache: a write past it is dropped, so an
        # oversized request would corrupt its own attention rather than error
        need = len(req.prompt) + req.max_new_tokens
        chunked = (self.prefill_chunk is not None
                   and len(req.prompt) > self.prefill_chunk)
        limit = self.max_seq_len - (1 if chunked else 0)
        if need > limit:
            raise ValueError(
                f"request {req.req_id}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_seq_len {self.max_seq_len}"
            )
        if not chunked and _bucket(len(req.prompt)) > self.max_seq_len:
            # whole-prompt prefill pads to a power-of-two-ish bucket; a
            # bucket beyond the cache would fail at admission mid-run
            raise ValueError(
                f"request {req.req_id}: prompt length {len(req.prompt)} "
                f"rounds to prefill bucket {_bucket(len(req.prompt))} > "
                f"max_seq_len {self.max_seq_len}; use a prefill_chunk <= "
                f"{len(req.prompt) - 1} or a larger max_seq_len"
            )
        self.queue.append(req)

    def cancel(self, req_id: int) -> bool:
        """Cancel a queued or running request. Running requests free their
        slot immediately (partial output is recorded in ``finished``).
        Returns True if the request was found."""
        for i, r in enumerate(self.queue):
            if r.req_id == req_id:
                del self.queue[i]
                self.finished[req_id] = np.zeros((0,), np.int32)
                return True
        for slot, st in enumerate(self.slots):
            if st.req is not None and st.req.req_id == req_id:
                self.finished[req_id] = np.asarray(st.generated, np.int32)
                st.req = None
                st.generated = []
                st.prefilling = False
                self._temps[slot] = 0.0
                self._eos[slot] = -1
                self._min_new[slot] = 0
                self.lengths[slot] = 0
                return True
        return False

    @torch.inference_mode()
    def warmup(self, buckets=None, sampling: bool = True) -> None:
        """Run every prefill bucket the engine can hit (``buckets=None``: all
        up to ``max_seq_len``; the draft's too) and capture every decode
        graph a run can reach (one step and, with ``decode_block`` > 1, the
        block; greedy, and sampling with ``sampling``), so that serving
        captures nothing new. The host state is untouched; the warm-up steps
        write each slot's cache at its cursor, which the next real step of a
        live slot overwrites before any row attends it, as the JAX engine's
        warm-up does."""
        if buckets is None:
            buckets = sorted({_bucket(n) for n in range(1, self.max_seq_len + 1)
                              if _bucket(n) <= self.max_seq_len})
        for b in buckets:
            if b > self.max_seq_len:
                continue
            prefill_bucket(self.model, [0, 0], _bucket(b), self.device, self.cache_dtype,
                           self.kv_quant)
            if self.draft is not None:
                prefill_bucket(self.draft, [0, 0], _bucket(b), self.device, logits=False)
        zeros = np.zeros((self.max_slots,), np.int32)
        blocks = (1, self.decode_block) if self.decode_block > 1 else (1,)
        for s in (False, True) if sampling else (False,):
            for nblk in blocks:
                # the windows a step can ask for: a block's need counts its nblk tokens
                extra = nblk if nblk > 1 else 0
                wins = {self._step_window(need + extra)
                        for need in range(1, self.max_seq_len - extra + 1)}
                for win in wins:
                    for _ in range(2):   # the eager warm-up, then the capture and a replay
                        self._stage(zeros, zeros)
                        self._decode(s, nblk, win)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- whole-prompt (bucketed) prefill --------------------------------

    def _bind_slot(self, slot: int, req: Request, first_tok: int, length: int) -> None:
        self.lengths[slot] = length
        self.cur_tokens[slot] = first_tok
        self._temps[slot] = req.temperature
        self._top_ps[slot] = req.top_p
        self._top_ks[slot] = req.top_k
        self._seeds[slot] = req.seed
        self._eos[slot] = -1 if req.eos_token_id is None else req.eos_token_id
        self._min_new[slot] = req.min_new_tokens
        st = self.slots[slot]
        st.req = req
        st.generated = [first_tok]
        st.prefilling = False
        if self.draft is not None:
            self._draft_prefill(slot, req.prompt)
        if self.on_token is not None:
            self.on_token(req.req_id, first_tok)

    def _draft_prefill(self, slot: int, prompt) -> None:
        """Fill the draft's cache with the slot's prompt (a whole-prompt
        bucket even when the target prefills chunked: the draft is small).
        The draft's cursor is the target's (``lengths``). A chunk-admitted
        prompt's bucket can exceed ``max_seq_len``; the rows past the cache
        are bucket padding and are clipped."""
        cache, _ = prefill_bucket(self.draft, prompt, _bucket(len(prompt)), self.device,
                                  logits=False)
        rows = min(cache.k.shape[2], self.max_seq_len)
        self._d_cache.k[:, slot, :rows] = cache.k[:, 0, :rows]
        self._d_cache.v[:, slot, :rows] = cache.v[:, 0, :rows]

    def _prefill(self, slot: int, req: Request) -> None:
        p = len(req.prompt)
        self.stats.prefills += 1
        self.stats.prefill_tokens += p
        bucket = _bucket(p)
        if bucket > self.max_seq_len:
            raise ValueError(f"prompt of {p} tokens exceeds max_seq_len")
        cache, lrow = prefill_bucket(self.model, req.prompt, bucket, self.device, self.cache_dtype,
                                     self.kv_quant)
        # copy the bucket into the engine's cache at this slot (right padding: the slot's cache
        # is contiguous from 0)
        c = self._cache
        pairs = [(c.k, cache.k), (c.v, cache.v)]
        if self.kv_quant:
            pairs += [(c.k_scale, cache.k_scale), (c.v_scale, cache.v_scale)]
        for dst, src in pairs:
            dst[:, slot, :bucket] = src[:, 0]
        self._bind_slot(slot, req, first_token(req, lrow), p)

    # -- chunked (cache-continuation) prefill ---------------------------

    def _start_chunked(self, slot: int, req: Request) -> None:
        p = len(req.prompt)
        self.stats.prefills += 1
        self.stats.prefill_tokens += p
        if p + req.max_new_tokens > self.max_seq_len - 1:
            raise ValueError(
                f"chunked request needs prompt+max_new_tokens <= "
                f"max_seq_len-1 ({p}+{req.max_new_tokens} > {self.max_seq_len - 1})"
            )
        st = self.slots[slot]
        st.req = req
        st.prefilling = True
        st.pf_pos = 0
        st.generated = []
        # park the decode write cursor on the reserved scratch cell: decode steps taken while
        # this slot is mid-prefill write their garbage there, where nothing attends it
        self.lengths[slot] = self.max_seq_len - 1

    def _run_chunk(self, slot: int) -> None:
        """One ``[1, C]`` chunk of the slot's prompt through the host-cursor
        path at ``length = start`` on the slot's ``[L, 1, S, Hkv, D]`` view of
        the engine's cache, which it writes in place and attends up to
        ``start + C``. A ragged last chunk is realigned backward to ``[p - C,
        p)``: the overlap recomputes the same K/V."""
        st = self.slots[slot]
        req = st.req
        C = self.prefill_chunk
        p = len(req.prompt)
        start = st.pf_pos if p - st.pf_pos >= C else max(p - C, 0)
        valid = min(C, p - start)
        chunk = torch.zeros((1, C), dtype=torch.int32)
        chunk[0, :valid] = torch.as_tensor(np.asarray(req.prompt[start:start + valid], np.int32))
        c, rows = self._cache, slice(slot, slot + 1)
        view = KVCache(k=c.k[:, rows], v=c.v[:, rows], length=start,
                       k_scale=None if c.k_scale is None else c.k_scale[:, rows],
                       v_scale=None if c.v_scale is None else c.v_scale[:, rows])
        dev = self.device
        attn_mask = (torch.arange(start + C, device=dev)[None, :] < start + valid).to(torch.int32)
        logits, _ = arch.forward(self.model.params, chunk.to(dev), self.cfg, cache=view,
                                 attn_mask=attn_mask, dtype=self.dtype, mask_contig=True,
                                 positions=start + torch.arange(C, device=dev)[None, :])
        st.pf_pos = start + valid
        if st.pf_pos >= p:
            self._bind_slot(slot, req, first_token(req, logits[0, valid - 1]), p)

    def _admit(self) -> None:
        for slot, st in enumerate(self.slots):
            if st.req is None and self.queue:
                req = self.queue.popleft()
                if self.prefill_chunk is not None and len(req.prompt) > self.prefill_chunk:
                    self._start_chunked(slot, req)
                else:
                    self._prefill(slot, req)

    # -- decode ---------------------------------------------------------

    def _stage(self, min_left: np.ndarray, steps: np.ndarray) -> None:
        """The host mirrors into the step's device buffer, one copy."""
        self._inputs.stage((self.lengths, self.cur_tokens, self._eos, min_left, self._temps,
                            self._top_ps, self._top_ks, self._seeds, steps))

    def _window(self, need: int) -> Optional[int]:
        """The JAX engine's window bucket for rows that reach ``need`` slots,
        None for the whole cache."""
        win = _bucket(need)
        return win if win < self.max_seq_len else None

    def _step_window(self, need: int) -> Optional[int]:
        """The window of a plain or block step: only a step that attends
        through the einsum takes one."""
        return self._window(need) if self._windowed else None

    def _decode(self, sampling: bool, nblk: int, win: Optional[int]):
        """The (sampling, nblk, win) step over the staged buffers, through its
        CUDA graph on the card with ``JIT_GENERATE`` on: ``(tokens [nblk, S],
        logits [S, V])``."""
        from .utils import generation

        key = (sampling, nblk, win)
        run = self._steps.get(key)
        if run is None:
            run = self._steps[key] = generation._stepper(SlotStep(self, sampling, nblk, win),
                                                         self.device)
        return run()

    def _min_left_steps(self):
        min_left = np.array([max(0, self._min_new[i] - len(st.generated))
                             for i, st in enumerate(self.slots)], np.int32)
        steps = np.array([len(st.generated) for st in self.slots], np.int32)
        return min_left, steps

    def _block_step(self, active, sampling: bool, need: int) -> list[int]:
        """Run one decode BLOCK (``decode_block`` steps, one host sync)."""
        n = self.decode_block
        t0 = time.perf_counter()
        self._stage(*self._min_left_steps())
        toks, _ = self._decode(sampling, n, self._step_window(need + n))
        toks_np = toks.cpu().numpy()             # ONE sync for n steps
        self.stats.steps += n
        self.stats.step_time_s += time.perf_counter() - t0

        # device cursors advanced by n for every row; mirror, then fix up
        self.lengths += n
        done_ids = []
        for slot, st in enumerate(self.slots):
            if not active[slot]:
                continue
            rid = st.req.req_id
            appended = 0
            retired = False
            for j in range(n):
                appended += 1
                if self._append_token(slot, int(toks_np[j, slot])):
                    done_ids.append(rid)
                    self.lengths[slot] = 0
                    retired = True
                    break
            self.stats.tokens_generated += appended
            if not retired:
                self.cur_tokens[slot] = int(toks_np[n - 1, slot])
        self.stats.requests_completed += len(done_ids)
        return done_ids

    def _append_token(self, slot: int, tok: int) -> bool:
        """Append ONE generated token to a live slot: stream it (unless the
        previous token was EOS or max_new is already met: that token is not
        part of the output, so it is not streamed either) and retire the slot
        when EOS was hit or max_new reached. Returns True when the slot
        retired. ``generated[-1]`` is the token just sampled from the
        previous token's logits. The plain, the block and the speculative
        step all retire through here."""
        st = self.slots[slot]
        req = st.req
        st.generated.append(tok)
        hit_eos = (req.eos_token_id is not None
                   and st.generated[-2] == req.eos_token_id)
        if (self.on_token is not None and not hit_eos
                and len(st.generated) - 1 < req.max_new_tokens):
            self.on_token(req.req_id, tok)
        if hit_eos or len(st.generated) - 1 >= req.max_new_tokens:
            out = st.generated[: req.max_new_tokens]
            if req.eos_token_id is not None and req.eos_token_id in out:
                out = out[: out.index(req.eos_token_id) + 1]
            self.finished[req.req_id] = np.asarray(out, np.int32)
            st.req = None
            st.generated = []
            self._temps[slot] = 0.0
            self._eos[slot] = -1
            self._min_new[slot] = 0
            return True
        return False

    def _spec_step(self, active) -> list[int]:
        """One speculative step for ALL slots: ``spec_gamma + 1`` draft steps
        at the slots' cursors (K8a per row and K2 on the draft's cache; the
        last token is discarded, but its forward writes the draft row a full
        acceptance needs), ONE target forward over each slot's ``[cur,
        d_1..d_g]`` window (K8a per row at T = g + 1, the einsum), greedy
        acceptance: the longest draft prefix matching the target's argmax,
        plus the target's correction or bonus token. Window-bucketed as the
        JAX engine's: writes past ``_bucket(need)`` are dropped and the
        einsum attends only that window."""
        g = self.spec_gamma
        win = self._window(max(len(st.req.prompt) + len(st.generated)
                               for st, a in zip(self.slots, active) if a) + g + 1)
        dev, dm = self.device, self.draft
        t0 = time.perf_counter()
        lengths = torch.from_numpy(self.lengths.astype(np.int64)).to(dev)
        cur = torch.from_numpy(self.cur_tokens.copy()).to(dev)[:, None]     # [S, 1]
        dc, c = self._d_cache, self._cache
        dcache = KVCache(k=dc.k, v=dc.v, cursors=lengths.clone(), lo=c.lo, win=win,
                         inv_freq=dc.inv_freq)
        tok, drafts = cur, []
        for _ in range(g + 1):
            lg, _ = arch.forward(dm.params, tok, dm.cfg, cache=dcache, dtype=dm.dtype)
            tok = lg[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
            drafts.append(tok)
        drafts = torch.cat(drafts[:g], dim=1)                               # [S, g]
        tcache = KVCache(k=c.k, v=c.v, k_scale=c.k_scale, v_scale=c.v_scale, cursors=lengths,
                         win=win, inv_freq=c.inv_freq)
        lg, _ = arch.forward(self.model.params, torch.cat([cur, drafts], dim=1), self.cfg,
                             cache=tcache, dtype=self.dtype)
        t_next = lg.argmax(dim=-1).to(torch.int32)                          # [S, g + 1]
        n_acc = torch.cumprod((drafts == t_next[:, :g]).to(torch.int32), dim=1).sum(dim=1)
        both = torch.cat([t_next, n_acc[:, None].to(torch.int32)], dim=1).cpu().numpy()
        t_next_np, n_acc_np = both[:, :g + 1], both[:, g + 1]
        self.stats.steps += 1
        self.stats.step_time_s += time.perf_counter() - t0
        self.spec_steps += 1

        done_ids = []
        for slot, st in enumerate(self.slots):
            if not active[slot]:
                continue
            rid = st.req.req_id
            emitted = int(n_acc_np[slot]) + 1
            retired = False
            appended = 0
            # the plain step's append/stream/retire replayed over the emitted window; tokens past
            # a retirement are those the sequential engine would never have generated
            for j in range(emitted):
                appended += 1
                if self._append_token(slot, int(t_next_np[slot, j])):
                    done_ids.append(rid)
                    self.lengths[slot] = 0
                    retired = True
                    break
            self.stats.tokens_generated += appended
            if not retired:
                self.lengths[slot] += emitted
                self.cur_tokens[slot] = int(t_next_np[slot, emitted - 1])
        self.stats.requests_completed += len(done_ids)
        return done_ids

    @torch.inference_mode()
    def step(self) -> list[int]:
        """Admit queued requests, advance at most ONE prefill chunk, run one
        decode step for all active slots, retire finished sequences. Returns
        req_ids finished this step."""
        self._admit()

        # one chunk of one mid-prefill slot per step (round-robin), so decoding slots advance
        # every step even under long-prompt ingest
        pf_slots = [i for i, st in enumerate(self.slots) if st.prefilling]
        if pf_slots:
            slot = pf_slots[self._pf_rr % len(pf_slots)]
            self._pf_rr += 1
            self._run_chunk(slot)

        active = [st.req is not None and not st.prefilling for st in self.slots]
        if not any(active):
            return []

        # speculative path: every active slot greedy with min_new satisfied and nothing
        # mid-prefill (the plain step handles parked cursors, sampling and EOS suppression)
        if (self.draft is not None and not pf_slots and all(
                self._temps[i] == 0.0 and self._min_new[i] <= len(self.slots[i].generated)
                for i, a in enumerate(active) if a)):
            return self._spec_step(active)

        sampling = any(self._temps[i] > 0.0 for i, a in enumerate(active) if a)
        need = max(len(st.req.prompt) + len(st.generated)
                   for st, a in zip(self.slots, active) if a)
        # multi-step block: all-decode state and enough cache headroom
        if (self.decode_block > 1 and not pf_slots
                and need + self.decode_block <= self.max_seq_len):
            return self._block_step(active, sampling, need)
        t0 = time.perf_counter()
        self._stage(*self._min_left_steps())
        toks, _ = self._decode(sampling, 1, self._step_window(need))
        nxt_np = toks[0].cpu().numpy()       # the one sync per step
        self.stats.steps += 1
        self.stats.step_time_s += time.perf_counter() - t0
        self.stats.tokens_generated += int(sum(active))

        # host cursor mirror: the step advanced every row's cursor by exactly 1; mirror that
        # instead of reading the device back, then re-park mid-prefill slots (their garbage
        # write went to the scratch cell)
        self.lengths += 1
        for i, st in enumerate(self.slots):
            if st.prefilling:
                self.lengths[i] = self.max_seq_len - 1
        for i, a in enumerate(active):
            if a:
                self.cur_tokens[i] = nxt_np[i]

        done_ids = []
        for slot, st in enumerate(self.slots):
            if st.req is None or st.prefilling:
                continue
            rid = st.req.req_id
            if self._append_token(slot, int(nxt_np[slot])):
                done_ids.append(rid)
                self.lengths[slot] = 0
        self.stats.requests_completed += len(done_ids)
        return done_ids

    def run(self, requests: list[Request]) -> dict[int, np.ndarray]:
        """Run all requests to completion; returns req_id -> generated
        tokens. K8a's target flag and K9's expert check are read once, at
        the end."""
        for r in requests:
            self.submit(r)
        while self.queue or any(st.req is not None for st in self.slots):
            self.step()
        check_page_errors(self.device)
        check_routed_errors(self.device)
        out, self.finished = self.finished, {}
        return out


__all__ = ["ContinuousBatchEngine", "EngineStats", "Request", "SlotStep", "StepInputs",
           "first_token", "prefill_bucket"]
