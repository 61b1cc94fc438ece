"""Autoregressive generation: greedy or temperature sampling over a
preallocated KV cache, and beam search over a paged KV cache.

Counterpart of the JAX package's ``utils/generation.py`` (``_prep_inputs``,
``_generate_greedy``, ``_generate_beam``, ``_generate_beam_paged``,
``generate``). Decode loops are Python loops of steps; every token stays on
the device until the loop ends. The JAX package's growing attention
windows (``_window_phases``, ``_page_phases``) have no counterpart: K2 reads
only the live slots ``[lo, hi)`` of each row and K7 only each row's live
pages, so ``phased`` is accepted and ignored.

Beam search follows HF ``BeamSearchScorer`` as the JAX package does. Its
top-k selections go through ``arch.top_k``, a stable sort, so that equal
scores (the done pool holds many ``NEG_INF``) resolve to the lower index as
``jax.lax.top_k`` does; ``torch.topk`` promises no order for ties.

:data:`JIT_GENERATE` (``AUTOGPTQ_TPU_JIT_GENERATE``, default on, as in the
JAX package, where it jits each ``generate``) is the counterpart of that
whole-program jit: a greedy or paged-beam ``generate`` on the card runs its
decode step eagerly once, captures it into one CUDA graph and replays that
for every later step (``build.StepGraph``). :class:`GreedyStep` is the
forward of one token from the embedding to the f32 logits, with the write
cursor, positions, validity and K2's bounds in buffers that persist for the
call and are updated in place; sampling and the EOS bookkeeping stay eager
between replays. :class:`PagedBeamStep` is the whole beam step of the JAX
package's ``step_fn``: the forward, the beams' choice (``_Beams.advance``,
which reads the step from a device counter and updates the beams' state in
place) and the reorder (``_paged_reorder``: the table update and K8b), so
the host loop only replays. In both, each layer's RoPE and K/V write are one
K8a launch (``ops/paged_attn.rope_write_kv``), which quantizes the rows of an
int8 cache (``kv_quant``: the contiguous cache's scheme for greedy, the
paged pools' for the paged beam). A graph lives for one call:
``build.split_scratch`` grows its workspaces by replacing them. With the
switch off, and on the CPU, the same step objects run eagerly, one dispatch
per operation. Not captured, and eager whatever the switch: the prefill,
training, the contiguous beam path (``_generate_beam``, taken by
adaption-prompt models and by int8 beams of a configuration the paged engine
refuses, :func:`_beam_paged_ok`) and the greedy decode of an adaption-prompt
model, whose dense attention reads the host cursor.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models import arch
from ..models.arch import KVCache
from ..ops import build
from ..ops.gemm import check_routed_errors
from ..ops.paged_attn import (check_page_errors, copy_pages_pair, paged_attention_mh,
                               quant_rows, rope_inv_freq, rope_write_kv)

NEG_INF = -1e30
PAGE_SIZE = 16
_top_k = arch.top_k

# Decode steps on the card through one CUDA graph per generate call (the JAX package's switch,
# utils/generation.py:31). Read at every call.
JIT_GENERATE = os.environ.get("AUTOGPTQ_TPU_JIT_GENERATE", "1") != "0"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _prep_inputs(input_ids, pad_token_id: int = 0):
    """Left-pad a batch of prompts: ``(ids [B, T], mask [B, T])`` int32."""
    if isinstance(input_ids, (list, tuple)):
        rows = [np.asarray(x).reshape(-1) for x in input_ids]
    else:
        arr = np.asarray(input_ids)
        if arr.ndim == 1:
            arr = arr[None]
        rows = list(arr)
    t = max(len(r) for r in rows)
    ids = np.full((len(rows), t), pad_token_id, np.int32)
    mask = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        ids[i, t - len(r):] = r
        mask[i, t - len(r):] = 1
    return ids, mask


def _sample(logits: torch.Tensor, step: int, temperature: float, min_new_tokens: int,
            eos_token_id: Optional[int], generator: Optional[torch.Generator]) -> torch.Tensor:
    if eos_token_id is not None and step < min_new_tokens:
        logits = logits.clone()
        logits[:, eos_token_id] = NEG_INF
    if temperature > 0.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)


def _stepper(step, device, capturable: bool = True):
    """``step`` as the decode loop calls it: through a CUDA graph
    (``build.StepGraph``) on the card with :data:`JIT_GENERATE` on, else
    itself, eagerly."""
    if JIT_GENERATE and capturable and device.type == "cuda":
        return build.StepGraph(step, device)
    return step


def _has_adaption(params: dict) -> bool:
    return any("adaption" in b.get("attn", {}) for b in params["layers"])


class GreedyStep:
    """One greedy decode step over buffers that persist for the call: the
    token ``tok [B, 1]``, which the loop fills before each call, the
    positions ``pos [B, 1]``, the cache (moved to the device cursor by
    :meth:`KVCache.start_decode` unless the model has an adaption prompt)
    and ``validity [B, S]``. A call marks the cursor's slot valid, runs
    :func:`arch.forward` of the token and advances the positions, all in
    place; it returns the logits ``[B, V]`` f32."""

    def __init__(self, params: dict, cfg, cache: KVCache, validity: torch.Tensor,
                 pos: torch.Tensor, dtype: torch.dtype):
        self.params, self.cfg, self.cache, self.validity, self.dtype = (params, cfg, cache,
                                                                       validity, dtype)
        self.pos = pos.clone()
        self.tok = torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
        self.device_cursor = not _has_adaption(params)
        if self.device_cursor:
            cache.start_decode(validity, cfg)

    def __call__(self) -> torch.Tensor:
        if self.device_cursor:
            self.validity.index_fill_(1, self.cache.cursor, 1)
        else:
            self.validity[:, self.cache.length] = 1
        logits, _ = arch.forward(self.params, self.tok, self.cfg, cache=self.cache,
                                 positions=self.pos, attn_mask=self.validity, dtype=self.dtype,
                                 mask_contig=True)
        self.pos.add_(1)
        return logits[:, -1]


@torch.inference_mode()
def _generate_greedy(params: dict, tokens: torch.Tensor, mask: torch.Tensor, cfg,
                     max_new_tokens: int, min_new_tokens: int, eos_token_id: Optional[int],
                     temperature: float, dtype: torch.dtype,
                     generator: Optional[torch.Generator], pad_token_id: int = 0,
                     kv_quant: bool = False) -> torch.Tensor:
    """Prefill the prompt, then decode one token per step (:class:`GreedyStep`,
    through a CUDA graph on the card with :data:`JIT_GENERATE` on) over the
    contiguous cache, int8 with ``kv_quant``; returns the new tokens ``[B,
    max_new_tokens]`` int32."""
    b, t = tokens.shape
    dev = tokens.device
    total = t + max_new_tokens
    cache = KVCache.create(cfg, b, total, dtype=dtype, device=dev, quantized=kv_quant)
    validity = torch.zeros((b, total), dtype=torch.int32, device=dev)
    validity[:, :t] = mask

    positions = (torch.cumsum(mask, dim=-1) - 1).clamp_min(0)
    logits, cache = arch.forward(params, tokens, cfg, cache=cache, positions=positions,
                                 attn_mask=validity, dtype=dtype, logits_last_only=True)
    tok = _sample(logits[:, -1], 0, temperature, min_new_tokens, eos_token_id, generator)
    out = torch.empty((b, max_new_tokens), dtype=torch.int32, device=dev)
    out[:, 0] = tok
    finished = (tok == eos_token_id) if eos_token_id is not None else None

    step = GreedyStep(params, cfg, cache, validity, positions[:, -1:] + 1, dtype)
    run = _stepper(step, dev, step.device_cursor)
    for i in range(1, max_new_tokens):
        step.tok.copy_(tok[:, None])
        raw = _sample(run(), i, temperature, min_new_tokens, eos_token_id, generator)
        tok = raw
        if finished is not None:
            # HF protocol: the EOS token is kept, later positions get pad_token_id
            tok = torch.where(finished, torch.full_like(raw, pad_token_id), raw)
            finished = finished | (raw == eos_token_id)
        out[:, i] = tok
    return out


# ---------------------------------------------------------------- beam search

def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a [b, n, m], idx [b, j, None], axis=1)`` -> [b, j, m]."""
    return torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))


def _flat_top2k(cand: torch.Tensor):
    """``top_k(cand.reshape(b, k * vocab), 2k)`` in two stages, per beam and
    then a merge, exactly as the JAX package computes it (ties included).
    Returns (values [b, 2k], flat indices [b, 2k])."""
    b, k, vocab = cand.shape
    k2 = 2 * k
    v1, i1 = _top_k(cand, k2)                                       # [b, k, 2k]
    i1f = (torch.arange(k, device=cand.device)[None, :, None] * vocab + i1).reshape(b, k * k2)
    v2, sel = _top_k(v1.reshape(b, k * k2), k2)                     # [b, 2k]
    return v2, torch.gather(i1f, 1, sel)


def _beam_row_done(done_scores, best_raw, len_norm, p: float, early_stopping,
                   max_new_tokens: int) -> torch.Tensor:
    """HF ``BeamHypotheses.is_done``, vectorized over rows: the pool is full
    and (``early_stopping`` is True, or no candidate can still beat the worst
    kept hypothesis at the best attainable normalization). ``len_norm`` is
    the current generated length to the power ``p`` (a float, or an f32
    tensor ``[1]``)."""
    pool_full = done_scores[:, -1] > NEG_INF / 2
    if early_stopping is True:
        return pool_full
    if early_stopping == "never" and p > 0.0:
        div = float(max_new_tokens) ** p
    else:   # False, or 'never' with p <= 0: the best length is the current one
        div = len_norm
    return pool_full & (done_scores[:, -1] >= best_raw / div)


def _beam_pool_seed(lp0, k: int, eos: Optional[int], p: float, early_stopping,
                    max_new_tokens: int):
    """Step 0 of HF ``BeamSearchScorer.process`` + ``is_done``: EOS candidates
    ranked within the top ``k`` of the ``2k`` enter the done pool,
    normalized by their generated length 1. Returns (done_scores,
    done_tokens, frozen, s2k with EOS masked, tok2k)."""
    b, dev = lp0.shape[0], lp0.device
    done_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    done_tokens = torch.zeros((b, k, max_new_tokens), dtype=torch.int32, device=dev)
    frozen = torch.zeros((b,), dtype=torch.bool, device=dev)
    s2k, tok2k = _top_k(lp0, 2 * k)
    if eos is not None:
        is_eos = tok2k == eos
        rank_ok = torch.arange(2 * k, device=dev)[None, :] < k
        cand = torch.where(is_eos & rank_ok, s2k, NEG_INF)          # / (1 ** p)
        cand_tok = torch.zeros((b, 2 * k, max_new_tokens), dtype=torch.int32, device=dev)
        cand_tok[:, :, 0] = eos
        done_scores, di = _top_k(torch.cat([done_scores, cand], dim=1), k)
        done_tokens = _take_rows(torch.cat([done_tokens, cand_tok], dim=1), di)
        frozen = _beam_row_done(done_scores, s2k.amax(dim=1), 1.0, p, early_stopping,
                                max_new_tokens)
        s2k = torch.where(is_eos, NEG_INF, s2k)
    return done_scores, done_tokens, frozen, s2k, tok2k


def _beam_pool_update(step: torch.Tensor, len_norm: torch.Tensor, out, s2k, tok2k, beam2k,
                      done_scores, done_tokens, frozen, k: int, eos: int, p: float,
                      early_stopping, max_new_tokens: int):
    """Per-step HF ``BeamSearchScorer.process`` + ``is_done``, vectorized over
    rows: generated length ``step + 1`` (``step`` int64 ``[1]`` on the
    device, ``len_norm`` that length to the power ``p``, f32 ``[1]``); EOS
    candidates enter the pool only when ranked within the top ``k``;
    ``is_done`` compares against the best raw candidate, EOS ones included.
    Returns (s2k with EOS masked, pool scores, pool tokens, frozen)."""
    k2 = 2 * k
    is_eos = tok2k == eos
    rank_ok = torch.arange(k2, device=s2k.device)[None, :] < k
    cand_norm = torch.where(is_eos & rank_ok & ~frozen[:, None], s2k / len_norm, NEG_INF)
    cand_tok = _take_rows(out, beam2k)
    cand_tok.index_fill_(2, step, eos)
    done_scores, di = _top_k(torch.cat([done_scores, cand_norm], dim=1), k)
    done_tokens = _take_rows(torch.cat([done_tokens, cand_tok], dim=1), di)
    frozen = frozen | _beam_row_done(done_scores, s2k.amax(dim=1), len_norm, p, early_stopping,
                                     max_new_tokens)
    s2k = torch.where(is_eos, NEG_INF, s2k)
    return s2k, done_scores, done_tokens, frozen


@dataclass
class _Beams:
    """Beam-search bookkeeping shared by the contiguous and the paged path.
    After :meth:`start` the state lives in tensors that :meth:`advance`
    updates in place, the step in a device counter: a CUDA graph of the
    paged step replays the advance (:class:`PagedBeamStep`)."""

    k: int
    eos: Optional[int]
    p: float
    early_stopping: object
    max_new_tokens: int
    min_new_tokens: int
    scores: torch.Tensor = None        # [B, k] f32 running log-probability sums
    out: torch.Tensor = None           # [B, k, M] int32 tokens of the live beams
    done_scores: torch.Tensor = None   # [B, k] f32 normalized scores of finished hypotheses
    done_tokens: torch.Tensor = None   # [B, k, M] int32
    frozen: torch.Tensor = None        # [B] bool: row is done
    cur_tok: torch.Tensor = None       # [B * k] int32: the token each beam feeds next
    step: torch.Tensor = None          # int64 [1]: the step advance() takes next
    len_norm: torch.Tensor = None      # f32 [M]: (j + 1) ** p, the length norm of step j

    def _logprobs(self, logits: torch.Tensor, early) -> torch.Tensor:
        """Log-probabilities, EOS masked where ``early`` (True, or a bool
        tensor ``[1]``: the step is below ``min_new_tokens``)."""
        lp = torch.log_softmax(logits.float(), dim=-1)
        if self.eos is not None and self.min_new_tokens > 0:
            lp[:, self.eos] = NEG_INF if early is True else torch.where(early, NEG_INF,
                                                                        lp[:, self.eos])
        return lp

    def start(self, logits_b: torch.Tensor) -> None:
        """Step 0 from the prefill's last logits ``[B, V]``: the k beams of a
        row are identical until this step decides them."""
        b, dev = logits_b.shape[0], logits_b.device
        self.step = torch.ones(1, dtype=torch.int64, device=dev)
        # each step's norm rounded from the double power, as a Python float divisor was
        self.len_norm = torch.tensor([float(j + 1) ** self.p for j in range(self.max_new_tokens)],
                                     dtype=torch.float32, device=dev)
        lp0 = self._logprobs(logits_b, True)
        self.done_scores, self.done_tokens, self.frozen, s2k, tok2k = _beam_pool_seed(
            lp0, self.k, self.eos, self.p, self.early_stopping, self.max_new_tokens)
        self.scores, sel = _top_k(s2k, self.k)
        top_tok = torch.gather(tok2k, 1, sel).to(torch.int32)
        self.out = torch.zeros((b, self.k, self.max_new_tokens), dtype=torch.int32, device=dev)
        self.out[:, :, 0] = top_tok
        self.cur_tok = top_tok.reshape(-1)

    def advance(self, logits: torch.Tensor) -> torch.Tensor:
        """One step from the beams' logits ``[B * k, V]`` at the step
        :attr:`step` holds: picks the new beams, updates the state and the
        step in place, reads nothing on the host, and returns, for each beam,
        the flat index of its parent beam ``[B * k]``."""
        b = self.scores.shape[0]
        k, step = self.k, self.step
        lp = self._logprobs(logits, step < self.min_new_tokens).reshape(b, k, -1)
        vocab = lp.shape[2]
        s2k, flat_idx = _flat_top2k(self.scores[:, :, None] + lp)
        beam2k = flat_idx // vocab
        tok2k = (flat_idx % vocab).to(torch.int32)
        if self.eos is not None:
            s2k, done_scores, done_tokens, frozen = _beam_pool_update(
                step, self.len_norm.index_select(0, step), self.out, s2k, tok2k, beam2k,
                self.done_scores, self.done_tokens, self.frozen, k, self.eos, self.p,
                self.early_stopping, self.max_new_tokens)
            self.done_scores.copy_(done_scores)
            self.done_tokens.copy_(done_tokens)
            self.frozen.copy_(frozen)
        scores, sel = _top_k(s2k, k)
        beam_idx = torch.gather(beam2k, 1, sel)
        tok_idx = torch.gather(tok2k, 1, sel)
        out = _take_rows(self.out, beam_idx)
        out.scatter_(2, step.view(1, 1, 1).expand(b, k, 1), tok_idx[:, :, None])
        self.scores.copy_(scores)
        self.out.copy_(out)
        self.cur_tok.copy_(tok_idx.reshape(-1))
        step.add_(1)
        return (torch.arange(b, device=beam_idx.device)[:, None] * k + beam_idx).reshape(-1)

    def finish(self, num_return_sequences: int) -> torch.Tensor:
        """HF finalize: rows that did not stop early add their live beams,
        normalized at the final generated length; returns the best
        ``[B, R, M]``."""
        final_norm = self.scores / (float(self.max_new_tokens) ** self.p)
        live_norm = torch.where(self.frozen[:, None], NEG_INF, final_norm)
        pool_s = torch.cat([self.done_scores, live_norm], dim=1)
        pool_t = torch.cat([self.done_tokens, self.out], dim=1)
        _, ti = _top_k(pool_s, num_return_sequences)
        return _take_rows(pool_t, ti)


@torch.inference_mode()
def _generate_beam(params: dict, tokens: torch.Tensor, mask: torch.Tensor, cfg,
                   max_new_tokens: int, min_new_tokens: int, eos_token_id: Optional[int],
                   num_beams: int, dtype: torch.dtype, kv_quant: bool = False,
                   length_penalty: float = 1.0, early_stopping=False,
                   num_return_sequences: int = 1) -> torch.Tensor:
    """Beam search over the contiguous KV cache: after every step the whole
    cache, an int8 one's scales with it, is reordered to the chosen parents
    (``index_select``); decode attention is K2 (the einsum over an int8
    cache). ``generate`` takes the paged path, and this one for a model with
    an adaption prompt and for an int8 beam that :func:`_beam_paged_ok`
    refuses; it is also the paged path's oracle in the tests. Returns ``[B,
    num_return_sequences, max_new_tokens]``."""
    b, t = tokens.shape
    k = num_beams
    dev = tokens.device
    total = t + max_new_tokens
    cache_b = KVCache.create(cfg, b, total, dtype=dtype, device=dev, quantized=kv_quant)
    validity_b = torch.zeros((b, total), dtype=torch.int32, device=dev)
    validity_b[:, :t] = mask
    positions_b = (torch.cumsum(mask, dim=-1) - 1).clamp_min(0)
    logits, cache_b = arch.forward(params, tokens, cfg, cache=cache_b, positions=positions_b,
                                   attn_mask=validity_b, dtype=dtype, logits_last_only=True,
                                   mask_contig=True)

    def beams_of(a):
        return None if a is None else a.repeat_interleave(k, dim=1)

    cache = KVCache(k=beams_of(cache_b.k), v=beams_of(cache_b.v), length=cache_b.length,
                    k_scale=beams_of(cache_b.k_scale), v_scale=beams_of(cache_b.v_scale))
    validity = validity_b.repeat_interleave(k, dim=0)
    cur_pos = positions_b[:, -1].repeat_interleave(k, dim=0) + 1
    del cache_b

    beams = _Beams(k, eos_token_id, float(length_penalty), early_stopping, max_new_tokens,
                   min_new_tokens)
    beams.start(logits[:, -1])
    for _ in range(1, max_new_tokens):
        validity[:, cache.length] = 1
        logits, cache = arch.forward(params, beams.cur_tok[:, None], cfg, cache=cache,
                                     positions=cur_pos[:, None], attn_mask=validity,
                                     dtype=dtype, mask_contig=True)
        parent = beams.advance(logits[:, -1])
        cache.k = cache.k.index_select(1, parent)
        cache.v = cache.v.index_select(1, parent)
        if kv_quant:
            cache.k_scale = cache.k_scale.index_select(1, parent)
            cache.v_scale = cache.v_scale.index_select(1, parent)
        validity = validity[parent]
        cur_pos = cur_pos[parent] + 1
    return beams.finish(num_return_sequences)


@dataclass
class PagedBeamCache:
    """The paged beam cache after prefill.

    Pools are page-major ``[L, P, Hkv, ps, D]`` (int8 with f32 ``[L, P, Hkv,
    ps]`` scale pools when ``kv_quant``). Page ids are fixed functions of
    (row, beam): page 0 is a null page; ``1 + r * pps + i`` is prompt page
    ``i`` of batch row ``r``, shared by its beams (the prompt's KV compacted
    to slots ``[0, plen_r)``); ``g0 + (r * k + j) * gmax + c`` is generated
    page ``c`` of beam ``(r, j)``, which only that beam writes. ``tables``
    ``[B * k, W]`` maps each beam's page ordinals to page ids."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    tables: torch.Tensor        # int32 [B * k, W]
    plen: torch.Tensor          # int32 [B * k]: prompt length of each beam's row
    c0: torch.Tensor            # [B * k]: ordinal of the first page a beam writes
    own: torch.Tensor           # [B * k, W]: the beam's own page id at each ordinal
    own_ok: torch.Tensor        # [B * k, W]: ordinals that have an own page
    own_base: torch.Tensor      # [B * k]: the beam's first own page id
    page_size: int

    def copy_pages(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """K8b on the K/V pools (and the scale pools); the ids are checked
        later, by :func:`check_page_errors`."""
        copy_pages_pair(self.k_pool, self.v_pool, src, dst, check=False)
        if self.k_scale is not None:
            copy_pages_pair(self.k_scale, self.v_scale, src, dst, check=False)


def beam_paged_prefill(params: dict, tokens: torch.Tensor, mask: torch.Tensor, cfg,
                       num_beams: int, max_new_tokens: int, dtype: torch.dtype,
                       kv_quant: bool = False):
    """Prefill each prompt once through the contiguous path, compact its
    left-padded KV into page-major pools and build the beams' page tables,
    each beam owning a copy of its row's boundary page. Returns (the last
    prefill logits ``[B, V]`` f32, :class:`PagedBeamCache`). On the card the
    caller reads K8b's id check with :func:`check_page_errors`."""
    b, t = tokens.shape
    k = num_beams
    bk = b * k
    dev = tokens.device
    ps = PAGE_SIZE
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    n_layers = cfg.num_layers
    pps = _cdiv(t, ps)                      # prompt pages per row
    gmax = _cdiv(max_new_tokens, ps) + 1    # own (written) pages per beam
    g0 = 1 + b * pps
    n_pages = g0 + bk * gmax
    width = _cdiv(pps + gmax, 8) * 8

    cache_b = KVCache.create(cfg, b, t, dtype=dtype, device=dev)
    positions_b = (torch.cumsum(mask, dim=-1) - 1).clamp_min(0)
    logits, cache_b = arch.forward(params, tokens, cfg, cache=cache_b, positions=positions_b,
                                   attn_mask=mask, dtype=dtype, logits_last_only=True,
                                   mask_contig=True)
    plen = mask.sum(dim=-1).to(torch.int32)                          # [B]

    # Left-padded prompts: compact each row's valid KV to slots [0, plen).
    tpad = pps * ps
    src = ((t - plen)[:, None] + torch.arange(tpad, device=dev)[None, :]).clamp(0, t - 1)
    idx = src[None, :, :, None, None].expand(n_layers, b, tpad, hkv, d)

    def to_pages(a):                        # [L, B, t, Hkv, D] -> [L, B * pps, Hkv, ps, D]
        g = torch.gather(a, 2, idx).reshape(n_layers, b, pps, ps, hkv, d)
        return g.permute(0, 1, 2, 4, 3, 5).reshape(n_layers, b * pps, hkv, ps, d)

    shape = (n_layers, n_pages, hkv, ps, d)
    k_scale = v_scale = None
    if kv_quant:
        k_pool = torch.zeros(shape, dtype=torch.int8, device=dev)
        v_pool = torch.zeros(shape, dtype=torch.int8, device=dev)
        k_scale = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        v_scale = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        for pool, scale, a in ((k_pool, k_scale, cache_b.k), (v_pool, v_scale, cache_b.v)):
            q, s = quant_rows(to_pages(a))
            pool[:, 1:g0] = q
            scale[:, 1:g0] = s[..., 0]
    else:
        k_pool = torch.zeros(shape, dtype=dtype, device=dev)
        v_pool = torch.zeros(shape, dtype=dtype, device=dev)
        k_pool[:, 1:g0] = to_pages(cache_b.k)
        v_pool[:, 1:g0] = to_pages(cache_b.v)
    del cache_b

    rows = torch.arange(bk, device=dev) // k
    plen_bk = plen[rows]
    c0 = plen_bk // ps                      # ordinal of the first written page
    ar = torch.arange(width, device=dev)[None, :]
    own_base = g0 + torch.arange(bk, device=dev) * gmax
    own = own_base[:, None] + (ar - c0[:, None])
    own_ok = (ar >= c0[:, None]) & (ar - c0[:, None] < gmax)
    prompt_pg = 1 + rows[:, None] * pps + ar
    tables = torch.where(own_ok, own, torch.where(ar < pps, prompt_pg, 0)).to(torch.int32)
    cache = PagedBeamCache(k_pool, v_pool, k_scale, v_scale, tables.contiguous(), plen_bk, c0,
                           own, own_ok, own_base, ps)
    # Copy-on-share of the boundary page: generation goes on inside the
    # prompt's last, partial page, which each beam must own before writing.
    # A page-aligned prompt has an empty boundary page (c0 == pps would name
    # the next row's pages), so clamp: what is copied is then overwritten.
    bsrc = (1 + rows * pps + torch.clamp(c0, max=pps - 1)).clamp(0, n_pages - 1)
    cache.copy_pages(bsrc.to(torch.int32), own_base.to(torch.int32))
    return logits[:, -1].float(), cache


def paged_decode_step(params: dict, cfg, cache: PagedBeamCache, cur_tok: torch.Tensor,
                      pos: torch.Tensor, dtype: torch.dtype,
                      inv_freq: Optional[torch.Tensor] = None,
                      fuse_norm: Optional[bool] = None) -> torch.Tensor:
    """One decode token per beam over the paged cache: every layer turns q
    and k and writes K/V into the beam's own current page in one K8a launch
    (``rope_write_kv``, which finds the page in ``cache.tables``) and attends
    over the beam's live pages (K7). ``pos`` ``[B * k]`` is the slot (and the
    position) of the incoming token; ``inv_freq`` RoPE's
    (``rope_inv_freq``, made here when not given). ``cache`` is anything with
    the pools, scale pools and ``tables`` of :class:`PagedBeamCache` (the
    paged serving engine passes its own). ``fuse_norm`` None follows
    :data:`arch.FUSE_NORM`; the serving engine passes False, as the JAX
    engine never fuses. Returns the logits ``[B * k, V]`` f32. On the card
    the caller reads K8a's target check with :func:`check_page_errors`."""
    bk = cur_tok.shape[0]
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = d ** -0.5
    if inv_freq is None:
        inv_freq = rope_inv_freq(cfg.rope_theta, d, cur_tok.device)
    lengths = (pos + 1).to(torch.int32)
    x = arch.embed(params, cur_tok[:, None], dtype)
    # Fused norm+matmul (arch.FUSE_NORM), the JAX _fwd_step's branch: q/k/v take the input
    # norm and gate/up the post-attention norm as a prenorm; a MoE block stays unfused, as
    # arch.block_forward keeps it.
    if fuse_norm is None:
        fuse_norm = arch.FUSE_NORM != "0"
    fuse_norm = fuse_norm and cfg.moe_num_experts == 0
    for idx, bp in enumerate(params["layers"]):
        ap = bp["attn"]
        if fuse_norm:
            hn, lin = x, functools.partial(arch._prenorm_linear, norm=bp["input_norm"], cfg=cfg)
        else:
            hn, lin = arch.rms_norm(x, bp["input_norm"]["weight"], cfg.norm_eps), arch.apply_linear
        q = rope_write_kv(lin(ap["q_proj"], hn).view(bk, h, d),
                          lin(ap["k_proj"], hn).view(bk, hkv, d),
                          lin(ap["v_proj"], hn).view(bk, hkv, d), pos, inv_freq, cache.k_pool,
                          cache.v_pool, idx, tables=cache.tables, k_scale=cache.k_scale,
                          v_scale=cache.v_scale, check=False)
        of = paged_attention_mh(q, cache.k_pool, cache.v_pool, lengths, cache.tables,
                                cache.k_scale, cache.v_scale, sm_scale=scale, layer=idx)
        x = x + arch.apply_linear(ap["o_proj"], of.reshape(bk, 1, h * d).to(x.dtype))
        if fuse_norm:
            x = x + arch.mlp(bp["mlp"], x, cfg, prenorm=bp["post_norm"])
        else:
            x = x + arch.mlp(bp["mlp"], arch.rms_norm(x, bp["post_norm"]["weight"],
                                                      cfg.norm_eps), cfg)
    return arch.unembed(params, x, cfg)[:, -1]


class PagedBeamStep:
    """One whole paged beam step, the JAX package's ``step_fn``, over buffers
    that persist for the call: :func:`paged_decode_step` of the beams'
    tokens (``beams.cur_tok``) at the incoming token's slot ``pos [B * k]``,
    ``beams.advance`` (the step from its device counter, the state updated in
    place) and :func:`_paged_reorder` (the tables in place, K8b). Reads
    nothing on the host; returns the logits ``[B * k, V]`` f32 that the
    beams chose from."""

    def __init__(self, params: dict, cfg, cache: PagedBeamCache, dtype: torch.dtype,
                 beams: _Beams):
        self.params, self.cfg, self.cache, self.dtype, self.beams = (params, cfg, cache, dtype,
                                                                     beams)
        self.pos = cache.plen.clone()
        self.inv_freq = rope_inv_freq(cfg.rope_theta, cfg.head_dim, self.pos.device)

    def __call__(self) -> torch.Tensor:
        logits = paged_decode_step(self.params, self.cfg, self.cache, self.beams.cur_tok,
                                   self.pos, self.dtype, self.inv_freq)
        self.pos.add_(1)
        _paged_reorder(self.cache, self.beams.advance(logits), self.pos)   # pos: the next slot
        return logits


def _paged_reorder(cache: PagedBeamCache, parent: torch.Tensor, next_pos: torch.Tensor) -> None:
    """Reorder without moving the history: each beam takes its parent's page
    table, copies the parent's page that the next token lands in into its
    own page (copy-on-share; one page per beam), and owns every ordinal from
    there on. ``cache.tables`` is written in place."""
    tables = cache.tables[parent]
    nc = next_pos // cache.page_size                    # next write ordinal [B * k]
    rows = torch.arange(tables.shape[0], device=tables.device)
    psrc = tables[rows, nc]
    pdst = cache.own_base + (nc - cache.c0)
    cache.copy_pages(psrc.to(torch.int32), pdst.to(torch.int32))
    ar = torch.arange(tables.shape[1], device=tables.device)[None, :]
    own_from = (ar >= nc[:, None]) & cache.own_ok
    cache.tables.copy_(torch.where(own_from, cache.own, tables))   # in place: K7 reads its address


@torch.inference_mode()
def _generate_beam_paged(params: dict, tokens: torch.Tensor, mask: torch.Tensor, cfg,
                         max_new_tokens: int, min_new_tokens: int, eos_token_id: Optional[int],
                         num_beams: int, dtype: torch.dtype, kv_quant: bool = False,
                         length_penalty: float = 1.0, early_stopping=False,
                         num_return_sequences: int = 1) -> torch.Tensor:
    """Beam search over a paged KV cache, with the same HF semantics and
    tokens as :func:`_generate_beam`: beams index a shared page pool through
    per-beam page tables, so a reorder shuffles the tables and copies one
    page per beam instead of the whole cache. Completed pages are never
    written again and are shared by sibling beams. Attention is K7, token
    writes K8a, page copies K8b; their page ids are checked once, at the
    end. The decode step is :class:`PagedBeamStep`, through a CUDA graph on
    the card with :data:`JIT_GENERATE` on, with the beams' choice and the
    reorder inside it: the host loop only replays. Returns ``[B,
    num_return_sequences, max_new_tokens]``."""
    logits_b, cache = beam_paged_prefill(params, tokens, mask, cfg, num_beams, max_new_tokens,
                                         dtype, kv_quant)
    beams = _Beams(num_beams, eos_token_id, float(length_penalty), early_stopping,
                   max_new_tokens, min_new_tokens)
    beams.start(logits_b)
    run = _stepper(PagedBeamStep(params, cfg, cache, dtype, beams), cache.k_pool.device)
    for _ in range(1, max_new_tokens):
        run()
    check_page_errors(cache.k_pool.device)
    return beams.finish(num_return_sequences)


def _beam_paged_ok(model) -> bool:
    """The JAX package's route of a beam to the paged cache
    (``utils/generation.py:_beam_paged_ok``): a configuration the paged engine
    takes (``serving_paged.paged_cfg_ok``: not MoE) and no adaption prompt.
    :func:`generate` asks it for an int8 beam, whose two routes quantize by
    different schemes and so give different tokens; a float beam takes the
    paged cache for every family, since both routes give the same tokens
    there."""
    from ..serving_paged import paged_cfg_ok

    return paged_cfg_ok(model.cfg) and not _has_adaption(model.params)


def generate(model, input_ids, max_new_tokens: int = 128, temperature: float = 0.0,
             num_beams: int = 1, eos_token_id: Optional[int] = None, min_new_tokens: int = 0,
             seed: int = 0, pad_token_id: int = 0, kv_quant: bool = False,
             length_penalty: float = 1.0, early_stopping=False, num_return_sequences: int = 1,
             phased: bool = True) -> np.ndarray:
    """HF-generate-protocol decoding on ``model.device``: returns
    ``[B * num_return_sequences, T + max_new_tokens]`` int32 (prompt, left
    padded, then the new tokens). ``num_return_sequences`` R > 1 returns the
    top R beams under beam search, or R independent samples per prompt under
    sampling. ``kv_quant`` takes an int8 KV cache: the contiguous cache's
    scheme for greedy and sampled decoding and for beams on the contiguous
    route, the paged pools' for beams on the paged route, as in the JAX
    package. ``phased`` is accepted for the JAX signature and has no
    effect."""
    if num_beams > 1:
        if num_return_sequences > num_beams:
            raise ValueError("num_return_sequences must be <= num_beams")
        if temperature and temperature > 0.0:
            raise NotImplementedError(
                "beam-sample (num_beams > 1 with temperature > 0) is not supported; use beam "
                "search (temperature=0) or sampling (num_beams=1)")
        if early_stopping not in (True, False, "never"):
            raise ValueError(f"early_stopping must be True, False, or 'never' "
                             f"(got {early_stopping!r})")
    else:
        if num_return_sequences > 1 and not temperature:
            raise ValueError("num_return_sequences > 1 requires sampling (temperature > 0) "
                             "or beam search (num_beams > 1)")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be at least 1")
    ids, mask = _prep_inputs(input_ids, pad_token_id)
    dev = model.device
    tokens = torch.from_numpy(ids).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    if num_beams > 1:
        # the paged decode step has no adaption-prompt branch: such models take the contiguous
        # cache, as in the JAX package. An int8 beam routes as the JAX package routes it
        # (_beam_paged_ok), since the two routes quantize differently; a float beam takes the
        # paged cache for every other model, Mixtral's too, the routes' tokens being the same
        contiguous = _has_adaption(model.params) or (kv_quant and not _beam_paged_ok(model))
        beam = _generate_beam if contiguous else _generate_beam_paged
        new = beam(
            model.params, tokens, mask_t, model.cfg, max_new_tokens, min_new_tokens,
            eos_token_id, num_beams, model.dtype, kv_quant=kv_quant,
            length_penalty=float(length_penalty), early_stopping=early_stopping,
            num_return_sequences=num_return_sequences).cpu().numpy()
        check_routed_errors(dev)
        b, r, m = new.shape
        ids = np.repeat(ids, r, axis=0)
        new = new.reshape(b * r, m)
        if eos_token_id is not None:
            # HF finalize pads the positions after a hypothesis' EOS with
            # pad_token_id (the done pool holds zeros there)
            hit = new == eos_token_id
            after = np.cumsum(hit, axis=1) - hit.astype(np.int64) > 0
            new[after] = pad_token_id
        return np.concatenate([ids, new], axis=1)
    if num_return_sequences > 1:
        tokens = tokens.repeat_interleave(num_return_sequences, dim=0)
        mask_t = mask_t.repeat_interleave(num_return_sequences, dim=0)
        ids = np.repeat(ids, num_return_sequences, axis=0)
    generator = None
    if temperature and temperature > 0.0:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    new = _generate_greedy(
        model.params, tokens, mask_t, model.cfg, max_new_tokens, min_new_tokens, eos_token_id,
        float(temperature or 0.0), model.dtype, generator, pad_token_id=pad_token_id,
        kv_quant=kv_quant,
    ).cpu().numpy()
    check_routed_errors(dev)
    check_page_errors(dev)
    return np.concatenate([ids, new], axis=1)


__all__ = ["GreedyStep", "JIT_GENERATE", "PagedBeamCache", "PagedBeamStep", "beam_paged_prefill",
           "generate", "paged_decode_step"]
