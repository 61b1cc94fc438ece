"""Draft-model speculative decoding (greedy verification) on PyTorch.

Counterpart of the JAX package's ``utils/speculative.py``: a small draft
model proposes ``gamma`` tokens per iteration and ONE target forward over the
``gamma + 1``-token window verifies them. The acceptance rule keeps the
longest prefix where the draft matches the target's argmax, then emits the
target's own correction or bonus token, so the stream is the target's greedy
stream whatever the draft.

The loop is the JAX one, run eagerly (the JAX package jits it as one
``lax.while_loop``; a captured loop would need a cursor advance that depends
on the accepted count, ROADMAP Queue 1):

* both models prefill the prompt through the host-cursor path;
* the draft takes ``gamma + 1`` one-token steps (the last token is
  discarded, but its forward writes the K/V row that a full acceptance needs)
  at a per-row device cursor (``KVCache.cursors``): each step is K8a's
  per-row write and K2, the slot engine's decode step at one row, and the
  steps read no host value between them;
* the target runs its window through the host-cursor multi-token path
  (``cache.length = pos``), its quantized projections at M = ``gamma + 1``;
* one host read per iteration (the target's tokens and the drafts) decides
  the accepted count; both caches rewind by resetting their cursor (rows past
  it are causally masked and later overwritten).

Batch 1 (a latency feature; batched throughput is the slot engine's, whose
speculative step, ``serving.ContinuousBatchEngine``, runs the same loop over
per-slot cursors).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import arch
from ..models.arch import KVCache
from ..ops.gemm import check_routed_errors
from ..ops.paged_attn import check_page_errors, rope_inv_freq


@torch.inference_mode()
def _spec_generate(model, draft, ids: torch.Tensor, gamma: int, max_new_tokens: int,
                   stats: Optional[dict]) -> np.ndarray:
    dev = ids.device
    t = ids.shape[1]
    g1 = gamma + 1
    total = t + max_new_tokens + g1           # headroom for the last window
    tcfg, dcfg = model.cfg, draft.cfg
    t_cache = KVCache.create(tcfg, 1, total, dtype=model.dtype, device=dev)
    d_cache = KVCache.create(dcfg, 1, total, dtype=draft.dtype, device=dev)
    t_logits, _ = arch.forward(model.params, ids, tcfg, cache=t_cache, dtype=model.dtype,
                               logits_last_only=True)
    arch.forward(draft.params, ids, dcfg, cache=d_cache, dtype=draft.dtype,
                 logits_last_only=True)
    d_cache.cursors = torch.full((1,), t, dtype=torch.int64, device=dev)
    d_cache.inv_freq = rope_inv_freq(dcfg.rope_theta, dcfg.head_dim, dev)
    cur = t_logits[:, -1].argmax(dim=-1)                                    # [1]

    out = np.zeros((max_new_tokens + g1,), np.int32)
    out[0] = int(cur[0])
    pos, produced, forwards, accepted = t, 1, 0, 0
    while produced < max_new_tokens:
        d_cache.cursors.fill_(pos)            # the draft's history rewound to the accepted one
        tok, drafts = cur.view(1, 1), []
        for _ in range(g1):
            lg, _ = arch.forward(draft.params, tok, dcfg, cache=d_cache, dtype=draft.dtype)
            tok = lg[:, -1].argmax(dim=-1, keepdim=True)
            drafts.append(tok)
        drafts = torch.cat(drafts[:gamma], dim=1)                           # [1, gamma]
        t_cache.length = pos                  # the target's history rewound likewise
        lg, _ = arch.forward(model.params, torch.cat([cur.view(1, 1), drafts], dim=1), tcfg,
                             cache=t_cache, dtype=model.dtype)
        t_next = lg[0].argmax(dim=-1)                                       # [g1]
        both = torch.cat([t_next, drafts[0]]).cpu().numpy()                 # the one host read
        tn, dn = both[:g1], both[g1:]
        n_acc = int(np.cumprod(dn == tn[:gamma]).sum())
        emitted = n_acc + 1
        out[produced:produced + g1] = tn      # the tail past `emitted` is overwritten next
        pos += emitted
        produced += emitted
        forwards += 1
        accepted += n_acc
        cur = t_next[n_acc:n_acc + 1]
    if stats is not None:
        stats.update(target_forwards=forwards, accepted_drafts=accepted,
                     tokens_per_target_forward=(max_new_tokens - 1) / max(forwards, 1))
    return out[:max_new_tokens]


def generate_speculative(model, draft_model, input_ids, max_new_tokens: int = 128,
                         gamma: int = 4, eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0, stats: Optional[dict] = None) -> np.ndarray:
    """Greedy speculative decoding on ``model.device``: returns ``[1, T +
    max_new_tokens]``, token for token ``generate(model, ...)`` at
    temperature 0. ``stats``, a dict, receives the number of target forwards,
    the drafts accepted and the tokens per target forward (the first token,
    the prefill's, not counted)."""
    ids = np.asarray(input_ids, np.int32)
    if ids.ndim == 1:
        ids = ids[None]
    if ids.shape[0] != 1:
        raise ValueError("speculative decoding is batch-1 (latency path)")
    if model.cfg.vocab_size != draft_model.cfg.vocab_size:
        raise ValueError("draft and target models must share a vocabulary")

    dev = model.device
    new = _spec_generate(model, draft_model, torch.from_numpy(ids).to(dev), gamma,
                         max_new_tokens, stats)
    check_routed_errors(dev)
    check_page_errors(dev)
    if eos_token_id is not None and eos_token_id in new:
        # HF protocol (and generate()): keep the EOS, pad after it
        idx = int(np.argmax(new == eos_token_id))
        new[idx + 1:] = pad_token_id
    return np.concatenate([ids, new[None]], axis=1)


__all__ = ["generate_speculative"]
