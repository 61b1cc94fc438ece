"""What the paged continuous-batching engine (``serving_paged.py``) shares with
the slot engine of the JAX package's ``serving.py``: the request, the engine's
counters, the prefill buckets and the per-row samplers.

Counterpart of ``autogptq_tpu/serving.py:42-157``. The slot engine itself
(``ContinuousBatchEngine``, per-slot write cursors, chunked prefill) is not
ported yet (ROADMAP Queue 1, 'Serving').

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
from typing import Optional

import numpy as np
import torch

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


__all__ = ["EngineStats", "Request"]
