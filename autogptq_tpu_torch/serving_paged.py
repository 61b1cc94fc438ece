"""Paged-KV continuous batching (vLLM-style block paging) on PyTorch and CUDA.

Counterpart of the JAX package's ``serving_paged.py``, with its constructor
arguments, public methods, ``EngineStats`` fields and refusals. All slots
share one page pool: each sequence owns a page table into page-major
``[L, total_pages, Hkv, page_size, D]`` pools, pages are allocated as a
sequence grows and freed the moment it retires, so cache memory scales with
the tokens resident, not with ``max_slots * max context``. Page 0 is a
reserved null page: unused table entries and idle slots point at it.

A prompt is prefilled eagerly through the contiguous path at its ``_bucket``
size (right-padded) and its K/V scattered into its pages (plain tensor code:
the JAX scatter is XLA, not a Pallas kernel). With ``enable_prefix_cache``
full prompt pages are content-addressed by a sha256 chain hash; a request
reuses the longest cached run of them, gathers those pages and prefills only
the suffix as a cache continuation (``arch.forward`` at ``length =
shared_len``). Retired sequences' registered pages stay resident with
refcount 0, evicted least recently used under pool pressure.

The decode step (:class:`PagedStep`) is the JAX engine's layer loop, the norm
never fused (``generation.paged_decode_step(fuse_norm=False)``): per layer
the q/k/v projections (K1's GEMV at M = ``max_slots``), RoPE and the K/V
write through the page tables in one K8a launch (``rope_write_kv(tables=,
pos = lengths)``, which finds each slot's page itself), K7 over ``lengths +
1``, o_proj and the MLP; then the unembedding and the sampler
(``serving._sample_tokens`` / ``_greedy_tokens``), all on the device. It
reads persistent device buffers only: the tables at the full
``pages_per_seq`` width, the lengths, current tokens, EOS ids, ``min_left``
and the sampling parameters, one int32 buffer refilled from the host mirrors
by one host-to-device copy before each step. On the card with
``generation.JIT_GENERATE`` on, each (sampling flag, block length) is one
CUDA graph (``build.StepGraph``), captured once; ``JIT_GENERATE`` off, and
the CPU, run the same step object eagerly. K7 reads only each row's live
pages, so one graph covers every context length: the JAX engine's per-window
retrace (``page_window_bucket``) has no counterpart. There is one sync per
engine step, to read its tokens; K8a's target flag is read once per
:meth:`PagedContinuousBatchEngine.run`.

``decode_block`` > 1 runs that many decode steps in one graph (pages for the
block preallocated, one sync per block); a slot that retires inside a block
keeps writing into its own pages and its surplus tokens are dropped at
emission; near the context cap the tail runs one step at a time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .models import arch
from .models.arch import KVCache
from .models.base import resolve_device
from .ops.paged_attn import check_page_errors, rope_inv_freq
from .serving import (EngineStats, Request, StepInputs, _bucket, _greedy_tokens, _sample_tokens,
                      first_token, prefill_bucket)
from .utils import generation


def paged_cfg_ok(cfg) -> bool:
    """True when the paged decode step's plain layer loop (a rope/GQA
    pre-norm decoder with a dense MLP) reproduces ``arch.forward``. The JAX
    rule (``serving_paged.py:54-63``) also refuses MLA, alibi, softcaps,
    sliding windows, per-layer KV heads and other block shapes; the port's
    registry admits none of those, so of its families only MoE is left."""
    return not cfg.moe_num_experts


def _check_cfg(cfg) -> None:
    if not paged_cfg_ok(cfg):
        raise NotImplementedError("paged serving supports standard rope/GQA decoder families")


@dataclasses.dataclass
class _PagedSlot:
    req: Optional[Request] = None
    generated: list = dataclasses.field(default_factory=list)


class PagedStep:
    """``nblk`` decode steps of every slot over the engine's persistent
    buffers (:class:`PagedContinuousBatchEngine`'s ``_dev``): step ``j``
    writes at ``lengths + j`` and samples with ``min_left - j`` (floored at
    0) and ``steps + j``, the tokens of one step feeding the next. Returns
    ``(tokens [nblk, S] int32, the last step's logits [S, V] f32)``, which a
    CUDA graph's replays overwrite."""

    def __init__(self, engine: "PagedContinuousBatchEngine", sampling: bool, nblk: int):
        self.engine, self.sampling, self.nblk = engine, sampling, nblk

    def __call__(self):
        e = self.engine
        d = e._dev
        cur, toks, logits = d.cur, [], None
        for j in range(self.nblk):
            pos = d.lengths if j == 0 else d.lengths + j
            min_left = d.min_left if j == 0 else (d.min_left - j).clamp_min(0)
            logits = generation.paged_decode_step(e.model.params, e.cfg, e._pools, cur, pos,
                                                  e.dtype, e._inv_freq, fuse_norm=False)
            if self.sampling:
                cur = _sample_tokens(logits, d.temps, d.top_ps, d.top_ks, d.seeds, d.steps + j,
                                     d.eos, min_left)
            else:
                cur = _greedy_tokens(logits, d.eos, min_left)
            toks.append(cur)
        return torch.stack(toks), logits


class PagedContinuousBatchEngine:
    """Continuous batching over a shared page pool (see the module docstring).

    ``total_pages`` bounds the resident tokens (``total_pages * page_size``),
    not a slot's length: admission waits until enough pages are free.
    ``model`` has ``params``, ``cfg``, ``dtype`` and ``device`` (a
    ``GPTQModel``); the pools live on that device, the card unless the model
    is on the CPU. ``use_kernel`` and ``write_kernel`` are the JAX switches
    between its Pallas kernels and its jnp references; here the kernels
    follow the tensors' device, as every wrapper of the port does, so they
    are accepted only where they agree with it."""

    def __init__(self, model, max_slots: int = 4, total_pages: int = 64, page_size: int = 16,
                 pages_per_seq: int = 32, use_kernel: Optional[bool] = None, on_token=None,
                 enable_prefix_cache: bool = False, decode_block: int = 1,
                 write_kernel: Optional[bool] = None):
        _check_cfg(model.cfg)
        if "q_proj" not in model.params["layers"][0].get("attn", {}):
            raise NotImplementedError("paged serving requires unfused q/k/v projections")
        if any("adaption" in b.get("attn", {}) for b in model.params["layers"]):
            raise NotImplementedError("paged serving does not apply adaption-prompt adapters; "
                                      "use the contiguous engine, "
                                      "serving.ContinuousBatchEngine")
        self.device = resolve_device(getattr(model, "device", "cuda"))
        on_card = self.device.type == "cuda"
        for name, flag in (("use_kernel", use_kernel), ("write_kernel", write_kernel)):
            if flag is not None and bool(flag) != on_card:
                raise ValueError(f"{name}={flag!r}: the port's kernels run on the card and their "
                                 f"plain versions on the CPU, and this model is on {self.device}")
        self.model = model
        self.cfg = cfg = model.cfg
        self.dtype = model.dtype
        self.max_slots = max_slots
        self.page_size = page_size
        self.total_pages = total_pages
        self.pages_per_seq = pages_per_seq
        self.on_token = on_token
        shape = (cfg.num_layers, total_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        # page 0 is the reserved null page: unused table entries point at it
        self._free = list(range(total_pages - 1, 0, -1))
        # host mirrors of the step's inputs: lengths evolve deterministically (+1 per active
        # step), so the host never reads them back
        self.tables = np.zeros((max_slots, pages_per_seq), np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.cur_tokens = np.zeros((max_slots,), np.int32)
        self._temps = np.zeros((max_slots,), np.float32)
        self._top_ps = np.ones((max_slots,), np.float32)
        self._top_ks = np.zeros((max_slots,), np.int32)
        self._seeds = np.zeros((max_slots,), np.int32)
        self._eos = np.full((max_slots,), -1, np.int32)
        self._min_new = np.zeros((max_slots,), np.int32)
        self.slots = [_PagedSlot() for _ in range(max_slots)]
        # drain mode: set on preemption, cleared when a request completes (or the slots
        # empty), so that cheap re-admissions cannot make two growing sequences preempt each
        # other forever
        self._drain = False
        self.queue: deque[Request] = deque()
        self.finished: dict[int, np.ndarray] = {}
        self.stats = EngineStats()
        self._streamed: dict[int, int] = {}   # req_id -> tokens emitted
        if not 1 <= decode_block < page_size * pages_per_seq:
            raise ValueError("decode_block must be in [1, max context)")
        self.decode_block = decode_block
        self.enable_prefix_cache = enable_prefix_cache
        self._hash_to_pid: dict = {}            # chain hash -> page id
        self._pid_hash: dict[int, object] = {}  # page id -> chain hash
        self._ref: dict[int, int] = {}          # registered page -> live refs
        self._cached = OrderedDict()            # LRU of refcount-0 pages
        self._hash_memo: dict[int, list] = {}   # req_id -> chain hashes

        # the step's persistent inputs: the tables, then the per-slot fields
        self._inputs = StepInputs(max_slots, self.device, (max_slots, pages_per_seq))
        self._dev = self._inputs.dev
        self._pools = SimpleNamespace(k_pool=self.k_pages, v_pool=self.v_pages, k_scale=None,
                                      v_scale=None, tables=self._dev.tables)
        self._inv_freq = rope_inv_freq(cfg.rope_theta, cfg.head_dim, self.device)
        self._steps: dict[tuple, object] = {}   # (sampling, nblk) -> the step, or its graph

    def _emit(self, req_id: int, idx: int, tok: int) -> None:
        """Stream token ``idx`` once per request: preemption replays the same
        deterministic tokens, so indices already emitted are skipped."""
        if self.on_token is None:
            return
        if idx >= self._streamed.get(req_id, 0):
            self.on_token(req_id, tok)
            self._streamed[req_id] = idx + 1

    # -- page accounting -------------------------------------------------

    def pages_in_use(self) -> int:
        return (self.total_pages - 1) - len(self._free)

    def _alloc(self, n: int) -> list[int]:
        assert len(self._free) >= n
        out = [self._free.pop() for _ in range(n)]
        self.stats.pages_high_water = max(self.stats.pages_high_water, self.pages_in_use())
        return out

    def pages_cached(self) -> int:
        """Registered pages resident with no live reference (evictable)."""
        return len(self._cached)

    def _evict_one(self) -> None:
        pid, _ = self._cached.popitem(last=False)   # LRU
        h = self._pid_hash.pop(pid)
        del self._hash_to_pid[h]
        self._ref.pop(pid, None)
        self._free.append(pid)

    def _ensure_free(self, n: int) -> None:
        while len(self._free) < n and self._cached:
            self._evict_one()
        assert len(self._free) >= n

    def _chain_hashes(self, prompt) -> list:
        """sha256 digest chain over full pages: collision-resistant content
        addressing, so no crafted prompt can alias another tenant's pages."""
        pg = self.page_size
        hs, h = [], b""
        arr = np.ascontiguousarray(np.asarray(prompt), dtype=np.int32)
        for i in range(len(arr) // pg):
            h = hashlib.sha256(h + arr[i * pg:(i + 1) * pg].tobytes()).digest()
            hs.append(h)
        return hs

    def _free_slot_pages(self, slot: int) -> None:
        used = self.tables[slot][self.tables[slot] != 0]
        for pid in (int(x) for x in used):
            if pid in self._pid_hash:
                # a registered page: drop this slot's reference; at zero it stays cached
                self._ref[pid] -= 1
                if self._ref[pid] <= 0:
                    self._cached[pid] = None
            else:
                self._free.append(pid)
        self.tables[slot] = 0

    # -- admission / prefill --------------------------------------------

    def submit(self, req: Request) -> None:
        need = max(len(req.prompt) + req.max_new_tokens, len(req.prompt) + 1)
        if need > self.pages_per_seq * self.page_size:
            raise ValueError(f"request {req.req_id}: {need} tokens exceed pages_per_seq * "
                             f"page_size = {self.pages_per_seq * self.page_size}")
        if self._pages_needed(need) > self.total_pages - 1:
            raise ValueError(f"request {req.req_id}: prompt + max_new_tokens needs more pages "
                             f"than the pool can ever supply (total_pages={self.total_pages})")
        if self.enable_prefix_cache and req.req_id not in self._hash_memo:
            # hashed once: a blocked head-of-queue request would rehash on every step
            self._hash_memo[req.req_id] = self._chain_hashes(req.prompt)
        self.queue.append(req)

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _prefill(self, prompt, bucket: int):
        """A right-padded prompt through ``arch.forward`` into a one-row cache
        of ``bucket`` slots: ``(K [L, bucket, Hkv, D], V, the last prompt
        position's logits [V])``."""
        cache, lrow = prefill_bucket(self.model, prompt, bucket, self.device)
        return cache.k[:, 0], cache.v[:, 0], lrow

    def _gather_prefix(self, pids: torch.Tensor):
        """The pages ``pids`` (null-padded) as contiguous ``[L, n * ps, Hkv,
        D]`` K and V."""
        def g(pool):
            x = pool[:, pids]                                   # [L, n, Hkv, ps, D]
            n_layers, n, hkv, ps, d = x.shape
            return x.permute(0, 1, 3, 2, 4).reshape(n_layers, n * ps, hkv, d)

        return g(self.k_pages), g(self.v_pages)

    def _suffix_prefill(self, suffix, pk: torch.Tensor, pv: torch.Tensor, shared_len: int,
                        sb: int):
        """A cache-continuation prefill of the right-padded ``suffix`` in a
        ``[1, sb]`` bucket against the gathered prefix ``pk``/``pv`` ``[L, pb,
        Hkv, D]``, whose first ``shared_len`` rows are real: ``(the suffix's K
        [L, sb, Hkv, D], V, the last suffix position's logits [V])``. The
        compute saved against a whole-prompt prefill is the shared prefix."""
        pb = pk.shape[1]
        sv = len(suffix)
        size = pb + sb
        tokens = torch.zeros((1, sb), dtype=torch.int32)
        tokens[0, :sv] = torch.as_tensor(np.asarray(suffix, np.int32))
        tokens = tokens.to(self.device)
        cache = KVCache.create(self.cfg, 1, size, dtype=self.dtype, device=self.device)
        cache.k[:, 0, :pb] = pk
        cache.v[:, 0, :pb] = pv
        cache.length = shared_len
        attn_mask = (torch.arange(size, device=self.device)[None, :]
                     < shared_len + sv).to(torch.int32)
        positions = shared_len + torch.arange(sb, dtype=torch.int32, device=self.device)[None, :]
        logits, cache = arch.forward(self.model.params, tokens, self.cfg, cache=cache,
                                     attn_mask=attn_mask, dtype=self.dtype, positions=positions)
        rows = slice(shared_len, shared_len + sb)
        return cache.k[:, 0, rows], cache.v[:, 0, rows], logits[0, sv - 1]

    def _scatter(self, k: torch.Tensor, v: torch.Tensor, pids: np.ndarray) -> None:
        """A whole prefill's K/V ``[L, n, Hkv, D]`` into its pages: page ``j``
        takes rows ``[j * ps, (j + 1) * ps)``; ids past the allocated pages
        name the null page 0, whose content is never attended."""
        pg = self.page_size
        n_layers, rows, hkv, d = k.shape
        npages = len(pids)
        span = npages * pg
        ids = torch.as_tensor(pids, dtype=torch.long).to(self.device)
        for pool, x in ((self.k_pages, k), (self.v_pages, v)):
            if span != rows:
                x = torch.cat([x, x.new_zeros((n_layers, span - rows, hkv, d))], dim=1)
            pool[:, ids] = x.reshape(n_layers, npages, pg, hkv, d).permute(0, 1, 3, 2, 4)

    def _admit(self) -> None:
        if self._drain and all(st.req is None for st in self.slots):
            self._drain = False          # nothing left to drain
        while self.queue and not self._drain:
            free_slots = [i for i, st in enumerate(self.slots) if st.req is None]
            if not free_slots:
                return
            req = self.queue[0]
            p = len(req.prompt)
            pg = self.page_size

            # the prefix cache's probe: the longest cached run of full prompt pages, capped at
            # p - 1 tokens (the last position is computed, to sample the first token)
            shared, shared_pids, hashes = 0, [], None
            if self.enable_prefix_cache:
                hashes = self._hash_memo.get(req.req_id)
                if hashes is None:
                    hashes = self._chain_hashes(req.prompt)
                    self._hash_memo[req.req_id] = hashes
                for h in hashes[: (p - 1) // pg]:
                    pid = self._hash_to_pid.get(h)
                    if pid is None:
                        break
                    shared_pids.append(pid)
                    shared += 1
            need_new = self._pages_needed(p + 1) - shared
            # free and evictable pages, less the cached ones this request is about to reuse
            avail = (len(self._free) + len(self._cached)
                     - sum(1 for pid in shared_pids if pid in self._cached))
            if need_new > avail:
                return                       # wait for pages to free up
            self.queue.popleft()
            slot = free_slots[0]
            for pid in shared_pids:          # activate the shared pages
                self._ref[pid] = self._ref.get(pid, 0) + 1
                self._cached.pop(pid, None)
            self._ensure_free(need_new)

            shared_tok = shared * pg
            self.stats.prefills += 1
            self.stats.prefill_tokens += p - shared_tok
            self.stats.prefix_hit_tokens += shared_tok
            if shared == 0:
                k, v, lrow = self._prefill(req.prompt, _bucket(p))
            else:
                # gather the shared prefix pages and prefill only the suffix
                ns = 8
                while ns < shared:
                    ns *= 2
                gpids = np.zeros((ns,), np.int64)
                gpids[:shared] = shared_pids
                pk, pv = self._gather_prefix(torch.as_tensor(gpids).to(self.device))
                k, v, lrow = self._suffix_prefill(req.prompt[shared_tok:], pk, pv, shared_tok,
                                                  _bucket(p - shared_tok))

            pages = self._alloc(need_new)
            npages = -(-k.shape[1] // pg)
            # page j covers tokens [shared_tok + j * pg, ...); ids past the allocated pages
            # (a headroom page past the bucket, which the decode step fills) name page 0
            pids = np.zeros((npages,), np.int32)
            n_in_bucket = min(len(pages), npages)
            pids[:n_in_bucket] = pages[:n_in_bucket]
            self._scatter(k, v, pids)
            self.tables[slot] = 0
            if shared:
                self.tables[slot, :shared] = shared_pids
            self.tables[slot, shared:shared + len(pages)] = pages
            if self.enable_prefix_cache:
                # register this prompt's remaining full pages for reuse
                for i in range(shared, p // pg):
                    h = hashes[i]
                    pid = int(self.tables[slot, i])
                    if pid != 0 and h not in self._hash_to_pid:
                        self._hash_to_pid[h] = pid
                        self._pid_hash[pid] = h
                        self._ref[pid] = self._ref.get(pid, 0) + 1

            tok = first_token(req, lrow)
            self.lengths[slot] = p
            self.cur_tokens[slot] = tok
            self._temps[slot] = req.temperature
            self._top_ps[slot] = req.top_p
            self._top_ks[slot] = req.top_k
            self._seeds[slot] = req.seed
            self._eos[slot] = -1 if req.eos_token_id is None else req.eos_token_id
            self._min_new[slot] = req.min_new_tokens
            st = self.slots[slot]
            st.req = req
            st.generated = [tok]
            self._emit(req.req_id, 0, tok)

    # -- decode ----------------------------------------------------------

    def _stage(self, min_left: np.ndarray, steps: np.ndarray) -> None:
        """The host mirrors into the step's device buffer, one copy."""
        self._inputs.stage((self.lengths, self.cur_tokens, self._eos, min_left, self._temps,
                            self._top_ps, self._top_ks, self._seeds, steps), tables=self.tables)

    def _decode(self, sampling: bool, nblk: int):
        """The (sampling, nblk) step over the staged buffers, through its
        CUDA graph on the card with ``JIT_GENERATE`` on: ``(tokens [nblk, S],
        logits [S, V])``."""
        key = (sampling, nblk)
        run = self._steps.get(key)
        if run is None:
            run = self._steps[key] = generation._stepper(PagedStep(self, sampling, nblk),
                                                         self.device)
        return run()

    @torch.inference_mode()
    def warmup(self, sampling: bool = True) -> None:
        """Run every prefill bucket the engine can hit, the prefix cache's
        gathers and suffix prefills, and capture every decode graph (one step
        and, with ``decode_block`` > 1, the block; greedy, and sampling with
        ``sampling``) before serving, so that a run captures nothing new. The
        engine's state is untouched: the warm-up steps run with every slot
        idle and write only the null page, which is never attended."""
        max_ctx = self.pages_per_seq * self.page_size
        pg = self.page_size
        buckets = sorted({_bucket(n) for n in range(1, max_ctx)})
        for bkt in buckets:   # no "<= max_ctx" filter: a prompt's bucket may exceed it
            self._prefill([0, 0], bkt)
        if self.enable_prefix_cache:
            shared_max = max(1, (max_ctx - 1) // pg)
            ns_list = [8]
            while ns_list[-1] < shared_max:
                ns_list.append(ns_list[-1] * 2)
            for ns in ns_list:
                pk, pv = self._gather_prefix(torch.zeros(ns, dtype=torch.long,
                                                         device=self.device))
                for sb in buckets:
                    self._suffix_prefill([0], pk, pv, 0, sb)
        zeros = np.zeros((self.max_slots,), np.int32)
        blocks = (1, self.decode_block) if self.decode_block > 1 else (1,)
        for s in (False, True) if sampling else (False,):
            for nblk in blocks:
                for _ in range(2):   # the eager warm-up, then the capture and a replay
                    self._stage(zeros, zeros)
                    self._decode(s, nblk)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _append_paged(self, slot: int, tok: int) -> bool:
        """Append one generated token to a live slot: advance the host
        mirrors, stream it (a token after EOS is not part of the output and
        is not streamed), retire on EOS or ``max_new_tokens``. Returns True
        when the slot retired."""
        st = self.slots[slot]
        self.lengths[slot] += 1
        self.cur_tokens[slot] = tok
        st.generated.append(tok)
        req = st.req
        hit_eos = req.eos_token_id is not None and st.generated[-2] == req.eos_token_id
        if not hit_eos and len(st.generated) - 1 < req.max_new_tokens:
            self._emit(req.req_id, len(st.generated) - 1, tok)
        if hit_eos or len(st.generated) - 1 >= req.max_new_tokens:
            out = st.generated[: req.max_new_tokens]
            if req.eos_token_id is not None and req.eos_token_id in out:
                out = out[: out.index(req.eos_token_id) + 1]
            self.finished[req.req_id] = np.asarray(out, np.int32)
            self._streamed.pop(req.req_id, None)
            self._hash_memo.pop(req.req_id, None)
            self._clear_slot(slot)
            return True
        return False

    def _clear_slot(self, slot: int) -> None:
        st = self.slots[slot]
        st.req = None
        st.generated = []
        self._temps[slot] = 0.0
        self._eos[slot] = -1
        self._min_new[slot] = 0
        self._free_slot_pages(slot)
        self.lengths[slot] = 0

    @torch.inference_mode()
    def step(self) -> list[int]:
        self._admit()
        active = [st.req is not None for st in self.slots]
        if not any(active):
            return []
        nblk = self.decode_block
        if nblk > 1:
            # a block writes nblk positions per slot (a slot retiring inside it keeps writing
            # its own pages); near the context cap those could not be backed by owned pages,
            # so the tail runs one step at a time
            mx = max(int(self.lengths[i]) for i, a in enumerate(active) if a)
            if mx + nblk > self.pages_per_seq * self.page_size:
                nblk = 1

        # grow the tables to cover the next nblk writes per slot; with the pool dry, preempt
        # the youngest sequence (recompute: free its pages, queue it again; its tokens
        # depend only on its seed and token index, so its output is the same)
        for slot, st in enumerate(self.slots):
            if st.req is None:
                continue
            needed = self._pages_needed(int(self.lengths[slot]) + nblk)
            have = int(np.count_nonzero(self.tables[slot]))
            while needed > have:
                while not self._free:
                    if self._cached:
                        self._evict_one()
                        continue
                    victims = [i for i, s2 in enumerate(self.slots)
                               if s2.req is not None and i != slot]
                    if not victims:
                        raise RuntimeError("page pool exhausted by a single sequence; increase "
                                           "total_pages")
                    v = victims[-1]
                    self.stats.preemptions += 1
                    self._drain = True
                    self.queue.appendleft(self.slots[v].req)
                    self._clear_slot(v)
                self.tables[slot, have] = self._alloc(1)[0]
                have += 1
        active = [st.req is not None for st in self.slots]
        if not any(active):
            return []

        sampling = any(self._temps[i] > 0 for i, a in enumerate(active) if a)
        min_left = np.array([max(0, self._min_new[i] - len(st.generated))
                             for i, st in enumerate(self.slots)], np.int32)
        steps = np.array([len(st.generated) for st in self.slots], np.int32)
        t0 = time.perf_counter()
        self._stage(min_left, steps)
        toks, _ = self._decode(sampling, nblk)
        toks_np = toks.cpu().numpy()        # the one sync per step (per block)
        self.stats.steps += nblk
        self.stats.step_time_s += time.perf_counter() - t0

        done_ids = []
        for slot, st in enumerate(self.slots):
            if st.req is None:
                self.lengths[slot] = 0
                continue
            rid = st.req.req_id
            for j in range(nblk):
                self.stats.tokens_generated += 1
                if self._append_paged(slot, int(toks_np[j, slot])):
                    done_ids.append(rid)
                    break
        self.stats.requests_completed += len(done_ids)
        if done_ids:
            self._drain = False          # capacity freed; admissions resume
        return done_ids

    def run(self, requests: list[Request]) -> dict[int, np.ndarray]:
        for r in requests:
            self.submit(r)
        while self.queue or any(st.req is not None for st in self.slots):
            self.step()
        check_page_errors(self.device)
        out, self.finished = self.finished, {}
        return out


__all__ = ["PagedContinuousBatchEngine", "PagedStep", "paged_cfg_ok"]
