"""The Llama decoder in PyTorch: the port's counterpart of the JAX package's
``models/arch.py``, llama path and Mixtral's sparse MoE MLP (:func:`moe_mlp`).

Parameters are a plain dict (``embed_tokens``, ``final_norm``, ``lm_head``,
``layers``: one dict per block with ``input_norm``, ``post_norm``, ``attn``
and ``mlp``), the same tree the JAX package builds. Linear layers are
:class:`DenseLinear` or :class:`~autogptq_tpu_torch.ops.quantlinear.QuantLinear`.

The KV cache is the JAX package's stacked ``[L, B, S, Hkv, D]`` pair, written
in place (the port mutates where JAX returns a new array), bf16/f16/f32 or int8
with f32 scales ``[L, B, S, Hkv, 1]`` (``KVCache.create(quantized=True)``,
rows quantized by :func:`kv_quantize`, the JAX ``_kv_quantize``). Decode steps
(``t == 1`` with a float cache) attend through K2 (``ops/flash_decode.py``)
over the slots ``[lo, hi)`` of the layer; prefill attention is plain tensor
code that mirrors the JAX einsum path, and so is every step over an int8
cache (the JAX package never takes its flash decode there, its
``models/arch.py:767``: a static dispatch, its scales folded into the dots)
and every step of a block that holds an adaption prompt (``attn.adaption``,
``utils/peft.py``). After
:meth:`KVCache.start_decode` a decode step keeps its write cursor and K2's
bounds on the card, so that it reads no host value and a CUDA graph of it
(``utils/generation.py``) can be replayed; its RoPE and K/V write are one K8a
launch per layer (``ops/paged_attn.rope_write_kv``). The slot engine
(``serving.ContinuousBatchEngine``) and speculative decoding give the cache
one cursor per row instead (``KVCache.cursors``, the JAX package's vector
``length``, its ``models/arch.py:707-745``): row ``b`` writes its ``T``
tokens at ``cursors[b] + [0, T)`` through K8a's per-row mode, a slot past the
written window dropped, and a one-token step of a float cache attends
through K2 over ``[0, cursors + 1)``, every other step (int8, ``T > 1``, an
adaption prompt) through the einsum with the per-row causal mask. Adapter nodes in
place of a linear (LoRA, AdaLoRA) are dispatched by :func:`apply_linear`. The
cache-less forward runs under autograd: training calls :func:`forward` and
``loss.backward()``. What the llama path does not need is refused:
alibi, MLA and softcaps belong to other families, which
``registry.get_family`` rejects; rope scaling and sliding windows are rejected
when the llama configuration is built.

:data:`FUSE_NORM` (``AUTOGPTQ_TPU_FUSE_NORM``, default ``"0"`` as in the JAX
package) fuses each decode step's RMS norms into the quantized q/k/v and
gate/up projections that follow them (``quantlinear.matmul(prenorm=)``: K1's
fused prologue on the card), in :func:`block_forward`'s dense-MLP decode steps
and the paged beam step.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops import quantlinear as qlin
from ..ops.flash_decode import flash_decode
from ..ops.paged_attn import kv_quantize, rope_inv_freq, rope_rows, rope_write_kv

NEG_INF = -1e30

# Fused norm+matmul for the decode step (the JAX package's switch, models/arch.py:152): "0" =
# off, anything else = the RMS norm feeding each quantized q/k/v/gate/up runs inside K1's
# kernel where gemm.prenorm_eligible admits it, unfused elsewhere. Read at every call.
FUSE_NORM = os.environ.get("AUTOGPTQ_TPU_FUSE_NORM", "0")


@dataclass(frozen=True)
class ArchConfig:
    """Static description of a Llama-family decoder."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    intermediate_size: int = 11008
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    moe_num_experts: int = 0                  # > 0: Mixtral-style MoE MLP
    moe_top_k: int = 2


@dataclass
class DenseLinear:
    kernel: torch.Tensor                  # [K, N]
    bias: Optional[torch.Tensor] = None


def apply_linear(p, x: torch.Tensor) -> torch.Tensor:
    # adapter nodes (utils/peft.py, which imports this module) by duck typing
    if hasattr(p, "lora_e"):
        from ..utils.peft import apply_adalora

        return apply_adalora(p, x)
    if hasattr(p, "lora_a"):
        from ..utils.peft import apply_lora

        return apply_lora(p, x)
    if isinstance(p, qlin.QuantLinear):
        return qlin.matmul(x, p)
    y = x @ p.kernel.to(x.dtype)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _prenorm_linear(node, x: torch.Tensor, norm: dict, cfg: ArchConfig) -> torch.Tensor:
    """``apply_linear(node, rms_norm(x))`` with the norm fused into a
    quantized layer's kernel (``quantlinear.matmul(prenorm=)``); an adapter or
    dense node takes the unfused norm. The port's families scale by ``w``,
    never ``1 + w``."""
    if isinstance(node, qlin.QuantLinear):
        return qlin.matmul(x, node, prenorm=(norm["weight"], cfg.norm_eps, False))
    return apply_linear(node, rms_norm(x, norm["weight"], cfg.norm_eps))


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """Llama (rotate-halves) RoPE. q/k: [B, T, H, D]; positions: [B, T]. A
    decode step at the device cursor turns q and k inside K8a instead
    (``ops/paged_attn.rope_write_kv``)."""
    return rope_rows(positions, rope_inv_freq(cfg.rope_theta, q.shape[-1], positions.device), q, k)


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return shape, shape


@dataclass
class KVCache:
    """Stacked KV cache, updated in place; ``length`` is the write cursor
    shared by every row (left padding keeps the rows aligned). An int8 cache
    (``quantized=True``) holds :func:`kv_quantize`'s codes in ``k`` / ``v``
    and their f32 scales in ``k_scale`` / ``v_scale`` ``[L, B, S, Hkv, 1]``.

    :meth:`start_decode` moves the cursor to the card for the decode steps:
    ``cursor`` (int64 ``[1]``) then stands for ``length``, which such steps
    neither read nor advance; K2's bounds persist beside it, ``lo`` fixed for
    the call and ``hi`` written by each step, and RoPE's ``inv_freq`` with
    them. A one-token :func:`forward` then reads no host value, turns q and k
    and writes K/V at ``cursor`` in one K8a launch per layer, and advances
    ``cursor`` in place, so a CUDA graph of the step advances it on every
    replay. Prefill, calibration and training use ``length``."""

    k: torch.Tensor       # [L, B, S, Hkv, D]
    v: torch.Tensor
    length: int = 0
    cursor: Optional[torch.Tensor] = None   # int64 [1]: the decode steps' write slot
    # int64 [B]: one write cursor per row (the slot engine, speculative decoding); with it set, a
    # forward of T tokens writes row b at cursors[b] + [0, T) (K8a, turning q and k by inv_freq)
    # and advances cursors by T in place, and neither length nor cursor is read
    cursors: Optional[torch.Tensor] = None
    win: Optional[int] = None               # per-row steps write and attend only slots [0, win)
    lo: Optional[torch.Tensor] = None       # int32 [B]: each row's first valid slot
    hi: Optional[torch.Tensor] = None       # int32 [B]: cursor + 1, K2's end of the window
    inv_freq: Optional[torch.Tensor] = None  # f32 [D / 2]: RoPE's, for K8a
    k_scale: Optional[torch.Tensor] = None   # f32 [L, B, S, Hkv, 1] (an int8 cache)
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", quantized: bool = False) -> "KVCache":
        kshape, vshape = cache_shapes(cfg, batch, max_len)
        if quantized:
            return cls(k=torch.zeros(kshape, dtype=torch.int8, device=device),
                       v=torch.zeros(vshape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(kshape[:-1] + (1,), dtype=torch.float32,
                                           device=device),
                       v_scale=torch.zeros(vshape[:-1] + (1,), dtype=torch.float32,
                                           device=device))
        return cls(k=torch.zeros(kshape, dtype=dtype, device=device),
                   v=torch.zeros(vshape, dtype=dtype, device=device))

    def start_decode(self, attn_mask: torch.Tensor, cfg: ArchConfig) -> None:
        """Put the cursor on the card at ``length``, and K2's ``lo`` from
        ``attn_mask [B, S]``: the first valid slot of each row's run, the
        cursor's slot for a row with none; ``inv_freq`` from ``cfg``."""
        b, dev = self.k.shape[1], self.k.device
        self.inv_freq = rope_inv_freq(cfg.rope_theta, cfg.head_dim, dev)
        self.cursor = torch.full((1,), self.length, dtype=torch.int64, device=dev)
        valid = attn_mask[:, :self.length].bool()
        self.lo = torch.where(valid.any(dim=1), valid.to(torch.int32).argmax(dim=1),
                              self.length).to(torch.int32)
        self.hi = torch.empty(b, dtype=torch.int32, device=dev)

    def window(self) -> tuple:
        """``(k, v, k_scale, v_scale)`` as the per-row steps write and attend
        them: views of the first ``win`` slots (all of them when ``win`` is
        None), so that a cursor past ``win`` writes nothing, as the JAX
        engine's window-bucketed steps drop it."""
        if self.win is None:
            return self.k, self.v, self.k_scale, self.v_scale
        return tuple(None if a is None else a[:, :, :self.win]
                     for a in (self.k, self.v, self.k_scale, self.v_scale))


def attention(bp: dict, x: torch.Tensor, layer_idx: int, cache: Optional[KVCache],
              positions: torch.Tensor, cfg: ArchConfig,
              attn_mask: Optional[torch.Tensor] = None,
              decode_bounds: Optional[tuple] = None,
              capture: Optional[dict] = None, prenorm: Optional[dict] = None) -> torch.Tensor:
    """Self-attention of one block; writes this step's K/V into ``cache``.
    ``decode_bounds = (lo, hi)`` (int32 [B]) selects the K2 decode path.
    ``capture`` (calibration, cache-less) records the input of every linear.
    ``prenorm`` (the input norm's params, :data:`FUSE_NORM`): ``x`` arrives
    raw and the norm fuses into q/k/v."""
    b, t, _ = x.shape
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if capture is not None:
        capture["q_proj"] = capture["k_proj"] = capture["v_proj"] = x
    lin = (apply_linear if prenorm is None
           else functools.partial(_prenorm_linear, norm=prenorm, cfg=cfg))
    q = lin(bp["q_proj"], x).view(b, t, h, d)
    k = lin(bp["k_proj"], x).view(b, t, hkv, d)
    v = lin(bp["v_proj"], x).view(b, t, hkv, d)
    scale = d ** -0.5
    kv_int8 = cache is not None and cache.k.dtype == torch.int8
    key_sc = val_sc = None

    if cache is not None and cache.cursors is not None:
        # per-row cursors: RoPE and the K/V write of row b's T tokens at cursors[b] + [0, T) in
        # one K8a launch (a slot past the window dropped; int8 rows quantized inside it)
        kc, vc, ksc, vsc = cache.window()
        qr = rope_write_kv(q.reshape(b * t, h, d), k.reshape(b * t, hkv, d),
                           v.reshape(b * t, hkv, d), positions.reshape(b * t), cache.inv_freq,
                           kc, vc, layer_idx, cursors=cache.cursors, k_scale=ksc, v_scale=vsc,
                           check=False)
        if decode_bounds is not None and not kv_int8 and "adaption" not in bp:
            of = flash_decode(qr, cache.k, cache.v, *decode_bounds, layer=layer_idx,
                              sm_scale=scale)
            return apply_linear(bp["o_proj"], of.reshape(b, 1, h * d).to(x.dtype))
        # int8, the verify window (T > 1) and an adaption prompt: the einsum over the window
        # with the JAX mask kv_slot <= cursors[b] + t
        q = qr.view(b, t, h, d)
        keys, values = kc[layer_idx], vc[layer_idx]
        if kv_int8:
            key_sc, val_sc = ksc[layer_idx], vsc[layer_idx]
        s = keys.shape[1]
        q_slot = cache.cursors[:, None] + torch.arange(t, device=x.device)[None, :]   # [B, T]
        mask = torch.arange(s, device=x.device)[None, None, :] <= q_slot[:, :, None]  # [B, T, S]
    elif cache is not None and cache.cursor is not None and t == 1:
        # a decode step at the device cursor (KVCache.start_decode): RoPE and the K/V write in
        # one K8a launch (int8 rows quantized inside it), whose target check generate reads once
        # (check_page_errors)
        if "adaption" in bp:
            raise ValueError("an adaption-prompt block attends up to the host cursor: decode it "
                             "without KVCache.start_decode")
        qr = rope_write_kv(q.view(b, h, d), k.view(b, hkv, d), v.view(b, hkv, d),
                           positions.reshape(b), cache.inv_freq, cache.k, cache.v, layer_idx,
                           cursor=cache.cursor, k_scale=cache.k_scale, v_scale=cache.v_scale,
                           check=False)
        if not kv_int8:
            of = flash_decode(qr, cache.k, cache.v, *decode_bounds, layer=layer_idx,
                              sm_scale=scale)
            return apply_linear(bp["o_proj"], of.reshape(b, 1, h * d).to(x.dtype))
        # an int8 cache takes the einsum below over all S slots, as the JAX package does
        # (never its flash decode): causality from the device cursor, the rows' validity from
        # attn_mask, so no host value is read
        q = qr.view(b, 1, h, d)
        keys, values = cache.k[layer_idx], cache.v[layer_idx]
        key_sc, val_sc = cache.k_scale[layer_idx], cache.v_scale[layer_idx]
        s = keys.shape[1]
        mask = (torch.arange(s, device=x.device) <= cache.cursor)[None, None]         # [1, 1, S]
    else:
        q, k = apply_rope(q, k, positions, cfg)
        if cache is not None:
            start = cache.length
            if start + t > cache.k.shape[2]:
                raise ValueError(f"KV cache of {cache.k.shape[2]} slots cannot take "
                                 f"{t} tokens at slot {start}")
            if kv_int8:
                (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
                for c, rows in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                                (cache.v_scale, vs)):
                    c[layer_idx, :, start:start + t] = rows
            else:
                cache.k[layer_idx, :, start:start + t] = k.to(cache.k.dtype)
                cache.v[layer_idx, :, start:start + t] = v.to(cache.v.dtype)
            if decode_bounds is not None and "adaption" not in bp and not kv_int8:
                lo, hi = decode_bounds
                of = flash_decode(q[:, 0].contiguous(), cache.k, cache.v, lo, hi,
                                  layer=layer_idx, sm_scale=scale)
                return apply_linear(bp["o_proj"], of.reshape(b, 1, h * d).to(x.dtype))
            s = start + t
            keys = cache.k[layer_idx, :, :s]
            values = cache.v[layer_idx, :, :s]
            if kv_int8:
                key_sc, val_sc = cache.k_scale[layer_idx, :, :s], cache.v_scale[layer_idx, :, :s]
            q_slot = start + torch.arange(t, device=x.device)
        else:
            keys, values = k, v
            s = t
            q_slot = torch.arange(t, device=x.device)
        # causality in cache-slot space (uniform across rows under left padding)
        mask = (torch.arange(s, device=x.device)[None, :] <= q_slot[:, None])[None]   # [1, T, S]

    # the "attention" range lets a profile attribute these kernels, and through
    # their sequence numbers those of their backward
    with record_function("attention"):
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, :s].bool()                               # [B, T, S]
        rep = h // hkv
        qh = q.reshape(b, t, hkv, rep, d)
        logits = torch.einsum("bthrd,bshd->bhrts", qh.float(), keys.float()) * scale
        if key_sc is not None:   # int8 cache: the per-(slot, head) scale after the QK dot
            logits = logits * key_sc[..., 0].transpose(1, 2)[:, :, None, None, :]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        if val_sc is not None:   # and its V scale on the probabilities before the PV dot
            probs = probs * val_sc[..., 0].transpose(1, 2)[:, :, None, None, :]
        out = torch.einsum("bhrts,bshd->bthrd", probs, values.float())
        if "adaption" in bp:
            # adaption prompt (LLaMA-Adapter): the prompt rows through the frozen
            # k/v projections, no RoPE on their keys, a softmax of their own over
            # the prompt, scaled by the zero-initialized gate
            ad = bp["adaption"]
            plen = ad.prompt.shape[0]
            pr = ad.prompt[None].to(x.dtype)
            kp = apply_linear(bp["k_proj"], pr).view(1, plen, hkv, d)
            vp = apply_linear(bp["v_proj"], pr).view(1, plen, hkv, d)
            ascore = torch.einsum("bthrd,xphd->bhrtp", qh.float(), kp.float()) * scale
            aprobs = torch.softmax(ascore, dim=-1) * ad.gate.float()
            out = out + torch.einsum("bhrtp,xphd->bthrd", aprobs, vp.float())
        out = out.reshape(b, t, h * d).to(x.dtype)
    if capture is not None:
        capture["o_proj"] = out
    return apply_linear(bp["o_proj"], out)


def mlp(bp: dict, x: torch.Tensor, cfg: ArchConfig,
        capture: Optional[dict] = None, prenorm: Optional[dict] = None) -> torch.Tensor:
    """``prenorm`` (the post-attention norm's params, :data:`FUSE_NORM`):
    ``x`` arrives raw and the norm fuses into gate/up; a MoE block refuses it
    (its router needs the normed hidden), as the JAX ``mlp`` asserts."""
    if cfg.moe_num_experts > 0:
        if prenorm is not None:
            raise ValueError("a MoE block takes no fused norm: its router needs the normed input")
        return moe_mlp(bp, x, cfg, capture)
    lin = (apply_linear if prenorm is None
           else functools.partial(_prenorm_linear, norm=prenorm, cfg=cfg))
    gate = lin(bp["gate_proj"], x)
    up = lin(bp["up_proj"], x)
    h = F.silu(gate) * up
    if capture is not None:
        capture["gate_proj"] = capture["up_proj"] = x
        capture["down_proj"] = h
    return apply_linear(bp["down_proj"], h)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, equal values in
    ascending index order (a stable sort, so ties route alike on every
    device)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routed_ok(st: dict) -> bool:
    """K9 takes 4-bit storage (3- and 4-bit layers); 2- and 8-bit stacks take
    the dense path, as the JAX package's ``supported_routed`` sends them."""
    return all(isinstance(st[p], qlin.StackedQuantLinear) and qlin.storage_bits(st[p].bits) == 4
               for p in ("gate_proj", "up_proj", "down_proj"))


def moe_mlp(bp: dict, x: torch.Tensor, cfg: ArchConfig,
            capture: Optional[dict] = None) -> torch.Tensor:
    """Mixtral-style sparse MoE with top-k routing, route for route the JAX
    ``moe_mlp``: router logits in f32, top-k, a softmax over the k logits and
    a dense ``combine [B, T, E]``. With stacked experts
    (``params.stack_moe_experts``) and at most E pairs of (token, expert), the
    routed path runs each pair's gate, up and down through
    :func:`~autogptq_tpu_torch.ops.quantlinear.matmul_routed` (K9 on the card,
    which reads the selection on the device: no sync); with more pairs, the
    dense path applies every expert (``matmul_stacked``) and combines. An
    expert list runs the per-expert masked loop, whose ``capture`` records
    each expert's inputs multiplied by its routed mask (calibration)."""
    b, t, hdim = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    weights, sel = top_k(apply_linear(bp["router"], x).float(), k)
    weights = torch.softmax(weights, dim=-1)                                   # [B, T, k]
    combine = torch.zeros((b, t, e), dtype=torch.float32, device=x.device)
    combine.scatter_add_(-1, sel, weights)

    if "experts_stacked" in bp:
        st = bp["experts_stacked"]
        if capture is None and b * t * k <= e and _routed_ok(st):
            sel_flat = sel.reshape(-1).to(torch.int32)
            xt = x.reshape(b * t, 1, hdim).expand(b * t, k, hdim).reshape(b * t * k, hdim)
            gate = qlin.matmul_routed(xt, st["gate_proj"], sel_flat, check=False)
            up = qlin.matmul_routed(xt, st["up_proj"], sel_flat, check=False)
            y = qlin.matmul_routed(F.silu(gate) * up, st["down_proj"], sel_flat, check=False)
            out = y.float() * weights.reshape(-1)[:, None]
            return out.reshape(b, t, k, hdim).sum(dim=2).to(x.dtype)
        h = F.silu(qlin.matmul_stacked(x, st["gate_proj"])) * qlin.matmul_stacked(x, st["up_proj"])
        down = st["down_proj"]
        y = torch.stack([qlin.matmul(h[i], down.expert(i)) for i in range(e)])
        return torch.einsum("ebth,bte->bth", y.float(), combine).to(x.dtype)

    out = torch.zeros_like(x, dtype=torch.float32)
    for i in range(e):
        ep = bp["experts"][i]
        if capture is not None:
            # the Hessians see only the tokens routed to this expert
            routed = (combine[..., i] > 0).to(x.dtype)[..., None]
            capture[f"experts.{i}.gate_proj"] = capture[f"experts.{i}.up_proj"] = x * routed
        h = F.silu(apply_linear(ep["gate_proj"], x)) * apply_linear(ep["up_proj"], x)
        if capture is not None:
            capture[f"experts.{i}.down_proj"] = h * routed
        out = out + apply_linear(ep["down_proj"], h).float() * combine[..., i][..., None]
    return out.to(x.dtype)


def block_forward(bp: dict, x: torch.Tensor, layer_idx: int, cache: Optional[KVCache],
                  positions: torch.Tensor, cfg: ArchConfig,
                  attn_mask: Optional[torch.Tensor] = None,
                  decode_bounds: Optional[tuple] = None,
                  capture: Optional[dict] = None) -> torch.Tensor:
    """One decoder block. With ``capture`` a dict, the input of every linear
    is recorded under its block-relative path (``attn.q_proj``,
    ``mlp.down_proj``, ...): the calibration pass of ``quantize``, which runs
    cache-less on a left-padded batch (``positions`` and ``attn_mask`` [B, T]).

    With :data:`FUSE_NORM` on, a one-token step with a cache and no capture
    of a dense-MLP block passes the raw ``x`` and the norms' params to
    ``attention`` and ``mlp``, which fuse each norm into the projections after
    it (the JAX gate, ``models/arch.py:1184-1193``; the port's blocks are all
    sequential pre-norm RMS blocks, so a MoE block stays unfused)."""
    attn_cap = {} if capture is not None else None
    mlp_cap = {} if capture is not None else None
    fuse_norm = (FUSE_NORM != "0" and capture is None and cache is not None
                 and x.shape[1] == 1 and cfg.moe_num_experts == 0)
    if fuse_norm:
        x = x + attention(bp["attn"], x, layer_idx, cache, positions, cfg, attn_mask,
                          decode_bounds, prenorm=bp["input_norm"])
        return x + mlp(bp["mlp"], x, cfg, prenorm=bp["post_norm"])
    h = rms_norm(x, bp["input_norm"]["weight"], cfg.norm_eps)
    x = x + attention(bp["attn"], h, layer_idx, cache, positions, cfg, attn_mask, decode_bounds,
                      attn_cap)
    h2 = rms_norm(x, bp["post_norm"]["weight"], cfg.norm_eps)
    x = x + mlp(bp["mlp"], h2, cfg, mlp_cap)
    if capture is not None:
        capture.update({f"attn.{k}": v for k, v in attn_cap.items()})
        capture.update({f"mlp.{k}": v for k, v in mlp_cap.items()})
    return x


def embed(params: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return params["embed_tokens"][tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final norm and head; logits are f32."""
    x = rms_norm(x, params["final_norm"]["weight"], cfg.norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return torch.einsum("bth,vh->btv", x.float(), params["embed_tokens"].float())
    return apply_linear(params["lm_head"], x).float()


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            cache: Optional[KVCache] = None, positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None, dtype: Optional[torch.dtype] = None,
            logits_last_only: bool = False, mask_contig: bool = False):
    """Full forward: returns ``(logits [B, T, V] f32, cache)``.

    With a cache, the step's K/V are written at slot ``cache.length`` and the
    cursor advances by T. ``attn_mask`` [B, S] marks valid key slots (0 for
    left padding). A decode step (T == 1 with a cache) attends through K2 and
    needs each row's valid slots to be one contiguous run, which
    ``mask_contig=True`` promises (generation builds its masks that way);
    after :meth:`KVCache.start_decode` it writes at ``cache.cursor`` on the
    card, takes K2's window from ``cache.lo`` and ``cache.hi`` (written here
    as ``cursor + 1``) and advances ``cursor`` in place, reading nothing on
    the host. With ``cache.cursors`` (one per row) row ``b`` writes at
    ``cursors[b]``, its positions are ``cursors[b] + [0, T)`` unless given,
    and ``cursors`` advances by T in place. ``logits_last_only`` unembeds
    only the last position, the newest token of every row under left
    padding."""
    b, t = tokens.shape
    dtype = dtype or params["embed_tokens"].dtype
    row_step = cache is not None and cache.cursors is not None
    device_step = not row_step and cache is not None and cache.cursor is not None and t == 1
    start = cache.length if cache is not None and not (device_step or row_step) else 0
    if row_step and attn_mask is not None:
        raise ValueError("per-row cursors take no attn_mask: each row's valid slots are "
                         "[0, cursors + T)")
    if positions is None:
        if attn_mask is not None and cache is None:
            positions = (torch.cumsum(attn_mask, dim=-1) - 1).clamp_min(0)
        elif row_step:
            positions = cache.cursors[:, None] + torch.arange(t, device=tokens.device)[None, :]
        elif device_step:
            positions = cache.cursor.view(1, 1).expand(b, t)
        else:
            positions = (torch.arange(t, device=tokens.device) + start)[None].expand(b, t)

    decode_bounds = None
    if row_step:
        if t == 1:   # K2 over [lo, cursors + 1): lo 0 unless the caller keeps its own
            lo = (cache.lo if cache.lo is not None
                  else torch.zeros(b, dtype=torch.int32, device=tokens.device))
            decode_bounds = (lo, (cache.cursors + 1).to(torch.int32))
    elif cache is not None and t == 1:
        if attn_mask is not None and not mask_contig:
            raise ValueError("a decode step needs a contiguous left-pad attn_mask "
                             "(mask_contig=True)")
        if device_step:
            cache.hi.copy_(cache.cursor + 1)
            decode_bounds = (cache.lo, cache.hi)
        else:
            if attn_mask is None:
                lo = torch.zeros(b, dtype=torch.int32, device=tokens.device)
            else:   # first valid slot of each row's contiguous run
                lo = attn_mask.to(torch.int32).argmax(dim=1).to(torch.int32)
            hi = torch.full((b,), start + 1, dtype=torch.int32, device=tokens.device)
            decode_bounds = (lo, hi)

    x = embed(params, tokens, dtype)
    for i, bp in enumerate(params["layers"]):
        x = block_forward(bp, x, i, cache, positions, cfg, attn_mask, decode_bounds)
    logits = unembed(params, x[:, -1:] if logits_last_only else x, cfg)
    if row_step:
        cache.cursors.add_(t)
    elif device_step:
        cache.cursor.add_(1)
    elif cache is not None:
        cache.length = start + t
    return logits, cache


__all__ = [
    "ArchConfig",
    "DenseLinear",
    "KVCache",
    "cache_shapes",
    "kv_quantize",
    "apply_linear",
    "rms_norm",
    "FUSE_NORM",
    "apply_rope",
    "attention",
    "mlp",
    "moe_mlp",
    "top_k",
    "block_forward",
    "embed",
    "unembed",
    "forward",
]
