"""Quantized linear layers: the checkpoint layout and the port's runtime layout.

Counterpart of the JAX package's ``ops/quantlinear.py``.

* :class:`PackedQuantLinear` holds a layer's GPTQ checkpoint tensors
  (``qweight`` / ``qzeros`` / ``scales`` / ``g_idx``) as NumPy arrays.
* :class:`QuantLinear` is the runtime layout that :func:`from_packed` builds
  once at load. It keeps GPTQ's own K-packed words, ``32 / storage bits``
  consecutive K rows per 32-bit word: a 2-, 4- or 8-bit checkpoint without
  desc_act needs no repack. 3-bit codes are unpacked from GPTQ's 32-in-3-words
  interleave and stored in nibbles (storage bits 4), as the JAX package
  stores them. With desc_act (a non-trivial ``g_idx``) the rows are sorted
  into group order once at load and ``kperm`` maps each sorted row to its
  activation column (the TPU layouts of the JAX package are not carried
  over). Scales stay fp16 ``[G, N]`` as on disk; zero points become the
  effective uint8 ``[G, N]`` (for 3 bits up to 8, never re-masked).
* ``from_packed(..., layout="kb32l")`` builds the tile-contiguous layout
  instead (:func:`kb32l_pack`, 3- and 4-bit layers, the JAX package's kb32l
  shape rule): the same 4-bit words cut into contiguous 256-row by
  128-column tiles, column tile first, which K6 streams through K1's
  tensor-core decode GEMV (bf16/f16) or a multi-stage async-copy ring (f32).
* :func:`matmul` runs the kernel of the layout and storage width
  (``ops/gemm.py``: K1 for 3 and 4 bits, K4 for 8, K5 for 2, K6 for kb32l)
  for a CUDA tensor and its plain version for a CPU tensor. It is
  differentiable in ``x`` on both routes through :class:`QuantMatmul`, whose
  backward is :func:`matmul_t` (K10 on the card); the weights get no
  gradient, as the JAX custom VJP gives them zero cotangents. With
  ``prenorm=`` it applies an RMS norm first, fused into K1's kernels where
  eligible (inference only, outside :class:`QuantMatmul`).
* :class:`StackedQuantLinear` (:func:`stack_experts`) holds an MoE block's
  experts on a leading axis; :func:`matmul_stacked` applies every expert
  (dense prefill) and :func:`matmul_routed` one expert per row (K9 on the
  card, the top-k decode product; differentiable in ``x`` through
  :class:`RoutedMatmul`, K10 per selected expert on the card).
* :func:`pack_from_solver` turns the GPTQ solver's outputs into checkpoint
  tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import gemm, packing


@dataclass
class PackedQuantLinear:
    """GPTQ checkpoint tensors of one linear layer (NumPy)."""

    qweight: np.ndarray            # int32 [K*bits/32, N]
    qzeros: np.ndarray             # int32 [G, N*bits/32]
    scales: np.ndarray             # fp16  [G, N]
    g_idx: np.ndarray              # int32 [K]
    bias: Optional[np.ndarray]     # [N] or None
    bits: int = 4
    group_size: int = -1
    in_features: int = 0
    out_features: int = 0


@dataclass
class QuantLinear:
    """Runtime layout. Rows are in group-sorted order when ``kperm`` is set.
    With ``layout == "kb32l"`` the words are tiles ``[N_pad/128 * K_pad/256,
    32, 128]`` and scales and zeros ``[K_pad/gs, N_pad]`` (:func:`kb32l_pack`)."""

    qweight: torch.Tensor          # int32 [K * storage_bits / 32, N] words
    scales: torch.Tensor           # fp16  [G, N]
    zeros: torch.Tensor            # uint8 [G, N] effective zero points
    kperm: Optional[torch.Tensor]  # int64 [K]: sorted row k reads activation column kperm[k]
    bias: Optional[torch.Tensor]   # [N] in the model dtype
    bits: int = 4
    group_size: int = -1
    in_features: int = 0
    out_features: int = 0
    layout: str = "gptq"           # "gptq" (K1/K4/K5) or "kb32l" (K6)


STORAGE_BITS = gemm.STORAGE_BITS
storage_bits = gemm.storage_bits


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def group_order(g_idx: np.ndarray, k: int, group_size: int, groups: int) -> Optional[np.ndarray]:
    """``kperm`` for a desc_act ``g_idx`` (None when it is the trivial order).
    GPTQ always makes groups of equal size; anything else raises."""
    gs = group_size if group_size != -1 else k
    g_idx = np.asarray(g_idx)
    if np.array_equal(g_idx, np.arange(k) // gs):
        return None
    counts = np.bincount(g_idx, minlength=groups)
    if len(counts) != groups or not np.all(counts == counts[0]) or counts[0] * groups != k:
        raise ValueError("non-uniform g_idx group sizes are not supported by the runtime layout "
                         "(GPTQ always produces uniform groups)")
    return np.argsort(g_idx, kind="stable").astype(np.int64)


def check_card_shape(bits: int, k: int, n: int, group_size: int) -> None:
    """Raise for a layer shape that the kernels of ``bits`` do not take: only
    what no GPTQ checkpoint can hold. ``qweight`` is ``[K*bits/32, N]`` and
    ``qzeros`` ``[G, N*bits/32]``, so ``K*bits % 32 == 0`` and
    ``N*bits % 32 == 0`` in every checkpoint, and with them ``K % (32 /
    storage bits) == 0`` and ``N % 4 == 0``, which the kernels need. Every
    positive group size is taken (or -1, one group): one that the codes per
    word do not divide, and a partial last group, are looked up per code."""
    gs = group_size if group_size != -1 else k
    if (k * bits) % 32 or (n * bits) % 32 or gs <= 0:
        raise NotImplementedError(
            f"{gemm.KERNEL_NAMES[storage_bits(bits)]} takes {bits}-bit layers whose K*{bits} "
            f"and N*{bits} are whole 32-bit words, as in every GPTQ checkpoint, and a positive "
            f"group size (K={k}, N={n}, group size={gs})")


def check_kb32l_shape(bits: int, k: int, group_size: int) -> None:
    """Raise ValueError for a layer the kb32l layout does not take: the JAX
    package's rule (``autogptq_tpu/ops/quantlinear.py:380-390``), 3- and 4-bit
    codes only."""
    gs = group_size if group_size != -1 else k
    if bits not in (3, 4):
        raise ValueError(f"kb32l holds 3- and 4-bit codes, got bits={bits}")
    if not gemm.kb32l_shape_ok(k, gs):
        raise ValueError(f"kb32l requires group_size | 256, group_size % 32 == 0 and "
                         f"group-aligned K (got K={k}, gs={gs})")


def kb32l_pack(words: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, k: int,
               group_size: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kb32l layout of 4-bit GPTQ words ``[K/8, N]`` of the sorted rows with
    fp16 scales and uint8 zeros ``[G, N]``, on their device: K padded to 256
    rows and N to 128 columns with zero words, scales and zeros, the words cut
    into ``[32, 128]`` tiles, tile ``(j, kb)`` at ``j * K_pad/256 + kb``.
    Returns ``(words [N_pad/128 * K_pad/256, 32, 128], scales [K_pad/gs,
    N_pad], zeros [K_pad/gs, N_pad])``."""
    n = words.shape[1]
    gs = group_size if group_size != -1 else k
    kb, bn = gemm.KB32L_KB, gemm.KB32L_BN
    k_pad, n_pad = -(-k // kb) * kb, -(-n // bn) * bn

    def pad(a, rows):
        out = a.new_zeros((rows, n_pad))
        out[:a.shape[0], :n] = a
        return out

    tiles = pad(words, k_pad // 8).view(k_pad // 8, n_pad // bn, bn).permute(1, 0, 2)
    return (tiles.contiguous().view(-1, kb // 8, bn), pad(scales, k_pad // gs),
            pad(zeros, k_pad // gs))


def from_packed(packed: PackedQuantLinear, device="cuda", dtype: torch.dtype = torch.bfloat16,
                layout: Optional[str] = None) -> QuantLinear:
    """Build the runtime layout on ``device`` from checkpoint tensors.
    ``layout`` None or ``"gptq"`` keeps GPTQ's K-packed words (K1/K4/K5);
    ``"kb32l"`` builds the tile-contiguous layout of K6, the counterpart of
    the JAX ``from_packed(layout="kb32l")``. Any other value raises."""
    device = torch.device(device)
    layout = layout or "gptq"
    if layout not in ("gptq", "kb32l"):
        raise ValueError(f"layout must be 'gptq' or 'kb32l', got {layout!r}")
    bits = packed.bits
    sbits = storage_bits(bits)
    k, n = packed.in_features, packed.out_features
    if layout == "kb32l":
        check_kb32l_shape(bits, k, packed.group_size)
    elif device.type == "cuda":
        check_card_shape(bits, k, n, packed.group_size)
    qweight = np.ascontiguousarray(_to_numpy(packed.qweight))
    scales = np.ascontiguousarray(_to_numpy(packed.scales).astype(np.float16))
    zeros = packing.unpack_qzeros(_to_numpy(packed.qzeros), bits)[:, :n].astype(np.uint8)
    kperm = group_order(_to_numpy(packed.g_idx), k, packed.group_size, scales.shape[0])

    if bits == sbits and kperm is None:
        weight = qweight
    else:
        codes = packing.unpack_qweight(qweight, bits)[:k]
        if kperm is not None:
            codes = codes[kperm]
        weight = packing.pack_qweight(codes, sbits)
    weight = torch.from_numpy(np.ascontiguousarray(weight)).to(device)
    scales = torch.from_numpy(scales).to(device)
    zeros = torch.from_numpy(np.ascontiguousarray(zeros)).to(device)
    if layout == "kb32l":
        weight, scales, zeros = kb32l_pack(weight, scales, zeros, k, packed.group_size)
    bias = None if packed.bias is None else torch.as_tensor(_to_numpy(packed.bias)).to(device, dtype)
    return QuantLinear(
        qweight=weight,
        scales=scales,
        zeros=zeros,
        kperm=None if kperm is None else torch.from_numpy(kperm).to(device),
        bias=bias,
        bits=bits,
        group_size=packed.group_size,
        in_features=k,
        out_features=n,
        layout=layout,
    )


def gptq_tensors(ql: QuantLinear) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPTQ words ``[K/P, N]``, scales and zeros ``[G, N]`` of either layout
    (kb32l's de-linearized, padding cut)."""
    if ql.layout != "kb32l":
        return ql.qweight, ql.scales, ql.zeros
    k = ql.in_features
    return gemm.kb32l_as_gptq(ql.qweight, ql.scales, ql.zeros, k, ql.out_features,
                              ql.group_size if ql.group_size != -1 else k)


def codes(ql: QuantLinear) -> torch.Tensor:
    """Integer codes [K, N] of the stored (sorted) rows."""
    return gemm.unpack_words(gptq_tensors(ql)[0], storage_bits(ql.bits))


def dequantize(ql: QuantLinear, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense ``[K, N]`` weight in stored (group-sorted) row order; pair it with
    ``x[..., kperm]``. Counterpart of the JAX ``dequantize_xla``."""
    _, scales, zeros = gptq_tensors(ql)
    return gemm.dequantize_codes(codes(ql), scales, zeros, ql.group_size, dtype)


def logical_weight(ql: QuantLinear, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense ``[in_features, out_features]`` weight in logical row order
    (kperm undone)."""
    w = dequantize(ql, dtype)
    if ql.kperm is None:
        return w
    out = torch.empty_like(w)
    out[ql.kperm] = w
    return out


def _bias(ql: QuantLinear, x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if ql.bias is None else ql.bias.to(x.dtype)


def matmul_plain(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """Plain ``y = x @ dequant(W) (+ bias)`` for any bit width and layout: f32
    weight and product, one cast to ``x``'s dtype. Counterpart of the JAX
    ``matmul_xla``."""
    x2d = x.reshape(-1, ql.in_features)
    if ql.layout == "kb32l":
        y = gemm.w4a16_kb32l_matmul_ref(x2d, ql.qweight, ql.scales, ql.zeros, ql.kperm,
                                        _bias(ql, x), ql.group_size, ql.out_features)
    else:
        y = gemm.wna16_matmul_ref(x2d, ql.qweight, ql.scales, ql.zeros, ql.kperm,
                                  _bias(ql, x), ql.group_size, storage_bits(ql.bits))
    return y.reshape(*x.shape[:-1], ql.out_features)


def matmul_t(g: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """Cotangent of ``y = matmul(x, ql)``: ``dx = g @ dequant(W)^T``,
    ``g [..., N] -> [..., K]`` in ``g``'s dtype, ``kperm`` undone. A CUDA
    tensor launches K10 or raises; a CPU tensor takes its plain version.
    Counterpart of the JAX ``matmul_t``."""
    dx = gemm.wna16_matmul_t(g.reshape(-1, ql.out_features).contiguous(), ql.qweight,
                             ql.scales, ql.zeros, ql.kperm, ql.group_size,
                             storage_bits(ql.bits), k=ql.in_features)
    return dx.reshape(*g.shape[:-1], ql.in_features)


class QuantMatmul(torch.autograd.Function):
    """``y = x @ dequant(W) (+ bias)`` with ``dx = g @ dequant(W)^T``: the
    counterpart of the JAX ``_matmul_vjp``. The layer is passed as a Python
    object, so its integer words, scales, zeros and bias get no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
        ctx.ql = ql
        x2d = x.reshape(-1, ql.in_features).contiguous()
        if ql.layout == "kb32l":
            y = gemm.w4a16_kb32l_matmul(x2d, ql.qweight, ql.scales, ql.zeros, ql.kperm,
                                        _bias(ql, x), ql.group_size, ql.out_features)
        else:
            y = gemm.wna16_matmul(x2d, ql.qweight, ql.scales, ql.zeros, ql.kperm, _bias(ql, x),
                                  ql.group_size, storage_bits(ql.bits))
        return y.reshape(*x.shape[:-1], ql.out_features)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        return matmul_t(g, ctx.ql), None


def matmul(x: torch.Tensor, ql: QuantLinear, prenorm: Optional[tuple] = None) -> torch.Tensor:
    """Quantized ``y = x @ dequant(W) (+ bias)``, ``x [..., K] -> [..., N]``.
    A CUDA tensor launches K1 (3/4-bit), K4 (8-bit), K5 (2-bit) or K6 (the
    kb32l layout) or raises; a CPU tensor takes the plain path.
    Differentiable in ``x`` on both routes (:class:`QuantMatmul`).

    ``prenorm=(weight, eps, plus_one)`` applies an RMS norm to ``x`` first,
    fused into K1's kernels where ``gemm.prenorm_eligible`` admits the call
    (``gemm.wna16_matmul(prenorm=)``), else unfused (``gemm.rms_apply``; a
    kb32l layer always). Inference only, as in the JAX package, whose prenorm
    path lies outside its custom VJP: with grad mode on, an ``x`` or a norm
    weight that requires grad raises rather than lose its gradient."""
    if prenorm is None:
        return QuantMatmul.apply(x, ql)
    if torch.is_grad_enabled() and (x.requires_grad or prenorm[0].requires_grad):
        raise RuntimeError("the fused-norm matmul (prenorm=) is inference-only: it has no "
                           "gradient; run it under torch.no_grad() or without prenorm")
    x2d = x.reshape(-1, ql.in_features).contiguous()
    if ql.layout == "kb32l":
        y = gemm.w4a16_kb32l_matmul(gemm.rms_apply(x2d, *prenorm), ql.qweight, ql.scales,
                                    ql.zeros, ql.kperm, _bias(ql, x), ql.group_size,
                                    ql.out_features)
    else:
        y = gemm.wna16_matmul(x2d, ql.qweight, ql.scales, ql.zeros, ql.kperm, _bias(ql, x),
                              ql.group_size, storage_bits(ql.bits), prenorm=prenorm)
    return y.reshape(*x.shape[:-1], ql.out_features)


@dataclass
class StackedQuantLinear:
    """E experts' runtime layouts on a leading expert axis (MoE), each with
    the trivial row order. Counterpart of the JAX ``StackedQuantLinear``."""

    qweight: torch.Tensor          # int32 [E, K * storage_bits / 32, N]
    scales: torch.Tensor           # fp16  [E, G, N]
    zeros: torch.Tensor            # uint8 [E, G, N]
    bias: Optional[torch.Tensor]   # [E, N] or None
    bits: int = 4
    group_size: int = -1
    in_features: int = 0
    out_features: int = 0

    @property
    def num_experts(self) -> int:
        return self.qweight.shape[0]

    def expert(self, e: int) -> QuantLinear:
        """Expert ``e`` as a :class:`QuantLinear` of views into the stack."""
        return QuantLinear(
            qweight=self.qweight[e], scales=self.scales[e], zeros=self.zeros[e], kperm=None,
            bias=None if self.bias is None else self.bias[e], bits=self.bits,
            group_size=self.group_size, in_features=self.in_features,
            out_features=self.out_features)


def stack_experts(qls: list[QuantLinear]) -> StackedQuantLinear:
    """Stack per-expert layers of identical shape; desc_act (``kperm``) raises,
    and so do kb32l layers: K9 reads GPTQ words, and no JAX load path stacks
    kb32l."""
    if any(q.layout != "gptq" for q in qls):
        raise NotImplementedError("stacked experts in the kb32l layout are not ported and not "
                                  "queued (K9 reads GPTQ words, and the JAX package stacks no "
                                  "kb32l layers): load MoE checkpoints without layout='kb32l'")
    if any(q.kperm is not None for q in qls):
        raise ValueError("stacked experts require trivial g_idx (no desc_act)")
    first = qls[0]
    return StackedQuantLinear(
        qweight=torch.stack([q.qweight for q in qls]),
        scales=torch.stack([q.scales for q in qls]),
        zeros=torch.stack([q.zeros for q in qls]),
        bias=None if first.bias is None else torch.stack([q.bias for q in qls]),
        bits=first.bits, group_size=first.group_size, in_features=first.in_features,
        out_features=first.out_features)


def matmul_stacked(x: torch.Tensor, sql: StackedQuantLinear) -> torch.Tensor:
    """Dense MoE execution: every expert applied to the same ``x``, one
    :func:`matmul` per expert (K1, K4 or K5 on the card). Returns
    ``[E, ..., N]``."""
    return torch.stack([matmul(x, sql.expert(e)) for e in range(sql.num_experts)])


def matmul_routed_t(g: torch.Tensor, sql: StackedQuantLinear, sel: torch.Tensor) -> torch.Tensor:
    """Cotangent of the routed product: row p of ``dx`` is
    ``g[p] @ dequant(W[sel[p]])^T`` (``g [P, N] -> [P, K]`` in ``g``'s dtype):
    :func:`matmul_t` on the rows of each distinct expert, K10 on the card and
    its plain version on the CPU. Finding the distinct experts waits for the
    card once."""
    dx = torch.empty((g.shape[0], sql.in_features), dtype=g.dtype, device=g.device)
    ids = sel.long()
    for e in torch.unique(ids).tolist():
        if not 0 <= e < sql.num_experts:
            raise ValueError(f"expert ids must lie in [0, {sql.num_experts}), got {e}")
        rows = (ids == e).nonzero()[:, 0]
        dx[rows] = matmul_t(g[rows], sql.expert(e))
    return dx


class RoutedMatmul(torch.autograd.Function):
    """``y[p] = x[p] @ dequant(W[sel[p]])`` with ``dx = matmul_routed_t``:
    the gradient of the JAX routed XLA path (``quantlinear.py:1040-1053``).
    The stack is passed as a Python object, so the experts get no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, sql: StackedQuantLinear, sel: torch.Tensor,
                check: bool) -> torch.Tensor:
        ctx.sql = sql
        ctx.save_for_backward(sel)
        return gemm.wna16_routed_matmul(x.contiguous(), sel, sql.qweight, sql.scales, sql.zeros,
                                        sql.group_size, storage_bits(sql.bits), check=check)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (sel,) = ctx.saved_tensors
        return matmul_routed_t(g.contiguous(), ctx.sql, sel), None, None, None


def matmul_routed(x: torch.Tensor, sql: StackedQuantLinear, sel: torch.Tensor,
                  check: bool = True) -> torch.Tensor:
    """Sparse MoE decode execution: row p of the result is
    ``x[p] @ dequant(W[sel[p]])`` (``x [P, K]``, ``sel`` int32 ``[P]`` ->
    ``[P, N]`` in ``x``'s dtype), plus the gathered bias. A CUDA tensor
    launches K9, which reads only the selected experts' words; a CPU tensor
    takes its plain version. Differentiable in ``x`` on both routes
    (:class:`RoutedMatmul`). 4-bit storage only (3- and 4-bit layers);
    ``check`` as in :func:`~autogptq_tpu_torch.ops.gemm.wna16_routed_matmul`."""
    y = RoutedMatmul.apply(x, sql, sel, check)
    if sql.bias is not None:
        y = y + sql.bias[sel.long()].to(y.dtype)
    return y


def solver_codes(w: torch.Tensor, scales16: torch.Tensor, zero: torch.Tensor,
                 g_idx: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes [K, N] of fake-quantized weights ``w [N, K]``:
    ``clip(rint(w / scale + zero), 0, 2^bits - 1)`` in float64 on ``w``'s
    device, the arithmetic of ``packing.quantize_weight_rtn`` (IEEE division
    and round-half-even on both sides, so the codes are the same bits)."""
    g = g_idx.long()
    s = scales16.double()[g]                 # [K, N]
    z = zero.double()[g]
    q = torch.round(w.t().double() / s + z)
    return q.clamp_(0, (1 << bits) - 1).to(torch.uint8)


def pack_from_solver(w, scale, zero, g_idx, bits: int, group_size: int,
                     bias: Optional[np.ndarray] = None) -> PackedQuantLinear:
    """Pack GPTQ solver outputs (``w [N, K]`` fake-quantized weights, ``scale``
    and ``zero`` [G, N], ``g_idx`` [K]; tensors or arrays) into the checkpoint
    layout. Scales are rounded to fp16 and zeros to integers *before*
    ``intweight = clip(rint(w / scale + zero))``: the order decides codes. The
    codes are computed where ``w`` lies (:func:`solver_codes`); the words are
    packed on the host by ``ops/packing.py``, bit for bit what
    ``packing.pack_layer`` gives for the same inputs."""
    w = torch.as_tensor(w)
    dev = w.device
    n, k = w.shape
    scales16 = torch.as_tensor(scale).to(dev).to(torch.float16)
    zero_int = torch.round(torch.as_tensor(zero).to(dev).float())
    g_idx_t = torch.as_tensor(g_idx).to(dev)
    codes = solver_codes(w, scales16, zero_int, g_idx_t, bits).cpu().numpy()
    return PackedQuantLinear(
        qweight=packing.pack_qweight(codes, bits),
        qzeros=packing.pack_qzeros(zero_int.cpu().numpy().astype(np.int64), bits),
        scales=scales16.cpu().numpy(),
        g_idx=g_idx_t.cpu().numpy().astype(np.int32),
        bias=None if bias is None else np.asarray(bias),
        bits=bits, group_size=group_size, in_features=k, out_features=n)


__all__ = [
    "PackedQuantLinear",
    "QuantLinear",
    "from_packed",
    "pack_from_solver",
    "solver_codes",
    "check_card_shape",
    "check_kb32l_shape",
    "kb32l_pack",
    "gptq_tensors",
    "storage_bits",
    "codes",
    "group_order",
    "dequantize",
    "logical_weight",
    "matmul",
    "matmul_plain",
    "matmul_t",
    "QuantMatmul",
    "StackedQuantLinear",
    "stack_experts",
    "matmul_stacked",
    "matmul_routed",
    "matmul_routed_t",
    "RoutedMatmul",
]
