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
* :func:`matmul` runs the kernel of the storage width (``ops/gemm.py``: K1
  for 3 and 4 bits, K4 for 8, K5 for 2) for a CUDA tensor and its plain
  version for a CPU tensor. It is differentiable in ``x`` on both routes
  through :class:`QuantMatmul`, whose backward is :func:`matmul_t` (K10 on
  the card); the weights get no gradient, as the JAX custom VJP gives them
  zero cotangents.
* :class:`StackedQuantLinear` (:func:`stack_experts`) holds an MoE block's
  experts on a leading axis; :func:`matmul_stacked` applies every expert
  (dense prefill) and :func:`matmul_routed` one expert per row (K9 on the
  card, the top-k decode product).
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
    """Runtime layout. Rows are in group-sorted order when ``kperm`` is set."""

    qweight: torch.Tensor          # int32 [K * storage_bits / 32, N] words
    scales: torch.Tensor           # fp16  [G, N]
    zeros: torch.Tensor            # uint8 [G, N] effective zero points
    kperm: Optional[torch.Tensor]  # int64 [K]: sorted row k reads activation column kperm[k]
    bias: Optional[torch.Tensor]   # [N] in the model dtype
    bits: int = 4
    group_size: int = -1
    in_features: int = 0
    out_features: int = 0


STORAGE_BITS = {2: 2, 3: 4, 4: 4, 8: 8}     # bits per weight of the runtime words


def storage_bits(bits: int) -> int:
    return STORAGE_BITS[bits]


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
    """Raise for a layer shape that the kernel of ``bits`` does not take."""
    pack = 32 // storage_bits(bits)
    gs = group_size if group_size != -1 else k
    if k % pack or n % 4 or gs % pack:
        raise NotImplementedError(
            f"{gemm.KERNEL_NAMES[storage_bits(bits)]} needs K % {pack} == 0, N % 4 == 0 and "
            f"group size % {pack} == 0 for {bits}-bit layers (K={k}, N={n}, group size={gs}); "
            f"other shapes wait for ROADMAP Queue 2, {'K5' if bits == 2 else 'K4'}")


def from_packed(packed: PackedQuantLinear, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> QuantLinear:
    """Build the runtime layout on ``device`` from checkpoint tensors."""
    device = torch.device(device)
    bits = packed.bits
    sbits = storage_bits(bits)
    k, n = packed.in_features, packed.out_features
    if device.type == "cuda":
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
    bias = None if packed.bias is None else torch.as_tensor(_to_numpy(packed.bias)).to(device, dtype)
    return QuantLinear(
        qweight=torch.from_numpy(np.ascontiguousarray(weight)).to(device),
        scales=torch.from_numpy(scales).to(device),
        zeros=torch.from_numpy(np.ascontiguousarray(zeros)).to(device),
        kperm=None if kperm is None else torch.from_numpy(kperm).to(device),
        bias=bias,
        bits=bits,
        group_size=packed.group_size,
        in_features=k,
        out_features=n,
    )


def codes(ql: QuantLinear) -> torch.Tensor:
    """Integer codes [K, N] of the stored (sorted) rows."""
    return gemm.unpack_words(ql.qweight, storage_bits(ql.bits))


def dequantize(ql: QuantLinear, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense ``[K, N]`` weight in stored (group-sorted) row order; pair it with
    ``x[..., kperm]``. Counterpart of the JAX ``dequantize_xla``."""
    return gemm.dequantize_codes(codes(ql), ql.scales, ql.zeros, ql.group_size, dtype)


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
    """Plain ``y = x @ dequant(W) (+ bias)`` for any bit width: f32 weight and
    product, one cast to ``x``'s dtype. Counterpart of the JAX ``matmul_xla``."""
    y = gemm.wna16_matmul_ref(x.reshape(-1, ql.in_features), ql.qweight, ql.scales, ql.zeros,
                              ql.kperm, _bias(ql, x), ql.group_size, storage_bits(ql.bits))
    return y.reshape(*x.shape[:-1], ql.out_features)


def matmul_t(g: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """Cotangent of ``y = matmul(x, ql)``: ``dx = g @ dequant(W)^T``,
    ``g [..., N] -> [..., K]`` in ``g``'s dtype, ``kperm`` undone. A CUDA
    tensor launches K10 or raises; a CPU tensor takes its plain version.
    Counterpart of the JAX ``matmul_t``."""
    dx = gemm.wna16_matmul_t(g.reshape(-1, ql.out_features).contiguous(), ql.qweight,
                             ql.scales, ql.zeros, ql.kperm, ql.group_size,
                             storage_bits(ql.bits))
    return dx.reshape(*g.shape[:-1], ql.in_features)


class QuantMatmul(torch.autograd.Function):
    """``y = x @ dequant(W) (+ bias)`` with ``dx = g @ dequant(W)^T``: the
    counterpart of the JAX ``_matmul_vjp``. The layer is passed as a Python
    object, so its integer words, scales, zeros and bias get no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
        ctx.ql = ql
        y = gemm.wna16_matmul(x.reshape(-1, ql.in_features).contiguous(), ql.qweight,
                              ql.scales, ql.zeros, ql.kperm, _bias(ql, x), ql.group_size,
                              storage_bits(ql.bits))
        return y.reshape(*x.shape[:-1], ql.out_features)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        return matmul_t(g, ctx.ql), None


def matmul(x: torch.Tensor, ql: QuantLinear) -> torch.Tensor:
    """Quantized ``y = x @ dequant(W) (+ bias)``, ``x [..., K] -> [..., N]``.
    A CUDA tensor launches K1 (3/4-bit), K4 (8-bit) or K5 (2-bit) or raises; a
    CPU tensor takes the plain path. Differentiable in ``x`` on both routes
    (:class:`QuantMatmul`)."""
    return QuantMatmul.apply(x, ql)


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
    """Stack per-expert layers of identical shape; desc_act (``kperm``) raises."""
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


def matmul_routed(x: torch.Tensor, sql: StackedQuantLinear, sel: torch.Tensor,
                  check: bool = True) -> torch.Tensor:
    """Sparse MoE decode execution: row p of the result is
    ``x[p] @ dequant(W[sel[p]])`` (``x [P, K]``, ``sel`` int32 ``[P]`` ->
    ``[P, N]`` in ``x``'s dtype), plus the gathered bias. A CUDA tensor
    launches K9, which reads only the selected experts' words; a CPU tensor
    takes its plain version. 4-bit storage only (3- and 4-bit layers);
    ``check`` as in :func:`~autogptq_tpu_torch.ops.gemm.wna16_routed_matmul`."""
    y = gemm.wna16_routed_matmul(x.contiguous(), sel, sql.qweight, sql.scales, sql.zeros,
                                 sql.group_size, storage_bits(sql.bits), check=check)
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
]
