"""Carry a parameter tree of the JAX package across to the port.

``params_from_jax`` takes the JAX package's params tree (its leaves as NumPy
arrays, or any array that ``np.asarray`` reads) and returns the port's
params dict. The tree's nodes are recognised by their fields, so this module
imports nothing from the JAX package:

* a dense linear (``kernel``, ``bias``) is copied;
* a quantized linear in the ``kb32``, ``kb32l``, ``ki32``, ``kpair``,
  ``k2i32``, ``kquad``, ``koct`` or ``planar`` layout is unpacked with the
  port's copy of that layout's ``*_unpack_np`` (pack granularity 1024 rows for
  kb32 and kb32l, whose tiles are first de-linearized, the group size for
  ki32, k2i32 and kquad), stripped of its K/N padding and repacked into the
  port's words, keeping ``kperm``; a kb32l node becomes a port kb32l node
  (``quantlinear.kb32l_pack``), every other one GPTQ words;
* a stacked expert node (``StackedQuantLinear``: ``num_experts``, words with
  a leading expert axis) is carried across expert by expert as above and
  stacked into the port's ``StackedQuantLinear``;
* the adapter nodes of the JAX ``utils/peft.py`` become the port's
  (``utils/peft.py``): an AdaLoRA node (``lora_e``, with ``rank_mask`` and
  ``scaling``), a LoRA node (``lora_a``, ``lora_b``, ``scaling``), each with
  its ``base`` carried across, and an adaption prompt (``prompt``, ``gate``);
  their tensors stay f32, the trainable ones with ``requires_grad=True``;
* dicts and lists are walked; any other array (norm weights, embeddings) is
  copied.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..models.arch import DenseLinear
from ..ops import packing
from ..ops.quantlinear import (STORAGE_BITS, QuantLinear, StackedQuantLinear, kb32l_pack,
                               stack_experts)
from . import peft

_QUANT_FIELDS = ("wp", "scales", "zeros", "kperm", "layout", "group_size", "in_features",
                 "out_features", "bits")


def ki32_unpack_np(wp: np.ndarray, gs: int) -> np.ndarray:
    """Codes [K, N] of a JAX ki32/kb32 word array [K/8, N]: within each block
    of ``gs`` rows, word j's nibble m holds row m*gs/4 + 2j, and nibble m + 4
    row m*gs/4 + 2j + 1."""
    k8, n = wp.shape
    k = k8 * 8
    w = wp.astype(np.uint32).reshape(k // gs, gs // 8, n)
    q = gs // 4
    out = np.empty((k // gs, gs, n), np.uint8)
    for m in range(4):
        pair = w >> np.uint32(4 * m)
        out[:, m * q + 0:(m + 1) * q:2] = (pair & np.uint32(15)).astype(np.uint8)
        out[:, m * q + 1:(m + 1) * q:2] = ((pair >> np.uint32(16)) & np.uint32(15)).astype(np.uint8)
    return out.reshape(k, n)


def kpair_unpack_np(wp: np.ndarray) -> np.ndarray:
    """Codes [K, N] of a JAX kpair byte array [K/2, N]: byte k' holds row 2k'
    in its low nibble and row 2k'+1 in its high one."""
    k2, n = wp.shape
    out = np.empty((k2 * 2, n), dtype=np.uint8)
    out[0::2] = wp & np.uint8(0xF)
    out[1::2] = wp >> np.uint8(4)
    return out


def k2i32_unpack_np(wp: np.ndarray, gs: int) -> np.ndarray:
    """Codes [K, N] of a JAX k2i32 word array [K/16, N]: within each block of
    ``gs`` rows, bits 2m..2m+1 of word j hold row m*gs/8 + 2j and bits
    16+2m..17+2m row m*gs/8 + 2j + 1."""
    k16, n = wp.shape
    k = k16 * 16
    w = wp.astype(np.uint32).reshape(k // gs, gs // 16, n)
    e = gs // 8
    out = np.empty((k // gs, gs, n), np.uint8)
    for m in range(8):
        pair = w >> np.uint32(2 * m)
        out[:, m * e + 0:(m + 1) * e:2] = (pair & np.uint32(3)).astype(np.uint8)
        out[:, m * e + 1:(m + 1) * e:2] = ((pair >> np.uint32(16)) & np.uint32(3)).astype(np.uint8)
    return out.reshape(k, n)


def kquad_unpack_np(wp: np.ndarray, gs: int) -> np.ndarray:
    """Codes [K, N] of a JAX kquad byte array [K/4, N]: within each block of
    ``gs`` rows, byte j holds rows 2j and 2j+1 of the first half in bits 0..3
    and rows 2j and 2j+1 of the second half in bits 4..7."""
    k4, n = wp.shape
    k = k4 * 4
    b4 = wp.reshape(k // gs, gs // 4, n)
    first = np.empty((k // gs, gs // 2, n), np.uint8)
    second = np.empty_like(first)
    first[:, 0::2] = b4 & np.uint8(3)
    first[:, 1::2] = (b4 >> np.uint8(2)) & np.uint8(3)
    second[:, 0::2] = (b4 >> np.uint8(4)) & np.uint8(3)
    second[:, 1::2] = b4 >> np.uint8(6)
    return np.concatenate([first, second], axis=1).reshape(k, n)


_PLANES = {2: 4, 3: 2, 4: 2, 8: 1}     # logical columns per planar byte


def plane_unpack_np(wp: np.ndarray, bits: int) -> np.ndarray:
    """Codes [K, N] of a JAX planar byte array [K, N / planes]: plane p of
    every byte holds column ``p * N / planes + c``."""
    sbits = STORAGE_BITS[bits]
    mask = np.uint8((1 << sbits) - 1)
    return np.concatenate([(wp >> np.uint8(sbits * p)) & mask for p in range(_PLANES[bits])],
                          axis=1)


def _codes(node) -> np.ndarray:
    """Integer codes [K_padded, N_padded] of a JAX runtime layout."""
    wp = np.asarray(node.wp)
    layout = node.layout
    gs = node.group_size
    if layout == "kb32":
        return ki32_unpack_np(wp, 1024)
    if layout == "kb32l":
        nbn = node.n_pad // wp.shape[2]
        nbk = wp.shape[0] // nbn
        words = wp.reshape(nbn, nbk * wp.shape[1], wp.shape[2]).transpose(1, 0, 2)
        return ki32_unpack_np(words.reshape(nbk * wp.shape[1], node.n_pad), 1024)
    if layout == "ki32":
        return ki32_unpack_np(wp, gs if gs != -1 else wp.shape[0] * 8)
    if layout == "kpair":
        return kpair_unpack_np(wp)
    if layout == "k2i32":
        return k2i32_unpack_np(wp, gs if gs != -1 else wp.shape[0] * 16)
    if layout == "kquad":
        return kquad_unpack_np(wp, gs if gs != -1 else wp.shape[0] * 4)
    if layout == "koct":
        return wp
    if layout == "planar":
        return plane_unpack_np(wp, node.bits)
    raise NotImplementedError(f"JAX runtime layout {layout!r} has no converter")


def _quant_linear(node, device, dtype) -> QuantLinear:
    k, n = node.in_features, node.out_features
    gs = node.group_size if node.group_size != -1 else k
    g = -(-k // gs)
    codes = _codes(node)[:k, :n]
    # scales/zeros are [G, planes, C] with column p * C + c in plane p
    scales = np.asarray(node.scales)
    scales = scales.reshape(scales.shape[0], -1)[:g, :n].astype(np.float16)
    zeros = np.asarray(node.zeros)
    zeros = zeros.reshape(zeros.shape[0], -1)[:g, :n].astype(np.uint8)
    kperm = None if node.kperm is None else np.asarray(node.kperm)[:k].astype(np.int64)
    weight = torch.from_numpy(packing.pack_qweight(codes, STORAGE_BITS[node.bits])).to(device)
    scales = torch.from_numpy(np.ascontiguousarray(scales)).to(device)
    zeros = torch.from_numpy(np.ascontiguousarray(zeros)).to(device)
    layout = "kb32l" if node.layout == "kb32l" else "gptq"
    if layout == "kb32l":
        weight, scales, zeros = kb32l_pack(weight, scales, zeros, k, node.group_size)
    bias = None if node.bias is None else torch.tensor(np.asarray(node.bias, np.float32)).to(device, dtype)
    return QuantLinear(
        qweight=weight,
        scales=scales,
        zeros=zeros,
        kperm=None if kperm is None else torch.from_numpy(kperm).to(device),
        bias=bias,
        bits=node.bits,
        group_size=node.group_size,
        in_features=k,
        out_features=n,
        layout=layout,
    )


def _stacked(node, device, dtype) -> StackedQuantLinear:
    """A JAX ``StackedQuantLinear``: each expert's words, scales and zeros
    through :func:`_quant_linear`, then stacked."""
    wp, scales, zeros = np.asarray(node.wp), np.asarray(node.scales), np.asarray(node.zeros)
    fields = dict(kperm=None, bias=None, layout=node.layout, group_size=node.group_size,
                  in_features=node.in_features, out_features=node.out_features, bits=node.bits)
    sql = stack_experts([
        _quant_linear(SimpleNamespace(wp=wp[e], scales=scales[e], zeros=zeros[e], **fields),
                      device, dtype)
        for e in range(wp.shape[0])])
    if node.bias is not None:
        sql.bias = torch.tensor(np.asarray(node.bias, np.float32)).to(device, dtype)
    return sql


def _adapter(a, device, trainable: bool = True) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device).requires_grad_(trainable)


def params_from_jax(tree, device="cuda", dtype: torch.dtype = torch.bfloat16):
    """The port's params for a JAX params tree (see the module docstring)."""
    if isinstance(tree, dict):
        return {key: params_from_jax(val, device, dtype) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(val, device, dtype) for val in tree]
    if hasattr(tree, "lora_e"):
        return peft.AdaLoraLinear(
            base=params_from_jax(tree.base, device, dtype), lora_a=_adapter(tree.lora_a, device),
            lora_e=_adapter(tree.lora_e, device), lora_b=_adapter(tree.lora_b, device),
            rank_mask=_adapter(tree.rank_mask, device, trainable=False),
            scaling=float(tree.scaling))
    if hasattr(tree, "lora_a"):
        return peft.LoraLinear(
            base=params_from_jax(tree.base, device, dtype), lora_a=_adapter(tree.lora_a, device),
            lora_b=_adapter(tree.lora_b, device), scaling=float(tree.scaling))
    if hasattr(tree, "prompt") and hasattr(tree, "gate"):
        return peft.AdaptionPrompt(prompt=_adapter(tree.prompt, device),
                                   gate=_adapter(tree.gate, device))
    if hasattr(tree, "num_experts") and hasattr(tree, "wp") and np.ndim(tree.wp) == 3:
        return _stacked(tree, device, dtype)
    if all(hasattr(tree, f) for f in _QUANT_FIELDS):
        return _quant_linear(tree, device, dtype)
    if hasattr(tree, "kernel"):
        bias = None if tree.bias is None else torch.tensor(np.asarray(tree.bias, np.float32))
        return DenseLinear(
            kernel=torch.tensor(np.asarray(tree.kernel, np.float32)).to(device, dtype),
            bias=None if bias is None else bias.to(device, dtype),
        )
    return torch.tensor(np.asarray(tree, np.float32)).to(device, dtype)


__all__ = ["params_from_jax", "ki32_unpack_np", "kpair_unpack_np", "k2i32_unpack_np",
           "kquad_unpack_np", "plane_unpack_np"]
