"""Build the decoder's parameter dict from checkpoint tensors, and flatten it
back to a GPTQ checkpoint's tensor dict.

Counterpart of the JAX package's ``models/params.py`` for the llama spec:

* :func:`build_fp_params`: an unquantized HF checkpoint -> dense params
  (``from_pretrained``);
* :func:`build_quantized_params`: a GPTQ checkpoint -> q/k/v/o/gate/up/down
  as runtime ``QuantLinear``s (unfused), norms, embeddings and the head dense
  in the model dtype (``from_quantized``);
* :func:`flatten_quantized_params`: quantized params plus the packed layers of
  ``quantize`` -> the checkpoint's tensor dict (``save_quantized``);
* :func:`stack_moe_experts`: a Mixtral block's expert list -> stacked experts
  (``mlp.experts_stacked``), the layout of the routed decode path.

Mixtral's experts are the list ``mlp.experts[e].{gate,up,down}_proj`` (numeric
path components index lists) and its router the dense ``mlp.router``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..ops import quantlinear as qlin
from .arch import ArchConfig, DenseLinear
from .registry import FamilySpec


def get_in(tree, path: str) -> Any:
    """The node at a dotted path; numeric components index lists."""
    node = tree
    for key in path.split("."):
        node = node[key] if isinstance(node, dict) else node[int(key)]
    return node


def set_in_block(block: dict, path: str, value) -> None:
    """Set a dotted path inside a params or block dict, creating intermediate dicts;
    numeric components index lists, grown as needed."""
    keys = path.split(".")
    node = block
    for i, key in enumerate(keys[:-1]):
        nxt = keys[i + 1]
        if isinstance(node, list):
            idx = int(key)
            while len(node) <= idx:
                node.append({})
            if nxt.isdigit() and not isinstance(node[idx], list):
                node[idx] = node[idx] or []
            node = node[idx]
        else:
            if key not in node:
                node[key] = [] if nxt.isdigit() else {}
            node = node[key]
    last = keys[-1]
    if isinstance(node, list):
        while len(node) <= int(last):
            node.append(None)
        node[int(last)] = value
    else:
        node[last] = value


def _dense(w: torch.Tensor, b, device, dtype) -> DenseLinear:
    """HF Linear weight [N, K] -> DenseLinear kernel [K, N] on ``device``."""
    kernel = w.to(device=device, dtype=dtype).t().contiguous()
    return DenseLinear(kernel=kernel, bias=None if b is None else b.to(device=device, dtype=dtype))


def _dense_named(tensors, base: str, device, dtype) -> DenseLinear:
    name = f"{base}.weight"
    if name not in tensors:
        raise KeyError(f"missing tensor {name}")
    bias = tensors.get(f"{base}.bias")
    return _dense(torch.as_tensor(tensors[name]),
                  None if bias is None else torch.as_tensor(bias), device, dtype)


def _top_level(tensors, spec: FamilySpec, device, dtype) -> dict:
    """Embedding, final norm and a dense head."""
    params: dict = {"layers": []}
    for our, hf in spec.top_tensors.items():
        if hf in tensors:
            set_in_block(params, our, torch.as_tensor(tensors[hf]).to(device=device, dtype=dtype))
    if spec.lm_head is not None and f"{spec.lm_head}.weight" in tensors:
        params["lm_head"] = _dense_named(tensors, spec.lm_head, device, dtype)
    return params


def _norms(tensors, spec: FamilySpec, prefix: str, block: dict, device, dtype) -> None:
    for our, hf in spec.block_norms.items():
        weight = torch.as_tensor(tensors[f"{prefix}.{hf}.weight"])
        set_in_block(block, our, {"weight": weight.to(device=device, dtype=dtype)})


def build_fp_params(tensors, spec: FamilySpec, cfg: ArchConfig,
                    dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """Dense (unquantized) params from an HF checkpoint's tensors (a mapping
    of names to CPU tensors or arrays)."""
    params = _top_level(tensors, spec, device, dtype)
    for i in range(cfg.num_layers):
        prefix = f"{spec.layers_prefix}.{i}"
        block: dict = {}
        for our, hf in spec.block_linears.items():
            set_in_block(block, our, _dense_named(tensors, f"{prefix}.{hf}", device, dtype))
        _norms(tensors, spec, prefix, block, device, dtype)
        params["layers"].append(block)
    return params


def build_quantized_params(tensors, spec: FamilySpec, cfg: ArchConfig, bits: int,
                           group_size: int, dtype: torch.dtype = torch.bfloat16,
                           device="cuda", layout: Optional[str] = None) -> dict:
    """``tensors`` maps checkpoint names to CPU tensors or arrays; ``layout``
    is every quantized linear's runtime layout (``quantlinear.from_packed``)."""
    quant_paths = {p for sub in spec.quant_layers for p in sub}
    if spec.lm_head is not None and f"{spec.lm_head}.qweight" in tensors:
        raise NotImplementedError("a quantized lm_head is not ported yet (ROADMAP Queue 1, "
                                  "'The rest of quantization, and checkpoint I/O')")
    params = _top_level(tensors, spec, device, dtype)

    for i in range(cfg.num_layers):
        prefix = f"{spec.layers_prefix}.{i}"
        block: dict = {}
        for our, hf in spec.block_linears.items():
            base = f"{prefix}.{hf}"
            if our in quant_paths and f"{base}.qweight" in tensors:
                qweight = np.asarray(tensors[f"{base}.qweight"])
                k = qweight.shape[0] * 32 // bits
                gs = group_size if group_size != -1 else k
                g_idx = tensors.get(f"{base}.g_idx")
                packed = qlin.PackedQuantLinear(
                    qweight=qweight,
                    qzeros=np.asarray(tensors[f"{base}.qzeros"]),
                    scales=np.asarray(tensors[f"{base}.scales"]),
                    g_idx=(np.arange(k) // gs).astype(np.int32) if g_idx is None
                    else np.asarray(g_idx),
                    bias=tensors.get(f"{base}.bias"),
                    bits=bits,
                    group_size=group_size,
                    in_features=k,
                    out_features=qweight.shape[1],
                )
                set_in_block(block, our, qlin.from_packed(packed, device=device, dtype=dtype,
                                                          layout=layout))
            else:
                set_in_block(block, our, _dense_named(tensors, base, device, dtype))
        _norms(tensors, spec, prefix, block, device, dtype)
        params["layers"].append(block)
    return params


def flatten_quantized_params(params: dict, packed_layers: dict, spec: FamilySpec,
                             cfg: ArchConfig, save_dtype=np.float16) -> dict[str, np.ndarray]:
    """Tensor dict for ``save_quantized``. ``packed_layers`` maps
    ``"{layer_idx}.{our_path}"`` to the layer's ``PackedQuantLinear``; every
    other linear, the norms, the embedding and the head are written dense in
    ``save_dtype``."""
    out: dict[str, np.ndarray] = {}

    def as_np(t: torch.Tensor) -> np.ndarray:
        return t.detach().to(device="cpu", dtype=torch.float32).numpy().astype(save_dtype)

    def put_dense(base: str, node: DenseLinear) -> None:
        out[f"{base}.weight"] = np.ascontiguousarray(as_np(node.kernel).T)
        if node.bias is not None:
            out[f"{base}.bias"] = as_np(node.bias)

    for our, hf in spec.top_tensors.items():
        try:
            val = get_in(params, our)
        except (KeyError, TypeError):
            continue
        out[hf] = as_np(val)
    if "lm_head" in params and spec.lm_head is not None:
        put_dense(spec.lm_head, params["lm_head"])

    for i, block in enumerate(params["layers"]):
        prefix = f"{spec.layers_prefix}.{i}"
        for our, hf in spec.block_linears.items():
            base = f"{prefix}.{hf}"
            packed = packed_layers.get(f"{i}.{our}")
            if packed is None:
                put_dense(base, get_in(block, our))
                continue
            out[f"{base}.qweight"] = np.asarray(packed.qweight).astype(np.int32)
            out[f"{base}.qzeros"] = np.asarray(packed.qzeros).astype(np.int32)
            out[f"{base}.scales"] = np.asarray(packed.scales).astype(np.float16)
            out[f"{base}.g_idx"] = np.asarray(packed.g_idx).astype(np.int32)
            if packed.bias is not None:
                out[f"{base}.bias"] = np.asarray(packed.bias).astype(save_dtype)
        for our, hf in spec.block_norms.items():
            out[f"{prefix}.{hf}.weight"] = as_np(get_in(block, our)["weight"])
    return out


EXPERT_PROJS = ("gate_proj", "up_proj", "down_proj")


def stack_moe_experts(params: dict) -> dict:
    """Params in which every block's list of quantized experts becomes
    ``mlp.experts_stacked`` (one :class:`~autogptq_tpu_torch.ops.quantlinear.StackedQuantLinear`
    per projection), the JAX ``stack_moe_experts``. Experts with desc_act
    raise ValueError. Layers are stacked one at a time and each layer's list
    is popped from the input's MLP dict at once, so the device holds about one
    copy of the experts, not two: the input params are consumed, and the
    returned ones are to be used."""
    out = dict(params)
    layers = []
    for block in params["layers"]:
        mlp = block.get("mlp")
        experts = mlp.get("experts") if isinstance(mlp, dict) else None
        if experts and all(isinstance(ex.get(p), qlin.QuantLinear)
                           for ex in experts for p in EXPERT_PROJS):
            stacked = {p: qlin.stack_experts([ex[p] for ex in experts]) for p in EXPERT_PROJS}
            del mlp["experts"], experts
            block = dict(block, mlp=dict(mlp, experts_stacked=stacked))
        layers.append(block)
    out["layers"] = layers
    return out


__all__ = ["build_fp_params", "build_quantized_params", "flatten_quantized_params",
           "get_in", "set_in_block", "stack_moe_experts"]
