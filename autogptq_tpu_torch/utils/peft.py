"""LoRA, AdaLoRA and adaption-prompt adapters on a quantized model, in PyTorch.

Counterpart of the JAX package's ``utils/peft.py``. Adapters are nodes of the
params tree: :class:`LoraLinear` and :class:`AdaLoraLinear` wrap a frozen
linear (``QuantLinear`` or ``DenseLinear``), and :class:`AdaptionPrompt` sits
beside the projections of an attention block (``attn.adaption``).
``models/arch.py`` dispatches on them by duck typing. Their tensors are f32
leaves with ``requires_grad=True``; the quantized base gets no gradient (its
matmul is ``quantlinear.QuantMatmul``, whose backward is K10 on the card), so
``loss.backward()`` reaches the adapters only and any ``torch.optim``
optimizer takes :func:`trainable_tensors`.

The loss and the optimizer step live with the caller, as in the JAX package:
a causal-LM loss over ``arch.forward`` (which runs under autograd) and, for
example, ``torch.optim.AdamW``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from ..models import params as params_lib
from ..models.arch import DenseLinear, apply_linear
from ..ops.quantlinear import QuantLinear


@dataclass
class LoraLinear:
    """A frozen base linear plus a trainable low-rank adapter:
    ``y = base(x) + (x @ A @ B) * scaling``."""

    base: Any                      # QuantLinear or DenseLinear
    lora_a: torch.Tensor           # [K, r]
    lora_b: torch.Tensor           # [r, N]
    scaling: float = 1.0


@dataclass
class AdaLoraLinear:
    """SVD-parameterized adapter (AdaLoRA): ``delta = B diag(E * mask) A``;
    ``rank_mask`` is not trained, :func:`adalora_prune` sets it."""

    base: Any
    lora_a: torch.Tensor           # [K, r]
    lora_e: torch.Tensor           # [r] singular values
    lora_b: torch.Tensor           # [r, N]
    rank_mask: torch.Tensor        # [r] 0/1 gate
    scaling: float = 1.0


@dataclass
class AdaptionPrompt:
    """LLaMA-Adapter adaption prompt of one attention block: the ``prompt``
    rows go through the block's frozen k/v projections; the zero-initialized
    ``gate`` makes injection an exact identity at step 0."""

    prompt: torch.Tensor           # [adapter_len, hidden]
    gate: torch.Tensor             # scalar


@dataclasses.dataclass
class GPTQLoraConfig:
    r: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.0
    target_modules: Sequence[str] = ("attn.q_proj", "attn.v_proj")
    # AdaLoRA: start at init_r; pruning masks ranks (adalora_prune)
    adalora: bool = False
    init_r: Optional[int] = None

    @property
    def scaling(self) -> float:
        return self.lora_alpha / self.r


@dataclasses.dataclass
class AdaptionPromptConfig:
    adapter_len: int = 10
    adapter_layers: int = 30       # the top adapter_layers blocks get prompts


_LINEARS = (QuantLinear, DenseLinear, LoraLinear, AdaLoraLinear)


def _copy_tree(node):
    """Structural copy of dicts and lists; linear nodes and tensors are shared."""
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_tree(v) for v in node]
    return node


def _in_out(node) -> tuple[int, int, torch.device]:
    while isinstance(node, (LoraLinear, AdaLoraLinear)):
        node = node.base
    if isinstance(node, QuantLinear):
        return node.in_features, node.out_features, node.qweight.device
    return node.kernel.shape[0], node.kernel.shape[1], node.kernel.device


def _trainable(t: torch.Tensor) -> torch.Tensor:
    return t.float().requires_grad_(True)


def inject_lora(params: dict, peft_cfg: GPTQLoraConfig, seed: int = 0) -> dict:
    """Params with :class:`LoraLinear` nodes around every target module (the
    caller's tree is not changed). A ~ N(0, 1/K), B = 0, so the adapter
    starts as the identity. Already wrapped modules are skipped."""
    gen = torch.Generator().manual_seed(seed)
    r = peft_cfg.init_r or peft_cfg.r
    out = dict(params)
    out["layers"] = []
    for block in params["layers"]:
        block = _copy_tree(block)
        for path in peft_cfg.target_modules:
            try:
                node = params_lib.get_in(block, path)
            except (KeyError, TypeError, IndexError):
                continue
            if isinstance(node, (LoraLinear, AdaLoraLinear)):
                continue
            k, n, dev = _in_out(node)
            a = torch.randn((k, r), generator=gen) / np.sqrt(k)
            params_lib.set_in_block(block, path, LoraLinear(
                base=node, lora_a=_trainable(a.to(dev)),
                lora_b=_trainable(torch.zeros((r, n), device=dev)),
                scaling=peft_cfg.scaling))
        out["layers"].append(block)
    return out


def inject_adalora(params: dict, peft_cfg: GPTQLoraConfig, seed: int = 0) -> dict:
    """Params with :class:`AdaLoraLinear` nodes around every target module
    (A, B ~ N(0, 0.02^2), E = 0: identity at init; rank mask all ones)."""
    gen = torch.Generator().manual_seed(seed)
    r = peft_cfg.init_r or peft_cfg.r
    out = dict(params)
    out["layers"] = []
    for block in params["layers"]:
        block = _copy_tree(block)
        for path in peft_cfg.target_modules:
            try:
                node = params_lib.get_in(block, path)
            except (KeyError, TypeError, IndexError):
                continue
            if isinstance(node, (LoraLinear, AdaLoraLinear)):
                continue    # already wrapped: injection is idempotent
            k, n, dev = _in_out(node)
            a = torch.randn((k, r), generator=gen) * 0.02
            b = torch.randn((r, n), generator=gen) * 0.02
            params_lib.set_in_block(block, path, AdaLoraLinear(
                base=node, lora_a=_trainable(a.to(dev)),
                lora_e=_trainable(torch.zeros(r, device=dev)), lora_b=_trainable(b.to(dev)),
                rank_mask=torch.ones(r, device=dev), scaling=peft_cfg.scaling))
        out["layers"].append(block)
    return out


def inject_adaption_prompt(params: dict, pcfg: AdaptionPromptConfig, seed: int = 0) -> dict:
    """Params with an :class:`AdaptionPrompt` in the top ``adapter_layers``
    attention blocks (prompt ~ N(0, 0.02^2), gate 0)."""
    gen = torch.Generator().manual_seed(seed)
    first = max(0, len(params["layers"]) - pcfg.adapter_layers)
    out = dict(params)
    out["layers"] = []
    for i, block in enumerate(params["layers"]):
        block = dict(block)
        if i >= first and "attn" in block:
            hidden, _, dev = _in_out(block["attn"]["q_proj"])
            prompt = torch.randn((pcfg.adapter_len, hidden), generator=gen) * 0.02
            block["attn"] = dict(block["attn"], adaption=AdaptionPrompt(
                prompt=_trainable(prompt.to(dev)), gate=_trainable(torch.zeros((), device=dev))))
        out["layers"].append(block)
    return out


def apply_lora(p: LoraLinear, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               dropout_rate: float = 0.0) -> torch.Tensor:
    """``base(x) + (dropout(x) @ A @ B) * scaling``, the adapter in f32;
    dropout only with an explicit ``generator`` (on ``x``'s device)."""
    y = apply_linear(p.base, x)
    xa = x
    if generator is not None and dropout_rate > 0.0:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout_rate
        xa = torch.where(keep, x / (1.0 - dropout_rate), torch.zeros_like(x))
    delta = (xa.float() @ p.lora_a.float()) @ p.lora_b.float()
    return y + (delta * p.scaling).to(y.dtype)


def apply_adalora(p: AdaLoraLinear, x: torch.Tensor) -> torch.Tensor:
    y = apply_linear(p.base, x)
    e = (p.lora_e * p.rank_mask).float()
    delta = ((x.float() @ p.lora_a.float()) * e) @ p.lora_b.float()
    return y + (delta * p.scaling).to(y.dtype)


def find_all_linear_names(params: dict) -> list[str]:
    """Block-relative paths of every linear of the first block."""
    names: set[str] = set()

    def walk(node, prefix):
        if isinstance(node, _LINEARS):
            names.add(prefix)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")

    for block in params["layers"][:1]:
        walk(block, "")
    return sorted(names)


def split_lora_params(params: dict) -> tuple[dict, dict]:
    """(trainable tree, params): the trainable tree has the blocks' topology
    with only adapter leaves (``lora_a``/``lora_b``, ``lora_e``, ``prompt``/
    ``gate``; None where a block has none). Its leaves are the model's own
    tensors, so an optimizer over them trains the model in place."""

    def extract(node):
        if isinstance(node, AdaLoraLinear):
            return {"lora_a": node.lora_a, "lora_e": node.lora_e, "lora_b": node.lora_b}
        if isinstance(node, LoraLinear):
            return {"lora_a": node.lora_a, "lora_b": node.lora_b}
        if isinstance(node, AdaptionPrompt):
            return {"prompt": node.prompt, "gate": node.gate}
        if isinstance(node, dict):
            sub = {k: extract(v) for k, v in node.items()}
            return {k: v for k, v in sub.items() if v} or None
        if isinstance(node, list):
            return [extract(v) for v in node]
        return None

    return {"layers": [extract(b) for b in params["layers"]]}, params


def trainable_tensors(tree) -> list[torch.Tensor]:
    """The leaves of a trainable tree, in a fixed order (sorted keys)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in trainable_tensors(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in trainable_tensors(v)]
    return [] if tree is None else [tree]


def merge_lora_params(params: dict, trainable: dict) -> dict:
    """Params with the adapter leaves of ``trainable`` written back in."""

    def merge(node, t):
        if t is None:
            return node
        if isinstance(node, AdaLoraLinear):
            return dataclasses.replace(node, lora_a=t["lora_a"], lora_e=t["lora_e"],
                                       lora_b=t["lora_b"])
        if isinstance(node, LoraLinear):
            return dataclasses.replace(node, lora_a=t["lora_a"], lora_b=t["lora_b"])
        if isinstance(node, AdaptionPrompt):
            return AdaptionPrompt(prompt=t["prompt"], gate=t["gate"])
        if isinstance(node, dict):
            return {k: merge(v, t.get(k)) for k, v in node.items()}
        if isinstance(node, list):
            return [merge(v, tv) for v, tv in zip(node, t)]
        return node

    out = dict(params)
    out["layers"] = [merge(b, t) for b, t in zip(params["layers"], trainable["layers"])]
    return out


def adalora_importance(p: AdaLoraLinear) -> torch.Tensor:
    """Per-rank importance ``|E| * ||A[:, i]|| * ||B[i, :]||``."""
    with torch.no_grad():
        return p.lora_e.abs() * p.lora_a.norm(dim=0) * p.lora_b.norm(dim=1)


def adalora_prune(p: AdaLoraLinear, target_rank: int) -> AdaLoraLinear:
    """Keep the ``target_rank`` most important ranks (mask the rest)."""
    imp = adalora_importance(p)
    thresh = torch.sort(imp).values[-target_rank] if target_rank > 0 else float("inf")
    return dataclasses.replace(p, rank_mask=(imp >= thresh).to(p.rank_mask.dtype))


def get_gptq_peft_model(model, peft_cfg: Union[GPTQLoraConfig, AdaptionPromptConfig, None] = None,
                        seed: int = 0):
    """Add adapters to a (quantized) ``GPTQModel`` in place and return it:
    LoRA, AdaLoRA (``peft_cfg.adalora``) or, for an
    :class:`AdaptionPromptConfig`, adaption prompts."""
    peft_cfg = peft_cfg or GPTQLoraConfig()
    if isinstance(peft_cfg, AdaptionPromptConfig):
        inject = inject_adaption_prompt
    else:
        inject = inject_adalora if peft_cfg.adalora else inject_lora
    model.params = inject(model.params, peft_cfg, seed)
    model.peft_config = peft_cfg
    return model


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def save_adapter(model, save_dir: str, spec=None) -> None:
    """Write the LoRA / AdaLoRA weights to ``save_dir/adapter_model.safetensors``
    under HF-peft names: ``lora_A`` [r, K], ``lora_B`` [N, r] and, for
    AdaLoRA, ``lora_E`` [r, 1] with the rank mask folded in."""
    from . import hf_io

    spec = spec or model.spec
    tensors: dict[str, np.ndarray] = {}
    for li, block in enumerate(model.params["layers"]):
        for path, hf in spec.block_linears.items():
            try:
                node = params_lib.get_in(block, path)
            except (KeyError, TypeError, IndexError):
                continue
            if not isinstance(node, (LoraLinear, AdaLoraLinear)):
                continue
            base = f"base_model.model.{spec.layers_prefix}.{li}.{hf}"
            tensors[f"{base}.lora_A.weight"] = _np(node.lora_a).T
            tensors[f"{base}.lora_B.weight"] = _np(node.lora_b).T
            if isinstance(node, AdaLoraLinear):
                tensors[f"{base}.lora_E.weight"] = (_np(node.lora_e) * _np(node.rank_mask))[:, None]
    if not tensors:
        raise ValueError(
            "no LoRA/AdaLoRA adapter weights found in the model — adaption-prompt adapters have "
            "no HF-peft file format and must be saved separately")
    os.makedirs(save_dir, exist_ok=True)
    hf_io.save_safetensors(tensors, os.path.join(save_dir, "adapter_model.safetensors"))


__all__ = [
    "AdaLoraLinear",
    "AdaptionPrompt",
    "AdaptionPromptConfig",
    "GPTQLoraConfig",
    "LoraLinear",
    "adalora_importance",
    "adalora_prune",
    "apply_adalora",
    "apply_lora",
    "find_all_linear_names",
    "get_gptq_peft_model",
    "inject_adalora",
    "inject_adaption_prompt",
    "inject_lora",
    "merge_lora_params",
    "save_adapter",
    "split_lora_params",
    "trainable_tensors",
]
