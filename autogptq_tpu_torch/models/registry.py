"""Model-family registry: the llama and Mixtral ``FamilySpec``s of the JAX
package's ``models/registry.py`` (the families ported so far).

A spec binds the HF config and tensor names to the decoder in ``arch.py``:
the config translation, the block's linear and norm names, the top-level
tensors and the quantization order (``quant_layers``). A family whose names
depend on the config (Mixtral's expert count) registers a function of the HF
config that returns its spec.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .arch import ArchConfig


@dataclass(frozen=True)
class FamilySpec:
    model_type: str
    arch_fn: Callable[[dict], ArchConfig]
    layers_prefix: str
    block_linears: dict[str, str]
    block_norms: dict[str, str]
    top_tensors: dict[str, str]
    lm_head: str | None
    quant_layers: list[list[str]] = field(default_factory=list)


REGISTRY: dict[str, FamilySpec | Callable[[dict], FamilySpec]] = {}


def register(spec: FamilySpec) -> FamilySpec:
    REGISTRY[spec.model_type] = spec
    return spec


def get_family(model_type: str, hf_config: dict | None = None) -> FamilySpec:
    """The spec of ``model_type``; a config-dependent family is built from
    ``hf_config``."""
    if model_type not in REGISTRY:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported to PyTorch yet (ROADMAP Queue 1, "
            f"'Other families'). Ported: {sorted(REGISTRY)}")
    entry = REGISTRY[model_type]
    if isinstance(entry, FamilySpec):
        return entry
    return entry(hf_config or {})


def _llama_arch(c: dict, **moe) -> ArchConfig:
    """HF llama config -> ArchConfig. Settings the port's llama path does not
    implement raise instead of being ignored."""
    unsupported = {
        "rope_scaling": c.get("rope_scaling"),
        "sliding_window": c.get("sliding_window"),
        "num_key_value_heads_per_layer": c.get("num_key_value_heads_per_layer"),
    }
    for key, val in unsupported.items():
        if val is not None:
            raise NotImplementedError(f"llama config sets {key}={val!r}, which the PyTorch "
                                      "port does not implement yet")
    if c.get("hidden_act", "silu") != "silu":
        raise NotImplementedError(f"llama hidden_act={c['hidden_act']!r} is not implemented")
    heads = c["num_attention_heads"]
    kv = c.get("num_key_value_heads", heads) or heads
    return ArchConfig(
        model_type=c.get("model_type", "llama"),
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        intermediate_size=c["intermediate_size"],
        norm_eps=c.get("rms_norm_eps", 1e-6),
        rope_theta=c.get("rope_theta", 10000.0),
        tie_word_embeddings=c.get("tie_word_embeddings", False),
        **moe,
    )


_LLAMA_BLOCK_LINEARS = {
    "attn.q_proj": "self_attn.q_proj",
    "attn.k_proj": "self_attn.k_proj",
    "attn.v_proj": "self_attn.v_proj",
    "attn.o_proj": "self_attn.o_proj",
    "mlp.gate_proj": "mlp.gate_proj",
    "mlp.up_proj": "mlp.up_proj",
    "mlp.down_proj": "mlp.down_proj",
}
_LLAMA_BLOCK_NORMS = {
    "input_norm": "input_layernorm",
    "post_norm": "post_attention_layernorm",
}
_LLAMA_TOP = {
    "embed_tokens": "model.embed_tokens.weight",
    "final_norm.weight": "model.norm.weight",
}
_LLAMA_QUANT = [
    ["attn.k_proj", "attn.v_proj", "attn.q_proj"],
    ["attn.o_proj"],
    ["mlp.up_proj", "mlp.gate_proj"],
    ["mlp.down_proj"],
]

register(
    FamilySpec(
        model_type="llama",
        arch_fn=_llama_arch,
        layers_prefix="model.layers",
        block_linears=_LLAMA_BLOCK_LINEARS,
        block_norms=_LLAMA_BLOCK_NORMS,
        top_tensors=_LLAMA_TOP,
        lm_head="lm_head",
        quant_layers=_LLAMA_QUANT,
    )
)


# Mixtral (MoE): the llama block with a routed MLP of num_local_experts experts


def _mixtral_arch(c: dict) -> ArchConfig:
    return _llama_arch(c, moe_num_experts=c.get("num_local_experts", 8),
                       moe_top_k=c.get("num_experts_per_tok", 2))


def _mixtral_block_linears(num_experts: int) -> dict[str, str]:
    d = {our: hf for our, hf in _LLAMA_BLOCK_LINEARS.items() if our.startswith("attn.")}
    d["mlp.router"] = "block_sparse_moe.gate"          # dense, never quantized
    for e in range(num_experts):
        d[f"mlp.experts.{e}.gate_proj"] = f"block_sparse_moe.experts.{e}.w1"
        d[f"mlp.experts.{e}.down_proj"] = f"block_sparse_moe.experts.{e}.w2"
        d[f"mlp.experts.{e}.up_proj"] = f"block_sparse_moe.experts.{e}.w3"
    return d


def _mixtral_quant(num_experts: int) -> list[list[str]]:
    return [
        ["attn.k_proj", "attn.v_proj", "attn.q_proj"],
        ["attn.o_proj"],
        [f"mlp.experts.{e}.{p}" for e in range(num_experts) for p in ("gate_proj", "up_proj")],
        [f"mlp.experts.{e}.down_proj" for e in range(num_experts)],
    ]


def _mixtral_family(c: dict) -> FamilySpec:
    """The expert name lists follow ``num_local_experts``."""
    n = c.get("num_local_experts", 8)
    return FamilySpec(
        model_type="mixtral",
        arch_fn=_mixtral_arch,
        layers_prefix="model.layers",
        block_linears=_mixtral_block_linears(n),
        block_norms=_LLAMA_BLOCK_NORMS,
        top_tensors=_LLAMA_TOP,
        lm_head="lm_head",
        quant_layers=_mixtral_quant(n),
    )


REGISTRY["mixtral"] = _mixtral_family

__all__ = ["FamilySpec", "REGISTRY", "get_family", "register"]
