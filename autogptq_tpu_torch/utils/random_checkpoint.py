"""Write checkpoints of random weights, made from a NumPy seed: a GPTQ one
(``write_random_checkpoint``) and an unquantized fp16 one
(``write_random_fp_checkpoint``).

The port's counterpart of ``bench.py``'s random weights, written to
disk in the GPTQ checkpoint format so that both packages' ``from_quantized``
load it and nothing has to be downloaded:

* ``config.json`` (an HF llama or Mixtral config) and ``quantize_config.json``;
* one safetensors shard per decoder layer plus one for the embedding, final
  norm and head, listed in ``model.safetensors.index.json``;
* per quantized linear: random ``qweight`` words (every bit pattern is a
  valid code word), fp16 ``scales``, random zero points packed into
  ``qzeros``, and ``g_idx`` (a random permutation of the groups' rows when
  ``desc_act``);
* for Mixtral, every expert's ``w1`` / ``w2`` / ``w3`` quantized as above and
  the fp16 router ``block_sparse_moe.gate.weight`` ``[E, H]``.

Layer ``i`` draws from ``np.random.default_rng([seed, i + 1])`` and the
top-level tensors from ``[seed, 0]``, so a checkpoint cut to fewer layers has
the same weights as the first layers of the full one. Scales are about
``2 / (2^bits * sqrt(K))`` so that activations stay of order one through the
layers.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..ops import packing
from ..quantization import BaseQuantizeConfig

# Llama-2-7B (meta-llama/Llama-2-7b-hf config.json)
LLAMA2_7B = {
    "model_type": "llama",
    "architectures": ["LlamaForCausalLM"],
    "vocab_size": 32000,
    "hidden_size": 4096,
    "intermediate_size": 11008,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 32,
    "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "hidden_act": "silu",
    "tie_word_embeddings": False,
    "torch_dtype": "float16",
}

# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json)
MIXTRAL_8X7B = {
    "model_type": "mixtral",
    "architectures": ["MixtralForCausalLM"],
    "vocab_size": 32000,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "num_local_experts": 8,
    "num_experts_per_tok": 2,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-5,
    "rope_theta": 1e6,
    "sliding_window": None,
    "hidden_act": "silu",
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}


def linear_shapes(cfg: dict) -> dict[str, tuple[int, int]]:
    """HF block-relative linear name -> (in_features K, out_features N) of
    every quantized linear (Mixtral: the experts' ``w1``/``w2``/``w3`` in
    place of the MLP; its router is not quantized)."""
    h = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    kv = cfg.get("num_key_value_heads", heads) or heads
    d = cfg.get("head_dim") or h // heads
    inter = cfg["intermediate_size"]
    shapes = {
        "self_attn.q_proj": (h, heads * d),
        "self_attn.k_proj": (h, kv * d),
        "self_attn.v_proj": (h, kv * d),
        "self_attn.o_proj": (heads * d, h),
    }
    if cfg.get("model_type") == "mixtral":
        for e in range(cfg.get("num_local_experts", 8)):
            prefix = f"block_sparse_moe.experts.{e}"
            shapes.update({f"{prefix}.w1": (h, inter), f"{prefix}.w2": (inter, h),
                           f"{prefix}.w3": (h, inter)})
        return shapes
    shapes.update({"mlp.gate_proj": (h, inter), "mlp.up_proj": (h, inter),
                   "mlp.down_proj": (inter, h)})
    return shapes


def _router(config: dict, rng: np.random.Generator, prefix: str) -> dict:
    """Mixtral's fp16 router ``[E, H]``, ``N(0, 1 / H)`` (logits of order
    one); nothing for other families."""
    if config.get("model_type") != "mixtral":
        return {}
    h = config["hidden_size"]
    w = rng.standard_normal((config.get("num_local_experts", 8), h), np.float32) / np.sqrt(h)
    return {f"{prefix}.block_sparse_moe.gate.weight": w.astype(np.float16)}


def random_quant_tensors(rng: np.random.Generator, k: int, n: int, bits: int = 4,
                         group_size: int = 128, desc_act: bool = False) -> dict:
    """``qweight`` / ``qzeros`` / ``scales`` / ``g_idx`` of one random layer."""
    gs = group_size if group_size != -1 else k
    g = -(-k // gs)
    info = np.iinfo(np.int32)
    qweight = rng.integers(info.min, info.max, size=(k * bits // 32, n), dtype=np.int32,
                           endpoint=True)
    scales = (rng.uniform(0.5, 1.5, size=(g, n)) * (2.0 / (2 ** bits * np.sqrt(k))))
    zeros = rng.integers(1, 2 ** bits, size=(g, n))
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if desc_act:
        g_idx = rng.permutation(g_idx).astype(np.int32)
    return {
        "qweight": qweight,
        "qzeros": packing.pack_qzeros(zeros, bits),
        "scales": scales.astype(np.float16),
        "g_idx": g_idx,
    }


def _write_config(out_dir: str, config: dict, weight_map: dict) -> None:
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f, indent=1)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


def _top_tensors(config: dict, seed: int) -> dict:
    """Embedding, final norm and head, drawn from ``[seed, 0]``."""
    h, vocab = config["hidden_size"], config["vocab_size"]
    rng = np.random.default_rng([seed, 0])
    top = {
        "model.embed_tokens.weight": rng.standard_normal((vocab, h), np.float32).astype(np.float16),
        "model.norm.weight": (1.0 + 0.1 * rng.standard_normal(h, np.float32)).astype(np.float16),
    }
    if not config.get("tie_word_embeddings", False):
        top["lm_head.weight"] = (rng.standard_normal((vocab, h), np.float32)
                                 / np.sqrt(h)).astype(np.float16)
    return top


def write_random_fp_checkpoint(out_dir: str, config: dict, seed: int = 0) -> str:
    """Write an unquantized fp16 checkpoint of random weights into
    ``out_dir``: the input of ``from_pretrained`` / ``quantize``. One
    safetensors file per decoder layer (layer ``i`` drawn from
    ``[seed, i + 1]``) plus one for the embedding, final norm and head, so a
    cut to a few layers is cheap and has the full model's first layers.
    Linear weights are ``N(0, 1 / K)``, so activations stay of order one."""
    from safetensors.numpy import save_file

    os.makedirs(out_dir, exist_ok=True)
    layers = config["num_hidden_layers"]
    h = config["hidden_size"]
    n_files = layers + 1
    weight_map = {}

    def save(idx: int, tensors: dict) -> None:
        name = f"model-{idx + 1:05d}-of-{n_files:05d}.safetensors"
        save_file(tensors, os.path.join(out_dir, name))
        weight_map.update({key: name for key in tensors})

    save(layers, _top_tensors(config, seed))
    for i in range(layers):
        rng = np.random.default_rng([seed, i + 1])
        prefix = f"model.layers.{i}"
        tensors = {}
        for name, (k, n) in linear_shapes(config).items():
            w = rng.standard_normal((n, k), np.float32) / np.float32(np.sqrt(k))
            tensors[f"{prefix}.{name}.weight"] = w.astype(np.float16)
        tensors.update(_router(config, rng, prefix))
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{prefix}.{norm}.weight"] = (
                1.0 + 0.1 * rng.standard_normal(h, np.float32)).astype(np.float16)
        save(i, tensors)
    _write_config(out_dir, config, weight_map)
    return out_dir


def write_random_checkpoint(out_dir: str, config: dict, bits: int = 4, group_size: int = 128,
                            desc_act: bool = False, seed: int = 0) -> str:
    """Write the checkpoint into ``out_dir`` (created if missing); returns it."""
    from safetensors.numpy import save_file

    os.makedirs(out_dir, exist_ok=True)
    layers = config["num_hidden_layers"]
    h = config["hidden_size"]
    shapes = linear_shapes(config)
    n_files = layers + 1
    weight_map = {}

    def save(idx: int, tensors: dict) -> None:
        name = f"model-{idx + 1:05d}-of-{n_files:05d}.safetensors"
        save_file(tensors, os.path.join(out_dir, name))
        weight_map.update({key: name for key in tensors})

    save(layers, _top_tensors(config, seed))

    for i in range(layers):
        rng = np.random.default_rng([seed, i + 1])
        prefix = f"model.layers.{i}"
        tensors = {}
        for name, (k, n) in shapes.items():
            for key, val in random_quant_tensors(rng, k, n, bits, group_size, desc_act).items():
                tensors[f"{prefix}.{name}.{key}"] = val
        tensors.update(_router(config, rng, prefix))
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{prefix}.{norm}.weight"] = (
                1.0 + 0.1 * rng.standard_normal(h, np.float32)).astype(np.float16)
        save(i, tensors)

    _write_config(out_dir, config, weight_map)
    BaseQuantizeConfig(bits=bits, group_size=group_size, desc_act=desc_act,
                       sym=False).save_pretrained(out_dir)
    return out_dir


__all__ = ["LLAMA2_7B", "MIXTRAL_8X7B", "linear_shapes", "random_quant_tensors", "write_random_checkpoint",
           "write_random_fp_checkpoint"]
