"""GPTQModel: load a GPTQ checkpoint and generate, on the card by default.

Counterpart of the JAX package's ``models/base.py`` for inference:
``from_quantized`` (llama, 4-bit on the card, ``gptq`` checkpoint format) and
``generate`` (greedy, temperature sampling, or beam search).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..quantization import BaseQuantizeConfig
from ..utils import hf_io
from . import params as params_lib
from .arch import ArchConfig
from .registry import FamilySpec, get_family


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; asking for CUDA without a card raises instead
    of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} was requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain PyTorch path")
    return dev


class GPTQModel:
    """A causal LM whose linear layers are GPTQ-quantized."""

    def __init__(self, params: dict, cfg: ArchConfig, spec: FamilySpec,
                 quantize_config: BaseQuantizeConfig, device: torch.device,
                 dtype: torch.dtype):
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.quantize_config = quantize_config
        self.device = device
        self.dtype = dtype

    @classmethod
    def from_quantized(cls, model_dir: str, device="cuda",
                       dtype: torch.dtype = torch.bfloat16) -> "GPTQModel":
        """Load a local GPTQ checkpoint directory (``config.json``,
        ``quantize_config.json``, safetensors) onto ``device``."""
        dev = resolve_device(device)
        hf_cfg = hf_io.load_hf_config(model_dir)
        spec = get_family(hf_cfg["model_type"])
        cfg = spec.arch_fn(hf_cfg)
        qc = BaseQuantizeConfig.from_pretrained(model_dir)
        if qc.checkpoint_format != "gptq":
            raise NotImplementedError(f"checkpoint format {qc.checkpoint_format!r} is not "
                                      "ported yet; only 'gptq' checkpoints load")
        qc.model_name_or_path = model_dir
        tensors = hf_io.open_tensors(model_dir, qc.model_file_base_name)
        params = params_lib.build_quantized_params(
            tensors, spec, cfg, qc.bits, qc.group_size, dtype=dtype, device=dev)
        return cls(params, cfg, spec, qc, dev, dtype)

    def generate(self, input_ids, max_new_tokens: int = 128, temperature: float = 0.0,
                 num_beams: int = 1, eos_token_id: Optional[int] = None,
                 min_new_tokens: int = 0, seed: int = 0, pad_token_id: int = 0,
                 kv_quant: bool = False, length_penalty: float = 1.0,
                 early_stopping=False, num_return_sequences: int = 1,
                 phased: bool = True) -> np.ndarray:
        """Returns ``[B * num_return_sequences, T_in + max_new_tokens]`` token
        ids (see :func:`autogptq_tpu_torch.utils.generation.generate`)."""
        from ..utils import generation

        return generation.generate(
            self, input_ids, max_new_tokens=max_new_tokens, temperature=temperature,
            num_beams=num_beams, eos_token_id=eos_token_id, min_new_tokens=min_new_tokens,
            seed=seed, pad_token_id=pad_token_id, kv_quant=kv_quant,
            length_penalty=length_penalty, early_stopping=early_stopping,
            num_return_sequences=num_return_sequences, phased=phased,
        )


__all__ = ["GPTQModel", "resolve_device"]
