"""AutoGPTQForCausalLM: dispatch on the checkpoint's ``model_type``."""

from __future__ import annotations

import os

from ..utils import hf_io
from .base import GPTQModel
from .registry import REGISTRY


class AutoGPTQForCausalLM:
    def __init__(self):
        raise EnvironmentError(
            "AutoGPTQForCausalLM is designed to be instantiated using "
            "`AutoGPTQForCausalLM.from_pretrained` or `AutoGPTQForCausalLM.from_quantized`."
        )

    @classmethod
    def check_and_get_model_type(cls, model_dir: str) -> str:
        model_type = hf_io.load_hf_config(model_dir)["model_type"]
        if model_type not in REGISTRY:
            raise TypeError(f"{model_type} isn't supported by the PyTorch port yet.")
        return model_type

    @classmethod
    def from_pretrained(cls, model_name_or_path: str, quantize_config=None,
                        **kwargs) -> GPTQModel:
        """Load a local unquantized HF checkpoint directory for
        :meth:`GPTQModel.quantize`; keyword arguments go to
        :meth:`GPTQModel.from_pretrained` (``device="cuda"`` by default)."""
        if not os.path.isdir(model_name_or_path):
            raise FileNotFoundError(f"{model_name_or_path!r} is not a local directory")
        cls.check_and_get_model_type(model_name_or_path)
        return GPTQModel.from_pretrained(model_name_or_path, quantize_config, **kwargs)

    @classmethod
    def from_quantized(cls, model_name_or_path: str, **kwargs) -> GPTQModel:
        """Load a local GPTQ checkpoint directory; keyword arguments go to
        :meth:`GPTQModel.from_quantized` (``device="cuda"`` by default)."""
        if not os.path.isdir(model_name_or_path):
            raise FileNotFoundError(f"{model_name_or_path!r} is not a local directory")
        cls.check_and_get_model_type(model_name_or_path)
        return GPTQModel.from_quantized(model_name_or_path, **kwargs)


__all__ = ["AutoGPTQForCausalLM"]
