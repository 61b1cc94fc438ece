"""Quantization configuration with the GPTQ ``quantize_config.json`` schema.

The port's own copy of the JAX package's ``quantization/config.py``: the same
fields, the compat synonyms (``w_bit`` -> ``bits``, ``q_group_size`` ->
``group_size``), nested HF ``config.json::quantization_config`` discovery and
``is_marlin_format`` / ``version: gemm`` format inference. Paths are local
directories; nothing here touches the network.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field, fields
from typing import Optional

logger = logging.getLogger(__name__)

QUANT_CONFIG_FILENAME = "quantize_config.json"
CHECKPOINT_FORMAT_FIELD = "checkpoint_format"
CHECKPOINT_FORMAT_FIELD_COMPAT_MARLIN = "is_marlin_format"
QUANT_METHOD_FIELD = "quant_method"


class CHECKPOINT_FORMAT:
    GPTQ = "gptq"
    MARLIN = "marlin"
    AWQ_GEMM = "gemm"


class QUANT_METHOD:
    GPTQ = "gptq"
    AWQ = "awq"


QUANT_METHOD_FORMAT_MAPPING = {
    QUANT_METHOD.GPTQ: {CHECKPOINT_FORMAT.GPTQ, CHECKPOINT_FORMAT.MARLIN},
    QUANT_METHOD.AWQ: {CHECKPOINT_FORMAT.AWQ_GEMM},
}

_ARG_SYNONYMS = {"w_bit": "bits", "q_group_size": "group_size"}


@dataclass
class BaseQuantizeConfig:
    bits: int = field(default=4, metadata={"choices": [2, 3, 4, 8]})
    group_size: int = -1
    damp_percent: float = 0.01
    desc_act: bool = True
    static_groups: bool = False
    sym: bool = True
    true_sequential: bool = True
    quant_method: str = QUANT_METHOD.GPTQ
    checkpoint_format: str = CHECKPOINT_FORMAT.GPTQ
    model_name_or_path: Optional[str] = None
    model_file_base_name: Optional[str] = None
    # MSE grid search of the group ranges: an extension that the checkpoint
    # schema lacks, so to_dict leaves it out.
    mse: bool = False
    lm_head: bool = False

    def __post_init__(self):
        valid_formats = QUANT_METHOD_FORMAT_MAPPING.get(self.quant_method)
        if valid_formats is None:
            raise ValueError(f"Unsupported quantization method: {self.quant_method}")
        if self.checkpoint_format not in valid_formats:
            raise ValueError(
                f"checkpoint format {self.checkpoint_format!r} is not valid for "
                f"quantization method {self.quant_method!r}."
            )
        if self.bits not in (2, 3, 4, 8):
            raise ValueError("only support quantize to [2, 3, 4, 8] bits.")
        if self.group_size != -1 and self.group_size <= 0:
            raise ValueError("unless equal to -1, group_size must greater than 0.")
        if not (0 < self.damp_percent < 1):
            raise ValueError("damp_percent must be between 0 and 1.")

    def to_dict(self) -> dict:
        return {
            "bits": self.bits,
            "group_size": self.group_size,
            "damp_percent": self.damp_percent,
            "desc_act": self.desc_act,
            "static_groups": self.static_groups,
            "sym": self.sym,
            "true_sequential": self.true_sequential,
            "lm_head": self.lm_head,
            "model_name_or_path": self.model_name_or_path,
            "model_file_base_name": self.model_file_base_name,
            QUANT_METHOD_FIELD: self.quant_method,
            CHECKPOINT_FORMAT_FIELD: self.checkpoint_format,
        }

    def save_pretrained(self, save_dir: str) -> None:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, QUANT_CONFIG_FILENAME), "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_quant_config(cls, quantize_cfg: dict, checkpoint_format: str | None = None):
        """Normalize an HF-style quantization dict."""
        valid = {CHECKPOINT_FORMAT.GPTQ, CHECKPOINT_FORMAT.MARLIN, CHECKPOINT_FORMAT.AWQ_GEMM}
        if checkpoint_format:
            if checkpoint_format not in valid:
                raise ValueError(f"Unknown quantization checkpoint format: {checkpoint_format}.")
            if quantize_cfg.get(CHECKPOINT_FORMAT_FIELD):
                raise ValueError(
                    "Conflict: checkpoint_format is passed in and also exists in model config."
                )

        field_names = {f.name for f in fields(cls)}
        normalized = {
            QUANT_METHOD_FIELD: QUANT_METHOD.GPTQ,
            CHECKPOINT_FORMAT_FIELD: checkpoint_format or CHECKPOINT_FORMAT.GPTQ,
        }
        for key, val in quantize_cfg.items():
            key = key.lower()
            if key in _ARG_SYNONYMS and _ARG_SYNONYMS[key] in field_names:
                key = _ARG_SYNONYMS[key]

            if key == CHECKPOINT_FORMAT_FIELD:
                val = val.lower()
                if val not in valid:
                    raise ValueError(f"Unknown quantization format: {val}.")
                normalized[key] = val
            elif key == QUANT_METHOD_FIELD:
                val = val.lower()
                if val == CHECKPOINT_FORMAT.MARLIN:
                    normalized[CHECKPOINT_FORMAT_FIELD] = CHECKPOINT_FORMAT.MARLIN
                elif val not in {QUANT_METHOD.GPTQ, QUANT_METHOD.AWQ}:
                    raise ValueError(f"Unknown quantization method: {val}.")
                else:
                    normalized[QUANT_METHOD_FIELD] = val
            elif key == CHECKPOINT_FORMAT_FIELD_COMPAT_MARLIN and val:
                normalized[CHECKPOINT_FORMAT_FIELD] = CHECKPOINT_FORMAT.MARLIN
            elif key == "version" and isinstance(val, str) and val.lower() == CHECKPOINT_FORMAT.AWQ_GEMM:
                normalized[QUANT_METHOD_FIELD] = QUANT_METHOD.AWQ
                normalized[CHECKPOINT_FORMAT_FIELD] = CHECKPOINT_FORMAT.AWQ_GEMM
            elif key in field_names:
                normalized[key] = val
            else:
                logger.info("Ignoring unknown quantization configuration parameter: %s.", key)

        if normalized[CHECKPOINT_FORMAT_FIELD] in {CHECKPOINT_FORMAT.AWQ_GEMM, CHECKPOINT_FORMAT.MARLIN}:
            normalized["desc_act"] = False
        return cls(**normalized)

    @classmethod
    def from_pretrained(cls, save_dir: str, checkpoint_format: str | None = None):
        transformers_config = False
        resolved = None
        for name in (QUANT_CONFIG_FILENAME, "quant_config.json", "config.json"):
            candidate = os.path.join(save_dir, name)
            if os.path.isfile(candidate):
                resolved = candidate
                transformers_config = name == "config.json"
                break
        if resolved is None:
            raise ValueError(
                "No quantize_config.json, quant_config.json or config.json file "
                f"was found in {save_dir!r}."
            )
        with open(resolved, "r", encoding="utf-8") as f:
            args = json.load(f)
        if transformers_config:
            if "quantization_config" not in args:
                raise ValueError(
                    f"{resolved!r} has no 'quantization_config' section: this "
                    "looks like an unquantized model's config.json."
                )
            args = args["quantization_config"]
        return cls.from_quant_config(args, checkpoint_format)


__all__ = [
    "BaseQuantizeConfig",
    "CHECKPOINT_FORMAT",
    "QUANT_METHOD",
    "QUANT_CONFIG_FILENAME",
]
