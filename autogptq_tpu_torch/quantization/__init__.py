from .config import (
    BaseQuantizeConfig,
    CHECKPOINT_FORMAT,
    QUANT_CONFIG_FILENAME,
    QUANT_METHOD,
)

from .gptq import GPTQConfig, GPTQResult, gptq_quantize, hessian_init, hessian_update
from .quantizer import QuantizerConfig, find_params, find_params_tensor, quantize_rtn

__all__ = [
    "GPTQConfig",
    "GPTQResult",
    "gptq_quantize",
    "hessian_init",
    "hessian_update",
    "QuantizerConfig",
    "find_params",
    "find_params_tensor",
    "quantize_rtn",
    "BaseQuantizeConfig",
    "CHECKPOINT_FORMAT",
    "QUANT_METHOD",
    "QUANT_CONFIG_FILENAME",
]
