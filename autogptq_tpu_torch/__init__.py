"""autogptq_tpu_torch — the PyTorch/CUDA port of autogptq_tpu.

Quantizes causal LMs with GPTQ to 2, 3, 4 or 8 bits, saves and loads GPTQ
checkpoints and generates on an NVIDIA Hopper GPU through kernels written by
hand for ``sm_90a`` (``ops/csrc``), with a plain PyTorch version of every
kernel that runs on the CPU. It imports PyTorch and NumPy, never JAX or
the ``autogptq_tpu`` package.
"""

__version__ = "0.1.0"

from .models.auto import AutoGPTQForCausalLM
from .models.base import GPTQModel
from .quantization import BaseQuantizeConfig

__all__ = ["AutoGPTQForCausalLM", "GPTQModel", "BaseQuantizeConfig", "__version__"]
