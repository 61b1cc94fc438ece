"""Scale/zero-point search ("quantizer") on torch tensors.

Counterpart of the JAX package's ``quantization/quantizer.py``: pure functions
that run on whatever device their input lies on.

  * :func:`find_params` — per-row min/max scale and zero search with optional
    symmetric mode and MSE grid-search refinement.
  * :func:`quantize_rtn` — round-to-nearest quantize/dequantize given params.

Conventions: weight matrices are ``[rows, cols] = [out_features, in_features]``
slices; ``find_params(w)`` returns per-row ``scale``/``zero`` of shape
``[rows]``, the only path GPTQ uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class QuantizerConfig:
    bits: int = 4
    sym: bool = True
    mse: bool = False
    norm: float = 2.4
    grid: int = 100
    maxshrink: float = 0.8

    @property
    def maxq(self) -> int:
        return (1 << self.bits) - 1


def quantize_rtn(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 maxq: int) -> torch.Tensor:
    """Round-to-nearest fake-quantization:
    ``scale * (clip(round(x / scale) + zero) - zero)``; ``scale``/``zero``
    broadcast against ``x``."""
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


def find_params(x: torch.Tensor, cfg: QuantizerConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row quantization params for a weight slice ``x[rows, cols]``:
    ``(scale[rows], zero[rows])`` in f32. Ranges include 0, symmetric mode
    mirrors the max magnitude, all-zero rows get the range [-1, 1], the
    symmetric zero point is the fixed midpoint ``(maxq + 1) / 2``, and the
    optional MSE pass shrinks the range over a grid, minimizing the
    ``norm``-power reconstruction error."""
    maxq = cfg.maxq
    # A range becomes a scale by multiplying with the f32 reciprocal of maxq,
    # which is how XLA compiles the JAX package's division by that constant:
    # the two differ in the last bit, and in symmetric mode a group's extreme
    # weight sits exactly on a rounding edge, where that bit decides its code.
    inv_maxq = float(np.float32(1.0) / np.float32(maxq))
    x = x.float()
    xmin = x.amin(dim=1).clamp(max=0.0)
    xmax = x.amax(dim=1).clamp(min=0.0)

    if cfg.sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)

    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)

    scale = (xmax - xmin) * inv_maxq
    if cfg.sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)

    if cfg.mse:
        best = torch.full_like(scale, float("inf"))
        for i in range(int(cfg.maxshrink * cfg.grid)):
            # the shrink factor in f32 arithmetic, as the JAX package computes it
            p = float(np.float32(1.0) - np.float32(i) / np.float32(cfg.grid))
            xmin1 = p * xmin
            xmax1 = p * xmax
            scale1 = (xmax1 - xmin1) * inv_maxq
            zero1 = zero if cfg.sym else torch.round(-xmin1 / scale1)
            q = quantize_rtn(x, scale1[:, None], zero1[:, None], maxq)
            err = ((q - x).abs() ** cfg.norm).sum(dim=1)
            better = err < best
            best = torch.where(better, err, best)
            scale = torch.where(better, scale1, scale)
            zero = torch.where(better, zero1, zero)

    return scale, zero


def find_params_tensor(x: torch.Tensor, cfg: QuantizerConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor variant: one scalar scale/zero for the whole array."""
    scale, zero = find_params(x.reshape(1, -1), cfg)
    return scale[0], zero[0]


__all__ = ["QuantizerConfig", "find_params", "find_params_tensor", "quantize_rtn"]
