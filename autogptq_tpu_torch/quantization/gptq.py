"""GPTQ solver: Hessian-weighted error-compensated quantization on torch tensors.

Counterpart of the JAX package's ``quantization/gptq.py``; everything runs on
the device its inputs lie on.

  * Hessian accumulation is a fold (:func:`hessian_update`):
    ``H = (2 / n) * sum_i x_i x_i^T`` kept as a running mean.
  * :func:`gptq_quantize` performs the damped-Cholesky blockwise solve:
    dead-column zeroing, optional activation-order permutation (desc_act),
    per-group scale/zero search and rank-1 error propagation. The 128-column
    blocks and the columns inside them are Python loops; every tensor stays on
    the device and nothing is read back inside them, so the host only enqueues.

Numerics follow the JAX package step for step (fp32 Hessian and weights,
damp = percdamp * mean(diag H), the stale-within-block W used for the group
param search). The two products that decide codes, the Hessian's
``x^T x`` and the block error propagation, run in full fp32: TF32 is switched
off around them and restored, never flipped globally.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .quantizer import QuantizerConfig, find_params, quantize_rtn


@dataclass(frozen=True)
class GPTQConfig:
    """Static solver configuration."""

    bits: int = 4
    group_size: int = -1
    sym: bool = True
    desc_act: bool = False          # activation-order ("act-order") quantization
    static_groups: bool = False
    percdamp: float = 0.01
    blocksize: int = 128
    mse: bool = False

    @property
    def maxq(self) -> int:
        return (1 << self.bits) - 1

    def quantizer(self) -> QuantizerConfig:
        return QuantizerConfig(bits=self.bits, sym=self.sym, mse=self.mse)


class GPTQResult(NamedTuple):
    qweight: torch.Tensor      # [N, K] fake-quantized (dequantized) weights, fp32
    scale: torch.Tensor        # [G, N] per-group scales
    zero: torch.Tensor         # [G, N] per-group zero points (integral, stored float)
    g_idx: torch.Tensor        # [K]    per-input-feature group index (original order), int32
    total_loss: torch.Tensor   # scalar sum of proxy losses
    row_loss: torch.Tensor     # [N] per-output-row loss (splits a batched multi-layer
    #                            solve back into per-layer sums)


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 ``torch.matmul`` on the card in full precision (no TF32) inside
    the block; the caller's setting is restored after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def hessian_init(columns: int, device) -> tuple[torch.Tensor, int]:
    """A zero ``[columns, columns]`` f32 Hessian on ``device`` (no default:
    the caller names where the calibration runs) and a sample count of 0."""
    return torch.zeros((columns, columns), dtype=torch.float32, device=device), 0


def hessian_update(h: torch.Tensor, nsamples: int, x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Fold a batch of layer inputs into the running Hessian (in place).

    ``x``: ``[B, T, K]`` or ``[T, K]`` activations feeding the linear layer.
    The sample count is the number of *sequences* (leading batch dim), not
    tokens; it is a host integer, so no step waits for the device."""
    if x.dim() == 2:
        x = x[None]
    new_n = nsamples + x.shape[0]
    x2d = x.reshape(-1, x.shape[-1]).float()
    coeff = float(np.float32(nsamples) / np.float32(new_n))
    xs = x2d * float(np.sqrt(np.float32(2.0) / np.float32(new_n)))
    with full_fp32_matmul():
        h.mul_(coeff).addmm_(xs.t(), xs)
    return h, new_n


def _cholesky_inv_upper(h: torch.Tensor) -> torch.Tensor:
    """Upper-triangular U with ``H^{-1} = U^T U``. A Hessian that is not
    positive definite gives NaNs (as the JAX package's does) instead of
    raising here: the caller checks the solver loss once, after the solve."""
    l, info = torch.linalg.cholesky_ex(h)
    l = torch.where(info.bool(), torch.nan, l)
    hinv = torch.cholesky_inverse(l)
    u, info = torch.linalg.cholesky_ex(hinv, upper=True)
    return torch.where(info.bool(), torch.nan, u)


def gptq_quantize(w: torch.Tensor, h: torch.Tensor, cfg: GPTQConfig) -> GPTQResult:
    """Quantize one weight matrix ``w[N, K]`` given Hessian ``h[K, K]``.

    Returns fake-quantized weights plus per-group parameters and ``g_idx``,
    all in the *original* (unpermuted) column order."""
    n, k = w.shape
    gs = cfg.group_size if cfg.group_size != -1 else k
    n_groups = -(-k // gs)
    k_pad = n_groups * gs
    bs = cfg.blocksize
    qcfg = cfg.quantizer()
    maxq = cfg.maxq
    dev = w.device

    w = w.float().clone()
    h = h.float().clone()

    # Whole-matrix params (used when group_size == -1): computed on the raw W
    # before dead-column zeroing.
    full_scale, full_zero = find_params(w, qcfg)

    dead = torch.diagonal(h) == 0
    torch.diagonal(h).add_(dead.float())
    w = torch.where(dead[None, :], 0.0, w)

    def padded(t: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(t, (0, k_pad - k))

    # Static-group params are found on the *unpermuted* dead-zeroed W.
    if cfg.static_groups:
        rows = padded(w).view(n, n_groups, gs).permute(1, 0, 2).reshape(n_groups * n, gs)
        s, z = find_params(rows, qcfg)
        scale_arr, zero_arr = s.view(n_groups, n), z.view(n_groups, n)
    elif cfg.group_size == -1:
        scale_arr, zero_arr = full_scale[None, :], full_zero[None, :]
    else:
        scale_arr = torch.zeros((n_groups, n), dtype=torch.float32, device=dev)
        zero_arr = torch.zeros((n_groups, n), dtype=torch.float32, device=dev)

    perm = invperm = None
    if cfg.desc_act:
        # stable, as jnp.argsort is: dead columns (diagonal set to 1) tie
        perm = torch.argsort(-torch.diagonal(h), stable=True)
        w = w[:, perm]
        h = h[perm][:, perm]
        invperm = torch.argsort(perm)

    damp = cfg.percdamp * torch.mean(torch.diagonal(h))
    torch.diagonal(h).add_(damp)
    hinv = _cholesky_inv_upper(h)
    del h

    # Global W, zero-padded so in-loop group slices are always full-width
    # (zero columns are exactly neutral for find_params).
    w_pad = padded(w)
    q_full = torch.zeros((n, k), dtype=torch.float32, device=dev)
    row_loss = torch.zeros((n,), dtype=torch.float32, device=dev)
    # group of each (permuted) column's ORIGINAL index, for static groups
    static_group = None
    if cfg.static_groups:
        cols = perm if cfg.desc_act else torch.arange(k, device=dev)
        static_group = cols // gs

    # Current-group params carry across block boundaries (matters when
    # group_size > blocksize); they start as the whole-matrix params.
    cur_s, cur_z = full_scale, full_zero

    for i1 in range(0, k, bs):
        i2 = min(i1 + bs, k)
        w1 = w_pad[:, i1:i2].clone()
        hinv1 = hinv[i1:i2, i1:i2]
        q1 = torch.zeros_like(w1)
        err1 = torch.zeros_like(w1)
        for i in range(i2 - i1):
            j = i1 + i      # global column in (permuted) order
            if cfg.static_groups:
                g = static_group[j:j + 1]
                cur_s = scale_arr.index_select(0, g)[0]
                cur_z = zero_arr.index_select(0, g)[0]
            elif cfg.group_size != -1 and j % gs == 0:
                # Entering a new group: search params on the stale global W
                # (un-updated since the block's start).
                cur_s, cur_z = find_params(w_pad[:, j:j + gs], qcfg)
                scale_arr[j // gs] = cur_s
                zero_arr[j // gs] = cur_z

            wcol = w1[:, i]
            q = quantize_rtn(wcol, cur_s, cur_z, maxq)
            e = (wcol - q) / hinv1[i, i]
            q1[:, i] = q
            err1[:, i] = e
            w1[:, i:] -= e[:, None] * hinv1[i, i:][None, :]

        # the columns' proxy losses ((w - q) / d)^2 / 2, summed once per block
        row_loss += 0.5 * (err1 * err1).sum(dim=1)
        q_full[:, i1:i2] = q1
        if i2 < k:
            # Propagate the block's error to the remaining real columns.
            with full_fp32_matmul():
                w_pad[:, i2:k] -= err1 @ hinv[i1:i2, i2:]

    # Group indices in original column order.
    g_idx = torch.arange(k, device=dev) // gs
    if cfg.static_groups and cfg.desc_act:
        g_idx = static_group[invperm]
    elif cfg.desc_act:
        g_idx = g_idx[invperm]
    if cfg.desc_act:
        q_full = q_full[:, invperm]

    return GPTQResult(
        qweight=q_full,
        scale=scale_arr,
        zero=zero_arr,
        g_idx=g_idx.to(torch.int32),
        total_loss=row_loss.sum(),
        row_loss=row_loss,
    )


__all__ = ["GPTQConfig", "GPTQResult", "gptq_quantize", "hessian_init", "hessian_update",
           "full_fp32_matmul"]
