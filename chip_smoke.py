#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autogptq_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_smoke.py`` (no arguments,
one card). It imports nothing of JAX or of the ``autogptq_tpu`` package.

1. Prints the card (``nvidia-smi`` name and power limit, torch's device name).
2. Builds every kernel of the port from ``autogptq_tpu_torch/ops/csrc`` with
   ``nvcc`` for ``sm_90a``, all sources at once, and prints the build times.
3. K1 (w4a16 GEMM) against its plain PyTorch version at the Llama-2-7B
   projection shapes, M in {1, 4, 16, 128, 2048} (4 is the beam path's decode,
   2048 a training step's 4 x 512 batch), plus
   a desc_act and a bias case: the
   error against the stated tolerance, the kernel's, the plain version's and
   ``torch.matmul``'s (on a pre-dequantized bf16 weight) times, and the bound.
   At M = 128 and 2048 (bf16) the tensor-core tile kernel runs, and the SIMT
   tile kernel is held and timed beside it on the same weights; ptxas'
   registers, spills and shared memory of every tensor-core instance.
4. K2 (split-KV flash-decode) against ``flash_decode_ref``: B=1 MHA, B=2
   with a left-padded row, and GQA at 528 slots, a window sweep (17, 64, 272
   and 528 live slots, MHA and GQA) and Mixtral-8x7B's decode shape (8 KV
   heads, 144 slots), each case called twice with bit-equal results, with the
   same measurements (the library call is ``scaled_dot_product_attention``)
   and the split plan.
5. K7 (split-KV paged attention) against ``paged_attention_mh_ref`` at the
   beam-4 Llama-2-7B shape (bf16 and int8 pools), GQA, unequal lengths and a
   length sweep (bf16 and int8), as K2; ptxas' registers and spills of every
   K2 and K7 instance (a spill fails the run); K8a
   (page row write) and K8b (page copy, a src naming another copy's dst)
   bit-equal against ``write_token_pages`` / ``copy_pages`` on bf16, int8
   and 4-D scale pools, and refusing an id outside the pool without writing.
   Library yardsticks: ``scaled_dot_product_attention`` over the same live
   K/V laid out contiguously, ``index_put_``, and ``index_select`` +
   ``index_copy_``.
6. The main path: writes a random 4-bit g128 Llama-2-7B checkpoint (all 32
   layers), loads it with ``AutoGPTQForCausalLM.from_quantized`` on the
   default device and greedy-decodes 512 tokens from a 16-token prompt at
   batch 1, with the launch counts set to 0 just before and read just after;
   then a batch-2 left-padded run of 16 tokens.
7. The beam path on the same model: ``generate(num_beams=4)`` of 512 tokens
   over the paged bf16 cache (counts set to 0 just before, read just after),
   repeated to check that it reproduces its tokens, then a 64-token run over
   the int8 paged cache. A profile of a short greedy and a short beam-4
   generate gives device time by kernel family.
8. The port on the card against the port on the CPU: a 2-layer, full-width
   cut of the same checkpoint, prefill and one decode step, and one paged
   beam-4 decode step, bf16 kernels on the card against the f32 plain
   versions on the CPU.
9. K4 (w8a16 GEMM), K5 (w2a16 GEMM) and K1 at the shape classes of the TPU's
   ``ki32`` and ``kpair`` kernels (3-bit codes in nibbles, one group, group
   sizes 16 and 64, K = 11008) against their plain versions at the three
   Llama-2-7B shapes, M in {1, 4, 16, 17, 128}, bf16 (timed) and f32, one
   desc_act case per kernel. The rest classes (group sizes the codes per word
   do not divide, a partial last group) at full width, one layer per storage
   width, through the GEMV (M = 1), the SIMT tile kernel and K10 (M = 128).
10. The other widths generate: random 2-, 3- and 8-bit g128 checkpoints at
   full width and 8 layers, ``from_quantized``, 64 greedy tokens twice with
   equal tokens, launch counts (K5, K1, K4) set to 0 before and read after;
   a batch-2 run whose 32-row prefill takes each width's tensor-core kernel.
11. Quantize on the card at full width: a random fp16 1-layer checkpoint,
   ``from_pretrained``, ``quantize`` with 64 calibration sequences of 256
   tokens for 4-bit g128, 4-bit g128 desc_act, 2-, 3- and 8-bit; seconds per
   layer by phase, the solver loss, GPTQ against round-to-nearest on every
   solve's own Hessian, ``save_quantized`` -> ``from_quantized`` with logits
   bit-equal to the in-memory model's, and the logit error against the fp
   model, which must fall from 2 to 8 bits.
12. K10 (``wna16_gemm_t``, the backward ``dx = g @ dequant(W)^T``) against
   ``wna16_matmul_t_ref`` at the three Llama-2-7B projection shapes, M in
   {10 (an adaption prompt's rows), 17, 128, 2048 (a 4 x 512 batch)}, 2-, 3-,
   4- and 8-bit g128 plus a desc_act and a group-size-32 case, bf16 (timed)
   and f32; ``torch.matmul(g, W_bf16.T)`` on a pre-dequantized weight is the
   library yardstick. bf16 above 16 rows takes the tensor-core K10; the
   4-bit rows at M = 128 and 2048 also hold and time the SIMT K10.
13. Training on the main-path model (full depth and width, 4-bit g128):
   ``utils.peft.get_gptq_peft_model`` with LoRA at the example's defaults (r 16,
   alpha 32, q_proj and v_proj), 8 ``torch.optim.AdamW`` steps at lr 1e-3 on
   one random batch of 4 x 512 tokens (one row left-padded, labels -100 on the
   pads, the example's masked loss); the loss of every step, seconds per step,
   tokens/s, peak memory, K1 and K10 launches per step (counts set to 0 just
   before each step and read just after: the tensor-core kernels only), a
   profile of one more step (K1, K10, attention, other, and by kernel
   instance), ``save_adapter`` and a 16-token greedy ``generate`` with the
   adapters in place, twice with equal tokens.
14. Adapter gradients on the card against the CPU: the 2-layer full-width cut
   of step 8, batch 1 x 64, LoRA, AdaLoRA and an adaption prompt with every
   adapter tensor drawn from a seed; one backward on the card (bf16, K1 and
   K10, K10 launches counted) and one on the CPU (f32, plain versions),
   relative Frobenius error of every adapter gradient, and the same with f32
   activations on the card; then one AdamW step of each kind on the card.
15. K9 (``w4a16_routed_gemm``, the routed-expert GEMV of MoE decode) against
   ``wna16_routed_matmul_ref`` at Mixtral-8x7B's expert shapes (4096 x 14336 and
   14336 x 4096, g128, 8 stacked experts), P in {1, 2, 8} pairs (8 with repeated
   experts), bf16 (timed) and f32; P ``torch.matmul`` calls on pre-dequantized
   bf16 experts are the library yardstick; a pair naming expert -1 or E writes
   nothing, sets the flag and ``check=True`` raises.
16. The Mixtral path: writes a random 4-bit g128 Mixtral-8x7B checkpoint (all 32
   layers, about 24.6 GB) under ``build/chip_smoke/``, ``from_quantized`` on the
   default device, ``params.stack_moe_experts``, deletes the checkpoint; greedy
   decode of 128 tokens from a 16-token prompt twice (equal tokens; launch
   counts set to 0 just before the first and read just after: K9 96, K2 32,
   K1 128 per decode token), a profile by kernel family, and 64 tokens of
   beam 4 over the paged bf16 cache (K9 at P = 8, K7, K8a, K8b).
17. Mixtral card against CPU on a 2-layer full-width cut, f32 on both sides
   (logits of a prefill and of a routed decode step), the share of the
   CPU's routing choices that an f32 and a bf16 card run make, and one
   layer's ``moe_mlp`` on the card in f32, routed (K9) and dense stacked
   against the expert list (K1).
18. K6 (``w4a16_kb32l_gemm``, K1's function over the tile-contiguous kb32l
   words, a cp.async ring in the decode regime) against its plain version at
   the Llama-2-7B projection shapes, M in {1, 4, 16} (decode) and {128, 2048}
   (tile), 4-bit g128 bf16, plus 3-bit, desc_act, bias, N = 1312 and f32 and
   f16 at M = 1; timed beside K1 on the same weights in the GPTQ layout, the
   plain version and ``torch.matmul``; the decode plan (stages, tile bytes,
   blocks, blocks per SM, weight bytes in flight per SM) and ptxas' registers
   and spills. K10 over kb32l words at M = 64 and 2048.
19. The kb32l path: the main path's checkpoint loaded again with
   ``from_quantized(layout="kb32l")``; prefill logits against the GPTQ-layout
   model; 512 greedy tokens twice (counts set to 0 just before the first and
   read just after: K6 7 x 32 per token, no K1); the share of tokens equal to
   the main path's; a profile; a batch-2 generate whose 32-row prefill runs
   K6's tile regime. On the 2-layer cut, kb32l in f32 on the card against
   the CPU. On the 2-layer Mixtral cut, ``dx`` through a layer's routed
   ``moe_mlp`` (K9 forward, K10 backward) on the card against the CPU.
20. Estimates K2's and K7's device time per token over a 512-token run from
   the sweeps, writes every measurement to ``build/chip_smoke.json`` and
   prints one JSON line of kernel measurements, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line. Times are CUDA-event times of warmed calls with the 50 MB L2 cache
flushed before each call.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
# K1: the kernel and its plain version both dequantize and accumulate in f32
# and round once to bf16 (2^-9 relative). Allowed: 1% of the largest output.
K1_REL_TOL = 1e-2
# K2: both sides are f32 on the same bf16 inputs and differ only in summation
# order and in exp; outputs are averages of values of order one.
K2_ABS_TOL = 1e-4
# Card (bf16 activations, bf16 KV cache, kernels) against CPU (f32, plain
# versions) after 2 full-width layers: relative Frobenius error of the logits.
E2E_REL_TOL = 5e-2
# K7: as K2, both sides f32 on the same inputs (int8 codes and f32 scales
# dequantized alike), differing only in summation order and exp.
K7_ABS_TOL = 1e-4
# K1/K4/K5 with f32 activations: f32 weights and accumulation on both sides,
# summation order only (K up to 11008 terms of order one).
F32_ABS_TOL = 1e-4
# K10: as K1, f32 weights and accumulation on both sides, one rounding to bf16;
# with f32 cotangents F32_ABS_TOL.
K10_REL_TOL = 1e-2
# Adapter gradients, card (bf16 activations, kernels) against CPU (f32, plain),
# 2 full-width layers: relative Frobenius error of each adapter tensor's
# gradient, the logits' bound E2E_REL_TOL.
GRAD_REL_TOL = 5e-2
# The same with f32 activations on the card: f32 everywhere (K1/K10 dequantize
# and accumulate in f32, TF32 off), so summation order only.
GRAD_F32_REL_TOL = 1e-3
TRAIN_BATCH, TRAIN_LEN, TRAIN_PAD = 4, 512, 64   # one row left-padded by TRAIN_PAD
TRAIN_STEPS, TRAIN_LR, TRAIN_RANK = 8, 1e-3, 16  # the example's r and alpha = 2 r
TRAIN_M = TRAIN_BATCH * TRAIN_LEN                # rows of every projection in a step
GRAD_LEN = 64                                    # tokens of the card-vs-CPU gradient batch
ADAPTER_STD = 0.02                               # adapter tensors drawn for that check
TRAIN_NEW_TOKENS = 16
OTHER_WIDTH_LAYERS = 8        # depth of the 2-, 3- and 8-bit generate runs
OTHER_WIDTH_TOKENS = 64
QUANT_LAYERS = 1              # depth of the model quantized on the card (widths full)
CALIB_SEQS, CALIB_LEN, CALIB_BATCH = 64, 256, 16
KERNEL_OF_BITS = {2: "w2a16_gemm", 3: "w4a16_gemm", 4: "w4a16_gemm", 8: "w8a16_gemm"}
BEAMS = 4
PAGE = 16
QUANT_NEW_TOKENS = 64
BEAM_PROFILE_TOKENS = 17
AUTOGPTQ_BEAM4_A100 = 91.30   # BASELINE.md: llama-7b gptq-int4, beam 4, 1x A100-40G
SPIN_CYCLES = 1_000_000       # about 0.5 ms of GPU clock before each timed call
NEW_TOKENS = 512
PROFILE_TOKENS = 33
PROMPT_LEN = 16
# K9 against its plain version: f32 to F32_ABS_TOL, bf16 to 1% of the largest output
# (one rounding on both sides). Mixtral card against CPU, both f32 (a bf16 router can rank
# two near-equal experts otherwise: a different result, no kernel wrong): relative
# Frobenius error of the logits. One layer's moe_mlp, routed (K9) against the expert
# list (K1) and the dense stacked path (K1), f32 on the card.
MIXTRAL_E2E_F32_REL_TOL = 1e-3
MOE_F32_ABS_TOL = 1e-4
# K6 with f32 activations against its plain version: f32 weights and accumulation on both
# sides, summation order only: 1e-5 of the largest output (bf16/f16: K1_REL_TOL).
K6_F32_REL_TOL = 1e-5
# The kb32l model against the GPTQ-layout model, both bf16 on the card: the same function
# summed in another order, rounded to bf16 at every layer; relative Frobenius error.
KB32L_E2E_REL_TOL = 5e-2
# The kb32l model, f32 on the card (K6, K2) against f32 on the CPU (plain), 2 layers; and
# dx through a Mixtral layer's routed moe_mlp, f32 on both sides (K9 + K10 against plain).
KB32L_CUT_F32_REL_TOL = 1e-4
ROUTED_GRAD_F32_REL_TOL = 1e-4
MIXTRAL_LAYERS = 32           # depth of the Mixtral-8x7B path (full)
MIXTRAL_NEW_TOKENS = 128
MIXTRAL_BEAM_TOKENS = 64
MIXTRAL_PROFILE_TOKENS = 17
K9_SELS = {1: [3], 2: [1, 6], 8: [0, 7, 7, 2, 0, 5, 1, 7]}   # P = 8: beam 4, repeats
MIXTRAL_SHAPES = {        # Mixtral-8x7B expert projection: (K, N, K9 calls per layer)
    "gate_up": (4096, 14336, 2),
    "down": (14336, 4096, 1),
}
LAYER_SHAPES = {          # Llama-2-7B projection: (K, N, calls per decoder layer)
    "qkvo": (4096, 4096, 4),
    "gate_up": (4096, 11008, 2),
    "down": (11008, 4096, 1),
}


MMA_SOURCE = "autogptq_tpu_torch/ops/csrc/wna16_mma.cuh"   # the tensor-core tile kernels


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean CUDA-event time of a warmed call, L2 flushed before each call.
    A GPU-side spin between the flush and the start event keeps the card busy
    while the host enqueues the call, so the events time the device work and
    not the host's launch overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def simt_matmul(gemm, qlin, x, layer):
    """``qlin.matmul(x, layer)`` through the layer's SIMT kernels (GEMV or SIMT
    tile kernel) whatever ``gemm.tile_kernel`` would pick: the tensor-core
    kernel's yardstick on the same weights."""
    if layer.layout == "kb32l":
        return gemm.w4a16_kb32l_matmul(x, layer.qweight, layer.scales, layer.zeros, layer.kperm,
                                       layer.bias, layer.group_size, layer.out_features,
                                       kernel="simt")
    return gemm.wna16_matmul(x, layer.qweight, layer.scales, layer.zeros, layer.kperm,
                             layer.bias, layer.group_size, qlin.storage_bits(layer.bits),
                             kernel="simt")


def phase_k1(torch, np, timer) -> list:
    """K1 against its plain version at the Llama-2-7B shapes; at M > 16 the
    tensor-core tile kernel (bf16) and the SIMT tile kernel on the same
    weights, each held to K1_REL_TOL and timed."""
    from autogptq_tpu_torch.ops import gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin
    from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors

    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(name, k, n, m, False, False)
             for m in (1, BEAMS, 16, 128, TRAIN_M) for name, (k, n, _) in LAYER_SHAPES.items()]
    cases += [("qkvo+desc_act", 4096, 4096, 1, True, False),
              ("gate_up+bias", 4096, 11008, 16, False, True)]
    rows = []
    for name, k, n, m, desc_act, with_bias in cases:
        t = random_quant_tensors(rng, k, n, 4, 128, desc_act)
        bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
        layer = qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=bias, bits=4, group_size=128, in_features=k, out_features=n), device="cuda")
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        y = qlin.matmul(x, layer)
        ref = qlin.matmul_plain(x, layer)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(bool(torch.isfinite(y).all()), f"K1 {name} M={m}: non-finite output")
        check(err <= K1_REL_TOL * scale, f"K1 {name} M={m}: max |kernel - plain| = {err:.3e} "
                                         f"> {K1_REL_TOL} * {scale:.3e}")
        route = gemm.tile_kernel(x.dtype, m, 128)
        iters = 5 if m == TRAIN_M else 20
        simt = {}
        if route == "mma":     # the SIMT tile kernel on the same weights
            ys = simt_matmul(gemm, qlin, x, layer)
            torch.cuda.synchronize()
            serr = (ys.float() - ref.float()).abs().max().item()
            check(serr <= K1_REL_TOL * scale, f"K1 SIMT {name} M={m}: max |kernel - plain| = "
                                              f"{serr:.3e} > {K1_REL_TOL} * {scale:.3e}")
            simt = dict(simt_max_abs_err=serr, simt_ms=timer.ms(
                lambda: simt_matmul(gemm, qlin, x, layer), iters=iters))
        w = qlin.logical_weight(layer, torch.bfloat16)
        ms = timer.ms(lambda: qlin.matmul(x, layer), iters=iters)
        plain_ms = timer.ms(lambda: qlin.matmul_plain(x, layer), iters=min(iters, 10))
        lib_ms = timer.ms(lambda: torch.matmul(x, w), iters=iters)
        b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                     layer.kperm, layer.bias), 2.0 * m * k * n)
        rows.append(dict(case=name, K=k, N=n, M=m, route=route, max_abs_err=err,
                         max_abs_ref=scale, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, **simt))
        print(f"K1 {name:14s} K={k:5d} N={n:5d} M={m:4d} {route:4s}  err {err:.3e} (tol "
              f"{K1_REL_TOL * scale:.3e})  kernel {ms:.4f} ms ({2.0 * m * k * n / ms / 1e9:.1f} "
              f"TFLOP/s)" + (f"  SIMT tile {simt['simt_ms']:.4f} ms (err "
                             f"{simt['simt_max_abs_err']:.3e})" if simt else "")
              + f"  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound {b_ms:.4f} ms "
                f"({b_by})", flush=True)
    return rows

def _random_layer(qlin, rng, k, n, bits, gs, desc_act, dtype, layout=None):
    from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors

    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    return qlin.from_packed(qlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=None, bits=bits, group_size=gs, in_features=k, out_features=n), device="cuda",
        dtype=dtype, layout=layout)


def ptxas_report(name: str, key: str) -> list:
    """Registers and spill bytes that ptxas reported in kernel ``name``'s build
    log for each entry function whose mangled name contains ``key``."""
    import re

    from autogptq_tpu_torch.ops import build

    out, fn, spills, smem = [], None, None, None
    for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spills = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None and key in fn:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(dict(function=fn, registers=int(m.group(1)),
                            spill_stores=spills[0] if spills else None,
                            spill_loads=spills[1] if spills else None,
                            smem=int(smem.group(1)) if smem else 0))
            fn = None
    return out


def phase_k6(torch, np, timer) -> dict:
    """K6 against its plain version, timed beside K1 on the same weights in
    the GPTQ layout, the plain version and torch.matmul; the decode plan."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin
    from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors

    rng = np.random.default_rng(6)
    gen = torch.Generator(device="cuda").manual_seed(6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (case, K, N, M, bits, desc_act, bias, dtype)
    cases = [(name, k, n, m, 4, False, False, bf16)
             for m in (1, BEAMS, 16, 128, TRAIN_M) for name, (k, n, _) in LAYER_SHAPES.items()]
    cases += [("qkvo 3-bit", 4096, 4096, 1, 3, False, False, bf16),
              ("down+desc_act", 11008, 4096, 1, 4, True, False, bf16),
              ("gate_up+bias", 4096, 11008, 1, 4, False, True, bf16),
              ("N=1312", 4096, 1312, 1, 4, False, False, bf16)]
    cases += [(f"{name} {tag}", k, n, 1, 4, False, False, dt) for tag, dt in (("f32", f32),
                                                                             ("f16", f16))
              for name, (k, n, _) in LAYER_SHAPES.items()]
    rows = []
    for name, k, n, m, bits, desc_act, with_bias, dtype in cases:
        t = random_quant_tensors(rng, k, n, bits, 128, desc_act)
        packed = qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=rng.standard_normal(n).astype(np.float32) if with_bias else None, bits=bits,
            group_size=128, in_features=k, out_features=n)
        layer = qlin.from_packed(packed, device="cuda", dtype=dtype, layout="kb32l")
        gptq = qlin.from_packed(packed, device="cuda", dtype=dtype)
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=dtype)
        before = dict(build.launches)
        y = qlin.matmul(x, layer)
        key = gemm.KB32L_KERNEL + (gemm.MMA_SUFFIX if gemm.tile_kernel(dtype, m, 128) == "mma"
                                   else "")
        check(build.launches[key] == before.get(key, 0) + 1
              and build.launches["w4a16_gemm"] == before.get("w4a16_gemm", 0)
              and build.launches["w4a16_gemm_mma"] == before.get("w4a16_gemm_mma", 0),
              f"K6 {name} M={m}: launched {dict(build.launches)}")
        ref = qlin.matmul_plain(x, layer)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (K6_F32_REL_TOL if dtype == f32 else K1_REL_TOL) * scale
        check(y.shape == (m, n) and bool(torch.isfinite(y).all()), f"K6 {name} M={m}: bad output")
        check(err <= tol, f"K6 {name} M={m} {dtype}: max |kernel - plain| = {err:.3e} > {tol:.3e}")
        check(torch.equal(qlin.matmul(x, layer), y), f"K6 {name} M={m}: not deterministic")
        w = qlin.logical_weight(layer, dtype)
        iters = 5 if m == TRAIN_M else 20
        route = gemm.tile_kernel(dtype, m, 128)
        simt = {}
        if route == "mma":     # K6's SIMT tile kernel on the same words
            ys = simt_matmul(gemm, qlin, x, layer)
            torch.cuda.synchronize()
            serr = (ys.float() - ref.float()).abs().max().item()
            check(serr <= tol, f"K6 SIMT {name} M={m}: max |kernel - plain| = {serr:.3e} > "
                               f"{tol:.3e}")
            simt = dict(simt_max_abs_err=serr, simt_ms=timer.ms(
                lambda: simt_matmul(gemm, qlin, x, layer), iters=iters))
        ms = timer.ms(lambda: qlin.matmul(x, layer), iters=iters)
        k1_ms = timer.ms(lambda: qlin.matmul(x, gptq), iters=iters)
        plain_ms = timer.ms(lambda: qlin.matmul_plain(x, layer), iters=min(iters, 5), warmup=1)
        lib_ms = timer.ms(lambda: torch.matmul(x, w), iters=iters)
        b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                     layer.kperm, layer.bias), 2.0 * m * k * n)
        plan = gemm.kb32l_plan(k, n, m, 128, sms)
        if plan["regime"] == "decode":
            per_sm = gemm.kb32l_blocks_per_sm(dtype, m, 128, plan["tiles_per_split"])
            resident = min(per_sm, -(-plan["blocks"] // sms))
            plan.update(nbuf=gemm.KB32L_NBUF, blocks_per_sm=per_sm,
                        weight_bytes_in_flight_per_sm=resident * min(
                            gemm.KB32L_NBUF, plan["tiles_per_split"]) * plan["stage_bytes"])
        rows.append(dict(case=name, K=k, N=n, M=m, bits=bits, desc_act=desc_act,
                         bias=with_bias, dtype=str(dtype), route=route, max_abs_err=err,
                         max_abs_ref=scale, tol=tol, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, plan=plan, **simt))
        print(f"K6 {name:14s} K={k:5d} N={n:5d} M={m:4d} {str(dtype)[6:]:8s} {route:4s} err "
              f"{err:.3e} (tol {tol:.3e})  kernel {ms:.4f} ms"
              + (f"  SIMT tile {simt['simt_ms']:.4f} ms" if simt else "")
              + f"  K1 {k1_ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"torch.matmul {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  plan {plan}",
              flush=True)
        del layer, gptq, w
    ptxas = ptxas_report(gemm.KB32L_KERNEL, "kb32l")
    print("K6 ptxas: " + "; ".join(f"{r['function']}: {r['registers']} registers, spill "
                                   f"{r['spill_stores']}/{r['spill_loads']} B"
                                   for r in ptxas), flush=True)
    return dict(rows=rows, ptxas=ptxas)


def phase_wna16(torch, np, timer) -> list:
    """K4, K5 and K1's other shape classes against their plain versions."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = {name: (k, n) for name, (k, n, _) in LAYER_SHAPES.items()}
    layers = [(bits, name, 128, False) for bits in (8, 2, 3) for name in shapes]
    layers += [(8, "down", 128, True), (2, "down", 128, True), (3, "qkvo", 128, True)]
    # K1 at the classes of the TPU's ki32 (one group, any K % 8 == 0) and kpair (any group
    # size 8 divides) kernels
    layers += [(4, "qkvo", -1, False), (4, "down", -1, False), (4, "qkvo", 16, False),
               (4, "gate_up", 64, False), (4, "down", 64, True), (3, "down", -1, False)]
    # K5 at the class of the TPU's kquad kernel (group sizes below 128), K4 at a small group
    layers += [(2, "qkvo", 64, False), (2, "down", 32, True), (8, "qkvo", 32, False)]
    rows = []
    for bits, name, gs, desc_act in layers:
        k, n = shapes[name]
        kernel = KERNEL_OF_BITS[bits]
        layer = _random_layer(qlin, rng, k, n, bits, gs, desc_act, torch.bfloat16)
        w = qlin.logical_weight(layer, torch.bfloat16)
        case = f"{bits}-bit {name} g{gs}" + ("+desc_act" if desc_act else "")
        for m in (1, BEAMS, 16, 17, 128):
            x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            key = kernel + ("_mma" if gemm.tile_kernel(x.dtype, m, k if gs == -1 else gs) == "mma"
                            else "")
            before = build.launches[key]
            y = qlin.matmul(x, layer)
            check(build.launches[key] == before + 1, f"{case} M={m}: {key} not launched")
            ref = qlin.matmul_plain(x, layer)
            y32 = qlin.matmul(x.float(), layer)
            ref32 = qlin.matmul_plain(x.float(), layer)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            err32 = (y32 - ref32).abs().max().item()
            check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(y32).all()),
                  f"{case} M={m}: non-finite output")
            check(err <= K1_REL_TOL * scale, f"{case} M={m} bf16: max |kernel - plain| = "
                                             f"{err:.3e} > {K1_REL_TOL} * {scale:.3e}")
            check(err32 <= F32_ABS_TOL * max(1.0, scale),
                  f"{case} M={m} f32: max |kernel - plain| = {err32:.3e} > {F32_ABS_TOL}")
            ms = timer.ms(lambda: qlin.matmul(x, layer), iters=10)
            plain_ms = timer.ms(lambda: qlin.matmul_plain(x, layer), iters=5, warmup=1)
            lib_ms = timer.ms(lambda: torch.matmul(x, w), iters=10)
            b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm), 2.0 * m * k * n)
            rows.append(dict(kernel=key, bits=bits, case=name, K=k, N=n, M=m, group_size=gs,
                             desc_act=desc_act, max_abs_err=err, max_abs_ref=scale,
                             max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
            print(f"{key} {case:26s} K={k:5d} N={n:5d} M={m:3d}  bf16 err {err:.3e} (tol "
                  f"{K1_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol {F32_ABS_TOL})  kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
        del layer, w
    return rows


# Rest-class layers at Llama-2-7B widths, one per storage width: group sizes that the codes
# per word do not divide (a word straddles groups), 4-bit gs 100 and 3-bit gs 12 with a
# partial last group, 4-bit gs 172 with desc_act. (bits, projection, group size, desc_act)
REST_LAYERS = ((4, "qkvo", 100, False), (3, "qkvo", 12, False), (2, "qkvo", 24, False),
               (8, "qkvo", 6, False), (4, "down", 172, True))


def phase_rest(torch, np, timer) -> list:
    """The rest classes on the card: each layer once through the decode
    regime (M = 1, the per-code group GEMV) and once through the tile regime
    (M = 128, the SIMT tile kernel: 16 divides none of these group sizes),
    and K10 at M = 128, bf16 (timed) and f32, against the plain versions."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = {name: (k, n) for name, (k, n, _) in LAYER_SHAPES.items()}
    rows = []
    for bits, name, gs, desc_act in REST_LAYERS:
        k, n = shapes[name]
        kernel = KERNEL_OF_BITS[bits]
        layer = _random_layer(qlin, rng, k, n, bits, gs, desc_act, torch.bfloat16)
        w = qlin.logical_weight(layer, torch.bfloat16)
        case = f"{bits}-bit {name} g{gs}" + ("+desc_act" if desc_act else "")
        for m, what in ((1, "forward"), (128, "forward"), (128, "K10")):
            x = torch.randn((m, n if what == "K10" else k), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            key = gemm.T_KERNEL if what == "K10" else kernel
            if what == "K10":
                def run(v):
                    return qlin.matmul_t(v, layer)

                def plain(v):
                    return gemm.wna16_matmul_t_ref(v, layer.qweight, layer.scales, layer.zeros,
                                                   layer.kperm, gs, qlin.storage_bits(bits))

                def lib():
                    return torch.matmul(x, w.t())
            else:
                def run(v):
                    return qlin.matmul(v, layer)

                def plain(v):
                    return qlin.matmul_plain(v, layer)

                def lib():
                    return torch.matmul(x, w)
            before = dict(build.launches)
            y = run(x)
            check(build.launches[key] == before.get(key, 0) + 1
                  and build.launches[key + "_mma"] == before.get(key + "_mma", 0),
                  f"rest class {case} {what} M={m}: launched {dict(build.launches)}")
            ref = plain(x)
            y32, ref32 = run(x.float()), plain(x.float())
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            err32 = (y32 - ref32).abs().max().item()
            check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(y32).all()),
                  f"rest class {case} {what} M={m}: non-finite output")
            tol = K10_REL_TOL if what == "K10" else K1_REL_TOL
            check(err <= tol * scale, f"rest class {case} {what} M={m} bf16: max |kernel - "
                                      f"plain| = {err:.3e} > {tol} * {scale:.3e}")
            check(err32 <= F32_ABS_TOL * max(1.0, scale), f"rest class {case} {what} M={m} f32: "
                                                          f"{err32:.3e} > {F32_ABS_TOL}")
            ms = timer.ms(lambda: run(x), iters=10)
            plain_ms = timer.ms(lambda: plain(x), iters=3, warmup=1)
            lib_ms = timer.ms(lib, iters=10)
            b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm), 2.0 * m * k * n)
            rows.append(dict(kernel=key, bits=bits, case=name, what=what, K=k, N=n, M=m,
                             group_size=gs, desc_act=desc_act, max_abs_err=err,
                             max_abs_ref=scale, max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
            print(f"rest class {key} {case:22s} {what:7s} K={k:5d} N={n:5d} M={m:3d}  bf16 err "
                  f"{err:.3e} (tol {tol * scale:.3e})  f32 err {err32:.3e} (tol "
                  f"{F32_ABS_TOL})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  torch.matmul "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
        del layer, w
    return rows


# Dynamic shared memory of the tensor-core kernels (csrc/wna16_mma.cuh): forward 4 stages of
# an x tile [128][72] halves, 64/P word rows of 128 words and 4 group rows of fp16 scales and
# uint8 zeros; K10 4 stages of a g tile [128][72], 128/P word rows of 64 words and 8 group
# rows, plus two sets of hi and lo B tiles [128][72].
def mma_smem_bytes(bits: int, transpose: bool) -> int:
    p = 32 // bits
    if transpose:
        return 4 * (128 * 72 * 2 + (128 // p) * 64 * 4 + 8 * 64 * 3) + 2 * 2 * 128 * 72 * 2
    return 4 * (128 * 72 * 2 + (64 // p) * 128 * 4 + 4 * 128 * 3)


def mma_ptxas() -> list:
    """ptxas' registers, spills and static shared memory of every tensor-core
    kernel instance, with its dynamic shared memory."""
    out = []
    for name, bits in (("w4a16_gemm", 4), ("w8a16_gemm", 8), ("w2a16_gemm", 2),
                       ("w4a16_kb32l_gemm", 4), ("wna16_gemm_t", None)):
        for r in ptxas_report(name, "mma_kernel"):
            b = bits
            if b is None:   # K10's library holds the three widths: ILi<BITS>E in the name
                b = next(x for x in (2, 4, 8) if f"ILi{x}E" in r["function"])
            r.update(library=name, dynamic_smem_bytes=mma_smem_bytes(b, "t_mma" in r["function"]))
            out.append(r)
    for r in out:
        print(f"ptxas {r['library']}: {r['function'][:70]}: {r['registers']} registers, spill "
              f"{r['spill_stores']}/{r['spill_loads']} B, static smem {r['smem']} B, dynamic "
              f"smem {r['dynamic_smem_bytes']} B", flush=True)
    return out


def phase_k10(torch, np, timer) -> list:
    """K10 against its plain version at the shapes of a training step; at
    M = 128 and 2048 the SIMT kernel beside the tensor-core one (bf16) on the
    same weights for the 4-bit rows (g128, desc_act, g32), both held to
    K10_REL_TOL and timed."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    shapes = {name: (k, n) for name, (k, n, _) in LAYER_SHAPES.items()}
    layers = [(bits, name, 128, False) for bits in (4, 2, 3, 8) for name in shapes]
    layers += [(4, "down", 128, True), (4, "qkvo", 32, False)]
    rows = []
    for bits, name, gs, desc_act in layers:
        k, n = shapes[name]
        layer = _random_layer(qlin, rng, k, n, bits, gs, desc_act, torch.bfloat16)
        w = qlin.logical_weight(layer, torch.bfloat16)
        case = f"{bits}-bit {name} g{gs}" + ("+desc_act" if desc_act else "")
        for m in (10, 17, 128, TRAIN_M):
            g = torch.randn((m, n), generator=gen, device="cuda", dtype=torch.bfloat16)
            route = gemm.tile_kernel(g.dtype, m, gs)
            key = gemm.T_KERNEL + (gemm.MMA_SUFFIX if route == "mma" else "")
            before = build.launches[key]
            dx = qlin.matmul_t(g, layer)
            check(build.launches[key] == before + 1, f"K10 {case} M={m}: {key} not launched")
            ref = gemm.wna16_matmul_t_ref(g, layer.qweight, layer.scales, layer.zeros,
                                          layer.kperm, gs, qlin.storage_bits(bits))
            dx32 = qlin.matmul_t(g.float(), layer)
            ref32 = gemm.wna16_matmul_t_ref(g.float(), layer.qweight, layer.scales, layer.zeros,
                                            layer.kperm, gs, qlin.storage_bits(bits))
            torch.cuda.synchronize()
            err = (dx.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            err32 = (dx32 - ref32).abs().max().item()
            check(dx.shape == (m, k) and bool(torch.isfinite(dx).all())
                  and bool(torch.isfinite(dx32).all()), f"K10 {case} M={m}: bad output")
            check(err <= K10_REL_TOL * scale, f"K10 {case} M={m} bf16: max |kernel - plain| = "
                                              f"{err:.3e} > {K10_REL_TOL} * {scale:.3e}")
            check(err32 <= F32_ABS_TOL * max(1.0, scale),
                  f"K10 {case} M={m} f32: max |kernel - plain| = {err32:.3e} > {F32_ABS_TOL}")
            iters = 5 if m == TRAIN_M else 10
            simt = {}
            if route == "mma" and bits == 4 and m >= 128:   # the SIMT kernel, same weights
                def simt_t():
                    return gemm.wna16_matmul_t(g, layer.qweight, layer.scales, layer.zeros,
                                               layer.kperm, gs, 4, kernel="simt")
                dxs = simt_t()
                torch.cuda.synchronize()
                serr = (dxs.float() - ref.float()).abs().max().item()
                check(serr <= K10_REL_TOL * scale, f"K10 SIMT {case} M={m}: max |kernel - "
                                                   f"plain| = {serr:.3e} > {K10_REL_TOL} * "
                                                   f"{scale:.3e}")
                simt = dict(simt_max_abs_err=serr,
                            simt_ms=timer.ms(simt_t, iters=iters, warmup=1))
            ms = timer.ms(lambda: qlin.matmul_t(g, layer), iters=iters, warmup=1)
            plain_ms = timer.ms(lambda: gemm.wna16_matmul_t_ref(
                g, layer.qweight, layer.scales, layer.zeros, layer.kperm, gs,
                qlin.storage_bits(bits)), iters=3, warmup=1)
            lib_ms = timer.ms(lambda: torch.matmul(g, w.t()), iters=iters, warmup=1)
            b_ms, b_by = bound_ms(nbytes(g, dx, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm), 2.0 * m * k * n)
            rows.append(dict(bits=bits, case=name, K=k, N=n, M=m, group_size=gs,
                             desc_act=desc_act, route=route, max_abs_err=err, max_abs_ref=scale,
                             max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             tflops=2.0 * m * k * n / ms / 1e9, **simt))
            print(f"K10 {case:24s} K={k:5d} N={n:5d} M={m:4d} {route:4s}  bf16 err {err:.3e} "
                  f"(tol {K10_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol {F32_ABS_TOL})  "
                  f"kernel {ms:.4f} ms ({2.0 * m * k * n / ms / 1e9:.2f} TFLOP/s)"
                  + (f"  SIMT {simt['simt_ms']:.4f} ms (err {simt['simt_max_abs_err']:.3e})"
                     if simt else "")
                  + f"  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound "
                    f"{b_ms:.4f} ms ({b_by})", flush=True)
        del layer, w
    # K10 over K6's kb32l words (a backward through a kb32l layer)
    k, n = shapes["gate_up"]
    layer = _random_layer(qlin, rng, k, n, 4, 128, False, torch.bfloat16, layout="kb32l")
    words, s, z = qlin.gptq_tensors(layer)
    w = qlin.logical_weight(layer, torch.bfloat16)
    for m in (64, TRAIN_M):
        g = torch.randn((m, n), generator=gen, device="cuda", dtype=torch.bfloat16)
        route = gemm.tile_kernel(g.dtype, m, 128)
        key = gemm.T_KERNEL + (gemm.MMA_SUFFIX if route == "mma" else "")
        before = build.launches[key]
        dx = qlin.matmul_t(g, layer)
        check(build.launches[key] == before + 1, f"K10 kb32l M={m}: {key} not launched")
        ref = gemm.wna16_matmul_t_ref(g, words, s, z, None, 128, 4)
        dx32 = qlin.matmul_t(g.float(), layer)
        ref32 = gemm.wna16_matmul_t_ref(g.float(), words, s, z, None, 128, 4)
        torch.cuda.synchronize()
        err = (dx.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        err32 = (dx32 - ref32).abs().max().item()
        check(dx.shape == (m, k) and bool(torch.isfinite(dx).all()), f"K10 kb32l M={m}: bad output")
        check(err <= K10_REL_TOL * scale, f"K10 kb32l M={m} bf16: max |kernel - plain| = "
                                          f"{err:.3e} > {K10_REL_TOL} * {scale:.3e}")
        check(err32 <= F32_ABS_TOL * max(1.0, scale),
              f"K10 kb32l M={m} f32: max |kernel - plain| = {err32:.3e} > {F32_ABS_TOL}")
        ms = timer.ms(lambda: qlin.matmul_t(g, layer), iters=5, warmup=1)
        plain_ms = timer.ms(lambda: gemm.wna16_matmul_t_ref(g, words, s, z, None, 128, 4),
                            iters=3, warmup=1)
        lib_ms = timer.ms(lambda: torch.matmul(g, w.t()), iters=5, warmup=1)
        b_ms, b_by = bound_ms(nbytes(g, dx, layer.qweight, layer.scales, layer.zeros),
                              2.0 * m * k * n)
        rows.append(dict(bits=4, case="gate_up kb32l", K=k, N=n, M=m, group_size=128,
                         desc_act=False, layout="kb32l", route=route, max_abs_err=err,
                         max_abs_ref=scale,
                         max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, tflops=2.0 * m * k * n / ms / 1e9))
        print(f"K10 4-bit gate_up g128 kb32l    K={k:5d} N={n:5d} M={m:4d}  bf16 err {err:.3e} "
              f"(tol {K10_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol {F32_ABS_TOL})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
    return rows


def phase_k9(torch, np, timer) -> list:
    """K9 against its plain version at Mixtral-8x7B's expert shapes, E = 8."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for name, (k, n, _) in MIXTRAL_SHAPES.items():
        sql = qlin.stack_experts([_random_layer(qlin, rng, k, n, 4, 128, False, torch.bfloat16)
                                  for _ in range(8)])
        dense = [qlin.logical_weight(sql.expert(e), torch.bfloat16) for e in range(8)]
        per_expert = nbytes(sql.qweight[0], sql.scales[0], sql.zeros[0])
        for p, ids in K9_SELS.items():
            sel = torch.tensor(ids, dtype=torch.int32, device="cuda")
            x = torch.randn((p, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            before = build.launches[gemm.ROUTED_KERNEL]
            y = qlin.matmul_routed(x, sql, sel)
            check(build.launches[gemm.ROUTED_KERNEL] == before + 1, f"K9 {name} P={p}: not launched")
            ref = gemm.wna16_routed_matmul_ref(x, sel, sql.qweight, sql.scales, sql.zeros, 128)
            y32 = qlin.matmul_routed(x.float(), sql, sel)
            ref32 = gemm.wna16_routed_matmul_ref(x.float(), sel, sql.qweight, sql.scales,
                                                 sql.zeros, 128)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            err32 = (y32 - ref32).abs().max().item()
            check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(y32).all()),
                  f"K9 {name} P={p}: non-finite output")
            check(err <= K1_REL_TOL * scale, f"K9 {name} P={p} bf16: max |kernel - plain| = "
                                             f"{err:.3e} > {K1_REL_TOL} * {scale:.3e}")
            check(err32 <= F32_ABS_TOL * max(1.0, scale),
                  f"K9 {name} P={p} f32: max |kernel - plain| = {err32:.3e} > {F32_ABS_TOL}")
            ms = timer.ms(lambda: qlin.matmul_routed(x, sql, sel, check=False))
            plain_ms = timer.ms(lambda: gemm.wna16_routed_matmul_ref(
                x, sel, sql.qweight, sql.scales, sql.zeros, 128), iters=5, warmup=1)
            # no single PyTorch call computes a routed product without a gather: P
            # torch.matmul calls on pre-dequantized bf16 experts, timed only
            lib_ms = timer.ms(lambda: [torch.matmul(x[i], dense[e]) for i, e in enumerate(ids)])
            # the least the card could move: each selected expert once, x, y and sel
            b_ms, b_by = bound_ms(len(set(ids)) * per_expert + nbytes(x, y, sel),
                                  2.0 * p * k * n)
            rows.append(dict(case=name, K=k, N=n, P=p, sel=ids, max_abs_err=err,
                             max_abs_ref=scale, max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
            print(f"K9 {name:8s} K={k:5d} N={n:5d} E=8 P={p} sel={ids}  bf16 err {err:.3e} "
                  f"(tol {K1_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol {F32_ABS_TOL})  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  {p} x torch.matmul "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
        if name == "gate_up":
            refuse_bad_experts(torch, gemm, sql, gen)
        del sql, dense
        torch.cuda.empty_cache()
    return rows


def refuse_bad_experts(torch, gemm, sql, gen) -> None:
    """A pair naming expert -1 or E writes nothing and sets the flag; the good
    pairs of the same launch are right; check=True raises ValueError."""
    x = torch.randn((3, sql.in_features), generator=gen, device="cuda", dtype=torch.bfloat16)
    for bad in (-1, sql.num_experts):
        sel = torch.tensor([2, bad, 6], dtype=torch.int32, device="cuda")
        out = torch.full((3, sql.out_features), 7.0, device="cuda", dtype=torch.bfloat16)
        gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 128, check=False,
                                 out=out)
        torch.cuda.synchronize()
        check(bool((out[1] == 7.0).all()), f"K9 expert id {bad}: its row was written")
        good = torch.tensor([0, 2], device="cuda")
        ref = gemm.wna16_routed_matmul_ref(x[good], sel[good], sql.qweight, sql.scales,
                                           sql.zeros, 128)
        check((out[good].float() - ref.float()).abs().max().item()
              <= K1_REL_TOL * ref.float().abs().max().item(),
              f"K9 expert id {bad}: the good pairs of the launch are wrong")
        for what, call in (("flag", lambda: gemm.check_routed_errors("cuda")),
                           ("check=True", lambda: gemm.wna16_routed_matmul(
                               x, sel, sql.qweight, sql.scales, sql.zeros, 128))):
            try:
                call()
            except ValueError:
                continue
            raise SmokeFailure(f"K9 expert id {bad}: {what} raised no ValueError")
    print("K9 bad expert ids (-1 and E): the pair's row is left as it was, the other pairs of "
          "the launch are right, the flag is set and check=True raises ValueError", flush=True)


def boundary_cost(torch, np) -> dict:
    """Host microseconds per call of ``quantlinear.matmul`` (through the
    autograd Function) and of the K1 wrapper it calls, at M = 1 under
    inference_mode, on a 256 x 256 layer whose device time stays below the
    host's: the cost of the autograd boundary on the host-bound decode path."""
    from autogptq_tpu_torch.ops import gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    layer = _random_layer(qlin, np.random.default_rng(11), 256, 256, 4, 128, False,
                          torch.bfloat16)
    x = torch.randn((1, 1, 256), device="cuda", dtype=torch.bfloat16)

    def wrapper():
        gemm.wna16_matmul(x.reshape(-1, 256), layer.qweight, layer.scales, layer.zeros, None,
                          None, 128, 4)

    calls, us = 2000, {"matmul": [], "wrapper": []}
    with torch.inference_mode():
        for name, fn in (("matmul", lambda: qlin.matmul(x, layer)), ("wrapper", wrapper)) * 2:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            us[name].append((time.perf_counter() - t0) / calls * 1e6)
    out = {k: min(v) for k, v in us.items()}
    print(f"host cost per call at M=1 under inference_mode (256 x 256 layer, best of two runs of "
          f"{calls}): quantlinear.matmul through the autograd Function {out['matmul']:.2f} us, "
          f"the K1 wrapper alone {out['wrapper']:.2f} us", flush=True)
    return out


def masked_loss(torch, logits, labels):
    """The masked causal-LM loss of examples/peft/peft_lora_clm_instruction_tuning.py:
    next-token NLL averaged over the labels that are not -100."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = labels[:, 1:].clamp_min(0)
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    m = (labels[:, 1:] != -100).float()
    return (nll * m).sum() / m.sum().clamp_min(1)


def phase_train(torch, np, model, work: str) -> dict:
    """LoRA training on the full-depth model: 8 AdamW steps, a profiled
    step, save_adapter and generate with the adapters in place."""
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.utils import peft

    cfg = model.cfg
    layers = cfg.num_layers
    pcfg = peft.GPTQLoraConfig(r=TRAIN_RANK, lora_alpha=2 * TRAIN_RANK,
                               target_modules=("attn.q_proj", "attn.v_proj"))
    peft.get_gptq_peft_model(model, pcfg, seed=0)
    trainable = peft.trainable_tensors(peft.split_lora_params(model.params)[0])
    check(len(trainable) == 4 * layers, f"{len(trainable)} trainable tensors")
    opt = torch.optim.AdamW(trainable, lr=TRAIN_LR)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, cfg.vocab_size, (TRAIN_BATCH, TRAIN_LEN))
    mask = np.ones_like(tokens)
    mask[1, :TRAIN_PAD] = 0
    tokens[1, :TRAIN_PAD] = 0
    labels = np.where(mask == 1, tokens, -100)
    tokens_t = torch.from_numpy(tokens).cuda()
    mask_t = torch.from_numpy(mask).to(torch.int32).cuda()
    labels_t = torch.from_numpy(labels).cuda()

    def step():
        logits, _ = arch.forward(model.params, tokens_t, cfg, attn_mask=mask_t, dtype=model.dtype)
        loss = masked_loss(torch, logits, labels_t)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.item()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, counts = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        build.launches.clear()
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(dict(build.launches))
        print(f"train step {i + 1}: loss {losses[-1]:.6f}, {seconds[-1]:.3f} s, launches "
              f"{counts[-1]}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    check(bool(np.all(np.isfinite(losses))), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    # every projection is a bf16 product of 2048 rows: the tensor-core kernels, no SIMT tile
    for c in counts:
        check(c.get("w4a16_gemm_mma", 0) == 7 * layers and not c.get("w4a16_gemm", 0),
              f"a training step launched K1 {c}")
        check(c.get(gemm.T_KERNEL + gemm.MMA_SUFFIX, 0) >= 7 * (layers - 1)
              and not c.get(gemm.T_KERNEL, 0), f"a training step launched K10 {c}")
    steady = float(np.median(seconds[1:]))
    tok_s = TRAIN_BATCH * TRAIN_LEN / steady
    print(f"train: LoRA r={TRAIN_RANK} alpha={2 * TRAIN_RANK} on q_proj and v_proj, Llama-2-7B "
          f"4-bit g128, {layers} layers (full depth), batch {TRAIN_BATCH} x {TRAIN_LEN} tokens "
          f"(row 1 left-padded by {TRAIN_PAD}), AdamW lr {TRAIN_LR}: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; {steady:.3f} s/step (median of steps 2-{TRAIN_STEPS}; step 1 "
          f"{seconds[0]:.3f} s) = {tok_s:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches per step {counts[-1]}", flush=True)
    split = profile_train_step(torch, step)
    check(not split or ("K1 tensor-core tile" in split["instances"]
                        and "K10 tensor-core" in split["instances"]
                        and "K1 SIMT tile" not in split["instances"]
                        and "K10 SIMT" not in split["instances"]),
          f"the profiled training step ran {split.get('instances')}")

    adapter_dir = os.path.join(work, "adapter")
    peft.save_adapter(model, adapter_dir)
    from safetensors import safe_open

    with safe_open(os.path.join(adapter_dir, "adapter_model.safetensors"), framework="np") as f:
        names = list(f.keys())
        a0 = f.get_tensor("base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight")
    check(len(names) == 4 * layers and a0.shape == (TRAIN_RANK, cfg.hidden_size),
          f"save_adapter wrote {len(names)} tensors, lora_A {a0.shape}")
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    build.launches.clear()
    first = model.generate(prompt, max_new_tokens=TRAIN_NEW_TOKENS)
    gen_counts = dict(build.launches)
    again = model.generate(prompt, max_new_tokens=TRAIN_NEW_TOKENS)
    check(first.shape == (1, PROMPT_LEN + TRAIN_NEW_TOKENS), f"generate shape {first.shape}")
    check(np.array_equal(first, again), "generate with adapters does not repeat its tokens")
    check(gen_counts.get("w4a16_gemm", 0) > 0 and gen_counts.get("flash_decode", 0) > 0,
          f"generate with adapters launched {gen_counts}")
    print(f"save_adapter: {len(names)} tensors; generate with the trained adapters, "
          f"{TRAIN_NEW_TOKENS} greedy tokens, twice with equal tokens: "
          f"{first[0, PROMPT_LEN:].tolist()}, launches {gen_counts}", flush=True)
    return dict(losses=losses, seconds=seconds, s_per_step=steady, tokens_per_s=tok_s,
                peak_bytes=peak, launches_per_step=counts[-1], profile=split,
                generate_launches=gen_counts, adapter_tensors=len(names))


def profile_train_step(torch, step) -> dict:
    """Device time of one training step by family from torch.profiler's
    kernel events: K1, K10 by kernel name, each split by kernel instance
    (tensor-core tile kernel, SIMT tile kernel, GEMV); attention, the kernels
    launched by the ops inside ``arch.attention``'s "attention" range and by
    their backward nodes (matched on sequence number); the rest is other."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()

    def family(name):
        if any(k in name for k in K10_KEYS):
            return "K10"
        if any(k in name for k in K1_KEYS):
            return "K1"
        return None

    split = dict(K1=0.0, K10=0.0, attention=0.0, other=0.0)
    instances: dict = {}      # kernel instance (KERNEL_INSTANCES) -> [launches, ms]
    kernels = 0
    for evt in events:
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        kernels += 1
        ms = evt.time_range.elapsed_us() / 1e3
        split[family(evt.name) or "other"] += ms
        inst = next((label for label, key in KERNEL_INSTANCES if key in evt.name), None)
        if inst is not None:
            instances.setdefault(inst, [0, 0.0])
            instances[inst][0] += 1
            instances[inst][1] += ms

    def walk(evt):
        yield evt
        for child in evt.cpu_children:
            yield from walk(child)

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = [e for e in cpu if e.name == "attention"]
    fwd = {(d.thread, d.sequence_nr) for r in ranges for d in walk(r) if d.sequence_nr >= 0}
    roots = ranges + [e for e in cpu if e.name.startswith("autograd::engine::evaluate_function")
                      and (e.fwd_thread, e.sequence_nr) in fwd]
    attention = sum(k.duration for r in roots for d in walk(r) for k in d.kernels
                    if family(k.name) is None) / 1e3
    busy = sum(split.values())
    if not kernels:
        print("profile, training step: torch.profiler recorded no CUDA kernel events; device "
              "split not measured", flush=True)
        return {}
    if ranges:
        split["attention"] = attention
        split["other"] -= attention
    print(f"profile, one training step (loss {loss:.6f}): device {busy:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" if (k != "attention" or ranges) else f"{k} not measured"
                      for k, v in split.items())
          + f"), {kernels} kernels; host clock {wall_ms:.1f} ms under the profiler (device busy "
          f"{100 * busy / wall_ms:.1f}%); by kernel instance: "
          + ", ".join(f"{k} {n} launches {v:.1f} ms" for k, (n, v) in instances.items()),
          flush=True)
    return dict(device_ms=busy, wall_ms=wall_ms, kernels=kernels,
                attention_measured=bool(ranges), instances=instances,
                **{f"{k}_ms": v for k, v in split.items()})


def _draw_adapters(torch, np, tensors, seed) -> None:
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in tensors:
            t.copy_(torch.from_numpy(np.asarray(rng.standard_normal(t.shape) * ADAPTER_STD,
                                                np.float32)))


def phase_grads(torch, np, ckpt_dir: str) -> dict:
    """Adapter gradients of the three kinds, card (bf16, and f32) against CPU
    (f32), on a 2-layer full-width cut; one AdamW step of each kind on the card."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.utils import peft
    from autogptq_tpu_torch.utils.hf_io import load_hf_config

    kinds = {"LoRA": peft.GPTQLoraConfig(r=TRAIN_RANK, lora_alpha=2 * TRAIN_RANK),
             "AdaLoRA": peft.GPTQLoraConfig(r=TRAIN_RANK, lora_alpha=2 * TRAIN_RANK, adalora=True),
             "adaption prompt": peft.AdaptionPromptConfig(adapter_len=10, adapter_layers=2)}
    vocab = load_hf_config(ckpt_dir)["vocab_size"]
    tokens = torch.from_numpy(np.random.default_rng(6).integers(1, vocab, (1, GRAD_LEN)))
    runs = (("card bf16", "cuda", torch.bfloat16), ("card f32", "cuda", torch.float32),
            ("cpu", "cpu", torch.float32))
    grads = {kind: {} for kind in kinds}
    out = {kind: {} for kind in kinds}
    for run, device, dtype in runs:
        model = AutoGPTQForCausalLM.from_quantized(ckpt_dir, device=device, dtype=dtype)
        base = model.params
        toks = tokens.to(device)
        for i, (kind, pcfg) in enumerate(kinds.items()):
            model.params = base
            peft.get_gptq_peft_model(model, pcfg, seed=0)
            leaves = peft.trainable_tensors(peft.split_lora_params(model.params)[0])
            _draw_adapters(torch, np, leaves, seed=20 + i)
            loss = masked_loss(torch, arch.forward(model.params, toks, model.cfg, dtype=dtype)[0],
                               toks)
            build.launches.clear()
            loss.backward()
            grads[kind][run] = [t.grad.float().cpu() for t in leaves]
            if device == "cpu":
                continue
            torch.cuda.synchronize()
            counts = dict(build.launches)
            key = gemm.T_KERNEL + (gemm.MMA_SUFFIX if dtype == torch.bfloat16 else "")
            check(counts.get(key, 0) > 0, f"{kind} backward on the card ({run}) launched {counts}")
            out[kind][f"{run} backward_launches"] = counts
            if dtype != torch.bfloat16:
                continue
            torch.optim.AdamW(leaves, lr=TRAIN_LR).step()
            with torch.no_grad():
                after = masked_loss(torch, arch.forward(model.params, toks, model.cfg,
                                                        dtype=dtype)[0], toks).item()
            check(np.isfinite(loss.item()) and np.isfinite(after),
                  f"{kind}: loss {loss.item()} -> {after} after one step")
            out[kind].update(loss=loss.item(), loss_after_step=after)
        del model, base
        torch.cuda.empty_cache()
    for kind in kinds:
        cpu = grads[kind]["cpu"]
        errs = {}
        for run, tol in (("card bf16", GRAD_REL_TOL), ("card f32", GRAD_F32_REL_TOL)):
            rels = [((a - b).norm() / b.norm()).item() for a, b in zip(grads[kind][run], cpu)]
            check(all(np.isfinite(rels)) and max(rels) <= tol,
                  f"{kind}: {run} vs CPU adapter gradient relative error {max(rels):.3e} > {tol}")
            errs[run] = (max(rels), float(np.median(rels)),
                         list(cpu[int(np.argmax(rels))].shape))
            out[kind][f"{run} max_rel_err"], out[kind][f"{run} median_rel_err"], \
                out[kind][f"{run} worst_shape"] = errs[run]
        out[kind]["tensors"] = len(cpu)
        print(f"{kind} gradients vs the CPU (f32, plain), 2 full-width layers, 1 x {GRAD_LEN} "
              f"tokens, {len(cpu)} adapter tensors: card bf16 (K1 + K10, K10 launched "
              f"{out[kind]['card bf16 backward_launches']} in the backward) "
              f"relative error max {errs['card bf16'][0]:.3e} (a tensor of shape "
              f"{errs['card bf16'][2]}) median {errs['card bf16'][1]:.3e} "
              f"(tol {GRAD_REL_TOL}); card f32 max {errs['card f32'][0]:.3e} median "
              f"{errs['card f32'][1]:.3e} (tol {GRAD_F32_REL_TOL}); one AdamW step on the card: "
              f"loss {out[kind]['loss']:.6f} -> {out[kind]['loss_after_step']:.6f}", flush=True)
    return out


def phase_other_widths(torch, np, work: str) -> dict:
    """2-, 3- and 8-bit checkpoints generate through K5, K1 and K4."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B, write_random_checkpoint

    cfg = dict(LLAMA2_7B, num_hidden_layers=OTHER_WIDTH_LAYERS)
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    out = {}
    for bits in (2, 3, 8):
        path = os.path.join(work, f"llama2-7b-random-{bits}bit-g128")
        write_random_checkpoint(path, cfg, bits=bits, group_size=128, seed=bits)
        model = AutoGPTQForCausalLM.from_quantized(path)
        model.generate(prompt, max_new_tokens=4)
        torch.cuda.synchronize()
        build.launches.clear()
        t0 = time.perf_counter()
        first = model.generate(prompt, max_new_tokens=OTHER_WIDTH_TOKENS)
        gen_s = time.perf_counter() - t0
        counts = dict(build.launches)
        t0 = time.perf_counter()
        again = model.generate(prompt, max_new_tokens=OTHER_WIDTH_TOKENS)
        again_s = time.perf_counter() - t0
        kernel = KERNEL_OF_BITS[bits]
        need = 7 * OTHER_WIDTH_LAYERS * (OTHER_WIDTH_TOKENS - 1)
        new = first[:, PROMPT_LEN:]
        check(first.shape == (1, PROMPT_LEN + OTHER_WIDTH_TOKENS), f"{bits}-bit output shape")
        check(bool(((new >= 0) & (new < cfg["vocab_size"])).all()), f"{bits}-bit ids out of range")
        check(np.array_equal(first, again), f"{bits}-bit greedy decode does not repeat its tokens")
        check(counts.get(kernel, 0) >= need,
              f"{bits}-bit: {kernel} launched {counts.get(kernel, 0)} times, need >= {need}")
        others = set(KERNEL_OF_BITS.values()) - {kernel}
        check(not any(counts.get(o, 0) for o in others), f"{bits}-bit run launched {counts}")
        tok_s = OTHER_WIDTH_TOKENS / gen_s
        # two prompts: a 32-row prefill through the width's tensor-core tile kernel
        build.launches.clear()
        out2 = model.generate([prompt[0], prompt[0][::-1].copy()], max_new_tokens=4)
        counts2 = dict(build.launches)
        check(out2.shape == (2, PROMPT_LEN + 4), f"{bits}-bit batch-2 output shape {out2.shape}")
        check(counts2.get(kernel + "_mma", 0) == 7 * OTHER_WIDTH_LAYERS
              and counts2.get(kernel, 0) == 7 * OTHER_WIDTH_LAYERS * 3,
              f"{bits}-bit batch-2 launches {counts2}")
        out[bits] = dict(counts=counts, gen_s=gen_s, repeat_s=again_s, tok_s=tok_s,
                         layers=OTHER_WIDTH_LAYERS, batch2_counts=counts2)
        print(f"{bits}-bit g128, Llama-2-7B widths, {OTHER_WIDTH_LAYERS} of 32 layers, batch 1, "
              f"{PROMPT_LEN}-token prompt, {OTHER_WIDTH_TOKENS} new tokens greedy, twice with "
              f"equal tokens: {gen_s:.3f} s = {tok_s:.2f} tok/s at this depth (repeat "
              f"{again_s:.3f} s), launches {counts}; batch 2 (a {2 * PROMPT_LEN}-row prefill), 4 "
              f"new tokens: launches {counts2}", flush=True)
        del model
        torch.cuda.empty_cache()
        shutil.rmtree(path, ignore_errors=True)
    return out


def rtn_objective(torch, w, h, cfg) -> float:
    """``tr(E H E^T)`` of round-to-nearest on ``w [N, K]`` with per-group
    ranges from the same search the solver uses; ``H = 2/n X^T X``, so this is
    ``2/n |X (W - W_rtn)^T|^2`` on the calibration inputs."""
    from autogptq_tpu_torch.quantization.quantizer import find_params, quantize_rtn

    n, k = w.shape
    gs = cfg.group_size if cfg.group_size != -1 else k
    rows = w.float().reshape(n * (k // gs), gs)
    scale, zero = find_params(rows, cfg.quantizer())
    q = quantize_rtn(rows, scale[:, None], zero[:, None], cfg.maxq).reshape(n, k)
    return objective(torch, q - w.float(), h)


def objective(torch, e, h) -> float:
    return float(((e @ h.float()) * e).sum())


def phase_quantize(torch, np, work: str) -> dict:
    """quantize -> save_quantized -> from_quantized on the card, full width."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM, BaseQuantizeConfig
    from autogptq_tpu_torch.models import base
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.quantization.gptq import full_fp32_matmul
    from autogptq_tpu_torch.utils.data import random_calibration_examples
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B, write_random_fp_checkpoint

    cfg = dict(LLAMA2_7B, num_hidden_layers=QUANT_LAYERS)
    fp_dir = os.path.join(work, f"llama2-7b-random-fp16-{QUANT_LAYERS}layers")
    t0 = time.perf_counter()
    write_random_fp_checkpoint(fp_dir, cfg, seed=0)
    print(f"quantize: random fp16 checkpoint, Llama-2-7B widths, {QUANT_LAYERS} layers, written "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    examples = random_calibration_examples(cfg["vocab_size"], n=CALIB_SEQS, seqlen=CALIB_LEN,
                                           seed=0)
    tokens = (np.arange(24) * 37 % cfg["vocab_size"])[None]      # M = 24: the tile kernel
    fp = AutoGPTQForCausalLM.from_pretrained(fp_dir, dtype=torch.float16)
    check(fp.device.type == "cuda", "from_pretrained did not default to the card")
    fp_logits = fp.forward(tokens)
    del fp

    # hold every solve against round-to-nearest on the Hessian it was given
    solves = []
    real_solver = base.gptq_quantize

    def solver(w, h, gcfg):
        res = real_solver(w, h, gcfg)
        with full_fp32_matmul():
            solves.append((objective(torch, res.qweight - w.float(), h),
                           rtn_objective(torch, w, h, gcfg)))
        return res

    out = {}
    configs = [("4-bit g128", dict(bits=4)), ("4-bit g128 desc_act", dict(bits=4, desc_act=True)),
               ("2-bit g128", dict(bits=2)), ("3-bit g128", dict(bits=3)),
               ("8-bit g128", dict(bits=8))]
    base.gptq_quantize = solver
    try:
        for label, kw in configs:
            qc = BaseQuantizeConfig(group_size=128, sym=True, **dict(dict(desc_act=False), **kw))
            model = AutoGPTQForCausalLM.from_pretrained(fp_dir, qc, dtype=torch.float16)
            del solves[:]
            build.launches.clear()
            torch.cuda.reset_peak_memory_stats()
            model.quantize(examples, batch_size=CALIB_BATCH)
            counts = dict(build.launches)
            peak = torch.cuda.max_memory_allocated()
            stats = model.quantize_stats
            losses = list(stats["losses"].values())
            kernel = KERNEL_OF_BITS[qc.bits]
            check(len(losses) == 7 * QUANT_LAYERS and bool(np.all(np.isfinite(losses))),
                  f"quantize {label}: solver losses {losses}")
            check(counts.get(kernel, 0) >= 7 * QUANT_LAYERS * (CALIB_SEQS // CALIB_BATCH),
                  f"quantize {label}: the re-forward launched {counts}")
            check(len(solves) == 4 * QUANT_LAYERS, f"quantize {label}: {len(solves)} solves")
            for i, (gptq_obj, rtn_obj) in enumerate(solves):
                check(gptq_obj < rtn_obj, f"quantize {label}: solve {i} does not beat "
                                          f"round-to-nearest ({gptq_obj:.4e} >= {rtn_obj:.4e})")
            ratio = float(np.mean([g / r for g, r in solves]))

            q_dir = os.path.join(work, "quantized")
            t0 = time.perf_counter()
            model.save_quantized(q_dir)
            save_s = time.perf_counter() - t0
            name = f"gptq_model-{qc.bits}bit-128g.safetensors"
            check(os.path.isfile(os.path.join(q_dir, name)), f"quantize {label}: no {name}")
            logits = model.forward(tokens)
            reloaded = AutoGPTQForCausalLM.from_quantized(q_dir, dtype=torch.float16)
            check(torch.equal(reloaded.forward(tokens), logits),
                  f"quantize {label}: reloaded logits differ from the in-memory model's")
            gen = reloaded.generate(tokens[:, :PROMPT_LEN], max_new_tokens=8)
            check(gen.shape == (1, PROMPT_LEN + 8), f"quantize {label}: generate shape")
            check(bool(torch.isfinite(logits).all()), f"quantize {label}: non-finite logits")
            rel = ((logits - fp_logits).norm() / fp_logits.norm()).item()
            per_layer = {k: v / QUANT_LAYERS for k, v in stats["phases"].items()}
            out[label] = dict(bits=qc.bits, desc_act=qc.desc_act, seconds=stats["seconds"],
                              s_per_layer=per_layer, mean_loss=float(np.mean(losses)),
                              gptq_over_rtn=ratio, rel_logit_err=rel, launches=counts,
                              save_s=save_s, peak_bytes=peak)
            print(f"quantize {label}: {stats['seconds']:.1f} s for {QUANT_LAYERS} layers = "
                  f"{stats['seconds'] / QUANT_LAYERS:.1f} s/layer ("
                  + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per_layer.items()))
                  + f"); mean solver loss {np.mean(losses):.4f}; GPTQ / round-to-nearest "
                  f"objective {ratio:.3f} (below 1 on all {len(solves)} solves); saved in "
                  f"{save_s:.1f} s, reloaded logits bit-equal; relative logit error against the "
                  f"fp16 model {rel:.4f}; peak device memory {peak / 2**30:.2f} GiB; launches "
                  f"{counts}", flush=True)
            del model, reloaded
            torch.cuda.empty_cache()
            shutil.rmtree(q_dir, ignore_errors=True)
    finally:
        base.gptq_quantize = real_solver
    errs = [out[f"{b}-bit g128"]["rel_logit_err"] for b in (2, 3, 4, 8)]
    check(all(a > b for a, b in zip(errs, errs[1:])),
          f"logit error against the fp model does not fall from 2 to 8 bits: {errs}")
    shutil.rmtree(fp_dir, ignore_errors=True)
    return out


K2_WINDOWS = (17, 64, 272, 528)   # live slots swept: a 512-token run attends 17 .. 527


def phase_k2(torch, timer) -> list:
    """K2 against its plain version at 528 slots (B1 MHA, B2 left-padded,
    GQA), over the window sweep (MHA and GQA) and at Mixtral-8x7B's decode
    shape; each case twice with bit-equal results, timed beside SDPA."""
    import torch.nn.functional as F

    from autogptq_tpu_torch.ops import flash_decode as fdm

    gen = torch.Generator(device="cuda").manual_seed(2)
    s, d, layers, layer = 528, 128, 2, 1
    mixtral_s = PROMPT_LEN + MIXTRAL_NEW_TOKENS
    cases = [("B1 MHA", 1, 32, 32, s, [0], [s]),
             ("B2 left-pad", 2, 32, 32, s, [0, 7], [s, s]),
             ("B1 GQA 32/8", 1, 32, 8, s, [0], [s])]
    cases += [(f"{kind} window {w}", 1, 32, hkv, s, [0], [w])
              for kind, hkv in (("B1 MHA", 32), ("B1 GQA 32/8", 8)) for w in K2_WINDOWS]
    cases.append(("Mixtral B1 32/8", 1, 32, 8, mixtral_s, [0], [mixtral_s]))
    rows = []
    for name, b, h, hkv, s, lo_l, hi_l in cases:
        q = torch.randn((b, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        kc = torch.randn((layers, b, s, hkv, d), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        vc = torch.randn(kc.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        lo = torch.tensor(lo_l, dtype=torch.int32, device="cuda")
        hi = torch.tensor(hi_l, dtype=torch.int32, device="cuda")
        scale = d ** -0.5
        o = fdm.flash_decode(q, kc, vc, lo, hi, layer=layer, sm_scale=scale)
        again = fdm.flash_decode(q, kc, vc, lo, hi, layer=layer, sm_scale=scale)
        ref = fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=layer, sm_scale=scale)
        torch.cuda.synchronize()
        err = (o - ref).abs().max().item()
        check(bool(torch.isfinite(o).all()), f"K2 {name}: non-finite output")
        check(err <= K2_ABS_TOL, f"K2 {name}: max |kernel - plain| = {err:.3e} > {K2_ABS_TOL}")
        check(torch.equal(o, again), f"K2 {name}: two calls on the same inputs differ")
        rep = h // hkv
        kl = kc[layer].permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
        vl = vc[layer].permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
        pos = torch.arange(s, device="cuda")
        mask = ((pos[None] >= lo[:, None]) & (pos[None] < hi[:, None]))[:, None, None, :]
        q4 = q[:, :, None, :]
        ms = timer.ms(lambda: fdm.flash_decode(q, kc, vc, lo, hi, layer=layer, sm_scale=scale))
        plain_ms = timer.ms(lambda: fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=layer,
                                                         sm_scale=scale))
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask,
                                                                 scale=scale))
        live = sum(max(0, min(e, s) - a) for a, e in zip(lo_l, hi_l))
        kv_bytes = 2 * live * hkv * d * kc.element_size()
        b_ms, b_by = bound_ms(kv_bytes + nbytes(q, o, lo, hi), 4.0 * live * h * d)
        chunk, n_split = fdm.split_plan(b, hkv, s)
        rows.append(dict(case=name, B=b, H=h, Hkv=hkv, S=s, D=d, live_slots=live,
                         chunk=chunk, n_split=n_split, blocks=b * hkv * n_split,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"K2 {name:22s} B={b} H={h} Hkv={hkv} S={s} D={d} live={live:4d}  plan "
              f"{n_split} x {chunk} slots ({b * hkv * n_split} blocks)  err {err:.3e} (tol "
              f"{K2_ABS_TOL}), repeat bit-equal  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"sdpa {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
    return rows


def _live_kv(pool, scales, tables, layer, lengths, ps, rep, dtype):
    """The live K or V of each row, gathered from its pages into a contiguous
    [B, H, S, D] tensor (int8 dequantized), for the library yardstick."""
    wl = -(-int(lengths.max()) // ps)
    idx = tables[:, :wl].long()
    g = pool[layer][idx]                                    # [B, wl, Hkv, ps, D]
    if scales is not None:
        g = g.float() * (scales[layer][idx] / 127.5)[..., None]
    b, _, hkv, _, d = g.shape
    g = g.to(dtype).permute(0, 2, 1, 3, 4).reshape(b, hkv, wl * ps, d)
    return g.repeat_interleave(rep, dim=1).contiguous()


K7_LENGTHS = (17, 64, 272, 528)   # live slots per row swept, as K2_WINDOWS


def phase_k7(torch, timer) -> list:
    """K7 against its plain version at the beam-4 Llama-2-7B shape (bf16 and
    int8 pools, GQA, unequal lengths) and over the length sweep (bf16 and
    int8); each case twice with bit-equal results, timed beside SDPA."""
    import torch.nn.functional as F

    from autogptq_tpu_torch.ops import paged_attn as pam

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, h, d, ps, width, layers, layer = BEAMS, 32, 128, PAGE, 40, 2, 1
    n_pages = 2 + BEAMS * 33           # null page, one prompt page, 33 own pages per beam
    full = 33 * ps                     # 528 live slots: 16 prompt + 512 new
    cases = [("beam4 bf16", 32, torch.bfloat16, [full] * b),
             ("beam4 int8", 32, torch.int8, [full] * b),
             ("GQA 32/8", 8, torch.bfloat16, [full] * b),
             ("unequal lengths", 32, torch.bfloat16, [full, 300, 77, 1])]
    cases += [(f"beam4 {tag} length {n}", 32, dt, [n] * b)
              for tag, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)) for n in K7_LENGTHS]
    rows = []
    for name, hkv, kv_dtype, lens in cases:
        rep = h // hkv
        q = torch.randn((b, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        shape = (layers, n_pages, hkv, ps, d)
        ks = vs = None
        if kv_dtype == torch.int8:
            kp = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
            vp = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
            ks = torch.rand(shape[:-1], generator=gen, device="cuda") * 4 + 0.1
            vs = torch.rand(shape[:-1], generator=gen, device="cuda") * 4 + 0.1
        else:
            kp = torch.randn(shape, generator=gen, device="cuda", dtype=kv_dtype)
            vp = torch.randn(shape, generator=gen, device="cuda", dtype=kv_dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        # each row's live pages are distinct pages of the pool; dead entries name the null page
        live_pages = -(-full // ps)
        perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * live_pages] + 1
        tables = torch.zeros((b, width), dtype=torch.int32, device="cuda")
        tables[:, :live_pages] = perm.reshape(b, live_pages).to(torch.int32)
        scale = d ** -0.5
        args = (q, kp, vp, lengths, tables, ks, vs)
        o = pam.paged_attention_mh(*args, sm_scale=scale, layer=layer)
        again = pam.paged_attention_mh(*args, sm_scale=scale, layer=layer)
        ref = pam.paged_attention_mh_ref(*args, sm_scale=scale, layer=layer)
        torch.cuda.synchronize()
        err = (o - ref).abs().max().item()
        check(bool(torch.isfinite(o).all()), f"K7 {name}: non-finite output")
        check(err <= K7_ABS_TOL, f"K7 {name}: max |kernel - plain| = {err:.3e} > {K7_ABS_TOL}")
        check(torch.equal(o, again), f"K7 {name}: two calls on the same inputs differ")
        kl = _live_kv(kp, ks, tables, layer, lengths, ps, rep, torch.bfloat16)
        vl = _live_kv(vp, vs, tables, layer, lengths, ps, rep, torch.bfloat16)
        mask = (torch.arange(kl.shape[2], device="cuda")[None] < lengths[:, None])[:, None, None]
        q4 = q[:, :, None, :]
        ms = timer.ms(lambda: pam.paged_attention_mh(*args, sm_scale=scale, layer=layer))
        plain_ms = timer.ms(lambda: pam.paged_attention_mh_ref(*args, sm_scale=scale,
                                                               layer=layer))
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask,
                                                                 scale=scale))
        live = sum(lens)
        kv_bytes = 2 * live * hkv * d * kp.element_size()
        if ks is not None:
            kv_bytes += 2 * live * hkv * 4
        table_bytes = sum(-(-n // ps) for n in lens) * 4
        b_ms, b_by = bound_ms(kv_bytes + table_bytes + nbytes(q, o, lengths), 4.0 * live * h * d)
        chunk, n_split = pam.split_plan(b, hkv, width, ps)
        rows.append(dict(case=name, B=b, H=h, Hkv=hkv, D=d, page_size=ps, pages=n_pages,
                         width=width, lengths=lens, kv_dtype=str(kv_dtype), chunk=chunk,
                         n_split=n_split, blocks=b * hkv * n_split, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by))
        print(f"K7 {name:22s} B={b} H={h} Hkv={hkv} D={d} ps={ps} lengths={lens}  plan "
              f"{n_split} x {chunk} slots ({b * hkv * n_split} blocks)  err {err:.3e} (tol "
              f"{K7_ABS_TOL}), repeat bit-equal  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"sdpa {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
        del kp, vp, ks, vs, kl, vl
    return rows


def attention_ptxas() -> list:
    """ptxas' registers, spills and shared memory of every K2 and K7
    instance; a spill fails the run."""
    rows = (ptxas_report("flash_decode", "flash_decode_kernel")
            + ptxas_report("paged_attn", "paged_attention_kernel"))
    check(len(rows) > 0, "no K2/K7 entry in the ptxas logs")
    for lib, key in (("K2", "flash_decode_kernel"), ("K7", "paged_attention_kernel")):
        mine = [r for r in rows if key in r["function"]]
        stores = max(r["spill_stores"] or 0 for r in mine)
        loads = max(r["spill_loads"] or 0 for r in mine)
        print(f"{lib} ptxas: {len(mine)} instances, {min(r['registers'] for r in mine)}-"
              f"{max(r['registers'] for r in mine)} registers, spill bytes {stores}/{loads} at "
              f"most, static shared memory {min(r['smem'] for r in mine)}-"
              f"{max(r['smem'] for r in mine)} B", flush=True)
    spilled = [(r["function"], r["registers"], r["spill_stores"], r["spill_loads"])
               for r in rows if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"K2/K7 instances spill registers: {spilled}")
    return rows


def decode_ms_per_token(np, rows, prefix, layers) -> float:
    """A kernel's device ms per token over a run of NEW_TOKENS from a
    PROMPT_LEN prompt: the sweep rows' times (``prefix``), interpolated
    linearly over the windows PROMPT_LEN + 1 .. PROMPT_LEN + NEW_TOKENS - 1
    that its decode steps attend, times ``layers``."""
    pts = sorted((r["live_slots"] if "live_slots" in r else r["lengths"][0], r["ms"])
                 for r in rows if r["case"].startswith(prefix))
    windows = np.arange(PROMPT_LEN + 1, PROMPT_LEN + NEW_TOKENS)
    return float(np.interp(windows, [p[0] for p in pts], [p[1] for p in pts]).mean() * layers)


def phase_k8(torch, timer) -> tuple:
    """K8a and K8b at the beam-4 Llama-2-7B pool shape, all 32 layers."""
    from autogptq_tpu_torch.ops import paged_attn as pam

    gen = torch.Generator(device="cuda").manual_seed(8)
    layers, hkv, d, b = 32, 32, 128, BEAMS
    n_pages = 2 + BEAMS * 33
    cases = [("bf16 K/V", torch.bfloat16, 5), ("int8 K/V", torch.int8, 5),
             ("f32 scales 4-D", torch.float32, 4)]

    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=dtype)
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    write_rows, copy_rows = [], []
    for name, dtype, rank in cases:
        tail = (d,) if rank == 5 else ()
        kp = rand((layers, n_pages, hkv, PAGE) + tail, dtype)
        vp = rand(kp.shape, dtype)
        rk, rv = rand((b, hkv) + tail, dtype), rand((b, hkv) + tail, dtype)
        layer = layers - 1
        page_of = torch.tensor([2, 35, 68, 101], dtype=torch.int32, device="cuda")
        off = torch.tensor([0, 5, 15, 9], dtype=torch.int32, device="cuda")
        want_k = pam.write_token_pages(kp.clone(), layer, page_of, off, rk)
        want_v = pam.write_token_pages(vp.clone(), layer, page_of, off, rv)
        pam.write_token_pages_kernel(kp, vp, layer, page_of, off, rk, rv)
        torch.cuda.synchronize()
        check(torch.equal(kp, want_k) and torch.equal(vp, want_v),
              f"K8a {name}: pools differ from write_token_pages")
        del want_k, want_v
        li = torch.full((b, 1), layer, device="cuda")
        pi, hi, oi = page_of.long()[:, None], torch.arange(hkv, device="cuda")[None], \
            off.long()[:, None]
        ms = timer.ms(lambda: pam.write_token_pages_kernel(kp, vp, layer, page_of, off, rk, rv,
                                                           check=False))
        plain_ms = timer.ms(lambda: (pam.write_token_pages(kp, layer, page_of, off, rk),
                                     pam.write_token_pages(vp, layer, page_of, off, rv)))
        lib_ms = timer.ms(lambda: (kp.index_put_((li, pi, hi, oi), rk),
                                   vp.index_put_((li, pi, hi, oi), rv)))
        b_ms, b_by = bound_ms(2 * nbytes(rk, rv) + nbytes(page_of, off), 0.0)
        write_rows.append(dict(case=name, rows=list(rk.shape), pool=list(kp.shape),
                               max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by))
        print(f"K8a {name:14s} rows {list(rk.shape)} into {list(kp.shape)} {dtype}: bit-equal  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  index_put_ {lib_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)

        # src[1] is dst[0] and src[2] is dst[1]: every read must see the pool
        # before any copy; src[3] == dst[3] copies a page onto itself
        src = torch.tensor([2, 35, 68, 101], dtype=torch.int32, device="cuda")
        dst = torch.tensor([35, 68, 120, 101], dtype=torch.int32, device="cuda")
        want_k = pam.copy_pages(kp.clone(), src, dst)
        want_v = pam.copy_pages(vp.clone(), src, dst)
        pam.copy_pages_pair(kp, vp, src, dst)
        torch.cuda.synchronize()
        check(torch.equal(kp, want_k) and torch.equal(vp, want_v),
              f"K8b {name}: pools differ from copy_pages")
        del want_k, want_v
        si, di = src.long(), dst.long()
        ms = timer.ms(lambda: pam.copy_pages_pair(kp, vp, src, dst, check=False))
        wrapper_ms = timer.ms(lambda: pam.copy_pages_pair(kp, vp, src, dst))
        plain_ms = timer.ms(lambda: (pam.copy_pages(kp, src, dst), pam.copy_pages(vp, src, dst)))
        lib_ms = timer.ms(lambda: (kp.index_copy_(1, di, kp.index_select(1, si)),
                                   vp.index_copy_(1, di, vp.index_select(1, si))))
        page_bytes = kp[0, 0].numel() * kp.element_size()
        b_ms, b_by = bound_ms(2 * 2 * layers * src.numel() * page_bytes + nbytes(src, dst), 0.0)
        copy_rows.append(dict(case=name, pages=src.numel(), pool=list(kp.shape),
                              max_abs_err=0.0, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"K8b {name:14s} {src.numel()} pages x {layers} layers x 2 pools of "
              f"{list(kp.shape)} {dtype}, src aliasing dst: bit-equal  kernel {ms:.4f} ms "
              f"(check=True, waiting for the id flag: {wrapper_ms:.4f} ms)  plain {plain_ms:.4f} ms  "
              f"index_select+index_copy_ {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        if dtype == torch.bfloat16:
            refuse_bad_ids(torch, pam, kp, vp, layer, page_of, off, rk, rv, src, dst)
        del kp, vp
        torch.cuda.empty_cache()
    return write_rows, copy_rows


def refuse_bad_ids(torch, pam, kp, vp, layer, page_of, off, rk, rv, src, dst) -> None:
    """K8a with a page id past the pool and K8b with a negative src and with a
    repeated dst raise ValueError and leave both pools as they were."""
    n_pages = kp.shape[1]
    bad_page = page_of.clone()
    bad_page[2] = n_pages
    bad_src = src.clone()
    bad_src[1] = -1
    dup_dst = dst.clone()
    dup_dst[3] = dst[0]
    want_k, want_v = kp.clone(), vp.clone()
    calls = (("K8a page id past the pool", lambda: pam.write_token_pages_kernel(
                 kp, vp, layer, bad_page, off, rk, rv)),
             ("K8b negative src", lambda: pam.copy_pages_pair(kp, vp, bad_src, dst)),
             ("K8b repeated dst", lambda: pam.copy_pages_pair(kp, vp, src, dup_dst)))
    for what, call in calls:
        try:
            call()
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"{what}: no ValueError")
        check(torch.equal(kp, want_k) and torch.equal(vp, want_v), f"{what}: pools changed")
    print("K8a/K8b bad ids: a page id past the pool, a negative src and a repeated dst each "
          "raise ValueError and leave the pools unchanged", flush=True)


def phase_main_path(torch, np, ckpt_dir: str) -> tuple:
    """Returns the launch counts of the 512-token run, the loaded model and
    the run's tokens."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B, write_random_checkpoint

    cfg = LLAMA2_7B
    t0 = time.perf_counter()
    write_random_checkpoint(ckpt_dir, cfg, bits=4, group_size=128, seed=0)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = AutoGPTQForCausalLM.from_quantized(ckpt_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(model.device.type == "cuda", "from_quantized did not default to the card")
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    warm = model.generate(prompt, max_new_tokens=4)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=NEW_TOKENS)
    gen_s = time.perf_counter() - t0
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()

    layers = cfg["num_hidden_layers"]
    need_k1 = 7 * layers * (NEW_TOKENS - 1)
    need_k2 = layers * (NEW_TOKENS - 1)
    new = out[:, PROMPT_LEN:]
    check(out.shape == (1, PROMPT_LEN + NEW_TOKENS), f"output shape {out.shape}")
    check(bool(((new >= 0) & (new < cfg["vocab_size"])).all()), "token ids out of range")
    check(np.array_equal(out[:, :PROMPT_LEN + 4], warm), "greedy decode is not deterministic")
    check(counts.get("w4a16_gemm", 0) >= need_k1,
          f"K1 launched {counts.get('w4a16_gemm', 0)} times, need >= {need_k1}")
    check(counts.get("flash_decode", 0) >= need_k2,
          f"K2 launched {counts.get('flash_decode', 0)} times, need >= {need_k2}")
    tok_s = NEW_TOKENS / gen_s
    print(f"main path: Llama-2-7B 4-bit g128, {layers} layers (full depth), batch 1, "
          f"{PROMPT_LEN}-token prompt, {NEW_TOKENS} new tokens greedy: checkpoint written in "
          f"{write_s:.1f} s, loaded in {load_s:.1f} s, generate {gen_s:.3f} s = {tok_s:.2f} tok/s, "
          f"peak device memory {peak / 2**30:.2f} GiB, launches {counts}", flush=True)

    prompts = [np.arange(PROMPT_LEN) % 1000 + 1, np.arange(9) + 100]
    build.launches.clear()
    out2 = model.generate(prompts, max_new_tokens=16)
    counts2 = dict(build.launches)
    check(out2.shape == (2, PROMPT_LEN + 16), f"batch-2 output shape {out2.shape}")
    check(bool((out2[1, :PROMPT_LEN - 9] == 0).all()), "batch-2 row 1 is not left-padded")
    check(bool(((out2 >= 0) & (out2 < cfg["vocab_size"])).all()), "batch-2 token ids out of range")
    # the 32-row prefill takes K1's tensor-core tile kernel, the 15 decode steps its GEMV
    check(counts2.get("w4a16_gemm_mma", 0) == 7 * layers
          and counts2.get("w4a16_gemm", 0) == 7 * layers * 15, f"batch-2 K1 launches {counts2}")
    print(f"batch 2, left-padded prompts of {PROMPT_LEN} and 9 tokens (a {2 * PROMPT_LEN}-row "
          f"prefill: K1's tensor-core tile kernel), 16 new tokens: shape {out2.shape}, launches "
          f"{counts2}", flush=True)
    profile_generate(torch, model, prompt, 1e3 * gen_s / NEW_TOKENS, "batch-1 generate",
                     PROFILE_TOKENS)
    return counts, model, out, counts2


def phase_kb32l_path(torch, np, ckpt_dir: str, gptq_model, main_out) -> dict:
    """The main path's checkpoint loaded into the kb32l layout (K6): prefill
    logits against the GPTQ-layout model, 512 greedy tokens twice with the
    launch counts, a profile, and a batch-2 generate (K6's tile regime)."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AutoGPTQForCausalLM.from_quantized(ckpt_dir, layout="kb32l")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    quant = [node for block in model.params["layers"] for sec in ("attn", "mlp")
             for node in block[sec].values() if isinstance(node, qlin.QuantLinear)]
    check(len(quant) == 7 * layers and all(q.layout == "kb32l" for q in quant),
          "from_quantized(layout='kb32l') left a layer in another layout")
    prompt = main_out[:, :PROMPT_LEN]
    want = gptq_model.forward(prompt).float()
    got = model.forward(prompt).float()
    prefill_rel = ((got - want).norm() / want.norm()).item()
    check(bool(torch.isfinite(got).all()) and prefill_rel <= KB32L_E2E_REL_TOL,
          f"kb32l prefill logits vs the GPTQ layout: relative error {prefill_rel:.3e} > "
          f"{KB32L_E2E_REL_TOL}")
    warm = model.generate(prompt, max_new_tokens=4)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=NEW_TOKENS)
    gen_s = time.perf_counter() - t0
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = model.generate(prompt, max_new_tokens=NEW_TOKENS)
    again_s = time.perf_counter() - t0
    steps = NEW_TOKENS - 1
    # the 16-token prefill (M = 16) and every decode step (M = 1): 7 K6 launches per layer
    want_counts = {gemm.KB32L_KERNEL: 7 * layers * (steps + 1), "flash_decode": layers * steps}
    new = out[:, PROMPT_LEN:]
    check(out.shape == (1, PROMPT_LEN + NEW_TOKENS), f"kb32l output shape {out.shape}")
    check(bool(((new >= 0) & (new < vocab)).all()), "kb32l token ids out of range")
    check(np.array_equal(out, again), "kb32l greedy decode does not repeat its tokens")
    check(np.array_equal(out[:, :PROMPT_LEN + 4], warm), "kb32l greedy decode is not "
                                                         "deterministic")
    for name, n in want_counts.items():
        check(counts.get(name, 0) == n, f"kb32l greedy: {name} launched {counts.get(name, 0)} "
                                        f"times, want {n}")
    check(counts.get("w4a16_gemm", 0) == 0, f"kb32l greedy launched K1: {counts}")
    same = float((new == main_out[:, PROMPT_LEN:]).mean())
    agree = int(np.argmin(new[0] == main_out[0, PROMPT_LEN:])) if same < 1 else NEW_TOKENS
    tok_s = NEW_TOKENS / gen_s
    print(f"kb32l path: Llama-2-7B 4-bit g128 from_quantized(layout='kb32l'), {layers} layers, "
          f"batch 1, {PROMPT_LEN}-token prompt, {NEW_TOKENS} new tokens greedy, twice with equal "
          f"tokens: loaded in {load_s:.1f} s (peak {load_peak / 2**30:.2f} GiB), prefill logits "
          f"vs the GPTQ layout rel err {prefill_rel:.3e} (tol {KB32L_E2E_REL_TOL}), generate "
          f"{gen_s:.3f} s = {tok_s:.2f} tok/s (repeat {again_s:.3f} s), peak device memory "
          f"{peak / 2**30:.2f} GiB; launches per decode token: K6 "
          f"{(counts.get(gemm.KB32L_KERNEL, 0) - 7 * layers) / steps:.0f}, K2 "
          f"{counts.get('flash_decode', 0) / steps:.0f}, K1 0; {100 * same:.1f}% of the tokens "
          f"equal to the main path's (the first {agree} in a row); launches {counts}", flush=True)
    profile = profile_generate(torch, model, prompt, 1e3 * gen_s / NEW_TOKENS,
                               "kb32l batch-1 generate", PROFILE_TOKENS, families=KB32L_FAMILIES)

    prompts = [np.arange(PROMPT_LEN) % 1000 + 1, np.arange(PROMPT_LEN) + 100]
    build.launches.clear()
    out2 = model.generate(prompts, max_new_tokens=16)
    counts2 = dict(build.launches)
    check(out2.shape == (2, PROMPT_LEN + 16), f"kb32l batch-2 output shape {out2.shape}")
    check(bool(((out2 >= 0) & (out2 < vocab)).all()), "kb32l batch-2 token ids out of range")
    check(counts2.get(gemm.KB32L_KERNEL + gemm.MMA_SUFFIX, 0) == 7 * layers
          and counts2.get(gemm.KB32L_KERNEL, 0) == 7 * layers * 15
          and not counts2.get("w4a16_gemm", 0) and not counts2.get("w4a16_gemm_mma", 0),
          f"kb32l batch-2 launches {counts2}")
    print(f"kb32l batch 2, two {PROMPT_LEN}-token prompts (a {2 * PROMPT_LEN}-row prefill: K6's "
          f"tile regime, the tensor-core kernel), 16 new tokens: shape {out2.shape}, launches "
          f"{counts2}", flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(load_s=load_s, load_peak_bytes=load_peak, prefill_rel_err=prefill_rel,
                gen_s=gen_s, repeat_s=again_s, tok_s=tok_s, peak_bytes=peak, counts=counts,
                share_equal_to_main=same, leading_equal_tokens=agree, profile=profile,
                batch2_counts=counts2)


def phase_kb32l_cut(torch, np, ckpt_dir: str) -> dict:
    """The 2-layer full-width cut loaded with layout='kb32l' in f32, card (K6,
    K2) against CPU (plain versions): logits of a prefill and a decode step."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models.arch import KVCache, forward
    from autogptq_tpu_torch.ops import build, gemm

    tokens = torch.from_numpy((np.arange(PROMPT_LEN) * 37 % 32000)[None].astype(np.int64))
    nxt = torch.tensor([[1234]])
    results = {}
    for device in ("cuda", "cpu"):
        model = AutoGPTQForCausalLM.from_quantized(ckpt_dir, device=device, dtype=torch.float32,
                                                   layout="kb32l")
        build.launches.clear()
        with torch.inference_mode():
            cache = KVCache.create(model.cfg, 1, PROMPT_LEN + 1, dtype=torch.float32,
                                   device=device)
            pre, cache = forward(model.params, tokens.to(device), model.cfg, cache=cache)
            dec, _ = forward(model.params, nxt.to(device), model.cfg, cache=cache)
        if device == "cuda":
            torch.cuda.synchronize()
            check(build.launches[gemm.KB32L_KERNEL] == 2 * 7 * 2 and
                  build.launches["w4a16_gemm"] == 0, f"kb32l cut launched {dict(build.launches)}")
        results[device] = (pre.float().cpu(), dec.float().cpu())
        del model, cache
    rows = {}
    for i, name in enumerate(("prefill", "decode")):
        card, cpu = results["cuda"][i], results["cpu"][i]
        rel = ((card - cpu).norm() / cpu.norm()).item()
        rows[name] = dict(rel_err=rel, max_abs_err=(card - cpu).abs().max().item())
        check(bool(torch.isfinite(card).all()) and rel <= KB32L_CUT_F32_REL_TOL,
              f"kb32l {name} logits: card f32 vs CPU relative error {rel:.3e} > "
              f"{KB32L_CUT_F32_REL_TOL}")
    print("kb32l card (f32, K6) vs CPU (f32, plain), 2 full-width layers: "
          + ", ".join(f"{k} rel err {v['rel_err']:.3e} max abs {v['max_abs_err']:.3e}"
                      for k, v in rows.items()) + f" (tol {KB32L_CUT_F32_REL_TOL})", flush=True)
    return rows


def phase_beam(torch, np, model) -> dict:
    """Beam search on the main-path model; returns the launch counts and the
    numbers of the 512-token run."""
    from autogptq_tpu_torch.ops import build

    layers = model.cfg.num_layers
    vocab = model.cfg.vocab_size
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    model.generate(prompt, max_new_tokens=4, num_beams=BEAMS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=NEW_TOKENS, num_beams=BEAMS)
    gen_s = time.perf_counter() - t0
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()

    steps = NEW_TOKENS - 1
    need = {"w4a16_gemm": 7 * layers * steps, "paged_attention_mh": layers * steps,
            "write_token_pages": layers * steps, "copy_pages_pair": steps}
    check(out.shape == (1, PROMPT_LEN + NEW_TOKENS), f"beam output shape {out.shape}")
    check(bool(((out[:, PROMPT_LEN:] >= 0) & (out[:, PROMPT_LEN:] < vocab)).all()),
          "beam token ids out of range")
    for name, n in need.items():
        check(counts.get(name, 0) >= n, f"beam: {name} launched {counts.get(name, 0)} times, "
                                         f"need >= {n}")
    t0 = time.perf_counter()
    again = model.generate(prompt, max_new_tokens=NEW_TOKENS, num_beams=BEAMS)
    again_s = time.perf_counter() - t0
    check(np.array_equal(out, again), "beam search does not reproduce its tokens")
    seq_tok_s = NEW_TOKENS / gen_s
    print(f"beam path: Llama-2-7B 4-bit g128, {layers} layers (full depth), batch 1, "
          f"{PROMPT_LEN}-token prompt, {NEW_TOKENS} new tokens, num_beams={BEAMS}, paged bf16 "
          f"cache (page {PAGE}): generate {gen_s:.3f} s = {seq_tok_s:.2f} seq-tok/s = "
          f"{BEAMS * seq_tok_s:.2f} beam-tok/s (repeat: {again_s:.3f} s, same tokens); "
          f"AutoGPTQ gptq-int4 beam 4 on 1x A100-40G: {AUTOGPTQ_BEAM4_A100} tok/s (that "
          f"card's number, BASELINE.md); peak device memory {peak / 2**30:.2f} GiB, "
          f"launches {counts}", flush=True)

    build.launches.clear()
    t0 = time.perf_counter()
    outq = model.generate(prompt, max_new_tokens=QUANT_NEW_TOKENS, num_beams=BEAMS,
                          kv_quant=True)
    q_s = time.perf_counter() - t0
    counts_q = dict(build.launches)
    qsteps = QUANT_NEW_TOKENS - 1
    need_q = {"paged_attention_mh": layers * qsteps, "write_token_pages": 2 * layers * qsteps,
              "copy_pages_pair": 2 * qsteps}
    check(outq.shape == (1, PROMPT_LEN + QUANT_NEW_TOKENS), f"int8 beam output shape {outq.shape}")
    check(bool(((outq[:, PROMPT_LEN:] >= 0) & (outq[:, PROMPT_LEN:] < vocab)).all()),
          "int8 beam token ids out of range")
    for name, n in need_q.items():
        check(counts_q.get(name, 0) >= n, f"int8 beam: {name} launched "
                                          f"{counts_q.get(name, 0)} times, need >= {n}")
    print(f"beam path, int8 paged cache (kv_quant=True): {QUANT_NEW_TOKENS} new tokens, "
          f"num_beams={BEAMS}: generate {q_s:.3f} s = {QUANT_NEW_TOKENS / q_s:.2f} seq-tok/s, "
          f"launches {counts_q}", flush=True)
    profile_generate(torch, model, prompt, 1e3 * gen_s / NEW_TOKENS,
                     f"beam-{BEAMS} generate", BEAM_PROFILE_TOKENS, num_beams=BEAMS)
    return dict(counts=counts, gen_s=gen_s, repeat_s=again_s, seq_tok_s=seq_tok_s,
                beam_tok_s=BEAMS * seq_tok_s, peak_bytes=peak, int8_new_tokens=QUANT_NEW_TOKENS,
                int8_gen_s=q_s, int8_counts=counts_q)


# K1, K4 and K5 are one template (wna16_{decode,prefill}_kernel<BITS, ...> and the tensor-core
# wna16_mma_kernel<BITS, ...>); the profiled model is 4-bit. K10 is wna16_t_kernel<BITS, ...>
# and the tensor-core wna16_t_mma_kernel<BITS, ...>.
K1_KEYS = ("wna16_decode", "wna16_prefill", "splitk_reduce", "wna16_mma_kernel")
K10_KEYS = ("wna16_t_kernel", "wna16_t_mma_kernel")
KERNEL_INSTANCES = (("K1 tensor-core tile", "wna16_mma_kernel"),
                    ("K1 SIMT tile", "wna16_prefill_kernel"),
                    ("K1 GEMV", "wna16_decode_kernel"), ("K1 split-K reduce", "splitk_reduce"),
                    ("K10 tensor-core", "wna16_t_mma_kernel"), ("K10 SIMT", "wna16_t_kernel"))
# K9 is routed_{decode,reduce}_kernel<T>.
FAMILIES = (("K1 w4a16_gemm", K1_KEYS),
            ("K9 w4a16_routed_gemm", ("routed_decode", "routed_reduce")),
            ("K2 flash_decode", ("flash_decode",)),
            ("K7 paged_attention", ("paged_attention",)), ("K8a write_rows", ("write_rows",)),
            ("K8b move_pages", ("move_pages",)))
# K6 is kb32l_decode_kernel<T, MT>, K1's splitk_reduce_kernel<T> and, above 16 rows,
# wna16_prefill_kernel<4, T, Kb32lWords>: in a model loaded with layout="kb32l" K1 never
# launches (the kb32l path checks it), so K1's names count as K6 there.
KB32L_FAMILIES = (("K6 w4a16_kb32l_gemm", ("kb32l", "Kb32l") + K1_KEYS),
                  ("K2 flash_decode", ("flash_decode",)))


def profile_generate(torch, model, prompt, unprofiled_ms_per_token: float, label: str,
                     tokens: int, families=FAMILIES, **gen_kwargs) -> None:
    """Device time by kernel family over a short generate, from
    torch.profiler's CUDA kernel events. The profiler slows the host, so the
    busy share is also given against the unprofiled 512-token run's wall time
    per token (an estimate: that run's windows are longer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.generate(prompt, max_new_tokens=tokens, **gen_kwargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(prompt, max_new_tokens=tokens, **gen_kwargs)
        wall_us = (time.perf_counter() - t0) * 1e6
    sums = dict.fromkeys([name for name, _ in families] + ["other"], 0.0)
    kernels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        kernels += 1
        us = evt.time_range.elapsed_us()
        family = next((name for name, keys in families if any(k in evt.name for k in keys)),
                      "other")
        sums[family] += us
    if not kernels:
        print(f"profile, {label}: torch.profiler recorded no CUDA kernel events; device busy "
              "share not measured", flush=True)
        return {}
    busy = sum(sums.values())
    device_ms = busy / tokens / 1e3
    print(f"profile, {label} of {tokens} tokens (prefill included): "
          f"device {device_ms:.3f} ms/token ("
          + ", ".join(f"{k} {v / tokens / 1e3:.3f}" for k, v in sums.items())
          + f"), {kernels / tokens:.0f} kernels/token; host clock "
          f"{wall_us / tokens / 1e3:.3f} ms/token under the profiler (device busy "
          f"{100 * busy / wall_us:.1f}%), {unprofiled_ms_per_token:.3f} ms/token unprofiled "
          f"(device busy about {100 * device_ms / unprofiled_ms_per_token:.1f}%)", flush=True)
    return dict(device_ms_per_token=device_ms, kernels_per_token=kernels / tokens,
                wall_ms_per_token=wall_us / tokens / 1e3,
                **{f"{k} ms_per_token": v / tokens / 1e3 for k, v in sums.items()})


def phase_cpu_vs_card(torch, np, ckpt_dir: str) -> None:
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models.arch import KVCache, forward
    from autogptq_tpu_torch.ops.paged_attn import check_page_errors
    from autogptq_tpu_torch.utils.generation import beam_paged_prefill, paged_decode_step
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B, write_random_checkpoint

    cfg = dict(LLAMA2_7B, num_hidden_layers=2)
    write_random_checkpoint(ckpt_dir, cfg, bits=4, group_size=128, seed=0)
    tokens = torch.from_numpy((np.arange(PROMPT_LEN) * 37 % 32000)[None].astype(np.int64))
    nxt = torch.tensor([[1234]])
    results = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = AutoGPTQForCausalLM.from_quantized(ckpt_dir, device=device, dtype=dtype)
        with torch.inference_mode():
            cache = KVCache.create(model.cfg, 1, PROMPT_LEN + 1, dtype=dtype, device=device)
            pre, cache = forward(model.params, tokens.to(device), model.cfg, cache=cache)
            dec, _ = forward(model.params, nxt.to(device), model.cfg, cache=cache)
            mask = torch.ones_like(tokens, dtype=torch.int32)
            _, pcache = beam_paged_prefill(model.params, tokens.to(device), mask.to(device),
                                           model.cfg, BEAMS, 4, dtype)
            beam_tok = torch.tensor([1234, 99, 5000, 31999], dtype=torch.int32, device=device)
            step = paged_decode_step(model.params, model.cfg, pcache, beam_tok, pcache.plen,
                                     dtype)
            check_page_errors(device)
        results[device] = (pre.float().cpu(), dec.float().cpu(), step.float().cpu())
        del model, cache, pcache
    rows = {}
    for i, name in enumerate(("prefill", "decode", "paged beam-4 step")):
        card, cpu = results["cuda"][i], results["cpu"][i]
        check(bool(torch.isfinite(card).all()), f"card {name} logits are not finite")
        rel = ((card - cpu).norm() / cpu.norm()).item()
        rows[name] = dict(rel_err=rel, max_abs_err=(card - cpu).abs().max().item(),
                          max_abs_ref=cpu.abs().max().item())
        check(rel <= E2E_REL_TOL, f"{name} logits: card vs CPU relative error {rel:.3e} "
                                  f"> {E2E_REL_TOL}")
    print(f"card (bf16, kernels) vs CPU (f32, plain), 2 full-width layers: "
          + ", ".join(f"{k} rel err {v['rel_err']:.3e} max abs {v['max_abs_err']:.3e}"
                      for k, v in rows.items()) + f" (tol {E2E_REL_TOL})", flush=True)
    return rows


def phase_mixtral(torch, np, ckpt_dir: str) -> dict:
    """The Mixtral-8x7B path: write the random 4-bit g128 checkpoint,
    ``from_quantized`` on the default device, ``stack_moe_experts``, greedy
    decode twice, a profile, beam 4 over the paged bf16 cache."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import params as params_lib
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.utils.random_checkpoint import MIXTRAL_8X7B, write_random_checkpoint

    cfg = dict(MIXTRAL_8X7B, num_hidden_layers=MIXTRAL_LAYERS)
    layers, new_tokens = MIXTRAL_LAYERS, MIXTRAL_NEW_TOKENS
    t0 = time.perf_counter()
    write_random_checkpoint(ckpt_dir, cfg, bits=4, group_size=128, seed=0)
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AutoGPTQForCausalLM.from_quantized(ckpt_dir)
    model.params = params_lib.stack_moe_experts(model.params)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(model.device.type == "cuda", "from_quantized did not default to the card")
    check(all("experts_stacked" in b["mlp"] and "experts" not in b["mlp"]
              for b in model.params["layers"]), "stack_moe_experts left an expert list")
    resident = torch.cuda.memory_allocated()
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    warm = model.generate(prompt, max_new_tokens=4)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=new_tokens)
    gen_s = time.perf_counter() - t0
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = model.generate(prompt, max_new_tokens=new_tokens)
    again_s = time.perf_counter() - t0
    steps = new_tokens - 1
    # prefill: 16 tokens x top-2 = 32 pairs > 8 experts, the dense path (24 K1 per layer);
    # every decode step: 2 pairs, routed, 3 K9 per layer; attention's 4 projections on K1
    want = {"w4a16_routed_gemm": 3 * layers * steps, "flash_decode": layers * steps,
            "w4a16_gemm": (4 + 24) * layers + 4 * layers * steps}
    new = out[:, PROMPT_LEN:]
    check(out.shape == (1, PROMPT_LEN + new_tokens), f"Mixtral output shape {out.shape}")
    check(bool(((new >= 0) & (new < cfg["vocab_size"])).all()), "Mixtral token ids out of range")
    check(np.array_equal(out, again), "Mixtral greedy decode does not repeat its tokens")
    check(np.array_equal(out[:, :PROMPT_LEN + 4], warm), "Mixtral greedy decode is not "
                                                         "deterministic")
    for name, n in want.items():
        check(counts.get(name, 0) == n, f"Mixtral greedy: {name} launched "
                                        f"{counts.get(name, 0)} times, want {n}")
    tok_s = new_tokens / gen_s
    print(f"Mixtral-8x7B 4-bit g128, {layers} layers, 8 experts top-2, batch 1, {PROMPT_LEN}-token "
          f"prompt, {new_tokens} new tokens greedy, twice with equal tokens: checkpoint written "
          f"in {write_s:.1f} s, from_quantized + stack_moe_experts {load_s:.1f} s (peak "
          f"{load_peak / 2**30:.2f} GiB, resident {resident / 2**30:.2f} GiB), generate "
          f"{gen_s:.3f} s = {tok_s:.2f} tok/s (repeat {again_s:.3f} s), peak device memory "
          f"{peak / 2**30:.2f} GiB; launches per decode token: K9 "
          f"{counts.get('w4a16_routed_gemm', 0) / steps:.0f}, K2 "
          f"{counts.get('flash_decode', 0) / steps:.0f}, "
          f"K1 {4 * layers}; launches {counts}", flush=True)
    profile = profile_generate(torch, model, prompt, 1e3 * gen_s / new_tokens,
                               "Mixtral batch-1 generate", MIXTRAL_PROFILE_TOKENS)

    build.launches.clear()
    t0 = time.perf_counter()
    outb = model.generate(prompt, max_new_tokens=MIXTRAL_BEAM_TOKENS, num_beams=BEAMS)
    beam_s = time.perf_counter() - t0
    beam_counts = dict(build.launches)
    bsteps = MIXTRAL_BEAM_TOKENS - 1
    need = {"w4a16_routed_gemm": 3 * layers * bsteps, "paged_attention_mh": layers * bsteps,
            "write_token_pages": layers * bsteps, "copy_pages_pair": bsteps}
    check(outb.shape == (1, PROMPT_LEN + MIXTRAL_BEAM_TOKENS), f"Mixtral beam shape {outb.shape}")
    check(bool(((outb[:, PROMPT_LEN:] >= 0) & (outb[:, PROMPT_LEN:] < cfg["vocab_size"])).all()),
          "Mixtral beam token ids out of range")
    for name, n in need.items():
        check(beam_counts.get(name, 0) >= n, f"Mixtral beam: {name} launched "
                                             f"{beam_counts.get(name, 0)} times, need >= {n}")
    print(f"Mixtral beam {BEAMS} (8 pairs per step, K9 at P = 8), paged bf16 cache, "
          f"{MIXTRAL_BEAM_TOKENS} new tokens: {beam_s:.3f} s = "
          f"{MIXTRAL_BEAM_TOKENS / beam_s:.2f} seq-tok/s, launches {beam_counts}", flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(layers=layers, write_s=write_s, load_s=load_s, load_peak_bytes=load_peak,
                resident_bytes=resident, gen_s=gen_s, repeat_s=again_s, tok_s=tok_s,
                peak_bytes=peak, counts=counts, tokens=new[0].tolist(), profile=profile,
                beam_s=beam_s, beam_counts=beam_counts)


def phase_mixtral_cpu_vs_card(torch, np, ckpt_dir: str) -> dict:
    """A 2-layer full-width Mixtral cut: card (f32) against CPU (f32, plain
    versions) on a prefill and one routed decode step; the share of routing
    choices a bf16 card run shares with the CPU; one layer's moe_mlp on the
    card, routed (K9) and dense stacked against the expert list (K1), f32."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.models import params as params_lib
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.utils.random_checkpoint import MIXTRAL_8X7B, write_random_checkpoint

    write_random_checkpoint(ckpt_dir, dict(MIXTRAL_8X7B, num_hidden_layers=2), bits=4,
                            group_size=128, seed=0)
    tokens = torch.from_numpy((np.arange(PROMPT_LEN) * 37 % 32000)[None].astype(np.int64))
    nxt = torch.tensor([[1234]])
    results, routes, moe, dxs = {}, {}, {}, {}
    real_top_k = arch.top_k
    grad_rng = np.random.default_rng(14)
    grad_x = grad_rng.standard_normal((4, 1, MIXTRAL_8X7B["hidden_size"])).astype(np.float32)
    grad_cot = grad_rng.standard_normal(grad_x.shape).astype(np.float32)
    for run, device, dtype in (("card f32", "cuda", torch.float32),
                               ("card bf16", "cuda", torch.bfloat16),
                               ("cpu", "cpu", torch.float32)):
        model = AutoGPTQForCausalLM.from_quantized(ckpt_dir, device=device, dtype=dtype)
        if run == "card f32":
            moe = moe_layer_check(torch, arch, params_lib, build, model)
        model.params = params_lib.stack_moe_experts(model.params)
        if dtype == torch.float32:
            dxs[run] = routed_grad(torch, arch, build, model, grad_x, grad_cot)
        chosen = []

        def recording_top_k(x, k):
            vals, idx = real_top_k(x, k)
            chosen.append(idx.reshape(-1, k).sort(dim=-1).values.cpu())
            return vals, idx

        arch.top_k = recording_top_k
        try:
            with torch.inference_mode():
                cache = arch.KVCache.create(model.cfg, 1, PROMPT_LEN + 1, dtype=dtype,
                                            device=device)
                pre, cache = arch.forward(model.params, tokens.to(device), model.cfg, cache=cache)
                build.launches.clear()
                dec, _ = arch.forward(model.params, nxt.to(device), model.cfg, cache=cache)
                if device == "cuda":
                    torch.cuda.synchronize()
                    check(build.launches["w4a16_routed_gemm"] == 3 * 2,
                          f"{run}: the decode step launched {dict(build.launches)}")
        finally:
            arch.top_k = real_top_k
        results[run] = (pre.float().cpu(), dec.float().cpu())
        routes[run] = torch.cat(chosen)
        del model, cache
        torch.cuda.empty_cache()
    rows = {}
    for i, name in enumerate(("prefill", "routed decode step")):
        card, cpu = results["card f32"][i], results["cpu"][i]
        check(bool(torch.isfinite(card).all()), f"Mixtral card {name} logits are not finite")
        rel = ((card - cpu).norm() / cpu.norm()).item()
        bf16 = results["card bf16"][i]
        rows[name] = dict(rel_err=rel, max_abs_err=(card - cpu).abs().max().item(),
                          bf16_rel_err=((bf16 - cpu).norm() / cpu.norm()).item())
        check(rel <= MIXTRAL_E2E_F32_REL_TOL, f"Mixtral {name} logits: card f32 vs CPU relative "
                                              f"error {rel:.3e} > {MIXTRAL_E2E_F32_REL_TOL}")
    shared = {run: (routes[run] == routes["cpu"]).all(dim=-1).float().mean().item()
              for run in ("card f32", "card bf16")}
    card_dx, cpu_dx = dxs["card f32"][0], dxs["cpu"][0]
    grad_rel = ((card_dx - cpu_dx).norm() / cpu_dx.norm()).item()
    check(bool(torch.isfinite(card_dx).all()) and grad_rel <= ROUTED_GRAD_F32_REL_TOL,
          f"dx through the routed moe_mlp: card f32 vs CPU relative error {grad_rel:.3e} > "
          f"{ROUTED_GRAD_F32_REL_TOL}")
    print(f"dx through layer 0's routed moe_mlp (4 tokens x top-2 = 8 pairs of 8 experts), card "
          f"f32 (K9 forward, K10 per selected expert backward; launches {dxs['card f32'][1]}) vs "
          f"CPU f32: relative error {grad_rel:.3e} (tol {ROUTED_GRAD_F32_REL_TOL})", flush=True)
    print(f"Mixtral card (f32, kernels) vs CPU (f32, plain), 2 full-width layers: "
          + ", ".join(f"{k} rel err {v['rel_err']:.3e} max abs {v['max_abs_err']:.3e}"
                      for k, v in rows.items())
          + f" (tol {MIXTRAL_E2E_F32_REL_TOL}); of the CPU's routing choices on "
          f"{routes['cpu'].shape[0]} (layer, token) pairs the f32 card run shares "
          f"{100 * shared['card f32']:.1f}%, a bf16 card run {100 * shared['card bf16']:.1f}% "
          f"(logits rel err "
          + ", ".join(f"{k} {v['bf16_rel_err']:.3e}" for k, v in rows.items()) + ")", flush=True)
    return dict(rows=rows, routes_shared=shared, routes=int(routes["cpu"].shape[0]),
                moe_mlp=moe, routed_grad=dict(rel_err=grad_rel, launches=dxs["card f32"][1]))


def routed_grad(torch, arch, build, model, x, cot) -> tuple:
    """dx of sum(moe_mlp(x) * cot) through layer 0's stacked experts on the
    model's device; on the card the routed route must launch K9 (3) and K10."""
    from autogptq_tpu_torch.ops import gemm

    dev = model.device
    xt = torch.from_numpy(x).to(dev).requires_grad_()
    build.launches.clear()
    y = arch.moe_mlp(model.params["layers"][0]["mlp"], xt, model.cfg)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(cot).to(dev)).sum(), xt)
    counts = dict(build.launches)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        check(counts.get(gemm.ROUTED_KERNEL, 0) == 3 and counts.get(gemm.T_KERNEL, 0) >= 3,
              f"routed moe_mlp gradient on the card launched {counts}")
    return dx.detach().float().cpu(), counts


def moe_layer_check(torch, arch, params_lib, build, model) -> dict:
    """Layer 0's moe_mlp on the card in f32: routed (K9, decode shapes) and
    dense stacked (a 16-token prefill) against the expert list (K1)."""
    bp = model.params["layers"][0]["mlp"]
    stacked = params_lib.stack_moe_experts({"layers": [{"mlp": dict(bp)}]})["layers"][0]["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for what, shape in (("routed P=2", (1, 1)), ("routed P=8", (4, 1)), ("dense", (1, 16))):
        x = torch.randn(shape + (model.cfg.hidden_size,), generator=gen, device="cuda")
        with torch.inference_mode():
            build.launches.clear()
            got = arch.moe_mlp(stacked, x, model.cfg)
            counts = dict(build.launches)
            want = arch.moe_mlp(bp, x, model.cfg)
        torch.cuda.synchronize()
        routed = what.startswith("routed")
        check(counts.get("w4a16_routed_gemm", 0) == (3 if routed else 0)
              and counts.get("w4a16_gemm", 0) == (0 if routed else 24),
              f"moe_mlp {what}: launched {counts}")
        err = (got - want).abs().max().item()
        check(err <= MOE_F32_ABS_TOL, f"moe_mlp {what}: max |stacked - list| = {err:.3e} > "
                                      f"{MOE_F32_ABS_TOL}")
        out[what] = dict(max_abs_err=err, max_abs_ref=want.abs().max().item(), launches=counts)
    print("one layer's moe_mlp on the card, f32, against the expert list (K1): "
          + ", ".join(f"{k} (launches {v['launches']}) max abs err {v['max_abs_err']:.3e}"
                      for k, v in out.items()) + f" (tol {MOE_F32_ABS_TOL})", flush=True)
    return out


def layer_sum(rows: list, key: str, m: int = 1) -> float:
    by = {r["case"]: r for r in rows if r["M"] == m}
    return sum(by[name][key] * calls for name, (_, _, calls) in LAYER_SHAPES.items())


def mixtral_layer_sum(rows: list, key: str, p: int = 2) -> float:
    return sum(r[key] * MIXTRAL_SHAPES[r["case"]][2] for r in rows if r["P"] == p)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from autogptq_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    seconds = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()), flush=True)

    phase_s = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return result

    timer = Timer(torch)
    k1_rows = timed("K1", phase_k1, torch, np, timer)
    wna_rows = timed("K4/K5/K1 classes", phase_wna16, torch, np, timer)
    rest_rows = timed("rest classes", phase_rest, torch, np, timer)
    ptxas = mma_ptxas()
    k2_rows = timed("K2", phase_k2, torch, timer)
    k7_rows = timed("K7", phase_k7, torch, timer)
    attn_ptxas = attention_ptxas()
    k8a_rows, k8b_rows = timed("K8", phase_k8, torch, timer)
    k10_rows = timed("K10", phase_k10, torch, np, timer)
    k9_rows = timed("K9", phase_k9, torch, np, timer)
    k6 = timed("K6", phase_k6, torch, np, timer)
    boundary = boundary_cost(torch, np)
    del timer
    torch.cuda.empty_cache()

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        ckpt = os.path.join(work, "llama2-7b-random-g128")
        launches, model, main_out, batch2_launches = timed("main path", phase_main_path, torch,
                                                           np, ckpt)
        kb32l = timed("kb32l path", phase_kb32l_path, torch, np, ckpt, model, main_out)
        beam = timed("beam", phase_beam, torch, np, model)
        train = timed("train", phase_train, torch, np, model, work)
        del model
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
        cut_dir = os.path.join(work, "llama2-7b-random-g128-2layers")
        cpu_vs_card = timed("card vs CPU", phase_cpu_vs_card, torch, np, cut_dir)
        kb32l_cut = timed("kb32l card vs CPU", phase_kb32l_cut, torch, np, cut_dir)
        grads = timed("gradients", phase_grads, torch, np, cut_dir)
        shutil.rmtree(work, ignore_errors=True)
        widths = timed("other widths", phase_other_widths, torch, np, work)
        quantize = timed("quantize", phase_quantize, torch, np, work)
        shutil.rmtree(work, ignore_errors=True)
        mixtral = timed("Mixtral", phase_mixtral, torch, np,
                        os.path.join(work, "mixtral-8x7b-random-g128"))
        mixtral_cut = timed("Mixtral card vs CPU", phase_mixtral_cpu_vs_card, torch, np,
                            os.path.join(work, "mixtral-8x7b-random-g128-2layers"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()),
          flush=True)

    k2_main, k7_main, k8a_main, k8b_main = k2_rows[0], k7_rows[0], k8a_rows[0], k8b_rows[0]
    beam_launches = beam["counts"]
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B

    layers = LLAMA2_7B["num_hidden_layers"]
    full_run = dict(k2_ms_per_token=decode_ms_per_token(np, k2_rows, "B1 MHA window", layers),
                    k7_ms_per_step=decode_ms_per_token(np, k7_rows, "beam4 bf16 length", layers),
                    k7_int8_ms_per_step=decode_ms_per_token(np, k7_rows, "beam4 int8 length",
                                                            layers))
    print(f"K2/K7 device time over a {NEW_TOKENS}-token run from a {PROMPT_LEN}-token prompt "
          f"(the sweeps interpolated over windows {PROMPT_LEN + 1}..{PROMPT_LEN + NEW_TOKENS - 1},"
          f" x {layers} layers): K2 {full_run['k2_ms_per_token']:.4f} ms per greedy token, K7 "
          f"{full_run['k7_ms_per_step']:.4f} ms per beam-4 step (int8 pools "
          f"{full_run['k7_int8_ms_per_step']:.4f})", flush=True)
    at_full = [r for r in k2_rows if r["case"] in ("B1 MHA", "B2 left-pad", "B1 GQA 32/8")]
    print("against SDPA at 528 slots: " + ", ".join(
        f"K2 {r['case']} {r['ms']:.4f} / {r['library_ms']:.4f} ms" for r in at_full) + ", "
          + ", ".join(f"K7 {r['case']} {r['ms']:.4f} / {r['library_ms']:.4f} ms"
                      for r in k7_rows[:4]), flush=True)
    decode_m = {m: dict(k1_ms=layer_sum(k1_rows, "ms", m),
                        k1_library_ms=layer_sum(k1_rows, "library_ms", m),
                        k6_ms=layer_sum(k6["rows"], "ms", m),
                        k6_library_ms=layer_sum(k6["rows"], "library_ms", m))
                for m in (1, BEAMS, 16)}
    print("one Llama-2-7B layer's 7 projections, 4-bit g128 bf16, decode regime: " + "; ".join(
        f"M = {m}: K1 {v['k1_ms']:.4f} ms, torch.matmul {v['k1_library_ms']:.4f} ms (K1 phase); "
        f"K6 {v['k6_ms']:.4f} ms, torch.matmul {v['k6_library_ms']:.4f} ms (K6 phase)"
        for m, v in decode_m.items()), flush=True)

    def entry(name, source, replaces, counted, rows, main_row, at):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=counted.get(name, 0),
                    max_abs_err=max(r["max_abs_err"] for r in rows), ms=main_row["ms"],
                    plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
                    bound_by=main_row["bound_by"], library_ms=main_row["library_ms"], at=at)

    def gemm_entry(name, replaces, counted, rows, at, m=1, err_rows=None, source=None,
                   ms_key="ms", errs=None):
        """One decoder layer's 7 projections at M = m, g128 (the kernel's time
        under ``ms_key``; its errors ``errs``, else those of ``err_rows``)."""
        main_rows = [r for r in rows if r["M"] == m]
        errs = errs or [r["max_abs_err"] for r in (err_rows or rows)]
        return dict(name=name, route="cuda",
                    source=source or f"autogptq_tpu_torch/ops/csrc/{name}.cu",
                    replaces=replaces, launches=counted.get(name, 0), max_abs_err=max(errs),
                    ms=layer_sum(rows, ms_key, m), plain_ms=layer_sum(rows, "plain_ms", m),
                    bound_ms=layer_sum(rows, "bound_ms", m),
                    bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in main_rows)
                              else "operations"),
                    library_ms=layer_sum(rows, "library_ms", m), at=at)

    k10_g128 = [r for r in k10_rows if r["bits"] == 4 and r["group_size"] == 128
                and not r["desc_act"]]

    def width_rows(bits):
        return [r for r in wna_rows if r["bits"] == bits and r["group_size"] == 128
                and not r["desc_act"]]

    at = "one Llama-2-7B decoder layer's 7 projections at M=1, g128"
    kernels = [
        gemm_entry("w4a16_gemm", "autogptq_tpu/ops/pallas/gemm.py:487", launches, k1_rows, at,
                   errs=[r["max_abs_err"] for r in k1_rows if r["route"] == "simt"]
                   + [r["simt_max_abs_err"] for r in k1_rows if "simt_ms" in r]),
        gemm_entry("w8a16_gemm", "autogptq_tpu/ops/pallas/gemm.py:46", widths[8]["counts"],
                   width_rows(8), at + "; launches from the 64-token 8-bit greedy run at 8 layers",
                   errs=[r["max_abs_err"] for r in wna_rows + rest_rows
                         if r["kernel"] == "w8a16_gemm"]),
        gemm_entry("w2a16_gemm", "autogptq_tpu/ops/pallas/gemm.py:1061", widths[2]["counts"],
                   width_rows(2), at + "; launches from the 64-token 2-bit greedy run at 8 layers",
                   errs=[r["max_abs_err"] for r in wna_rows + rest_rows
                         if r["kernel"] == "w2a16_gemm"]),
        gemm_entry("wna16_gemm_t", "autogptq_tpu/ops/pallas/gemm.py:844",
                   grads["LoRA"]["card f32 backward_launches"], k10_g128,
                   f"the SIMT kernel: one Llama-2-7B decoder layer's 7 projections at M="
                   f"{TRAIN_M}, 4-bit g128, bf16 cotangents, timed beside the tensor-core kernel "
                   f"on the same weights (it runs f32 cotangents, M <= 16 and group sizes 16 "
                   f"does not divide); launches from the f32 LoRA backward of the 2-layer "
                   f"gradient check; max_abs_err over every SIMT K10 case",
                   m=TRAIN_M, ms_key="simt_ms",
                   errs=[r["max_abs_err"] for r in k10_rows if r["route"] == "simt"]
                   + [r["simt_max_abs_err"] for r in k10_rows if "simt_ms" in r]),
        gemm_entry("wna16_gemm_t_mma", "autogptq_tpu/ops/pallas/gemm.py:811",
                   train["launches_per_step"], k10_g128,
                   f"the tensor-core K10: one Llama-2-7B decoder layer's 7 projections at M="
                   f"{TRAIN_M} (a {TRAIN_BATCH} x {TRAIN_LEN} batch), 4-bit g128, bf16 "
                   f"cotangents; launches from one LoRA training step at full depth; "
                   f"max_abs_err over every tensor-core K10 case", m=TRAIN_M, source=MMA_SOURCE,
                   errs=[r["max_abs_err"] for r in k10_rows if r["route"] == "mma"]),
        gemm_entry("w4a16_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:487", train["launches_per_step"],
                   k1_rows, f"K1's tensor-core tile kernel: one Llama-2-7B decoder layer's 7 "
                   f"projections at M={TRAIN_M}, g128, bf16 (replaces the prefill regime of "
                   f"_kernel_kb32 :487); launches from one LoRA training step at full depth; "
                   f"max_abs_err over every K1 case it ran", m=TRAIN_M, source=MMA_SOURCE,
                   errs=[r["max_abs_err"] for r in k1_rows if r["route"] == "mma"]),
        gemm_entry("w8a16_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:46", widths[8]["batch2_counts"],
                   width_rows(8), "K4's tensor-core tile kernel: one Llama-2-7B decoder layer's 7 "
                   "projections at M=128, g128, bf16; launches from the 8-bit batch-2 run's "
                   "32-row prefill at 8 layers", m=128, source=MMA_SOURCE,
                   errs=[r["max_abs_err"] for r in wna_rows if r["kernel"] == "w8a16_gemm_mma"]),
        gemm_entry("w2a16_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:1061",
                   widths[2]["batch2_counts"], width_rows(2), "K5's tensor-core tile kernel: one "
                   "Llama-2-7B decoder layer's 7 projections at M=128, g128, bf16; launches from "
                   "the 2-bit batch-2 run's 32-row prefill at 8 layers", m=128, source=MMA_SOURCE,
                   errs=[r["max_abs_err"] for r in wna_rows if r["kernel"] == "w2a16_gemm_mma"]),
        gemm_entry("w4a16_kb32l_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:635",
                   kb32l["batch2_counts"], [r for r in k6["rows"] if r["case"] in LAYER_SHAPES],
                   f"K6's tile regime, the tensor-core kernel over kb32l words: one Llama-2-7B "
                   f"decoder layer's 7 projections at M={TRAIN_M}, g128, bf16 (replaces "
                   f"_matmul_kb32l :635, _kernel_kb32 with lin=True); launches from the kb32l "
                   f"batch-2 run's 32-row prefill", m=TRAIN_M, source=MMA_SOURCE,
                   errs=[r["max_abs_err"] for r in k6["rows"] if r["route"] == "mma"]),
        entry("flash_decode", "autogptq_tpu_torch/ops/csrc/flash_decode.cu",
              "autogptq_tpu/ops/pallas/flash_decode.py:62", launches, k2_rows, k2_main,
              "one layer, B=1, H=Hkv=32, D=128, 528 live slots, bf16 cache"),
        entry("paged_attention_mh", "autogptq_tpu_torch/ops/csrc/paged_attn.cu",
              "autogptq_tpu/ops/pallas/paged_attn.py:45", beam_launches, k7_rows, k7_main,
              "one layer, beam 4: B=4, H=Hkv=32, D=128, page 16, 528 live slots per row, "
              "bf16 pools; launches from the 512-token beam-4 run"),
        entry("write_token_pages", "autogptq_tpu_torch/ops/csrc/page_ops.cu",
              "autogptq_tpu/ops/pallas/paged_attn.py:252", beam_launches, k8a_rows, k8a_main,
              "one layer, both pools, rows [4, 32, 128] bf16; launches from the 512-token "
              "beam-4 run"),
        entry("copy_pages_pair", "autogptq_tpu_torch/ops/csrc/page_ops.cu",
              "autogptq_tpu/ops/pallas/paged_attn.py:316", beam_launches, k8b_rows, k8b_main,
              "4 pages x 32 layers x 2 bf16 pools (one beam-4 step), check=False as on the "
              "beam path; launches from the 512-token beam-4 run"),
        gemm_entry("w4a16_kb32l_gemm", "autogptq_tpu/ops/pallas/gemm.py:692", kb32l["counts"],
                   [r for r in k6["rows"] if r["case"] in LAYER_SHAPES], at + "; the same "
                   f"function over the tile-contiguous kb32l words, a cp.async ring at M <= 16 "
                   f"(replaces _kernel_kb32l_manual :692 and _matmul_kb32l :635); launches from "
                   f"the {NEW_TOKENS}-token greedy run of the model loaded with layout='kb32l'; "
                   f"max_abs_err over every K6 case of the GEMV and the SIMT tile kernel",
                   errs=[r["max_abs_err"] for r in k6["rows"] if r["route"] == "simt"]
                   + [r["simt_max_abs_err"] for r in k6["rows"] if "simt_ms" in r]),
        dict(name="w4a16_routed_gemm", route="cuda",
             source="autogptq_tpu_torch/ops/csrc/w4a16_routed_gemm.cu",
             replaces="autogptq_tpu/ops/pallas/gemm.py:894",
             launches=mixtral["counts"].get("w4a16_routed_gemm", 0),
             max_abs_err=max(r["max_abs_err"] for r in k9_rows),
             **{key: mixtral_layer_sum(k9_rows, key) for key in
                ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in k9_rows if r["P"] == 2)
                       else "operations"),
             at=f"one Mixtral-8x7B layer's 3 expert projections at P=2 (batch-1 decode, top-2 of "
                f"8), g128, bf16; library: 2 torch.matmul per call on pre-dequantized bf16 "
                f"experts; launches from the {MIXTRAL_NEW_TOKENS}-token greedy run at "
                f"{MIXTRAL_LAYERS} layers; max_abs_err over every K9 case"),
    ]
    for e in kernels:   # every kernel of the line ran on its path
        check(e["launches"] > 0, f"{e['name']} was launched no time on its path: {e['at']}")
    elapsed = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, device=torch.cuda.get_device_name(0), build_s=seconds,
                       k1=k1_rows, k9=k9_rows, k6=k6, kb32l=kb32l, kb32l_cut=kb32l_cut,
                       mixtral=mixtral, mixtral_cut=mixtral_cut,
                       wna16=wna_rows, rest=rest_rows, mma_ptxas=ptxas, other_widths=widths,
                       quantize=quantize, main_batch2=batch2_launches,
                       k2=k2_rows, k7=k7_rows, k8a=k8a_rows, k8b=k8b_rows, k10=k10_rows,
                       attention_ptxas=attn_ptxas, attention_full_run=full_run,
                       decode_layer_ms=decode_m,
                       main_path=launches, beam=beam, train=train, grads=grads,
                       cpu_vs_card=cpu_vs_card, phase_s=phase_s, boundary_us=boundary,
                       kernels=kernels, elapsed_s=elapsed), f, indent=1)
    print(f"elapsed {elapsed:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
