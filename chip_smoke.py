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
   At M <= 16 (bf16) the tensor-core decode GEMV runs (bit-equal on a second
   call, with its plan and weight bytes in flight per SM) and the SIMT GEMV is
   held and timed beside it on the same weights (``kernel="simt"``); at M = 128
   and 2048 the wgmma/TMA tile kernel (bit-equal on a second call, with its
   plan) beside the mma.sync tile kernel (``kernel="mma"``) and the SIMT tile
   kernel; ptxas' registers, spills and shared memory of every tensor-core
   instance (a spill in a GEMV or wgmma instance fails the run). K1's fused RMS-norm prologue on
   one layer's q/k/v and gate/up: each route (the tensor-core GEMV at M = 1, 4,
   16 in bf16 and f16, the SIMT GEMV in f32, the wgmma/TMA tile kernel at M =
   17, 24 and 31 in bf16 and 24 in f16, the SIMT tile kernel at M = 24, a 3-bit
   and a ``plus_one`` case) against ``rms_apply`` and the plain matmul, one
   launch of its own key, bit-equal on a second call, timed beside the same
   kernel alone, the unfused pair, the plain version and ``F.rms_norm`` +
   ``torch.matmul``; the wgmma cases also launch the rows' rstd kernel first
   and run the mma.sync tile kernel's prologue (``kernel="mma"``, held to the
   same tolerance), timed at M = 24 bf16; the GEMV's entry launches the same
   rstd kernel before the GEMV, which it overlaps by programmatic dependent
   launch (bf16 at M = 1, 4, 8, 9 and 16 too); the rstd kernel alone held to
   its plain version in every bf16 and f16 case and timed at M = 1, 16 and
   24; ptxas' registers and spills of its 28 instances.
4. K2 (split-KV flash-decode) against ``flash_decode_ref``: B=1 MHA, B=2
   with a left-padded row, and GQA at 528 slots, a window sweep (17, 64, 272
   and 528 live slots, MHA and GQA) and Mixtral-8x7B's decode shape (8 KV
   heads, 144 slots), each case called twice with bit-equal results, with the
   same measurements (the library call is ``scaled_dot_product_attention``)
   and the split plan.
5. K7 (split-KV paged attention) against ``paged_attention_mh_ref`` at the
   beam-4 Llama-2-7B shape (bf16 and int8 pools), GQA, unequal lengths and a
   length sweep (bf16 and int8), as K2; ptxas' registers and spills of every
   K2 and K7 instance (a spill fails the run). K8a's fused RoPE + K/V write
   (``rope_write_kv``) against its plain version (``rope_write_kv_ref``: the
   rotation of ``arch.apply_rope``, then ``write_token_pages`` or
   ``index_copy_``, ``quant_rows`` for int8) at the steps' shapes: the beam-4
   pools in bf16 and in int8 with their scales, the greedy contiguous cache at
   the cursor, Mixtral's GQA shape over its cache and its beam-4 pools; the
   elements that differ are counted and printed, at most one ulp of the cache's
   dtype and one int8 code allowed; one launch each. K8a with the rotation off
   (``write_token_pages_kernel``, a page row write) and K8b (one cluster per
   (layer, pool); a src naming another copy's dst, a swap cycle, self-copies)
   bit-equal against ``write_token_pages`` / ``copy_pages`` on bf16, int8 and
   4-D scale pools, K8b timed beside its gather and scatter kernels on the
   same copies, and refusing an id outside the pool (a position past the
   table too) without writing. Library yardsticks:
   ``scaled_dot_product_attention`` over the same live K/V laid out
   contiguously, ``index_put_`` (the fused write has no one call: the write
   alone is timed beside it), and ``index_select`` + ``index_copy_``.
6. The main path: writes a random 4-bit g128 Llama-2-7B checkpoint (all 32
   layers), loads it with ``AutoGPTQForCausalLM.from_quantized`` on the
   default device and greedy-decodes 512 tokens from a 16-token prompt at
   batch 1, with the launch counts set to 0 just before and read just after
   (exactly 224 ``w4a16_gemm_gemv`` per token, no SIMT GEMV; exactly one
   fused RoPE + K/V write, ``rope_write_kv``, per layer and decode step, and
   no Python call of ``arch.apply_rope`` but the prefill's nor of
   ``Tensor.index_copy_``); then a batch-2
   left-padded run of 16 tokens (its 32-row prefill exactly 224
   ``w4a16_gemm_wgmma``). A profile of a short generate, and of the
   same generate with every quantized matmul forced through the SIMT kernels
   (``gemm.forced_kernel``): the new route must launch one kernel per K1 call
   and take less device time per token; the SIMT route's kernels and reduces
   are reported beside.
7. The beam path on the same model: ``generate(num_beams=4)`` of 512 tokens
   over the paged bf16 cache (counts set to 0 just before, read just after;
   its tokens repeat in the 64-token runs below), then a 64-token run over
   the int8 paged cache (224 GEMV launches per step in both; exactly one
   ``rope_write_kv`` per layer and step, the int8 quantization inside it; one
   K8b ``copy_pages_pair`` per step and one at setup, two with int8 pools,
   every one of the steps' after the warm-up replayed from the step's CUDA
   graph, which holds the beams' advance and reorder; no Python call of
   ``arch.apply_rope`` but the prefill's nor of ``Tensor.index_copy_``), and
   its graph turn against the per-op loop (identical tokens). A profile of a
   short beam-4 generate, through both routes as for greedy. Then the same
   model with ``arch.FUSE_NORM = "1"`` (``AUTOGPTQ_TPU_FUSE_NORM``; put back
   after): 256 greedy tokens (exactly 160 ``w4a16_gemm_gemv_norm``, 160 rstd
   launches and 64 ``w4a16_gemm_gemv`` per decode token, one ``rms_norm`` per token: the final
   norm's), a profiled 33-token window, the tokens equal to the default run's;
   beam-4 runs of 48 tokens with the switch off, on, on and off (host time in
   turns; each repeats its tokens; the fused tokens against the unfused ones);
   a bf16 batch of 24 prompts whose decode steps take the wgmma/TMA tile
   kernel's prologue (exactly 1120 ``w4a16_gemm_wgmma_norm`` and 1120
   ``w4a16_gemm_wgmma_norm_rstd``, no ``w4a16_gemm_mma_norm``), a 2-token
   run of that batch forced through
   the mma.sync kernels (``gemm.forced_kernel("mma")``), and a bf16 batch of 16
   (8 tokens) whose decode steps take the fused GEMV at M = 16 (exactly 160
   ``w4a16_gemm_gemv_norm`` and 160 rstd launches per step), its tokens
   counted against the same batch's with the switch off, and one decode step
   of 16 rows after the same prefill with the switch on and off, logits
   within ``FUSED_STEP_REL_TOL`` while two planted faults of the rstd stray
   beyond it; the two profile readers held to the same kernels on one
   window.
8. The port on the card against the port on the CPU: a 2-layer, full-width
   cut of the same checkpoint, prefill and one decode step, and one paged
   beam-4 decode step, bf16 kernels (the tensor-core GEMV) and f32 kernels
   (the SIMT GEMV) on the card against the f32 plain versions on the CPU; and
   with the switch on, a decode step's logits and greedy tokens at batch 1 and
   24 (the SIMT kernels' prologue) against the CPU.
9. K4 (w8a16 GEMM), K5 (w2a16 GEMM) and K1 at the shape classes of the TPU's
   ``ki32`` and ``kpair`` kernels (3-bit codes in nibbles, one group, group
   sizes 16 and 64, K = 11008) against their plain versions at the three
   Llama-2-7B shapes, M in {1, 4, 16, 17, 128}, bf16 (timed) and f32, one
   desc_act case with a bias per width; at M <= 16 the tensor-core GEMV,
   bit-equal on a second call, timed beside the SIMT GEMV. The rest classes
   (group sizes 16 does not divide, words straddling groups, a partial last
   group) at full width, one layer per storage width, through the tensor-core
   GEMV's ANY_GS instance (M = 1, 4 and 16), the wgmma/TMA tile kernel
   (M = 128 and 2048), K10's decode regime (M = 16) and the wgmma K10 (M = 128
   and 2048), bf16 (each bit-equal on a second call and faster than the
   kernel it replaced, timed beside it on the same weights: the mma.sync
   kernels for the wgmma ones (the SIMT kernel beside too), the SIMT kernel
   for the GEMV (but the desc_act g172 forward at M >= 4), the tile K10 at
   M = 16) and f32 (the SIMT kernels); ptxas' registers and spills of every
   tensor-core instance, the 12 ANY_GS ones too; K9 at 4-bit gs 12
   and 100 (Mixtral's gate/up shape, P = 2 and 8) through the routed GEMV's
   ANY_GS instance beside the SIMT routed kernel.
10. The other widths generate: random 2-, 3- and 8-bit g128 checkpoints at
   full width and 8 layers, ``from_quantized``, 64 greedy tokens twice with
   equal tokens, launch counts (K5, K1, K4) set to 0 before and read after;
   a batch-2 run whose 32-row prefill takes each width's wgmma/TMA kernel
   (exact counts), and its prefill again through the mma.sync kernel.
   Then the rest-class path: an 8-layer 4-bit group-size-100 checkpoint at
   full width, a batch-2 greedy generate of 16 tokens (its 32-row prefill
   through the wgmma/TMA tile kernel, exactly 7 x 8 launches, its decode
   steps through the tensor-core GEMV, exactly 7 x 8 x 15; its prefill and
   first decode logits within 5e-2 of the SIMT route's,
   ``gemm.forced_kernel("simt")``), two LoRA steps of 4 x 512 tokens through
   the wgmma kernels only (step 1's loss and adapter gradients within 5e-2 of
   the SIMT route's; a profiled step through each route and through the mma.sync
   kernels) and one of
   1 x 16 tokens through the GEMV and K10's decode regime (exact counts, its
   loss within 5e-2 of the SIMT route's).
11. Quantize on the card at full width: a random fp16 1-layer checkpoint,
   ``from_pretrained``, ``quantize`` with 64 calibration sequences of 256
   tokens for 4-bit g128, 4-bit g128 desc_act, 2-, 3- and 8-bit; seconds per
   layer by phase, the solver loss, GPTQ against round-to-nearest on every
   solve's own Hessian, ``save_quantized`` -> ``from_quantized`` with logits
   bit-equal to the in-memory model's, and the logit error against the fp
   model, which must fall from 2 to 8 bits.
12. K10 (``wna16_gemm_t``, the backward ``dx = g @ dequant(W)^T``) against
   ``wna16_matmul_t_ref`` at the three Llama-2-7B projection shapes, M in
   {10 (an adaption prompt's rows), 16 (a decode-sized batch), 17, 128, 2048
   (a 4 x 512 batch)}, 2-, 3-, 4- and 8-bit g128 plus a desc_act and a
   group-size-32 case, bf16 (timed) and f32; ``torch.matmul(g, W_bf16.T)`` on a
   pre-dequantized weight is the library yardstick. bf16 takes K10's split-N
   decode regime at M = 10 and 16 (bit-equal on a second call, with its
   plan) and the wgmma/TMA K10 above (bit-equal, with its plan); the 4-bit
   rows also hold and time the SIMT K10 and the mma.sync tile K10, both
   slower (else the run fails).
13. Training on the main-path model (full depth and width, 4-bit g128):
   ``utils.peft.get_gptq_peft_model`` with LoRA at the example's defaults (r 16,
   alpha 32, q_proj and v_proj), 8 ``torch.optim.AdamW`` steps at lr 1e-3 on
   one random batch of 4 x 512 tokens (one row left-padded, labels -100 on the
   pads, the example's masked loss); the loss of every step, seconds per step,
   tokens/s, peak memory, K1 and K10 launches per step (counts set to 0 just
   before each step and read just after: exactly 224 ``w4a16_gemm_wgmma`` and
   221 ``wna16_gemm_t_wgmma``), a
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
   experts): bf16 through the expert-major tensor-core GEMV (``_gemv``; bit-equal
   on a second call, its plan), timed beside the SIMT routed kernel on the same
   operands and beside the GEMV over a stack of the selected experts alone
   (what the expert slices that exit at once cost); f32 through the SIMT
   kernel; P ``torch.matmul`` calls on pre-dequantized bf16 experts are the
   library yardstick; a pair naming expert -1 or E writes nothing, sets the flag
   and ``check=True`` raises, through both kernels.
16. The Mixtral path: writes a random 4-bit g128 Mixtral-8x7B checkpoint at full
   width cut to 8 of its 32 layers (for time: every kernel and check of the path
   runs at any depth) under ``build/chip_smoke/``, ``from_quantized`` on the
   default device, ``params.stack_moe_experts``, deletes the checkpoint; greedy
   decode of 128 tokens from a 16-token prompt, then 16 again (equal to the
   first 16; launch counts set to 0 just before the first and read just after: K9's GEMV 96, no
   SIMT routed kernel, K2 32, K1's GEMV 128 per decode token), a profile by
   kernel family through both routes (no reduce, at most one K1 and one K9
   kernel per call on the new one), and 64 tokens of beam 4 over the paged bf16
   cache (K9's GEMV at P = 8, K7, the fused K8a, K8b; exact counts).
17. Mixtral card against CPU on a 2-layer full-width cut, f32 on both sides
   (logits of a prefill and of a routed decode step), the share of the
   CPU's routing choices that an f32 and a bf16 card run make, and one
   layer's ``moe_mlp`` on the card in f32, routed (K9) and dense stacked
   against the expert list (K1).
18. K6 (``w4a16_kb32l_gemm``, K1's function over the tile-contiguous kb32l
   words) against its plain version at the Llama-2-7B projection shapes, M in
   {1, 4, 16} (decode: the tensor-core GEMV over the kb32l tiles, bit-equal on a
   second call, beside its cp.async ring on the same words) and {128, 2048}
   (tile: the wgmma/TMA kernel over the kb32l tiles' 3-D map, bit-equal on a
   second call, beside the mma.sync kernel, ``kernel="mma"``, and at M = 128
   the SIMT tile kernel on the same words), 4-bit g128 bf16 and at M = 128 and 2048
   f16 (checked, not timed), plus 3-bit, desc_act, bias, N = 1312 and f32 (the
   ring) and f16 at M = 1; timed beside K1 on the same weights in the GPTQ layout (its tensor-core
   GEMV or wgmma kernel and, at M <= 16, its SIMT GEMV), the plain version and
   ``torch.matmul``; both decode plans (blocks, blocks per SM, weight bytes in
   flight per SM) and ptxas' registers and spills. K10 over kb32l words (one
   gate/up call) at M = 16 (its decode regime), 64, 128 and 2048 (the wgmma/TMA
   K10 over the tiles' 3-D map, bit-equal on a second call, one launch of
   ``w4a16_kb32l_gemm_t_wgmma``), timed beside K1's wgmma K10 on the same
   weights in GPTQ words (in turns; within 10% or NOT MET) and at M = 64 and
   128 beside the mma.sync K10 on the same words (slower, else the run
   fails).
19. The kb32l path: the main path's checkpoint loaded again with
   ``from_quantized(layout="kb32l")``; prefill logits against the GPTQ-layout
   model; 256 greedy tokens (counts set to 0 just before and read just after:
   K6's GEMV 7 x 32 per token, no ring, no K1), then 32 again, equal to the
   first 32; the share of tokens equal to the main path's; a profile of 17
   tokens through both routes (the ring's beside); a batch-2 generate whose
   32-row prefill runs K6's tile regime (exactly 224 ``w4a16_kb32l_gemm_wgmma``,
   no ``w4a16_kb32l_gemm_mma``), and its prefill again through the mma.sync
   kernel (``gemm.forced_kernel("mma")``); one LoRA step (r 16 on q/v, 4 x 512
   tokens): a finite loss, exactly 7 x 32 ``w4a16_kb32l_gemm_wgmma`` and
   7 x 32 - 3 ``w4a16_kb32l_gemm_t_wgmma``, no other K10 kernel. On
   the 2-layer cut, kb32l in f32 (the ring) on the card against the CPU. On
   the 2-layer Mixtral cut, ``dx`` through a layer's routed ``moe_mlp`` (K9's
   SIMT kernel forward in f32, K10 backward) on the card against the CPU.
20. The contiguous int8 KV cache (PR 20): the main path's model with
   ``kv_quant=True``, batch 1, the 16-token prompt, 64 greedy tokens through
   the decode step's graph: exactly 224 K1 GEMVs and 32 ``rope_write_kv``
   (K8a's contiguous int8 mode) per decode token, no ``flash_decode`` (the
   int8 cache takes the einsum, as the JAX package's does), its tokens equal
   to the per-op loop's, the count equal to the bf16 cache's run; K8a's
   contiguous int8 mode at that cache's shape bit-equal to its plain version
   (codes and scales). Mixtral's int8 beam 4 over 16 tokens takes the
   contiguous route (exact K9 and K1 counts, no K8a, K7, K8b or K2).
21. The paged serving engine (PR 20, ``serving_paged.py``): the main path's
   model, 8 slots, page 16, 48 pages per sequence, 160 pages, the prefix cache
   on; a trace of 24 requests drawn from a seed (prompts 16-480 tokens, 8
   sharing a 256-token prefix, 4 sampled at temperature 0.8, top-p 0.95,
   top-k 50; 32-192 new tokens) after ``warmup()``: no capture in the run,
   exactly 224 K1 GEMVs at M = 8, 32 ``rope_write_kv`` and 32
   ``paged_attention_mh`` per replayed step, at least one preemption and one
   prefix hit; the same streams and stats through the per-op loop; each
   sampled request alone on a fresh engine, the same stream; a profiled window
   of 16 steps (host against device ms per step); a shorter trace with
   ``decode_block = 4``, graph against per-op loop likewise; on the 2-layer
   f32 cut the engine's decode-step logits on the card within 1e-3 relative of
   the CPU engine's on one trace.
22. The slot engine (``serving.ContinuousBatchEngine``) on per-slot
   cursors: K8a's per-row mode at its shapes (8 rows of a 768-slot cache, bf16
   and int8, T = 1 over the whole cache and T = 5 on a 512-slot window; an idle
   row, a row parked on the last slot and one past it, dropped) bit-equal to
   its plain version, timed beside it and beside two ``index_put_``; K2 at the
   engine's per-row bounds (an idle row's hi = 1, a parked row's S, one past
   S). The main path's model, 8 slots of 768 positions, chunks of 256, the
   paged phase's 24 requests after ``warmup()``: no capture in the run,
   exactly 224 K1 GEMVs at M = 8, 32 ``rope_write_kv`` and 32 ``flash_decode``
   per replayed step, the same streams and stats through the per-op loop, a
   16-step window run twice on the same requests (host ms unprofiled, device
   ms profiled); a ``decode_block = 4`` trace and a ``kv_quant`` trace (no
   ``flash_decode``: the einsum), each against its per-op loop. Speculative
   ``generate`` (gamma 4, 128 tokens from the 16-token prompt) with the model
   as its draft and with its first 2 layers: tokens per target forward, tok/s,
   and the tokens equal to plain greedy's counted (bf16: the verify window's
   K1 at M = 5 and its einsum round otherwise than the step's K1 at M = 1 and
   K2); speculative serving of the trace's greedy requests with the model as
   its draft, streams counted against the plain engine's. On the f32 2-layer
   cut: the engine on the card against the CPU engine, every decode step's
   logits within 1e-3 relative; speculative ``generate`` (the cut and its
   first layer as drafts) equal to plain greedy and speculative serving's
   streams equal to the plain engine's, on the card.
23. Estimates K2's and K7's device time per token over a 512-token run from
   the sweeps, holds the wgmma/TMA tile kernels per Llama-2-7B layer against
   the mma.sync ones (faster at M = 128 and 2048, forward and K10; whether at most half
   its time at M = 2048 is reported), reports K6's wgmma kernel per layer
   against K1's on the same weights (within 10% or NOT MET), K10 over kb32l
   words per gate/up call against K1's wgmma K10 (within 10% or NOT MET), K1's
   wgmma prologue at M = 24 against the same kernel alone (within 10% or NOT
   MET) and the unfused pair, the fused GEMV at M = 1 to 16
   and at M = 16 against the GEMV alone (within 25% or NOT MET) and
   ``F.rms_norm`` + ``torch.matmul`` (below it or NOT MET), writes every
   measurement to
   ``build/chip_smoke.json`` and
   prints one JSON line of kernel measurements, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Every ``generate`` of a greedy or paged-beam path runs its decode steps from
one CUDA graph per call (``AUTOGPTQ_TPU_JIT_GENERATE``, default on): the
launch counts include the kernels each replay ran (``build.replayed`` says how
many), so every exact count above holds as in the per-op loop, and a kernel
entry's ``replayed`` gives the share of its ``launches`` that replays ran. The
profiles by kernel family run the per-op loop (``JIT_GENERATE`` off). The main
path, beam 4 (over bf16 and over int8 pools), Mixtral and the fused-norm
greedy run each add a turn of the per-op loop (64 tokens) beside their graph
run, with the same tokens, and a profiled replay window: rate, host ms per
token, capture and warm-up seconds, replayed launches and the device's busy
share of each.

Any failed check raises, so the script exits non-zero and prints no result
line. Times are medians of CUDA-event times of warmed calls with the 50 MB
L2 cache flushed before each call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
# K1: the kernel and its plain version both dequantize and accumulate in f32 (the
# wgmma/TMA kernels carry the weight as a bf16 hi/lo pair, about 16 bits) and
# round once to bf16 (2^-9 relative). Allowed: 1% of the largest output.
K1_REL_TOL = 1e-2
# K2: both sides are f32 on the same bf16 inputs and differ only in summation
# order and in exp; outputs are averages of values of order one.
K2_ABS_TOL = 1e-4
# Card (bf16 activations, bf16 KV cache, kernels) against CPU (f32, plain
# versions) after 2 full-width layers: relative Frobenius error of the logits.
E2E_REL_TOL = 5e-2
# The same with f32 activations on the card: f32 weights and accumulation on both sides (the
# SIMT GEMV and tile kernel), summation order only.
E2E_F32_REL_TOL = 1e-3
# K7: as K2, both sides f32 on the same inputs (int8 codes and f32 scales
# dequantized alike), differing only in summation order and exp.
K7_ABS_TOL = 1e-4
# K1/K4/K5 with f32 activations: f32 weights and accumulation on both sides,
# summation order only (K up to 11008 terms of order one).
F32_ABS_TOL = 1e-4
# K10: as K1, the weight as a bf16 hi/lo pair on the tensor cores; with f32
# cotangents F32_ABS_TOL.
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
REST_PATH_GROUP_SIZE = 100    # the rest-class path's group size: 16 does not divide it
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
KB32L_NEW_TOKENS = 256        # the kb32l path's and the fused norm's recorded greedy runs (512
FUSED_NEW_TOKENS = 256        # tokens), held to the main path's first tokens
PROFILE_TOKENS = 33
GRAPH_EAGER_TOKENS = 64       # the per-op loop's turn beside each CUDA graph run
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
MIXTRAL_LAYERS = 8            # depth of the Mixtral-8x7B path (of 32: cut for time)
MIXTRAL_NEW_TOKENS = 128
MIXTRAL_BEAM_TOKENS = 64
MIXTRAL_PROFILE_TOKENS = 17
MIXTRAL_INT8_BEAM_TOKENS = 16   # Mixtral's int8 beam 4: the contiguous route (as the JAX package's)
MIXTRAL_CUT_BEAM_TOKENS = 8     # the int8 beam on the 2-layer cut, card f32 against the CPU
INT8_NEW_TOKENS = 64          # the int8 greedy path: batch 1, the 16-token prompt, kv_quant=True
# The paged serving engine (serving_paged.py) on the main path's model: 8 slots of at most
# 48 pages of 16 tokens; a pool below the trace's peak demand, so that it preempts
SERVE_SLOTS, SERVE_PAGE, SERVE_PAGES_PER_SEQ, SERVE_TOTAL_PAGES = 8, 16, 48, 160
SERVE_REQUESTS, SERVE_SEED = 24, 20
SERVE_PROMPT = (16, 480)      # prompt lengths drawn from this range
SERVE_NEW = (32, 192)         # max_new_tokens drawn from this range
SERVE_PREFIX, SERVE_SHARING = 256, 8     # 8 requests share a 256-token prefix
SERVE_SAMPLED = 4             # sampled at SERVE_SAMPLING; the rest greedy
SERVE_SAMPLING = dict(temperature=0.8, top_p=0.95, top_k=50)
SERVE_BLOCK, SERVE_BLOCK_REQUESTS, SERVE_BLOCK_NEW = 4, 8, (32, 64)   # the decode_block run
SERVE_PROFILE_STEPS = 16      # engine steps in the profiled window
SERVE_CUT_REL_TOL = 1e-3      # the f32 2-layer cut's decode-step logits, card against CPU
# The slot engine (serving.ContinuousBatchEngine) on the main path's model: 8 slots of 768
# positions (the paged phase's longest request, 480 + 192 tokens, fits), prompts above 256
# tokens prefilled in chunks of 256. K8a's and K2's per-row cases: live rows, an idle row at 0,
# a row parked on the last slot and one past it; the verify window's on a view of VERIFY_WIN
# slots (the speculative step's window), one row's window ending on its last slot
SLOT_SEQ, SLOT_CHUNK = 768, 256
SLOT_CURSORS = (670, 0, 301, 528, SLOT_SEQ - 1, 17, 145, SLOT_SEQ + 3)
SPEC_GAMMA, SPEC_NEW_TOKENS, SPEC_DRAFT_LAYERS = 4, 128, 2
VERIFY_WIN = 512
VERIFY_CURSORS = (300, 0, 120, VERIFY_WIN - SPEC_GAMMA - 1, VERIFY_WIN - 1, 17, 145,
                  VERIFY_WIN + 3)
SLOT_CUT_REL_TOL = 1e-3       # the f32 2-layer cut's decode-step logits, card against CPU
SPEC_CUT_TOKENS = 24          # speculative generate on the f32 cut, held to plain greedy
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


# K1's fused RMS-norm prologue: the projections that follow a norm in a Llama-2-7B
# layer, (K, N, calls per decoder layer); Llama-2-7B's eps. Against the plain version (the
# unfused norm, then the f32-weight plain matmul): bf16/f16 K1_REL_TOL of the largest output,
# f32 PRENORM_F32_REL_TOL of it (f32 weights and accumulation on both sides: summation order,
# and the order of the norm's sum of squares, only). The f32 2-layer cut with the switch on,
# card against CPU: E2E_F32_REL_TOL on the logits, tokens equal.
PRENORM_SHAPES = {"qkv": (4096, 4096, 3), "gate_up": (4096, 11008, 2)}
PRENORM_EPS = 1e-5
PRENORM_F32_REL_TOL = 1e-5
NORM_KEY = {"gemv": "w4a16_gemm_gemv_norm", "wgmma": "w4a16_gemm_wgmma_norm",
            "mma": "w4a16_gemm_mma_norm", "simt": "w4a16_gemm_norm"}
FUSED_AB_TOKENS = 48          # beam-4 runs off, on, on, off: host time in turns
FUSED_BATCH, FUSED_BATCH_TOKENS = 24, 8   # a bf16 batch whose decode steps take the wgmma prologue
FUSED_CUT_TOKENS = 4          # f32 cut with the switch on: greedy tokens at batch 1 and 24
REPEAT_TOKENS = 32            # the kb32l path's repeat, held to its 512-token run's first tokens
MIXTRAL_REPEAT_TOKENS = 16    # the Mixtral path's repeat, likewise
KB32L_PROFILE_TOKENS = 17     # the kb32l path's profiled window through both routes
WITHIN = 0.10                 # K6's and the wgmma prologue's targets: within 10% of K1's / alone
PRENORM_TIMED_CASE = "M=24 bf16"   # the wgmma prologue case timed beside mma.sync's
RSTD_TIMED_CASES = ("M=1 bf16", "M=16 bf16", PRENORM_TIMED_CASE)   # the rstd kernel timed alone
GEMV_NORM_M = (1, BEAMS, 8, 9, 16)   # the fused GEMV's rows timed beside the GEMV alone
GEMV_NORM_WITHIN = 0.25       # the fused GEMV at M = 16: within 25% of the GEMV alone (target)
FUSED_BATCH16, FUSED_BATCH16_TOKENS = 16, 8   # a bf16 batch whose decode steps take the rstd launch
# Its decode step's logits, switch on against off, bf16, 32 layers, relative Frobenius error:
# the two differ in the rows' rstd (the rstd kernel's f32 sum against torch's, in another
# order), which moves single bf16 roundings of x_n. Set from the readings, a few times the
# largest of the sound runs (1.119e-3 on the H100); two planted faults, each row normalized by
# its neighbour's rstd or by the previous fused call's, are held above it in every run.
FUSED_STEP_REL_TOL = 5e-3
RSTD_REL_TOL = 1e-5           # the prologue's rstd against its plain version: f32 sum order

MMA_SOURCE = "autogptq_tpu_torch/ops/csrc/wna16_mma.cuh"   # the mma.sync tile kernels
WGMMA_SOURCE = "autogptq_tpu_torch/ops/csrc/wna16_wgmma.cuh"  # the wgmma/TMA tile kernels
GEMV_SOURCE = "autogptq_tpu_torch/ops/csrc/wna16_gemv.cuh"  # the tensor-core decode GEMV
ROUTE_SUFFIX = {"gemv": "_gemv", "wgmma": "_wgmma", "mma": "_mma",
                "simt": ""}  # launch-count key by gemm.route


class Counts(dict):
    """A snapshot of ``build.launches`` (every launch that ran, a CUDA graph's
    replays included) with the share of them that graph replays ran
    (``replayed``) and the captures, replays and their host seconds
    (``graphs``)."""

    replayed: dict = {}
    graphs: dict = {}


def clear_counts(build) -> None:
    """Set the launch, replay and graph counts to 0."""
    build.launches.clear()
    build.replayed.clear()
    build.graphs.clear()


def snapshot(build) -> Counts:
    counts = Counts(build.launches)
    counts.replayed, counts.graphs = dict(build.replayed), dict(build.graphs)
    return counts


@contextlib.contextmanager
def jit_generate(on: bool):
    """``generation.JIT_GENERATE`` set to ``on`` inside, put back after."""
    from autogptq_tpu_torch.utils import generation

    old, generation.JIT_GENERATE = generation.JIT_GENERATE, on
    try:
        yield
    finally:
        generation.JIT_GENERATE = old


@contextlib.contextmanager
def python_calls():
    """Counts the Python calls of ``arch.apply_rope`` and of
    ``Tensor.index_copy_`` inside: the prefill's, the eager warm-up step's
    and the capture's (a CUDA graph's replays make none)."""
    import collections

    import torch
    from autogptq_tpu_torch.models import arch

    calls = collections.Counter()
    real_rope, real_copy = arch.apply_rope, torch.Tensor.index_copy_

    def rope(*a, **kw):
        calls["apply_rope"] += 1
        return real_rope(*a, **kw)

    def index_copy_(self, *a, **kw):
        calls["index_copy_"] += 1
        return real_copy(self, *a, **kw)

    arch.apply_rope, torch.Tensor.index_copy_ = rope, index_copy_
    try:
        yield calls
    finally:
        arch.apply_rope, torch.Tensor.index_copy_ = real_rope, real_copy


def python_steps(steps: int) -> int:
    """How many of a generate's ``steps`` one-token decode steps run their
    Python: all of them eagerly, two with the CUDA graph (the warm-up and the
    capture; the replays run none)."""
    from autogptq_tpu_torch.utils import generation

    return min(steps, 2) if generation.JIT_GENERATE else steps


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
    """Median CUDA-event time of a warmed call, L2 flushed before each call
    (the median, not the mean: one stalled call, 1.9 ms among calls of
    0.04 ms in one run, must not decide a comparison). A GPU-side spin between
    the flush and the start event keeps the card busy while the host enqueues
    the call, so the events time the device work and not the host's launch
    overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return (times[(iters - 1) // 2] + times[iters // 2]) / 2


def bound_ms(nbytes: float, flops: float, rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def simt_matmul(gemm, qlin, x, layer):
    """``qlin.matmul(x, layer)`` through the layer's SIMT kernels (GEMV or SIMT
    tile kernel) whatever ``gemm.route`` would pick: the tensor-core kernels'
    yardstick on the same weights."""
    if layer.layout == "kb32l":
        return gemm.w4a16_kb32l_matmul(x, layer.qweight, layer.scales, layer.zeros, layer.kperm,
                                       layer.bias, layer.group_size, layer.out_features,
                                       kernel="simt")
    return gemm.wna16_matmul(x, layer.qweight, layer.scales, layer.zeros, layer.kperm,
                             layer.bias, layer.group_size, qlin.storage_bits(layer.bits),
                             kernel="simt")


def gemv_plan_of(torch, gemm, dtype, k, n, m, gs, bits, library=None, experts=None) -> dict:
    """The decode GEMV's plan with its blocks per SM (the occupancy
    calculator) and the weight bytes in flight per SM: the blocks resident
    on an SM times the stages in flight per block (three of the ring's four,
    or all of a shorter split) times a stage's bytes of words. ``library``
    names K6's or K9's GEMV; ``experts`` (K9) the stack's E, ``m`` its P."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = (gemm.gemv_plan(k, n, m, gs, bits, sms) if experts is None
            else gemm.routed_plan(k, n, m, experts, gs, bits, sms))
    per_sm = gemm.gemv_blocks_per_sm(dtype, m, bits, plan["kc"], library)
    resident = min(per_sm, -(-plan["blocks"] // sms))
    stages = min(gemm.GEMV_STAGES - 1, -(-plan["kc"] // plan["stage_k"]))
    plan.update(blocks_per_sm=per_sm,
                weight_bytes_in_flight_per_sm=resident * stages * plan["stage_word_bytes"])
    return plan


def phase_k1(torch, np, timer) -> list:
    """K1 against its plain version at the Llama-2-7B shapes (M = SERVE_SLOTS is
    the paged serving engine's decode step); at M <= 16 the
    tensor-core decode GEMV and at M > 16 the wgmma/TMA tile kernel (bf16),
    each beside the SIMT GEMV or SIMT tile kernel on the same weights (the
    wgmma kernel also beside the mma.sync tile kernel), each held to
    K1_REL_TOL and timed; the GEMV and the wgmma kernel also bit-equal on a
    second call with one launch of their key, each with its plan."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin
    from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors

    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(name, k, n, m, False, False)
             for m in (1, BEAMS, 16, 128, TRAIN_M) for name, (k, n, _) in LAYER_SHAPES.items()]
    cases += [("qkvo+desc_act", 4096, 4096, 1, True, False),
              ("gate_up+bias", 4096, 11008, 16, False, True)]
    cases += [(name, k, n, SERVE_SLOTS, False, False) for name, (k, n, _) in LAYER_SHAPES.items()]
    rows = []
    for name, k, n, m, desc_act, with_bias in cases:
        t = random_quant_tensors(rng, k, n, 4, 128, desc_act)
        bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
        layer = qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=bias, bits=4, group_size=128, in_features=k, out_features=n), device="cuda")
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        route = gemm.route(x.dtype, m, 128, k=k, n=n)
        key = "w4a16_gemm" + ROUTE_SUFFIX[route]
        before = snapshot(build)
        y = qlin.matmul(x, layer)
        check(all(build.launches[c] == before.get(c, 0) + (c == key)
                  for c in ("w4a16_gemm" + sfx for sfx in ROUTE_SUFFIX.values())),
              f"K1 {name} M={m}: launched {snapshot(build)}, want one {key}")
        ref = qlin.matmul_plain(x, layer)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(bool(torch.isfinite(y).all()), f"K1 {name} M={m}: non-finite output")
        check(err <= K1_REL_TOL * scale, f"K1 {name} M={m}: max |kernel - plain| = {err:.3e} "
                                         f"> {K1_REL_TOL} * {scale:.3e}")
        iters = 5 if m == TRAIN_M else 20
        simt = {}
        if route == "wgmma":   # the mma.sync tile kernel on the same weights
            def mma():
                return gemm.wna16_matmul(x, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm, layer.bias, layer.group_size, 4,
                                         kernel="mma")
            ym = mma()
            torch.cuda.synchronize()
            merr = (ym.float() - ref.float()).abs().max().item()
            check(merr <= K1_REL_TOL * scale, f"K1 mma {name} M={m}: max |kernel - plain| = "
                                              f"{merr:.3e} > {K1_REL_TOL} * {scale:.3e}")
            check(torch.equal(qlin.matmul(x, layer), y), f"K1 wgmma {name} M={m}: a second "
                                                         "call differs")
            simt.update(mma_max_abs_err=merr, mma_ms=timer.ms(mma, iters=iters),
                        plan=gemm.wgmma_plan(m, k, n, 128, 4, torch.cuda.get_device_properties(
                            0).multi_processor_count))
        if route in ("wgmma", "gemv"):   # the SIMT GEMV or tile kernel on the same weights
            ys = simt_matmul(gemm, qlin, x, layer)
            torch.cuda.synchronize()
            serr = (ys.float() - ref.float()).abs().max().item()
            check(serr <= K1_REL_TOL * scale, f"K1 SIMT {name} M={m}: max |kernel - plain| = "
                                              f"{serr:.3e} > {K1_REL_TOL} * {scale:.3e}")
            simt.update(simt_max_abs_err=serr, simt_ms=timer.ms(
                lambda: simt_matmul(gemm, qlin, x, layer), iters=iters))
        if route == "gemv":
            check(torch.equal(qlin.matmul(x, layer), y), f"K1 GEMV {name} M={m}: a second call "
                                                         "differs")
            simt["plan"] = gemv_plan_of(torch, gemm, x.dtype, k, n, m, 128, 4)
        w = qlin.logical_weight(layer, torch.bfloat16)
        ms = timer.ms(lambda: qlin.matmul(x, layer), iters=iters)
        check(route != "wgmma" or ms < simt["mma_ms"],
              f"K1 {name} M={m}: the wgmma kernel {ms:.4f} ms is not faster than the mma.sync "
              f"tile kernel {simt.get('mma_ms', 0):.4f} ms")
        plain_ms = timer.ms(lambda: qlin.matmul_plain(x, layer), iters=min(iters, 10))
        lib_ms = timer.ms(lambda: torch.matmul(x, w), iters=iters)
        b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                     layer.kperm, layer.bias), 2.0 * m * k * n)
        rows.append(dict(case=name, K=k, N=n, M=m, route=route, max_abs_err=err,
                         max_abs_ref=scale, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, **simt))
        print(f"K1 {name:14s} K={k:5d} N={n:5d} M={m:4d} {route:4s}  err {err:.3e} (tol "
              f"{K1_REL_TOL * scale:.3e})  kernel {ms:.4f} ms ({2.0 * m * k * n / ms / 1e9:.1f} "
              f"TFLOP/s)" + (f"  SIMT {'GEMV' if route == 'gemv' else 'tile'} "
                             f"{simt['simt_ms']:.4f} ms (err {simt['simt_max_abs_err']:.3e})"
                             if simt else "")
              + (f"  mma.sync {simt['mma_ms']:.4f} ms (err {simt['mma_max_abs_err']:.3e})"
                 if "mma_ms" in simt else "")
              + f"  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound {b_ms:.4f} ms "
                f"({b_by})" + (f"  plan {simt['plan']}" if "plan" in simt else ""), flush=True)
    return rows

def phase_prenorm(torch, np, timer) -> list:
    """K1's fused RMS-norm prologue against its plain version (``rms_apply``,
    then the plain matmul with f32 weights) on one Llama-2-7B layer's q/k/v and
    gate/up, g128: each route once (the tensor-core GEMV at M = 1, 4, 16 in bf16
    and f16, the SIMT GEMV at M = 1 in f32, the wgmma/TMA tile kernel at M = 17,
    24 and 31 in bf16 and 24 in f16, the SIMT tile kernel at M = 24 in f32, a
    3-bit and a ``plus_one`` case), one launch of its own key, bit-equal on a
    second call; timed beside the same kernel without the prologue, the unfused
    pair (``rms_apply`` + the kernel), the plain version and the library
    (``F.rms_norm`` + ``torch.matmul`` on a pre-dequantized weight of the
    activation type); the wgmma and GEMV cases launch the rows' rstd first
    (``w4a16_gemm_wgmma_norm_rstd``: by ``gemm.prenorm_rstd`` before the wgmma
    kernel, by the GEMV's entry before the GEMV), one launch of its key; in
    every bf16 and f16 case it is also called alone and held to its plain
    version, ``rsqrt(mean(x^2) + eps)`` in torch, to ``RSTD_REL_TOL``, and
    timed in ``RSTD_TIMED_CASES``; the wgmma cases run the mma.sync tile
    kernel's prologue on the same operands (``kernel="mma"``:
    ``w4a16_gemm_mma_norm``), held to the same tolerance and timed at M = 24
    bf16."""
    import torch.nn.functional as F

    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    layers = {(bits, proj): _random_layer(qlin, rng, k, n, bits, 128, False, bf16)
              for bits in (4, 3) for proj, (k, n, _) in PRENORM_SHAPES.items()}
    # (case, M, bits, dtype, plus_one)
    cases = [(f"M={m} {tag}", m, 4, dt, False) for m in (1, BEAMS, 16)
             for tag, dt in (("bf16", bf16), ("f16", f16))]
    cases += [(f"M={m} bf16", m, 4, bf16, False) for m in GEMV_NORM_M if m not in (1, BEAMS, 16)]
    cases += [("M=1 f32", 1, 4, f32, False), ("M=24 bf16", 24, 4, bf16, False),
              ("M=17 bf16", 17, 4, bf16, False), ("M=31 bf16", 31, 4, bf16, False),
              ("M=24 f16", 24, 4, f16, False),
              ("M=24 f32", 24, 4, f32, False), ("M=1 bf16 3-bit", 1, 3, bf16, False),
              (f"M={BEAMS} bf16 plus_one", BEAMS, 4, bf16, True)]
    rows = []
    for case, m, bits, dtype, plus_one in cases:
        for proj, (k, n, _) in PRENORM_SHAPES.items():
            layer = layers[bits, proj]
            x = 4.0 * torch.randn((m, k), generator=gen, device="cuda", dtype=f32)
            x = x.to(dtype)
            w = (1.0 + 0.1 * torch.randn((k,), generator=gen, device="cuda")).to(dtype)
            pn = (w, PRENORM_EPS, plus_one)
            route = gemm.route(dtype, m, 128, k=k, n=n)
            key = NORM_KEY[route]
            check(gemm.prenorm_eligible(m, k, 128, bits), f"prenorm {case} {proj}: not eligible")
            before = snapshot(build)
            y = qlin.matmul(x, layer, prenorm=pn)
            launched = {kk: v - before.get(kk, 0) for kk, v in build.launches.items()
                        if v != before.get(kk, 0)}
            want_launched = {key: 1, **({gemm.RSTD_KERNEL: 1} if route in ("wgmma", "gemv")
                                        else {})}
            check(launched == want_launched, f"prenorm {case} {proj}: launched {launched}, want "
                                             f"{want_launched}")
            xn = gemm.rms_apply(x, *pn)
            ref = qlin.matmul_plain(xn, layer)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = (PRENORM_F32_REL_TOL if dtype == f32 else K1_REL_TOL) * scale
            check(y.shape == (m, n) and bool(torch.isfinite(y).all()),
                  f"prenorm {case} {proj}: bad output")
            check(err <= tol, f"prenorm {case} {proj}: max |kernel - plain| = {err:.3e} > "
                              f"{tol:.3e}")
            check(torch.equal(qlin.matmul(x, layer, prenorm=pn), y),
                  f"prenorm {case} {proj}: a second call differs")
            mma = {}
            if dtype != f32:   # the rows' rstd alone, as the GEMV and wgmma prologues take it
                def rstd_plain():
                    return torch.rsqrt(x.float().pow(2).mean(-1) + PRENORM_EPS)

                r_ref = rstd_plain()
                r = gemm.prenorm_rstd(x, PRENORM_EPS)
                torch.cuda.synchronize()
                rerr = (r - r_ref).abs().max().item()
                check(rerr <= RSTD_REL_TOL * r_ref.abs().max().item()
                      and torch.equal(gemm.prenorm_rstd(x, PRENORM_EPS), r),
                      f"prenorm {case} {proj} rstd: max |kernel - plain| = {rerr:.3e}")
                mma = dict(rstd_max_abs_err=rerr)
                if case in RSTD_TIMED_CASES:
                    r_b_ms, r_b_by = bound_ms(nbytes(x, r), 2.0 * m * k)
                    mma.update(rstd_ms=timer.ms(lambda: gemm.prenorm_rstd(x, PRENORM_EPS)),
                               rstd_plain_ms=timer.ms(rstd_plain), rstd_bound_ms=r_b_ms,
                               rstd_bound_by=r_b_by)
            if route == "wgmma":   # the mma.sync prologue on the same operands
                def mma_norm():
                    with gemm.forced_kernel("mma"):
                        return qlin.matmul(x, layer, prenorm=pn)

                before = build.launches[NORM_KEY["mma"]]
                ym = mma_norm()
                check(build.launches[NORM_KEY["mma"]] == before + 1,
                      f"prenorm {case} {proj}: kernel='mma' launched no {NORM_KEY['mma']}")
                torch.cuda.synchronize()
                merr = (ym.float() - ref.float()).abs().max().item()
                check(merr <= tol, f"prenorm {case} {proj} mma.sync: max |kernel - plain| = "
                                   f"{merr:.3e} > {tol:.3e}")
                mma.update(mma_max_abs_err=merr)
                if case == PRENORM_TIMED_CASE:
                    mma.update(mma_ms=timer.ms(mma_norm))
            wl = qlin.logical_weight(layer, dtype)
            wlib = (1.0 + w.float()).to(dtype) if plus_one else w
            ms = timer.ms(lambda: qlin.matmul(x, layer, prenorm=pn))
            kernel_ms = timer.ms(lambda: qlin.matmul(xn, layer))
            unfused_ms = timer.ms(lambda: qlin.matmul(gemm.rms_apply(x, *pn), layer))
            plain_ms = timer.ms(lambda: qlin.matmul_plain(gemm.rms_apply(x, *pn), layer),
                                iters=5, warmup=1)
            lib_ms = timer.ms(lambda: torch.matmul(F.rms_norm(x, (k,), wlib, PRENORM_EPS), wl))
            b_ms, b_by = bound_ms(nbytes(x, y, w, layer.qweight, layer.scales, layer.zeros),
                                  2.0 * m * k * n)
            rows.append(dict(case=case, proj=proj, K=k, N=n, M=m, bits=bits, dtype=str(dtype),
                             plus_one=plus_one, route=route, key=key, max_abs_err=err,
                             max_abs_ref=scale, tol=tol, ms=ms, kernel_ms=kernel_ms,
                             unfused_ms=unfused_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by, **mma))
            print(f"prenorm {case:20s} {proj:7s} K={k:5d} N={n:5d} {route:5s} err {err:.3e} "
                  f"(tol {tol:.3e})  fused {ms:.4f} ms  kernel alone {kernel_ms:.4f} ms  "
                  + (f"mma.sync prologue err {mma['mma_max_abs_err']:.3e}  "
                     if "mma_max_abs_err" in mma else "")
                  + (f"rstd err {mma['rstd_max_abs_err']:.3e}  " if mma else "")
                  + (f"mma.sync prologue {mma['mma_ms']:.4f} ms  " if "mma_ms" in mma else "")
                  + (f"rstd alone {mma['rstd_ms']:.4f} ms (plain {mma['rstd_plain_ms']:.4f} ms, "
                     f"bound {mma['rstd_bound_ms']:.4f} ms)  " if "rstd_ms" in mma else "")
                  +
                  f"unfused (rms_apply + kernel) {unfused_ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"F.rms_norm + torch.matmul {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    del layers
    return rows


def prenorm_layer(rows: list, case: str, key: str) -> float:
    """One Llama-2-7B layer's q/k/v and gate/up (``PRENORM_SHAPES``) of a case."""
    return sum(r[key] * PRENORM_SHAPES[r["proj"]][2] for r in rows if r["case"] == case)


def template_flags(function: str) -> list:
    """The bool template arguments of a mangled kernel name (``Lb<0|1>E``), in order."""
    import re

    return [f == "1" for f in re.findall(r"Lb([01])E", function)]


def prenorm_ptxas() -> list:
    """ptxas' registers and spills of every fused-prologue instance (the PRENORM
    template flag: the last bool template argument, the first of the tensor-core
    tile kernel's PRENORM and ANY_GS; the wgmma/TMA kernel's own entry and its
    rstd kernel) in K1's library: 4 tensor-core GEMVs, 2 wgmma/TMA tile kernels
    and 2 of their rstd kernels, 2 mma.sync tile kernels, 15 SIMT GEMVs and 3
    SIMT tile kernels; a spill in a GEMV, wgmma or rstd instance fails the
    run."""
    out = [dict(r, library="w4a16_gemm") for r in ptxas_report("w4a16_gemm", "")
           if "prenorm_wgmma_kernel" in r["function"] or "wg_rstd_kernel" in r["function"] or (
               template_flags(r["function"]) and template_flags(r["function"])[
                   0 if "wna16_mma_kernel" in r["function"] else -1])]
    kinds = {kind: [r for r in out if kind in r["function"]] for kind in
             ("wna16_gemv_kernel", "prenorm_wgmma_kernel", "wg_rstd_kernel", "wna16_mma_kernel",
              "wna16_decode_kernel", "wna16_prefill_kernel")}
    check([len(v) for v in kinds.values()] == [4, 2, 2, 2, 15, 3] and len(out) == 28,
          f"fused-prologue instances in the ptxas log: { {k: len(v) for k, v in kinds.items()} }"
          f", {len(out)} in all; want 4, 2, 2, 2, 15, 3")
    for r in out:
        print(f"ptxas prenorm {r['function'][:90]}: {r['registers']} registers, spill "
              f"{r['spill_stores']}/{r['spill_loads']} B", flush=True)
    for r in kinds["wna16_gemv_kernel"] + kinds["prenorm_wgmma_kernel"] + kinds["wg_rstd_kernel"]:
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"{r['function']} spills {r['spill_stores']}/{r['spill_loads']} B")
    return out


def _random_layer(qlin, rng, k, n, bits, gs, desc_act, dtype, layout=None, bias=False):
    from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors

    t = random_quant_tensors(rng, k, n, bits, gs, desc_act)
    return qlin.from_packed(qlin.PackedQuantLinear(
        qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
        bias=rng.standard_normal(n).astype("float32") if bias else None, bits=bits,
        group_size=gs, in_features=k, out_features=n), device="cuda", dtype=dtype, layout=layout)


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
    the GPTQ layout, the plain version and torch.matmul; at M <= 16 (bf16,
    f16) its tensor-core GEMV over the kb32l tiles beside its cp.async ring
    (``kernel="simt"``) on the same words, bit-equal on a second call, with
    both plans; f32 takes the ring. At M = 128 and 2048 (bf16, f16) the
    wgmma/TMA kernel over the kb32l tiles' 3-D map, bit-equal on a second call,
    beside the mma.sync kernel (``kernel="mma"``, held to the same tolerance);
    in bf16 both timed, with the wgmma plan and, at M = 128, the SIMT tile
    kernel on the same words (f16 there is checked, not timed)."""
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
    cases += [(f"{name} f16", k, n, m, 4, False, False, f16)
              for m in (128, TRAIN_M) for name, (k, n, _) in LAYER_SHAPES.items()]
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
        before = snapshot(build)
        y = qlin.matmul(x, layer)
        route = gemm.kb32l_route(dtype, m, 128, k=k, n=n)
        keys = [gemm.KB32L_KERNEL + suffix for suffix in ROUTE_SUFFIX.values()]
        key = gemm.KB32L_KERNEL + ROUTE_SUFFIX[route]
        check(all(build.launches[k6] == before.get(k6, 0) + (k6 == key) for k6 in keys)
              and all(build.launches["w4a16_gemm" + sfx] == before.get("w4a16_gemm" + sfx, 0)
                      for sfx in ROUTE_SUFFIX.values()),
              f"K6 {name} M={m}: launched {snapshot(build)}")
        ref = qlin.matmul_plain(x, layer)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (K6_F32_REL_TOL if dtype == f32 else K1_REL_TOL) * scale
        check(y.shape == (m, n) and bool(torch.isfinite(y).all()), f"K6 {name} M={m}: bad output")
        check(err <= tol, f"K6 {name} M={m} {dtype}: max |kernel - plain| = {err:.3e} > {tol:.3e}")
        check(torch.equal(qlin.matmul(x, layer), y), f"K6 {name} M={m}: not deterministic")
        iters = 5 if m == TRAIN_M else 20
        timed = not (dtype == f16 and route == "wgmma")
        simt = {}
        if route == "wgmma":   # the mma.sync kernel on the same words
            def mma():
                with gemm.forced_kernel("mma"):
                    return qlin.matmul(x, layer)

            before = build.launches[gemm.KB32L_KERNEL + gemm.MMA_SUFFIX]
            ym = mma()
            check(build.launches[gemm.KB32L_KERNEL + gemm.MMA_SUFFIX] == before + 1,
                  f"K6 {name} M={m}: kernel='mma' launched no {gemm.KB32L_KERNEL}_mma")
            torch.cuda.synchronize()
            merr = (ym.float() - ref.float()).abs().max().item()
            check(merr <= tol, f"K6 mma.sync {name} M={m}: max |kernel - plain| = {merr:.3e} > "
                               f"{tol:.3e}")
            simt.update(mma_max_abs_err=merr)
        if not timed:
            rows.append(dict(case=name, K=k, N=n, M=m, bits=bits, desc_act=desc_act,
                             bias=with_bias, dtype=str(dtype), route=route, max_abs_err=err,
                             max_abs_ref=scale, tol=tol, **simt))
            print(f"K6 {name:14s} K={k:5d} N={n:5d} M={m:4d} {str(dtype)[6:]:8s} {route:4s} err "
                  f"{err:.3e} (tol {tol:.3e})  mma.sync err {simt['mma_max_abs_err']:.3e}  "
                  f"(checked, not timed)", flush=True)
            del layer, gptq
            continue
        w = qlin.logical_weight(layer, dtype)
        if route == "wgmma":
            simt.update(mma_ms=timer.ms(mma, iters=iters),
                        wgmma_plan=gemm.wgmma_plan(m, k, n, 128, bits, sms, layout="kb32l"))
        # the ring, or the SIMT tile kernel at M = 128 (at 2048 it took 47.88 ms a layer: dropped)
        if route == "gemv" or (route == "wgmma" and dtype == bf16 and m != TRAIN_M):
            ys = simt_matmul(gemm, qlin, x, layer)
            torch.cuda.synchronize()
            serr = (ys.float() - ref.float()).abs().max().item()
            check(serr <= tol, f"K6 {'ring' if route == 'gemv' else 'SIMT'} {name} M={m}: max "
                               f"|kernel - plain| = {serr:.3e} > {tol:.3e}")
            simt.update(simt_max_abs_err=serr, simt_ms=timer.ms(
                lambda: simt_matmul(gemm, qlin, x, layer), iters=iters))
        ms = timer.ms(lambda: qlin.matmul(x, layer), iters=iters)
        k1_ms = timer.ms(lambda: qlin.matmul(x, gptq), iters=iters)
        if gemm.route(dtype, m, 128) == "gemv":   # K1's SIMT GEMV on the same words
            simt["k1_simt_ms"] = timer.ms(lambda: simt_matmul(gemm, qlin, x, gptq), iters=iters)
        plain_ms = timer.ms(lambda: qlin.matmul_plain(x, layer), iters=min(iters, 5), warmup=1)
        lib_ms = timer.ms(lambda: torch.matmul(x, w), iters=iters)
        b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                     layer.kperm, layer.bias), 2.0 * m * k * n)
        plan = gemm.kb32l_plan(k, n, m, 128, sms)   # the ring's (f32, or kernel="simt")
        if plan["regime"] == "decode":
            per_sm = gemm.kb32l_blocks_per_sm(dtype, m, 128, plan["tiles_per_split"])
            resident = min(per_sm, -(-plan["blocks"] // sms))
            plan.update(nbuf=gemm.KB32L_NBUF, blocks_per_sm=per_sm,
                        weight_bytes_in_flight_per_sm=resident * min(
                            gemm.KB32L_NBUF, plan["tiles_per_split"]) * plan["stage_bytes"])
        if route == "gemv":
            check(torch.equal(qlin.matmul(x, layer), y), f"K6 GEMV {name} M={m}: a second "
                                                         "call differs")
            simt["gemv_plan"] = gemv_plan_of(torch, gemm, dtype, k, n, m, 128, bits,
                                             library=gemm.KB32L_KERNEL)
        rows.append(dict(case=name, K=k, N=n, M=m, bits=bits, desc_act=desc_act,
                         bias=with_bias, dtype=str(dtype), route=route, max_abs_err=err,
                         max_abs_ref=scale, tol=tol, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, plan=plan, **simt))
        print(f"K6 {name:14s} K={k:5d} N={n:5d} M={m:4d} {str(dtype)[6:]:8s} {route:4s} err "
              f"{err:.3e} (tol {tol:.3e})  kernel {ms:.4f} ms"
              + (f"  {'ring' if route == 'gemv' else 'SIMT tile'} {simt['simt_ms']:.4f} ms"
                 if "simt_ms" in simt else "")
              + (f"  mma.sync {simt['mma_ms']:.4f} ms (err {simt['mma_max_abs_err']:.3e})"
                 if "mma_ms" in simt else "")
              + f"  K1 {k1_ms:.4f} ms"
              + (f" (SIMT GEMV {simt['k1_simt_ms']:.4f} ms)" if "k1_simt_ms" in simt else "")
              + f"  plain {plain_ms:.4f} ms  "
              f"torch.matmul {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
              + (f"GEMV plan {simt['gemv_plan']}  ring " if "gemv_plan" in simt else "")
              + (f"wgmma plan {simt['wgmma_plan']}  ring " if "wgmma_plan" in simt else "")
              + f"plan {plan}", flush=True)
        del layer, gptq, w
    ptxas = ptxas_report(gemm.KB32L_KERNEL, "kb32l")
    print("K6 ptxas: " + "; ".join(f"{r['function']}: {r['registers']} registers, spill "
                                   f"{r['spill_stores']}/{r['spill_loads']} B"
                                   for r in ptxas), flush=True)
    return dict(rows=rows, ptxas=ptxas)


def phase_wna16(torch, np, timer) -> list:
    """K4, K5 and K1's other shape classes against their plain versions; at
    M <= 16 (bf16, 16 | gs) the tensor-core decode GEMV, bit-equal on a
    second call and timed beside the SIMT GEMV on the same weights."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = {name: (k, n) for name, (k, n, _) in LAYER_SHAPES.items()}
    # (bits, projection, group size, desc_act, bias)
    layers = [(bits, name, 128, False, False) for bits in (8, 2, 3) for name in shapes]
    layers += [(8, "down", 128, True, True), (2, "down", 128, True, True),
               (3, "qkvo", 128, True, True)]
    # K1 at the classes of the TPU's ki32 (one group, any K % 8 == 0) and kpair (any group
    # size 8 divides) kernels
    layers += [(4, "qkvo", -1, False, False), (4, "down", -1, False, False),
               (4, "qkvo", 16, False, False), (4, "gate_up", 64, False, False),
               (4, "down", 64, True, False), (3, "down", -1, False, False)]
    # K5 at the class of the TPU's kquad kernel (group sizes below 128), K4 at a small group
    layers += [(2, "qkvo", 64, False, False), (2, "down", 32, True, False),
               (8, "qkvo", 32, False, False)]
    rows = []
    for bits, name, gs, desc_act, with_bias in layers:
        k, n = shapes[name]
        kernel = KERNEL_OF_BITS[bits]
        layer = _random_layer(qlin, rng, k, n, bits, gs, desc_act, torch.bfloat16,
                              bias=with_bias)
        w = qlin.logical_weight(layer, torch.bfloat16)
        case = (f"{bits}-bit {name} g{gs}" + ("+desc_act" if desc_act else "")
                + ("+bias" if with_bias else ""))
        for m in (1, BEAMS, 16, 17, 128):
            x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            route = gemm.route(x.dtype, m, k if gs == -1 else gs)
            key = kernel + ROUTE_SUFFIX[route]
            before = snapshot(build)
            y = qlin.matmul(x, layer)
            check(build.launches[key] == before.get(key, 0) + 1
                  and (key == kernel or build.launches[kernel] == before.get(kernel, 0)),
                  f"{case} M={m}: launched {snapshot(build)}, want one {key}")
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
            simt = {}
            if route == "wgmma":   # bit-equal again, the mma.sync kernel on the same weights
                check(torch.equal(qlin.matmul(x, layer), y), f"{case} M={m}: the wgmma kernel's "
                                                             "second call differs")

                def mma():
                    return gemm.wna16_matmul(x, layer.qweight, layer.scales, layer.zeros,
                                             layer.kperm, layer.bias, layer.group_size,
                                             qlin.storage_bits(bits), kernel="mma")
                ym = mma()
                torch.cuda.synchronize()
                merr = (ym.float() - ref.float()).abs().max().item()
                check(merr <= K1_REL_TOL * scale, f"{case} M={m} mma.sync: max |kernel - plain| "
                                                  f"= {merr:.3e} > {K1_REL_TOL} * {scale:.3e}")
                simt = dict(mma_max_abs_err=merr, mma_ms=timer.ms(mma, iters=10))
            if route == "gemv":    # bit-equal again, and the SIMT GEMV on the same weights
                check(torch.equal(qlin.matmul(x, layer), y), f"{case} M={m}: the GEMV's second "
                                                             "call differs")
                ys = simt_matmul(gemm, qlin, x, layer)
                torch.cuda.synchronize()
                serr = (ys.float() - ref.float()).abs().max().item()
                check(serr <= K1_REL_TOL * scale, f"{case} M={m} SIMT GEMV: max |kernel - plain| "
                                                  f"= {serr:.3e} > {K1_REL_TOL} * {scale:.3e}")
                simt = dict(simt_max_abs_err=serr, simt_ms=timer.ms(
                    lambda: simt_matmul(gemm, qlin, x, layer), iters=10))
            ms = timer.ms(lambda: qlin.matmul(x, layer), iters=10)
            plain_ms = timer.ms(lambda: qlin.matmul_plain(x, layer), iters=5, warmup=1)
            lib_ms = timer.ms(lambda: torch.matmul(x, w), iters=10)
            b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm, layer.bias), 2.0 * m * k * n)
            rows.append(dict(kernel=key, bits=bits, case=name, K=k, N=n, M=m, group_size=gs,
                             desc_act=desc_act, bias=with_bias, max_abs_err=err,
                             max_abs_ref=scale, max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **simt))
            print(f"{key} {case:31s} K={k:5d} N={n:5d} M={m:3d}  bf16 err {err:.3e} (tol "
                  f"{K1_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol {F32_ABS_TOL})  kernel "
                  f"{ms:.4f} ms" + (f"  SIMT GEMV {simt['simt_ms']:.4f} ms" if "simt_ms" in simt
                                    else f"  mma.sync {simt['mma_ms']:.4f} ms" if simt else "")
                  + f"  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
        del layer, w
    return rows


# Rest-class layers at Llama-2-7B widths, one per storage width: group sizes that the codes
# per word do not divide (a word straddles groups), 4-bit gs 100 and 3-bit gs 12 with a
# partial last group, 4-bit gs 172 with desc_act. (bits, projection, group size, desc_act)
REST_LAYERS = ((4, "qkvo", 100, False), (3, "qkvo", 12, False), (2, "qkvo", 24, False),
               (8, "qkvo", 6, False), (4, "down", 172, True))


def phase_rest(torch, np, timer) -> list:
    """The rest classes on the card: each layer through the decode regime
    (M = 1, 4 and 16: in bf16 the tensor-core GEMV's ANY_GS instance from
    group size 16 on, the SIMT GEMV below), the tile regime (M = 128 and a
    training step's 2048, the wgmma/TMA tile kernel in bf16) and K10 at M = 16
    (its split-N decode regime in bf16), 128 and 2048 (the wgmma K10), bf16
    (timed) and f32 (the SIMT kernels), against the plain versions; each case
    bit-equal on a second call and timed beside another kernel on the same
    weights. A tensor-core case must beat the kernel it replaced: the wgmma
    kernels beat the mma.sync tile kernels (``kernel="mma"``, the SIMT kernel
    timed beside too), the GEMV the SIMT kernel (``kernel="simt"``; but the
    desc_act g172 forward at M >= 4, the GEMV's wide gather of x: recorded),
    and for K10 at M = 16 the tile K10 (``kernel="mma"``). Below group size 16 the decode
    regime's SIMT GEMV is timed beside the GEMV's exact ANY_GS instance
    (``kernel="gemv"``, also held to the plain version and bit-equal), the
    design it keeps these group sizes from: recorded, not required."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = {name: (k, n) for name, (k, n, _) in LAYER_SHAPES.items()}
    rows, slower = [], []
    for bits, name, gs, desc_act in REST_LAYERS:
        k, n = shapes[name]
        kernel = KERNEL_OF_BITS[bits]
        sbits = qlin.storage_bits(bits)
        layer = _random_layer(qlin, rng, k, n, bits, gs, desc_act, torch.bfloat16)
        w = qlin.logical_weight(layer, torch.bfloat16)
        case = f"{bits}-bit {name} g{gs}" + ("+desc_act" if desc_act else "")
        for m, what in ((1, "forward"), (BEAMS, "forward"), (16, "forward"), (128, "forward"),
                        (TRAIN_M, "forward"), (16, "K10"), (128, "K10"), (TRAIN_M, "K10")):
            x = torch.randn((m, n if what == "K10" else k), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            if what == "K10":
                route = gemm.t_route(x.dtype, m, k=k, n=n)

                def run(v, kern=None):
                    return gemm.wna16_matmul_t(v, layer.qweight, layer.scales, layer.zeros,
                                               layer.kperm, gs, sbits, kernel=kern)

                def plain(v):
                    return gemm.wna16_matmul_t_ref(v, layer.qweight, layer.scales, layer.zeros,
                                                   layer.kperm, gs, sbits)

                def lib():
                    return torch.matmul(x, w.t())
            else:
                route = gemm.route(x.dtype, m, gs, k=k, n=n)

                def run(v, kern=None):
                    return gemm.wna16_matmul(v, layer.qweight, layer.scales, layer.zeros,
                                             layer.kperm, None, gs, sbits, kernel=kern)

                def plain(v):
                    return qlin.matmul_plain(v, layer)

                def lib():
                    return torch.matmul(x, w)
            base = gemm.T_KERNEL if what == "K10" else kernel
            key = base + ROUTE_SUFFIX[route]
            keys = [base + suffix for suffix in ROUTE_SUFFIX.values()]
            want = "wgmma" if m > 16 else "gemv" if what == "K10" or gs >= 16 else "simt"
            check(route == want, f"rest class {case} {what} M={m}: bf16 routes to {key}")
            before = snapshot(build)
            y = run(x)
            check(all(build.launches[c] == before.get(c, 0) + (c == key) for c in keys),
                  f"rest class {case} {what} M={m}: launched {snapshot(build)}, want one {key}")
            ref = plain(x)
            before = snapshot(build)
            y32, ref32 = run(x.float()), plain(x.float())
            check(all(build.launches[c] == before.get(c, 0) + (c == base) for c in keys),
                  f"rest class {case} {what} M={m} f32: launched {snapshot(build)}, want "
                  f"one {base}")
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
            check(torch.equal(run(x), y), f"rest class {case} {what} M={m}: a second call differs")
            iters = 5 if m == TRAIN_M else 10
            ms = timer.ms(lambda: run(x), iters=iters)
            # the kernel this one replaced on the same weights: the mma.sync tile kernel for the wgmma
            # kernels and for K10 at M <= 16, else the SIMT kernel; beside the SIMT GEMV (below
            # gs 16) the exact ANY_GS GEMV
            old = ("mma" if route == "wgmma" or (what == "K10" and route == "gemv")
                   else "gemv" if route == "simt" else "simt")
            ys = run(x, old)
            torch.cuda.synchronize()
            serr = (ys.float() - ref.float()).abs().max().item()
            check(serr <= tol * scale, f"rest class {case} {what} M={m} {old}: max |kernel - "
                                       f"plain| = {serr:.3e} > {tol} * {scale:.3e}")
            if old == "gemv":
                check(torch.equal(run(x, old), ys),
                      f"rest class {case} {what} M={m} gemv: a second call differs")
            old_ms = timer.ms(lambda: run(x, old), iters=iters, warmup=1)
            beside = {f"{old}_max_abs_err": serr, f"{old}_ms": old_ms}
            if route == "wgmma":   # the SIMT kernel too, recorded
                ys = run(x, "simt")
                torch.cuda.synchronize()
                beside.update(simt_max_abs_err=(ys.float() - ref.float()).abs().max().item(),
                              simt_ms=timer.ms(lambda: run(x, "simt"), iters=iters, warmup=1))
            if route != "simt" and not (ms < old_ms or (desc_act and route == "gemv" and m > 1)):
                slower.append(f"{case} {what} M={m}: the tensor-core kernel {ms:.4f} ms, the "
                              f"{old} kernel {old_ms:.4f} ms")
            plain_ms = timer.ms(lambda: plain(x), iters=3, warmup=1)
            lib_ms = timer.ms(lib, iters=iters)
            b_ms, b_by = bound_ms(nbytes(x, y, layer.qweight, layer.scales, layer.zeros,
                                         layer.kperm), 2.0 * m * k * n)
            rows.append(dict(kernel=key, bits=bits, case=name, what=what, K=k, N=n, M=m,
                             group_size=gs, desc_act=desc_act, max_abs_err=err,
                             max_abs_ref=scale, max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **beside))
            print(f"rest class {key} {case:22s} {what:7s} K={k:5d} N={n:5d} M={m:4d}  bf16 err "
                  f"{err:.3e} (tol {tol * scale:.3e})  f32 err {err32:.3e} (tol "
                  f"{F32_ABS_TOL})  kernel {ms:.4f} ms  {old} {old_ms:.4f} ms (err {serr:.3e})"
                  + (f"  simt {beside['simt_ms']:.4f} ms" if route == "wgmma" else "") +
                  f"  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
        del layer, w
    # every case timed first, so that all of them are on record
    check(not slower, "rest classes slower than the kernel they replaced: " + "; ".join(slower))
    return rows


def mma_ptxas() -> list:
    """ptxas' registers, spills and static shared memory of every tensor-core
    kernel instance, with its dynamic shared memory (``gemm.mma_smem_bytes``;
    for an ANY_GS instance, the rest-class layers' group sizes of its width).
    The template's bool arguments tell the instances apart (``Lb<0|1>E`` in the
    mangled name): the forward's PRENORM and ANY_GS, K10's ANY_GS."""
    from autogptq_tpu_torch.ops import gemm

    out = []
    for name, bits in (("w4a16_gemm", 4), ("w8a16_gemm", 8), ("w2a16_gemm", 2),
                       ("w4a16_kb32l_gemm", 4), ("wna16_gemm_t", None)):
        for r in ptxas_report(name, "mma_kernel"):
            if "wgmma" in r["function"]:   # wgmma_ptxas reports those
                continue
            b = bits
            if b is None:   # K10's library holds the three widths: ILi<BITS>E in the name
                b = next(x for x in (2, 4, 8) if f"ILi{x}E" in r["function"])
            transpose = "t_mma" in r["function"]
            flags = template_flags(r["function"])
            prenorm = not transpose and bool(flags) and flags[0]
            any_gs = len(flags) > (0 if transpose else 1) and flags[-1]
            # a fused-prologue instance adds a K tile's norm weight per stage
            smem = {gs: gemm.mma_smem_bytes(b, gs, transpose)
                    for gs in ([g for bb, _, g, _ in REST_LAYERS if gemm.storage_bits(bb) == b]
                               if any_gs else [128])}
            r.update(library=name, bits=b, prenorm=prenorm, any_gs=any_gs,
                     dynamic_smem_bytes={gs: v + (4 * 64 * 4 if prenorm else 0)
                                         for gs, v in smem.items()})
            out.append(r)
    for r in out:
        print(f"ptxas {r['library']}: {r['function'][:70]}{' ANY_GS' if r['any_gs'] else ''}: "
              f"{r['registers']} registers, spill {r['spill_stores']}/{r['spill_loads']} B, static "
              f"smem {r['smem']} B, dynamic smem by group size {r['dynamic_smem_bytes']} B",
              flush=True)
    check(sum(r["any_gs"] for r in out) == 12, "want 12 ANY_GS instances: 2 types x (3 forward "
                                               "libraries + K10's 3 widths)")
    return out


def wgmma_ptxas() -> list:
    """ptxas' registers, spills and static shared memory of every wgmma/TMA
    tile-kernel instance: the forward of the three libraries and K10's three
    widths, each for bf16 and f16 and the block heights 64, 128 and 256 (36),
    K6's forward and K10 over kb32l words (6 each) and K1's fused prologue
    (bf16 and f16 at block height 64: 2); a spill fails the run."""
    out = []
    for name in ("w4a16_gemm", "w8a16_gemm", "w2a16_gemm", "wna16_gemm_t", "w4a16_kb32l_gemm"):
        for r in ptxas_report(name, "wgmma_kernel"):
            r.update(library=name)
            out.append(r)
    kb32l = [r for r in out if "kb32l_wgmma_kernel" in r["function"]]
    kb32l_t = [r for r in out if "kb32l_t_wgmma_kernel" in r["function"]]
    norm = [r for r in out if "prenorm_wgmma_kernel" in r["function"]]
    check(len(out) == 50 and len(kb32l) == 6 and len(kb32l_t) == 6 and len(norm) == 2,
          f"{len(out)} wgmma instances in the ptxas logs ({len(kb32l)} forward and "
          f"{len(kb32l_t)} K10 over kb32l words, {len(norm)} with the prologue), want 50 (6, 6, "
          f"2)")
    for r in out:
        print(f"ptxas {r['library']}: {r['function'][:90]}: {r['registers']} registers, spill "
              f"{r['spill_stores']}/{r['spill_loads']} B, static smem {r['smem']} B", flush=True)
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"{r['function']} spills {r['spill_stores']}/{r['spill_loads']} B")
    return out


def gemv_ptxas() -> list:
    """ptxas' registers and spills of every tensor-core GEMV instance (bits x
    activation type x 8 or 16 rows over GPTQ words, with and without ANY_GS;
    K6's over kb32l tiles and K9's routed one, activation type x 8 or 16 rows;
    K10's decode regime, bits x activation type x 8 or 16 rows, and over kb32l
    words); a spill fails the run."""
    out = []
    for name, key in (("w4a16_gemm", "wna16_gemv_kernel"), ("w8a16_gemm", "wna16_gemv_kernel"),
                      ("w2a16_gemm", "wna16_gemv_kernel"),
                      ("w4a16_kb32l_gemm", "kb32l_gemv_kernel"),
                      ("w4a16_routed_gemm", "routed_gemv_kernel"),
                      ("wna16_gemm_t", "t_gemv_kernel")):
        for r in ptxas_report(name, key):
            r.update(library=name)
            out.append(r)
    # 20 plus K1's 4 fused-prologue instances, 16 ANY_GS ones (K1/K4/K5 and K9) and K10's 16
    check(len(out) == 56, f"{len(out)} GEMV instances in the ptxas logs, want 56")
    for r in out:
        print(f"ptxas {r['library']}: {r['function'][:90]}: {r['registers']} registers, spill "
              f"{r['spill_stores']}/{r['spill_loads']} B", flush=True)
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"{r['function']} spills {r['spill_stores']}/{r['spill_loads']} B")
    return out


def phase_k10(torch, np, timer) -> list:
    """K10 against its plain version at the shapes of a training step; bf16
    takes its split-N decode regime at M = 10 and 16 (bit-equal on a second
    call, with its plan) and the wgmma/TMA tile K10 above (bit-equal on a
    second call, with its plan), f32 the SIMT kernel; for the 4-bit rows (g128,
    desc_act, g32) the SIMT kernel and the mma.sync tile K10 beside it on the
    same weights, all held to K10_REL_TOL and timed; the decode regime must
    beat both."""
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
        for m in (10, 16, 17, 128, TRAIN_M):
            g = torch.randn((m, n), generator=gen, device="cuda", dtype=torch.bfloat16)
            route = gemm.t_route(g.dtype, m, k=k, n=n)
            key = gemm.T_KERNEL + ROUTE_SUFFIX[route]
            before = snapshot(build)
            dx = qlin.matmul_t(g, layer)
            check(route == ("gemv" if m <= 16 else "wgmma")
                  and all(build.launches[c] == before.get(c, 0) + (c == key)
                          for c in (gemm.T_KERNEL + sfx for sfx in ROUTE_SUFFIX.values())),
                  f"K10 {case} M={m}: launched {snapshot(build)}, want one {key}")
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
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            if route in ("gemv", "wgmma"):   # bit-equal again, its plan
                check(torch.equal(qlin.matmul_t(g, layer), dx), f"K10 {case} M={m}: a second "
                                                                 "call differs")
                simt["plan"] = (gemm.t_gemv_plan(k, n, m, gs, bits, sms) if route == "gemv"
                                else gemm.wgmma_plan(m, k, n, gs, bits, sms, transpose=True))
            if bits == 4:   # the mma.sync tile K10 on the same weights
                def tile_t():
                    return gemm.wna16_matmul_t(g, layer.qweight, layer.scales, layer.zeros,
                                               layer.kperm, gs, 4, kernel="mma")
                dxm = tile_t()
                torch.cuda.synchronize()
                merr = (dxm.float() - ref.float()).abs().max().item()
                check(merr <= K10_REL_TOL * scale, f"K10 tile {case} M={m}: max |kernel - "
                                                   f"plain| = {merr:.3e} > {K10_REL_TOL} * "
                                                   f"{scale:.3e}")
                simt.update(mma_max_abs_err=merr,
                            mma_ms=timer.ms(tile_t, iters=iters, warmup=1))
            if bits == 4:   # the SIMT kernel on the same weights
                def simt_t():
                    return gemm.wna16_matmul_t(g, layer.qweight, layer.scales, layer.zeros,
                                               layer.kperm, gs, 4, kernel="simt")
                dxs = simt_t()
                torch.cuda.synchronize()
                serr = (dxs.float() - ref.float()).abs().max().item()
                check(serr <= K10_REL_TOL * scale, f"K10 SIMT {case} M={m}: max |kernel - "
                                                   f"plain| = {serr:.3e} > {K10_REL_TOL} * "
                                                   f"{scale:.3e}")
                simt.update(simt_max_abs_err=serr,
                            simt_ms=timer.ms(simt_t, iters=iters, warmup=1))
            ms = timer.ms(lambda: qlin.matmul_t(g, layer), iters=iters, warmup=1)
            if route == "wgmma" and bits == 4:
                check(ms < simt["mma_ms"], f"K10 {case} M={m}: the wgmma K10 {ms:.4f} ms is not "
                                           f"faster than the mma.sync tile K10 {simt['mma_ms']:.4f} ms")
            if route == "gemv" and bits == 4:
                check(ms < min(simt["simt_ms"], simt["mma_ms"]),
                      f"K10 {case} M={m}: the decode regime {ms:.4f} ms is not faster than the "
                      f"tile K10's {simt['mma_ms']:.4f} ms and the SIMT K10's "
                      f"{simt['simt_ms']:.4f} ms")
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
                  + (f"  tile {simt['mma_ms']:.4f} ms (err {simt['mma_max_abs_err']:.3e})"
                     if "mma_ms" in simt else "")
                  + (f"  SIMT {simt['simt_ms']:.4f} ms (err {simt['simt_max_abs_err']:.3e})"
                     if "simt_ms" in simt else "")
                  + f"  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound "
                    f"{b_ms:.4f} ms ({b_by})" + (f"  plan {simt['plan']}" if "plan" in simt else ""),
                  flush=True)
        del layer, w
    # K10 over K6's kb32l words (a backward through a kb32l layer): its decode regime at M = 16,
    # above the wgmma/TMA K10 over the tiles' 3-D map, timed beside the mma.sync K10 on the
    # same words at M = 64 and 128 and beside K1's wgmma K10 on the same weights in GPTQ words
    # (gemm.kb32l_as_gptq) at every M above 16
    k, n = shapes["gate_up"]
    layer = _random_layer(qlin, rng, k, n, 4, 128, False, torch.bfloat16, layout="kb32l")
    words, s, z = (t.contiguous() for t in qlin.gptq_tensors(layer))
    w = qlin.logical_weight(layer, torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (16, 64, 128, TRAIN_M):
        g = torch.randn((m, n), generator=gen, device="cuda", dtype=torch.bfloat16)
        route = gemm.t_route(g.dtype, m, k=k, n=n, layout="kb32l")
        key = gemm.KB32L_T_WGMMA if route == "wgmma" else gemm.T_KERNEL + ROUTE_SUFFIX[route]
        keys = [gemm.KB32L_T_WGMMA] + [gemm.T_KERNEL + sfx for sfx in ROUTE_SUFFIX.values()]
        before = snapshot(build)
        dx = qlin.matmul_t(g, layer)
        check(route == ("gemv" if m <= 16 else "wgmma")
              and all(build.launches[c] == before.get(c, 0) + (c == key) for c in keys),
              f"K10 kb32l M={m}: launched {snapshot(build)}, want one {key}")
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
        check(torch.equal(qlin.matmul_t(g, layer), dx), f"K10 kb32l M={m}: a second call differs")
        extra = {}
        if route == "wgmma":
            extra["plan"] = gemm.wgmma_plan(m, k, n, 128, 4, sms, transpose=True, layout="kb32l")

            def gptq_t():   # K1's wgmma K10 on the same weights in GPTQ words
                return gemm.wna16_matmul_t(g, words, s, z, None, 128, 4)

            def mma_t():    # the mma.sync K10 on the same kb32l words
                return gemm.wna16_matmul_t(g, layer.qweight, layer.scales, layer.zeros, None,
                                           128, 4, k=k, kernel="mma")

            checked = (("k1", gptq_t),) + ((("mma", mma_t),) if m <= 128 else ())
            for label, fn in checked:
                other = fn()
                torch.cuda.synchronize()
                oerr = (other.float() - ref.float()).abs().max().item()
                check(oerr <= K10_REL_TOL * scale, f"K10 kb32l M={m} {label}: max |kernel - "
                                                   f"plain| = {oerr:.3e} > {K10_REL_TOL} * "
                                                   f"{scale:.3e}")
                extra[f"{label}_max_abs_err"] = oerr
            # in turns: the kb32l kernel, K1's, K1's, the kb32l kernel (the mean of each pair)
            t = {"ms": [], "k1_ms": []}
            for label in ("ms", "k1_ms", "k1_ms", "ms"):
                fn = (lambda: qlin.matmul_t(g, layer)) if label == "ms" else gptq_t
                t[label].append(timer.ms(fn, iters=5 if m == TRAIN_M else 10, warmup=1))
            extra.update(k1_ms=sum(t["k1_ms"]) / 2)
            ms = sum(t["ms"]) / 2
            if m <= 128:
                extra["mma_ms"] = timer.ms(mma_t, iters=10, warmup=1)
                check(ms < extra["mma_ms"], f"K10 kb32l M={m}: the wgmma K10 {ms:.4f} ms is not "
                                            f"faster than the mma.sync K10's {extra['mma_ms']:.4f} ms")
            extra["within_10pct_of_k1"] = ms <= (1 + WITHIN) * extra["k1_ms"]
        else:
            ms = timer.ms(lambda: qlin.matmul_t(g, layer), iters=10, warmup=1)
        plain_ms = timer.ms(lambda: gemm.wna16_matmul_t_ref(g, words, s, z, None, 128, 4),
                            iters=3, warmup=1)
        lib_ms = timer.ms(lambda: torch.matmul(g, w.t()), iters=5, warmup=1)
        b_ms, b_by = bound_ms(nbytes(g, dx, layer.qweight, layer.scales, layer.zeros),
                              2.0 * m * k * n)
        rows.append(dict(bits=4, case="gate_up kb32l", K=k, N=n, M=m, group_size=128,
                         desc_act=False, layout="kb32l", route=route, kernel=key,
                         max_abs_err=err, max_abs_ref=scale,
                         max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, tflops=2.0 * m * k * n / ms / 1e9, **extra))
        print(f"K10 4-bit gate_up g128 kb32l    K={k:5d} N={n:5d} M={m:4d} {route:5s} bf16 err "
              f"{err:.3e} (tol {K10_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol "
              f"{F32_ABS_TOL})  kernel {ms:.4f} ms"
              + (f"  K1's wgmma K10 on the GPTQ words {extra['k1_ms']:.4f} ms ("
                 f"{ms / extra['k1_ms']:.3f}x, within 10%: "
                 f"{'met' if extra['within_10pct_of_k1'] else 'NOT MET'})" if "k1_ms" in extra
                 else "")
              + (f"  the mma.sync K10 {extra['mma_ms']:.4f} ms" if "mma_ms" in extra else "")
              + f"  plain {plain_ms:.4f} ms  torch.matmul {lib_ms:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})" + (f"  plan {extra['plan']}" if "plan" in extra else ""),
              flush=True)
    return rows


def phase_k9(torch, np, timer) -> list:
    """K9 against its plain version at Mixtral-8x7B's expert shapes, E = 8:
    bf16 through the expert-major tensor-core GEMV (bit-equal on a second
    call, with its plan), held and timed beside the SIMT routed kernel
    (``kernel="simt"``) on the same operands; f32 through the SIMT kernel. At
    every P the GEMV also over a stack of only the selected experts: the time
    the expert slices that exit at once cost (none at P <= 2)."""
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
            key = gemm.ROUTED_KERNEL + gemm.GEMV_SUFFIX
            before = snapshot(build)
            y = qlin.matmul_routed(x, sql, sel)
            check(build.launches[key] == before.get(key, 0) + 1
                  and build.launches[gemm.ROUTED_KERNEL] == before.get(gemm.ROUTED_KERNEL, 0),
                  f"K9 {name} P={p}: launched {snapshot(build)}")
            ref = gemm.wna16_routed_matmul_ref(x, sel, sql.qweight, sql.scales, sql.zeros, 128)

            def simt():
                return gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 128,
                                                check=False, kernel="simt")
            ys = simt()
            y32 = qlin.matmul_routed(x.float(), sql, sel)
            ref32 = gemm.wna16_routed_matmul_ref(x.float(), sel, sql.qweight, sql.scales,
                                                 sql.zeros, 128)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            serr = (ys.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            err32 = (y32 - ref32).abs().max().item()
            check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(y32).all()),
                  f"K9 {name} P={p}: non-finite output")
            check(err <= K1_REL_TOL * scale and serr <= K1_REL_TOL * scale,
                  f"K9 {name} P={p} bf16: max |kernel - plain| = {err:.3e} (SIMT {serr:.3e}) > "
                  f"{K1_REL_TOL} * {scale:.3e}")
            check(err32 <= F32_ABS_TOL * max(1.0, scale),
                  f"K9 {name} P={p} f32: max |kernel - plain| = {err32:.3e} > {F32_ABS_TOL}")
            check(torch.equal(qlin.matmul_routed(x, sql, sel), y), f"K9 GEMV {name} P={p}: a "
                                                                   "second call differs")
            ms = timer.ms(lambda: qlin.matmul_routed(x, sql, sel, check=False))
            simt_ms = timer.ms(simt)
            # the same work over a stack of the selected experts alone: no slice exits at once
            distinct = sorted(set(ids))
            own = qlin.StackedQuantLinear(
                qweight=sql.qweight[distinct].contiguous(),
                scales=sql.scales[distinct].contiguous(),
                zeros=sql.zeros[distinct].contiguous(), bias=None, bits=4, group_size=128,
                in_features=k, out_features=n)
            own_sel = torch.tensor([distinct.index(i) for i in ids], dtype=torch.int32,
                                   device="cuda")
            check(torch.equal(qlin.matmul_routed(x, own, own_sel), y),
                  f"K9 GEMV {name} P={p}: the selected experts' own stack differs")
            own_ms = timer.ms(lambda: qlin.matmul_routed(x, own, own_sel, check=False))
            del own
            plain_ms = timer.ms(lambda: gemm.wna16_routed_matmul_ref(
                x, sel, sql.qweight, sql.scales, sql.zeros, 128), iters=5, warmup=1)
            # no single PyTorch call computes a routed product without a gather: P
            # torch.matmul calls on pre-dequantized bf16 experts, timed only
            lib_ms = timer.ms(lambda: [torch.matmul(x[i], dense[e]) for i, e in enumerate(ids)])
            # the least the card could move: each selected expert once, x, y and sel
            b_ms, b_by = bound_ms(len(set(ids)) * per_expert + nbytes(x, y, sel),
                                  2.0 * p * k * n)
            plan = gemv_plan_of(torch, gemm, torch.bfloat16, k, n, p, 128, 4,
                                library=gemm.ROUTED_KERNEL, experts=8)
            rows.append(dict(case=name, K=k, N=n, P=p, sel=ids, max_abs_err=err,
                             simt_max_abs_err=serr, max_abs_ref=scale, max_abs_err_f32=err32,
                             ms=ms, simt_ms=simt_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by, plan=plan, selected_only_ms=own_ms))
            print(f"K9 {name:8s} K={k:5d} N={n:5d} E=8 P={p} sel={ids}  bf16 err {err:.3e} "
                  f"(SIMT {serr:.3e}; tol {K1_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol "
                  f"{F32_ABS_TOL})  GEMV {ms:.4f} ms (over the selected experts' own stack "
                  f"{own_ms:.4f} ms)  SIMT {simt_ms:.4f} ms  plain {plain_ms:.4f} ms  {p} x "
                  f"torch.matmul {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  plan {plan}",
                  flush=True)
        if name == "gate_up":
            refuse_bad_experts(torch, gemm, sql, gen)
        del sql, dense
        torch.cuda.empty_cache()
    return rows


K9_REST_GROUP_SIZES = (12, 100)   # K9's rest classes held on the card: 16 does not divide them


def phase_k9_rest(torch, np, timer) -> list:
    """K9 at the rest classes (4-bit gs 12 and 100: words straddling groups, a
    partial last group) at Mixtral-8x7B's gate/up expert shape, E = 8, P = 2
    and 8: bf16 through the route's kernel (``gemm.routed_route``: the
    expert-major GEMV's ANY_GS instance at gs 100, one launch of
    ``w4a16_routed_gemm_gemv``; the SIMT routed kernel below group size 16)
    against the plain version, the GEMV and the SIMT routed kernel each asked
    for (``kernel=``) on the same operands, held to the plain version, the
    GEMV bit-equal on a second call, and timed beside P ``torch.matmul`` calls
    on pre-dequantized bf16 experts and the bound (each selected expert's
    bytes once); f32 through the SIMT routed kernel."""
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)
    k, n, _ = MIXTRAL_SHAPES["gate_up"]
    rows = []
    for gs in K9_REST_GROUP_SIZES:
        sql = qlin.stack_experts([_random_layer(qlin, rng, k, n, 4, gs, False, torch.bfloat16)
                                  for _ in range(8)])
        dense = [qlin.logical_weight(sql.expert(e), torch.bfloat16) for e in range(8)]
        per_expert = nbytes(sql.qweight[0], sql.scales[0], sql.zeros[0])
        for p in (2, 8):
            ids = K9_SELS[p]
            sel = torch.tensor(ids, dtype=torch.int32, device="cuda")
            x = torch.randn((p, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            route = gemm.routed_route(x.dtype, p, gs)
            check(route == ("gemv" if gs >= 16 else "simt"), f"K9 g{gs} P={p}: bf16 routes to "
                                                               f"{route}")
            key = gemm.ROUTED_KERNEL + ROUTE_SUFFIX[route]
            keys = (gemm.ROUTED_KERNEL, gemm.ROUTED_KERNEL + gemm.GEMV_SUFFIX)
            before = snapshot(build)
            y = qlin.matmul_routed(x, sql, sel)
            check(all(build.launches[c] == before.get(c, 0) + (c == key) for c in keys),
                  f"K9 g{gs} P={p}: launched {snapshot(build)}, want one {key}")
            ref = gemm.wna16_routed_matmul_ref(x, sel, sql.qweight, sql.scales, sql.zeros, gs)

            def simt():
                return gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, gs,
                                                check=False, kernel="simt")

            def gemv():
                return gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, gs,
                                                check=False, kernel="gemv")
            ys, yg = simt(), gemv()
            y32 = qlin.matmul_routed(x.float(), sql, sel)
            ref32 = gemm.wna16_routed_matmul_ref(x.float(), sel, sql.qweight, sql.scales,
                                                 sql.zeros, gs)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            serr = (ys.float() - ref.float()).abs().max().item()
            gerr = (yg.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            err32 = (y32 - ref32).abs().max().item()
            check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(y32).all()),
                  f"K9 g{gs} P={p}: non-finite output")
            check(max(err, serr, gerr) <= K1_REL_TOL * scale,
                  f"K9 g{gs} P={p} bf16: max |kernel - plain| = {err:.3e} (SIMT {serr:.3e}, GEMV "
                  f"{gerr:.3e}) > {K1_REL_TOL} * {scale:.3e}")
            check(err32 <= F32_ABS_TOL * max(1.0, scale),
                  f"K9 g{gs} P={p} f32: max |kernel - plain| = {err32:.3e} > {F32_ABS_TOL}")
            check(torch.equal(qlin.matmul_routed(x, sql, sel), y) and torch.equal(gemv(), yg),
                  f"K9 g{gs} P={p}: a second call differs")
            ms = timer.ms(lambda: qlin.matmul_routed(x, sql, sel, check=False))
            simt_ms = timer.ms(simt)
            gemv_ms = timer.ms(gemv)
            plain_ms = timer.ms(lambda: gemm.wna16_routed_matmul_ref(
                x, sel, sql.qweight, sql.scales, sql.zeros, gs), iters=3, warmup=1)
            lib_ms = timer.ms(lambda: [torch.matmul(x[i], dense[e]) for i, e in enumerate(ids)])
            b_ms, b_by = bound_ms(len(set(ids)) * per_expert + nbytes(x, y, sel),
                                  2.0 * p * k * n)
            rows.append(dict(case="gate_up", group_size=gs, K=k, N=n, P=p, sel=ids, route=route,
                             max_abs_err=err, simt_max_abs_err=serr, gemv_max_abs_err=gerr,
                             max_abs_ref=scale, max_abs_err_f32=err32, ms=ms, simt_ms=simt_ms,
                             gemv_ms=gemv_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by))
            print(f"K9 rest class gate_up g{gs} K={k:5d} N={n:5d} E=8 P={p} sel={ids}  route "
                  f"{route}  bf16 err {err:.3e} (SIMT {serr:.3e}, GEMV {gerr:.3e}; tol "
                  f"{K1_REL_TOL * scale:.3e})  f32 err {err32:.3e} (tol {F32_ABS_TOL})  routed "
                  f"{ms:.4f} ms  GEMV {gemv_ms:.4f} ms  SIMT {simt_ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  {p} x torch.matmul {lib_ms:.4f} ms  bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
        del sql, dense
        torch.cuda.empty_cache()
    return rows


def refuse_bad_experts(torch, gemm, sql, gen) -> None:
    """A pair naming expert -1 or E writes nothing and sets the flag; the good
    pairs of the same launch are right; check=True raises ValueError: through
    the routed GEMV and the SIMT routed kernel."""
    x = torch.randn((3, sql.in_features), generator=gen, device="cuda", dtype=torch.bfloat16)
    for bad, kernel in ((-1, None), (sql.num_experts, None), (-1, "simt"),
                        (sql.num_experts, "simt")):
        sel = torch.tensor([2, bad, 6], dtype=torch.int32, device="cuda")
        out = torch.full((3, sql.out_features), 7.0, device="cuda", dtype=torch.bfloat16)
        gemm.wna16_routed_matmul(x, sel, sql.qweight, sql.scales, sql.zeros, 128, check=False,
                                 out=out, kernel=kernel)
        torch.cuda.synchronize()
        check(bool((out[1] == 7.0).all()),
              f"K9 {kernel or 'GEMV'} expert id {bad}: its row was written")
        good = torch.tensor([0, 2], device="cuda")
        ref = gemm.wna16_routed_matmul_ref(x[good], sel[good], sql.qweight, sql.scales,
                                           sql.zeros, 128)
        check((out[good].float() - ref.float()).abs().max().item()
              <= K1_REL_TOL * ref.float().abs().max().item(),
              f"K9 {kernel or 'GEMV'} expert id {bad}: the good pairs of the launch are wrong")
        for what, call in (("flag", lambda: gemm.check_routed_errors("cuda")),
                           ("check=True", lambda: gemm.wna16_routed_matmul(
                               x, sel, sql.qweight, sql.scales, sql.zeros, 128, kernel=kernel))):
            try:
                call()
            except ValueError:
                continue
            raise SmokeFailure(f"K9 {kernel or 'GEMV'} expert id {bad}: {what} raised no "
                               "ValueError")
    print("K9 bad expert ids (-1 and E), routed GEMV and SIMT routed kernel: the pair's row is "
          "left as it was, the other pairs of the launch are right, the flag is set and "
          "check=True raises ValueError", flush=True)


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
        clear_counts(build)
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(snapshot(build))
        print(f"train step {i + 1}: loss {losses[-1]:.6f}, {seconds[-1]:.3f} s, launches "
              f"{counts[-1]}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    check(bool(np.all(np.isfinite(losses))), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    # every projection is a bf16 product of 2048 rows: the wgmma/TMA kernels, exactly one per
    # projection forward and one per backward but layer 0's q/k/v (its input needs no gradient)
    want = {"w4a16_gemm" + gemm.WGMMA_SUFFIX: 7 * layers,
            gemm.T_KERNEL + gemm.WGMMA_SUFFIX: 7 * layers - 3}
    for c in counts:
        check(c == want, f"a training step launched {c}, want {want}")
    steady = float(np.median(seconds[1:]))
    tok_s = TRAIN_BATCH * TRAIN_LEN / steady
    print(f"train: LoRA r={TRAIN_RANK} alpha={2 * TRAIN_RANK} on q_proj and v_proj, Llama-2-7B "
          f"4-bit g128, {layers} layers (full depth), batch {TRAIN_BATCH} x {TRAIN_LEN} tokens "
          f"(row 1 left-padded by {TRAIN_PAD}), AdamW lr {TRAIN_LR}: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; {steady:.3f} s/step (median of steps 2-{TRAIN_STEPS}; step 1 "
          f"{seconds[0]:.3f} s) = {tok_s:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches per step {counts[-1]}", flush=True)
    split = profile_train_step(torch, step)
    check(not split or ("K1 wgmma tile" in split["instances"]
                        and "K10 wgmma" in split["instances"]
                        and not {"K1 tensor-core tile", "K10 tensor-core", "K1 SIMT tile",
                                 "K10 SIMT"} & set(split["instances"])),
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
    clear_counts(build)
    first = model.generate(prompt, max_new_tokens=TRAIN_NEW_TOKENS)
    gen_counts = snapshot(build)
    again = model.generate(prompt, max_new_tokens=TRAIN_NEW_TOKENS)
    check(first.shape == (1, PROMPT_LEN + TRAIN_NEW_TOKENS), f"generate shape {first.shape}")
    check(np.array_equal(first, again), "generate with adapters does not repeat its tokens")
    check(gen_counts.get("w4a16_gemm_gemv", 0) > 0 and not gen_counts.get("w4a16_gemm", 0)
          and gen_counts.get("flash_decode", 0) > 0, f"generate with adapters launched {gen_counts}")
    print(f"save_adapter: {len(names)} tensors; generate with the trained adapters, "
          f"{TRAIN_NEW_TOKENS} greedy tokens, twice with equal tokens: "
          f"{first[0, PROMPT_LEN:].tolist()}, launches {gen_counts}", flush=True)
    return dict(losses=losses, seconds=seconds, s_per_step=steady, tokens_per_s=tok_s,
                peak_bytes=peak, launches_per_step=counts[-1], profile=split,
                generate_launches=gen_counts, adapter_tensors=len(names))


# torch.profiler on the H100 drops the kernel records of the first launches of a profiling
# session, and more of them in each later session of a process (each profile below reports
# the launches it recorded with no kernel). A burst of tiny kernels opens every session to
# take that loss, and only the kernels that start inside the profiled function's range are
# counted. Records also go missing inside the range with their launch records (4 of 7392
# GEMV kernels in one greedy profile, 1521 of 70878 kernels in another), so a count read
# from a profile is held only where a loss cannot make it pass: no split-K reduce, and never
# more kernels than the wrappers launched.
PROFILER_WARMUP_LAUNCHES = 512
PROFILER_WINDOW = "chip_smoke.profiled"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
PROFILE_READERS_US = 1.0   # one kernel's time through either reader: prof.events()' rounding


def profiled(torch, fn, tree: bool = False, both: bool = False) -> dict:
    """``fn()`` under torch.profiler, after :data:`PROFILER_WARMUP_LAUNCHES`
    tiny kernels and a synchronize. Returns its result, the CUDA kernel events
    that start inside ``fn``'s range (each with ``name`` and ``time_range``),
    the host clock of ``fn`` in microseconds, and the kernel launches the
    profiler recorded with no kernel, inside that range and before it; with
    ``tree`` also the profiler's events (``prof.events()``, whose CPU events
    carry their children). Without ``tree`` the kineto results are read as
    they are: building ``prof.events()`` costs about 50 us of host time per
    event, 20 s or more for a generate of 33 tokens (2000 kernels per token and
    their CPU events), and none of its fields is read. With ``both``, the
    window read both ways (``readers``: kernels, their summed microseconds and
    the two lost-launch counts of each), which :func:`profile_readers` holds
    equal."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(PROFILER_WARMUP_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize()
        with record_function(PROFILER_WINDOW):
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events, rows = _profile_rows(prof, tree)
    run = dict(result=result, events=events, wall_us=wall_us, **_profile_window(rows))
    if both:
        run["readers"] = {reader: _profile_window(_profile_rows(prof, reader == "tree")[1])
                          for reader in ("tree", "kineto")}
    return run


def _profile_rows(prof, tree: bool) -> tuple:
    """(``prof.events()`` or None, a (name, span in us, device type,
    correlation id, user annotation) row per event), from the profiler's event
    tree or straight from its kineto results."""
    from torch.autograd.profiler_util import Interval

    if tree:
        events = prof.events()
        return events, [(e.name, e.time_range, e.device_type, e.id,
                         getattr(e, "is_user_annotation", False)) for e in events]
    return None, [(e.name(), Interval(e.start_ns() / 1e3, e.end_ns() / 1e3), e.device_type(),
                   e.correlation_id(), e.is_user_annotation())
                  for e in prof.profiler.kineto_results.events()
                  if not getattr(e, "is_hidden_event", lambda: False)()]   # as prof.events() skips


def _profile_window(rows: list) -> dict:
    """The kernels that start inside :data:`PROFILER_WINDOW`'s range and the
    launches with no kernel record inside it and before it."""
    from torch.autograd import DeviceType

    window = next(span for name, span, dev, _, _ in rows
                  if name == PROFILER_WINDOW and dev == DeviceType.CPU)
    device = [r for r in rows if r[2] == DeviceType.CUDA and not r[4]]
    recorded = {r[3] for r in device}
    lost = [span.start for name, span, dev, cid, _ in rows if dev == DeviceType.CPU
            and name in LAUNCH_CALLS and cid not in recorded]
    return dict(kernels=[types.SimpleNamespace(name=name, time_range=span, cid=cid)
                         for name, span, _, cid, _ in device
                         if window.start <= span.start <= window.end],
                lost_inside=sum(window.start <= t <= window.end for t in lost),
                lost_before=sum(t < window.start for t in lost))


def profile_readers(torch, fn) -> dict:
    """One profiled window of ``fn`` read through ``prof.events()`` and
    straight from the kineto results: the same kernels (correlation id and
    name), the same lost-launch counts, and each kernel's time within
    ``PROFILE_READERS_US`` of the other reader's, or the run fails. Reports
    the summed kernel time of each and the largest difference of one
    kernel."""
    import collections

    run = profiled(torch, fn, both=True)
    seen, spans = {}, {}
    for reader, w in run["readers"].items():
        spans[reader], occ = {}, collections.Counter()
        for k in sorted(w["kernels"], key=lambda k: k.time_range.start):
            spans[reader][k.cid, k.name, occ[k.cid, k.name]] = k.time_range.elapsed_us()
            occ[k.cid, k.name] += 1
        seen[reader] = dict(kernels=len(w["kernels"]), kernel_us=sum(spans[reader].values()),
                            lost_inside=w["lost_inside"], lost_before=w["lost_before"])
    a, b = seen["tree"], seen["kineto"]
    same_set = spans["tree"].keys() == spans["kineto"].keys() and a["kernels"] == len(
        spans["tree"]) == b["kernels"] > 0
    diffs = ([abs(spans["tree"][key] - spans["kineto"][key]) for key in spans["tree"]]
             if same_set else [float("inf")])
    whole = sum(float(v).is_integer() for v in spans["tree"].values())
    check(same_set and max(diffs) <= PROFILE_READERS_US
          and (a["lost_inside"], a["lost_before"]) == (b["lost_inside"], b["lost_before"]),
          f"profile readers disagree on one window: prof.events() {a}, kineto {b}, same kernels "
          f"{same_set}, largest difference of one kernel {max(diffs):.4f} us")
    print(f"profile readers on one window (a 4-token generate): prof.events() {a}; the kineto "
          f"results read directly {b}; the same {a['kernels']} kernels by correlation id and "
          f"name; largest difference of one kernel's time {max(diffs):.4f} us, "
          f"{sum(d > 0 for d in diffs)} differ; {whole} of prof.events()' kernel times are whole "
          f"microseconds", flush=True)
    return dict(seen, max_kernel_diff_us=max(diffs), kernels_differing=sum(d > 0 for d in diffs))


def profile_train_step(torch, step) -> dict:
    """Device time of one training step by family from torch.profiler's
    kernel events: K1, K10 by kernel name, each split by kernel instance
    (tensor-core tile kernel, SIMT tile kernel, GEMV); attention, the kernels
    launched by the ops inside ``arch.attention``'s "attention" range and by
    their backward nodes (matched on sequence number); the rest is other."""
    from torch.autograd import DeviceType

    run = profiled(torch, step, tree=True)
    loss, events, wall_ms = run["result"], run["events"], run["wall_us"] / 1e3

    def family(name):
        if any(k in name for k in K10_KEYS):
            return "K10"
        if any(k in name for k in K1_KEYS):
            return "K1"
        return None

    split = dict(K1=0.0, K10=0.0, attention=0.0, other=0.0)
    instances: dict = {}      # kernel instance (KERNEL_INSTANCES) -> [launches, ms]
    kernels = 0
    for evt in run["kernels"]:
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
            clear_counts(build)
            loss.backward()
            grads[kind][run] = [t.grad.float().cpu() for t in leaves]
            if device == "cpu":
                continue
            torch.cuda.synchronize()
            counts = snapshot(build)
            key = gemm.T_KERNEL + (gemm.WGMMA_SUFFIX if dtype == torch.bfloat16 else "")
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
    from autogptq_tpu_torch.ops import build, gemm
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
        clear_counts(build)
        t0 = time.perf_counter()
        first = model.generate(prompt, max_new_tokens=OTHER_WIDTH_TOKENS)
        gen_s = time.perf_counter() - t0
        counts = snapshot(build)
        t0 = time.perf_counter()
        again = model.generate(prompt, max_new_tokens=OTHER_WIDTH_TOKENS)
        again_s = time.perf_counter() - t0
        kernel = KERNEL_OF_BITS[bits]
        # the 16-row prefill and every decode step: the tensor-core GEMV, no SIMT GEMV
        need = 7 * OTHER_WIDTH_LAYERS * OTHER_WIDTH_TOKENS
        new = first[:, PROMPT_LEN:]
        check(first.shape == (1, PROMPT_LEN + OTHER_WIDTH_TOKENS), f"{bits}-bit output shape")
        check(bool(((new >= 0) & (new < cfg["vocab_size"])).all()), f"{bits}-bit ids out of range")
        check(np.array_equal(first, again), f"{bits}-bit greedy decode does not repeat its tokens")
        check(counts.get(kernel + "_gemv", 0) == need and not counts.get(kernel, 0),
              f"{bits}-bit: {kernel}_gemv launched {counts.get(kernel + '_gemv', 0)} times, want "
              f"{need}, and {kernel} {counts.get(kernel, 0)}, want 0")
        others = set(KERNEL_OF_BITS.values()) - {kernel}
        check(not any(counts.get(o + suffix, 0) for o in others for suffix in ROUTE_SUFFIX.values()),
              f"{bits}-bit run launched {counts}")
        tok_s = OTHER_WIDTH_TOKENS / gen_s
        # two prompts: a 32-row prefill through the width's wgmma/TMA tile kernel, and again
        # through the mma.sync tile kernel (gemm.forced_kernel), held to the same tokens
        batch = [prompt[0], prompt[0][::-1].copy()]
        clear_counts(build)
        out2 = model.generate(batch, max_new_tokens=4)
        counts2 = snapshot(build)
        check(out2.shape == (2, PROMPT_LEN + 4), f"{bits}-bit batch-2 output shape {out2.shape}")
        check(counts2 == {kernel + "_wgmma": 7 * OTHER_WIDTH_LAYERS,
                          kernel + "_gemv": 7 * OTHER_WIDTH_LAYERS * 3,
                          "flash_decode": 3 * OTHER_WIDTH_LAYERS,
                          "rope_write_kv": 3 * OTHER_WIDTH_LAYERS},
              f"{bits}-bit batch-2 launches {counts2}")
        clear_counts(build)
        with gemm.forced_kernel("mma"):
            out3 = model.generate(batch, max_new_tokens=1)
        counts3 = snapshot(build)
        check(counts3.get(kernel + "_mma", 0) == 7 * OTHER_WIDTH_LAYERS
              and not counts3.get(kernel + "_wgmma", 0),
              f"{bits}-bit batch-2 prefill through mma.sync launched {counts3}")
        out[bits] = dict(counts=counts, gen_s=gen_s, repeat_s=again_s, tok_s=tok_s,
                         layers=OTHER_WIDTH_LAYERS, batch2_counts=counts2, mma_counts=counts3,
                         mma_prefill_token_equal=bool(np.array_equal(out3, out2[:, :out3.shape[1]])))
        print(f"{bits}-bit g128, Llama-2-7B widths, {OTHER_WIDTH_LAYERS} of 32 layers, batch 1, "
              f"{PROMPT_LEN}-token prompt, {OTHER_WIDTH_TOKENS} new tokens greedy, twice with "
              f"equal tokens: {gen_s:.3f} s = {tok_s:.2f} tok/s at this depth (repeat "
              f"{again_s:.3f} s), launches {counts}; batch 2 (a {2 * PROMPT_LEN}-row prefill), 4 "
              f"new tokens: launches {counts2}; its prefill through the mma.sync kernel: "
              f"launches {counts3}, first token equal {out[bits]['mma_prefill_token_equal']}",
              flush=True)
        del model
        torch.cuda.empty_cache()
        shutil.rmtree(path, ignore_errors=True)
    return out


def _rel_err(a, b) -> float:
    """Relative Frobenius error of ``a`` against ``b`` (0 where both are 0)."""
    d, ref = (a.float() - b.float()).norm().item(), b.float().norm().item()
    return d / ref if ref else d


def phase_rest_path(torch, np, work: str) -> dict:
    """The rest classes at full width: an 8-layer Llama-2-7B checkpoint at 4-bit
    group size 100 (groups of 100 over K = 4096 with a last one of 96, over
    11008 a last one of 8; 12.5 words of 8 codes per group, so words straddle
    groups), ``from_quantized`` on the card (bf16).

    * A batch-2 greedy generate of 16 tokens: its 32-row prefill through the
      wgmma/TMA tile kernel (exactly 7 x 8 ``w4a16_gemm_wgmma``), its decode
      steps through the tensor-core GEMV's
      ANY_GS instance (exactly 7 x 8 x 15 ``w4a16_gemm_gemv``, no SIMT GEMV);
      the prefill logits and the first decode step's against the same model
      forced through the SIMT kernels (``gemm.forced_kernel("simt")``) within
      E2E_REL_TOL, and the tokens of both routes compared.
    * Two LoRA steps as ``phase_train`` takes them (r 16 on q/v, B = 0 at
      start, 4 x 512 tokens): the forward through ``w4a16_gemm_wgmma``, the
      backward through ``wna16_gemm_t_wgmma`` at M = 2048 (exact counts, no
      other tile kernel or K10); step 1's loss within GRAD_REL_TOL of the SIMT
      route's on the same weights; its adapter gradients against the SIMT
      route's (bf16) and against the same model's in f32 (the SIMT kernels),
      reported and not held: through 8 random layers at this batch the bf16
      gradients of both routes lie far from the f32 ones, so the difference
      of the two routes measures bf16 rounding, not the kernels; a profiled
      step through each route and through the mma.sync tile kernels (device
      ms by family).
    * The held gradient check, on the checkpoint's first 2 layers (the cut and
      batch of ``phase_grads``, 1 x 64 tokens, every adapter tensor drawn):
      the LoRA gradients of the default route (bf16; the wgmma K10) against
      the SIMT route's in f32 on the same weights within GRAD_REL_TOL, and
      against the SIMT route's in bf16, reported. At 1 x 16 tokens the
      tensor-core route's backward is K10's decode regime
      (``wna16_gemm_t_gemv``, no tile K10): its gradients are held against the
      SIMT route's in bf16 (the same model, only the kernels differ) within
      GRAD_REL_TOL; at so few tokens the bf16 model's own rounding moves every
      route's gradients about 5% from f32, so the distances from f32 of the
      decode regime, the SIMT route and the tile kernels (``kernel="mma"``)
      are reported beside it.
    * One LoRA step at 1 x 16 tokens (a decode-sized batch) at full depth: the
      forward through the GEMV's ANY_GS instance and the backward through
      K10's decode regime (exactly 7 x 8 ``w4a16_gemm_gemv`` and 7 x 8 - 3
      ``wna16_gemm_t_gemv``, no tile K10), its loss within GRAD_REL_TOL of the
      SIMT route's (the loss comes before the backward: the cut above holds
      the decode regime's gradients)."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.utils import peft
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B, write_random_checkpoint

    layers, gs = OTHER_WIDTH_LAYERS, REST_PATH_GROUP_SIZE
    nxt = torch.tensor([[1234], [99]], device="cuda")
    cfg = dict(LLAMA2_7B, num_hidden_layers=layers)
    path = os.path.join(work, f"llama2-7b-random-g{gs}")
    write_random_checkpoint(path, cfg, bits=4, group_size=gs, seed=gs)
    model = AutoGPTQForCausalLM.from_quantized(path)
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    prompts = [prompt[0], prompt[0][::-1].copy()]
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()

    def run(forced):   # (batch-2 prefill logits, first decode logits, 16 tokens, launches)
        with gemm.forced_kernel(forced), torch.inference_mode():
            cache = arch.KVCache.create(model.cfg, 2, PROMPT_LEN + 1, dtype=model.dtype)
            logits, cache = arch.forward(model.params, tokens, model.cfg, cache=cache,
                                         dtype=model.dtype)
            dec, _ = arch.forward(model.params, nxt, model.cfg, cache=cache, dtype=model.dtype)
            clear_counts(build)
            out = model.generate(prompts, max_new_tokens=16)
        return logits.float(), dec.float(), out, snapshot(build)

    logits, dec, out, counts = run(None)
    logits_simt, dec_simt, out_simt, counts_simt = run("simt")
    rel, rel_dec = _rel_err(logits, logits_simt), _rel_err(dec, dec_simt)
    check(bool(torch.isfinite(logits).all()) and rel <= E2E_REL_TOL,
          f"g{gs} path: prefill logits against the SIMT route, relative error {rel:.3e} > "
          f"{E2E_REL_TOL}")
    check(bool(torch.isfinite(dec).all()) and rel_dec <= E2E_REL_TOL,
          f"g{gs} path: first decode logits against the SIMT route, relative error "
          f"{rel_dec:.3e} > {E2E_REL_TOL}")
    check(out.shape == (2, PROMPT_LEN + 16) and bool(((out >= 0) & (out < cfg["vocab_size"])).all()),
          f"g{gs} path: output {out.shape}")
    want = {"w4a16_gemm_wgmma": 7 * layers, "w4a16_gemm_gemv": 7 * layers * 15}
    check({k: v for k, v in counts.items() if k.startswith("w4a16")} == want,
          f"g{gs} path: K1 launches {counts}, want {want}")
    same = int((out[:, PROMPT_LEN:] == out_simt[:, PROMPT_LEN:]).sum())
    print(f"rest-class path: Llama-2-7B widths, {layers} layers, 4-bit g{gs}: batch-2 prefill "
          f"logits (the wgmma/TMA tile kernel) against the SIMT route's: relative error "
          f"{rel:.3e}, first decode step's (the tensor-core GEMV) {rel_dec:.3e} (tol "
          f"{E2E_REL_TOL}); {same} of {out[:, PROMPT_LEN:].size} greedy tokens equal to the "
          f"SIMT route's; launches {counts} (SIMT route {counts_simt})", flush=True)

    pcfg = peft.GPTQLoraConfig(r=TRAIN_RANK, lora_alpha=2 * TRAIN_RANK,
                               target_modules=("attn.q_proj", "attn.v_proj"))
    peft.get_gptq_peft_model(model, pcfg, seed=0)
    trainable = peft.trainable_tensors(peft.split_lora_params(model.params)[0])
    opt = torch.optim.AdamW(trainable, lr=TRAIN_LR)
    rng = np.random.default_rng(4)
    batch = torch.from_numpy(rng.integers(1, cfg["vocab_size"], (TRAIN_BATCH, TRAIN_LEN))).cuda()

    def fwd_bwd(m=model):
        logits, _ = arch.forward(m.params, batch, m.cfg, dtype=m.dtype)
        loss = masked_loss(torch, logits, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        return loss.item()

    # step 1's loss and gradients through the SIMT route, the same model in f32 (the same
    # weights and adapters), and last the tensor-core route, whose gradients the step applies
    m32 = AutoGPTQForCausalLM.from_quantized(path, dtype=torch.float32)
    shutil.rmtree(path, ignore_errors=True)
    peft.get_gptq_peft_model(m32, pcfg, seed=0)
    t32 = peft.trainable_tensors(peft.split_lora_params(m32.params)[0])
    check(all(torch.equal(a, b) for a, b in zip(t32, trainable)), "f32 adapters differ")
    losses, launches, grads = {}, {}, {}
    for route, m, leaves in (("simt", model, trainable), ("f32", m32, t32),
                             (None, model, trainable)):
        clear_counts(build)
        with gemm.forced_kernel(route if route != "f32" else None):
            losses[route] = fwd_bwd(m)
        torch.cuda.synchronize()
        launches[route] = snapshot(build)
        grads[route] = [t.grad.float().clone() for t in leaves]
    del m32, t32
    rels = [_rel_err(a, b) for a, b in zip(grads[None], grads["simt"])]
    rels32 = {route: [_rel_err(a, b) for a, b in zip(grads[route], grads["f32"])]
              for route in (None, "simt")}
    loss_rel = abs(losses[None] - losses["simt"]) / abs(losses["simt"])
    check(np.isfinite(losses[None]) and loss_rel <= GRAD_REL_TOL,
          f"g{gs} path: step 1 loss {losses[None]} (SIMT route {losses['simt']})")
    want_step = {"w4a16_gemm_wgmma": 7 * layers, "wna16_gemm_t_wgmma": 7 * layers - 3}
    want_simt = {"w4a16_gemm": 7 * layers, "wna16_gemm_t": 7 * layers - 3}
    check(launches[None] == want_step and launches["simt"] == want_simt,
          f"g{gs} path: a training step launched {launches[None]} (want {want_step}), the SIMT "
          f"route {launches['simt']} (want {want_simt})")
    opt.step()
    step2 = fwd_bwd()
    opt.step()
    check(np.isfinite(step2), f"g{gs} path: step 2 loss {step2}")
    profiles = {}
    for route in (None, "mma", "simt"):
        with gemm.forced_kernel(route):
            profiles[route or "wgmma"] = profile_train_step(torch, fwd_bwd)
    print(f"rest-class path, LoRA r={TRAIN_RANK} on q_proj and v_proj, batch {TRAIN_BATCH} x "
          f"{TRAIN_LEN}: step 1 loss {losses[None]:.6f} (SIMT route {losses['simt']:.6f}, "
          f"relative {loss_rel:.3e}, tol {GRAD_REL_TOL}; f32 {losses['f32']:.6f}); adapter "
          f"gradients (reported, not held; the A tensors' are 0 on every route while B = 0), "
          f"relative error max / median over {len(rels)} tensors: wgmma against SIMT "
          f"route {max(rels):.3e} / {float(np.median(rels)):.3e}, wgmma against f32 "
          f"{max(rels32[None]):.3e} / {float(np.median(rels32[None])):.3e}, SIMT route against "
          f"f32 {max(rels32['simt']):.3e} / {float(np.median(rels32['simt'])):.3e}; step 2 loss "
          f"{step2:.6f}; launches per step {launches[None]} (SIMT route {launches['simt']})",
          flush=True)
    # one step at 1 x 16 tokens: K1's GEMV forward and K10's decode regime backward
    small = batch[:1, :16].contiguous()
    small_losses, small_launches = {}, {}
    for route in ("simt", None):
        clear_counts(build)
        with gemm.forced_kernel(route):
            logits, _ = arch.forward(model.params, small, model.cfg, dtype=model.dtype)
            loss = masked_loss(torch, logits, small)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            small_losses[route] = loss.item()
        small_launches[route] = snapshot(build)
    small_rel = abs(small_losses[None] - small_losses["simt"]) / abs(small_losses["simt"])
    want_small = {"w4a16_gemm_gemv": 7 * layers, "wna16_gemm_t_gemv": 7 * layers - 3}
    want_small_simt = {"w4a16_gemm": 7 * layers, "wna16_gemm_t": 7 * layers - 3}
    check(small_launches[None] == want_small and small_launches["simt"] == want_small_simt,
          f"g{gs} path: a 1 x 16 step launched {small_launches[None]} (want {want_small}), the "
          f"SIMT route {small_launches['simt']} (want {want_small_simt})")
    check(np.isfinite(small_losses[None]) and small_rel <= GRAD_REL_TOL,
          f"g{gs} path: 1 x 16 step loss {small_losses[None]} (SIMT route "
          f"{small_losses['simt']})")
    print(f"rest-class path, LoRA r={TRAIN_RANK} on q_proj and v_proj, batch 1 x 16: loss "
          f"{small_losses[None]:.6f} (SIMT route {small_losses['simt']:.6f}, relative "
          f"{small_rel:.3e}, tol {GRAD_REL_TOL}); launches {small_launches[None]} (SIMT route "
          f"{small_launches['simt']})", flush=True)
    del model, opt, trainable, grads
    torch.cuda.empty_cache()

    cut = os.path.join(work, f"llama2-7b-random-g{gs}-2layers")   # the same first 2 layers
    write_random_checkpoint(cut, dict(cfg, num_hidden_layers=2), bits=4, group_size=gs, seed=gs)
    toks = torch.from_numpy(np.random.default_rng(6).integers(1, cfg["vocab_size"], (1, GRAD_LEN)))
    lens = (GRAD_LEN, 16)   # the tile K10 and K10's decode regime
    cut_grads, cut_launches = {n: {} for n in lens}, {n: {} for n in lens}
    for label, dtype, route in (("default", torch.bfloat16, None),
                                ("simt", torch.bfloat16, "simt"),
                                ("simt f32", torch.float32, None),
                                ("tile", torch.bfloat16, "mma")):
        cm = AutoGPTQForCausalLM.from_quantized(cut, dtype=dtype)
        peft.get_gptq_peft_model(cm, peft.GPTQLoraConfig(r=TRAIN_RANK, lora_alpha=2 * TRAIN_RANK),
                                 seed=0)
        leaves = peft.trainable_tensors(peft.split_lora_params(cm.params)[0])
        _draw_adapters(torch, np, leaves, seed=20)
        for n in lens:
            t = toks[:, :n].cuda()
            for leaf in leaves:
                leaf.grad = None
            clear_counts(build)
            with gemm.forced_kernel(route):
                masked_loss(torch, arch.forward(cm.params, t, cm.cfg, dtype=dtype)[0],
                            t).backward()
            torch.cuda.synchronize()
            cut_launches[n][label] = snapshot(build)
            cut_grads[n][label] = [leaf.grad.float() for leaf in leaves]
        del cm, leaves
    shutil.rmtree(cut, ignore_errors=True)
    cut_rel, cut_rel_bf16, cut_rel_f32 = {}, {}, {}
    for n, t_key in zip(lens, ("wna16_gemm_t_wgmma", "wna16_gemm_t_gemv")):
        grads_n, launches_n = cut_grads[n], cut_launches[n]
        cut_rel[n] = [_rel_err(a, b) for a, b in zip(grads_n["default"], grads_n["simt f32"])]
        cut_rel_bf16[n] = [_rel_err(a, b) for a, b in zip(grads_n["default"], grads_n["simt"])]
        # every bf16 route against f32: (max, median)
        cut_rel_f32[n] = {label: [_rel_err(a, b) for a, b in zip(grads_n[label],
                                                                  grads_n["simt f32"])]
                          for label in ("default", "simt", "tile")}
        spread = ", ".join(f"{label} {max(v):.3e} / {float(np.median(v)):.3e}"
                           for label, v in cut_rel_f32[n].items())
        print(f"rest-class path, 2-layer cut (the first 2 layers), 1 x {n} tokens, LoRA with "
              f"every adapter drawn: gradients of the default route (bf16, {t_key}) against "
              f"the SIMT route's in f32: relative error max {max(cut_rel[n]):.3e}, median "
              f"{float(np.median(cut_rel[n])):.3e}; against the SIMT route's in bf16 max "
              f"{max(cut_rel_bf16[n]):.3e}, median {float(np.median(cut_rel_bf16[n])):.3e} (tol "
              f"{GRAD_REL_TOL}: 1 x {GRAD_LEN} against f32, 1 x 16 against the SIMT route in "
              f"bf16); each bf16 route against f32, max / median: {spread}; launches "
              f"{launches_n}", flush=True)
        others = {"wna16_gemm_t", "wna16_gemm_t_mma", "wna16_gemm_t_wgmma",
                  "wna16_gemm_t_gemv"} - {t_key}
        check(launches_n["default"].get(t_key, 0) > 0
              and not any(launches_n["default"].get(o, 0) for o in others)
              and not launches_n["default"].get("w4a16_gemm", 0)
              and not launches_n["simt f32"].get(t_key, 0)
              and launches_n["tile"].get("wna16_gemm_t_mma", 0) > 0,
              f"g{gs} 2-layer cut, 1 x {n} tokens: launches {launches_n}, want {t_key}")
        held, against = (cut_rel[n], "f32") if n == GRAD_LEN else (cut_rel_bf16[n], "bf16")
        check(all(np.isfinite(held)) and max(held) <= GRAD_REL_TOL,
              f"g{gs} 2-layer cut, 1 x {n} tokens: LoRA gradients of the default route "
              f"({t_key}) against the SIMT route's in {against}, relative error "
              f"{max(held):.3e} > {GRAD_REL_TOL}")
    torch.cuda.empty_cache()
    return dict(layers=layers, group_size=gs, prefill_rel_err=rel, decode_rel_err=rel_dec,
                tokens_equal=same, counts=counts, simt_counts=counts_simt,
                small_step=dict(losses=small_losses, rel_err=small_rel,
                                launches=small_launches),
                losses=losses, step2_loss=step2,
                loss_rel_err=loss_rel, grad_rel_errs=rels,
                grad_rel_errs_f32={"wgmma": rels32[None], "simt": rels32["simt"]},
                step_launches=launches,
                profiles=profiles, cut_grad_rel_errs=cut_rel,
                cut_grad_rel_errs_bf16=cut_rel_bf16, cut_grad_rel_errs_each_f32=cut_rel_f32,
                cut_launches=cut_launches)


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
            clear_counts(build)
            torch.cuda.reset_peak_memory_stats()
            model.quantize(examples, batch_size=CALIB_BATCH)
            counts = snapshot(build)
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
# The paged serving engine's K7 call: its lengths + 1 over SERVE_SLOTS rows, each row's own
# pages up to its length and the null page past them; the length-1 row is an idle slot (length
# 0), whose table names only the null page; 768 = SERVE_PAGES_PER_SEQ * SERVE_PAGE, the cap
ENGINE_K7_LENGTHS = (670, 1, 301, 528, 65, 17, 145, 768)


def phase_k7(torch, timer) -> list:
    """K7 against its plain version at the beam-4 Llama-2-7B shape (bf16 and
    int8 pools, GQA, unequal lengths), over the length sweep (bf16 and int8),
    and at the paged serving engine's shape (SERVE_SLOTS rows, tables
    SERVE_PAGES_PER_SEQ wide, ENGINE_K7_LENGTHS, bf16); each case twice with
    bit-equal results, timed beside SDPA."""
    import torch.nn.functional as F

    from autogptq_tpu_torch.ops import paged_attn as pam

    gen = torch.Generator(device="cuda").manual_seed(7)
    h, d, ps, layers, layer = 32, 128, PAGE, 2, 1
    full = 33 * ps                     # 528 live slots: 16 prompt + 512 new
    cases = [("beam4 bf16", 32, torch.bfloat16, [full] * BEAMS),
             ("beam4 int8", 32, torch.int8, [full] * BEAMS),
             ("GQA 32/8", 8, torch.bfloat16, [full] * BEAMS),
             ("unequal lengths", 32, torch.bfloat16, [full, 300, 77, 1])]
    cases += [(f"beam4 {tag} length {n}", 32, dt, [n] * BEAMS)
              for tag, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)) for n in K7_LENGTHS]
    cases += [("engine 8 slots", 32, torch.bfloat16, list(ENGINE_K7_LENGTHS))]
    rows = []
    for name, hkv, kv_dtype, lens in cases:
        engine = name.startswith("engine")
        b = len(lens)
        if engine:   # null page, then each row's own pages up to its length (none when idle)
            width = SERVE_PAGES_PER_SEQ
            own = [0 if n == 1 else -(-n // ps) for n in lens]
            n_pages = 1 + sum(own)
        else:        # null page, one prompt page, 33 own pages per beam
            width, n_pages = 40, 2 + BEAMS * 33
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
        tables = torch.zeros((b, width), dtype=torch.int32, device="cuda")
        if engine:
            perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).to(torch.int32)
            start = 0
            for row, n in enumerate(own):
                tables[row, :n] = perm[start:start + n]
                start += n
        else:
            live_pages = -(-full // ps)
            perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * live_pages] + 1
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


def page_ops_ptxas() -> list:
    """ptxas' registers, spills and shared memory of K8a's and K8b's
    instances, reported (K8a is launch-bound: a spill is not held)."""
    rows = []
    for lib, key in (("K8a", "kv_write_kernel"), ("K8b", "copy_pages_cluster_kernel"),
                     ("K8b gather/scatter", "move_pages_kernel")):
        mine = ptxas_report("page_ops", key)
        check(len(mine) > 0, f"no {lib} entry in page_ops' ptxas log")
        print(f"{lib} ptxas: {len(mine)} instances, {min(r['registers'] for r in mine)}-"
              f"{max(r['registers'] for r in mine)} registers, spill bytes "
              f"{max(r['spill_stores'] or 0 for r in mine)}/"
              f"{max(r['spill_loads'] or 0 for r in mine)} at most", flush=True)
        rows += mine
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


MANTISSA_BITS = {"torch.bfloat16": 7, "torch.float16": 10, "torch.float32": 23}
# K8a's fused cases: (name, cache layout, activations, int8 pools, B, H, Hkv, layers, slots of
# a row: the paged table's reach or the contiguous cache's S, the position written). The beam-4
# pools and the greedy cache of the Llama-2-7B main path at its last step (16 + 511), the int8
# greedy path's contiguous int8 cache at its last step (kv_quantize's scheme: codes and scales
# bit-equal, no code's tolerance), Mixtral's GQA cache and beam-4 pools at its depth and
# lengths; the paged serving engine's call (layout "engine": SERVE_SLOTS rows, each written at
# its own position through its own pages of a table SERVE_PAGES_PER_SEQ wide, the position-0 row
# an idle slot whose table names only the null page, as the engine's step writes it).
K8A_CASES = (
    ("beam4 bf16", "paged", "bfloat16", False, BEAMS, 32, 32, 32, PROMPT_LEN + NEW_TOKENS, 527),
    ("beam4 int8", "paged", "bfloat16", True, BEAMS, 32, 32, 32, PROMPT_LEN + NEW_TOKENS, 527),
    ("greedy bf16", "cursor", "bfloat16", False, 1, 32, 32, 32, PROMPT_LEN + NEW_TOKENS, 527),
    ("greedy int8", "cursor", "bfloat16", True, 1, 32, 32, 32, PROMPT_LEN + INT8_NEW_TOKENS,
     PROMPT_LEN + INT8_NEW_TOKENS - 1),
    ("Mixtral GQA", "cursor", "bfloat16", False, 1, 32, 8, MIXTRAL_LAYERS,
     PROMPT_LEN + MIXTRAL_NEW_TOKENS, 143),
    ("Mixtral beam4", "paged", "bfloat16", False, BEAMS, 32, 8, MIXTRAL_LAYERS,
     PROMPT_LEN + MIXTRAL_BEAM_TOKENS, 79),
    ("engine 8 slots", "engine", "bfloat16", False, SERVE_SLOTS, 32, 32, 32,
     SERVE_PAGES_PER_SEQ * PAGE, tuple(n - 1 for n in ENGINE_K7_LENGTHS)),
)
K8A_MAIN = "greedy bf16"     # the main path's shape: the kernel entry's times


def ulp_off(torch, got, want, dtype) -> tuple:
    """(elements that differ, elements more than one ulp of ``dtype`` apart)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 1 - MANTISSA_BITS[str(dtype)])
    return int((g != w).sum()), int(((g - w).abs() > ulp).sum())


def k8a_fused_case(torch, pam, gen, timer, case) -> dict:
    """One of K8A_CASES: the kernel against ``rope_write_kv_ref`` on clones of
    the same inputs, then timed beside it and beside the write alone."""
    from autogptq_tpu_torch.ops import build

    name, layout, act, quant, b, h, hkv, layers, reach, p = case
    d, dtype = 128, getattr(torch, act)
    q, k, v = (torch.randn((b, n, d), generator=gen, device="cuda").to(dtype)
               for n in (h, hkv, hkv))
    inv = pam.rope_inv_freq(10000.0, d, "cuda")
    kw = {}
    if layout == "paged":   # beam_paged_prefill's tables: a shared prompt page, then own pages
        w = -(-reach // PAGE)
        n_pages = 2 + b * w
        ordinal = torch.arange(w, device="cuda")[None]
        tables = torch.where(ordinal == 0, 1, 2 + torch.arange(b, device="cuda")[:, None] * w
                             + ordinal).to(torch.int32)
        pos = torch.full((b,), p, dtype=torch.int32, device="cuda")
    elif layout == "engine":   # the null page, then each row's own pages up to its position
        own = [0 if x == 0 else x // PAGE + 1 for x in p]
        n_pages = 1 + sum(own)
        perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).to(torch.int32)
        tables = torch.zeros((b, reach // PAGE), dtype=torch.int32, device="cuda")
        start = 0
        for row, n in enumerate(own):
            tables[row, :n] = perm[start:start + n]
            start += n
        pos = torch.tensor(p, dtype=torch.int32, device="cuda")
    if layout in ("paged", "engine"):
        shape = (layers, n_pages, hkv, PAGE, d)
        if quant:
            kc = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
            kw = dict(k_scale=torch.rand(shape[:-1], generator=gen, device="cuda") + 0.1)
            kw["v_scale"] = kw["k_scale"].clone()
        else:
            kc = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        kw["tables"] = tables
        page_of = tables[torch.arange(b, device="cuda"), pos.long() // PAGE]
        idx = (torch.full((b, 1), layers - 1, device="cuda"), page_of.long()[:, None],
               torch.arange(hkv, device="cuda")[None], (pos.long() % PAGE)[:, None])
    else:
        shape = (layers, b, reach, hkv, d)
        if quant:
            kc = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
            kw = dict(k_scale=torch.rand(shape[:-1] + (1,), generator=gen, device="cuda") + 0.1)
            kw["v_scale"] = kw["k_scale"].clone()
        else:
            kc = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        pos = torch.full((b,), p, dtype=torch.int64, device="cuda")
        kw["cursor"] = torch.tensor([p], device="cuda")
    vc = kc.clone()
    layer = layers - 1
    want = {key: t.clone() for key, t in dict(k=kc, v=vc, **kw).items()}
    want_q = pam.rope_write_kv_ref(q, k, v, pos, inv, want["k"], want["v"], layer,
                                   kw.get("tables"), kw.get("cursor"), want.get("k_scale"),
                                   want.get("v_scale"))
    before = build.launches["rope_write_kv"]
    got_q = pam.rope_write_kv(q, k, v, pos, inv, kc, vc, layer, **kw)
    torch.cuda.synchronize()
    check(build.launches["rope_write_kv"] == before + 1,
          f"K8a {name}: not one launch")
    diff = {"q": ulp_off(torch, got_q, want_q, dtype)}
    code_err = 0
    if quant:
        for key, got in (("k", kc), ("v", vc)):
            delta = (got.int() - want[key].int()).abs()
            diff[key] = (int((delta > 0).sum()), int((delta > 1).sum()))
            code_err = max(code_err, int(delta.max()))
        for key in ("k_scale", "v_scale"):
            diff[key] = ulp_off(torch, kw[key], want[key], dtype)
    else:
        diff["k"] = ulp_off(torch, kc, want["k"], dtype)
        diff["v"] = ulp_off(torch, vc, want["v"], dtype)
    check(all(over == 0 for _, over in diff.values()) and code_err <= 1,
          f"K8a {name}: beyond one ulp or one int8 code of its plain version: {diff}")
    if quant and layout == "cursor":   # the contiguous scheme: correctly rounded divisions
        check(all(diff[key][0] == 0 for key in ("k", "v", "k_scale", "v_scale")),
              f"K8a {name}: the contiguous int8 mode is not bit-equal to kv_quantize: {diff}")
    max_abs = max(float((got_q.float() - want_q.float()).abs().max()),
                  float((kc.float() - want["k"].float()).abs().max()) if not quant else 0.0)
    del want, want_q
    call = (lambda: pam.rope_write_kv(q, k, v, pos, inv, kc, vc, layer, check=False, **kw))
    ms = timer.ms(call)
    plain_ms = timer.ms(lambda: pam.rope_write_kv_ref(q, k, v, pos, inv, kc, vc, layer,
                                                      kw.get("tables"), kw.get("cursor"),
                                                      kw.get("k_scale"), kw.get("v_scale")))
    rows = (k.to(kc.dtype), v.to(vc.dtype))   # the write alone, one call per cache
    if layout != "cursor":
        write_ms = timer.ms(lambda: (kc.index_put_(idx, rows[0]), vc.index_put_(idx, rows[1])))
    else:
        cur = kw["cursor"]
        write_ms = timer.ms(lambda: (kc[layer].index_copy_(1, cur, rows[0][:, None]),
                                     vc[layer].index_copy_(1, cur, rows[1][:, None])))
    es = k.element_size()
    rows_out = 2 * b * hkv * (d * kc.element_size() + (4 if quant else 0))   # K, V (, scales)
    moved = (b * (h + 2 * hkv) * d * es + b * h * d * es + rows_out + b * pos.element_size()
             + d // 2 * 4 + (8 if layout == "cursor" else b * 4))
    b_ms, b_by = bound_ms(moved, 6 * b * (h + hkv) * d // 2, F32_FLOP_PER_S)
    print(f"K8a fused {name:13s} q {list(q.shape)}, k/v {list(k.shape)} {act} into "
          f"{list(kc.shape)} {kc.dtype} ({layout}, position {p}): elements differing from "
          f"rope_write_kv_ref (differ / beyond one ulp or one code): "
          + ", ".join(f"{key} {a} / {o}" for key, (a, o) in diff.items())
          + f"; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  the write alone "
          f"({'index_copy_' if layout == 'cursor' else 'index_put_'} x 2) {write_ms:.4f} ms  "
          f"bound {b_ms:.5f} ms ({b_by})", flush=True)
    return dict(case=name, layout=layout, q=list(q.shape), kv=list(k.shape), cache=list(kc.shape),
                cache_dtype=str(kc.dtype), position=p, differing=diff, max_code_err=code_err,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                write_only_ms=write_ms, bound_ms=b_ms, bound_by=b_by)


# K8b's copies at the beam-4 pool shape: src[1] is dst[0] and src[2] is dst[1] (every read must
# see the pool before any copy), src[3] == dst[3] copies a page onto itself; then a swap cycle
K8B_COPIES = (([2, 35, 68, 101], [35, 68, 120, 101]), ([2, 35, 68, 101], [35, 2, 68, 120]))


def phase_k8(torch, timer) -> tuple:
    """K8a fused (K8A_CASES), then K8a with the rotation off and K8b at the
    beam-4 Llama-2-7B pool shape, all 32 layers."""
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.ops import paged_attn as pam

    gen = torch.Generator(device="cuda").manual_seed(8)
    fused_rows = []
    for case in K8A_CASES:
        fused_rows.append(k8a_fused_case(torch, pam, gen, timer, case))
        torch.cuda.empty_cache()
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
        print(f"K8a rotation off {name:14s} rows {list(rk.shape)} into {list(kp.shape)} {dtype}: "
              f"bit-equal  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  index_put_ {lib_ms:.4f} ms"
              f"  bound {b_ms:.5f} ms ({b_by})", flush=True)

        page_bytes = kp[0, 0].numel() * kp.element_size()
        for src_l, dst_l in K8B_COPIES:
            src = torch.tensor(src_l, dtype=torch.int32, device="cuda")
            dst = torch.tensor(dst_l, dtype=torch.int32, device="cuda")
            want_k = pam.copy_pages(kp.clone(), src, dst)
            want_v = pam.copy_pages(vp.clone(), src, dst)
            before = build.launches["copy_pages_pair"]
            pam.copy_pages_pair(kp, vp, src, dst)
            torch.cuda.synchronize()
            check(build.launches["copy_pages_pair"] == before + 1,
                  f"K8b {name}: not one launch of its cluster kernel")
            check(torch.equal(kp, want_k) and torch.equal(vp, want_v),
                  f"K8b {name} {src_l} -> {dst_l}: pools differ from copy_pages")
            del want_k, want_v
        src = torch.tensor(K8B_COPIES[0][0], dtype=torch.int32, device="cuda")
        dst = torch.tensor(K8B_COPIES[0][1], dtype=torch.int32, device="cuda")
        si, di = src.long(), dst.long()
        ms = timer.ms(lambda: pam.copy_pages_pair(kp, vp, src, dst, check=False))
        wrapper_ms = timer.ms(lambda: pam.copy_pages_pair(kp, vp, src, dst))
        real_plan = pam.copy_plan
        pam.copy_plan = lambda n, nbytes_: 0       # the two-kernel path on the same copies
        try:
            two_ms = timer.ms(lambda: pam.copy_pages_pair(kp, vp, src, dst, check=False))
        finally:
            pam.copy_plan = real_plan
        plain_ms = timer.ms(lambda: (pam.copy_pages(kp, src, dst), pam.copy_pages(vp, src, dst)))
        lib_ms = timer.ms(lambda: (kp.index_copy_(1, di, kp.index_select(1, si)),
                                   vp.index_copy_(1, di, vp.index_select(1, si))))
        moving = sum(a != c for a, c in zip(*K8B_COPIES[0]))      # self-copies move nothing
        b_ms, b_by = bound_ms(2 * 2 * layers * moving * page_bytes + nbytes(src, dst), 0.0)
        slices = pam.copy_plan(src.numel(), page_bytes)
        copy_rows.append(dict(case=name, pages=src.numel(), moving=moving, pool=list(kp.shape),
                              slices=slices, cluster=src.numel() * slices, max_abs_err=0.0, ms=ms,
                              wrapper_ms=wrapper_ms, two_kernel_ms=two_ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"K8b {name:14s} {src.numel()} pages ({moving} moving) x {layers} layers x 2 pools "
              f"of {list(kp.shape)} {dtype}, clusters of {src.numel() * slices} blocks "
              f"({slices} slice(s) of {page_bytes // slices} bytes); src aliasing dst, a swap "
              f"cycle and self-copies: bit-equal  kernel {ms:.4f} ms (check=True, waiting for "
              f"the id flag: {wrapper_ms:.4f} ms)  the gather and scatter kernels {two_ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  index_select+index_copy_ {lib_ms:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        if dtype == torch.bfloat16:
            refuse_bad_ids(torch, pam, kp, vp, layer, page_of, off, rk, rv, src, dst)
        del kp, vp
        torch.cuda.empty_cache()
    return fused_rows, write_rows, copy_rows


def refuse_bad_ids(torch, pam, kp, vp, layer, page_of, off, rk, rv, src, dst) -> None:
    """K8a with a page id past the pool, fused with a position past the table,
    and K8b with a negative src and with a repeated dst raise ValueError and
    leave both pools as they were."""
    n_pages = kp.shape[1]
    bad_page = page_of.clone()
    bad_page[2] = n_pages
    bad_src = src.clone()
    bad_src[1] = -1
    dup_dst = dst.clone()
    dup_dst[3] = dst[0]
    want_k, want_v = kp.clone(), vp.clone()
    b, hkv, d = rk.shape
    tables = torch.arange(b * 2, dtype=torch.int32, device="cuda").reshape(b, 2)
    past = torch.full((b,), 2 * PAGE, dtype=torch.int32, device="cuda")
    inv = pam.rope_inv_freq(10000.0, d, "cuda")
    calls = (("K8a page id past the pool", lambda: pam.write_token_pages_kernel(
                 kp, vp, layer, bad_page, off, rk, rv)),
             ("K8a fused: a position past the table", lambda: pam.rope_write_kv(
                 rk, rk, rv, past, inv, kp, vp, layer, tables=tables)),
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
    print("K8a/K8b bad ids: a page id past the pool, a position past the table (fused), a "
          "negative src and a repeated dst each raise ValueError and leave the pools unchanged",
          flush=True)


def phase_main_path(torch, np, ckpt_dir: str) -> tuple:
    """Returns the launch counts of the 512-token run, the loaded model and
    the run's tokens."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin
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
    with python_calls() as calls:
        clear_counts(build)
        t0 = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=NEW_TOKENS)
        gen_s = time.perf_counter() - t0
        counts = snapshot(build)
    peak = torch.cuda.max_memory_allocated()

    layers = cfg["num_hidden_layers"]
    need_k1 = 7 * layers * NEW_TOKENS       # the 16-row prefill and 511 decode steps
    need_k2 = layers * (NEW_TOKENS - 1)
    new = out[:, PROMPT_LEN:]
    check(out.shape == (1, PROMPT_LEN + NEW_TOKENS), f"output shape {out.shape}")
    check(bool(((new >= 0) & (new < cfg["vocab_size"])).all()), "token ids out of range")
    check(np.array_equal(out[:, :PROMPT_LEN + 4], warm), "greedy decode is not deterministic")
    check(counts.get("w4a16_gemm_gemv", 0) == need_k1 and not counts.get("w4a16_gemm", 0),
          f"K1's GEMV launched {counts.get('w4a16_gemm_gemv', 0)} times, want {need_k1}, and the "
          f"SIMT GEMV {counts.get('w4a16_gemm', 0)}, want 0")
    check(counts.get("flash_decode", 0) >= need_k2,
          f"K2 launched {counts.get('flash_decode', 0)} times, need >= {need_k2}")
    check_fused_writes(counts, calls, layers, NEW_TOKENS - 1, "main path", pools=0)
    tok_s = NEW_TOKENS / gen_s
    print(f"main path: Llama-2-7B 4-bit g128, {layers} layers (full depth), batch 1, "
          f"{PROMPT_LEN}-token prompt, {NEW_TOKENS} new tokens greedy: checkpoint written in "
          f"{write_s:.1f} s, loaded in {load_s:.1f} s, generate {gen_s:.3f} s = {tok_s:.2f} tok/s, "
          f"peak device memory {peak / 2**30:.2f} GiB, launches {counts}", flush=True)

    prompts = [np.arange(PROMPT_LEN) % 1000 + 1, np.arange(9) + 100]
    clear_counts(build)
    out2 = model.generate(prompts, max_new_tokens=16)
    counts2 = snapshot(build)
    check(out2.shape == (2, PROMPT_LEN + 16), f"batch-2 output shape {out2.shape}")
    check(bool((out2[1, :PROMPT_LEN - 9] == 0).all()), "batch-2 row 1 is not left-padded")
    check(bool(((out2 >= 0) & (out2 < cfg["vocab_size"])).all()), "batch-2 token ids out of range")
    # the 32-row prefill takes K1's wgmma/TMA tile kernel, the 15 decode steps its GEMV
    check({k: v for k, v in counts2.items() if k.startswith("w4a16_gemm")}
          == {"w4a16_gemm_wgmma": 7 * layers, "w4a16_gemm_gemv": 7 * layers * 15},
          f"batch-2 K1 launches {counts2}")
    print(f"batch 2, left-padded prompts of {PROMPT_LEN} and 9 tokens (a {2 * PROMPT_LEN}-row "
          f"prefill: K1's wgmma/TMA tile kernel), 16 new tokens: shape {out2.shape}, launches "
          f"{counts2}", flush=True)
    routes = compare_routes(torch, model, prompt, 1e3 * gen_s / NEW_TOKENS, "batch-1 generate",
                            PROFILE_TOKENS)
    # the SIMT route launches a split-K reduce after every GEMV whose plan splits K; the new
    # route folds it into the GEMV's last block, so a token launches that many fewer kernels
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    quant = [node for block in model.params["layers"] for sec in ("attn", "mlp")
             for node in block[sec].values() if isinstance(node, qlin.QuantLinear)]
    folded = sum(gemm.split_k(q.in_features, q.out_features,
                              q.group_size if q.group_size > 0 else q.in_features, sms,
                              32 // q.bits)[1] > 1 for q in quant)
    check(folded == len(quant) == 7 * layers,
          f"{folded} of {len(quant)} projections split K on the SIMT route, want {7 * layers}")
    print(f"folded split-K reduces: {folded} per greedy token (every projection's SIMT plan "
          f"splits K), so the GEMV route launches {folded} fewer kernels per token; the profiles "
          f"recorded {routes['simt'].get('kernels_per_token', float('nan')):.1f} and "
          f"{routes['gemv'].get('kernels_per_token', float('nan')):.1f}", flush=True)
    routes.update(folded_per_token=folded, tok_s=tok_s)
    routes["graph"] = graph_turns(torch, np, model, "main path, batch-1 greedy", prompt,
                                  dict(out=out, s=gen_s, tokens=NEW_TOKENS, counts=counts),
                                  routes.get("gemv"), PROFILE_TOKENS)
    return counts, model, out, counts2, routes


def check_fused_writes(counts, calls, layers: int, steps: int, label: str, pools: int = 1) -> None:
    """A generate of ``steps`` one-token decode steps made exactly one fused
    RoPE + K/V write per layer and step and none with the rotation off, all
    but the eager warm-up step's replayed from the step's CUDA graph; no
    Python call of ``arch.apply_rope`` but the prefill's one per layer and
    none of ``Tensor.index_copy_``. A paged beam run (``pools`` 1, or 2 with
    int8 pools) also made ``pools`` K8b launches per step and at setup, every
    step's but the warm-up's replayed, none through the gather and scatter."""
    want = {"rope_write_kv": layers * steps}
    if pools:
        want["copy_pages_pair"] = pools * (steps + 1)
    got = {key: counts.get(key, 0) for key in want}
    rep = {key: counts.replayed.get(key, 0) for key in want}
    want_rep = {"rope_write_kv": layers * (steps - 1), "copy_pages_pair": pools * (steps - 1)}
    check(got == want and not counts.get("write_token_pages")
          and not counts.get("copy_pages_pair_gather"),
          f"{label}: K8a/K8b launches {got}, want {want}, and no rotation-off or gather launch "
          f"({counts})")
    check(all(rep[key] == want_rep[key] for key in want) or not counts.graphs,
          f"{label}: replayed {rep} of {got}, want {want_rep}")
    check(calls["apply_rope"] == layers and calls["index_copy_"] == 0,
          f"{label}: Python calls {dict(calls)}, want {layers} apply_rope (the prefill's) and no "
          f"index_copy_")
    print(f"{label}: fused RoPE + K/V writes {got['rope_write_kv']} ({rep['rope_write_kv']} "
          f"replayed) = one per layer and decode step"
          + (f", K8b {got['copy_pages_pair']} ({rep['copy_pages_pair']} replayed)" if pools else "")
          + f"; Python calls of apply_rope {calls['apply_rope']} (the prefill's), of index_copy_ "
          f"{calls['index_copy_']}", flush=True)


def phase_kb32l_path(torch, np, ckpt_dir: str, gptq_model, main_out) -> dict:
    """The main path's checkpoint loaded into the kb32l layout (K6): prefill
    logits against the GPTQ-layout model, 256 greedy tokens, 32 again, with
    the launch counts, a profile, a batch-2 generate (K6's tile regime: the
    wgmma/TMA kernel) and its prefill again through the mma.sync kernel
    (``gemm.forced_kernel("mma")``, 1 new token); then one LoRA step on the
    model (r 16 on q_proj and v_proj, one 4 x 512-token batch, AdamW): a
    finite loss, exactly 7 x 32 ``w4a16_kb32l_gemm_wgmma`` and 7 x 32 - 3
    ``w4a16_kb32l_gemm_t_wgmma`` (K10 over the kb32l words above 16 rows),
    no other K10 kernel and no K1."""
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
    clear_counts(build)
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=KB32L_NEW_TOKENS)
    gen_s = time.perf_counter() - t0
    counts = snapshot(build)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = model.generate(prompt, max_new_tokens=REPEAT_TOKENS)
    again_s = time.perf_counter() - t0
    steps = KB32L_NEW_TOKENS - 1
    # the 16-token prefill (M = 16) and every decode step (M = 1): 7 launches per layer of
    # K6's tensor-core GEMV, none of its ring (so no split-K reduce either)
    gemv_key = gemm.KB32L_KERNEL + gemm.GEMV_SUFFIX
    want_counts = {gemv_key: 7 * layers * (steps + 1), gemm.KB32L_KERNEL: 0,
                   "flash_decode": layers * steps}
    new = out[:, PROMPT_LEN:]
    check(out.shape == (1, PROMPT_LEN + KB32L_NEW_TOKENS), f"kb32l output shape {out.shape}")
    check(bool(((new >= 0) & (new < vocab)).all()), "kb32l token ids out of range")
    check(np.array_equal(out[:, :PROMPT_LEN + REPEAT_TOKENS], again),
          "kb32l greedy decode does not repeat its tokens")
    check(np.array_equal(out[:, :PROMPT_LEN + 4], warm), "kb32l greedy decode is not "
                                                         "deterministic")
    for name, n in want_counts.items():
        check(counts.get(name, 0) == n, f"kb32l greedy: {name} launched {counts.get(name, 0)} "
                                        f"times, want {n}")
    check(not any(counts.get("w4a16_gemm" + suffix, 0) for suffix in ROUTE_SUFFIX.values()),
          f"kb32l greedy launched K1: {counts}")
    main_new = main_out[:, PROMPT_LEN:PROMPT_LEN + KB32L_NEW_TOKENS]
    same = float((new == main_new).mean())
    agree = int(np.argmin(new[0] == main_new[0])) if same < 1 else KB32L_NEW_TOKENS
    tok_s = KB32L_NEW_TOKENS / gen_s
    print(f"kb32l path: Llama-2-7B 4-bit g128 from_quantized(layout='kb32l'), {layers} layers, "
          f"batch 1, {PROMPT_LEN}-token prompt, {KB32L_NEW_TOKENS} new tokens greedy (repeated "
          f"over "
          f"{REPEAT_TOKENS}, equal tokens): loaded in {load_s:.1f} s (peak {load_peak / 2**30:.2f} GiB), prefill logits "
          f"vs the GPTQ layout rel err {prefill_rel:.3e} (tol {KB32L_E2E_REL_TOL}), generate "
          f"{gen_s:.3f} s = {tok_s:.2f} tok/s (repeat of {REPEAT_TOKENS}: {again_s:.3f} s), "
          f"peak device memory {peak / 2**30:.2f} GiB; launches per decode token: K6's GEMV "
          f"{(counts.get(gemv_key, 0) - 7 * layers) / steps:.0f}, K2 "
          f"{counts.get('flash_decode', 0) / steps:.0f}, K1 0; {100 * same:.1f}% of the tokens "
          f"equal to the main path's (the first {agree} in a row); launches {counts}", flush=True)
    profile = compare_routes(torch, model, prompt, 1e3 * gen_s / KB32L_NEW_TOKENS,
                             "kb32l batch-1 generate", KB32L_PROFILE_TOKENS,
                             checked=(("K6 w4a16_kb32l_gemm", gemm.KB32L_KERNEL),),
                             families=KB32L_FAMILIES)

    prompts = [np.arange(PROMPT_LEN) % 1000 + 1, np.arange(PROMPT_LEN) + 100]
    clear_counts(build)
    out2 = model.generate(prompts, max_new_tokens=16)
    counts2 = snapshot(build)
    check(out2.shape == (2, PROMPT_LEN + 16), f"kb32l batch-2 output shape {out2.shape}")
    check(bool(((out2 >= 0) & (out2 < vocab)).all()), "kb32l batch-2 token ids out of range")
    check(counts2.get(gemm.KB32L_KERNEL + gemm.WGMMA_SUFFIX, 0) == 7 * layers
          and not counts2.get(gemm.KB32L_KERNEL + gemm.MMA_SUFFIX, 0)
          and counts2.get(gemv_key, 0) == 7 * layers * 15
          and not counts2.get(gemm.KB32L_KERNEL, 0)
          and not any(counts2.get("w4a16_gemm" + suffix, 0) for suffix in ROUTE_SUFFIX.values()),
          f"kb32l batch-2 launches {counts2}")
    print(f"kb32l batch 2, two {PROMPT_LEN}-token prompts (a {2 * PROMPT_LEN}-row prefill: K6's "
          f"tile regime, the wgmma/TMA kernel; 2-row decode steps: its GEMV), 16 new tokens: "
          f"shape {out2.shape}, launches "
          f"{counts2}", flush=True)
    clear_counts(build)
    with gemm.forced_kernel("mma"):
        out_mma = model.generate(prompts, max_new_tokens=1)
    mma_counts = snapshot(build)
    check(mma_counts.get(gemm.KB32L_KERNEL + gemm.MMA_SUFFIX, 0) == 7 * layers
          and not mma_counts.get(gemm.KB32L_KERNEL + gemm.WGMMA_SUFFIX, 0)
          and out_mma.shape == (2, PROMPT_LEN + 1),
          f"kb32l batch-2 prefill forced through the mma.sync kernel: launches {mma_counts}")
    print(f"kb32l batch-2 prefill forced through the mma.sync kernel (kernel='mma'): first token "
          f"{'equal to' if np.array_equal(out_mma, out2[:, :PROMPT_LEN + 1]) else 'unlike'} the "
          f"wgmma route's, launches {mma_counts}", flush=True)
    train = kb32l_train_step(torch, np, model)
    del model
    torch.cuda.empty_cache()
    return dict(load_s=load_s, load_peak_bytes=load_peak, prefill_rel_err=prefill_rel,
                gen_s=gen_s, repeat_s=again_s, tok_s=tok_s, peak_bytes=peak, counts=counts,
                share_equal_to_main=same, leading_equal_tokens=agree, profile=profile,
                batch2_counts=counts2, mma_counts=mma_counts, train=train)


def kb32l_train_step(torch, np, model) -> dict:
    """One LoRA step (the train phase's adapters, batch and loss) on a model
    loaded with ``layout="kb32l"``, the launch counts set to 0 just before and
    read just after: K6's wgmma forward once per projection, the wgmma K10
    over the kb32l words once per projection but layer 0's q/k/v (its input
    needs no gradient), nothing else of K6, K10 or K1."""
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.utils import peft

    cfg, layers = model.cfg, model.cfg.num_layers
    peft.get_gptq_peft_model(model, peft.GPTQLoraConfig(
        r=TRAIN_RANK, lora_alpha=2 * TRAIN_RANK, target_modules=("attn.q_proj", "attn.v_proj")),
        seed=0)
    trainable = peft.trainable_tensors(peft.split_lora_params(model.params)[0])
    opt = torch.optim.AdamW(trainable, lr=TRAIN_LR)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (TRAIN_BATCH, TRAIN_LEN))).cuda()
    torch.cuda.synchronize()
    clear_counts(build)
    t0 = time.perf_counter()
    logits, _ = arch.forward(model.params, tokens, cfg, dtype=model.dtype)
    loss = masked_loss(torch, logits, tokens)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    loss = loss.item()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = {k: v for k, v in build.launches.items() if v}
    want = {gemm.KB32L_KERNEL + gemm.WGMMA_SUFFIX: 7 * layers, gemm.KB32L_T_WGMMA: 7 * layers - 3}
    quant = {k: v for k, v in counts.items()
             if k.startswith((gemm.KB32L_KERNEL, gemm.T_KERNEL, "w4a16_gemm"))}
    check(bool(np.isfinite(loss)), f"kb32l LoRA step: non-finite loss {loss}")
    check(quant == want, f"kb32l LoRA step launched {quant}, want {want} (no "
                         f"{gemm.T_KERNEL}{gemm.MMA_SUFFIX}, no K1)")
    print(f"kb32l LoRA step: r={TRAIN_RANK} on q_proj and v_proj, {layers} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_LEN} tokens, AdamW: loss {loss:.6f}, {step_s:.3f} s (the "
          f"first step); launches {counts}", flush=True)
    return dict(loss=loss, s=step_s, counts=counts)


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
        clear_counts(build)
        with torch.inference_mode():
            cache = KVCache.create(model.cfg, 1, PROMPT_LEN + 1, dtype=torch.float32,
                                   device=device)
            pre, cache = forward(model.params, tokens.to(device), model.cfg, cache=cache)
            dec, _ = forward(model.params, nxt.to(device), model.cfg, cache=cache)
        if device == "cuda":
            torch.cuda.synchronize()
            card_launches = snapshot(build)
            # f32 takes K6's ring in both forwards (prefill M = 16, decode M = 1)
            check(build.launches[gemm.KB32L_KERNEL] == 2 * 7 * 2 and
                  not build.launches[gemm.KB32L_KERNEL + gemm.GEMV_SUFFIX] and
                  not any(build.launches["w4a16_gemm" + suffix] for suffix in ROUTE_SUFFIX.values()),
                  f"kb32l cut launched {snapshot(build)}")
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
    print("kb32l card (f32, K6's ring) vs CPU (f32, plain), 2 full-width layers: "
          + ", ".join(f"{k} rel err {v['rel_err']:.3e} max abs {v['max_abs_err']:.3e}"
                      for k, v in rows.items()) + f" (tol {KB32L_CUT_F32_REL_TOL})", flush=True)
    rows["card launches"] = card_launches
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
    with python_calls() as calls:
        clear_counts(build)
        t0 = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=NEW_TOKENS, num_beams=BEAMS)
        gen_s = time.perf_counter() - t0
        counts = snapshot(build)
    peak = torch.cuda.max_memory_allocated()

    steps = NEW_TOKENS - 1
    need = {"paged_attention_mh": layers * steps}
    check_fused_writes(counts, calls, layers, steps, f"beam {BEAMS}")
    # the 16-row prefill and every 4-row beam step: K1's tensor-core GEMV, no SIMT GEMV
    check(counts.get("w4a16_gemm_gemv", 0) == 7 * layers * NEW_TOKENS
          and not counts.get("w4a16_gemm", 0), f"beam: K1 launches {counts}, want "
                                              f"{7 * layers * NEW_TOKENS} w4a16_gemm_gemv")
    check(out.shape == (1, PROMPT_LEN + NEW_TOKENS), f"beam output shape {out.shape}")
    check(bool(((out[:, PROMPT_LEN:] >= 0) & (out[:, PROMPT_LEN:] < vocab)).all()),
          "beam token ids out of range")
    for name, n in need.items():
        check(counts.get(name, 0) >= n, f"beam: {name} launched {counts.get(name, 0)} times, "
                                         f"need >= {n}")
    seq_tok_s = NEW_TOKENS / gen_s
    print(f"beam path: Llama-2-7B 4-bit g128, {layers} layers (full depth), batch 1, "
          f"{PROMPT_LEN}-token prompt, {NEW_TOKENS} new tokens, num_beams={BEAMS}, paged bf16 "
          f"cache (page {PAGE}): generate {gen_s:.3f} s = {seq_tok_s:.2f} seq-tok/s = "
          f"{BEAMS * seq_tok_s:.2f} beam-tok/s (repeated over {FUSED_AB_TOKENS} tokens in the "
          f"fused-norm phase); "
          f"AutoGPTQ gptq-int4 beam 4 on 1x A100-40G: {AUTOGPTQ_BEAM4_A100} tok/s (that "
          f"card's number, BASELINE.md); peak device memory {peak / 2**30:.2f} GiB, "
          f"launches {counts}", flush=True)

    with python_calls() as calls_q:
        clear_counts(build)
        t0 = time.perf_counter()
        outq = model.generate(prompt, max_new_tokens=QUANT_NEW_TOKENS, num_beams=BEAMS,
                              kv_quant=True)
        q_s = time.perf_counter() - t0
        counts_q = snapshot(build)
    qsteps = QUANT_NEW_TOKENS - 1
    need_q = {"paged_attention_mh": layers * qsteps}
    check_fused_writes(counts_q, calls_q, layers, qsteps, f"beam {BEAMS}, int8 pools", pools=2)
    check(counts_q.get("w4a16_gemm_gemv", 0) == 7 * layers * QUANT_NEW_TOKENS
          and not counts_q.get("w4a16_gemm", 0), f"int8 beam: K1 launches {counts_q}")
    check(outq.shape == (1, PROMPT_LEN + QUANT_NEW_TOKENS), f"int8 beam output shape {outq.shape}")
    check(bool(((outq[:, PROMPT_LEN:] >= 0) & (outq[:, PROMPT_LEN:] < vocab)).all()),
          "int8 beam token ids out of range")
    for name, n in need_q.items():
        check(counts_q.get(name, 0) >= n, f"int8 beam: {name} launched "
                                          f"{counts_q.get(name, 0)} times, need >= {n}")
    print(f"beam path, int8 paged cache (kv_quant=True): {QUANT_NEW_TOKENS} new tokens, "
          f"num_beams={BEAMS}: generate {q_s:.3f} s = {QUANT_NEW_TOKENS / q_s:.2f} seq-tok/s, "
          f"launches {counts_q}", flush=True)
    routes = compare_routes(torch, model, prompt, 1e3 * gen_s / NEW_TOKENS,
                            f"beam-{BEAMS} generate", BEAM_PROFILE_TOKENS, num_beams=BEAMS)
    graph = graph_turns(torch, np, model, f"beam {BEAMS}", prompt,
                        dict(out=out, s=gen_s, tokens=NEW_TOKENS, counts=counts),
                        routes.get("gemv"), BEAM_PROFILE_TOKENS, num_beams=BEAMS)
    graph_q = graph_turns(torch, np, model, f"beam {BEAMS}, int8 pools", prompt,
                          dict(out=outq, s=q_s, tokens=QUANT_NEW_TOKENS, counts=counts_q), None,
                          BEAM_PROFILE_TOKENS, num_beams=BEAMS, kv_quant=True)
    return dict(counts=counts, gen_s=gen_s, seq_tok_s=seq_tok_s, graph=graph, int8_graph=graph_q,
                beam_tok_s=BEAMS * seq_tok_s, peak_bytes=peak, int8_new_tokens=QUANT_NEW_TOKENS,
                int8_gen_s=q_s, int8_counts=counts_q, profiles=routes)


def phase_fused_norm(torch, np, model, main_out) -> dict:
    """The main path's model with the switch on (``arch.FUSE_NORM = "1"``, put
    back after): ``FUSED_NEW_TOKENS`` greedy tokens (counts set to 0 just before and read just
    after: 160 ``w4a16_gemm_gemv_norm``, as many rstd launches and 64
    ``w4a16_gemm_gemv`` per decode token, no ``rms_norm`` but the final norm's, no unfused fallback), a profiled
    33-token window, tokens equal to the default run's; beam-4 runs of 48 tokens
    with the switch off, on, on and off (host time in turns; each repeats its
    tokens; the same counts per step as greedy; its tokens compared with the
    switch off); a bf16 batch of 24 prompts whose decode steps take the
    wgmma/TMA tile kernel's prologue (``w4a16_gemm_wgmma_norm`` and as many
    ``w4a16_gemm_wgmma_norm_rstd``), and 2 tokens of it forced through the
    mma.sync kernels (``w4a16_gemm_mma_norm``); a bf16 batch of 16 of those
    prompts, 8 greedy tokens, whose decode steps take the fused GEMV at M = 16
    (160 ``w4a16_gemm_gemv_norm`` per step, with as many rstd launches), its
    tokens against the same batch's with
    the switch off (counted: where a random model's logits nearly tie, the
    rstd's other sum order moves a token), and one decode step of 16
    equal-length prompts with the switch on and off after the same prefill:
    logits within ``FUSED_STEP_REL_TOL``, 160 ``w4a16_gemm_gemv_norm`` in the
    fused step, planted faults beyond it (:func:`fused_decode_step`); then
    one 4-token generate profiled and read both ways
    (:func:`profile_readers`)."""
    import collections

    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.ops import build, gemm

    layers = model.cfg.num_layers
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    rng = np.random.default_rng(24)
    prompts = [rng.integers(1, 32000, size=n).astype(np.int32)
               for n in rng.integers(4, PROMPT_LEN + 1, size=FUSED_BATCH)]
    norms = collections.Counter()
    rms_norm, rms_apply = arch.rms_norm, gemm.rms_apply

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            norms[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def run(tokens, fused, **kw):   # (tokens, seconds, launches, norm calls)
        arch.FUSE_NORM = "1" if fused else "0"
        clear_counts(build)
        norms.clear()
        t0 = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=tokens, **kw)
        return out, time.perf_counter() - t0, snapshot(build), dict(norms)

    turns = (False, True, True, False)
    arch.rms_norm, gemm.rms_apply = counted("rms_norm", rms_norm), counted("rms_apply", rms_apply)
    try:
        arch.FUSE_NORM = "1"
        warm = model.generate(prompt, max_new_tokens=4)
        out, gen_s, counts, norm_calls = run(FUSED_NEW_TOKENS, True)
        profile = profile_generate(torch, model, prompt, 1e3 * gen_s / FUSED_NEW_TOKENS,
                                   "batch-1 generate, fused norm", PROFILE_TOKENS)
        graph = graph_turns(torch, np, model, "fused norm, batch-1 greedy", prompt,
                            dict(out=out, s=gen_s, tokens=FUSED_NEW_TOKENS, counts=counts),
                            profile, PROFILE_TOKENS)
        model.generate(prompt, max_new_tokens=4, num_beams=BEAMS)
        beam_ab = [run(FUSED_AB_TOKENS, fused, num_beams=BEAMS) for fused in turns]
        arch.FUSE_NORM = "1"
        beam_profile = profile_generate(torch, model, prompt,
                                        1e3 * (beam_ab[1][1] + beam_ab[2][1]) / 2 / FUSED_AB_TOKENS,
                                        f"beam-{BEAMS} generate, fused norm",
                                        BEAM_PROFILE_TOKENS, num_beams=BEAMS)
        clear_counts(build)
        batch = model.generate(prompts, max_new_tokens=FUSED_BATCH_TOKENS)
        batch_counts = snapshot(build)
        clear_counts(build)
        with gemm.forced_kernel("mma"):
            batch_mma = model.generate(prompts, max_new_tokens=2)
        mma_counts = snapshot(build)
        arch.FUSE_NORM = "0"
        batch_ref = model.generate(prompts, max_new_tokens=FUSED_BATCH_TOKENS)
        arch.FUSE_NORM = "1"
        clear_counts(build)
        t0 = time.perf_counter()
        batch16 = model.generate(prompts[:FUSED_BATCH16], max_new_tokens=FUSED_BATCH16_TOKENS)
        batch16_s = time.perf_counter() - t0
        batch16_counts = snapshot(build)
        arch.FUSE_NORM = "0"
        t0 = time.perf_counter()
        batch16_ref = model.generate(prompts[:FUSED_BATCH16],
                                     max_new_tokens=FUSED_BATCH16_TOKENS)
        batch16_ref_s = time.perf_counter() - t0
        step16 = fused_decode_step(torch, np, model)
        arch.FUSE_NORM = "1"
        with jit_generate(False):
            readers = profile_readers(torch, lambda: model.generate(prompt, max_new_tokens=4))
    finally:
        arch.FUSE_NORM = "0"
        arch.rms_norm, gemm.rms_apply = rms_norm, rms_apply

    def k1_counts(c):
        return {k: v for k, v in c.items() if k.startswith("w4a16_gemm")}

    def want(steps, fused, unfused):   # K1 launches of a run of `steps` one-token steps
        rstd = {gemm.RSTD_KERNEL: 5 * layers * steps} if fused != NORM_KEY["mma"] else {}
        return {fused: 5 * layers * steps, unfused: 7 * layers + 2 * layers * steps, **rstd}

    vocab = model.cfg.vocab_size
    check(out.shape == (1, PROMPT_LEN + FUSED_NEW_TOKENS) and bool(
        ((out[:, PROMPT_LEN:] >= 0) & (out[:, PROMPT_LEN:] < vocab)).all()),
        f"fused greedy output {out.shape}")
    check(np.array_equal(out[:, :PROMPT_LEN + 4], warm), "fused greedy is not deterministic")
    steps = FUSED_NEW_TOKENS - 1
    check(k1_counts(counts) == want(steps, "w4a16_gemm_gemv_norm", "w4a16_gemm_gemv"),
          f"fused greedy: K1 launches {k1_counts(counts)}, want "
          f"{want(steps, 'w4a16_gemm_gemv_norm', 'w4a16_gemm_gemv')}")
    # the prefill's 2 norms per layer and the final one, then one final norm per step
    # the Python of a decode step runs in the warm-up and the capture only: replays run none
    check(norm_calls == {"rms_norm": 2 * layers + 1 + python_steps(steps)},
          f"fused greedy: norm calls {norm_calls}, want rms_norm "
          f"{2 * layers + 1 + python_steps(steps)}")
    main_new = main_out[0, PROMPT_LEN:PROMPT_LEN + FUSED_NEW_TOKENS]
    same = int((out[0, PROMPT_LEN:] == main_new).sum())
    diff = np.nonzero(out[0, PROMPT_LEN:] != main_new)[0]
    tok_s = FUSED_NEW_TOKENS / gen_s
    print(f"fused norm (AUTOGPTQ_TPU_FUSE_NORM=1), greedy: {FUSED_NEW_TOKENS} tokens in "
          f"{gen_s:.3f} s "
          f"= {tok_s:.2f} tok/s; per decode token {5 * layers} w4a16_gemm_gemv_norm and as many "
          f"rstd launches, "
          f"{2 * layers} w4a16_gemm_gemv, 1 rms_norm (the final norm); {same} of "
          f"{FUSED_NEW_TOKENS} "
          f"tokens equal to the default run's (first difference at "
          f"{int(diff[0]) if len(diff) else None}); launches {counts}", flush=True)

    ab_steps = FUSED_AB_TOKENS - 1
    n_ab = PROMPT_LEN + FUSED_AB_TOKENS
    runs = beam_ab
    check(np.array_equal(runs[0][0], runs[3][0]) and np.array_equal(runs[1][0], runs[2][0]),
          f"fused-norm turns, beam {BEAMS}: a run does not repeat its tokens")
    check(runs[1][0].shape == (1, n_ab) and bool(
        ((runs[1][0][:, PROMPT_LEN:] >= 0) & (runs[1][0][:, PROMPT_LEN:] < vocab)).all()),
        f"fused-norm turns, beam {BEAMS}: output {runs[1][0].shape}")
    check(k1_counts(runs[1][2]) == want(ab_steps, "w4a16_gemm_gemv_norm", "w4a16_gemm_gemv")
          and k1_counts(runs[0][2]) == {"w4a16_gemm_gemv": 7 * layers * FUSED_AB_TOKENS},
          f"fused-norm turns, beam {BEAMS}: K1 launches {runs[1][2]} / {runs[0][2]}")
    check(runs[1][3] == {"rms_norm": 2 * layers + 1 + python_steps(ab_steps)},
          f"fused-norm turns, beam {BEAMS}: norm calls {runs[1][3]}")
    boff_s, bon_s = (beam_ab[0][1] + beam_ab[3][1]) / 2, (beam_ab[1][1] + beam_ab[2][1]) / 2
    beam_same = int((beam_ab[1][0][0, PROMPT_LEN:] == beam_ab[0][0][0, PROMPT_LEN:]).sum())
    print(f"fused norm in turns (off, on, on, off; {FUSED_AB_TOKENS} tokens each, every run repeats "
          f"its tokens): beam {BEAMS} "
          f"{BEAMS * FUSED_AB_TOKENS / boff_s:.2f} beam-tok/s off, "
          f"{BEAMS * FUSED_AB_TOKENS / bon_s:.2f} on ({[round(r[1], 3) for r in beam_ab]} s), "
          f"per step {5 * layers} w4a16_gemm_gemv_norm and as many rstd launches, {2 * layers} "
          f"w4a16_gemm_gemv, 1 rms_norm; "
          f"{beam_same} of {FUSED_AB_TOKENS} beam tokens equal to the unfused beam's; launches "
          f"{beam_ab[1][2]}", flush=True)
    bsteps = FUSED_BATCH_TOKENS - 1
    check(k1_counts(batch_counts) == want(bsteps, "w4a16_gemm_wgmma_norm", "w4a16_gemm_wgmma"),
          f"fused batch {FUSED_BATCH}: K1 launches {k1_counts(batch_counts)}")
    check(k1_counts(mma_counts) == want(1, "w4a16_gemm_mma_norm", "w4a16_gemm_mma")
          and batch_mma.shape == (FUSED_BATCH, batch.shape[1] - FUSED_BATCH_TOKENS + 2),
          f"fused batch {FUSED_BATCH} forced through the mma.sync kernels: K1 launches "
          f"{k1_counts(mma_counts)}")
    batch_same = int((batch[:, -FUSED_BATCH_TOKENS:] == batch_ref[:, -FUSED_BATCH_TOKENS:]).sum())
    print(f"fused norm, bf16 batch of {FUSED_BATCH} prompts, {FUSED_BATCH_TOKENS} new tokens "
          f"(decode steps of {FUSED_BATCH} rows: the wgmma/TMA tile kernel's prologue): "
          f"{batch_same} of {batch_ref[:, -FUSED_BATCH_TOKENS:].size} tokens equal to the "
          f"unfused run's; launches {batch_counts}; 2 tokens forced through the mma.sync "
          f"kernels: launches {mma_counts}", flush=True)
    b16_steps = FUSED_BATCH16_TOKENS - 1
    # the prefill's 16 x 16 rows on the wgmma kernel, unfused; each decode step's 16 rows on
    # the GEMV: q/k/v and gate/up fused, o and down not
    want16 = {"w4a16_gemm_wgmma": 7 * layers, "w4a16_gemm_gemv": 2 * layers * b16_steps,
              **{k: v for k, v in want(b16_steps, NORM_KEY["gemv"], "w4a16_gemm_gemv").items()
                 if k != "w4a16_gemm_gemv"}}
    check(k1_counts(batch16_counts) == want16,
          f"fused batch {FUSED_BATCH16}: K1 launches {k1_counts(batch16_counts)}, want {want16}")
    check(batch16.shape == batch16_ref.shape, f"fused batch {FUSED_BATCH16}: output "
                                              f"{batch16.shape}, unfused {batch16_ref.shape}")
    new16, ref16 = batch16[:, -FUSED_BATCH16_TOKENS:], batch16_ref[:, -FUSED_BATCH16_TOKENS:]
    differ = np.argwhere(new16 != ref16)
    first = differ[np.argmin(differ[:, 1])].tolist() if len(differ) else None
    batch16_same = int((new16 == ref16).sum())
    print(f"fused norm, bf16 batch of {FUSED_BATCH16} prompts, {FUSED_BATCH16_TOKENS} new tokens "
          f"(decode steps of {FUSED_BATCH16} rows: the fused GEMV, rstd "
          f"by one launch before it"
          f"): {batch16_same} of {new16.size} tokens equal to the unfused run's (first difference "
          f"at [row, token] {first}); {FUSED_BATCH16 * FUSED_BATCH16_TOKENS / batch16_s:.2f}"
          f" tok/s ({FUSED_BATCH16 * FUSED_BATCH16_TOKENS / batch16_ref_s:.2f} unfused, prefill "
          f"included); launches {batch16_counts}", flush=True)
    return dict(counts=counts, gen_s=gen_s, tok_s=tok_s, norm_calls=norm_calls, graph=graph,
                tokens_equal=same, first_difference=int(diff[0]) if len(diff) else None,
                profile=profile, beam_turns_s=[r[1] for r in beam_ab], beam_counts=beam_ab[1][2],
                beam_tok_s_off=BEAMS * FUSED_AB_TOKENS / boff_s,
                beam_tok_s_on=BEAMS * FUSED_AB_TOKENS / bon_s, beam_tokens_equal=beam_same,
                beam_profile=beam_profile, batch_counts=batch_counts,
                batch_tokens_equal=batch_same, mma_batch_counts=mma_counts,
                batch16_counts=batch16_counts, batch16_tokens_equal=batch16_same,
                batch16_first_difference=first, step16=step16, batch16_s=batch16_s,
                batch16_ref_s=batch16_ref_s, profile_readers=readers)


def fused_decode_step(torch, np, model) -> dict:
    """One decode step of ``FUSED_BATCH16`` equal-length prompts after the
    same prefill, with the switch on and off: the fused step's K1 launches
    (160 ``w4a16_gemm_gemv_norm`` and as many rstd launches, 64 unfused GEMVs)
    and its logits against the unfused step's within ``FUSED_STEP_REL_TOL``.
    Two witnesses of what parts them: the rstd kernel on the inputs of the
    fused step's 160 prologues against torch's rstd, with the share of x_n
    elements whose bf16 rounding the difference moves; and two planted
    faults, the fused projections' x normalized (in torch, unfused) by the
    neighbouring row's rstd and by the previous fused call's, whose logits
    must each stray beyond the tolerance. Sets
    ``arch.FUSE_NORM``; the caller restores it."""
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.models.arch import KVCache, forward
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    layers = model.cfg.num_layers
    rng = np.random.default_rng(16)
    tokens = torch.from_numpy(rng.integers(1, 32000, size=(FUSED_BATCH16, PROMPT_LEN))).cuda()
    nxt = torch.from_numpy(rng.integers(1, 32000, size=(FUSED_BATCH16, 1))).cuda()
    matmul = qlin.matmul
    seen = []   # (x, norm weight, eps) of every fused projection of the sound fused step

    def recorded(x, layer, prenorm=None, **kw):
        if prenorm is not None:
            seen.append((x.detach().clone(), prenorm[0], prenorm[1]))
        return matmul(x, layer, prenorm=prenorm, **kw)

    def planted(fault):   # the fused projections' prologue, unfused in torch, with a fault
        last = []

        def hooked(x, layer, prenorm=None, **kw):
            if prenorm is None:
                return matmul(x, layer, **kw)
            w, eps, _ = prenorm
            xf = x.float().reshape(-1, x.shape[-1])
            r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
            if fault == "neighbour":     # each row takes the next row's rstd
                used = r.roll(1, 0)
            else:                        # stale: the rows' rstd of the previous fused call
                used = last[-1] if last else r
                last.append(r)
            return matmul((xf * used * w.float()).to(x.dtype).reshape(x.shape), layer, **kw)
        return hooked

    logits, launched = {}, {}
    with torch.inference_mode():
        for run, fused, hook in (("fused", True, recorded), ("unfused", False, None),
                                 ("neighbour", True, planted("neighbour")),
                                 ("stale", True, planted("stale"))):
            arch.FUSE_NORM = "0"
            cache = KVCache.create(model.cfg, FUSED_BATCH16, PROMPT_LEN + 1, dtype=model.dtype,
                                   device="cuda")
            _, cache = forward(model.params, tokens, model.cfg, cache=cache, dtype=model.dtype)
            arch.FUSE_NORM = "1" if fused else "0"
            clear_counts(build)
            qlin.matmul = hook or matmul
            try:
                out, _ = forward(model.params, nxt, model.cfg, cache=cache, dtype=model.dtype)
            finally:
                qlin.matmul = matmul
            logits[run] = out.float()
            launched[run] = {k: v for k, v in build.launches.items() if k.startswith("w4a16_gemm")}
            del cache

    def rel(run):
        return ((logits[run] - logits["unfused"]).norm() / logits["unfused"].norm()).item()

    def held(run):   # what the check below accepts
        return bool(torch.isfinite(logits[run]).all()) and rel(run) <= FUSED_STEP_REL_TOL

    step_rel, fault_rel, stale_rel = rel("fused"), rel("neighbour"), rel("stale")
    want = {"w4a16_gemm_gemv_norm": 5 * layers, "w4a16_gemm_gemv": 2 * layers,
            gemm.RSTD_KERNEL: 5 * layers}
    check(launched["fused"] == want, f"fused decode step of {FUSED_BATCH16} rows: K1 launches "
                                     f"{launched['fused']}, want {want}")
    check(held("fused"),
          f"fused decode step of {FUSED_BATCH16} rows: logits against the unfused step's, "
          f"relative error {step_rel:.3e} > {FUSED_STEP_REL_TOL}")
    for fault, what in (("neighbour", "the neighbouring row's rstd"),
                        ("stale", "the previous fused call's rstd")):
        check(not held(fault),
              f"fused decode step of {FUSED_BATCH16} rows: a planted fault ({what}) moves the "
              f"logits by only {rel(fault):.3e}, within {FUSED_STEP_REL_TOL}")
    check(len(seen) == 5 * layers, f"fused decode step: {len(seen)} prologues recorded")
    rstd_rel = moved = elements = rows_differ = 0
    for x, w, eps in seen:   # comparison launches, after the counted step
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        r_kernel = gemm.prenorm_rstd(x2, eps)
        r_torch = torch.rsqrt(x2.float().pow(2).mean(-1) + eps)
        rstd_rel = max(rstd_rel, ((r_kernel - r_torch).abs() / r_torch).max().item())
        rows_differ += int((r_kernel != r_torch).sum())
        xf, wf = x2.float(), w.float()
        moved += int(((xf * r_kernel[:, None] * wf).to(x.dtype)
                      != (xf * r_torch[:, None] * wf).to(x.dtype)).sum())
        elements += x2.numel()
    check(rstd_rel <= RSTD_REL_TOL, f"fused decode step: the rstd kernel against torch's, "
                                    f"relative {rstd_rel:.3e} > {RSTD_REL_TOL}")
    same = float((logits["fused"].argmax(-1) == logits["unfused"].argmax(-1)).float().mean())
    print(f"fused norm, one decode step of {FUSED_BATCH16} rows (equal {PROMPT_LEN}-token "
          f"prompts, the same prefill): logits against the unfused step's relative error "
          f"{step_rel:.3e} (tol {FUSED_STEP_REL_TOL}), {100 * same:.1f}% of the argmax tokens "
          f"equal; launches {launched['fused']}; planted faults, unfused in torch: each row "
          f"normalized by its neighbour's rstd, relative error {fault_rel:.3e} (finite "
          f"{bool(torch.isfinite(logits['neighbour']).all())}: "
          f"{'held' if held('neighbour') else 'refused'}); by the previous fused call's rstd, "
          f"{stale_rel:.3e} (finite {bool(torch.isfinite(logits['stale']).all())}: "
          f"{'held' if held('stale') else 'refused'}); the rstd kernel "
          f"on the step's {len(seen)} prologue inputs against torch's: {rows_differ} of "
          f"{len(seen) * FUSED_BATCH16} rows differ, largest relative difference "
          f"{rstd_rel:.3e}, moving the bf16 rounding of {moved} of {elements} x_n elements "
          f"({moved / elements:.2e})", flush=True)
    return dict(rel_err=step_rel, argmax_equal=same, launches=launched["fused"],
                fault_rel_err=fault_rel, stale_rel_err=stale_rel,
                rstd_rel_diff=rstd_rel, rstd_rows_differ=rows_differ,
                xn_rounding_moved=moved, xn_elements=elements)


def phase_fused_cut(torch, np, cut_dir: str) -> dict:
    """The f32 2-layer full-width cut with the switch on, card against CPU: the
    logits of a decode step (1e-3 relative) and the greedy tokens at batch 1 and
    at batch 24 (equal), through the f32 SIMT kernels' prologue on the card (the
    SIMT GEMV at one row, the SIMT tile kernel at 24) and the plain versions on
    the CPU."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.models.arch import KVCache, forward
    from autogptq_tpu_torch.ops import build

    tokens = (np.arange(PROMPT_LEN) * 37 % 32000)[None].astype(np.int32)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(1, 32000, size=n).astype(np.int32)
               for n in rng.integers(4, PROMPT_LEN + 1, size=FUSED_BATCH)]
    res, launches = {}, {}
    arch.FUSE_NORM = "1"
    try:
        for run, device in (("card", "cuda"), ("cpu", "cpu")):
            model = AutoGPTQForCausalLM.from_quantized(cut_dir, device=device,
                                                       dtype=torch.float32)
            clear_counts(build)
            with torch.inference_mode():
                cache = KVCache.create(model.cfg, 1, PROMPT_LEN + 1, dtype=torch.float32,
                                       device=device)
                _, cache = forward(model.params, torch.from_numpy(tokens).long().to(device),
                                   model.cfg, cache=cache)
                dec, _ = forward(model.params, torch.tensor([[1234]], device=device), model.cfg,
                                 cache=cache)
            one = model.generate(tokens, max_new_tokens=FUSED_CUT_TOKENS)
            many = model.generate(prompts, max_new_tokens=FUSED_CUT_TOKENS)
            launches[run] = snapshot(build)
            res[run] = (dec.float().cpu(), one, many)
            del model, cache
    finally:
        arch.FUSE_NORM = "0"
    steps = 1 + 2 * (FUSED_CUT_TOKENS - 1)      # one-token steps: M = 1 and M = 24
    card = launches["card"]
    check(card.get("w4a16_gemm_norm", 0) == 5 * 2 * steps
          and not any(card.get(k, 0) for k in ("w4a16_gemm_gemv_norm", "w4a16_gemm_mma_norm",
                                               "w4a16_gemm_gemv", "w4a16_gemm_mma",
                                               "w4a16_gemm_wgmma")),
          f"fused cut: card launches {card}, want {5 * 2 * steps} w4a16_gemm_norm")
    rel = ((res["card"][0] - res["cpu"][0]).norm() / res["cpu"][0].norm()).item()
    check(bool(torch.isfinite(res["card"][0]).all()) and rel <= E2E_F32_REL_TOL,
          f"fused cut: decode logits card vs CPU relative error {rel:.3e} > {E2E_F32_REL_TOL}")
    check(np.array_equal(res["card"][1], res["cpu"][1]), "fused cut: batch-1 tokens differ "
                                                         "from the CPU's")
    check(np.array_equal(res["card"][2], res["cpu"][2]), f"fused cut: batch-{FUSED_BATCH} "
                                                         "tokens differ from the CPU's")
    print(f"fused norm, f32 2-layer cut, card (the SIMT kernels' prologue) vs CPU (plain): "
          f"decode logits rel err {rel:.3e} (tol {E2E_F32_REL_TOL}); {FUSED_CUT_TOKENS} greedy "
          f"tokens at batch 1 and {FUSED_BATCH} equal; card launches {card}", flush=True)
    return dict(rel_err=rel, launches=launches)


# K1, K4 and K5 are one template (wna16_{decode,prefill}_kernel<BITS, ...>, the tensor-core
# wna16_mma_kernel<BITS, ...> and the wgmma/TMA wna16_wgmma_kernel<BITS, ...>); the profiled
# model is 4-bit. K10 is wna16_t_kernel<BITS, ...>, the tensor-core wna16_t_mma_kernel<BITS,
# ...> and the wgmma/TMA wna16_t_wgmma_kernel<BITS, ...> (no name is a substring of another).
K1_KEYS = ("wna16_decode", "wna16_prefill", "splitk_reduce", "wna16_mma_kernel",
           "wna16_wgmma_kernel", "wna16_gemv_kernel")
K10_KEYS = ("wna16_t_kernel", "wna16_t_mma_kernel", "wna16_t_wgmma_kernel")
KERNEL_INSTANCES = (("K1 tensor-core GEMV", "wna16_gemv_kernel"),
                    ("K1 wgmma tile", "wna16_wgmma_kernel"),
                    ("K10 wgmma", "wna16_t_wgmma_kernel"),
                    ("K1 tensor-core tile", "wna16_mma_kernel"),
                    ("K1 SIMT tile", "wna16_prefill_kernel"),
                    ("K1 GEMV", "wna16_decode_kernel"), ("K1 split-K reduce", "splitk_reduce"),
                    ("K10 tensor-core", "wna16_t_mma_kernel"), ("K10 SIMT", "wna16_t_kernel"))
# K9 is routed_gemv_kernel<T, MT> (the tensor-core GEMV) or routed_{decode,reduce}_kernel<T>.
FAMILIES = (("K1 w4a16_gemm", K1_KEYS),
            ("K9 w4a16_routed_gemm", ("routed_gemv", "routed_decode", "routed_reduce")),
            ("K2 flash_decode", ("flash_decode",)),
            ("K7 paged_attention", ("paged_attention",)), ("K8a kv_write", ("kv_write",)),
            ("K8b copy_pages", ("copy_pages_cluster", "move_pages")))
# K6 is kb32l_gemv_kernel<T, MT> (bf16/f16 at M <= 16), kb32l_decode_kernel<T, MT> with K1's
# splitk_reduce_kernel<T> (the ring) and, above 16 rows, kb32l_wgmma_kernel<T, BM> (or, by
# kernel="mma", wna16_mma_kernel<4, T, Kb32lWords>) or
# wna16_prefill_kernel<4, T, Kb32lWords>: in a model loaded with layout="kb32l" K1 never
# launches (the kb32l path checks it), so K1's names count as K6 there.
KB32L_FAMILIES = (("K6 w4a16_kb32l_gemm", ("kb32l", "Kb32l") + K1_KEYS),
                  ("K2 flash_decode", ("flash_decode",)))


REDUCE_KERNELS = ("splitk_reduce", "routed_reduce")   # the SIMT kernels' split-K reduces


def profile_generate(torch, model, prompt, unprofiled_ms_per_token: float, label: str,
                     tokens: int, families=FAMILIES, graphs: bool = False, **gen_kwargs) -> None:
    """Device time by kernel family over a short generate, from
    torch.profiler's CUDA kernel events: the per-op loop (``JIT_GENERATE``
    off), or with ``graphs`` the decode step replayed from its CUDA graph. The
    profiler slows the host, so the busy share is also given against the
    unprofiled 512-token run's wall time per token (an estimate: that run's
    windows are longer)."""
    from autogptq_tpu_torch.ops import build

    with jit_generate(graphs):
        model.generate(prompt, max_new_tokens=tokens, **gen_kwargs)
        torch.cuda.synchronize()
        clear_counts(build)
        run = profiled(torch, lambda: model.generate(prompt, max_new_tokens=tokens,
                                                     **gen_kwargs))
    wall_us = run["wall_us"]
    sums = dict.fromkeys([name for name, _ in families] + ["other"], 0.0)
    counts = dict.fromkeys(sums, 0)
    kernels = reduces = 0
    for evt in run["kernels"]:
        kernels += 1
        reduces += any(r in evt.name for r in REDUCE_KERNELS)
        us = evt.time_range.elapsed_us()
        family = next((name for name, keys in families if any(k in evt.name for k in keys)),
                      "other")
        sums[family] += us
        counts[family] += 1
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
          f"(device busy about {100 * device_ms / unprofiled_ms_per_token:.1f}%); launches with "
          f"no kernel record: {run['lost_inside']} in the generate, {run['lost_before']} in the "
          f"warm-up", flush=True)
    return dict(device_ms_per_token=device_ms, kernels_per_token=kernels / tokens,
                kernels=kernels, splitk_reduces=reduces, tokens=tokens, family_kernels=counts,
                launches=snapshot(build), lost_inside=run["lost_inside"],
                lost_before=run["lost_before"],
                wall_ms_per_token=wall_us / tokens / 1e3,
                **{f"{k} ms_per_token": v / tokens / 1e3 for k, v in sums.items()})


def compare_routes(torch, model, prompt, unprofiled_ms_per_token: float, label: str,
                   tokens: int, checked=(("K1 w4a16_gemm", "w4a16_gemm"),), families=FAMILIES,
                   **gen_kwargs) -> dict:
    """The profile of a short generate as the model runs it (K1/K4/K5, K6 and
    K9 through their tensor-core GEMVs), then the same generate with every
    quantized matmul forced through the SIMT kernels (``gemm.forced_kernel``:
    K6's ring, the SIMT routed kernel). The new route's profile must hold no
    split-K reduce and, for each (family, launch-count key prefix) of
    ``checked``, at most one of the family's kernels per wrapper call (the
    wrappers' count), and the new route must take less device time per token.
    The totals and the SIMT route's reduces are reported beside: the profiler
    drops records (see PROFILER_WARMUP_LAUNCHES), so they are not held."""
    from autogptq_tpu_torch.ops import gemm

    new = profile_generate(torch, model, prompt, unprofiled_ms_per_token, label, tokens,
                           families=families, **gen_kwargs)
    with gemm.forced_kernel("simt"):
        old = profile_generate(torch, model, prompt, unprofiled_ms_per_token,
                               label + ", SIMT route", tokens, families=families, **gen_kwargs)
    if not new or not old:
        return dict(gemv=new, simt=old)

    def calls(p, prefix):   # wrapper calls of a family in the profiled generate
        return sum(n for key, n in p["launches"].items() if key.startswith(prefix))

    for family, prefix in checked:
        check(new["splitk_reduces"] == 0
              and 0 < new["family_kernels"][family] <= calls(new, prefix),
              f"{label}: {new['family_kernels'][family]} {family} kernels and "
              f"{new['splitk_reduces']} reduces for {calls(new, prefix)} calls "
              f"({new['launches']})")
    folded = old["kernels"] - old["splitk_reduces"] - new["kernels"]
    check(new["device_ms_per_token"] < old["device_ms_per_token"],
          f"{label}: device {new['device_ms_per_token']:.3f} ms/token, SIMT route "
          f"{old['device_ms_per_token']:.3f}")
    print(f"{label}: {new['kernels_per_token']:.1f} kernels/token, {new['kernels']} in all "
          f"({old['kernels_per_token']:.1f} through the SIMT route, {old['kernels']} in all, of "
          f"which {old['splitk_reduces']} split-K reduces; difference {folded} after the "
          f"reduces; " + "; ".join(
              f"{family}: {calls(new, prefix)} calls, {new['family_kernels'][family]} kernels; "
              f"SIMT route {calls(old, prefix)} calls, {old['family_kernels'][family]} kernels"
              for family, prefix in checked) + "), device "
          f"{new['device_ms_per_token']:.3f} ms/token (SIMT route "
          f"{old['device_ms_per_token']:.3f})", flush=True)
    return dict(gemv=new, simt=old)


def graph_turns(torch, np, model, label: str, prompt, graph: dict, eager_profile: dict,
                profile_tokens: int, families=FAMILIES, **gen_kwargs) -> dict:
    """The reported run ``graph`` (``out``, ``s``, ``tokens``, ``counts``: a
    generate whose decode step ran from its CUDA graph) beside a turn with
    ``JIT_GENERATE`` off (the per-op loop) of at most ``GRAPH_EAGER_TOKENS``
    tokens, counts set to 0 just before each. The tokens must be identical:
    greedy, the graph run's first ones; beam search, whose result depends on
    the length, a graph run of the eager turn's length. The graph run must
    have captured once and replayed every step after the warm-up. Each turn's
    rate, host ms per token (prefill included, and per decode token: a
    1-token generate, the prefill alone, taken off) and device busy share; the
    graph run's capture and warm-up seconds and its replayed launches. The
    busy share of the graph run comes from a profiled replay window where
    its kernel records are at least the eager profile's (``eager_profile``,
    the same generate through the per-op loop), else from the eager profile's
    device ms, and the line says which."""
    from autogptq_tpu_torch.ops import build

    tokens, beams = graph["tokens"], gen_kwargs.get("num_beams", 1)
    n = min(tokens, GRAPH_EAGER_TOKENS)
    with jit_generate(False):
        t0 = time.perf_counter()
        model.generate(prompt, max_new_tokens=1, **gen_kwargs)
        prefill_s = time.perf_counter() - t0
        clear_counts(build)
        t0 = time.perf_counter()
        eager = model.generate(prompt, max_new_tokens=n, **gen_kwargs)
        eager_s = time.perf_counter() - t0
        eager_counts = snapshot(build)
    same = graph["out"][:, :prompt.shape[1] + n]
    if beams > 1 and n < tokens:
        with jit_generate(True):
            same = model.generate(prompt, max_new_tokens=n, **gen_kwargs)
    check(np.array_equal(same, eager), f"{label}: the CUDA graph's tokens differ from the "
                                       f"per-op loop's over {n} tokens")
    counts = graph["counts"]
    check(counts.graphs.get("captures") == 1 and counts.graphs.get("replays") == tokens - 2
          and not eager_counts.graphs and not eager_counts.replayed,
          f"{label}: graphs {counts.graphs} over {tokens} tokens, eager turn {eager_counts.graphs}")
    ms, eager_ms = 1e3 * graph["s"] / tokens, 1e3 * eager_s / n
    step_ms = 1e3 * (graph["s"] - prefill_s) / (tokens - 1)
    eager_step_ms = 1e3 * (eager_s - prefill_s) / (n - 1)
    replayed, launched = sum(counts.replayed.values()), sum(counts.values())
    replay_profile = profile_generate(torch, model, prompt, ms, label + ", CUDA graph",
                                      profile_tokens, families=families, graphs=True,
                                      **gen_kwargs)
    device_ms = (eager_profile or {}).get("device_ms_per_token", float("nan"))
    if replay_profile and replay_profile["kernels"] >= (eager_profile or {}).get("kernels", 0):
        busy_from, graph_device_ms = "the profiled replay window", replay_profile[
            "device_ms_per_token"]
    else:
        busy_from, graph_device_ms = "the per-op loop's profiled device ms", device_ms
    busy, eager_busy = graph_device_ms / ms, device_ms / eager_ms
    unit = "beam-tok/s" if beams > 1 else "tok/s"
    print(f"{label}, CUDA graph against the per-op loop: graph {beams * tokens / graph['s']:.2f} "
          f"{unit} over {tokens} tokens ({ms:.3f} host ms per token, prefill included, "
          f"{step_ms:.3f} per decode step with the 1-token generate's {prefill_s:.3f} s taken "
          f"off; capture "
          f"{counts.graphs.get('capture_s', 0.0):.3f} s, warm-up step "
          f"{counts.graphs.get('warmup_s', 0.0):.3f} s; {replayed} of {launched} counted "
          f"launches replayed; device busy about {100 * busy:.1f}%, device "
          f"{graph_device_ms:.3f} ms per token from {busy_from}); per-op loop (JIT_GENERATE "
          f"off) {beams * n / eager_s:.2f} {unit} over {n} tokens ({eager_ms:.3f} host ms per "
          f"token, {eager_step_ms:.3f} per decode step; device busy about "
          f"{100 * eager_busy:.1f}% from its profile's "
          f"{device_ms:.3f} ms per token); tokens identical over {n}", flush=True)
    return dict(tokens=tokens, rate=beams * tokens / graph["s"], host_ms_per_token=ms,
                prefill_s=prefill_s, step_ms=step_ms, eager_step_ms=eager_step_ms,
                capture_s=counts.graphs.get("capture_s", 0.0),
                warmup_s=counts.graphs.get("warmup_s", 0.0), replayed=replayed,
                launches=launched, busy=busy, busy_from=busy_from,
                device_ms_per_token=graph_device_ms, replay_profile=replay_profile,
                eager_tokens=n, eager_rate=beams * n / eager_s, eager_host_ms_per_token=eager_ms,
                eager_busy=eager_busy, eager_counts=eager_counts)


def phase_cpu_vs_card(torch, np, ckpt_dir: str) -> dict:
    """A 2-layer full-width cut: prefill, one decode step and one paged
    beam-4 step on the card in bf16 (K1 through the tensor-core GEMV and tile
    kernel) and in f32 (the SIMT GEMV and tile kernel, no GEMV launch)
    against the plain versions in f32 on the CPU."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models.arch import KVCache, forward
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.ops.paged_attn import check_page_errors
    from autogptq_tpu_torch.utils.generation import beam_paged_prefill, paged_decode_step
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B, write_random_checkpoint

    cfg = dict(LLAMA2_7B, num_hidden_layers=2)
    write_random_checkpoint(ckpt_dir, cfg, bits=4, group_size=128, seed=0)
    tokens = torch.from_numpy((np.arange(PROMPT_LEN) * 37 % 32000)[None].astype(np.int64))
    nxt = torch.tensor([[1234]])
    results, launches = {}, {}
    runs = (("card bf16", "cuda", torch.bfloat16), ("card f32", "cuda", torch.float32),
            ("cpu", "cpu", torch.float32))
    for run, device, dtype in runs:
        model = AutoGPTQForCausalLM.from_quantized(ckpt_dir, device=device, dtype=dtype)
        clear_counts(build)
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
        launches[run] = snapshot(build)
        results[run] = (pre.float().cpu(), dec.float().cpu(), step.float().cpu())
        del model, cache, pcache
    # 2 layers x 7 projections in four forwards of at most 16 rows (the 16-token prefill,
    # a decode step, the beam prefill, a 4-row beam step): the GEMV in bf16, the SIMT GEMV in f32
    check(launches["card bf16"].get("w4a16_gemm_gemv", 0) == 4 * 14
          and not launches["card bf16"].get("w4a16_gemm", 0)
          and launches["card f32"].get("w4a16_gemm", 0) == 4 * 14
          and not launches["card f32"].get("w4a16_gemm_gemv", 0),
          f"card vs CPU: K1 launches {launches}")
    rows = {}
    for run, tol in (("card bf16", E2E_REL_TOL), ("card f32", E2E_F32_REL_TOL)):
        for i, name in enumerate(("prefill", "decode", "paged beam-4 step")):
            card, cpu = results[run][i], results["cpu"][i]
            check(bool(torch.isfinite(card).all()), f"{run} {name} logits are not finite")
            rel = ((card - cpu).norm() / cpu.norm()).item()
            rows[f"{run} {name}"] = dict(rel_err=rel, max_abs_err=(card - cpu).abs().max().item(),
                                         max_abs_ref=cpu.abs().max().item(), tol=tol)
            check(rel <= tol, f"{run} {name} logits: card vs CPU relative error {rel:.3e} > {tol}")
    print("card (bf16: tensor-core GEMV; f32: SIMT GEMV) vs CPU (f32, plain), 2 full-width "
          "layers: " + ", ".join(f"{k} rel err {v['rel_err']:.3e} (tol {v['tol']}) max abs "
                                 f"{v['max_abs_err']:.3e}" for k, v in rows.items())
          + f"; launches {launches['card bf16']} / {launches['card f32']}", flush=True)
    return dict(rows=rows, launches=launches)


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
    with python_calls() as calls:
        clear_counts(build)
        t0 = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=new_tokens)
        gen_s = time.perf_counter() - t0
        counts = snapshot(build)
    peak = torch.cuda.max_memory_allocated()
    check_fused_writes(counts, calls, layers, new_tokens - 1, "Mixtral greedy", pools=0)
    t0 = time.perf_counter()
    again = model.generate(prompt, max_new_tokens=MIXTRAL_REPEAT_TOKENS)
    again_s = time.perf_counter() - t0
    steps = new_tokens - 1
    # prefill: 16 tokens x top-2 = 32 pairs > 8 experts, the dense path (24 K1 per layer);
    # every decode step: 2 pairs, routed, 3 of K9's tensor-core GEMV per layer and no SIMT
    # routed kernel (so no routed reduce); attention's 4 projections on K1
    want = {"w4a16_routed_gemm_gemv": 3 * layers * steps, "w4a16_routed_gemm": 0,
            "flash_decode": layers * steps,
            "w4a16_gemm_gemv": (4 + 24) * layers + 4 * layers * steps, "w4a16_gemm": 0}
    new = out[:, PROMPT_LEN:]
    check(out.shape == (1, PROMPT_LEN + new_tokens), f"Mixtral output shape {out.shape}")
    check(bool(((new >= 0) & (new < cfg["vocab_size"])).all()), "Mixtral token ids out of range")
    check(np.array_equal(out[:, :PROMPT_LEN + MIXTRAL_REPEAT_TOKENS], again),
          "Mixtral greedy decode does not repeat its tokens")
    check(np.array_equal(out[:, :PROMPT_LEN + 4], warm), "Mixtral greedy decode is not "
                                                         "deterministic")
    for name, n in want.items():
        check(counts.get(name, 0) == n, f"Mixtral greedy: {name} launched "
                                        f"{counts.get(name, 0)} times, want {n}")
    tok_s = new_tokens / gen_s
    print(f"Mixtral-8x7B 4-bit g128, {layers} layers, 8 experts top-2, batch 1, {PROMPT_LEN}-token "
          f"prompt, {new_tokens} new tokens greedy (repeated over {MIXTRAL_REPEAT_TOKENS}, equal "
          f"tokens): checkpoint written "
          f"in {write_s:.1f} s, from_quantized + stack_moe_experts {load_s:.1f} s (peak "
          f"{load_peak / 2**30:.2f} GiB, resident {resident / 2**30:.2f} GiB), generate "
          f"{gen_s:.3f} s = {tok_s:.2f} tok/s (repeat of {MIXTRAL_REPEAT_TOKENS}: {again_s:.3f} "
          f"s), peak device memory {peak / 2**30:.2f} GiB; launches per decode token: K9's GEMV "
          f"{counts.get('w4a16_routed_gemm_gemv', 0) / steps:.0f}, K2 "
          f"{counts.get('flash_decode', 0) / steps:.0f}, "
          f"K1 {4 * layers}; launches {counts}", flush=True)
    profile = compare_routes(torch, model, prompt, 1e3 * gen_s / new_tokens,
                             "Mixtral batch-1 generate", MIXTRAL_PROFILE_TOKENS,
                             checked=(("K1 w4a16_gemm", "w4a16_gemm"),
                                      ("K9 w4a16_routed_gemm", "w4a16_routed_gemm")))
    graph = graph_turns(torch, np, model, "Mixtral batch-1 greedy", prompt,
                        dict(out=out, s=gen_s, tokens=new_tokens, counts=counts),
                        profile.get("gemv"), MIXTRAL_PROFILE_TOKENS)

    with python_calls() as calls_b:
        clear_counts(build)
        t0 = time.perf_counter()
        outb = model.generate(prompt, max_new_tokens=MIXTRAL_BEAM_TOKENS, num_beams=BEAMS)
        beam_s = time.perf_counter() - t0
        beam_counts = snapshot(build)
    bsteps = MIXTRAL_BEAM_TOKENS - 1
    need = {"w4a16_routed_gemm_gemv": 3 * layers * bsteps, "paged_attention_mh": layers * bsteps}
    check_fused_writes(beam_counts, calls_b, layers, bsteps, f"Mixtral beam {BEAMS}")
    check(outb.shape == (1, PROMPT_LEN + MIXTRAL_BEAM_TOKENS), f"Mixtral beam shape {outb.shape}")
    check(bool(((outb[:, PROMPT_LEN:] >= 0) & (outb[:, PROMPT_LEN:] < cfg["vocab_size"])).all()),
          "Mixtral beam token ids out of range")
    for name, n in need.items():
        check(beam_counts.get(name, 0) >= n, f"Mixtral beam: {name} launched "
                                             f"{beam_counts.get(name, 0)} times, need >= {n}")
    check(not beam_counts.get("w4a16_routed_gemm", 0), f"Mixtral beam launched the SIMT routed "
                                                       f"kernel: {beam_counts}")
    print(f"Mixtral beam {BEAMS} (8 pairs per step, K9's GEMV at P = 8), paged bf16 cache, "
          f"{MIXTRAL_BEAM_TOKENS} new tokens: {beam_s:.3f} s = "
          f"{MIXTRAL_BEAM_TOKENS / beam_s:.2f} seq-tok/s, launches {beam_counts}", flush=True)

    # the int8 beam takes the contiguous cache, as the JAX package routes a MoE model
    # (generation._beam_paged_ok): RoPE by apply_rope and the quantized write at the host cursor
    # in every step, no K8a, K7 or K8b, and no K2 (the int8 cache takes the einsum); the 16-row
    # prefill on the dense path, every decode step's 8 pairs on K9's GEMV
    with python_calls() as calls_q:
        clear_counts(build)
        t0 = time.perf_counter()
        outq = model.generate(prompt, max_new_tokens=MIXTRAL_INT8_BEAM_TOKENS, num_beams=BEAMS,
                              kv_quant=True)
        int8_s = time.perf_counter() - t0
        int8_counts = snapshot(build)
    qsteps = MIXTRAL_INT8_BEAM_TOKENS - 1
    want = {"w4a16_routed_gemm_gemv": 3 * layers * qsteps, "w4a16_routed_gemm": 0,
            "w4a16_gemm_gemv": (4 + 24) * layers + 4 * layers * qsteps, "w4a16_gemm": 0,
            "flash_decode": 0, "rope_write_kv": 0, "paged_attention_mh": 0, "copy_pages_pair": 0,
            "copy_pages_pair_gather": 0}
    got = {name: int8_counts.get(name, 0) for name in want}
    check(got == want and not int8_counts.graphs
          and calls_q["apply_rope"] == layers * MIXTRAL_INT8_BEAM_TOKENS,
          f"Mixtral int8 beam: launches {got}, want {want}, no graph ({int8_counts.graphs}), "
          f"{layers * MIXTRAL_INT8_BEAM_TOKENS} apply_rope calls ({dict(calls_q)})")
    newq = outq[:, PROMPT_LEN:]
    check(outq.shape == (1, PROMPT_LEN + MIXTRAL_INT8_BEAM_TOKENS)
          and bool(((newq >= 0) & (newq < cfg["vocab_size"])).all()),
          f"Mixtral int8 beam: output {outq.shape} or token ids out of range")
    print(f"Mixtral beam {BEAMS} over the contiguous int8 cache (kv_quant=True, the JAX "
          f"package's route for MoE): {MIXTRAL_INT8_BEAM_TOKENS} new tokens, {int8_s:.3f} s = "
          f"{MIXTRAL_INT8_BEAM_TOKENS / int8_s:.2f} seq-tok/s; per decode step "
          f"{int8_counts.get('w4a16_routed_gemm_gemv', 0) / qsteps:.0f} K9 GEMVs; launches "
          f"{int8_counts}", flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(layers=layers, write_s=write_s, load_s=load_s, load_peak_bytes=load_peak,
                resident_bytes=resident, gen_s=gen_s, repeat_s=again_s, tok_s=tok_s,
                peak_bytes=peak, counts=counts, tokens=new[0].tolist(), profile=profile,
                graph=graph,
                beam_s=beam_s, beam_counts=beam_counts, int8_beam_s=int8_s,
                int8_beam_counts=int8_counts, int8_beam_tokens=MIXTRAL_INT8_BEAM_TOKENS)


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
    results, routes, moe, dxs, beams = {}, {}, {}, {}, {}
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
                clear_counts(build)
                dec, _ = arch.forward(model.params, nxt.to(device), model.cfg, cache=cache)
                if device == "cuda":   # f32: the SIMT routed kernel; bf16: the routed GEMV
                    torch.cuda.synchronize()
                    key, other = "w4a16_routed_gemm", "w4a16_routed_gemm_gemv"
                    if dtype == torch.bfloat16:
                        key, other = other, key
                    check(build.launches[key] == 3 * 2 and not build.launches[other],
                          f"{run}: the decode step launched {snapshot(build)}")
        finally:
            arch.top_k = real_top_k
        results[run] = (pre.float().cpu(), dec.float().cpu())
        routes[run] = torch.cat(chosen)
        del cache
        if dtype == torch.float32:
            beams[run] = int8_beam(torch, arch, build, model, tokens.numpy().astype(np.int32))
        del model
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
    (card_toks, card_steps, card_counts), (cpu_toks, cpu_steps, _) = beams["card f32"], \
        beams["cpu"]
    beam_rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(card_steps, cpu_steps))
    check(np.array_equal(card_toks, cpu_toks) and len(card_steps) == len(cpu_steps),
          f"Mixtral int8 beam {BEAMS} on the 2-layer cut: card f32 tokens {card_toks.tolist()} "
          f"against the CPU's {cpu_toks.tolist()}")
    check(beam_rel <= MIXTRAL_E2E_F32_REL_TOL, f"Mixtral int8 beam {BEAMS} on the 2-layer cut: "
                                               f"a step's logits card f32 vs CPU relative error "
                                               f"{beam_rel:.3e} > {MIXTRAL_E2E_F32_REL_TOL}")
    print(f"Mixtral int8 beam {BEAMS} (kv_quant=True, the contiguous route), 2 full-width layers, "
          f"{MIXTRAL_CUT_BEAM_TOKENS} new tokens, card f32 (K9's SIMT routed kernel, launches "
          f"{card_counts}) against the CPU f32: tokens equal, the {len(cpu_steps)} forwards' "
          f"last-position logits {beam_rel:.3e} relative apart at most (tol "
          f"{MIXTRAL_E2E_F32_REL_TOL})", flush=True)
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
                moe_mlp=moe, routed_grad=dict(rel_err=grad_rel, launches=dxs["card f32"][1]),
                int8_beam=dict(tokens=MIXTRAL_CUT_BEAM_TOKENS, max_rel=beam_rel,
                               forwards=len(cpu_steps), launches=card_counts))


def int8_beam(torch, arch, build, model, prompt) -> tuple:
    """``generate(num_beams=BEAMS, kv_quant=True)`` over MIXTRAL_CUT_BEAM_TOKENS
    on the model's device, each ``arch.forward``'s last-position logits
    recorded: (tokens, the logits on the host, launches); on the card the
    routed decode must launch K9 and none of K8a, K7, K8b or K2."""
    steps, real = [], arch.forward

    def recorded(*args, **kw):
        logits, cache = real(*args, **kw)
        steps.append(logits[:, -1].float().cpu())
        return logits, cache

    arch.forward = recorded
    try:
        clear_counts(build)
        out = model.generate(prompt, max_new_tokens=MIXTRAL_CUT_BEAM_TOKENS, num_beams=BEAMS,
                             kv_quant=True)
        counts = snapshot(build)
    finally:
        arch.forward = real
    if model.device.type == "cuda":
        check(counts.get("w4a16_routed_gemm", 0) == 3 * 2 * (MIXTRAL_CUT_BEAM_TOKENS - 1)
              and not any(counts.get(key, 0) for key in ("rope_write_kv", "paged_attention_mh",
                                                        "copy_pages_pair", "flash_decode")),
              f"Mixtral int8 beam on the 2-layer cut: launches {counts}")
    return out, steps, counts


def routed_grad(torch, arch, build, model, x, cot) -> tuple:
    """dx of sum(moe_mlp(x) * cot) through layer 0's stacked experts on the
    model's device; on the card the routed route must launch K9 (3) and K10."""
    from autogptq_tpu_torch.ops import gemm

    dev = model.device
    xt = torch.from_numpy(x).to(dev).requires_grad_()
    clear_counts(build)
    y = arch.moe_mlp(model.params["layers"][0]["mlp"], xt, model.cfg)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(cot).to(dev)).sum(), xt)
    counts = snapshot(build)
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
            clear_counts(build)
            got = arch.moe_mlp(stacked, x, model.cfg)
            counts = snapshot(build)
            want = arch.moe_mlp(bp, x, model.cfg)
        torch.cuda.synchronize()
        routed = what.startswith("routed")
        check(counts.get("w4a16_routed_gemm", 0) == (3 if routed else 0)
              and counts.get("w4a16_gemm", 0) == (0 if routed else 24)
              and not counts.get("w4a16_gemm_gemv", 0), f"moe_mlp {what}: launched {counts}")
        err = (got - want).abs().max().item()
        check(err <= MOE_F32_ABS_TOL, f"moe_mlp {what}: max |stacked - list| = {err:.3e} > "
                                      f"{MOE_F32_ABS_TOL}")
        out[what] = dict(max_abs_err=err, max_abs_ref=want.abs().max().item(), launches=counts)
    print("one layer's moe_mlp on the card, f32, against the expert list (K1): "
          + ", ".join(f"{k} (launches {v['launches']}) max abs err {v['max_abs_err']:.3e}"
                      for k, v in out.items()) + f" (tol {MOE_F32_ABS_TOL})", flush=True)
    return out


def phase_int8_greedy(torch, np, model, main_out) -> dict:
    """The main path's model over the contiguous int8 KV cache
    (``kv_quant=True``): batch 1, the 16-token prompt, 64 new tokens greedy,
    the decode step replayed from its CUDA graph. Per decode token exactly 224
    K1 GEMVs and one fused RoPE + int8 K/V write per layer (K8a's contiguous
    int8 mode), and no K2: the int8 cache takes the einsum over the cache, as
    the JAX package's does. Its tokens against the per-op loop's
    (``graph_turns``), and how many agree with the bf16 cache's run."""
    from autogptq_tpu_torch.ops import build

    layers = model.cfg.num_layers
    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    model.generate(prompt, max_new_tokens=4, kv_quant=True)
    with python_calls() as calls:
        clear_counts(build)
        t0 = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=INT8_NEW_TOKENS, kv_quant=True)
        gen_s = time.perf_counter() - t0
        counts = snapshot(build)
    steps = INT8_NEW_TOKENS - 1
    check_fused_writes(counts, calls, layers, steps, "int8 greedy", pools=0)
    check(counts.get("w4a16_gemm_gemv", 0) == 7 * layers * INT8_NEW_TOKENS
          and not counts.get("w4a16_gemm", 0) and not counts.get("flash_decode", 0),
          f"int8 greedy: launches {counts}, want {7 * layers * INT8_NEW_TOKENS} w4a16_gemm_gemv "
          f"(224 per token), no SIMT GEMV and no flash_decode")
    new = out[:, PROMPT_LEN:]
    check(out.shape == (1, PROMPT_LEN + INT8_NEW_TOKENS), f"int8 greedy output shape {out.shape}")
    check(bool(((new >= 0) & (new < model.cfg.vocab_size)).all()), "int8 greedy token ids "
                                                                    "out of range")
    agree = int((new[0] == main_out[0, PROMPT_LEN:PROMPT_LEN + INT8_NEW_TOKENS]).sum())
    lead = int(np.argmin(np.append(new[0] == main_out[0, PROMPT_LEN:PROMPT_LEN + INT8_NEW_TOKENS],
                                   False)))
    tok_s = INT8_NEW_TOKENS / gen_s
    print(f"int8 greedy: Llama-2-7B 4-bit g128, {layers} layers, batch 1, {PROMPT_LEN}-token "
          f"prompt, {INT8_NEW_TOKENS} new tokens over the contiguous int8 KV cache "
          f"(kv_quantize's scheme): generate {gen_s:.3f} s = {tok_s:.2f} tok/s; per decode token "
          f"{counts.get('w4a16_gemm_gemv', 0) / INT8_NEW_TOKENS:.0f} K1 GEMVs, "
          f"{counts.get('rope_write_kv', 0) / steps:.0f} rope_write_kv, 0 flash_decode; "
          f"{agree} of {INT8_NEW_TOKENS} tokens equal to the bf16 cache's run (the first {lead} "
          f"in a row); launches {counts}", flush=True)
    eager_profile = profile_generate(torch, model, prompt, 1e3 * gen_s / INT8_NEW_TOKENS,
                                     "int8 greedy", PROFILE_TOKENS, kv_quant=True)
    graph = graph_turns(torch, np, model, "int8 greedy", prompt,
                        dict(out=out, s=gen_s, tokens=INT8_NEW_TOKENS, counts=counts),
                        eager_profile, PROFILE_TOKENS, kv_quant=True)
    return dict(tokens=INT8_NEW_TOKENS, gen_s=gen_s, tok_s=tok_s, counts=counts,
                agree_with_bf16=agree, leading_agree=lead, profile=eager_profile, graph=graph)


def serving_trace(np, vocab: int, seed: int, n: int, new=SERVE_NEW):
    """The serving trace: ``n`` requests drawn from ``seed``. Every third
    request (up to ``SERVE_SHARING``) is a shared ``SERVE_PREFIX``-token prefix
    and a suffix of its own, up to ``SERVE_PROMPT[1]`` tokens in all; every
    sixth from the second (up to ``SERVE_SAMPLED``) is sampled
    (``SERVE_SAMPLING``, a seed of its own) from a ``SERVE_PROMPT[0]``-token
    prompt, which no prefix-cache lookup can hit (a lookup stops a token short
    of the prompt), so its prefill is the same whatever ran before; the rest
    are greedy with prompts of ``SERVE_PROMPT`` tokens; ``max_new_tokens`` is
    drawn from ``new``. No EOS: the schedule does not depend on the tokens."""
    from autogptq_tpu_torch.serving import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, SERVE_PREFIX).astype(np.int32)
    lo, hi = SERVE_PROMPT
    reqs, shared, sampled = [], 0, 0
    for i in range(n):
        max_new = int(rng.integers(new[0], new[1] + 1))
        if i % 3 == 0 and shared < SERVE_SHARING:
            shared += 1
            tail = rng.integers(1, vocab, int(rng.integers(8, hi - SERVE_PREFIX + 1)))
            reqs.append(Request(i, np.concatenate([prefix, tail.astype(np.int32)]), max_new))
        elif i % 6 == 1 and sampled < SERVE_SAMPLED:
            sampled += 1
            reqs.append(Request(i, rng.integers(1, vocab, lo).astype(np.int32), max_new,
                                seed=1000 + i, **SERVE_SAMPLING))
        else:
            reqs.append(Request(i, rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
                                .astype(np.int32), max_new))
    return reqs


def serving_engine(model, **kw):
    from autogptq_tpu_torch.serving_paged import PagedContinuousBatchEngine

    kw = dict(dict(max_slots=SERVE_SLOTS, total_pages=SERVE_TOTAL_PAGES, page_size=SERVE_PAGE,
                   pages_per_seq=SERVE_PAGES_PER_SEQ, enable_prefix_cache=True), **kw)
    return PagedContinuousBatchEngine(model, **kw)


def served(torch, build, engine, reqs, warm: bool) -> tuple:
    """``engine.run(reqs)`` with the counts set to 0 just before and read
    just after (after ``warmup()`` when ``warm``): (outputs, counts,
    seconds)."""
    if warm:
        engine.warmup()
    torch.cuda.synchronize()
    clear_counts(build)
    t0 = time.perf_counter()
    out = engine.run(list(reqs))
    seconds = time.perf_counter() - t0
    return out, snapshot(build), seconds


def check_engine_launches(counts, steps: int, layers: int, label: str) -> None:
    """Every decode step of a warmed engine replayed from its graph with
    exactly 224 K1 GEMVs (7 per layer at M = max_slots), one fused RoPE + K/V
    write (K8a through the tables) and one K7 per layer, and nothing
    captured; no other path launches these three (every prefill has at least
    32 rows: the wgmma tile kernel)."""
    want = {"w4a16_gemm_gemv": 7 * layers * steps, "rope_write_kv": layers * steps,
            "paged_attention_mh": layers * steps}
    got = {k: counts.get(k, 0) for k in want}
    rep = {k: counts.replayed.get(k, 0) for k in want}
    check(got == want == rep and not counts.get("w4a16_gemm", 0)
          and not counts.graphs.get("captures", 0),
          f"{label}: launches {got}, replayed {rep}, want {want} for {steps} steps, all replayed, "
          f"no SIMT GEMV and no capture after warmup(); graphs {counts.graphs}")


def phase_serving(torch, np, model) -> dict:
    """The paged continuous-batching engine (``serving_paged.py``) on the main
    path's model, 32 layers at full width, bf16: the trace of
    ``serving_trace`` (24 requests) with the prefix cache on, through the
    decode step's CUDA graphs after ``warmup()``, then again through the
    per-op loop (``JIT_GENERATE`` off), the streams identical; each sampled
    request again alone on a fresh engine, its stream identical; exact launch
    counts per replayed step; preemptions and prefix hits; a profiled window
    of engine steps for host against device ms per step. Then a shorter trace
    with ``decode_block = 4``, graph against per-op loop likewise."""
    from autogptq_tpu_torch.ops import build

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    reqs = serving_trace(np, vocab, SERVE_SEED, SERVE_REQUESTS)
    engine = serving_engine(model)
    captures = build.graphs.get("captures", 0)
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    captures = build.graphs.get("captures", 0) - captures
    out, counts, run_s = served(torch, build, engine, reqs, warm=False)
    st = engine.stats
    check_engine_launches(counts, st.steps, layers, "paged serving")
    check(set(out) == {r.req_id for r in reqs} and all(
        len(out[r.req_id]) == r.max_new_tokens and ((out[r.req_id] >= 0)
                                                     & (out[r.req_id] < vocab)).all()
        for r in reqs), "paged serving: an output of the wrong length or out of range")
    check(st.preemptions >= 1 and st.prefix_hit_tokens > 0,
          f"paged serving: preemptions {st.preemptions}, prefix hit tokens "
          f"{st.prefix_hit_tokens}; want at least one of each")
    check(engine.pages_in_use() == engine.pages_cached(), "paged serving: pages left in use")
    snap = st.snapshot()
    host_ms = 1e3 * st.step_time_s / st.steps
    print(f"paged serving: Llama-2-7B 4-bit g128, {layers} layers, bf16, {SERVE_SLOTS} slots, "
          f"page {SERVE_PAGE}, {SERVE_PAGES_PER_SEQ} pages per sequence, {SERVE_TOTAL_PAGES} "
          f"pages, prefix cache on; {len(reqs)} requests (prompts {SERVE_PROMPT[0]}-"
          f"{SERVE_PROMPT[1]} tokens, {SERVE_SHARING} sharing a {SERVE_PREFIX}-token prefix, "
          f"{SERVE_SAMPLED} sampled, max_new_tokens {SERVE_NEW[0]}-{SERVE_NEW[1]}): warmup "
          f"{warm_s:.1f} s ({captures} captures), run {run_s:.3f} s, "
          f"decode {snap['decode_tok_s']} tok/s, {host_ms:.3f} host ms per engine step; "
          f"pages high water {st.pages_high_water}; stats {snap}; per replayed step "
          f"{counts.get('w4a16_gemm_gemv', 0) / st.steps:.0f} K1 GEMVs at M = {SERVE_SLOTS}, "
          f"{counts.get('rope_write_kv', 0) / st.steps:.0f} rope_write_kv, "
          f"{counts.get('paged_attention_mh', 0) / st.steps:.0f} paged_attention_mh; "
          f"launches {counts}", flush=True)

    with jit_generate(False):
        eager_engine = serving_engine(model)
        t0 = time.perf_counter()
        eager = eager_engine.run(list(reqs))
        eager_s = time.perf_counter() - t0
    check(all(np.array_equal(eager[r], out[r]) for r in out),
          "paged serving: the per-op loop's streams differ from the CUDA graphs': requests "
          + str([r for r in out if not np.array_equal(eager[r], out[r])]))
    check(dataclasses.asdict(eager_engine.stats) | {"step_time_s": 0}
          == dataclasses.asdict(st) | {"step_time_s": 0}, "paged serving: the per-op loop's "
          "stats differ from the graphs'")
    eager_host_ms = 1e3 * eager_engine.stats.step_time_s / eager_engine.stats.steps
    del eager_engine
    alone_engine = serving_engine(model)
    sampled = [r for r in reqs if r.temperature > 0]
    for r in sampled:
        alone = alone_engine.run([r])
        check(np.array_equal(alone[r.req_id], out[r.req_id]),
              f"paged serving: sampled request {r.req_id} alone gives another stream")
    del alone_engine
    print(f"paged serving, per-op loop (JIT_GENERATE off): the same {len(reqs)} streams and "
          f"stats, {eager_s:.3f} s, {eager_host_ms:.3f} host ms per engine step (graphs "
          f"{host_ms:.3f}); each of the {len(sampled)} sampled requests alone on a fresh engine: "
          f"the same stream", flush=True)

    # a window of steps with every slot decoding and none admitted or retired, run twice on the
    # same engine and the same requests (greedy, no prefix cache: the same work and streams):
    # timed without the profiler for host ms per step, then profiled for device ms per step
    window = serving_engine(model, total_pages=SERVE_SLOTS * 8 + 1, enable_prefix_cache=False)
    window.warmup(sampling=False)
    rng = np.random.default_rng(SERVE_SEED + 1)
    prompts = [rng.integers(1, vocab, 64).astype(np.int32) for _ in range(SERVE_SLOTS)]
    from autogptq_tpu_torch.serving import Request

    def wave(first_id, steps):
        for i, p in enumerate(prompts):
            window.submit(Request(first_id + i, p, 64))
        window.step()                  # admits and prefills every request
        measured = steps()
        streams = window.run([])       # to the end of every request
        return measured, [streams[first_id + i] for i in range(SERVE_SLOTS)]

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE_STEPS):
            window.step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / SERVE_PROFILE_STEPS

    host_ms_window, first = wave(0, timed)
    run, second = wave(SERVE_SLOTS, lambda: profiled(
        torch, lambda: [window.step() for _ in range(SERVE_PROFILE_STEPS)]))
    check(all(np.array_equal(a, b) for a, b in zip(first, second)),
          "paged serving window: the same requests gave other streams the second time")
    device_ms = sum(k.time_range.elapsed_us() for k in run["kernels"]) / 1e3 / SERVE_PROFILE_STEPS
    wall_ms = run["wall_us"] / 1e3 / SERVE_PROFILE_STEPS
    print(f"paged serving, a window of {SERVE_PROFILE_STEPS} engine steps (8 slots decoding, "
          f"no admission, 64-token prompts), run twice on the same "
          f"requests with the same streams: host {host_ms_window:.3f} ms per step unprofiled, "
          f"device {device_ms:.3f} ms per step in {len(run['kernels'])} kernels profiled (busy "
          f"{100 * device_ms / host_ms_window:.1f}%, idle {host_ms_window - device_ms:.3f} ms per "
          f"step); host {wall_ms:.3f} ms per step under the profiler; launches with no kernel "
          f"record: {run['lost_inside']} inside, {run['lost_before']} before", flush=True)
    del window

    block_reqs = serving_trace(np, vocab, SERVE_SEED + 2, SERVE_BLOCK_REQUESTS,
                               new=SERVE_BLOCK_NEW)
    block_engine = serving_engine(model, decode_block=SERVE_BLOCK)
    block_out, block_counts, block_s = served(torch, build, block_engine, block_reqs, warm=True)
    bst = block_engine.stats
    check_engine_launches(block_counts, bst.steps, layers, f"paged serving, decode_block "
                                                          f"{SERVE_BLOCK}")
    with jit_generate(False):
        block_eager = serving_engine(model, decode_block=SERVE_BLOCK).run(list(block_reqs))
    check(all(np.array_equal(block_eager[r], block_out[r]) for r in block_out),
          f"paged serving, decode_block {SERVE_BLOCK}: the per-op loop's streams differ")
    print(f"paged serving, decode_block {SERVE_BLOCK}: {len(block_reqs)} requests "
          f"(max_new_tokens {SERVE_BLOCK_NEW[0]}-{SERVE_BLOCK_NEW[1]}), run {block_s:.3f} s, "
          f"decode {bst.decode_tok_s():.2f} tok/s, stats {bst.snapshot()}; streams equal to the "
          f"per-op loop's; launches {block_counts}", flush=True)
    del engine, block_engine
    torch.cuda.empty_cache()
    return dict(stats=snap, counts=counts, warmup_s=warm_s, warmup_captures=captures, run_s=run_s,
                host_ms_per_step=host_ms,
                eager_s=eager_s, eager_host_ms_per_step=eager_host_ms,
                profile=dict(steps=SERVE_PROFILE_STEPS, host_ms_per_step=host_ms_window,
                             profiled_wall_ms_per_step=wall_ms, device_ms_per_step=device_ms,
                             kernels=len(run["kernels"]), lost_inside=run["lost_inside"]),
                block=dict(stats=bst.snapshot(), counts=block_counts, run_s=block_s))


def phase_serving_cut(torch, np, cut_dir: str) -> dict:
    """The paged engine on the 2-layer full-width cut in f32, card against
    CPU on one trace (three requests, one a prefix-cache hit): every decode
    step's logits of the active slots within SERVE_CUT_REL_TOL relative."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.serving import Request

    rng = np.random.default_rng(SERVE_SEED + 3)
    base = rng.integers(1, 32000, 40).astype(np.int32)
    other = np.concatenate([base[:32], rng.integers(1, 32000, 8).astype(np.int32)])
    reqs = [Request(0, base, 3), Request(1, other, 3),
            Request(2, rng.integers(1, 32000, 24).astype(np.int32), 3)]
    rows = {}
    for device in ("cuda", "cpu"):
        model = AutoGPTQForCausalLM.from_quantized(cut_dir, device=device, dtype=torch.float32)
        engine = serving_engine(model, total_pages=32, pages_per_seq=8)
        steps, real = [], engine._decode

        def recorded(sampling, nblk, real=real, engine=engine, steps=steps):
            toks, logits = real(sampling, nblk)
            active = [i for i, st in enumerate(engine.slots) if st.req is not None]
            steps.append(logits[active].float().cpu())
            return toks, logits

        engine._decode = recorded
        rows[device] = (engine.run(reqs), steps, engine.stats.prefix_hit_tokens)
        del model, engine
        torch.cuda.empty_cache()
    (card_out, card_steps, hits), (cpu_out, cpu_steps, _) = rows["cuda"], rows["cpu"]
    check(len(card_steps) == len(cpu_steps) and hits > 0, f"serving cut: {len(card_steps)} card "
                                                           f"steps, {len(cpu_steps)} CPU, {hits} "
                                                           f"prefix hit tokens")
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(card_steps, cpu_steps))
    same = sum(np.array_equal(card_out[r], cpu_out[r]) for r in cpu_out)
    check(rel <= SERVE_CUT_REL_TOL, f"serving cut: decode-step logits {rel:.3e} relative apart, "
                                    f"tolerance {SERVE_CUT_REL_TOL}")
    print(f"paged serving on the 2-layer full-width cut, f32, card against CPU: {len(card_steps)} "
          f"decode steps of {len(reqs)} requests ({hits} prefix-hit tokens), logits {rel:.3e} "
          f"relative apart at most (tolerance {SERVE_CUT_REL_TOL}); {same} of {len(reqs)} "
          f"streams equal", flush=True)
    return dict(steps=len(card_steps), max_rel=rel, streams_equal=same, prefix_hit_tokens=hits)


def phase_k8a_rows(torch, timer) -> list:
    """K8a's per-row cursor mode at the slot engine's shapes: SERVE_SLOTS rows of a [2, 8, 768,
    32, 128] cache, bf16 and int8 with its scales; T = 1 (the decode step, over the whole cache,
    the rows at SLOT_CURSORS: an idle row at 0, one parked at S - 1 and one past S, dropped) and
    T = SPEC_GAMMA + 1 (the speculative verify window on a view narrowed to VERIFY_WIN slots, the
    rows at VERIFY_CURSORS: one whose window ends on the view's last slot, one parked there,
    whose later tokens fall past it, and one past it). Against rope_write_kv_ref on clones of
    the same inputs: q, K, V, codes and scales bit-equal; one launch; timed beside its plain
    version and beside two index_put_ of the same rows (the write alone)."""
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.ops import paged_attn as pam

    gen = torch.Generator(device="cuda").manual_seed(21)
    b, h, hkv, d, layers, layer = SERVE_SLOTS, 32, 32, 128, 2, 1
    inv = pam.rope_inv_freq(10000.0, d, "cuda")
    rows = []
    for name, quant, t, win, at in (("step bf16", False, 1, None, SLOT_CURSORS),
                                    ("step int8", True, 1, None, SLOT_CURSORS),
                                    ("verify bf16", False, SPEC_GAMMA + 1, VERIFY_WIN,
                                     VERIFY_CURSORS),
                                    ("verify int8", True, SPEC_GAMMA + 1, VERIFY_WIN,
                                     VERIFY_CURSORS)):
        cursors = torch.tensor(at, device="cuda")
        q, k, v = (torch.randn((b * t, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (h, hkv, hkv))
        pos = (cursors[:, None] + torch.arange(t, device="cuda")[None]).reshape(-1)
        shape = (layers, b, SLOT_SEQ, hkv, d)
        if quant:
            full = {"k": torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                       dtype=torch.int8),
                    "k_scale": torch.rand(shape[:-1] + (1,), generator=gen, device="cuda") + 0.1}
            full["v"], full["v_scale"] = full["k"].clone(), full["k_scale"].clone()
        else:
            full = {"k": torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)}
            full["v"] = full["k"].clone()
        want = {key: x.clone() for key, x in full.items()}

        def view(caches):
            return {key: (x if win is None else x[:, :, :win]) for key, x in caches.items()}

        gv, wv = view(full), view(want)
        kw = dict(cursors=cursors, k_scale=gv.get("k_scale"), v_scale=gv.get("v_scale"))
        want_q = pam.rope_write_kv_ref(q, k, v, pos, inv, wv["k"], wv["v"], layer,
                                       k_scale=wv.get("k_scale"), v_scale=wv.get("v_scale"),
                                       cursors=cursors)
        before = build.launches["rope_write_kv"]
        got_q = pam.rope_write_kv(q, k, v, pos, inv, gv["k"], gv["v"], layer, **kw)
        torch.cuda.synchronize()
        check(build.launches["rope_write_kv"] == before + 1, f"K8a per row {name}: not one launch")
        diff = {key: int((full[key] != want[key]).sum()) for key in full}
        diff["q"] = int((got_q != want_q).sum())
        check(not any(diff.values()), f"K8a per row {name}: elements differing from its plain "
                                      f"version: {diff}")
        s_view = win or SLOT_SEQ
        kept = pos < s_view
        check(int(kept.sum()) < b * t and bool(kept.any()), f"K8a per row {name}: no row dropped")
        max_abs = float((got_q.float() - want_q.float()).abs().max())
        del want, wv, want_q
        ms = timer.ms(lambda: pam.rope_write_kv(q, k, v, pos, inv, gv["k"], gv["v"], layer,
                                                check=False, **kw))
        plain_ms = timer.ms(lambda: pam.rope_write_kv_ref(q, k, v, pos, inv, gv["k"], gv["v"],
                                                          layer, **kw))
        row = torch.arange(b * t, device="cuda") // t
        idx = (torch.full((int(kept.sum()),), layer, device="cuda"), row[kept], pos[kept])
        kr, vr = k[kept].to(gv["k"].dtype), v[kept].to(gv["v"].dtype)
        lib_ms = timer.ms(lambda: (gv["k"].index_put_(idx, kr), gv["v"].index_put_(idx, vr)))
        n_kept = int(kept.sum())
        es, ce = 2, full["k"].element_size()
        moved = (2 * b * t * h * d * es + 2 * b * t * hkv * d * es
                 + 2 * n_kept * hkv * (d * ce + (4 if quant else 0))
                 + b * t * 8 + b * 8 + d // 2 * 4)
        b_ms, b_by = bound_ms(moved, 6 * b * t * (h + hkv) * d // 2, F32_FLOP_PER_S)
        rows.append(dict(case=name, T=t, cursors=list(at), window=s_view, rows_written=n_kept,
                         cache=list(shape), cache_dtype=str(full["k"].dtype), differing=diff,
                         max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"K8a per row {name:12s} q [{b * t}, {h}, {d}] bf16, T = {t}, cursors {list(at)} "
              f"into {list(shape)} {full['k'].dtype} (window {s_view}): {n_kept} of {b * t} "
              f"rows written, the rest dropped; elements differing from rope_write_kv_ref "
              f"{diff}; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  index_put_ x 2 "
              f"{lib_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})", flush=True)
        del full, gv
    return rows


def phase_k2_rows(torch, timer) -> list:
    """K2 at the slot engine's per-row bounds: SERVE_SLOTS rows of a [2, 8, 768, 32, 128] bf16
    cache, lo = 0, hi = SLOT_CURSORS + 1 (an idle row's hi = 1, a parked row's S, a row past S
    clamped to S); twice bit-equal, within K2_ABS_TOL of its plain version, timed beside SDPA."""
    import torch.nn.functional as F

    from autogptq_tpu_torch.ops import flash_decode as fdm

    gen = torch.Generator(device="cuda").manual_seed(22)
    b, h, hkv, d, s, layer = SERVE_SLOTS, 32, 32, 128, SLOT_SEQ, 1
    q = torch.randn((b, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    kc = torch.randn((2, b, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    vc = torch.randn(kc.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    lo = torch.zeros(b, dtype=torch.int32, device="cuda")
    hi = (torch.tensor(SLOT_CURSORS, device="cuda") + 1).to(torch.int32)
    scale = d ** -0.5
    o = fdm.flash_decode(q, kc, vc, lo, hi, layer=layer, sm_scale=scale)
    again = fdm.flash_decode(q, kc, vc, lo, hi, layer=layer, sm_scale=scale)
    ref = fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=layer, sm_scale=scale)
    torch.cuda.synchronize()
    err = (o - ref).abs().max().item()
    check(bool(torch.isfinite(o).all()), "K2 engine rows: non-finite output")
    check(err <= K2_ABS_TOL, f"K2 engine rows: max |kernel - plain| = {err:.3e} > {K2_ABS_TOL}")
    check(torch.equal(o, again), "K2 engine rows: two calls on the same inputs differ")
    kl, vl = kc[layer].permute(0, 2, 1, 3), vc[layer].permute(0, 2, 1, 3)
    p = torch.arange(s, device="cuda")
    mask = ((p[None] >= lo[:, None]) & (p[None] < hi[:, None]))[:, None, None, :]
    ms = timer.ms(lambda: fdm.flash_decode(q, kc, vc, lo, hi, layer=layer, sm_scale=scale))
    plain_ms = timer.ms(lambda: fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=layer,
                                                     sm_scale=scale))
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kl, vl,
                                                             attn_mask=mask, scale=scale))
    live = sum(min(int(x), s) for x in hi.tolist())
    b_ms, b_by = bound_ms(2 * live * hkv * d * 2 + nbytes(q, o, lo, hi), 4.0 * live * h * d)
    chunk, n_split = fdm.split_plan(b, hkv, s)
    print(f"K2 engine rows B={b} H=Hkv={h} S={s}: hi {hi.tolist()} ({live} live slots), plan "
          f"{n_split} x {chunk} slots; err {err:.3e} (tol {K2_ABS_TOL}), repeat bit-equal; "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {b_ms:.4f} "
          f"ms ({b_by})", flush=True)
    return [dict(case="engine rows", B=b, H=h, Hkv=hkv, S=s, D=d, hi=hi.tolist(),
                 live_slots=live, chunk=chunk, n_split=n_split, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)]


def slot_engine(model, **kw):
    from autogptq_tpu_torch.serving import ContinuousBatchEngine

    kw = dict(dict(max_slots=SERVE_SLOTS, max_seq_len=SLOT_SEQ, prefill_chunk=SLOT_CHUNK), **kw)
    return ContinuousBatchEngine(model, **kw)


def check_slot_launches(counts, steps: int, layers: int, label: str, int8: bool = False) -> None:
    """Every decode step of a warmed slot engine replayed from its graph with exactly 224 K1
    GEMVs (M = SERVE_SLOTS), one K8a per-row write and one K2 per layer (none over an int8
    cache: the einsum), and nothing captured; no other path launches them (the prefills and
    chunks run at 32 rows or more, the wgmma tile kernel, and write through the host cursor)."""
    want = {"w4a16_gemm_gemv": 7 * layers * steps, "rope_write_kv": layers * steps,
            "flash_decode": 0 if int8 else layers * steps}
    got = {key: counts.get(key, 0) for key in want}
    rep = {key: counts.replayed.get(key, 0) for key in want}
    check(got == want == rep and not counts.get("w4a16_gemm", 0)
          and not counts.graphs.get("captures", 0),
          f"{label}: launches {got}, replayed {rep}, want {want} for {steps} steps, all "
          f"replayed, no SIMT GEMV and no capture after warmup(); graphs {counts.graphs}")


def same_streams(np, a: dict, b: dict) -> list:
    """The request ids whose streams differ."""
    return sorted(r for r in set(a) | set(b) if r not in a or r not in b
                  or not np.array_equal(a[r], b[r]))


def phase_slot_serving(torch, np, model) -> dict:
    """The slot engine (``serving.ContinuousBatchEngine``) on the main path's model, 32 layers
    at full width, bf16, SERVE_SLOTS slots of SLOT_SEQ positions, chunks of SLOT_CHUNK: the
    trace of ``serving_trace`` (24 requests; the prompts above SLOT_CHUNK tokens prefilled in
    chunks, interleaved with decode) after ``warmup()``, through the decode step's CUDA graphs,
    then through the per-op loop (``JIT_GENERATE`` off), streams and stats identical; exact
    launches per replayed step; a window of 16 engine steps (8 slots decoding) run twice on
    the same requests, unprofiled for host ms and profiled for device ms. Then a shorter trace
    with ``decode_block = SERVE_BLOCK`` and the same trace over an int8 cache (``kv_quant``),
    each against its per-op loop."""
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.serving import Request

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    reqs = serving_trace(np, vocab, SERVE_SEED, SERVE_REQUESTS)
    chunked = sum(len(r.prompt) > SLOT_CHUNK for r in reqs)
    engine = slot_engine(model)
    captures = build.graphs.get("captures", 0)
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    captures = build.graphs.get("captures", 0) - captures
    out, counts, run_s = served(torch, build, engine, reqs, warm=False)
    st = engine.stats
    check_slot_launches(counts, st.steps, layers, "slot serving")
    check(set(out) == {r.req_id for r in reqs} and all(
        len(out[r.req_id]) == r.max_new_tokens and ((out[r.req_id] >= 0)
                                                     & (out[r.req_id] < vocab)).all()
        for r in reqs), "slot serving: an output of the wrong length or out of range")
    snap = st.snapshot()
    host_ms = 1e3 * st.step_time_s / st.steps
    print(f"slot serving: Llama-2-7B 4-bit g128, {layers} layers, bf16, {SERVE_SLOTS} slots of "
          f"{SLOT_SEQ} positions, prefill_chunk {SLOT_CHUNK}; the {len(reqs)} requests of the "
          f"paged phase ({chunked} prefilled in chunks): warmup {warm_s:.1f} s ({captures} "
          f"captures), run {run_s:.3f} s, decode {snap['decode_tok_s']} tok/s, {host_ms:.3f} host "
          f"ms per engine step; stats {snap}; per replayed step "
          f"{counts.get('w4a16_gemm_gemv', 0) / st.steps:.0f} K1 GEMVs at M = {SERVE_SLOTS}, "
          f"{counts.get('rope_write_kv', 0) / st.steps:.0f} rope_write_kv (per-row), "
          f"{counts.get('flash_decode', 0) / st.steps:.0f} flash_decode; launches {counts}",
          flush=True)

    with jit_generate(False):
        eager_engine = slot_engine(model)
        t0 = time.perf_counter()
        eager = eager_engine.run(list(reqs))
        eager_s = time.perf_counter() - t0
    differ = same_streams(np, eager, out)
    check(not differ, f"slot serving: the per-op loop's streams differ from the CUDA graphs': "
                      f"requests {differ}")
    check(dataclasses.asdict(eager_engine.stats) | {"step_time_s": 0}
          == dataclasses.asdict(st) | {"step_time_s": 0}, "slot serving: the per-op loop's "
          "stats differ from the graphs'")
    eager_host_ms = 1e3 * eager_engine.stats.step_time_s / eager_engine.stats.steps
    del eager_engine
    print(f"slot serving, per-op loop (JIT_GENERATE off): the same {len(reqs)} streams and stats, "
          f"{eager_s:.3f} s, {eager_host_ms:.3f} host ms per engine step (graphs "
          f"{host_ms:.3f})", flush=True)

    window = slot_engine(model)
    window.warmup(sampling=False)
    rng = np.random.default_rng(SERVE_SEED + 4)
    prompts = [rng.integers(1, vocab, 64).astype(np.int32) for _ in range(SERVE_SLOTS)]

    def wave(first_id, steps):
        for i, p in enumerate(prompts):
            window.submit(Request(first_id + i, p, 64))
        window.step()                  # admits and prefills every request
        measured = steps()
        streams = window.run([])
        return measured, [streams[first_id + i] for i in range(SERVE_SLOTS)]

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE_STEPS):
            window.step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / SERVE_PROFILE_STEPS

    host_ms_window, first = wave(0, timed)
    run, second = wave(SERVE_SLOTS, lambda: profiled(
        torch, lambda: [window.step() for _ in range(SERVE_PROFILE_STEPS)]))
    check(all(np.array_equal(a, b) for a, b in zip(first, second)),
          "slot serving window: the same requests gave other streams the second time")
    device_ms = sum(k.time_range.elapsed_us() for k in run["kernels"]) / 1e3 / SERVE_PROFILE_STEPS
    wall_ms = run["wall_us"] / 1e3 / SERVE_PROFILE_STEPS
    print(f"slot serving, a window of {SERVE_PROFILE_STEPS} engine steps ({SERVE_SLOTS} slots "
          f"decoding, no admission, 64-token prompts), run twice on the same requests with the "
          f"same streams: host {host_ms_window:.3f} ms per step unprofiled, device "
          f"{device_ms:.3f} ms per step in {len(run['kernels'])} kernels profiled (busy "
          f"{100 * device_ms / host_ms_window:.1f}%, idle {host_ms_window - device_ms:.3f} ms per "
          f"step); host {wall_ms:.3f} ms per step under the profiler; launches with no kernel "
          f"record: {run['lost_inside']} inside, {run['lost_before']} before", flush=True)
    del window

    block_reqs = serving_trace(np, vocab, SERVE_SEED + 2, SERVE_BLOCK_REQUESTS,
                               new=SERVE_BLOCK_NEW)
    variants = {}
    for label, kw in ((f"decode_block {SERVE_BLOCK}", dict(decode_block=SERVE_BLOCK)),
                      ("kv_quant", dict(kv_quant=True))):
        eng = slot_engine(model, **kw)
        v_out, v_counts, v_s = served(torch, build, eng, block_reqs, warm=True)
        vst = eng.stats
        check_slot_launches(v_counts, vst.steps, layers, f"slot serving, {label}",
                            int8=kw.get("kv_quant", False))
        del eng
        with jit_generate(False):
            v_eager = slot_engine(model, **kw).run(list(block_reqs))
        differ = same_streams(np, v_eager, v_out)
        check(not differ, f"slot serving, {label}: the per-op loop's streams differ: {differ}")
        print(f"slot serving, {label}: {len(block_reqs)} requests (max_new_tokens "
              f"{SERVE_BLOCK_NEW[0]}-{SERVE_BLOCK_NEW[1]}), run {v_s:.3f} s, decode "
              f"{vst.decode_tok_s():.2f} tok/s, {1e3 * vst.step_time_s / vst.steps:.3f} host ms "
              f"per decode step, stats {vst.snapshot()}; streams equal to the per-op loop's; "
              f"launches {v_counts}", flush=True)
        variants[label] = dict(stats=vst.snapshot(), counts=v_counts, run_s=v_s,
                               host_ms_per_step=1e3 * vst.step_time_s / vst.steps, out=v_out)
    torch.cuda.empty_cache()
    return dict(stats=snap, counts=counts, warmup_s=warm_s, warmup_captures=captures,
                run_s=run_s, host_ms_per_step=host_ms, eager_s=eager_s,
                eager_host_ms_per_step=eager_host_ms, out=out, reqs=reqs,
                profile=dict(steps=SERVE_PROFILE_STEPS, host_ms_per_step=host_ms_window,
                             profiled_wall_ms_per_step=wall_ms, device_ms_per_step=device_ms,
                             kernels=len(run["kernels"]), lost_inside=run["lost_inside"]),
                variants={k: {key: val for key, val in v.items() if key != "out"}
                          for k, v in variants.items()})


def layer_cut(model, n: int):
    """The first ``n`` decoder layers of ``model`` as a model of their own (the same tensors):
    a draft that shares the target's vocabulary and embeddings."""
    return types.SimpleNamespace(params=dict(model.params, layers=model.params["layers"][:n]),
                                 cfg=dataclasses.replace(model.cfg, num_layers=n),
                                 dtype=model.dtype, device=model.device)


def first_difference(np, a, b) -> int:
    """The index of the first token where ``a`` and ``b`` differ, or their length."""
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    ne = np.nonzero(a != b)[0]
    return int(ne[0]) if len(ne) else len(a)


def phase_speculative(torch, np, model, slot) -> dict:
    """Speculative decoding on the main path's model, bf16, 32 layers: ``generate(draft_model=,
    speculative_gamma=SPEC_GAMMA)`` of SPEC_NEW_TOKENS tokens from the main path's 16-token
    prompt with the model itself as its draft and with its first SPEC_DRAFT_LAYERS layers,
    beside plain greedy (its CUDA graph); tokens per target forward and tok/s; the tokens equal
    to plain greedy's counted (the verify window runs K1 at M = 5 and the einsum, plain greedy
    K1 at M = 1 and K2: other roundings of bf16, which can part the two at a near tie; the f32
    cut holds them equal). Then speculative serving: the slot phase's greedy requests through
    the slot engine with the model as its draft, streams counted against the plain engine's
    (the same roundings), every speculative step eager."""
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.utils.speculative import generate_speculative

    prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = model.generate(prompt, max_new_tokens=SPEC_NEW_TOKENS)
    plain_s = time.perf_counter() - t0
    runs = {}
    for label, draft in (("draft = the model", model),
                         (f"draft = its first {SPEC_DRAFT_LAYERS} layers",
                          layer_cut(model, SPEC_DRAFT_LAYERS))):
        stats = {}
        generate_speculative(model, draft, prompt, max_new_tokens=8, gamma=SPEC_GAMMA)  # warm
        torch.cuda.synchronize()
        clear_counts(build)
        t0 = time.perf_counter()
        got = generate_speculative(model, draft, prompt, max_new_tokens=SPEC_NEW_TOKENS,
                                   gamma=SPEC_GAMMA, stats=stats)
        spec_s = time.perf_counter() - t0
        counts = snapshot(build)
        new = got[0, PROMPT_LEN:]
        check(got.shape == plain.shape and bool(((new >= 0) & (new < model.cfg.vocab_size)).all()),
              f"speculative, {label}: output {got.shape} or ids out of range")
        check(counts.get("rope_write_kv", 0) > 0 and counts.get("flash_decode", 0) > 0,
              f"speculative, {label}: the draft's steps launched no K8a or K2: {counts}")
        equal = int((new == plain[0, PROMPT_LEN:]).sum())
        first = first_difference(np, new, plain[0, PROMPT_LEN:])
        runs[label] = dict(tok_s=SPEC_NEW_TOKENS / spec_s, seconds=spec_s, tokens_equal=equal,
                           first_difference=first, counts=counts, **stats)
        print(f"speculative generate, {label}, gamma {SPEC_GAMMA}, {SPEC_NEW_TOKENS} tokens from "
              f"the {PROMPT_LEN}-token prompt: {SPEC_NEW_TOKENS / spec_s:.2f} tok/s ({spec_s:.3f} "
              f"s; plain greedy {SPEC_NEW_TOKENS / plain_s:.2f} tok/s), "
              f"{stats['target_forwards']} target forwards, {stats['accepted_drafts']} drafts "
              f"accepted, {stats['tokens_per_target_forward']:.2f} tokens per target forward; "
              f"tokens equal to plain greedy's {equal} of {SPEC_NEW_TOKENS} (first difference at "
              f"{first}); launches {counts}", flush=True)

    greedy = [r for r in slot["reqs"] if r.temperature == 0]
    engine = slot_engine(model, draft_model=model, spec_gamma=SPEC_GAMMA)
    engine.warmup(sampling=False)
    torch.cuda.synchronize()
    clear_counts(build)
    t0 = time.perf_counter()
    out = engine.run(list(greedy))
    serve_s = time.perf_counter() - t0
    counts = snapshot(build)
    st = engine.stats
    check(engine.spec_steps > 0 and set(out) == {r.req_id for r in greedy} and all(
        len(out[r.req_id]) == r.max_new_tokens for r in greedy),
        f"speculative serving: {engine.spec_steps} speculative steps, outputs of the wrong length")
    plain_out = slot["out"]
    equal_streams = sum(np.array_equal(out[r.req_id], plain_out[r.req_id]) for r in greedy)
    tokens = sum(r.max_new_tokens for r in greedy)
    equal_tokens = sum(int((out[r.req_id] == plain_out[r.req_id]).sum()) for r in greedy)
    print(f"speculative serving, draft = the model, gamma {SPEC_GAMMA}: the {len(greedy)} greedy "
          f"requests of the slot phase's trace, run {serve_s:.3f} s, {st.tokens_generated} "
          f"tokens in {st.steps} engine steps ({engine.spec_steps} speculative, "
          f"{st.tokens_generated / max(st.steps, 1):.2f} tokens per step), decode "
          f"{st.decode_tok_s():.2f} tok/s; streams equal to the plain engine's {equal_streams} of "
          f"{len(greedy)}, tokens {equal_tokens} of {tokens}; launches {counts}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return dict(generate=runs, plain_tok_s=SPEC_NEW_TOKENS / plain_s,
                serving=dict(requests=len(greedy), seconds=serve_s, stats=st.snapshot(),
                             spec_steps=st.steps, streams_equal=equal_streams,
                             tokens_equal=equal_tokens, tokens=tokens, counts=counts))


def phase_slot_cut(torch, np, cut_dir: str) -> dict:
    """The 2-layer full-width cut in f32. On the card (f32: the SIMT kernels, K2, K8a) the slot
    engine against the CPU engine on one trace (a chunked prompt among them): every decode
    step's logits of the active slots within SLOT_CUT_REL_TOL relative, streams counted. On the
    card alone, where f32 leaves no near tie: speculative ``generate`` with the cut as its own
    draft and with its first layer, tokens equal to plain greedy's; speculative serving with the
    cut as its draft, streams equal to the plain engine's."""
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.serving import Request
    from autogptq_tpu_torch.utils.speculative import generate_speculative

    rng = np.random.default_rng(SERVE_SEED + 5)
    reqs = [Request(0, rng.integers(1, 32000, 40).astype(np.int32), 3),
            Request(1, rng.integers(1, 32000, 9).astype(np.int32), 4),
            Request(2, rng.integers(1, 32000, 24).astype(np.int32), 3)]
    rows = {}
    for device in ("cuda", "cpu"):
        model = AutoGPTQForCausalLM.from_quantized(cut_dir, device=device, dtype=torch.float32)
        engine = slot_engine(model, max_seq_len=64, prefill_chunk=16, max_slots=2)
        steps, real = [], engine._decode

        def recorded(sampling, nblk, win, real=real, engine=engine, steps=steps):
            toks, logits = real(sampling, nblk, win)
            active = [i for i, st in enumerate(engine.slots)
                      if st.req is not None and not st.prefilling]
            steps.append(logits[active].float().cpu())
            return toks, logits

        engine._decode = recorded
        rows[device] = (engine.run(reqs), steps)
        if device == "cuda":
            prompt = (np.arange(PROMPT_LEN) % 1000)[None].astype(np.int32)
            plain = model.generate(prompt, max_new_tokens=SPEC_CUT_TOKENS)
            spec = {}
            for label, draft in (("itself", model), ("its first layer", layer_cut(model, 1))):
                stats = {}
                got = generate_speculative(model, draft, prompt, max_new_tokens=SPEC_CUT_TOKENS,
                                           gamma=SPEC_GAMMA, stats=stats)
                check(np.array_equal(got, plain), f"speculative generate on the f32 cut, draft "
                      f"= {label}: tokens differ from plain greedy's at "
                      f"{first_difference(np, got, plain) - PROMPT_LEN}")
                spec[label] = stats
            longer = [Request(r.req_id, r.prompt, SPEC_CUT_TOKENS // 2) for r in reqs]
            plain_srv = slot_engine(model, max_seq_len=128, prefill_chunk=16).run(list(longer))
            spec_eng = slot_engine(model, max_seq_len=128, prefill_chunk=16, draft_model=model,
                                   spec_gamma=SPEC_GAMMA)
            spec_srv = spec_eng.run(list(longer))
            differ = same_streams(np, spec_srv, plain_srv)
            check(not differ and spec_eng.spec_steps > 0,
                  f"speculative serving on the f32 cut: streams differ from the plain engine's: "
                  f"{differ} ({spec_eng.spec_steps} speculative steps)")
        del model, engine
        torch.cuda.empty_cache()
    (card_out, card_steps), (cpu_out, cpu_steps) = rows["cuda"], rows["cpu"]
    check(len(card_steps) == len(cpu_steps), f"slot cut: {len(card_steps)} card steps, "
                                             f"{len(cpu_steps)} CPU")
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(card_steps, cpu_steps))
    same = sum(np.array_equal(card_out[r], cpu_out[r]) for r in cpu_out)
    check(rel <= SLOT_CUT_REL_TOL, f"slot cut: decode-step logits {rel:.3e} relative apart, "
                                   f"tolerance {SLOT_CUT_REL_TOL}")
    print(f"slot engine on the 2-layer full-width cut, f32, card against CPU: {len(card_steps)} "
          f"decode steps of {len(reqs)} requests (one prefilled in chunks of 16), logits "
          f"{rel:.3e} relative apart at most (tolerance {SLOT_CUT_REL_TOL}); {same} of "
          f"{len(reqs)} streams equal; on the card, speculative generate of {SPEC_CUT_TOKENS} "
          f"tokens equal to plain greedy's with the cut as its draft "
          f"({spec['itself']['tokens_per_target_forward']:.2f} tokens per target forward) and "
          f"with its first layer ({spec['its first layer']['tokens_per_target_forward']:.2f}); "
          f"speculative serving's {len(reqs)} streams of {SPEC_CUT_TOKENS // 2} tokens equal to "
          f"the plain engine's ({spec_eng.spec_steps} speculative steps)", flush=True)
    return dict(steps=len(card_steps), max_rel=rel, streams_equal=same, speculative=spec,
                spec_serving_steps=spec_eng.spec_steps)


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

    from autogptq_tpu_torch.ops import build, gemm

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
    prenorm_rows = timed("K1 prologue", phase_prenorm, torch, np, timer)
    wna_rows = timed("K4/K5/K1 classes", phase_wna16, torch, np, timer)
    rest_rows = timed("rest classes", phase_rest, torch, np, timer)
    ptxas = mma_ptxas()
    wgmma_regs = wgmma_ptxas()
    gemv_regs = gemv_ptxas()
    prenorm_regs = prenorm_ptxas()
    k2_rows = timed("K2", phase_k2, torch, timer)
    k7_rows = timed("K7", phase_k7, torch, timer)
    attn_ptxas = attention_ptxas()
    page_regs = page_ops_ptxas()
    k8a_fused_rows, k8a_rows, k8b_rows = timed("K8", phase_k8, torch, timer)
    k8a_row_rows = timed("K8a per row", phase_k8a_rows, torch, timer)
    k2_engine_rows = timed("K2 engine rows", phase_k2_rows, torch, timer)
    k10_rows = timed("K10", phase_k10, torch, np, timer)
    k9_rows = timed("K9", phase_k9, torch, np, timer)
    k9_rest_rows = timed("K9 rest classes", phase_k9_rest, torch, np, timer)
    k6 = timed("K6", phase_k6, torch, np, timer)
    boundary = boundary_cost(torch, np)
    del timer
    torch.cuda.empty_cache()

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        ckpt = os.path.join(work, "llama2-7b-random-g128")
        launches, model, main_out, batch2_launches, main_routes = timed(
            "main path", phase_main_path, torch, np, ckpt)
        kb32l = timed("kb32l path", phase_kb32l_path, torch, np, ckpt, model, main_out)
        beam = timed("beam", phase_beam, torch, np, model)
        int8 = timed("int8 greedy", phase_int8_greedy, torch, np, model, main_out)
        serving = timed("paged serving", phase_serving, torch, np, model)
        slot = timed("slot serving", phase_slot_serving, torch, np, model)
        spec = timed("speculative", phase_speculative, torch, np, model, slot)
        fused = timed("fused norm", phase_fused_norm, torch, np, model, main_out)
        train = timed("train", phase_train, torch, np, model, work)
        del model
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
        cut_dir = os.path.join(work, "llama2-7b-random-g128-2layers")
        cpu_vs_card = timed("card vs CPU", phase_cpu_vs_card, torch, np, cut_dir)
        serving_cut = timed("paged serving card vs CPU", phase_serving_cut, torch, np, cut_dir)
        slot_cut = timed("slot serving card vs CPU", phase_slot_cut, torch, np, cut_dir)
        fused_cut = timed("fused norm card vs CPU", phase_fused_cut, torch, np, cut_dir)
        kb32l_cut = timed("kb32l card vs CPU", phase_kb32l_cut, torch, np, cut_dir)
        grads = timed("gradients", phase_grads, torch, np, cut_dir)
        shutil.rmtree(work, ignore_errors=True)
        widths = timed("other widths", phase_other_widths, torch, np, work)
        rest_path = timed("rest-class path", phase_rest_path, torch, np, work)
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

    k2_main, k7_main, k8b_main = k2_rows[0], k7_rows[0], k8b_rows[0]
    k8a_main = next(r for r in k8a_fused_rows if r["case"] == K8A_MAIN)
    k8a_int8 = next(r for r in k8a_fused_rows if r["case"] == "greedy int8")
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
    def width_rows(bits):
        return [r for r in wna_rows if r["bits"] == bits and r["group_size"] == 128
                and not r["desc_act"]]

    k6_bf16 = [r for r in k6["rows"] if r["case"] in LAYER_SHAPES]
    decode_m = {m: dict(k1_ms=layer_sum(k1_rows, "ms", m),
                        k1_simt_ms=layer_sum(k1_rows, "simt_ms", m),
                        k1_library_ms=layer_sum(k1_rows, "library_ms", m),
                        k1_bound_ms=layer_sum(k1_rows, "bound_ms", m),
                        k6_ms=layer_sum(k6_bf16, "ms", m),
                        k6_ring_ms=layer_sum(k6_bf16, "simt_ms", m),
                        k6_k1_ms=layer_sum(k6_bf16, "k1_ms", m),
                        k6_k1_simt_ms=layer_sum(k6_bf16, "k1_simt_ms", m),
                        k6_library_ms=layer_sum(k6_bf16, "library_ms", m))
                for m in (1, BEAMS, 16)}
    decode_m.update({f"{bits}-bit M=1": dict(
        gemv_ms=layer_sum(width_rows(bits), "ms"), simt_ms=layer_sum(width_rows(bits), "simt_ms"),
        library_ms=layer_sum(width_rows(bits), "library_ms"),
        bound_ms=layer_sum(width_rows(bits), "bound_ms")) for bits in (2, 3, 8)})
    print("one Llama-2-7B layer's 7 projections, 4-bit g128 bf16, decode regime: " + "; ".join(
        f"M = {m}: K1's GEMV {v['k1_ms']:.4f} ms, the SIMT GEMV {v['k1_simt_ms']:.4f} ms, "
        f"torch.matmul {v['k1_library_ms']:.4f} ms, bound {v['k1_bound_ms']:.4f} ms (K1 phase); "
        f"K6's GEMV {v['k6_ms']:.4f} ms ({100 * v['k6_ms'] / v['k6_k1_ms'] - 100:+.1f}% against "
        f"K1's), K6's ring {v['k6_ring_ms']:.4f} ms, K1's GEMV {v['k6_k1_ms']:.4f} ms, the SIMT "
        f"GEMV "
        f"{v['k6_k1_simt_ms']:.4f} ms, torch.matmul {v['k6_library_ms']:.4f} ms (K6 phase)"
        for m, v in decode_m.items() if isinstance(m, int)) + "; at M = 1, g128: " + "; ".join(
        f"{m}: the GEMV {v['gemv_ms']:.4f} ms, the SIMT GEMV {v['simt_ms']:.4f} ms, torch.matmul "
        f"{v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms"
        for m, v in decode_m.items() if not isinstance(m, int)), flush=True)
    engine_k1 = {key: layer_sum(k1_rows, key, SERVE_SLOTS)
                 for key in ("ms", "simt_ms", "library_ms", "bound_ms")}
    print(f"one Llama-2-7B layer's 7 projections at M = {SERVE_SLOTS} (the paged serving engine's "
          f"decode step), K1's GEMV {engine_k1['ms']:.4f} ms (x {layers} layers: "
          f"{layers * engine_k1['ms']:.3f} ms per engine step), the SIMT GEMV "
          f"{engine_k1['simt_ms']:.4f} ms, torch.matmul {engine_k1['library_ms']:.4f} ms, bound "
          f"{engine_k1['bound_ms']:.4f} ms", flush=True)

    def replayed(counted, name):   # of a run's launches of `name`: those its graph replays ran
        return getattr(counted, "replayed", {}).get(name, 0)

    def entry(name, source, replaces, counted, rows, main_row, at):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=counted.get(name, 0), replayed=replayed(counted, name),
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
                    replaces=replaces, launches=counted.get(name, 0),
                    replayed=replayed(counted, name), max_abs_err=max(errs),
                    ms=layer_sum(rows, ms_key, m), plain_ms=layer_sum(rows, "plain_ms", m),
                    bound_ms=layer_sum(rows, "bound_ms", m),
                    bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in main_rows)
                              else "operations"),
                    library_ms=layer_sum(rows, "library_ms", m), at=at)

    prenorm_m = {case: {key: prenorm_layer(prenorm_rows, case, key) for key in
                        ("ms", "kernel_ms", "unfused_ms", "plain_ms", "library_ms", "bound_ms",
                         "mma_ms", "rstd_ms", "rstd_plain_ms", "rstd_bound_ms")
                        if all(key in r for r in prenorm_rows if r["case"] == case)}
                 for case in dict.fromkeys(r["case"] for r in prenorm_rows)}
    wgmma_cases = {r["case"] for r in prenorm_rows if r["route"] == "wgmma"}
    for case, v in prenorm_m.items():
        if case in wgmma_cases:   # the wgmma prologue's targets
            v["within_10pct_of_alone"] = v["ms"] <= (1 + WITHIN) * v["kernel_ms"]
            v["below_unfused_pair"] = v["ms"] < v["unfused_ms"]
    print("K1's fused RMS-norm prologue, one Llama-2-7B layer's q/k/v and gate/up, g128: " + "; ".join(
        f"{case}: fused {v['ms']:.4f} ms, the same kernel alone {v['kernel_ms']:.4f} ms "
        f"({1e3 * (v['ms'] - v['kernel_ms']):+.1f} us"
        + (f", within 10%: {'met' if v['within_10pct_of_alone'] else 'NOT MET'}"
           if "within_10pct_of_alone" in v else "")
        + f"), unfused pair {v['unfused_ms']:.4f} ms"
        + (f" (below it: {'met' if v['below_unfused_pair'] else 'NOT MET'})"
           if "below_unfused_pair" in v else "")
        + (f", the mma.sync prologue {v['mma_ms']:.4f} ms, its rstd alone {v['rstd_ms']:.4f} ms"
           if "mma_ms" in v else "")
        + f", plain {v['plain_ms']:.4f} ms, F.rms_norm + torch.matmul {v['library_ms']:.4f} ms, "
        f"bound {v['bound_ms']:.4f} ms" for case, v in prenorm_m.items()), flush=True)
    gemv_norm = {m: prenorm_m[f"M={m} bf16"] for m in GEMV_NORM_M}
    for m, v in gemv_norm.items():
        v["below_library"] = v["ms"] < v["library_ms"]
        v["within_25pct_of_alone"] = v["ms"] <= (1 + GEMV_NORM_WITHIN) * v["kernel_ms"]
    print("K1's fused decode GEMV (the rows' rstd from one launch before it), one Llama-2-7B "
          "layer's q/k/v and gate/up, g128, bf16: "
          + "; ".join(
              f"M = {m}: fused {v['ms']:.4f} ms ("
              + (f"the rstd alone {v['rstd_ms']:.4f} ms; " if "rstd_ms" in v else "") + "the GEMV "
              f"alone {v['kernel_ms']:.4f} ms, {v['ms'] / v['kernel_ms'] - 1:+.1%}"
              + (f", within 25%: {'met' if v['within_25pct_of_alone'] else 'NOT MET'}, below "
                 f"F.rms_norm + torch.matmul ({v['library_ms']:.4f} ms): "
                 f"{'met' if v['below_library'] else 'NOT MET'}" if m == 16 else "") + ")"
              for m, v in gemv_norm.items()), flush=True)
    turns = {"main path": main_routes["graph"], f"beam {BEAMS}": beam["graph"],
             "Mixtral": mixtral["graph"], "fused norm": fused["graph"]}
    print("CUDA graph runs against the per-op loop (rate, host ms per token, device busy): "
          + "; ".join(f"{k} {v['rate']:.2f} against {v['eager_rate']:.2f}, "
                      f"{v['host_ms_per_token']:.3f} against {v['eager_host_ms_per_token']:.3f} "
                      f"ms ({v['step_ms']:.3f} against {v['eager_step_ms']:.3f} per decode step), "
                      f"about {100 * v['busy']:.1f}% against {100 * v['eager_busy']:.1f}% "
                      f"(capture {v['capture_s']:.3f} s, warm-up {v['warmup_s']:.3f} s, "
                      f"{v['replayed']} of {v['launches']} launches replayed)"
                      for k, v in turns.items()), flush=True)
    main_prof, fused_prof = main_routes.get("gemv") or {}, fused["profile"] or {}
    beam_prof = beam["profiles"].get("gemv") or {}
    print(f"fused norm against the default, same run: greedy {fused['tok_s']:.2f} tok/s (default "
          f"{main_routes['tok_s']:.2f}), "
          f"{fused_prof.get('kernels_per_token', float('nan')):.1f} kernels/token (default "
          f"{main_prof.get('kernels_per_token', float('nan')):.1f}), device "
          f"{fused_prof.get('device_ms_per_token', float('nan')):.3f} ms/token (default "
          f"{main_prof.get('device_ms_per_token', float('nan')):.3f}); beam {BEAMS} "
          f"{(fused['beam_profile'] or {}).get('kernels_per_token', float('nan')):.1f} "
          f"kernels/step (default {beam_prof.get('kernels_per_token', float('nan')):.1f}), "
          f"device {(fused['beam_profile'] or {}).get('device_ms_per_token', float('nan')):.3f} "
          f"ms/step (default {beam_prof.get('device_ms_per_token', float('nan')):.3f})",
          flush=True)

    def prenorm_entry(name, source, counted, case, at, ms_key="ms", errs=None):
        rows = [r for r in prenorm_rows if r["case"] == case]
        return dict(name=name, route="cuda", source=source,
                    replaces="autogptq_tpu/ops/pallas/gemm.py:332", launches=counted.get(name, 0),
                    replayed=replayed(counted, name),
                    max_abs_err=max(errs or [r["max_abs_err"] for r in prenorm_rows
                                             if NORM_KEY[r["route"]] == name]),
                    ms=prenorm_m[case][ms_key],
                    **{key: prenorm_m[case][key] for key in ("plain_ms", "bound_ms", "library_ms")},
                    bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                              else "operations"),
                    at=at + "; library: F.rms_norm + torch.matmul on a pre-dequantized weight of "
                    "the activation type; max_abs_err over every case of this kernel")

    k10_g128 = [r for r in k10_rows if r["bits"] == 4 and r["group_size"] == 128
                and not r["desc_act"] and r.get("layout") != "kb32l"]
    kb32l_t = {r["M"]: r for r in k10_rows if r.get("layout") == "kb32l"}
    print("K10 over kb32l words, one Llama-2-7B gate/up call (K 4096, N 11008), 4-bit g128, bf16: "
          + "; ".join(f"M = {m}: {r['kernel']} {r['ms']:.4f} ms"
                      + (f", K1's wgmma K10 on the same weights {r['k1_ms']:.4f} ms "
                         f"({r['ms'] / r['k1_ms']:.3f}x, within 10%: "
                         f"{'met' if r['within_10pct_of_k1'] else 'NOT MET'})" if "k1_ms" in r
                         else "")
                      + (f", the mma.sync K10 {r['mma_ms']:.4f} ms" if "mma_ms" in r else "")
                      + f", torch.matmul {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
                      for m, r in kb32l_t.items()), flush=True)
    k10_m16 = {m: {key: layer_sum(k10_g128, key, m)
                   for key in ("ms", "mma_ms", "simt_ms", "library_ms", "bound_ms")}
               for m in (10, 16)}
    print("K10 (bf16 cotangents, 4-bit g128), one Llama-2-7B layer's 7 projections: " + "; ".join(
          f"M = {m}: the decode regime {v['ms']:.4f} ms, the tile K10 {v['mma_ms']:.4f} ms, the "
          f"SIMT kernel {v['simt_ms']:.4f} ms, torch.matmul {v['library_ms']:.4f} ms, bound "
          f"{v['bound_ms']:.4f} ms" for m, v in k10_m16.items()), flush=True)
    # the wgmma/TMA tile kernels against the mma.sync ones on the same weights, per layer:
    # faster at M = 128 and at a training step's M (else the run fails; each call was already
    # held to it), the target of at most half the mma.sync kernel's time at the training step's M reported
    tile_m = {(what, m): {key: layer_sum(rows, key, m) for key in
                          ("ms", "mma_ms", "simt_ms", "library_ms", "bound_ms")}
              for what, rows in (("forward", k1_rows), ("K10", k10_g128)) for m in (128, TRAIN_M)}
    for v in tile_m.values():
        v["half_of_mma_met"] = v["ms"] <= 0.5 * v["mma_ms"]
    print("wgmma/TMA tile kernels, one Llama-2-7B layer's 7 projections, 4-bit g128, bf16: "
          + "; ".join(f"{what} M = {m}: {v['ms']:.4f} ms, mma.sync {v['mma_ms']:.4f} ms "
                      f"({v['ms'] / v['mma_ms']:.3f}x"
                      + (f", at most half: {'met' if v['half_of_mma_met'] else 'NOT MET'}"
                         if m == TRAIN_M else "")
                      + f"), SIMT {v['simt_ms']:.4f} ms, torch.matmul {v['library_ms']:.4f} ms, "
                      f"bound {v['bound_ms']:.4f} ms" for (what, m), v in tile_m.items()),
          flush=True)
    for (what, m), v in tile_m.items():
        check(v["ms"] < v["mma_ms"], f"the wgmma {what} at M = {m}: {v['ms']:.4f} ms per layer "
                                     f"against the mma.sync kernel's {v['mma_ms']:.4f} ms")
    # K6's tile regime on the wgmma/TMA kernel against K1's on the same weights, per layer
    k6_tile = {m: {key: layer_sum(k6_bf16, key, m) for key in
                   ("ms", "k1_ms", "mma_ms", "library_ms", "bound_ms")
                   + (("simt_ms",) if m != TRAIN_M else ())}
               for m in (128, TRAIN_M)}
    for v in k6_tile.values():
        v["within_10pct_of_k1"] = v["ms"] <= (1 + WITHIN) * v["k1_ms"]
    print("K6's tile regime, one Llama-2-7B layer's 7 projections over kb32l words, 4-bit g128, "
          "bf16: " + "; ".join(
              f"M = {m}: the wgmma/TMA kernel {v['ms']:.4f} ms, K1's wgmma kernel on the same "
              f"weights {v['k1_ms']:.4f} ms ({v['ms'] / v['k1_ms']:.3f}x, within 10%: "
              f"{'met' if v['within_10pct_of_k1'] else 'NOT MET'}), the mma.sync kernel "
              f"{v['mma_ms']:.4f} ms, " + (f"SIMT {v['simt_ms']:.4f} ms, " if "simt_ms" in v
                                           else "") + f"torch.matmul "
              f"{v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms"
              for m, v in k6_tile.items()), flush=True)
    k9_layer = {p: {key: mixtral_layer_sum(k9_rows, key, p) for key in
                    ("ms", "selected_only_ms", "simt_ms", "bound_ms", "library_ms")}
                for p in K9_SELS}
    print("one Mixtral-8x7B layer's gate, up and down, bf16: " + "; ".join(
        f"P = {p}: K9's GEMV {v['ms']:.4f} ms (over a stack of the selected experts alone "
        f"{v['selected_only_ms']:.4f} ms), the SIMT routed kernel {v['simt_ms']:.4f} ms, "
        f"{p} x torch.matmul "
        f"{v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms" for p, v in k9_layer.items()),
        flush=True)

    at = "one Llama-2-7B decoder layer's 7 projections at M=1, g128"
    simt_at = (at + "; the SIMT kernels (split-K GEMV, with its reduce, and SIMT tile kernel) "
               "of the library, timed beside the tensor-core GEMV on the same weights (they "
               "run f32 activations, and at M <= 16 the group sizes 16 does not divide); "
               "launches from ")
    kernels = [
        dict(gemm_entry("w4a16_gemm_gemv", "autogptq_tpu/ops/pallas/gemm.py:487", launches,
                        k1_rows,
                        at + f"; K1's tensor-core decode GEMV, bf16 (replaces the decode regime "
                        f"of _kernel_kb32 :487, _kernel_ki32 :414 and _kernel_kpair :255); "
                        f"launches from the {NEW_TOKENS}-token greedy run (int8_launches: the "
                        f"int8 greedy run, 224 per token; serving_launches: the paged serving "
                        f"engine's run, 224 per step at M = {SERVE_SLOTS}); max_abs_err over "
                        f"every K1 GEMV case", source=GEMV_SOURCE,
                        errs=[r["max_abs_err"] for r in k1_rows if r["route"] == "gemv"]
                        + [r["max_abs_err"] for r in wna_rows
                           if r["kernel"] == "w4a16_gemm_gemv"]),
             int8_launches=int8["counts"].get("w4a16_gemm_gemv", 0),
             serving_launches=serving["counts"].get("w4a16_gemm_gemv", 0),
             slot_serving_launches=slot["counts"].get("w4a16_gemm_gemv", 0)),
        gemm_entry("w8a16_gemm_gemv", "autogptq_tpu/ops/pallas/gemm.py:46", widths[8]["counts"],
                   width_rows(8), at + "; K4's tensor-core decode GEMV, bf16 (replaces the "
                   "decode regime of the planar _kernel :46); launches from the 64-token 8-bit "
                   "greedy run at 8 layers", source=GEMV_SOURCE,
                   errs=[r["max_abs_err"] for r in wna_rows if r["kernel"] == "w8a16_gemm_gemv"]),
        gemm_entry("w2a16_gemm_gemv", "autogptq_tpu/ops/pallas/gemm.py:1061", widths[2]["counts"],
                   width_rows(2), at + "; K5's tensor-core decode GEMV, bf16 (replaces the "
                   "decode regime of _kernel_k2i32 :1061); launches from the 64-token 2-bit "
                   "greedy run at 8 layers", source=GEMV_SOURCE,
                   errs=[r["max_abs_err"] for r in wna_rows if r["kernel"] == "w2a16_gemm_gemv"]),
        gemm_entry("w4a16_gemm", "autogptq_tpu/ops/pallas/gemm.py:487",
                   cpu_vs_card["launches"]["card f32"], k1_rows,
                   simt_at + "the f32 forwards of the 2-layer card-vs-CPU cut", ms_key="simt_ms",
                   errs=[r["max_abs_err"] for r in k1_rows if r["route"] == "simt"]
                   + [r["simt_max_abs_err"] for r in k1_rows if "simt_ms" in r]),
        gemm_entry("w8a16_gemm", "autogptq_tpu/ops/pallas/gemm.py:46",
                   quantize["8-bit g128"]["launches"], width_rows(8),
                   simt_at + "the f32 re-forward of quantize at 8 bits", ms_key="simt_ms",
                   errs=[r["max_abs_err"] for r in wna_rows + rest_rows
                         if r["kernel"] == "w8a16_gemm"]
                   + [r["simt_max_abs_err"] for r in wna_rows
                      if "simt_ms" in r and r["bits"] == 8]),
        gemm_entry("w2a16_gemm", "autogptq_tpu/ops/pallas/gemm.py:1061",
                   quantize["2-bit g128"]["launches"], width_rows(2),
                   simt_at + "the f32 re-forward of quantize at 2 bits", ms_key="simt_ms",
                   errs=[r["max_abs_err"] for r in wna_rows + rest_rows
                         if r["kernel"] == "w2a16_gemm"]
                   + [r["simt_max_abs_err"] for r in wna_rows
                      if "simt_ms" in r and r["bits"] == 2]),
        gemm_entry("wna16_gemm_t", "autogptq_tpu/ops/pallas/gemm.py:844",
                   grads["LoRA"]["card f32 backward_launches"], k10_g128,
                   f"the SIMT kernel: one Llama-2-7B decoder layer's 7 projections at M="
                   f"{TRAIN_M}, 4-bit g128, bf16 cotangents, timed beside the tensor-core kernel "
                   f"on the same weights (it runs f32 cotangents); launches from the f32 LoRA "
                   f"backward of the 2-layer gradient check; max_abs_err over every SIMT K10 "
                   f"case",
                   m=TRAIN_M, ms_key="simt_ms",
                   errs=[r["max_abs_err"] for r in k10_rows if r["route"] == "simt"]
                   + [r["simt_max_abs_err"] for r in k10_rows if "simt_ms" in r]),
        gemm_entry("wna16_gemm_t_wgmma", "autogptq_tpu/ops/pallas/gemm.py:811",
                   train["launches_per_step"], k10_g128,
                   f"the wgmma/TMA K10: one Llama-2-7B decoder layer's 7 projections at M="
                   f"{TRAIN_M} (a {TRAIN_BATCH} x {TRAIN_LEN} batch), 4-bit g128, bf16 "
                   f"cotangents (replaces _kernel_kb32_t :811, _kernel_ki32_t :1031 and "
                   f"_kernel_kpair_t :1289 above 16 rows); launches from one LoRA training step "
                   f"at full depth; max_abs_err over every wgmma K10 case", m=TRAIN_M,
                   source=WGMMA_SOURCE,
                   errs=[r["max_abs_err"] for r in k10_rows if r["route"] == "wgmma"
                         and r.get("layout") != "kb32l"]
                   + [r["max_abs_err"] for r in rest_rows if r["kernel"] == "wna16_gemm_t_wgmma"]),
        gemm_entry("w4a16_gemm_wgmma", "autogptq_tpu/ops/pallas/gemm.py:487",
                   train["launches_per_step"], k1_rows,
                   f"K1's wgmma/TMA tile kernel: one Llama-2-7B decoder layer's 7 projections at "
                   f"M={TRAIN_M}, g128, bf16 (replaces the prefill regime of _kernel_kb32 :487, "
                   f"_kernel_ki32 :414 and _kernel_kpair :255); launches from one LoRA training "
                   f"step at full depth; max_abs_err over every K1 case it ran", m=TRAIN_M,
                   source=WGMMA_SOURCE,
                   errs=[r["max_abs_err"] for r in k1_rows if r["route"] == "wgmma"]
                   + [r["max_abs_err"] for r in rest_rows if r["kernel"] == "w4a16_gemm_wgmma"]
                   + [r["max_abs_err"] for r in wna_rows if r["kernel"] == "w4a16_gemm_wgmma"]),
        gemm_entry("w8a16_gemm_wgmma", "autogptq_tpu/ops/pallas/gemm.py:46",
                   widths[8]["batch2_counts"], width_rows(8), "K4's wgmma/TMA tile kernel: one "
                   "Llama-2-7B decoder layer's 7 projections at M=128, g128, bf16; launches from "
                   "the 8-bit batch-2 run's 32-row prefill at 8 layers", m=128,
                   source=WGMMA_SOURCE,
                   errs=[r["max_abs_err"] for r in wna_rows + rest_rows
                         if r["kernel"] == "w8a16_gemm_wgmma"]),
        gemm_entry("w2a16_gemm_wgmma", "autogptq_tpu/ops/pallas/gemm.py:1061",
                   widths[2]["batch2_counts"], width_rows(2), "K5's wgmma/TMA tile kernel: one "
                   "Llama-2-7B decoder layer's 7 projections at M=128, g128, bf16; launches from "
                   "the 2-bit batch-2 run's 32-row prefill at 8 layers", m=128,
                   source=WGMMA_SOURCE,
                   errs=[r["max_abs_err"] for r in wna_rows + rest_rows
                         if r["kernel"] == "w2a16_gemm_wgmma"]),
        gemm_entry("wna16_gemm_t_mma", "autogptq_tpu/ops/pallas/gemm.py:811",
                   rest_path["cut_launches"][GRAD_LEN]["tile"], k10_g128,
                   f"the mma.sync tile K10, timed beside the wgmma K10 on the same weights: one "
                   f"Llama-2-7B decoder layer's 7 projections at M={TRAIN_M}, 4-bit g128, bf16 "
                   f"cotangents; launches from the 1 x {GRAD_LEN} LoRA backward of the g100 "
                   f"2-layer cut forced through it (kernel='mma'); max_abs_err over every case "
                   f"it ran", m=TRAIN_M, source=MMA_SOURCE,
                   ms_key="mma_ms",
                   errs=[r["mma_max_abs_err"] for r in k10_rows if "mma_ms" in r]
                   + [r["mma_max_abs_err"] for r in rest_rows if "mma_ms" in r
                      and r["what"] == "K10"]),
        gemm_entry("w4a16_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:487",
                   rest_path["cut_launches"][GRAD_LEN]["tile"], k1_rows,
                   f"the mma.sync tile kernel, timed beside the wgmma kernel on the same "
                   f"weights: one Llama-2-7B decoder layer's 7 projections at M={TRAIN_M}, g128, "
                   f"bf16; launches from the 1 x {GRAD_LEN} LoRA forward of the g100 2-layer cut "
                   f"forced through it (kernel='mma'); max_abs_err over every K1 case it ran",
                   m=TRAIN_M, source=MMA_SOURCE, ms_key="mma_ms",
                   errs=[r["mma_max_abs_err"] for r in k1_rows if "mma_ms" in r]
                   + [r["mma_max_abs_err"] for r in rest_rows if "mma_ms" in r
                      and r["what"] == "forward"]),
        gemm_entry("wna16_gemm_t_gemv", "autogptq_tpu/ops/pallas/gemm.py:811",
                   rest_path["small_step"]["launches"][None], k10_g128,
                   "K10's split-N decode regime: one Llama-2-7B decoder layer's 7 projections at "
                   "M=16, 4-bit g128, bf16 cotangents (replaces the small-M regime of "
                   "_kernel_kb32_t :811, _kernel_ki32_t :1031 and _kernel_kpair_t :1289); "
                   "launches from the 1 x 16-token LoRA step of the 8-layer 4-bit g100 model; "
                   "max_abs_err over every case of the decode regime",
                   m=16, source="autogptq_tpu_torch/ops/csrc/wna16_gemv_t.cuh",
                   errs=[r["max_abs_err"] for r in k10_rows if r["route"] == "gemv"]
                   + [r["max_abs_err"] for r in rest_rows if r["kernel"] == "wna16_gemm_t_gemv"]),
        gemm_entry("w8a16_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:46", widths[8]["mma_counts"],
                   width_rows(8), "K4's mma.sync tile kernel, timed beside the wgmma "
                   "kernel: one Llama-2-7B decoder layer's 7 projections at M=128, g128, bf16; "
                   "launches from the 8-bit batch-2 prefill at 8 layers forced through it "
                   "(kernel='mma')", m=128, source=MMA_SOURCE, ms_key="mma_ms",
                   errs=[r["mma_max_abs_err"] for r in wna_rows + rest_rows
                         if "mma_ms" in r and r["bits"] == 8]),
        gemm_entry("w2a16_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:1061",
                   widths[2]["mma_counts"], width_rows(2), "K5's mma.sync tile kernel, "
                   "timed beside the wgmma kernel: one Llama-2-7B decoder layer's 7 projections "
                   "at M=128, g128, bf16; launches from the 2-bit batch-2 prefill at 8 layers "
                   "forced through it (kernel='mma')", m=128, source=MMA_SOURCE, ms_key="mma_ms",
                   errs=[r["mma_max_abs_err"] for r in wna_rows + rest_rows
                         if "mma_ms" in r and r["bits"] == 2]),
        gemm_entry("w4a16_kb32l_gemm_wgmma", "autogptq_tpu/ops/pallas/gemm.py:635",
                   kb32l["batch2_counts"], k6_bf16,
                   f"K6's tile regime, the wgmma/TMA kernel over the kb32l tiles' 3-D map: one "
                   f"Llama-2-7B decoder layer's 7 projections at M={TRAIN_M}, g128, bf16 "
                   f"(replaces _matmul_kb32l :635, _kernel_kb32 with lin=True, above 16 rows); "
                   f"launches from the kb32l batch-2 run's 32-row prefill; max_abs_err over "
                   f"every K6 case it ran", m=TRAIN_M, source=WGMMA_SOURCE,
                   errs=[r["max_abs_err"] for r in k6["rows"] if r["route"] == "wgmma"]),
        gemm_entry("w4a16_kb32l_gemm_mma", "autogptq_tpu/ops/pallas/gemm.py:635",
                   kb32l["mma_counts"], k6_bf16,
                   f"K6's mma.sync tile kernel over kb32l words, timed beside the wgmma kernel on "
                   f"the same words: one Llama-2-7B decoder layer's 7 projections at M={TRAIN_M}, "
                   f"g128, bf16; launches from the kb32l batch-2 prefill forced through it "
                   f"(kernel='mma'); max_abs_err over every K6 case it ran", m=TRAIN_M,
                   source=MMA_SOURCE, ms_key="mma_ms",
                   errs=[r["mma_max_abs_err"] for r in k6["rows"] if "mma_max_abs_err" in r]),
        dict(name=gemm.KB32L_T_WGMMA, route="cuda", source=WGMMA_SOURCE,
             replaces="autogptq_tpu/ops/pallas/gemm.py:811",
             launches=kb32l["train"]["counts"].get(gemm.KB32L_T_WGMMA, 0),
             replayed=replayed(kb32l["train"]["counts"], gemm.KB32L_T_WGMMA),
             max_abs_err=max(r["max_abs_err"] for r in kb32l_t.values() if r["route"] == "wgmma"),
             **{key: kb32l_t[TRAIN_M][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms")},
             at=f"K10 over kb32l words on the wgmma/TMA K10 (the tiles' 3-D map with K10's box): "
                f"one Llama-2-7B gate/up call at M={TRAIN_M}, 4-bit g128, bf16 cotangents "
                f"(replaces _kernel_kb32_t :811 for a kb32l layer's backward above 16 rows; "
                f"JAX's kb32l backward is XLA); launches from one LoRA step of the {TRAIN_BATCH} "
                f"x {TRAIN_LEN} batch on the model loaded with layout='kb32l'; max_abs_err over "
                f"every case it ran"),
        dict(entry("flash_decode", "autogptq_tpu_torch/ops/csrc/flash_decode.cu",
                   "autogptq_tpu/ops/pallas/flash_decode.py:62", launches,
                   k2_rows + k2_engine_rows, k2_main,
                   "one layer, B=1, H=Hkv=32, D=128, 528 live slots, bf16 cache; "
                   "slot_serving_launches: the slot engine's run, 32 per step; engine_rows: "
                   f"one layer at the slot engine's per-row bounds (B={SERVE_SLOTS}, "
                   f"S={SLOT_SEQ})"),
             slot_serving_launches=slot["counts"].get("flash_decode", 0),
             engine_rows={key: k2_engine_rows[0][key] for key in
                          ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                           "max_abs_err")}),
        dict(entry("paged_attention_mh", "autogptq_tpu_torch/ops/csrc/paged_attn.cu",
                   "autogptq_tpu/ops/pallas/paged_attn.py:45", beam_launches, k7_rows, k7_main,
                   "one layer, beam 4: B=4, H=Hkv=32, D=128, page 16, 528 live slots per row, "
                   "bf16 pools; launches from the 512-token beam-4 run (serving_launches: the "
                   "paged serving engine's run, 32 per step)"),
             serving_launches=serving["counts"].get("paged_attention_mh", 0)),
        dict(entry("rope_write_kv", "autogptq_tpu_torch/ops/csrc/page_ops.cu",
                   "autogptq_tpu/ops/pallas/paged_attn.py:252", launches, k8a_fused_rows,
                   k8a_main, "K8a's kv_write_kernel with the rotation on: one Llama-2-7B "
                   "layer's RoPE of q and k and K/V write at the device cursor, q [1, 32, 128], "
                   "k/v [1, 32, 128] bf16 into the [32, 1, 528, 32, 128] cache at slot 527 (the "
                   "greedy main path's last step); no one PyTorch call turns and writes "
                   "(write_only_ms: the write alone by two index_copy_); max_abs_err over the "
                   "bf16 q and K of every fused case (int8 codes within one, counted in "
                   "k8a_fused); launches from the 512-token greedy run, one per layer and "
                   "decode step"),
             beam_launches=beam_launches.get("rope_write_kv", 0),
             beam_replayed=replayed(beam_launches, "rope_write_kv"),
             int8_launches=int8["counts"].get("rope_write_kv", 0),
             serving_launches=serving["counts"].get("rope_write_kv", 0),
             slot_serving_launches=slot["counts"].get("rope_write_kv", 0),
             slot_serving_replayed=replayed(slot["counts"], "rope_write_kv"),
             int8_ms=k8a_int8["ms"], int8_plain_ms=k8a_int8["plain_ms"],
             int8_bound_ms=k8a_int8["bound_ms"],
             write_only_ms=k8a_main["write_only_ms"],
             per_row={r["case"]: {key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                                          "bound_ms", "bound_by", "max_abs_err")}
                      for r in k8a_row_rows}),
        dict(entry("copy_pages_pair", "autogptq_tpu_torch/ops/csrc/page_ops.cu",
                   "autogptq_tpu/ops/pallas/paged_attn.py:316", beam_launches, k8b_rows,
                   k8b_main, "K8b's copy_pages_cluster_kernel: 4 pages (3 moving, one "
                   "self-copy) x 32 layers x 2 bf16 pools (one beam-4 step), one cluster of 8 "
                   "blocks per (layer, pool), check=False as on the beam path; bound from the "
                   "moving pages' bytes; two_kernel_ms: the gather and scatter kernels on the same "
                   "copies; launches from the 512-token beam-4 run"),
             two_kernel_ms=k8b_main["two_kernel_ms"]),
        gemm_entry("w4a16_kb32l_gemm_gemv", "autogptq_tpu/ops/pallas/gemm.py:692",
                   kb32l["counts"], k6_bf16, at + "; K6's tensor-core GEMV over the "
                   f"tile-contiguous kb32l words, bf16 (replaces _kernel_kb32l_manual :692); "
                   f"launches from the {KB32L_NEW_TOKENS}-token greedy run of the model loaded "
                   f"with layout='kb32l'; max_abs_err over every K6 GEMV case",
                   source="autogptq_tpu_torch/ops/csrc/w4a16_kb32l_gemm.cu",
                   errs=[r["max_abs_err"] for r in k6["rows"] if r["route"] == "gemv"]),
        gemm_entry("w4a16_kb32l_gemm", "autogptq_tpu/ops/pallas/gemm.py:692",
                   kb32l_cut["card launches"], k6_bf16, at + "; K6's cp.async ring over the "
                   f"kb32l words (f32 activations, and its SIMT tile kernel above 16 rows), timed "
                   f"on the bf16 operands beside the GEMV (kernel='simt'); launches from the f32 "
                   f"forwards of the kb32l 2-layer card-vs-CPU cut; max_abs_err over every K6 "
                   f"case of the ring and the SIMT tile kernel", ms_key="simt_ms",
                   errs=[r["max_abs_err"] for r in k6["rows"] if r["route"] == "simt"]
                   + [r["simt_max_abs_err"] for r in k6["rows"] if "simt_ms" in r]),
        dict(name="w4a16_routed_gemm_gemv", route="cuda",
             source="autogptq_tpu_torch/ops/csrc/w4a16_routed_gemm.cu",
             replaces="autogptq_tpu/ops/pallas/gemm.py:894",
             launches=mixtral["counts"].get("w4a16_routed_gemm_gemv", 0),
             replayed=replayed(mixtral["counts"], "w4a16_routed_gemm_gemv"),
             max_abs_err=max(r["max_abs_err"] for r in k9_rows),
             **{key: mixtral_layer_sum(k9_rows, key) for key in
                ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in k9_rows if r["P"] == 2)
                       else "operations"),
             at=f"K9's expert-major tensor-core GEMV: one Mixtral-8x7B layer's 3 expert "
                f"projections at P=2 (batch-1 decode, top-2 of 8), g128, bf16; library: 2 "
                f"torch.matmul per call on pre-dequantized bf16 experts; launches from the "
                f"{MIXTRAL_NEW_TOKENS}-token greedy run at {MIXTRAL_LAYERS} layers; max_abs_err "
                f"over every K9 GEMV case"),
        dict(name="w4a16_routed_gemm", route="cuda",
             source="autogptq_tpu_torch/ops/csrc/w4a16_routed_gemm.cu",
             replaces="autogptq_tpu/ops/pallas/gemm.py:894",
             launches=mixtral_cut["routed_grad"]["launches"].get("w4a16_routed_gemm", 0),
             replayed=replayed(mixtral_cut["routed_grad"]["launches"], "w4a16_routed_gemm"),
             max_abs_err=max(r["simt_max_abs_err"] for r in k9_rows),
             ms=mixtral_layer_sum(k9_rows, "simt_ms"),
             **{key: mixtral_layer_sum(k9_rows, key) for key in
                ("plain_ms", "bound_ms", "library_ms")},
             bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in k9_rows if r["P"] == 2)
                       else "operations"),
             at=f"K9's SIMT routed kernel and its reduce (f32 activations, the group sizes 16 "
                f"does not divide): one Mixtral-8x7B layer's 3 expert projections at P=2, g128, "
                f"bf16, timed beside the GEMV on the same operands (kernel='simt'); launches "
                f"from the f32 routed moe_mlp gradient check of the 2-layer Mixtral cut; "
                f"max_abs_err over every K9 case it ran in bf16"),
        prenorm_entry("w4a16_gemm_gemv_norm", GEMV_SOURCE, fused["counts"], "M=1 bf16",
                      "K1's fused RMS-norm prologue (replaces _prenorm_x :332 inside _kernel_kb32 "
                      ":487 and _kernel_ki32 :349) in the tensor-core decode GEMV: one Llama-2-7B "
                      "layer's q/k/v and gate/up at M=1, g128, bf16; launches from the "
                      f"{FUSED_NEW_TOKENS}-token greedy run with AUTOGPTQ_TPU_FUSE_NORM=1"),
        prenorm_entry("w4a16_gemm_wgmma_norm", WGMMA_SOURCE, fused["batch_counts"], "M=24 bf16",
                      "K1's fused RMS-norm prologue in the wgmma/TMA tile kernel (17-31 rows): "
                      "one Llama-2-7B layer's q/k/v and gate/up at M=24, g128, bf16; launches "
                      f"from the bf16 batch-{FUSED_BATCH} greedy run with the switch on"),
        prenorm_entry("w4a16_gemm_mma_norm", MMA_SOURCE, fused["mma_batch_counts"], "M=24 bf16",
                      "K1's fused RMS-norm prologue in the mma.sync tile kernel, timed beside the "
                      "wgmma one on the same operands: one Llama-2-7B layer's q/k/v and gate/up "
                      f"at M=24, g128, bf16; launches from 2 tokens of the bf16 batch-"
                      f"{FUSED_BATCH} run forced through it (kernel='mma')", ms_key="mma_ms",
                      errs=[r["mma_max_abs_err"] for r in prenorm_rows
                            if "mma_max_abs_err" in r]),
        dict(name=gemm.RSTD_KERNEL, route="cuda", source=WGMMA_SOURCE,
             replaces="autogptq_tpu/ops/pallas/gemm.py:332",
             launches=sum(c.get(gemm.RSTD_KERNEL, 0) for c in (
                 fused["counts"], fused["batch_counts"], fused["batch16_counts"])),
             replayed=sum(replayed(c, gemm.RSTD_KERNEL) for c in (
                 fused["counts"], fused["batch_counts"], fused["batch16_counts"])),
             max_abs_err=max(r["rstd_max_abs_err"] for r in prenorm_rows
                             if "rstd_max_abs_err" in r),
             ms=prenorm_m["M=16 bf16"]["rstd_ms"],
             plain_ms=prenorm_m["M=16 bf16"]["rstd_plain_ms"],
             bound_ms=prenorm_m["M=16 bf16"]["rstd_bound_ms"],
             bound_by=("bytes" if all(r["rstd_bound_by"] == "bytes" for r in prenorm_rows
                                      if "rstd_bound_by" in r) else "operations"),
             library_ms=None,
             **{f"ms_{case.split()[0]}": prenorm_m[case]["rstd_ms"] for case in RSTD_TIMED_CASES},
             at=f"the rows' rstd of the fused prologue (wg_rstd_kernel; the rsqrt(mean(x^2) + "
                f"eps) of _prenorm_x :332), launched just before each w4a16_gemm_wgmma_norm and, "
                f"by w4a16_gemm_gemv_norm's entry, each fused GEMV that takes it: one "
                f"Llama-2-7B layer's q/k/v and gate/up at M=16, bf16 (5 calls; ms_M=1, ms_M=16 "
                f"and ms_M=24 the same at those rows); plain: "
                f"torch.rsqrt(x.float().pow(2).mean(-1) + eps) on the card; no single PyTorch "
                f"call computes it; launches from the {FUSED_NEW_TOKENS}-token fused greedy run, "
                f"the bf16 batch-{FUSED_BATCH} and batch-{FUSED_BATCH16} greedy runs with the "
                f"switch on; max_abs_err over every bf16 and f16 prologue case"),
        prenorm_entry("w4a16_gemm_norm", "autogptq_tpu_torch/ops/csrc/wna16_gemm.cuh",
                      fused_cut["launches"]["card"], "M=1 f32",
                      "K1's fused RMS-norm prologue in the SIMT GEMV (f32 activations; the SIMT "
                      "tile kernel above 16 rows): one Llama-2-7B layer's q/k/v and gate/up at "
                      "M=1, g128, f32; launches from the f32 2-layer card-vs-CPU cut with the "
                      "switch on (batch 1 and 24)"),
    ]
    for e in kernels:   # every kernel of the line ran on its path
        check(e["launches"] > 0, f"{e['name']} was launched no time on its path: {e['at']}")
    elapsed = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, device=torch.cuda.get_device_name(0), build_s=seconds,
                       k1=k1_rows, k9=k9_rows, k6=k6, kb32l=kb32l, kb32l_cut=kb32l_cut,
                       mixtral=mixtral, mixtral_cut=mixtral_cut,
                       wna16=wna_rows, rest=rest_rows, mma_ptxas=ptxas,
                       wgmma_ptxas=wgmma_regs, other_widths=widths,
                       quantize=quantize, main_batch2=batch2_launches,
                       k2=k2_rows, k7=k7_rows, k8a=k8a_rows, k8a_fused=k8a_fused_rows,
                       k8b=k8b_rows, k10=k10_rows,
                       k9_rest=k9_rest_rows,
                       attention_ptxas=attn_ptxas, page_ops_ptxas=page_regs,
                       attention_full_run=full_run,
                       decode_layer_ms=decode_m, engine_k1_layer_ms=engine_k1,
                       k9_layer_ms=k9_layer, k10_m16_layer_ms=k10_m16,
                       k6_tile_layer_ms=k6_tile, kb32l_t_call_ms=kb32l_t,
                       gemv_norm_layer_ms=gemv_norm,
                       tile_layer_ms={f"{what} M={m}": v for (what, m), v in tile_m.items()},
                       main_path=launches, main_routes=main_routes, gemv_ptxas=gemv_regs,
                       beam=beam, train=train, grads=grads,
                       cpu_vs_card=cpu_vs_card, phase_s=phase_s, boundary_us=boundary,
                       prenorm=prenorm_rows, prenorm_layer_ms=prenorm_m,
                       prenorm_ptxas=prenorm_regs, fused=fused, fused_cut=fused_cut,
                       rest_path=rest_path, graph_turns=turns, int8_greedy=int8,
                       serving=serving, serving_cut=serving_cut,
                       k8a_rows=k8a_row_rows, k2_engine_rows=k2_engine_rows,
                       slot_serving={k: v for k, v in slot.items() if k not in ("out", "reqs")},
                       speculative=spec, slot_cut=slot_cut,
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
