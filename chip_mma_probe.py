#!/usr/bin/env python3
"""Design probe of the port's tensor-core tile kernels on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_mma_probe.py`` (one card,
about three minutes on an H100). It imports nothing of JAX or of the
``autogptq_tpu`` package. It builds variants of
``autogptq_tpu_torch/ops/csrc/wna16_mma.cuh`` by text substitution, each into
its own library under ``build/chip_mma_probe/``:

* ``as is``: the kernels as the port ships them;
* ``K10 unsplit``: K10 with the scaled weight rounded once to bf16 (one MMA per
  fragment, ``TM_SPLIT = 1``) instead of the hi/lo pair;
* ``forward, no dequant`` / ``K10, no dequant``: the codes are not decoded
  (the forward feeds the raw words to the MMA, K10 skips filling its B tile):
  wrong results, timed only, to show what the MMA loop alone costs.

It times each at one Llama-2-7B decoder layer's 7 projections (4-bit g128, bf16,
M = 128 and 2048, CUDA events, L2 flushed) beside ``torch.matmul`` on a
pre-dequantized bf16 weight and the bound, and holds the ``as is`` and ``K10
unsplit`` kernels against the plain versions (relative Frobenius error against
f32). Then it trains LoRA (r 16 on q_proj and v_proj, AdamW lr 1e-3, one random
4 x 512-token batch, the loss of ``chip_smoke.py``) on a random full-depth 4-bit
Llama-2-7B for 8 steps three times: through the shipped kernels, with K10
unsplit, and through the SIMT kernels, and prints each run's losses. The card's
name and power limit come first; everything also goes to
``build/chip_mma_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LAYERS = 32
STEPS = 8


def variants(src: str) -> dict:
    """The header texts of the probed variants."""
    def sub(text, old, new):
        assert old in text, old
        return text.replace(old, new)

    nodeq_fwd, n = re.subn(
        r"const uint32_t b0 = Mma<T>::pack\(.*?\);\n\s*const uint32_t b1 = Mma<T>::pack\(.*?\);",
        "const uint32_t b0 = w0 ^ (uint32_t)zb, b1 = w1;", src, flags=re.S)
    assert n == 1
    return {
        "as is": src,
        "K10 unsplit": sub(src, "constexpr int TM_SPLIT = 2;", "constexpr int TM_SPLIT = 1;"),
        "forward, no dequant": nodeq_fwd,
        "K10, no dequant": sub(src, "for (int it = part; it < ITERS; it += TM_BR / 16) {",
                               "for (int it = part; it < 0; it += TM_BR / 16) {"),
    }


def build_variants(build) -> dict:
    """Compile each variant's K1 and K10 libraries (all at once); their CDLLs."""
    out_dir = os.path.join(ROOT, "build", "chip_mma_probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    src = (build.CSRC / "wna16_mma.cuh").read_text()
    procs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        d = os.path.join(out_dir, f"v{i}")
        shutil.copytree(build.CSRC, d)
        with open(os.path.join(d, "wna16_mma.cuh"), "w") as f:
            f.write(text)
        for lib in ("w4a16_gemm", "wna16_gemm_t"):
            so = os.path.join(d, f"lib{lib}.so")
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", so, os.path.join(d, f"{lib}.cu")]
            procs[(name, lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, lib), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {lib}: nvcc failed\n{log[-4000:]}")
        cdll = ctypes.CDLL(so)
        err = getattr(cdll, f"{lib}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs.setdefault(name, {})[lib] = cdll
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mma_probe: torch.cuda.is_available() is false; this script needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin
    from autogptq_tpu_torch.utils import peft
    from autogptq_tpu_torch.utils.random_checkpoint import (LLAMA2_7B, random_quant_tensors,
                                                            write_random_checkpoint)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.build(("w4a16_gemm", "wna16_gemm_t"))
    shipped = {lib: build.load(lib) for lib in ("w4a16_gemm", "wna16_gemm_t")}
    libs = build_variants(build)
    print(f"variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    def use(name):   # route the wrappers' libraries to a variant
        for lib, cdll in libs[name].items():
            build._libs[lib] = cdll

    timer = cs.Timer(torch)
    out = {"card": card, "device": torch.cuda.get_device_name(0), "layer_ms": {}}
    layers = {}
    for case, (k, n, _) in cs.LAYER_SHAPES.items():
        t = random_quant_tensors(np.random.default_rng(k + n), k, n, 4, 128, False)
        layers[case] = qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=None, bits=4, group_size=128, in_features=k, out_features=n), device="cuda")
    for m in (128, cs.TRAIN_M):
        rows = {"torch.matmul": [0.0, 0.0], "bound": [0.0, 0.0]}
        errs = {}
        for case, (k, n, calls) in cs.LAYER_SHAPES.items():
            layer = layers[case]
            x = torch.randn((m, k), device="cuda", dtype=torch.bfloat16)
            g = torch.randn((m, n), device="cuda", dtype=torch.bfloat16)
            w = qlin.logical_weight(layer, torch.bfloat16)
            ref = qlin.matmul_plain(x.float(), layer)
            ref_t = gemm.wna16_matmul_t_ref(g.float(), layer.qweight, layer.scales, layer.zeros,
                                            None, 128, 4)
            rows["torch.matmul"][0] += calls * timer.ms(lambda: torch.matmul(x, w), iters=5)
            rows["torch.matmul"][1] += calls * timer.ms(lambda: torch.matmul(g, w.t()), iters=5)
            b_ms, _ = cs.bound_ms(cs.nbytes(x, layer.qweight, layer.scales, layer.zeros) + 2 * m * n,
                                  2.0 * m * k * n)
            rows["bound"][0] += calls * b_ms
            rows["bound"][1] += calls * b_ms
            for name in libs:
                use(name)
                y, dx = qlin.matmul(x, layer), qlin.matmul_t(g, layer)
                torch.cuda.synchronize()
                if "no dequant" not in name:
                    e = errs.setdefault(name, [0.0, 0.0])
                    e[0] = max(e[0], ((y.float() - ref).norm() / ref.norm()).item())
                    e[1] = max(e[1], ((dx.float() - ref_t).norm() / ref_t.norm()).item())
                r = rows.setdefault(name, [0.0, 0.0])
                r[0] += calls * timer.ms(lambda: qlin.matmul(x, layer), iters=5)
                r[1] += calls * timer.ms(lambda: qlin.matmul_t(g, layer), iters=5)
        build._libs.update(shipped)
        out["layer_ms"][m] = rows
        out.setdefault("rel_err_vs_f32", {})[m] = errs
        for name, (f_ms, t_ms) in rows.items():
            err = errs.get(name)
            print(f"M={m:4d} {name:20s} forward {f_ms:.4f} ms  K10 {t_ms:.4f} ms per layer"
                  + (f"  rel err vs f32: forward {err[0]:.3e} K10 {err[1]:.3e}" if err else ""),
                  flush=True)
    del timer

    path = os.path.join(ROOT, "build", "chip_mma_probe", "llama2-7b-random-g128")
    write_random_checkpoint(path, dict(LLAMA2_7B, num_hidden_layers=LAYERS), bits=4,
                            group_size=128, seed=0)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, LLAMA2_7B["vocab_size"], (cs.TRAIN_BATCH, cs.TRAIN_LEN))
    mask = np.ones_like(tokens)
    mask[1, :cs.TRAIN_PAD] = 0
    tokens[1, :cs.TRAIN_PAD] = 0
    labels = np.where(mask == 1, tokens, -100)
    tt, mt, lt = (torch.from_numpy(a).cuda() for a in (tokens, mask.astype(np.int32), labels))
    plan = gemm.tile_kernel
    out["losses"] = {}
    for label, lib, route in (("as is", "as is", None), ("K10 unsplit", "K10 unsplit", None),
                              ("SIMT kernels", "as is", "simt")):
        use(lib)
        gemm.tile_kernel = plan if route is None else (lambda d, kernel=None: route)
        model = AutoGPTQForCausalLM.from_quantized(path)
        peft.get_gptq_peft_model(model, peft.GPTQLoraConfig(
            r=cs.TRAIN_RANK, lora_alpha=2 * cs.TRAIN_RANK,
            target_modules=("attn.q_proj", "attn.v_proj")), seed=0)
        params = peft.trainable_tensors(peft.split_lora_params(model.params)[0])
        opt = torch.optim.AdamW(params, lr=cs.TRAIN_LR)
        losses = []
        for _ in range(STEPS):
            logits, _ = arch.forward(model.params, tt, model.cfg, attn_mask=mt, dtype=model.dtype)
            loss = cs.masked_loss(torch, logits, lt)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        out["losses"][label] = losses
        print(f"LoRA, {LAYERS} layers, {STEPS} AdamW steps, {label}: losses "
              + ", ".join(f"{v:.6f}" for v in losses), flush=True)
        del model, opt, params
        torch.cuda.empty_cache()
    gemm.tile_kernel = plan
    build._libs.update(shipped)
    shutil.rmtree(path, ignore_errors=True)
    with open(os.path.join(ROOT, "build", "chip_mma_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
