#!/usr/bin/env python3
"""Design probe of the port's wgmma/TMA tile kernels on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_wgmma_probe.py`` (one card,
about three minutes on an H100). It imports nothing of JAX or of the
``autogptq_tpu`` package. It builds variants of
``autogptq_tpu_torch/ops/csrc/wna16_wgmma.cuh`` by text substitution, each into
its own K1 and K10 libraries under ``build/chip_wgmma_probe/``:

* ``as is``: the kernels as the port ships them;
* ``no dequant``: the consumers skip the dequant of the words into the B tiles
  (wrong results, timed only): what the TMA ring and the wgmmas cost alone;
* ``no wgmma``: the consumers issue no wgmma (wrong results, timed only): what
  the ring and the dequant cost alone.

It times each, forward and K10, at one Llama-2-7B decoder layer's 7 projections
(4-bit g128, bf16, M = 17, 64, 128 and 2048; CUDA events, L2 flushed before each call),
beside the ``mma.sync`` kernels on the same weights, ``torch.matmul`` on a
pre-dequantized bf16 weight and the bound, and holds the ``as is`` kernels
against the plain versions. Then it trains LoRA (r 16 on q_proj and v_proj,
AdamW lr 1e-3, one random 4 x 512-token batch, the loss of ``chip_smoke.py``)
on a random full-depth 4-bit Llama-2-7B for 8 steps: as shipped (both
kernels carry the weight as a bf16 hi/lo pair), with the forward through PR
7's kernel (its exact q - z and f32 scale fold) and K10 as shipped, and with
both through the mma.sync kernels; it prints each run's losses. The card's name and power limit come
first; everything also goes to ``build/chip_wgmma_probe.json``.

``python3 chip_wgmma_probe.py --prenorm`` (about two minutes) probes K1's fused
RMS-norm prologue on the wgmma/TMA forward instead (``w4a16_gemm_wgmma_norm``),
with variants of the same header in K1's library under
``build/chip_wgmma_probe/``:

* ``as is``: as shipped (the rows' rstd launched before the product, which
  starts beside it by programmatic dependent launch, the x tiles normalized
  by the producer's three idle warps);
* ``no PDL``: the product launched in plain stream order after the rstd
  kernel, no ``griddepcontrol`` (results checked like ``as is``): what
  programmatic dependent launch saves;
* ``no normalize``: those warps leave the x tiles as they are (wrong results,
  timed only): what normalizing costs;
* ``no rstd launch``: no rstd launch (``gemm.prenorm_rstd`` launches nothing
  while it is timed) and no wait for it (wrong results, timed only): what the
  second launch costs;
* ``no normed wait``: the consumers do not wait for the normalized tile (wrong
  results, timed only): what that wait costs;
* ``no setmaxnreg``: every warp keeps the kernel's registers (the shipped
  instance, like the others, gives the producer warpgroup's up to 40, which
  its normalizing warps run within, and lets the consumers take 232); ptxas'
  registers and spills of each variant's prologue instances are printed.

It times each at one Llama-2-7B layer's q/k/v and gate/up (4-bit g128, bf16,
M = 17, 24 and 31) beside the same kernel alone on the normalized x, the
unfused pair (``rms_apply`` + that kernel) and the mma.sync prologue, holds the
``as is`` instance against ``rms_apply`` + the plain matmul, and writes
``build/chip_wgmma_probe_prenorm.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"qkvo": (4096, 4096, 4), "gate_up": (4096, 11008, 2), "down": (11008, 4096, 1)}
LIBS = ("w4a16_gemm", "wna16_gemm_t")


def variants(src: str) -> dict:
    """The header texts of the probed variants."""
    def sub(text, pairs):
        for old, new in pairs:
            assert old in text, old
            text = text.replace(old, new)
        return text

    return {
        "as is": src,
        "no dequant": sub(src, [("    auto dequant = [&](int tl) {\n",
                                 "    auto dequant = [&](int tl) {\n        if (tl >= 0) return;\n")]),
        "no wgmma": sub(src, [("                    Wgmma<T, NW>::run(acc[h], da + h * (8192 >> 4) + 2 * kk,\n"
                               "                                      db + b * (WG_BTILE_BYTES >> 4) + 2 * kk);",
                               "                    ;")]),
    }


def prenorm_variants(src: str) -> dict:
    """The header texts of the fused prologue's probed variants."""
    def sub(text, pairs):
        for old, new in pairs:
            assert old in text, old
            text = text.replace(old, new)
        return text

    return {
        "as is": src,
        "no PDL": sub(src, [("cfg.numAttrs = 1;", "cfg.numAttrs = 0;"),
                            ('asm volatile("griddepcontrol.wait;\\n" ::: "memory");', ""),
                            ('asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");',
                             "")]),
        "no normalize": sub(src, [("for (int r = nt >> 3; r < nrows;", "for (int r = nrows; r < nrows;")]),
        "no rstd launch": sub(src, [
            ('asm volatile("griddepcontrol.wait;\\n" ::: "memory");', "")]),
        "no normed wait": sub(src, [("if constexpr (PRENORM) mbar_wait(smem_u32(&normed[tl % S])",
                                     "if constexpr (false) mbar_wait(smem_u32(&normed[tl % S])")]),
        "no setmaxnreg": sub(src, [
            ("        asm volatile(\"setmaxnreg.dec", "        if constexpr (!PRENORM)\n"
             "            asm volatile(\"setmaxnreg.dec"),
            ("    asm volatile(\"setmaxnreg.inc", "    if constexpr (!PRENORM)\n"
             "        asm volatile(\"setmaxnreg.inc")]),
    }


def build_variants(build, texts=variants, libs_built=LIBS) -> tuple[dict, float]:
    """Compile each variant's libraries (K1 and K10 by default), all at once; their CDLLs and
    the seconds."""
    out_dir = os.path.join(ROOT, "build", "chip_wgmma_probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    src = (build.CSRC / "wna16_wgmma.cuh").read_text()
    procs = {}
    t0 = time.perf_counter()
    for i, (name, text) in enumerate(texts(src).items()):
        d = os.path.join(out_dir, f"v{i}")
        shutil.copytree(build.CSRC, d)
        with open(os.path.join(d, "wna16_wgmma.cuh"), "w") as f:
            f.write(text)
        for lib in libs_built:
            so = os.path.join(d, f"lib{lib}.so")
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", so, os.path.join(d, f"{lib}.cu")]
            procs[(name, lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, lib), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} {lib}: nvcc failed\n{log}")
        libs[(name, lib)] = ctypes.CDLL(so)
        if texts is prenorm_variants:   # the prologue instances' registers and spills
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and "prenorm_wgmma_kernel" in line:
                    print(f"{name}: {line.split()[-1][:70]} " + " | ".join(
                        t.strip() for t in lines[i + 1:i + 4] if "spill" in t or "Used" in t),
                          flush=True)
    return libs, time.perf_counter() - t0


def train(torch, np, use, gemm) -> dict:
    """8 LoRA steps on a random full-depth 4-bit Llama-2-7B per configuration:
    (variant library, the mma.sync kernel for the forward, for K10); their losses."""
    import chip_smoke as cs
    from autogptq_tpu_torch import AutoGPTQForCausalLM
    from autogptq_tpu_torch.models import arch
    from autogptq_tpu_torch.utils import peft
    from autogptq_tpu_torch.utils.random_checkpoint import LLAMA2_7B, write_random_checkpoint

    path = os.path.join(ROOT, "build", "chip_wgmma_probe", "llama2-7b-random-g128")
    write_random_checkpoint(path, LLAMA2_7B, bits=4, group_size=128, seed=0)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, LLAMA2_7B["vocab_size"], (cs.TRAIN_BATCH, cs.TRAIN_LEN))
    mask = np.ones_like(tokens)
    mask[1, :cs.TRAIN_PAD] = 0
    tokens[1, :cs.TRAIN_PAD] = 0
    labels = np.where(mask == 1, tokens, -100)
    tt, mt, lt = (torch.from_numpy(a).cuda() for a in (tokens, mask.astype(np.int32), labels))
    route, t_route = gemm.route, gemm.t_route

    def pr7(fn):   # the route with the mma.sync kernel in place of the wgmma one
        return lambda *a, **kw: "mma" if fn(*a, **kw) == "wgmma" else fn(*a, **kw)

    out = {}
    for label, lib, fw_mma, t_mma in (("as is", "as is", False, False),
                                      ("forward mma.sync", "as is", True, False),
                                      ("both mma.sync", "as is", True, True)):
        use(lib)
        gemm.route = pr7(route) if fw_mma else route
        gemm.t_route = pr7(t_route) if t_mma else t_route
        model = AutoGPTQForCausalLM.from_quantized(path)
        peft.get_gptq_peft_model(model, peft.GPTQLoraConfig(
            r=cs.TRAIN_RANK, lora_alpha=2 * cs.TRAIN_RANK,
            target_modules=("attn.q_proj", "attn.v_proj")), seed=0)
        params = peft.trainable_tensors(peft.split_lora_params(model.params)[0])
        opt = torch.optim.AdamW(params, lr=cs.TRAIN_LR)
        losses = []
        for _ in range(cs.TRAIN_STEPS):
            logits, _ = arch.forward(model.params, tt, model.cfg, attn_mask=mt, dtype=model.dtype)
            loss = cs.masked_loss(torch, logits, lt)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        out[label] = losses
        print(f"LoRA, 32 layers, {cs.TRAIN_STEPS} AdamW steps, {label}: losses "
              + ", ".join(f"{v:.6f}" for v in losses), flush=True)
        del model, opt, params
        torch.cuda.empty_cache()
    gemm.route, gemm.t_route = route, t_route
    shutil.rmtree(path, ignore_errors=True)
    return out


def probe_prenorm(torch, np, card) -> int:
    """The fused prologue's variants at M = 17, 24 and 31 (see the module note)."""
    import torch.nn.functional as F

    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin
    from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors
    from chip_smoke import PRENORM_EPS, PRENORM_SHAPES, Timer

    lib = "w4a16_gemm"
    rstd = gemm.prenorm_rstd
    libs, secs = build_variants(build, prenorm_variants, (lib,))
    names = tuple(dict.fromkeys(variant for variant, _ in libs))
    shipped = build.load(lib)
    print(f"variants built in {secs:.1f} s", flush=True)
    timer = Timer(torch)
    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    layers = {}
    for name, (k, n, _) in PRENORM_SHAPES.items():
        t = random_quant_tensors(rng, k, n, 4, 128, False)
        layers[name] = qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=None, bits=4, group_size=128, in_features=k, out_features=n), device="cuda")
    rows = []
    for m in (17, 24, 31):
        per = {}
        for name, (k, n, calls) in PRENORM_SHAPES.items():
            L = layers[name]
            x = (4.0 * torch.randn((m, k), generator=gen, device="cuda")).bfloat16()
            w = (1.0 + 0.1 * torch.randn((k,), generator=gen, device="cuda")).bfloat16()
            pn = (w, PRENORM_EPS, False)
            xn = gemm.rms_apply(x, *pn)
            res = {}
            for variant in names:
                build._libs[lib] = libs[(variant, lib)]
                if variant == "no rstd launch":
                    gemm.prenorm_rstd = lambda a, eps, out=None: out
                res[f"fused {variant}"] = timer.ms(lambda: qlin.matmul(x, L, prenorm=pn))
                gemm.prenorm_rstd = rstd
                if variant in ("as is", "no PDL"):
                    ref = qlin.matmul_plain(xn, L).float()
                    err = (qlin.matmul(x, L, prenorm=pn).float() - ref).abs().max().item()
                    if err > 1e-2 * ref.abs().max().item():
                        raise RuntimeError(f"{variant} {name} M={m}: error {err:.3e}")
            build._libs[lib] = shipped
            res["alone"] = timer.ms(lambda: qlin.matmul(xn, L))
            res["unfused pair"] = timer.ms(lambda: qlin.matmul(gemm.rms_apply(x, *pn), L))
            with gemm.forced_kernel("mma"):
                res["mma.sync prologue"] = timer.ms(lambda: qlin.matmul(x, L, prenorm=pn))
            wl = qlin.logical_weight(L, torch.bfloat16)
            res["F.rms_norm + torch.matmul"] = timer.ms(
                lambda: torch.matmul(F.rms_norm(x, (k,), w, PRENORM_EPS), wl))
            print(f"prenorm M={m} {name:8s} " + "  ".join(f"{key} {val:.4f}"
                                                         for key, val in res.items()), flush=True)
            rows.append(dict(M=m, shape=name, **res))
            for key, val in res.items():
                per[key] = per.get(key, 0.0) + calls * val
        print(f"prenorm M={m} per layer (q/k/v + gate/up): " + "  ".join(
            f"{key} {val:.4f}" for key, val in per.items()), flush=True)
        rows.append(dict(M=m, shape="layer", **per))
    with open(os.path.join(ROOT, "build", "chip_wgmma_probe_prenorm.json"), "w") as f:
        json.dump(dict(card=card, rows=rows), f, indent=1)
    print(card)
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_wgmma_probe.py needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if "--prenorm" in sys.argv[1:]:
        from chip_smoke import card_line

        card = card_line()
        print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
        return probe_prenorm(torch, np, card)
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin
    from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors
    from chip_smoke import Timer, bound_ms, card_line, nbytes

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    libs, secs = build_variants(build)
    build.build(LIBS)   # the shipped libraries, for the mma.sync kernels beside
    print(f"variants built in {secs:.1f} s", flush=True)

    def use(name):   # route the wrappers' K1 and K10 libraries to a variant
        for lib in LIBS:
            build._libs[lib] = libs[(name, lib)]

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    layers = {}
    for name, (k, n, _) in SHAPES.items():
        t = random_quant_tensors(rng, k, n, 4, 128, False)
        layers[name] = qlin.from_packed(qlin.PackedQuantLinear(
            qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"], g_idx=t["g_idx"],
            bias=None, bits=4, group_size=128, in_features=k, out_features=n), device="cuda")
    rows = []
    for m in (17, 64, 128, 2048):
        iters = 5 if m == 2048 else 20
        per = {}
        for name, (k, n, calls) in SHAPES.items():
            L = layers[name]
            x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            g = torch.randn((m, n), generator=gen, device="cuda", dtype=torch.bfloat16)
            w = qlin.logical_weight(L, torch.bfloat16)

            def fw(kernel):
                return gemm.wna16_matmul(x, L.qweight, L.scales, L.zeros, None, None, 128, 4,
                                         kernel=kernel)

            def bw(kernel):
                return gemm.wna16_matmul_t(g, L.qweight, L.scales, L.zeros, None, 128, 4,
                                           kernel=kernel)

            res = {}
            for variant in ("as is", "no dequant", "no wgmma"):
                use(variant)
                res[f"fw {variant}"] = timer.ms(lambda: fw("wgmma"), iters=iters)
                res[f"t {variant}"] = timer.ms(lambda: bw("wgmma"), iters=iters)
                if variant == "as is":
                    ref_f, ref_t = qlin.matmul_plain(x, L).float(), gemm.wna16_matmul_t_ref(
                        g, L.qweight, L.scales, L.zeros, None, 128, 4).float()
                    ef = (fw("wgmma").float() - ref_f).abs().max().item() / ref_f.abs().max().item()
                    et = (bw("wgmma").float() - ref_t).abs().max().item() / ref_t.abs().max().item()
                    if not (ef <= 1e-2 and et <= 1e-2):
                        raise RuntimeError(f"{name} M={m}: relative error {ef:.3e} / {et:.3e}")
                    res["rel_err"] = (ef, et)
            res["fw mma"] = timer.ms(lambda: fw("mma"), iters=iters)
            res["t mma"] = timer.ms(lambda: bw("mma"), iters=iters)
            res["fw torch.matmul"] = timer.ms(lambda: torch.matmul(x, w), iters=iters)
            res["t torch.matmul"] = timer.ms(lambda: torch.matmul(g, w.t()), iters=iters)
            res["bound"] = bound_ms(nbytes(x, L.qweight, L.scales, L.zeros) + 2 * m * n,
                                    2.0 * m * k * n)[0]
            print(f"M={m} {name:8s} " + "  ".join(
                f"{key} {val:.4f}" for key, val in res.items() if key != "rel_err"), flush=True)
            rows.append(dict(M=m, shape=name, **res))
            for key, val in res.items():
                if key != "rel_err":
                    per[key] = per.get(key, 0.0) + calls * val
        print(f"M={m} per layer: " + "  ".join(f"{key} {val:.4f}" for key, val in per.items()),
              flush=True)
        rows.append(dict(M=m, shape="layer", **per))
    use("as is")
    losses = train(torch, np, use, gemm)
    with open(os.path.join(ROOT, "build", "chip_wgmma_probe.json"), "w") as f:
        json.dump(dict(card=card, rows=rows, losses=losses), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
