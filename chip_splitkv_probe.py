#!/usr/bin/env python3
"""Design probe of the port's split-KV decode attention (K2, K7) on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_splitkv_probe.py`` (one
card, about a minute on an H100). It imports nothing of JAX or of the
``autogptq_tpu`` package. It builds variants of
``autogptq_tpu_torch/ops/csrc`` by text substitution, each into its own
libraries under ``build/chip_splitkv_probe/``:

* ``as is``: the kernels as the port ships them;
* ``__ldg loads``: K and V read through the read-only cache path instead of
  streaming (evict-first) loads;
* ``int8 divide``: K7 divides each int8 scale by 127.5 instead of multiplying
  by the f32 reciprocal;

and ``unsplit``: the shipped kernels with the plan's block target set to 1, so
every row is one chunk (no partials, fence, ticket or merge). In two rounds, the
second in reverse order, it times one Llama-2-7B layer of K2 (B = 1, 32 heads,
a 528-slot cache, 17 and 528 live slots) and of K7 (beam 4, bf16 and int8 pools,
40-page tables of 16 slots, 17 and 528 live slots per row) through each, beside
the time of a one-element kernel (the timer's floor: launch and events). Every
call is held against its plain version (``chip_smoke.K2_ABS_TOL`` /
``K7_ABS_TOL``). The card's name and power limit come first; everything also
goes to ``build/chip_splitkv_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
LIBS = ("flash_decode", "paged_attn")
VARIANTS = {
    "as is": {},
    "__ldg loads": {"split_kv.cuh": [("__ldcs(", "__ldg(")]},
    "int8 divide": {"paged_attn.cu": [("* (1.0f / 127.5f);", "/ 127.5f;")]},
}


def build_variants(build) -> dict:
    """Compile every variant's K2 and K7 libraries (all at once); their CDLLs."""
    out_dir = os.path.join(ROOT, "build", "chip_splitkv_probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        d = os.path.join(out_dir, f"v{i}")
        shutil.copytree(build.CSRC, d)
        for fname, pairs in subs.items():
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            for old, new in pairs:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in {fname}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        for lib in LIBS:
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


def make_cases(torch, cs, fdm, pam) -> dict:
    """name -> (call, plain result, tolerance) at the main paths' shapes."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16, d, layer = torch.bfloat16, 128, 1
    scale = d ** -0.5
    kc = torch.randn((2, 1, 528, 32, d), generator=gen, device="cuda", dtype=bf16)
    vc = torch.randn(kc.shape, generator=gen, device="cuda", dtype=bf16)
    q = torch.randn((1, 32, d), generator=gen, device="cuda", dtype=bf16)
    lo = torch.zeros(1, dtype=torch.int32, device="cuda")
    n_pages, width = 2 + cs.BEAMS * 33, 40
    shape = (2, n_pages, 32, cs.PAGE, d)
    pools = {"bf16": (torch.randn(shape, generator=gen, device="cuda", dtype=bf16),
                      torch.randn(shape, generator=gen, device="cuda", dtype=bf16), None, None),
             "int8": tuple(torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                         dtype=torch.int8) for _ in range(2))
             + tuple(torch.rand(shape[:-1], generator=gen, device="cuda") * 4 + 0.1
                     for _ in range(2))}
    q4 = torch.randn((cs.BEAMS, 32, d), generator=gen, device="cuda", dtype=bf16)
    live = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:cs.BEAMS * 33] + 1
    tables = torch.zeros((cs.BEAMS, width), dtype=torch.int32, device="cuda")
    tables[:, :33] = live.reshape(cs.BEAMS, 33).to(torch.int32)
    cases = {}
    for n in (17, 528):
        hi = torch.full((1,), n, dtype=torch.int32, device="cuda")
        cases[f"K2 {n} slots"] = (
            lambda hi=hi: fdm.flash_decode(q, kc, vc, lo, hi, layer=layer, sm_scale=scale),
            fdm.flash_decode_ref(q, kc, vc, lo, hi, layer=layer, sm_scale=scale), cs.K2_ABS_TOL)
        lengths = torch.full((cs.BEAMS,), n, dtype=torch.int32, device="cuda")
        for tag, (kp, vp, ks, vs) in pools.items():
            args = (q4, kp, vp, lengths, tables, ks, vs)
            cases[f"K7 {tag} {n} slots"] = (
                lambda args=args: pam.paged_attention_mh(*args, sm_scale=scale, layer=layer),
                pam.paged_attention_mh_ref(*args, sm_scale=scale, layer=layer), cs.K7_ABS_TOL)
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_splitkv_probe: torch.cuda.is_available() is false; this script needs a "
              "CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from autogptq_tpu_torch.ops import build
    from autogptq_tpu_torch.ops import flash_decode as fdm
    from autogptq_tpu_torch.ops import paged_attn as pam

    card = cs.card_line()
    print(f"card: {card}; device {torch.cuda.get_device_name(0)}", flush=True)
    libs = build_variants(build)
    timer = cs.Timer(torch)
    tiny = torch.zeros(1, device="cuda")
    floor_ms = timer.ms(lambda: tiny.add_(1))
    print(f"one-element kernel (the timer's floor): {floor_ms:.4f} ms", flush=True)
    cases = make_cases(torch, cs, fdm, pam)
    shipped_target = fdm.TARGET_BLOCKS
    configs = [(name, name, shipped_target) for name in VARIANTS] + [("unsplit", "as is", 1)]
    ms = {}
    try:
        for rnd in range(2):
            for label, variant, target in (configs if rnd == 0 else configs[::-1]):
                build._libs.update(libs[variant])
                fdm.TARGET_BLOCKS = target
                for case, (call, ref, tol) in cases.items():
                    out = call()
                    torch.cuda.synchronize()
                    err = (out - ref).abs().max().item()
                    cs.check(err <= tol, f"{label} {case}: max |kernel - plain| = {err:.3e}")
                    ms.setdefault(label, {}).setdefault(case, []).append(timer.ms(call))
    finally:
        fdm.TARGET_BLOCKS = shipped_target
    for label, row in ms.items():
        print(f"{label:12s} " + "  ".join(f"{case} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                                          for case, ts in row.items()), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_splitkv_probe.json"), "w") as f:
        json.dump(dict(card=card, device=torch.cuda.get_device_name(0), floor_ms=floor_ms,
                       plans={"K2": fdm.split_plan(1, 32, 528),
                              "K7": pam.split_plan(cs.BEAMS, 32, 40, cs.PAGE)}, ms=ms), f,
                  indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
