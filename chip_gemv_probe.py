#!/usr/bin/env python3
"""Design probe of the port's tensor-core decode GEMV (K1/K4/K5 at M <= 16) on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_gemv_probe.py`` (one card,
about two minutes on an H100). It imports nothing of JAX or of the ``autogptq_tpu``
package. It builds variants of ``autogptq_tpu_torch/ops/csrc/wna16_gemv.cuh`` by text
substitution, each into its own ``w4a16_gemm`` / ``w8a16_gemm`` library under
``build/chip_gemv_probe/``:

* ``as is``: the kernel as the port ships it;
* ``no compute``: the codes are read from the ring but neither decoded nor multiplied
  (wrong results, timed only): what streaming the words costs;
* ``no x stage``: x is not staged (wrong results): what staging it costs;
* ``no combine``: every split writes its partial and stops (wrong results): what the
  fence, the ticket and the last block's merge cost;
* ``stream only``: the three above together: the words and scales stream through the
  ring and nothing else happens;
* ``one MMA chain``: the whole-stage path accumulates every step into one fragment
  (one dependent chain of MMAs) in place of two;
* ``3 stages``: a ring of 3 stages in place of 4.

``as is`` and ``stream only`` are also built for K6 (the same kernel over the kb32l
tiles) and K9 (over a routed stack of experts) and timed on one Llama-2-7B layer in both
layouts (the same weights) at M = 1 and 16 and on one Mixtral-8x7B layer at P = 1, 2
and 8: whether the contiguous tiles stream faster than GPTQ's rows under one kernel.

Each is timed two ways at 4-bit g128 (and ``as is`` also at 8-bit), bf16: one call
of each Llama-2-7B projection with the L2 cache flushed before it (CUDA events, as
``chip_smoke.py`` times kernels), and back to back over the 7 projections of 8
decoder layers (about 0.8 GB of 4-bit words, so nothing stays in the 50 MB L2),
per layer, as a decode step meets them. Beside them: the SIMT GEMV on the same
weights, ``torch.matmul`` on a pre-dequantized bf16 weight, the plan's splits
varied (2 and 8 blocks per SM in place of 4), the timer's floor (a one-element kernel),
and, at 4-bit M = 1, the shipped kernel, the stream alone, the SIMT GEMV, torch.matmul
and the floor timed with the L2 flushed by a read in place of a write (so that the timed
call does not first write back the flush's dirty lines). The
card's name and power limit come first; everything also goes to
``build/chip_gemv_probe.json``.
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
DEPTH = 8            # decoder layers of the back-to-back run
ROWS = (1, 4, 16)


def variants(src: str) -> dict:
    """The header texts of the probed variants and the column tile each takes."""
    def sub(text, old, new):
        assert old in text, old
        return text.replace(old, new)

    def nocompute(text):
        text = sub(text, """        uint32_t a[4];
        C::pairs(w.x, sh, zz0, a[0], a[2]);""", """        p[0][0] += __uint_as_float((w.x ^ w.y) & 0x3FFFFFFFu);
        if (false) {
        uint32_t a[4];
        C::pairs(w.x, sh, zz0, a[0], a[2]);""")
        return sub(text, """        for (int j = 0; j < NT; ++j) Mma<T>::run(p[j], a, b[2 * j], b[2 * j + 1]);""",
                   """        for (int j = 0; j < NT; ++j) Mma<T>::run(p[j], a, b[2 * j], b[2 * j + 1]);
        }""")

    def nox(text):
        text = sub(text, "for (int c = tid; c < rows * (kc / 8); c += GV_THREADS) {",
                   "for (int c = tid; c < 0; c += GV_THREADS) {")
        return sub(text, "for (int it = tid; it < rows * nsteps; it += GV_THREADS) {",
                   "for (int it = tid; it < 0; it += GV_THREADS) {")

    def nocombine(text):
        return sub(text, "    // The ticket: after the barrier",
                   "    return;\n    // The ticket: after the barrier")

    stream = nocombine(nox(nocompute(src)))
    return {
        "as is": (src, 64),
        "no compute": (nocompute(src), 64),
        "no x stage": (nox(src), 64),
        "no combine": (nocombine(src), 64),
        "stream only": (stream, 64),
        "one MMA chain": (sub(src, "part[ks & 1]);\n                left -= BK / 16;",
                              "part[0]);\n                left -= BK / 16;"), 64),
        "3 stages": (sub(src, "constexpr int GV_STAGES = 4;", "constexpr int GV_STAGES = 3;"), 64),
    }


LAYOUT_VARIANTS = ("as is", "stream only")   # also built for K6 (kb32l) and K9 (routed)


def build_variants(build) -> dict:
    """Compile each variant's w4a16_gemm and w8a16_gemm, and for LAYOUT_VARIANTS
    also w4a16_kb32l_gemm and w4a16_routed_gemm (all at once); their CDLLs."""
    out_dir = os.path.join(ROOT, "build", "chip_gemv_probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    src = (build.CSRC / "wna16_gemv.cuh").read_text()
    procs = {}
    for i, (name, (text, _)) in enumerate(variants(src).items()):
        d = os.path.join(out_dir, f"v{i}")
        shutil.copytree(build.CSRC, d)
        with open(os.path.join(d, "wna16_gemv.cuh"), "w") as f:
            f.write(text)
        libs = ("w4a16_gemm", "w8a16_gemm")
        if name in LAYOUT_VARIANTS:
            libs += ("w4a16_kb32l_gemm", "w4a16_routed_gemm")
        for lib in libs:
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
        print("chip_gemv_probe: torch.cuda.is_available() is false; this script needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from autogptq_tpu_torch.ops import build, gemm
    from autogptq_tpu_torch.ops import quantlinear as qlin

    card = cs.card_line()
    print(f"card: {card}; device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.build(("w4a16_gemm", "w8a16_gemm", "w4a16_kb32l_gemm", "w4a16_routed_gemm"))
    libs = build_variants(build)
    columns = {name: bn for name, (_, bn) in
               variants((build.CSRC / "wna16_gemv.cuh").read_text()).items()}
    print(f"variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    shipped = {lib: build.load(lib) for lib in ("w4a16_kb32l_gemm", "w4a16_routed_gemm")}

    def use(name):   # route the wrappers' libraries (and the plan's column tile) to a variant
        build._libs.update(shipped)
        for lib, cdll in libs[name].items():
            build._libs[lib] = cdll
        gemm.GEMV_BN = columns[name]
        gemm._gemv_plan.cache_clear()

    timer = cs.Timer(torch)
    one = torch.zeros(1, device="cuda")
    out = {"card": card, "device": torch.cuda.get_device_name(0),
           "floor_ms": timer.ms(lambda: one.add_(1.0), iters=50)}
    print(f"timer floor (a one-element kernel): {out['floor_ms']:.4f} ms", flush=True)
    rng = np.random.default_rng(0)
    stacks = {}
    for bits in (4, 8):
        stacks[bits] = [{case: cs._random_layer(qlin, rng, k, n, bits, 128, False,
                                                torch.bfloat16)
                         for case, (k, n, _) in cs.LAYER_SHAPES.items()} for _ in range(DEPTH)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = {(m, k): torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
          for m in ROWS for k in (4096, 11008)}

    def run(layer, m, kernel=None):
        x = xs[(m, layer.in_features)]
        return gemm.wna16_matmul(x, layer.qweight, layer.scales, layer.zeros, None, None, 128,
                                 qlin.storage_bits(layer.bits), kernel=kernel)

    def back_to_back(bits, m, kernel=None, reps=3):
        """ms per decoder layer over DEPTH layers' 7 projections, back to back."""
        calls = [(layer, c) for stack in stacks[bits] for case, layer in stack.items()
                 for c in range(cs.LAYER_SHAPES[case][2])]
        for layer, _ in calls:
            run(layer, m, kernel)
        torch.cuda.synchronize()
        best = None
        for _ in range(reps):
            timer.flush.zero_()
            torch.cuda._sleep(cs.SPIN_CYCLES * 4)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for layer, _ in calls:
                run(layer, m, kernel)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / DEPTH
            best = ms if best is None else min(best, ms)
        return best

    def per_call(bits, m, kernel=None):
        return {case: timer.ms(lambda: run(layer, m, kernel), iters=10)
                for case, layer in stacks[bits][0].items()}

    def layer_of(calls):
        return sum(ms * cs.LAYER_SHAPES[case][2] for case, ms in calls.items())

    def clean_flushed(fn, iters=10):
        """As timer.ms, but the L2 is flushed by reading the flush buffer, so the
        timed call finds it holding clean lines, not the 50 MB of dirty lines that
        zero_() leaves (which the call's misses must first write back)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            timer.flush.view(torch.int64).sum()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    rows = []
    for name in columns:
        use(name)
        for bits in ((4, 8) if name == "as is" else (4,)):
            for m in (ROWS if name == "as is" else (1, 16)):
                calls = per_call(bits, m)
                row = dict(variant=name, bits=bits, M=m, calls_ms=calls,
                           layer_flushed_ms=layer_of(calls),
                           layer_back_to_back_ms=back_to_back(bits, m),
                           blocks_per_sm=gemm.gemv_blocks_per_sm(
                               torch.bfloat16, m, bits, gemm.gemv_plan(4096, 4096, m, 128, bits,
                                                                       132)["kc"]))
                rows.append(row)
                print(f"{name:24s} {bits}-bit M={m:2d}: per call (L2 flushed) " + ", ".join(
                    f"{c} {v:.4f}" for c, v in calls.items()) + f"; layer "
                    f"{row['layer_flushed_ms']:.4f} ms flushed, {row['layer_back_to_back_ms']:.4f} "
                    f"ms back to back; {row['blocks_per_sm']} blocks per SM", flush=True)
    clean = {}
    for name, kernel in (("as is", None), ("stream only", None), ("SIMT GEMV", "simt")):
        use(name if kernel is None else "as is")
        clean[name] = layer_of({case: clean_flushed(lambda: run(layer, 1, kernel))
                                for case, layer in stacks[4][0].items()})
    w_bf16 = {case: qlin.logical_weight(layer, torch.bfloat16)
              for case, layer in stacks[4][0].items()}
    clean["torch.matmul"] = layer_of({case: clean_flushed(
        lambda: torch.matmul(xs[(1, layer.in_features)], w_bf16[case]))
        for case, layer in stacks[4][0].items()})
    clean["timer floor"] = 7 * clean_flushed(lambda: one.add_(1.0), iters=50)
    del w_bf16
    out["clean_flush_layer_ms"] = clean
    print("4-bit M=1 per layer, L2 flushed by a read (clean lines): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in clean.items()), flush=True)
    # The same kernel over other words: K6's kb32l tiles against K1's GPTQ rows (the same
    # weights, from one seed), and K9's routed stack of Mixtral-8x7B's experts, as shipped and
    # streaming only (which says whether the contiguous tiles stream faster than the rows)
    layouts = {}
    for layout in ("gptq", "kb32l"):
        layouts[layout] = {case: cs._random_layer(qlin, np.random.default_rng(i), k, n, 4, 128,
                                                  False, torch.bfloat16, layout=layout)
                           for i, (case, (k, n, _)) in enumerate(cs.LAYER_SHAPES.items())}
    experts = {case: qlin.stack_experts([cs._random_layer(qlin, rng, k, n, 4, 128, False,
                                                          torch.bfloat16) for _ in range(8)])
               for case, (k, n, _) in cs.MIXTRAL_SHAPES.items()}
    rx = {(p, k): torch.randn((p, k), generator=gen, device="cuda", dtype=torch.bfloat16)
          for p in cs.K9_SELS for k in (4096, 14336)}
    out["layouts"] = []
    for name in LAYOUT_VARIANTS:
        use(name)
        for layout, stack in layouts.items():
            for m in (1, 16):
                calls = {case: timer.ms(lambda: qlin.matmul(xs[(m, layer.in_features)], layer),
                                        iters=10) for case, layer in stack.items()}
                out["layouts"].append(dict(variant=name, layout=layout, M=m, calls_ms=calls,
                                           layer_flushed_ms=layer_of(calls)))
                print(f"{name:12s} {layout:5s} M={m:2d}: per call (L2 flushed) " + ", ".join(
                    f"{c} {v:.4f}" for c, v in calls.items())
                    + f"; layer {layer_of(calls):.4f} ms", flush=True)
        for p, ids in cs.K9_SELS.items():
            sel = torch.tensor(ids, dtype=torch.int32, device="cuda")
            calls = {case: timer.ms(lambda: qlin.matmul_routed(rx[(p, sql.in_features)], sql, sel,
                                                               check=False), iters=10)
                     for case, sql in experts.items()}
            layer = sum(v * cs.MIXTRAL_SHAPES[c][2] for c, v in calls.items())
            out["layouts"].append(dict(variant=name, layout="routed", P=p, calls_ms=calls,
                                       layer_flushed_ms=layer))
            print(f"{name:12s} routed P={p}: per call (L2 flushed) " + ", ".join(
                f"{c} {v:.4f}" for c, v in calls.items()) + f"; Mixtral layer {layer:.4f} ms",
                flush=True)
    del layouts, experts
    torch.cuda.empty_cache()
    use("as is")
    for bits in (4, 8):
        for m in ROWS:
            calls = per_call(bits, m, "simt")
            rows.append(dict(variant="SIMT GEMV", bits=bits, M=m, calls_ms=calls,
                             layer_flushed_ms=layer_of(calls),
                             layer_back_to_back_ms=back_to_back(bits, m, "simt")))
            print(f"SIMT GEMV  {bits}-bit M={m:2d}: layer {rows[-1]['layer_flushed_ms']:.4f} ms "
                  f"flushed, {rows[-1]['layer_back_to_back_ms']:.4f} ms back to back", flush=True)
    for per_sm in (2, 8):
        gemm.GEMV_BLOCKS_PER_SM = per_sm
        gemm._gemv_plan.cache_clear()
        for m in (1, 16):
            calls = per_call(4, m)
            rows.append(dict(variant=f"{per_sm} blocks per SM", bits=4, M=m, calls_ms=calls,
                             layer_flushed_ms=layer_of(calls),
                             layer_back_to_back_ms=back_to_back(4, m)))
            print(f"plan at {per_sm} blocks per SM, 4-bit M={m:2d}: layer "
                  f"{rows[-1]['layer_flushed_ms']:.4f} ms flushed, "
                  f"{rows[-1]['layer_back_to_back_ms']:.4f} ms back to back", flush=True)
    gemm.GEMV_BLOCKS_PER_SM = 4
    gemm._gemv_plan.cache_clear()
    lib = {}
    for case, layer in stacks[4][0].items():
        w = qlin.logical_weight(layer, torch.bfloat16)
        lib[case] = {m: timer.ms(lambda: torch.matmul(xs[(m, layer.in_features)], w), iters=10)
                     for m in ROWS}
        del w
    out["torch_matmul_layer_ms"] = {m: sum(lib[c][m] * cs.LAYER_SHAPES[c][2] for c in lib)
                                    for m in ROWS}
    print(f"torch.matmul per layer (flushed): {out['torch_matmul_layer_ms']}", flush=True)
    out["rows"] = rows
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_gemv_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
