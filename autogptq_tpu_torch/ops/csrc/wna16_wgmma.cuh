// Hopper tile kernels of the wNa16 dequant-matmuls (sm_90a: wgmma, TMA, mbarriers, setmaxnreg),
// bf16 and f16 activations, BITS in {2, 4, 8} (3-bit codes ride in nibbles), GPTQ's K-packed
// words, every group size:
//   wna16_wgmma_kernel          y[M,N]  = x[M,K] @ W[K,N] (+ bias)   K1, K4, K5 above 16 rows
//   wna16_t_wgmma_kernel        dx[M,K] = g[M,N] @ W[K,N]^T           K10 above 16 rows
//   kb32l_wgmma_kernel          y = x @ W over K6's kb32l words       K6 above 16 rows
//   kb32l_t_wgmma_kernel        dx = g @ W^T over kb32l words         K10 over them above 16 rows
//   wna16_prenorm_wgmma_kernel  y = rms_apply(x, w) @ W, M < 32       K1's fused prologue
// with W = (q - z) * s. Each library exports its kernels as NAME_wgmma (K1's prologue as
// w4a16_gemm_wgmma_norm, K10 over kb32l words as w4a16_kb32l_gemm_t_wgmma) beside the tile
// kernels of wna16_mma.cuh (NAME_mma, NAME_mma_norm), which stay nameable (ops/gemm.py:
// kernel="mma") and remain the route of shapes TMA cannot address (ops/gemm.py:tile_kernel,
// t_route).
//
// They replace the prefill regime of the TPU kernels autogptq_tpu/ops/pallas/gemm.py:
// _kernel_kb32 (:487, prefill branch :523-537; with lin=True behind _matmul_kb32l :635, K6),
// _kernel_ki32, _kernel_kpair, _kernel_k2i32, _kernel_kquad and the planar _kernel, which
// dequantize in f32, round the scaled weight once to dot_dtype (:535) and dot on the MXU with
// f32 accumulation; the prologue _prenorm_x (:332) of _kernel_kb32 and _kernel_ki32 at 17-31
// rows; and the backward kernels _kernel_kb32_t (:811), _kernel_ki32_t (:1031) and
// _kernel_kpair_t (:1289).
//
// Bound on the H100: at a training step's M = 2048 both are bound by operations, 2*M*K*N at
// 989 TFLOP/s bf16 dense (0.838 ms per Llama-2-7B layer); at M = 128 by the same operations
// within 2-3x of the weight's bytes.
//
// Design (one warp-specialized kernel each; the two share this body):
//  * Block: 384 threads. Warpgroup 0 is the producer: it gives its registers up (setmaxnreg 40)
//    and one warp keeps a ring of `stages` shared-memory stages in flight with TMA, each stage's
//    arrival marked by a `full` mbarrier (expect_tx bytes) and its release by an `empty` one
//    (one arrival per consumer warp). Warpgroups 1 and 2 are the consumers (setmaxnreg 232):
//    each issues m64nNk16 wgmmas into f32 accumulators held in registers. The block's output
//    tile is BM x 128: BM = 256 above 128 rows (each warpgroup 128 rows as two m64n128 halves,
//    so one dequantized B tile pair feeds 256 rows, half the dequant per output of BM = 128), 128
//    (each warpgroup 64 rows) or, for M <= 64, 64 (each warpgroup 64 columns, so both still
//    share the dequant). The reduction runs in tiles of 64 (K for the forward, N for K10).
//  * A stage holds the activation tile (x, or K10's g) [BM x 64] by TMA with the 128-byte
//    swizzle (64 halves are one 128-byte row), the packed words of the tile [64/P x 128] (K10:
//    [128/P x 64]), and the fp16 scale rows and uint8 zero rows of the groups it touches
//    (ops/gemm.py:mma_stage_groups of 64, or of K10's 128 K rows), each by TMA; the forward's
//    stage also carries a table of each K row's group row, written by the producer warp's lanes,
//    so no consumer divides by the group size.
//  * The weight is dequantized by the consumers into a B tile in shared memory, K-major (the
//    reduction contiguous, 128-byte rows) with the same 128-byte swizzle as TMA's (16-byte chunk
//    index XOR row % 8), which the wgmma descriptors name (layout 1, SBO 1024 bytes, +32 bytes
//    per 16-deep step). A code's weight is w = s[g(k), n] * (q - z[g(k), n]) in f32 (one exact
//    FFMA per code: code_unit, scale_pair), each code looking up its own row's group, so one
//    instance serves 16 | gs and the rest classes (a word straddling groups, a partial last
//    group); where every unit lies in one group (8 | gs, K10 P | gs) a branch-free path taken
//    once per call. Both kernels carry w as wna16_mma.cuh K10's pair of T, hi = round(w), lo =
//    round(w - hi) (about 16 significant bits), two wgmma sets into one accumulator, each in a
//    B tile of its own. Forward and backward must carry the weight alike: the forward rounding
//    it once (the JAX kernels' wd.astype(dot_dtype)) and K10 keeping the pair, a 32-layer LoRA
//    run's loss rose over 8 steps (an exact forward with a once-rounded K10 did too); both rounding once, it fell, but
//    the 2-layer AdaLoRA gradient check lay 5.03e-2 from f32, over its 5e-2 (the mma.sync kernels: 4.11e-2).
//    chip_wgmma_probe.py, PERF.md. The forward writes one 16-byte chunk (8 K rows of one
//    column) per unit and tile; K10 one word row by BITS columns.
//  * Dequant while the tensor cores run: per reduction tile t the consumers issue tile t's
//    wgmmas (asynchronous), wait for tile t-1's (wgmma.wait_group 1, then release its stage),
//    dequantize tile t+1 into the next of three B tile pairs, fence.proxy.async, and meet at one
//    named barrier. Three pairs make one barrier per tile enough: the pair written at t was
//    last read by tile t-2's wgmmas, which every warpgroup waited for before the barrier of t-1.
//  * Split K (ops/gemm.py:wgmma_plan): where fewer output tiles than SMs exist, blockIdx.z cuts
//    the reduction into `splits` runs of `per` tiles; each block writes f32 partials, draws a
//    ticket (acq_rel atomic), and the block drawing the last adds the partials in split order,
//    the bias, rounds once and stores (counter reset to 0), so results are bit-equal from call
//    to call.
//  * desc_act: the forward's wrapper gathers x by kperm once per call (as matmul_pallas and
//    matmul_xla do) before this kernel; K10 scatters dx through kperm in its epilogue.
//  * M, N and K edges: TMA zero-fills out-of-range rows and columns of every operand (codes 0
//    with scale 0, or with an x or g of 0), and the epilogue masks its stores.
//  * What bounds them (chip_wgmma_probe.py, PERF.md): at M = 2048 neither the wgmmas alone (the
//    dequant removed) nor the dequant alone (the wgmmas removed) reaches the whole kernel's
//    time, and both still stream every activation tile once per 128-column block from L2, about
//    7 GB per Llama-2-7B layer: wider column tiles or cluster multicast of those tiles, and a
//    persistent grid, are the next levers.
//  * kb32l words (K6): a 3-D map of the tiles (wg_encode_kb32l) gives each stage the same
//    [64/P][128] words as GPTQ's 2-D map, so K6 is K1's kernel with one other TMA load; K10
//    over them reads the same map with K10's box (64 columns by the 16 word rows of its 128 K
//    rows: the [128/P][64] words GPTQ's K10 map gives), its scales and zeros N_pad wide.
//  * The fused RMS-norm prologue (PRENORM, 17-31 rows: one 64-row block): rstd over each row's
//    full K once per call by a small launch before the product's (wg_rstd_kernel, its own entry
//    and launch count, which the product overlaps by programmatic dependent launch); the
//    tile's norm weights by TMA into
//    the stage; the x tile normalized in place in TMA's swizzle by the producer's three idle
//    warps, ahead of the consumers, behind a `normed` mbarrier per stage (wg_body).
// The host entry encodes the tensor maps with cuTensorMapEncodeTiled, reached through the
// runtime's entry-point lookup (no -lcuda). TMA needs 16-byte aligned bases and row strides:
// K % 8 for x, N % 8 for g and scales, N % 16 for zeros (ops/gemm.py:wgmma_shape_ok routes
// other shapes to the kernels of wna16_mma.cuh); kb32l scales and zeros are N_pad wide, so there
// only the epilogue's column pairs limit N in the forward (N % 4, ops/gemm.py:kb32l_route) and
// g's rows in K10 (N % 8, ops/gemm.py:t_route). Every entry point returns cudaGetLastError()
// or, for a failed encode, WG_ENCODE_ERROR + the CUresult, and the Python wrapper raises.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)

#include "wna16_mma.cuh"

namespace {

constexpr int WG_BK = 64;             // reduction rows per stage: one 128-byte row of T
constexpr int WG_BN = 128;            // output columns per block (N; K10: K rows)
constexpr int WG_THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int WG_CONSUMERS = 256;
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_BTILES = 3;          // dequantized B tile pairs (hi, lo) in rotation
constexpr int WG_BTILE_BYTES = WG_BN * WG_BK * 2;   // [128 rows][64] of T, swizzled
constexpr int WG_ENCODE_ERROR = 100000;  // + CUresult: cuTensorMapEncodeTiled failed
constexpr int WG_PRODUCER_REGS = 40;
constexpr int WG_CONSUMER_REGS = 232;
constexpr int WG_NW_BYTES = WG_BK * 4;  // PRENORM: a tile's norm weight (at most f32)
constexpr int WG_NORMERS = 96;          // PRENORM: the producer warps 1-3 that normalize x

__host__ __device__ constexpr int wg_up(int v, int a) { return (v + a - 1) / a * a; }

// Bytes of one stage (ops/gemm.py:wgmma_stage_bytes is the same rule): the activation tile
// [BM][64] of T, the words of 64 reduction rows (forward) or 128 output rows (K10), ng group rows
// of fp16 scales and uint8 zeros (128 columns, K10 64), the forward's 64-byte group table, with
// the fused prologue (norm) the tile's 64 norm weights (WG_NW_BYTES, 128-aligned); 1024-aligned
// so that every stage's swizzled tile starts on a swizzle atom.
struct WgStage {
    int a, w, s, z, tab, nw, bytes;
    __host__ __device__ WgStage(int bits, int bm, int ng, bool trans, bool norm = false) {
        const int sw = trans ? 64 : 128;
        a = 0;
        w = bm * 128;
        s = w + 1024 * bits;
        z = s + wg_up(ng * sw * 2, 128);
        tab = z + wg_up(ng * sw, 128);
        nw = wg_up(tab + (trans ? 0 : 64), 128);
        bytes = wg_up(nw + (norm ? WG_NW_BYTES : 0), 1024);
    }
};

// Dynamic shared memory of a block: alignment slack, the ring, the B tiles (hi and lo each).
__host__ __device__ inline int wg_smem_bytes(int bits, int bm, int ng, bool trans, int stages,
                                             bool norm = false) {
    return 1024 + stages * WgStage(bits, bm, ng, trans, norm).bytes +
           WG_BTILES * 2 * WG_BTILE_BYTES;
}

// ---- PTX wrappers -------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {   // the two consumer warpgroups
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across a wgmma wait.
template <int N>
__device__ __forceinline__ void wg_fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major operand tile with the 128-byte swizzle: rows of 128 bytes, 8-row
// atoms of 1024 bytes (SBO), the leading offset unused (1); the tile starts on an atom.
__device__ __forceinline__ uint64_t wg_desc(uint32_t smem_addr) {
    return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define WG_D8(i)                                                                              \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
        "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R32                                                                                 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                                 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
    "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
    "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x NW] += A[64 x 16] * B[16 x NW], both K-major in shared memory, f32 accumulators.
template <typename T, int NW> struct Wgmma;

template <> struct Wgmma<__nv_bfloat16, 128> {
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
                     ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                     : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48),
                       WG_D8(56)
                     : "l"(a), "l"(b), "r"(1));
    }
};
template <> struct Wgmma<__half, 128> {
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_R64
                     ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                     : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48),
                       WG_D8(56)
                     : "l"(a), "l"(b), "r"(1));
    }
};
template <> struct Wgmma<__nv_bfloat16, 64> {
    static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
                     ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                     : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
                     : "l"(a), "l"(b), "r"(1));
    }
};
template <> struct Wgmma<__half, 64> {
    static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_R32
                     ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                     : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
                     : "l"(a), "l"(b), "r"(1));
    }
};

// Byte offset of element (row, col) of a swizzled tile of 128-byte rows.
__device__ __forceinline__ int wg_swz(int row, int col) {
    return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// ---- the dequant of one reduction tile into a B tile ----------------------------------------

// Code j of word w as the float 1 + q / 2^BITS (its bits OR-ed into the mantissa: two integer
// operations, no conversion).
template <int BITS>
__device__ __forceinline__ float code_unit(uint32_t w, int j) {
    constexpr uint32_t MASK = ((1u << BITS) - 1u) << (23 - BITS);
    const int sh = 23 - BITS - BITS * j;
    const uint32_t f = sh >= 0 ? (w << sh) : (w >> -sh);
    return __uint_as_float((f & MASK) | 0x3F800000u);
}

// A group's scale and zero as the pair (s2, c) = (2^BITS s, -(2^BITS + z) s), both exact in f32
// (at most 21 significant bits), so that w = fma(1 + q / 2^BITS, s2, c) = (q - z) s exactly:
// the one rounding is the later one to T.
template <int BITS>
__device__ __forceinline__ float2 scale_pair(__half s16, uint8_t z) {
    const float s = __half2float(s16);
    const float s2 = s * (float)(1 << BITS);
    return make_float2(s2, -fmaf((float)z, s, s2));
}

// Two adjacent weights as the pair of T: hi = round(w), lo = round(w - hi).
template <typename T>
__device__ __forceinline__ void wg_pair(float w0, float w1, uint32_t& hi, uint32_t& lo) {
    hi = Mma<T>::pack(w0, w1);
    const float2 h = Mma<T>::unpack(hi);
    lo = Mma<T>::pack(w0 - h.x, w1 - h.y);
}

// Forward: the tile's words [64/P][128], scales and zeros [ng][128] and group table [64] (the
// group row of each K row) -> B hi and lo [128 columns][64 K rows] of T (lo WG_BTILE_BYTES
// after hi). Unit u: column n = u % 128, the
// 8 K rows 8c..8c+7 with c = u / 128 (all lanes of a warp share c, so the group test is
// uniform), one 16-byte chunk. UNIFORM (8 | gs, every chunk inside one group): no test, so the
// four units' loads and arithmetic interleave freely.
template <int BITS, typename T, bool UNIFORM>
__device__ __forceinline__ void wg_dequant_fw(const unsigned char* st, const WgStage& L,
                                              unsigned char* bt, int ct) {
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + L.w);
    const __half* ss = reinterpret_cast<const __half*>(st + L.s);
    const uint8_t* zs = st + L.z;
    const uint8_t* tab = st + L.tab;
#pragma unroll
    for (int i = 0; i < (WG_BN * WG_BK / 8) / WG_CONSUMERS; ++i) {
        const int u = ct + i * WG_CONSUMERS;
        const int n = u & (WG_BN - 1), c = u / WG_BN;
        uint32_t lo, hi = 0;   // the chunk's 8 codes, BITS each, lowest row first (hi: 8-bit)
        if constexpr (BITS == 4) {
            lo = ws[c * WG_BN + n];
        } else if constexpr (BITS == 2) {
            lo = ws[(c >> 1) * WG_BN + n] >> (16 * (c & 1));
        } else {
            lo = ws[(2 * c) * WG_BN + n];
            hi = ws[(2 * c + 1) * WG_BN + n];
        }
        float v[8];
        if constexpr (UNIFORM) {
            const int g = tab[8 * c];
            const float2 sc = scale_pair<BITS>(ss[g * WG_BN + n], zs[g * WG_BN + n]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const uint32_t w = (BITS == 8 && e >= 4) ? hi : lo;
                v[e] = fmaf(code_unit<BITS>(w, BITS == 8 ? (e & 3) : e), sc.x, sc.y);
            }
        } else if (const uint2 gt = *reinterpret_cast<const uint2*>(tab + 8 * c);
                   gt.x == gt.y && gt.x == __byte_perm(gt.x, 0, 0)) {   // one group
            const int g = gt.x & 0xFF;
            const float2 sc = scale_pair<BITS>(ss[g * WG_BN + n], zs[g * WG_BN + n]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const uint32_t w = (BITS == 8 && e >= 4) ? hi : lo;
                v[e] = fmaf(code_unit<BITS>(w, BITS == 8 ? (e & 3) : e), sc.x, sc.y);
            }
        } else {                                                 // each code its own group
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int g = tab[8 * c + e];
                const float2 sc = scale_pair<BITS>(ss[g * WG_BN + n], zs[g * WG_BN + n]);
                const uint32_t w = (BITS == 8 && e >= 4) ? hi : lo;
                v[e] = fmaf(code_unit<BITS>(w, BITS == 8 ? (e & 3) : e), sc.x, sc.y);
            }
        }
        uint32_t hv[4], lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) wg_pair<T>(v[2 * e], v[2 * e + 1], hv[e], lv[e]);
        unsigned char* const dst = bt + n * 128 + (((c ^ n) & 7) << 4);
        *reinterpret_cast<uint4*>(dst) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<uint4*>(dst + WG_BTILE_BYTES) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
}

template <int V> struct WgVec;   // V halves as one shared-memory access
template <> struct WgVec<2> { using H = uint32_t; using Z = uint16_t; };
template <> struct WgVec<4> { using H = uint2; using Z = uint32_t; };
template <> struct WgVec<8> { using H = uint4; using Z = uint2; };

// K10: the tile's words [128/P][64], scales and zeros [ng][64] and the block's group table
// [128] -> B hi and lo [128 K rows][64 N] of T (lo WG_BTILE_BYTES after hi). Unit ct
// (exactly one per consumer thread):
// word row r, columns V*q .. V*q+V-1 with V = BITS, so a store is V halves of one K row
// (a half-warp, a warp or 8 lanes cover a whole swizzled row, bank-conflict free). UNIFORM
// (P | gs, every word inside one group): one scale and zero load, the P rows branch-free.
template <int BITS, typename T, bool UNIFORM>
__device__ __forceinline__ void wg_dequant_t(const unsigned char* st, const WgStage& L,
                                             const uint8_t* tab, unsigned char* bt, int ct) {
    constexpr int P = 32 / BITS;
    constexpr int V = BITS;
    constexpr int QN = 64 / V;
    static_assert((128 / P) * QN == WG_CONSUMERS, "one unit per consumer thread");
    const int q = ct % QN, r = ct / QN;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + L.w);
    const __half* ss = reinterpret_cast<const __half*>(st + L.s);
    const uint8_t* zs = st + L.z;
    uint32_t w[V];
#pragma unroll
    for (int c = 0; c < V; c += 2) {
        const uint2 p = *reinterpret_cast<const uint2*>(ws + r * 64 + V * q + c);
        w[c] = p.x;
        w[c + 1] = p.y;
    }
    float s2[V], c0[V];
    int gcur = -1;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const int row = P * r + j;
        const int g = UNIFORM ? tab[P * r] : tab[row];
        if (UNIFORM ? j == 0 : g != gcur) {   // the table is monotonic: reload at each boundary
            gcur = g;
            const typename WgVec<V>::H sv =
                *reinterpret_cast<const typename WgVec<V>::H*>(ss + g * 64 + V * q);
            const typename WgVec<V>::Z zv =
                *reinterpret_cast<const typename WgVec<V>::Z*>(zs + g * 64 + V * q);
            const __half* sh = reinterpret_cast<const __half*>(&sv);
            const uint8_t* zh = reinterpret_cast<const uint8_t*>(&zv);
#pragma unroll
            for (int c = 0; c < V; ++c) {
                const float2 sc = scale_pair<BITS>(sh[c], zh[c]);
                s2[c] = sc.x;
                c0[c] = sc.y;
            }
        }
        uint32_t hv[V / 2], lv[V / 2];
#pragma unroll
        for (int c = 0; c < V; c += 2)
            wg_pair<T>(fmaf(code_unit<BITS>(w[c], j), s2[c], c0[c]),
                       fmaf(code_unit<BITS>(w[c + 1], j), s2[c + 1], c0[c + 1]), hv[c / 2],
                       lv[c / 2]);
        unsigned char* const hi = bt + wg_swz(row, V * q);
        unsigned char* const lo = hi + WG_BTILE_BYTES;
        if constexpr (V == 2) {
            *reinterpret_cast<uint32_t*>(hi) = hv[0];
            *reinterpret_cast<uint32_t*>(lo) = lv[0];
        } else if constexpr (V == 4) {
            *reinterpret_cast<uint2*>(hi) = make_uint2(hv[0], hv[1]);
            *reinterpret_cast<uint2*>(lo) = make_uint2(lv[0], lv[1]);
        } else {
            *reinterpret_cast<uint4*>(hi) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
            *reinterpret_cast<uint4*>(lo) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
        }
    }
}

// ---- the kernel body ------------------------------------------------------------------------

struct WgParams {
    const void* bias;        // forward: T [N] or null
    void* out;               // forward: y [M, N]; K10: dx [M, K]
    const int64_t* kperm;    // K10: dx column kperm[k] takes sorted row k; null: identity
    float* ws;               // split > 1: f32 partials [splits, M, out columns]
    int* counters;           // split > 1: ticket per output tile, 0 between launches
    int M, K, N, gs, ng, stages, ktiles, per;
    int uniform;             // every dequant unit lies in one group: 8 | gs (K10: P | gs)
    const float* rstd;       // PRENORM: rsqrt(mean(x^2) + eps) of each row (wg_rstd)
    Prenorm pn;              // PRENORM: the norm weight's dtype, eps and plus_one
};

// TRANS = false: the forward (reduction K, output columns N); true: K10 (reduction N, output
// columns K). The output tile is BM x 128: BM = 256 or 128, each consumer warpgroup BM / 2 rows
// in MH = BM / 128 wgmma halves of 64; BM = 64, each warpgroup 64 columns (WN = 2).
// KB32L: the words are K6's kb32l tiles, read through the 3-D map of launch_wgmma (a stage
// holds the same words as GPTQ's map gives: [64/P][128] in the forward, [128/P][64] in K10,
// at (64 (t % 2), 16 blockIdx.x, t / 2) for reduction tile t). PRENORM (forward,
// BM = 64, M < 32): the fused RMS-norm prologue of wna16_gemm.cuh on the x tiles in shared
// memory: each stage brings its tile's 64 norm weights by TMA (tm_n), and the producer
// warpgroup's three warps that issue no TMA (96 threads, within the producer's 40 registers:
// every warp keeping the kernel's 168 was slower, chip_wgmma_probe.py --prenorm, PERF.md)
// normalize each landed x tile in place
// (16-byte chunks of TMA's swizzle: rows x 8 chunks), fence.proxy.async and arrive on the
// stage's `normed` mbarrier, which the consumers wait for after their dequant of the tile and
// before the barrier that the tile's wgmmas follow; the ring runs ahead, so the normalization
// stays off the consumers' path. rstd comes from wg_rstd_kernel, the launch before this one
// on the stream (programmatic dependent launch: this kernel starts while it runs, and only the
// normalizing warps wait for it, with griddepcontrol.wait).
template <int BITS, typename T, int BM, bool TRANS, bool KB32L = false, bool PRENORM = false>
__device__ __forceinline__ void wg_body(const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                                        const CUtensorMap* tm_s, const CUtensorMap* tm_z,
                                        const CUtensorMap* tm_n, const WgParams& p) {
    static_assert(!(TRANS && PRENORM), "the prologue is the forward's");
    static_assert(!KB32L || BITS == 4, "kb32l words hold 4-bit storage");
    static_assert(!PRENORM || (BM == 64 && !KB32L && BITS == 4),
                  "the prologue: 4-bit storage, GPTQ words, one 64-row block (M < 32)");
    constexpr int P = 32 / BITS;
    static_assert(BM == 64 || BM == 128 || BM == 256, "block heights 64, 128, 256");
    constexpr int WN = BM == 64 ? 2 : 1;      // consumer warpgroups along the columns
    constexpr int MH = BM == 256 ? 2 : 1;     // 64-row wgmma halves per consumer warpgroup
    constexpr int NW = WG_BN / WN;     // wgmma N per consumer warpgroup
    constexpr int NACC = NW / 2;       // f32 accumulators per thread
    constexpr int SW = TRANS ? 64 : WG_BN;   // columns of a stage's words, scales and zeros
    extern __shared__ unsigned char wg_smem_raw[];
    __shared__ __align__(8) uint64_t full[WG_MAX_STAGES], empty[WG_MAX_STAGES];
    __shared__ __align__(8) uint64_t normed[PRENORM ? WG_MAX_STAGES : 1];   // x tile normalized
    __shared__ float rstd_s[PRENORM ? PN_MAX_ROWS : 1];
    __shared__ uint8_t ttab[TRANS ? WG_BN : 1];   // K10: the group row of the block's K rows
    __shared__ int last_block;
    unsigned char* const base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
    const WgStage L(BITS, BM, p.ng, TRANS, PRENORM);
    unsigned char* const btiles = base + p.stages * L.bytes;
    const int tid = threadIdx.x;
    const int o0 = blockIdx.x * WG_BN;   // output columns (N; K10: K rows)
    const int m0 = blockIdx.y * BM;
    const int t0 = blockIdx.z * p.per;
    const int ntl = min(p.per, p.ktiles - t0);   // >= 1 (ops/gemm.py:wgmma_plan)
    const int S = p.stages;
    const int rows_out = TRANS ? p.K : p.N;

    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(smem_u32(&full[s]), 1);
            mbar_init(smem_u32(&empty[s]), WG_CONSUMERS / 32);
            if constexpr (PRENORM) mbar_init(smem_u32(&normed[s]), WG_NORMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (TRANS) {
        if (tid >= 128) {   // K rows o0 .. o0+127 fixed for the block: one division each
            const int r = tid - 128;
            ttab[r] = (uint8_t)((o0 + r) / p.gs - o0 / p.gs);
        }
    }
    __syncthreads();

    if (tid < 128) {
        // ---- producer warpgroup: warp 0 keeps the ring full --------------------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
        if (tid >= 32) {
            if constexpr (PRENORM) {   // warps 1-3: x_n = to_T(f32(x) * rstd * w) in place
                const int nt = tid - 32;
                const int nrows = min(p.M - m0, PN_MAX_ROWS);
                asm volatile("griddepcontrol.wait;\n" ::: "memory");   // wg_rstd_kernel's rstd
                if (nt < nrows) rstd_s[nt] = p.rstd[m0 + nt];
                asm volatile("bar.sync 2, %0;\n" ::"n"(WG_NORMERS) : "memory");
                const int q = nt & 7;   // every chunk of this thread is column chunk q
                for (int tl = 0; tl < ntl; ++tl) {
                    const int s = tl % S;
                    mbar_wait(smem_u32(&full[s]), (tl / S) & 1);
                    unsigned char* const st = base + s * L.bytes;
                    float w[8];            // columns past K: TMA's zero weights (times 0)
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        w[e] = prenorm_weight_at(st + L.nw, p.pn.wdt, 8 * q + e, p.pn.plus_one);
#pragma unroll 1
                    for (int r = nt >> 3; r < nrows; r += WG_NORMERS / 8) {   // rows past M: 0
                        uint4* const chunk =
                            reinterpret_cast<uint4*>(st + L.a + r * 128 + (((q ^ r) & 7) << 4));
                        uint4 raw = *chunk;
                        uint32_t* const pair = reinterpret_cast<uint32_t*>(&raw);
                        const float rs = rstd_s[r];
#pragma unroll
                        for (int e = 0; e < 4; ++e) {   // prenorm_apply's f32(x) * rstd * w
                            const float2 f = Mma<T>::unpack(pair[e]);
                            pair[e] = Mma<T>::pack(f.x * rs * w[2 * e], f.y * rs * w[2 * e + 1]);
                        }
                        *chunk = raw;
                    }
                    fence_proxy_async();   // the wgmmas read the tile through the async proxy
                    mbar_arrive(smem_u32(&normed[s]));
                }
            }
            return;
        }
        const int lane = tid;
        const uint32_t tx = BM * 128 + 1024 * BITS + p.ng * SW * 3 +
                            (PRENORM ? WG_BK * prenorm_wsize(p.pn.wdt) : 0);
        for (int tl = 0; tl < ntl; ++tl) {
            const int s = tl % S;
            if (tl >= S) mbar_wait(smem_u32(&empty[s]), ((tl / S) + 1) & 1);
            unsigned char* st = base + s * L.bytes;
            const int t = t0 + tl;
            const int r0 = t * WG_BK;   // first reduction row of the tile
            if constexpr (!TRANS) {     // the group row of each of the tile's 64 K rows
                const int g0 = r0 / p.gs;
                for (int r = lane; r < WG_BK; r += 32) st[L.tab + r] = (uint8_t)((r0 + r) / p.gs - g0);
            }
            __syncwarp();
            if (lane == 0) {
                const uint32_t bar = smem_u32(&full[s]);
                mbar_expect_tx(bar, tx);
                tma_load_2d(smem_u32(st + L.a), tm_a, bar, r0, m0);
                if constexpr (TRANS) {
                    if constexpr (KB32L)   // columns r0 % 128.. of word rows o0/P.. of tile r0/128
                        tma_load_3d(smem_u32(st + L.w), tm_w, bar, r0 % KB32L_BN, o0 / P,
                                    r0 / KB32L_BN);
                    else
                        tma_load_2d(smem_u32(st + L.w), tm_w, bar, r0, o0 / P);
                    tma_load_2d(smem_u32(st + L.s), tm_s, bar, r0, o0 / p.gs);
                    tma_load_2d(smem_u32(st + L.z), tm_z, bar, r0, o0 / p.gs);
                } else {
                    if constexpr (KB32L)   // word rows r0/P.. of column tile o0/128
                        tma_load_3d(smem_u32(st + L.w), tm_w, bar, 0, r0 / P, o0 / WG_BN);
                    else
                        tma_load_2d(smem_u32(st + L.w), tm_w, bar, o0, r0 / P);
                    tma_load_2d(smem_u32(st + L.s), tm_s, bar, o0, r0 / p.gs);
                    tma_load_2d(smem_u32(st + L.z), tm_z, bar, o0, r0 / p.gs);
                    if constexpr (PRENORM) tma_load_2d(smem_u32(st + L.nw), tm_n, bar, r0, 0);
                }
            }
        }
        return;
    }

    // ---- consumer warpgroups ---------------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
    const int ct = tid - 128;      // 0..255
    const int cw = ct >> 7;        // consumer warpgroup
    const int lane = tid & 31;
    const uint32_t a_off = WN == 1 ? cw * (BM / 2) * 128 : 0;         // this warpgroup's rows
    const uint32_t b_off = WN == 2 ? cw * 64 * 128 : 0;               // and columns

    auto dequant = [&](int tl) {
        const unsigned char* st = base + (tl % S) * L.bytes;
        unsigned char* bt = btiles + (tl % WG_BTILES) * 2 * WG_BTILE_BYTES;
        if constexpr (TRANS) {
            if (p.uniform)
                wg_dequant_t<BITS, T, true>(st, L, ttab, bt, ct);
            else
                wg_dequant_t<BITS, T, false>(st, L, ttab, bt, ct);
        } else {
            if (p.uniform)
                wg_dequant_fw<BITS, T, true>(st, L, bt, ct);
            else
                wg_dequant_fw<BITS, T, false>(st, L, bt, ct);
        }
    };

    auto normalized = [&](int tl) {   // PRENORM: the normalizing warps are done with tile tl
        if constexpr (PRENORM) mbar_wait(smem_u32(&normed[tl % S]), (tl / S) & 1);
    };

    float acc[MH][NACC];
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[h][i] = 0.0f;

    mbar_wait(smem_u32(&full[0]), 0);
    dequant(0);
    normalized(0);
    fence_proxy_async();
    consumers_sync();
    for (int tl = 0; tl < ntl; ++tl) {
        const uint32_t a_addr = smem_u32(base + (tl % S) * L.bytes + L.a) + a_off;
        const uint32_t b_addr = smem_u32(btiles + (tl % WG_BTILES) * 2 * WG_BTILE_BYTES) + b_off;
        const uint64_t da = wg_desc(a_addr);
        const uint64_t db = wg_desc(b_addr);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)   // +32 bytes per 16-deep step
#pragma unroll
            for (int b = 0; b < 2; ++b)           // B hi, then lo (+16 KB)
#pragma unroll
                for (int h = 0; h < MH; ++h)      // +8192 bytes per 64-row half
                    Wgmma<T, NW>::run(acc[h], da + h * (8192 >> 4) + 2 * kk,
                                      db + b * (WG_BTILE_BYTES >> 4) + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();                 // tile tl-1's wgmmas are done: release its stage
#pragma unroll
        for (int h = 0; h < MH; ++h) wg_fence_acc(acc[h]);
        if (tl >= 1 && lane == 0) mbar_arrive(smem_u32(&empty[(tl - 1) % S]));
        if (tl + 1 < ntl) {
            mbar_wait(smem_u32(&full[(tl + 1) % S]), ((tl + 1) / S) & 1);
            dequant(tl + 1);
            normalized(tl + 1);
            fence_proxy_async();
        }
        consumers_sync();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < MH; ++h) wg_fence_acc(acc[h]);

    // ---- epilogue: fragment (i, h, e) of half mh is row 64 mh + 16 w + lane / 4 + 8 h, column
    // 8 i + 2 (lane % 4) + e of the warpgroup's tile --------------------------------------------
    const int wrow = m0 + (WN == 1 ? cw * (BM / 2) : 0) + 16 * ((ct & 127) >> 5) + (lane >> 2);
    const int wcol = o0 + (WN == 2 ? cw * 64 : 0) + 2 * (lane & 3);
    auto store = [&](int row, int col, float v0, float v1) {
        if constexpr (TRANS) {
            T* o = static_cast<T*>(p.out) + (int64_t)row * p.K;
            if (p.kperm == nullptr) {
                store2(o + col, v0, v1);
            } else {
                o[p.kperm[col]] = from_f32<T>(v0);
                o[p.kperm[col + 1]] = from_f32<T>(v1);
            }
        } else {
            if (p.bias != nullptr) {
                const T* b = static_cast<const T*>(p.bias);
                v0 += to_f32(b[col]);
                v1 += to_f32(b[col + 1]);
            }
            store2(static_cast<T*>(p.out) + (int64_t)row * p.N + col, v0, v1);
        }
    };
    // columns come in pairs: N % 4 == 0 (forward), K even (K10), so col < limit means col + 1 too
    if (gridDim.z == 1) {
#pragma unroll
        for (int mh = 0; mh < MH; ++mh)
#pragma unroll
            for (int i = 0; i < NW / 8; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = wrow + 64 * mh + 8 * h, col = wcol + 8 * i;
                    if (row < p.M && col < rows_out)
                        store(row, col, acc[mh][4 * i + 2 * h], acc[mh][4 * i + 2 * h + 1]);
                }
        return;
    }
    const int64_t plane = (int64_t)p.M * rows_out;
    float* const part = p.ws + blockIdx.z * plane;
#pragma unroll
    for (int mh = 0; mh < MH; ++mh)
#pragma unroll
        for (int i = 0; i < NW / 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = wrow + 64 * mh + 8 * h, col = wcol + 8 * i;
                if (row < p.M && col < rows_out)
                    *reinterpret_cast<float2*>(part + (int64_t)row * rows_out + col) =
                        make_float2(acc[mh][4 * i + 2 * h], acc[mh][4 * i + 2 * h + 1]);
            }
    // The ticket (as wna16_gemv.cuh's): after the barrier one acquire-release add publishes the
    // block's partial and, for the last block, makes every other split's visible.
    consumers_sync();
    if (ct == 0) {
        int* ctr = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
        int ticket;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(ticket)
                     : "l"(ctr)
                     : "memory");
        last_block = ticket == (int)gridDim.z - 1;
        if (last_block) *ctr = 0;
    }
    consumers_sync();
    if (!last_block) return;
#pragma unroll
    for (int mh = 0; mh < MH; ++mh)
#pragma unroll
        for (int i = 0; i < NW / 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = wrow + 64 * mh + 8 * h, col = wcol + 8 * i;
                if (row >= p.M || col >= rows_out) continue;
                const float* src = p.ws + (int64_t)row * rows_out + col;
                float v0 = 0.0f, v1 = 0.0f;
                for (int z = 0; z < (int)gridDim.z; ++z) {   // split order
                    const float2 v = __ldcg(reinterpret_cast<const float2*>(src + z * plane));
                    v0 += v.x;
                    v1 += v.y;
                }
                store(row, col, v0, v1);
            }
}

template <int BITS, typename T, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
wna16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_z,
                   const WgParams p) {
    wg_body<BITS, T, BM, false>(&tm_x, &tm_w, &tm_s, &tm_z, nullptr, p);
}

template <int BITS, typename T, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
wna16_t_wgmma_kernel(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_z,
                     const WgParams p) {
    wg_body<BITS, T, BM, true>(&tm_g, &tm_w, &tm_s, &tm_z, nullptr, p);
}

// K6's tile regime: the forward over kb32l words (4-bit storage), tm_w the 3-D map of the tiles.
template <typename T, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
kb32l_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_z,
                   const WgParams p) {
    wg_body<4, T, BM, false, true>(&tm_x, &tm_w, &tm_s, &tm_z, nullptr, p);
}

// K10 over kb32l words (4-bit storage), tm_w the 3-D map of the tiles with K10's box.
template <typename T, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
kb32l_t_wgmma_kernel(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_z,
                     const WgParams p) {
    wg_body<4, T, BM, true, true>(&tm_g, &tm_w, &tm_s, &tm_z, nullptr, p);
}

// K1's fused RMS-norm prologue on the forward (M < 32: one 64-row block), tm_n the norm weight.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
wna16_prenorm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_s,
                           const __grid_constant__ CUtensorMap tm_z,
                           const __grid_constant__ CUtensorMap tm_n, const WgParams p) {
    wg_body<4, T, 64, false, false, true>(&tm_x, &tm_w, &tm_s, &tm_z, &tm_n, p);
}

// rstd[i] = rsqrt(mean(x[i, 0:K]^2) + eps) of row i = blockIdx.x over its full K, for the fused
// prologue of wna16_prenorm_wgmma_kernel, the next launch on the stream. One block of 256 threads per
// row: each thread sums the squares of its 16-byte runs (four in flight), the 8 warps' sums are
// added in warp order, so every call gets the same rstd. It lets the next launch start at once
// (griddepcontrol.launch_dependents); that kernel waits for this one's results only where it
// first needs them. Once per call, it reads M x K activations from L2 once, where rstd taken in
// every block of a split reduction (up to 256 blocks at Llama-2-7B's q/k/v) read them once per
// block, up to 31 x K x 2 bytes each, before the block's first normalized tile.
template <typename T>
__global__ void __launch_bounds__(256) wg_rstd_kernel(const T* __restrict__ x, int K, float eps,
                                                      float* __restrict__ rstd) {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    constexpr int VEC = 16 / (int)sizeof(T);
    constexpr int U = 4;
    __shared__ float red[8];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (int64_t)blockIdx.x * K);
    const int runs = K / VEC;      // K % 8 == 0 and x 16-byte aligned (wna16_wgmma checks)
    float s = 0.0f;
    for (int c0 = tid; c0 < runs; c0 += U * 256) {
        uint4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
            v[u] = c0 + u * 256 < runs ? __ldg(xr + c0 + u * 256) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int u = 0; u < U; ++u) s += sumsq16<T>(v[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (tid == 0) {
        float t = 0.0f;
        for (int w = 0; w < 8; ++w) t += red[w];
        rstd[blockIdx.x] = rsqrtf(t / (float)K + eps);
    }
}

// ---- host side ------------------------------------------------------------------------------

using WgEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the CUDA runtime's entry-point lookup; null if it is missing.
inline WgEncodeTiled wg_encoder() {
    static const WgEncodeTiled fn = []() -> WgEncodeTiled {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t err =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
        return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<WgEncodeTiled>(f)
                   : nullptr;
    }();
    return fn;
}

// A map of `rank` dimensions (innermost first: dims, the byte strides of dims 1.., the box).
inline int wg_encode_nd(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                        const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                        bool swizzle) {
    const WgEncodeTiled enc = wg_encoder();
    if (enc == nullptr) return WG_ENCODE_ERROR + (int)CUDA_ERROR_NOT_FOUND;
    const cuuint32_t estr[3] = {1, 1, 1};
    const CUresult r = enc(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box,
                           estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : WG_ENCODE_ERROR + (int)r;
}

// A 2-D map of rows of `cols` elements (`row_bytes` apart), boxes of box_cols x box_rows.
inline int wg_encode(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                     int cols, int rows, int box_cols, int box_rows, bool swizzle) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    return wg_encode_nd(map, type, 2, ptr, dims, strides, box, swizzle);
}

// The kb32l words [N_pad/128][K_pad/8][128] of int32 (kb32l_tile.cuh: tiles column tile first,
// so one column tile's K tiles are contiguous) as a 3-D map, innermost first: 128 columns (4
// bytes), K_pad/8 word rows (512 bytes apart), N_pad/128 column tiles (K_pad/8 * 512 bytes
// apart); the box (box_cols, box_rows, 1): the forward's (128, 64/P, 1) is the [64/P][128] words
// of one reduction tile, K10's (64, 128/P, 1) the [128/P][64] words of its 128 K rows by one
// reduction tile, as GPTQ's maps give them (ops/gemm.py:kb32l_word_map is the same map).
inline int wg_encode_kb32l(CUtensorMap* map, const int32_t* qweight, int k_pad, int n_pad,
                           int box_cols, int box_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)KB32L_BN, (cuuint64_t)(k_pad / 8),
                                (cuuint64_t)(n_pad / KB32L_BN)};
    const cuuint64_t strides[2] = {(cuuint64_t)KB32L_BN * 4,
                                   (cuuint64_t)(k_pad / 8) * KB32L_BN * 4};
    const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
    return wg_encode_nd(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, qweight, dims, strides, box, false);
}

template <typename T> constexpr CUtensorMapDataType wg_type();
template <> constexpr CUtensorMapDataType wg_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <> constexpr CUtensorMapDataType wg_type<__half>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// One launch: a = x [M, K] (forward) or g [M, N] (K10). stages and splits come from
// ops/gemm.py:wgmma_plan; the split of the reduction into `splits` runs of `per` tiles must
// leave none empty. ld: the row stride of the scales and zeros (N; kb32l: N_pad, with K_pad / gs
// group rows). PRENORM: pn names the norm weight [K] (its dtype code, eps, plus_one), and rstd
// [M] is what wg_rstd, launched just before on the same stream, writes.
template <int BITS, typename T, int BM, bool TRANS, bool KB32L = false, bool PRENORM = false>
int launch_wgmma(const void* a, const int32_t* qweight, const void* scales, const uint8_t* zeros,
                 const void* bias, const int64_t* kperm, void* out, float* ws, int* counters,
                 int M, int K, int N, int ld, int gs, int stages, int splits, cudaStream_t stream,
                 const float* rstd, Prenorm pn) {
    constexpr int P = 32 / BITS;
    const int red = TRANS ? N : K;                 // the reduction
    const int cols_out = TRANS ? K : N;
    const int ktiles = (red + WG_BK - 1) / WG_BK;
    const int per = (ktiles + splits - 1) / splits;
    const int ng = stage_groups(gs, TRANS ? WG_BN : WG_BK);
    const int k_pad = KB32L ? (K + KB32L_KB - 1) / KB32L_KB * KB32L_KB : K;
    const int G = (k_pad + gs - 1) / gs;
    const int smem = wg_smem_bytes(BITS, BM, ng, TRANS, stages, PRENORM);
    if (stages < 2 || stages > WG_MAX_STAGES || splits < 1 || (splits - 1) * per >= ktiles ||
        smem > MMA_SMEM_LIMIT || ng > 255 || (M + BM - 1) / BM > 65535 ||
        (splits > 1 && (ws == nullptr || counters == nullptr)) || (PRENORM && rstd == nullptr))
        return (int)cudaErrorInvalidValue;
    CUtensorMap tm_a, tm_w, tm_s, tm_z, tm_n;
    int err;
    if constexpr (TRANS) {
        if ((err = wg_encode(&tm_a, wg_type<T>(), 2, a, N, M, WG_BK, BM, true))) return err;
        if constexpr (KB32L) {
            if ((err = wg_encode_kb32l(&tm_w, qweight, k_pad, ld, 64, WG_BN / P))) return err;
        } else {
            if ((err = wg_encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qweight, N, K / P, 64,
                                 WG_BN / P, false))) return err;
        }
        if ((err = wg_encode(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, scales, ld, G, 64, ng,
                             false))) return err;
        if ((err = wg_encode(&tm_z, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, zeros, ld, G, 64, ng,
                             false))) return err;
    } else {
        if ((err = wg_encode(&tm_a, wg_type<T>(), 2, a, K, M, WG_BK, BM, true))) return err;
        if constexpr (KB32L) {
            if ((err = wg_encode_kb32l(&tm_w, qweight, k_pad, ld, WG_BN, WG_BK / P))) return err;
        } else {
            if ((err = wg_encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qweight, N, K / P,
                                 WG_BN, WG_BK / P, false))) return err;
        }
        if ((err = wg_encode(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, scales, ld, G, WG_BN, ng,
                             false))) return err;
        if ((err = wg_encode(&tm_z, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, zeros, ld, G, WG_BN, ng,
                             false))) return err;
        if constexpr (PRENORM) {   // the norm weight as one row of K, a tile's 64 per box
            const CUtensorMapDataType nt = pn.wdt == DT_F32   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : pn.wdt == DT_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
            if ((err = wg_encode(&tm_n, nt, prenorm_wsize(pn.wdt), pn.w, K, 1, WG_BK, 1, false)))
                return err;
        }
    }
    const WgParams prm{bias, out,    kperm,  ws,  counters, M,
                       K,    N,      gs,     ng,  stages,   ktiles,
                       per,  gs % (TRANS ? P : 8) == 0, rstd, pn};
    const dim3 grid((cols_out + WG_BN - 1) / WG_BN, (M + BM - 1) / BM, splits);
    // one kernel per library, direction and word layout: no stray instances
    if constexpr (PRENORM) {
        static const cudaError_t attr = allow_smem(wna16_prenorm_wgmma_kernel<T>, MMA_SMEM_LIMIT);
        if (attr != cudaSuccess) return (int)attr;
        cudaLaunchAttribute pdl[1];   // may start while wg_rstd_kernel runs
        pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        pdl[0].val.programmaticStreamSerializationAllowed = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(WG_THREADS);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        cfg.attrs = pdl;
        cfg.numAttrs = 1;
        const cudaError_t err2 = cudaLaunchKernelEx(&cfg, wna16_prenorm_wgmma_kernel<T>, tm_a,
                                                    tm_w, tm_s, tm_z, tm_n, prm);
        if (err2 != cudaSuccess) return (int)err2;
    } else {
        void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                       const WgParams);
        if constexpr (TRANS && KB32L)
            kernel = kb32l_t_wgmma_kernel<T, BM>;
        else if constexpr (TRANS)
            kernel = wna16_t_wgmma_kernel<BITS, T, BM>;
        else if constexpr (KB32L)
            kernel = kb32l_wgmma_kernel<T, BM>;
        else
            kernel = wna16_wgmma_kernel<BITS, T, BM>;
        static const cudaError_t attr = allow_smem(kernel, MMA_SMEM_LIMIT);
        if (attr != cudaSuccess) return (int)attr;
        kernel<<<grid, WG_THREADS, smem, stream>>>(tm_a, tm_w, tm_s, tm_z, prm);
    }
    return (int)cudaGetLastError();
}

// KB32L: n_pad is the kb32l words' padded width (a multiple of 128 within 128 of N), the
// forward's or K10's. PRENORM:
// the fused prologue, M < 32 at bm 64 (ops/gemm.py:wgmma_plan), 32 | gs, rstd [M] from wg_rstd.
template <int BITS, bool TRANS, bool KB32L = false, bool PRENORM = false>
int wna16_wgmma(const void* a, const int32_t* qweight, const void* scales, const uint8_t* zeros,
                const void* bias, const int64_t* kperm, void* out, float* ws, int* counters,
                int dtype, int M, int K, int N, int gs, int bm, int stages, int splits,
                void* stream, int n_pad = 0, const float* rstd = nullptr, Prenorm pn = Prenorm{}) {
    constexpr int P = 32 / BITS;
    // the alignment TMA needs (ops/gemm.py:wgmma_shape_ok; kb32l maps are n_pad wide, the
    // forward's epilogue stores column pairs and K10's g rows are 16-byte strides), K in whole
    // words, a positive group
    if (M <= 0 || K <= 0 || N <= 0 || K % P != 0 || K % 8 != 0 ||
        N % (KB32L ? (TRANS ? 8 : 4) : 16) != 0 ||
        gs <= 0 || (bm != 64 && bm != 128 && bm != 256))
        return (int)cudaErrorInvalidValue;
    if (KB32L && (gs % 32 != 0 || KB32L_KB % gs != 0 || K % gs != 0 || n_pad % KB32L_BN != 0 ||
                  n_pad < N || n_pad - N >= KB32L_BN))
        return (int)cudaErrorInvalidValue;
    if (PRENORM && (!prenorm_ok(M, pn) || bm != 64 || gs % 32 != 0 || rstd == nullptr ||
                    (reinterpret_cast<uintptr_t>(pn.w) & 15) != 0 ||
                    (reinterpret_cast<uintptr_t>(a) & 15) != 0))
        return (int)cudaErrorInvalidValue;
    const int ld = KB32L ? n_pad : N;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WG_LAUNCH(TT, BM)                                                                      \
    launch_wgmma<BITS, TT, BM, TRANS, KB32L, PRENORM>(a, qweight, scales, zeros, bias, kperm,  \
                                                      out, ws, counters, M, K, N, ld, gs,      \
                                                      stages, splits, st, rstd, pn)
    if constexpr (PRENORM) {   // one 64-row block
        switch (dtype) {
            case DT_F16: return WG_LAUNCH(__half, 64);
            case DT_BF16: return WG_LAUNCH(__nv_bfloat16, 64);
            default: return (int)cudaErrorInvalidValue;
        }
    } else {
        switch (dtype) {
            case DT_F16:
                return bm == 256 ? WG_LAUNCH(__half, 256)
                                 : bm == 128 ? WG_LAUNCH(__half, 128) : WG_LAUNCH(__half, 64);
            case DT_BF16:
                return bm == 256 ? WG_LAUNCH(__nv_bfloat16, 256)
                                 : bm == 128 ? WG_LAUNCH(__nv_bfloat16, 128)
                                             : WG_LAUNCH(__nv_bfloat16, 64);
            default:   // f32 activations take the SIMT kernels
                return (int)cudaErrorInvalidValue;
        }
    }
#undef WG_LAUNCH
}

// rstd [M] of x [M, K] (bf16 or f16, 16-byte aligned, K % 8 == 0) by wg_rstd_kernel: the fused
// prologue's rows, launched just before its product on the same stream.
inline int wg_rstd(const void* x, float* rstd, int dtype, int M, int K, float eps, void* stream) {
    if (M <= 0 || K <= 0 || K % 8 != 0 || rstd == nullptr ||
        (reinterpret_cast<uintptr_t>(x) & 15) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F16:
            wg_rstd_kernel<__half><<<M, 256, 0, st>>>(static_cast<const __half*>(x), K, eps, rstd);
            break;
        case DT_BF16:
            wg_rstd_kernel<__nv_bfloat16><<<M, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                            K, eps, rstd);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Exports `int NAME_wgmma(...)`: the forward over GPTQ words of BITS-bit codes, x already
// gathered by kperm; bm, stages and splits from ops/gemm.py:wgmma_plan.
#define WNA16_WGMMA_DEFINE_ENTRY(NAME, BITS)                                                    \
    extern "C" int NAME##_wgmma(const void* x, const int32_t* qweight, const void* scales,      \
                                const uint8_t* zeros, const void* bias, void* out, float* ws,   \
                                int* counters, int dtype, int M, int K, int N, int gs, int bm,  \
                                int stages, int splits, void* stream) {                         \
        return wna16_wgmma<BITS, false>(x, qweight, scales, zeros, bias, nullptr, out, ws,      \
                                        counters, dtype, M, K, N, gs, bm, stages, splits,       \
                                        stream);                                                \
    }

// Exports `int NAME_wgmma_norm(...)`: the forward with the fused RMS-norm prologue (M < 32,
// 4-bit storage), the arguments of NAME_wgmma with the rows' rstd after the counters and the
// norm weight, its dtype code, eps and plus_one before the stream; and `int
// NAME_wgmma_norm_rstd(x, rstd, dtype, M, K, eps, stream)`, that rstd, launched just before.
#define WNA16_WGMMA_NORM_DEFINE_ENTRY(NAME, BITS)                                               \
    extern "C" int NAME##_wgmma_norm(const void* x, const int32_t* qweight, const void* scales, \
                                     const uint8_t* zeros, const void* bias, void* out,         \
                                     float* ws, int* counters, const float* rstd, int dtype,    \
                                     int M, int K, int N, int gs, int bm, int stages,           \
                                     int splits, const void* nw, int nw_dtype, float eps,       \
                                     int plus_one, void* stream) {                              \
        static_assert(BITS == 4, "the fused prologue takes 4-bit storage");                    \
        return wna16_wgmma<BITS, false, false, true>(x, qweight, scales, zeros, bias, nullptr,  \
                                                     out, ws, counters, dtype, M, K, N, gs, bm, \
                                                     stages, splits, stream, 0, rstd,           \
                                                     Prenorm{nw, nw_dtype, eps, plus_one});     \
    }                                                                                           \
    extern "C" int NAME##_wgmma_norm_rstd(const void* x, float* rstd, int dtype, int M, int K,  \
                                          float eps, void* stream) {                            \
        return wg_rstd(x, rstd, dtype, M, K, eps, stream);                                      \
    }

// Exports `int NAME_wgmma(...)`: K10 over GPTQ words of BITS-bit codes, dx through kperm (K10
// over kb32l words: w4a16_kb32l_gemm_t_wgmma in wna16_gemm_t.cu).
#define WNA16_T_WGMMA_DEFINE_ENTRY(NAME, BITS)                                                  \
    extern "C" int NAME##_wgmma(const void* g, const int64_t* kperm, const int32_t* qweight,    \
                                const void* scales, const uint8_t* zeros, void* dx, float* ws,  \
                                int* counters, int dtype, int M, int K, int N, int gs, int bm,  \
                                int stages, int splits, void* stream) {                         \
        return wna16_wgmma<BITS, true>(g, qweight, scales, zeros, nullptr, kperm, dx, ws,       \
                                       counters, dtype, M, K, N, gs, bm, stages, splits,        \
                                       stream);                                                 \
    }
