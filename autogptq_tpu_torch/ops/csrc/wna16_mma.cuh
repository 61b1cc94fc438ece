// Tensor-core tile kernels of the wNa16 dequant-matmuls for Hopper (sm_90a), bf16 and f16
// activations, BITS in {2, 4, 8} (3-bit codes ride in nibbles):
//   wna16_mma_kernel    y[M,N]  = x[M,K] @ ((q - z) * s)[K,N] (+ bias)   K1, K4, K5, K6
//   wna16_t_mma_kernel  dx[M,K] = g[M,N] @ ((q - z) * s)[K,N]^T           K10
// Each library instantiates them beside its SIMT kernels (wna16_gemm.cuh, wna16_gemm_t.cuh,
// w4a16_kb32l_gemm.cu) and exports them as NAME_mma; ops/gemm.py:tile_kernel routes bf16 and
// f16 products here above 16 rows over kb32l words, with the fused RMS-norm prologue and where
// TMA cannot address the shape: over GPTQ words the wgmma/TMA kernels of wna16_wgmma.cuh took
// the rest of this route (kernel="mma" names these for a timing beside them). (At M <= 16 the forward takes the
// tensor-core decode GEMV of wna16_gemv.cuh from gs 16 on and the SIMT GEMV below, K6 its GEMV
// over kb32l words, ops/gemm.py:route, and K10 its split-N decode regime of wna16_gemv_t.cuh,
// ops/gemm.py:t_route; kernel="mma" still names the tile kernels there). f32 activations stay on the SIMT kernels. Each kernel has two instances per
// library and type: the one of the group sizes 16 divides, and ANY_GS for the others (the
// "rest classes").
//
// They replace the prefill regime of the TPU kernels autogptq_tpu/ops/pallas/gemm.py:
// _kernel_kb32 (:487; _matmul_kb32 :559, and _matmul_kb32l :635 with lin=True), _kernel_ki32,
// _kernel_kpair, _kernel_k2i32, _kernel_kquad and the planar _kernel, which dequantize in f32,
// cast to dot_dtype (bf16) and dot on the MXU with f32 accumulation (:523-537); and the
// backward kernels _kernel_kb32_t (:811), _kernel_ki32_t (:1031) and _kernel_kpair_t (:1289),
// which dot in bf16 (dot_dtype=jnp.bfloat16 at :1452).
//
// Bound on the H100: at a training step's M = 2048 both are bound by operations, 2*M*K*N at
// 989 TFLOP/s bf16 dense: 0.0695 ms per 4096x4096 product, 0.838 ms per Llama-2-7B layer.
//
// Design (mma.sync.m16n8k16 with f32 accumulators; wgmma and TMA are not used):
//  * Forward: a 128 x 128 output tile per block of 8 warps (2 x 4, a 64 x 32 tile each), K in
//    tiles of 64 rows. A 4-stage cp.async ring holds, per K tile, x [128 x 64] (rows padded to
//    72 halves, so the 8 rows an ldmatrix reads sit on distinct banks), the packed words
//    [64/P x 128] and the fp16 scales and uint8 zeros of the (at most 4) groups the tile's
//    16-row steps touch. One barrier per K tile: the copy of tile t+3 is started right after
//    it, into the stage tile t-1 left, and flies while tile t's MMAs run.
//  * x fragments come by ldmatrix.x4. The B fragments are dequantized straight from the
//    staged words into registers: a thread's four codes of a 16-row step (rows 2t, 2t+1,
//    2t+8, 2t+9 of column lane/4) become (q - z) by the 2^23 trick and are packed two to a
//    register. q - z is an integer in [-255, 255], exact in bf16 and f16, so the MMA takes the
//    unscaled weight. Each group's product accumulates in a second fragment, folded into the
//    output once per group as acc += s[g, n] * part (16 | gs: a step never spans two
//    groups). The only rounding left is the f32 accumulation, as in the SIMT kernel, which
//    holds an f32 weight; finer than the JAX kernels' bf16 weight. ANY_GS keeps that
//    arithmetic: a step that spans groups runs one MMA per group it touches, each with q - z
//    of that group's rows and 0 for the others, and folds a group's scale in once its last row
//    has gone in (about 16/gs of the steps take two MMAs at gs >= 16; up to ceil(15/gs) + 1
//    below); a stage holds the floor(63/gs) + 2 groups a 64-row K tile can touch (33 at gs 2).
//  * desc_act: with kperm (or a K or x that is not 16-byte aligned) x is gathered inside the
//    kernel, by register loads and stores to shared memory, no separate index_select pass.
//  * Backward (K10): the same block and warp tiles over (M, K), N reduced in steps of 64 with
//    a 4-stage ring of g [128 x 64] tiles, words and the groups of the block's 128 K rows (at
//    most 8 at 16 | gs; ANY_GS floor(127/gs) + 2, each code's group looked up as the dequant
//    walks a word's rows). The scale varies along the reduction, so it cannot be folded
//    after the MMA: each stage's words are dequantized once per block into a shared B tile
//    [128 K x 64 N] of w = (q - z) * s, stored K-major with N contiguous, which is mma.sync's
//    column-major B: ldmatrix.x4 without .trans gives two 8-column fragments. A thread
//    writes column pairs, so a warp's stores fill 32 banks. w goes in as a pair of the activation type, hi =
//    round(w) and lo = round(w - hi), two MMAs each, so dx keeps the f32 weight's precision
//    as the SIMT kernel does (rounding w once to bf16 moved a 32-layer LoRA run off its
//    descent: chip_mma_probe.py, PERF.md). There are two sets of B tiles: tile t+1 is
//    dequantized in parts, one after each 16-row step's MMAs of tile t, so the dequant
//    interleaves with them; one barrier per tile; g and B fragments are loaded one step
//    ahead. dx is written once through kperm (a permutation: a plain store, no atomics).
//  * Measured on an H100 (chip_mma_probe.py, PERF.md): the forward runs at about 125 TFLOP/s
//    at M = 2048, 5-6x torch.matmul's time, and with its dequant removed it gains little, so
//    the mma.sync loop (64 x 32 warp tiles, 8 warps per SM) bounds it. Tried and not kept:
//    loading the forward's operands a step ahead (more registers, slower), dequantizing the
//    forward's codes once per block into a shared B tile (no faster), and 64 x 64 warp tiles
//    for K10 (no faster at M = 2048, slower at M = 128).
// Every entry point returns cudaGetLastError() and the Python wrapper raises when it is
// non-zero.

#pragma once

#include "kb32l_tile.cuh"
#include "wna16_gemm.cuh"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
                 : "memory");
}

// 16 bytes, or 16 zero bytes when !valid (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "r"(valid ? 16 : 0)
                 : "memory");
}

// 4 bytes, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// The m16n8k16 MMA of one activation type (f32 accumulators, D = C), and the packing of two
// f32 values into one operand register (the lower K index in the low half).
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
    static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
    // d = A * B, from a zero accumulator
    static __device__ __forceinline__ void run0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
            : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
    }
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
    static __device__ __forceinline__ float2 unpack(uint32_t v) {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    }
};

template <> struct Mma<__half> {
    static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
    // d = A * B, from a zero accumulator
    static __device__ __forceinline__ void run0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
            : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
    }
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
    static __device__ __forceinline__ float2 unpack(uint32_t v) {
        return __half22float2(*reinterpret_cast<const __half2*>(&v));
    }
};

// Opt a kernel in to `bytes` of dynamic shared memory, with the largest shared-memory carveout
// so that as many blocks fit on an SM as the registers allow.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
    return err;
}

// Two adjacent outputs (4-byte aligned) rounded once to T.
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = Mma<T>::pack(a, b);
}

constexpr int MMA_WARPS_M = 2;     // warps along M, 64 output rows each
constexpr int MMA_WARPS_N = 4;     // warps along the output columns, 32 each
constexpr int MMA_THREADS = 32 * MMA_WARPS_M * MMA_WARPS_N;
constexpr int MMA_BLOCKS_PER_SM = 256 / MMA_THREADS;   // the registers of 8 warps per SM
constexpr int MMA_BM = 64 * MMA_WARPS_M;   // output rows (M) per block
constexpr int MMA_BN = 32 * MMA_WARPS_N;   // output columns per block (N; K for K10)
constexpr int MMA_LD = 72;         // halves per staged row of 64: 144 B, ldmatrix conflict-free
static_assert(KB32L_BN % MMA_BN == 0, "a block's words must lie in one kb32l column tile");

// ---- forward: y = x @ dequant(W) ----------------------------------------------------------

constexpr int FW_BK = 64;          // K rows per stage
constexpr int FW_STAGES = 4;
constexpr int FW_GROUPS = FW_BK / 16;   // 16 | gs: group rows a K tile's 16-row steps can touch
// Dynamic shared memory an ANY_GS block may take: the card's 227 KB opt-in less room for the
// kernels' static arrays (ops/gemm.py:MMA_SMEM_LIMIT).
constexpr int MMA_SMEM_LIMIT = 226 * 1024;

// ANY_GS: the group rows a stage holds for `rows` K rows, every group that rows at any offset
// can touch (ops/gemm.py:mma_stage_groups).
__host__ __device__ constexpr int stage_groups(int gs, int rows) { return (rows - 1) / gs + 2; }

template <int BITS> struct FwStage {   // byte offsets within one stage
    static constexpr int P = 32 / BITS;
    static constexpr int X = 0;                                   // T   [MMA_BM][MMA_LD]
    static constexpr int W = X + MMA_BM * MMA_LD * 2;             // i32 [FW_BK / P][MMA_BN]
    static constexpr int S = W + (FW_BK / P) * MMA_BN * 4;        // f16 [FW_GROUPS][MMA_BN]
    static constexpr int Z = S + FW_GROUPS * MMA_BN * 2;          // u8  [FW_GROUPS][MMA_BN]
    static constexpr int BYTES = Z + FW_GROUPS * MMA_BN;
    static_assert(BYTES % 16 == 0, "stages must stay 16-byte aligned");
    // ANY_GS: ng group rows of scales and zeros in place of FW_GROUPS
    static __host__ __device__ constexpr int z_at(int ng) { return S + ng * MMA_BN * 2; }
    static __host__ __device__ constexpr int bytes(int ng) {
        return (z_at(ng) + ng * MMA_BN + 15) / 16 * 16;
    }
};

constexpr int FW_NW_BYTES = FW_BK * 4;  // PRENORM: a K tile's norm weight (at most f32)

// PRENORM: the fused RMS-norm prologue of wna16_gemm.cuh (M < PN_MAX_ROWS, one row block). Each
// K tile's norm weight rides in a slot of its own beside the stages (copied with the tile), and
// once the tile has landed its rows of x are normalized in place, each element rounded once to
// T, before a second barrier lets the MMAs read them; gathered x (kperm, or x or the weight
// not 16-byte aligned) is normalized as it is stored.
// ANY_GS: any group size (the instance of the group sizes 16 does not divide). A 16-row step
// may span groups: it runs one MMA per group it touches, each taking q - z with that group's
// zero for its own rows and exactly 0 for the others (so a word straddling groups gives each
// code its own group's zero), and folds the group's scale in as soon as the group's last row
// (or K's) has gone in. Group boundaries are K rows, the same for every thread, so the loop
// stays uniform. A stage holds stage_groups(gs, FW_BK) group rows.
template <int BITS, typename T, typename Words, bool PRENORM = false, bool ANY_GS = false>
__global__ void __launch_bounds__(MMA_THREADS, MMA_BLOCKS_PER_SM)
wna16_mma_kernel(const T* __restrict__ x, const int64_t* __restrict__ kperm,
                 const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                 const uint8_t* __restrict__ zeros, const T* __restrict__ bias,
                 T* __restrict__ out, int M, int K, int N, int gs, Words words, int ldsz,
                 int gather, Prenorm pn) {
    static_assert(!(PRENORM && ANY_GS), "the fused prologue takes 32 | gs only");
    using L = FwStage<BITS>;
    constexpr int P = L::P;
    constexpr int WROWS = FW_BK / P;        // word rows per K tile
    // group rows per stage, the offset of its zeros and a stage's bytes
    const int ngroups = ANY_GS ? stage_groups(gs, FW_BK) : FW_GROUPS;
    const int zoff = ANY_GS ? L::z_at(ngroups) : L::Z;
    const int sbytes = ANY_GS ? L::bytes(ngroups) : L::BYTES;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float rstd[PRENORM ? PN_MAX_ROWS : 1];
    __shared__ float red[PRENORM ? PN_MAX_ROWS * (MMA_THREADS / 32) : 1];
    unsigned char* const nws = smem + FW_STAGES * L::BYTES;   // PRENORM: [FW_STAGES][FW_NW_BYTES]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wm = (tid >> 5) / MMA_WARPS_N;   // warp row: output rows 64 wm ..
    const int wn = (tid >> 5) % MMA_WARPS_N;   // warp column: output columns 32 wn ..
    const int m0 = blockIdx.y * MMA_BM;
    const int n0 = blockIdx.x * MMA_BN;
    const int G = (K + gs - 1) / gs;
    const int kwords = K / P;
    const int ntiles = (K + FW_BK - 1) / FW_BK;

    // Copy K tile `tile` into stage `st` (x gathered by this thread's own loads if `gather`).
    auto fetch = [&](int tile, unsigned char* st) {
        const int kt = tile * FW_BK;
        T* xs = reinterpret_cast<T*>(st + L::X);
        if (!gather) {
            for (int c = tid; c < MMA_BM * (FW_BK / 8); c += MMA_THREADS) {
                const int r = c / (FW_BK / 8), q = c % (FW_BK / 8);
                const int m = m0 + r, k = kt + q * 8;
                const bool ok = m < M && k < K;
                cp_async16_zfill(xs + r * MMA_LD + q * 8, ok ? x + (int64_t)m * K + k : x, ok);
            }
            if constexpr (PRENORM) {                 // the tile's norm weight, 16 bytes a copy
                const int wsz = prenorm_wsize(pn.wdt), per = 16 / wsz;
                const unsigned char* w = static_cast<const unsigned char*>(pn.w);
                unsigned char* dst = nws + (tile % FW_STAGES) * FW_NW_BYTES;
                for (int c = tid; c < FW_BK / per; c += MMA_THREADS) {
                    const int k = kt + c * per;      // K % 8 == 0: a copy lies inside K or past it
                    cp_async16_zfill(dst + c * 16, k < K ? w + (int64_t)k * wsz : w, k < K);
                }
            }
        } else {
            for (int i = tid; i < MMA_BM * FW_BK; i += MMA_THREADS) {
                const int r = i / FW_BK, kk = i % FW_BK;
                const int m = m0 + r, k = kt + kk;
                T v = from_f32<T>(0.0f);
                if (m < M && k < K) {
                    const int64_t c = kperm != nullptr ? kperm[k] : (int64_t)k;
                    v = x[(int64_t)m * K + c];
                    if constexpr (PRENORM) v = prenorm_apply(v, rstd[r], prenorm_weight(pn, c));
                }
                xs[r * MMA_LD + kk] = v;
            }
        }
        int32_t* ws = reinterpret_cast<int32_t*>(st + L::W);
        for (int c = tid; c < WROWS * (MMA_BN / 4); c += MMA_THREADS) {
            const int r = c / (MMA_BN / 4), q = c % (MMA_BN / 4);
            const int kw = kt / P + r, n = n0 + q * 4;
            const bool ok = kw < kwords && n < N;
            cp_async16_zfill(ws + r * MMA_BN + q * 4, ok ? qweight + words(kw, n) : qweight, ok);
        }
        const int g0 = kt / gs;
        __half* ss = reinterpret_cast<__half*>(st + L::S);
        uint8_t* zs = st + zoff;
        for (int c = tid; c < ngroups * (MMA_BN / 2 + MMA_BN / 4); c += MMA_THREADS) {
            if (c < ngroups * (MMA_BN / 2)) {     // scales, 2 columns per copy
                const int r = c / (MMA_BN / 2), q = c % (MMA_BN / 2);
                const int g = g0 + r, n = n0 + 2 * q;
                const bool ok = g < G && n < N;
                cp_async4_zfill(ss + r * MMA_BN + 2 * q,
                                ok ? scales + (int64_t)g * ldsz + n : scales, ok);
            } else {                               // zeros, 4 columns per copy
                const int c2 = c - ngroups * (MMA_BN / 2);
                const int r = c2 / (MMA_BN / 4), q = c2 % (MMA_BN / 4);
                const int g = g0 + r, n = n0 + 4 * q;
                const bool ok = g < G && n < N;
                cp_async4_zfill(zs + r * MMA_BN + 4 * q,
                                ok ? zeros + (int64_t)g * ldsz + n : zeros, ok);
            }
        }
    };

    float acc[4][4][4];    // [m16 tile][n8 tile][fragment]
    float part[4][4][4];   // the current group's unscaled product
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = part[i][j][c] = 0.0f;

    if constexpr (PRENORM)
        prenorm_rstd<T, PN_MAX_ROWS>(x + (int64_t)m0 * K, K, min(M - m0, PN_MAX_ROWS), pn.eps,
                                     rstd, red);
#pragma unroll
    for (int s = 0; s < FW_STAGES - 1; ++s) {
        if (s < ntiles) fetch(s, smem + s * sbytes);
        cp_async_commit();   // one group per stage, empty past the end: wait counts alike
    }
    [[maybe_unused]] const int gsteps = gs / 16;   // 16 | gs: 16-row steps per group
    [[maybe_unused]] int gcur = 0;                 // the group of the current step
    [[maybe_unused]] int left = gsteps;            // its steps still to come
    for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<FW_STAGES - 2>();   // this thread's copies of tile t have landed
        __syncthreads();                  // everyone's have, and tile t-1's stage is free
        const int nxt = t + FW_STAGES - 1;
        if (nxt < ntiles) fetch(nxt, smem + (nxt % FW_STAGES) * sbytes);
        cp_async_commit();

        const unsigned char* st = smem + (t % FW_STAGES) * sbytes;
        if constexpr (PRENORM) {
            if (!gather) {   // the tile's rows of x normalized in place (rows past M stay zero)
                T* xn = reinterpret_cast<T*>(smem + (t % FW_STAGES) * sbytes + L::X);
                const unsigned char* wsl = nws + (t % FW_STAGES) * FW_NW_BYTES;
                const int rows = min(M - m0, PN_MAX_ROWS);
                for (int c = tid; c < rows * (FW_BK / 8); c += MMA_THREADS) {
                    const int r = c / (FW_BK / 8), q = c % (FW_BK / 8);
                    if (t * FW_BK + 8 * q >= K) continue;
                    uint4* p = reinterpret_cast<uint4*>(xn + r * MMA_LD + 8 * q);
                    uint4 raw = *p;
                    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        v[e] = prenorm_apply(v[e], rstd[r],
                                             prenorm_weight_at(wsl, pn.wdt, 8 * q + e, pn.plus_one));
                    *p = raw;
                }
                __syncthreads();
            }
        }
        const T* xs = reinterpret_cast<const T*>(st + L::X);
        const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + L::W);
        const __half* ss = reinterpret_cast<const __half*>(st + L::S);
        const uint8_t* zs = st + zoff;
        const int kt = t * FW_BK;
        const int g0 = kt / gs;
#pragma unroll
        for (int ks = 0; ks < FW_BK / 16; ++ks) {
            const int k = kt + ks * 16;
            if (k >= K) break;                      // uniform over the block
            if constexpr (ANY_GS) {
                uint32_t a[4][4];
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
                    ldmatrix_x4(a[mt], xs + (wm * 64 + mt * 16 + (lane & 15)) * MMA_LD +
                                           ks * 16 + (lane >> 4) * 8);
                const int r0 = ks * 16 + 2 * (lane & 3);   // K rows r0, r0+1, r0+8, r0+9
                const int kend = min(k + 16, K);
                for (int g = k / gs; g * gs < kend; ++g) {  // each group the step touches
                    const int grow = g - g0;
                    const int lo = g * gs, hi = min(lo + gs, K);   // its K rows [lo, hi)
                    const unsigned span = (unsigned)(hi - lo);
                    const bool in0 = (unsigned)(kt + r0 - lo) < span;
                    const bool in1 = (unsigned)(kt + r0 + 1 - lo) < span;
                    const bool in8 = (unsigned)(kt + r0 + 8 - lo) < span;
                    const bool in9 = (unsigned)(kt + r0 + 9 - lo) < span;
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                        const int col = wn * 32 + nt * 8 + (lane >> 2);
                        const float zb = MAGIC + (float)zs[grow * MMA_BN + col];
                        const uint32_t w0 = ws[(r0 / P) * MMA_BN + col];
                        const uint32_t w1 = ws[((r0 + 8) / P) * MMA_BN + col];
                        const uint32_t b0 = Mma<T>::pack(
                            in0 ? code_minus_zero<BITS>(w0, r0 % P, zb) : 0.0f,
                            in1 ? code_minus_zero<BITS>(w0, (r0 + 1) % P, zb) : 0.0f);
                        const uint32_t b1 = Mma<T>::pack(
                            in8 ? code_minus_zero<BITS>(w1, (r0 + 8) % P, zb) : 0.0f,
                            in9 ? code_minus_zero<BITS>(w1, (r0 + 9) % P, zb) : 0.0f);
#pragma unroll
                        for (int mt = 0; mt < 4; ++mt) Mma<T>::run(part[mt][nt], a[mt], b0, b1);
                    }
                    if (hi <= k + 16) {             // the group ends in this step: fold its scale
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt) {
                            const int col = wn * 32 + nt * 8 + 2 * (lane & 3);
                            const __half2 s2 =
                                *reinterpret_cast<const __half2*>(ss + grow * MMA_BN + col);
                            const float s0 = __low2float(s2), s1 = __high2float(s2);
#pragma unroll
                            for (int mt = 0; mt < 4; ++mt) {
                                acc[mt][nt][0] = fmaf(part[mt][nt][0], s0, acc[mt][nt][0]);
                                acc[mt][nt][1] = fmaf(part[mt][nt][1], s1, acc[mt][nt][1]);
                                acc[mt][nt][2] = fmaf(part[mt][nt][2], s0, acc[mt][nt][2]);
                                acc[mt][nt][3] = fmaf(part[mt][nt][3], s1, acc[mt][nt][3]);
#pragma unroll
                                for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
                            }
                        }
                    }
                }
            } else {
                const int grow = gcur - g0;             // this step's group row in the stage
                uint32_t a[4][4];
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
                    ldmatrix_x4(a[mt], xs + (wm * 64 + mt * 16 + (lane & 15)) * MMA_LD + ks * 16 +
                                           (lane >> 4) * 8);
                const int r0 = ks * 16 + 2 * (lane & 3);   // K rows r0, r0+1, r0+8, r0+9 of the tile
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const int col = wn * 32 + nt * 8 + (lane >> 2);
                    const float zb = MAGIC + (float)zs[grow * MMA_BN + col];
                    const uint32_t w0 = ws[(r0 / P) * MMA_BN + col];
                    const uint32_t w1 = ws[((r0 + 8) / P) * MMA_BN + col];
                    const uint32_t b0 = Mma<T>::pack(code_minus_zero<BITS>(w0, r0 % P, zb),
                                                     code_minus_zero<BITS>(w0, (r0 + 1) % P, zb));
                    const uint32_t b1 = Mma<T>::pack(code_minus_zero<BITS>(w1, (r0 + 8) % P, zb),
                                                     code_minus_zero<BITS>(w1, (r0 + 9) % P, zb));
#pragma unroll
                    for (int mt = 0; mt < 4; ++mt) Mma<T>::run(part[mt][nt], a[mt], b0, b1);
                }
                if (--left == 0 || k + 16 >= K) {       // the group ends: fold its scale in
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                        const int col = wn * 32 + nt * 8 + 2 * (lane & 3);
                        const __half2 s2 = *reinterpret_cast<const __half2*>(ss + grow * MMA_BN + col);
                        const float s0 = __low2float(s2), s1 = __high2float(s2);
#pragma unroll
                        for (int mt = 0; mt < 4; ++mt) {
                            acc[mt][nt][0] = fmaf(part[mt][nt][0], s0, acc[mt][nt][0]);
                            acc[mt][nt][1] = fmaf(part[mt][nt][1], s1, acc[mt][nt][1]);
                            acc[mt][nt][2] = fmaf(part[mt][nt][2], s0, acc[mt][nt][2]);
                            acc[mt][nt][3] = fmaf(part[mt][nt][3], s1, acc[mt][nt][3]);
#pragma unroll
                            for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
                        }
                    }
                }
                if (left == 0) {
                    ++gcur;
                    left = gsteps;
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
        if (col >= N) continue;                   // N % 4 == 0: col < N means col + 1 < N
        float b0 = 0.0f, b1 = 0.0f;
        if (bias != nullptr) {
            b0 = to_f32(bias[col]);
            b1 = to_f32(bias[col + 1]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            const int row = m0 + wm * 64 + mt * 16 + (lane >> 2);
            if (row < M)
                store2(out + (int64_t)row * N + col, acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
            if (row + 8 < M)
                store2(out + (int64_t)(row + 8) * N + col, acc[mt][nt][2] + b0,
                       acc[mt][nt][3] + b1);
        }
    }
}

template <int BITS, typename T, typename Words, bool PRENORM = false, bool ANY_GS = false>
cudaError_t launch_mma(const void* x, const int64_t* kperm, const int32_t* qweight,
                       const __half* scales, const uint8_t* zeros, const void* bias, void* out,
                       int M, int K, int N, int gs, Words words, int ldsz, cudaStream_t stream,
                       Prenorm pn = Prenorm{}) {
    constexpr int fixed = FW_STAGES * (FwStage<BITS>::BYTES + (PRENORM ? FW_NW_BYTES : 0));
    // ANY_GS: the stage grows with the groups a K tile touches (ops/gemm.py:mma_smem_bytes)
    const int smem = ANY_GS ? FW_STAGES * FwStage<BITS>::bytes(stage_groups(gs, FW_BK)) : fixed;
    if (smem > MMA_SMEM_LIMIT) return cudaErrorInvalidValue;
    // function-local static: the attribute is set once per instantiation, thread-safely
    static const cudaError_t attr = allow_smem(wna16_mma_kernel<BITS, T, Words, PRENORM, ANY_GS>,
                                               ANY_GS ? MMA_SMEM_LIMIT : fixed);
    if (attr != cudaSuccess) return attr;
    const int gather = kperm != nullptr || K % 8 != 0 ||
                       (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
                       (PRENORM && (reinterpret_cast<uintptr_t>(pn.w) & 15) != 0);
    const dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
    wna16_mma_kernel<BITS, T, Words, PRENORM, ANY_GS><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
        static_cast<T*>(out), M, K, N, gs, words, ldsz, gather, pn);
    return cudaGetLastError();
}

template <int BITS, typename Words, bool PRENORM = false, bool ANY_GS = false>
int launch_mma_dtype(const void* x, const int64_t* kperm, const int32_t* qweight,
                     const void* scales, const uint8_t* zeros, const void* bias, void* out,
                     int dtype, int M, int K, int N, int gs, Words words, int ldsz, void* stream,
                     Prenorm pn = Prenorm{}) {
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F16:
            return (int)launch_mma<BITS, __half, Words, PRENORM, ANY_GS>(
                x, kperm, qweight, s, zeros, bias, out, M, K, N, gs, words, ldsz, st, pn);
        case DT_BF16:
            return (int)launch_mma<BITS, __nv_bfloat16, Words, PRENORM, ANY_GS>(
                x, kperm, qweight, s, zeros, bias, out, M, K, N, gs, words, ldsz, st, pn);
        default:   // f32 activations take the SIMT kernels
            return (int)cudaErrorInvalidValue;
    }
}

// The forward over GPTQ words [K/P, N] (K1, K4, K5); PRENORM with the fused RMS-norm prologue
// (32 | gs). A group size that 16 does not divide takes the ANY_GS instance.
template <int BITS, bool PRENORM = false>
int wna16_gemm_mma(const void* x, const int64_t* kperm, const int32_t* qweight,
                   const void* scales, const uint8_t* zeros, const void* bias, void* out,
                   int dtype, int M, int K, int N, int gs, void* stream, Prenorm pn = Prenorm{}) {
    constexpr int P = 32 / BITS;
    if (M <= 0 || K <= 0 || N <= 0 || K % P != 0 || N % 4 != 0 || gs <= 0 ||
        (M + MMA_BM - 1) / MMA_BM > 65535 || (PRENORM && (!prenorm_ok(M, pn) || gs % 16 != 0)))
        return (int)cudaErrorInvalidValue;
    if constexpr (!PRENORM) {
        if (gs % 16 != 0)
            return launch_mma_dtype<BITS, GptqWords, false, true>(
                x, kperm, qweight, scales, zeros, bias, out, dtype, M, K, N, gs, GptqWords{N}, N,
                stream);
    }
    return launch_mma_dtype<BITS, GptqWords, PRENORM>(x, kperm, qweight, scales, zeros, bias,
                                                      out, dtype, M, K, N, gs, GptqWords{N}, N,
                                                      stream, pn);
}

// ---- backward (K10): dx = g @ dequant(W)^T -------------------------------------------------

constexpr int TM_BR = 64;                 // N (the reduction) per stage
constexpr int TM_STAGES = 4;             // tile t+1 must have landed while t is consumed
// The scaled weight w = (q - z) * s as a pair of the activation type, hi = round(w) and
// lo = round(w - hi), two MMAs each: w is carried to about 16 significant bits instead of 8
// (bf16), so dx keeps the f32 weight's precision as the SIMT kernel does.
constexpr int TM_SPLIT = 2;
constexpr int TM_GROUPS = MMA_BN / 16;    // group rows a block's MMA_BN K rows can touch

template <int BITS> struct TmStage {      // byte offsets within one stage
    static constexpr int P = 32 / BITS;
    static constexpr int X = 0;                                   // T   [MMA_BM][MMA_LD] of g
    static constexpr int W = X + MMA_BM * MMA_LD * 2;             // i32 [MMA_BN / P][64]
    static constexpr int S = W + (MMA_BN / P) * TM_BR * 4;        // f16 [TM_GROUPS][64]
    static constexpr int Z = S + TM_GROUPS * TM_BR * 2;           // u8  [TM_GROUPS][64]
    static constexpr int BYTES = Z + TM_GROUPS * TM_BR;
    static constexpr int B_TILE = MMA_BN * MMA_LD * 2;            // T   [MMA_BN K][MMA_LD]
    static_assert(BYTES % 16 == 0, "stages must stay 16-byte aligned");
    // ANY_GS: ng group rows of scales and zeros in place of TM_GROUPS
    static __host__ __device__ constexpr int z_at(int ng) { return S + ng * TM_BR * 2; }
    static __host__ __device__ constexpr int bytes(int ng) {
        return (z_at(ng) + ng * TM_BR + 15) / 16 * 16;
    }
};

// ANY_GS: any group size (the instance of the group sizes 16 does not divide). The dequant
// looks up the group of each code, not of each word (a word may straddle groups), and a stage
// holds stage_groups(gs, MMA_BN) group rows.
template <int BITS, typename T, typename Words, bool ANY_GS = false>
__global__ void __launch_bounds__(MMA_THREADS, MMA_BLOCKS_PER_SM)
wna16_t_mma_kernel(const T* __restrict__ g, const int64_t* __restrict__ kperm,
                   const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                   const uint8_t* __restrict__ zeros, T* __restrict__ dx, int M, int K, int N,
                   int gs, Words words, int ldsz, int gather) {
    using L = TmStage<BITS>;
    constexpr int P = L::P;
    constexpr int WROWS = MMA_BN / P;       // word rows of the block's MMA_BN K rows
    // group rows per stage, the offset of its zeros and a stage's bytes
    const int ngroups = ANY_GS ? stage_groups(gs, MMA_BN) : TM_GROUPS;
    const int zoff = ANY_GS ? L::z_at(ngroups) : L::Z;
    const int sbytes = ANY_GS ? L::bytes(ngroups) : L::BYTES;
    extern __shared__ __align__(16) unsigned char smem[];
    // the dequantized B tiles [2][TM_SPLIT][MMA_BN][MMA_LD]: tile t+1 is dequantized while
    // tile t's MMAs run
    T* const bts = reinterpret_cast<T*>(smem + TM_STAGES * sbytes);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wm = (tid >> 5) / MMA_WARPS_N;   // warp row: dx rows 64 wm ..
    const int wn = (tid >> 5) % MMA_WARPS_N;   // warp column: dx columns (sorted K) 32 wn ..
    const int m0 = blockIdx.y * MMA_BM;
    const int k0 = blockIdx.x * MMA_BN;
    const int G = (K + gs - 1) / gs;
    const int kwords = K / P;
    const int g_lo = k0 / gs;
    const int ntiles = (N + TM_BR - 1) / TM_BR;

    auto fetch = [&](int tile, unsigned char* st) {
        const int nt = tile * TM_BR;
        T* gsm = reinterpret_cast<T*>(st + L::X);
        if (!gather) {
            for (int c = tid; c < MMA_BM * (TM_BR / 8); c += MMA_THREADS) {
                const int r = c / (TM_BR / 8), q = c % (TM_BR / 8);
                const int m = m0 + r, n = nt + q * 8;
                const bool ok = m < M && n < N;
                cp_async16_zfill(gsm + r * MMA_LD + q * 8, ok ? g + (int64_t)m * N + n : g, ok);
            }
        } else {
            for (int i = tid; i < MMA_BM * TM_BR; i += MMA_THREADS) {
                const int r = i / TM_BR, nn = i % TM_BR;
                const int m = m0 + r, n = nt + nn;
                gsm[r * MMA_LD + nn] = (m < M && n < N) ? g[(int64_t)m * N + n] : from_f32<T>(0.0f);
            }
        }
        int32_t* ws = reinterpret_cast<int32_t*>(st + L::W);
        for (int c = tid; c < WROWS * (TM_BR / 4); c += MMA_THREADS) {
            const int r = c / (TM_BR / 4), q = c % (TM_BR / 4);
            const int kw = k0 / P + r, n = nt + q * 4;
            const bool ok = kw < kwords && n < N;
            cp_async16_zfill(ws + r * TM_BR + q * 4, ok ? qweight + words(kw, n) : qweight, ok);
        }
        __half* ss = reinterpret_cast<__half*>(st + L::S);
        uint8_t* zs = st + zoff;
        for (int c = tid; c < ngroups * (TM_BR / 2 + TM_BR / 4); c += MMA_THREADS) {
            if (c < ngroups * (TM_BR / 2)) {
                const int r = c / (TM_BR / 2), q = c % (TM_BR / 2);
                const int grp = g_lo + r, n = nt + 2 * q;
                const bool ok = grp < G && n < N;
                cp_async4_zfill(ss + r * TM_BR + 2 * q,
                                ok ? scales + (int64_t)grp * ldsz + n : scales, ok);
            } else {
                const int c2 = c - ngroups * (TM_BR / 2);
                const int r = c2 / (TM_BR / 4), q = c2 % (TM_BR / 4);
                const int grp = g_lo + r, n = nt + 4 * q;
                const bool ok = grp < G && n < N;
                cp_async4_zfill(zs + r * TM_BR + 4 * q,
                                ok ? zeros + (int64_t)grp * ldsz + n : zeros, ok);
            }
        }
    };

    // Dequantize part `part` of tile `tile`'s words into B tile `bt`: word row r, column
    // pair cp -> B rows P*r .. P*r+P-1, columns 2cp, 2cp+1 (16 | gs and P | 16, so a word
    // lies in one group; ANY_GS moves to the next group at each code that starts one). A
    // thread's word pairs are dealt out over the TM_BR / 16 parts.
    constexpr int ITERS = WROWS * (TM_BR / 2) / MMA_THREADS;   // word pairs per thread
    static_assert(ITERS * MMA_THREADS == WROWS * (TM_BR / 2), "whole word pairs per thread");
    auto dequant = [&](int tile, T* bt, int part) {
        const unsigned char* st = smem + (tile % TM_STAGES) * sbytes;
        const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + L::W);
        const __half* ss = reinterpret_cast<const __half*>(st + L::S);
        const uint8_t* zs = st + zoff;
#pragma unroll
        for (int it = part; it < ITERS; it += TM_BR / 16) {
            const int i = tid + it * MMA_THREADS;
            const int r = i / (TM_BR / 2), cp = i % (TM_BR / 2);
            if constexpr (ANY_GS) {   // the group of each code, from the word's first row on
                const uint2 w = *reinterpret_cast<const uint2*>(ws + r * TM_BR + 2 * cp);
                int grow = (k0 + r * P) / gs - g_lo;
                int left = gs - (k0 + r * P) % gs;   // rows of that group from the word's first
                float s0, s1, zb0, zb1;
                auto group = [&]() {
                    const __half2 s2 = *reinterpret_cast<const __half2*>(ss + grow * TM_BR + 2 * cp);
                    s0 = __low2float(s2);
                    s1 = __high2float(s2);
                    zb0 = MAGIC + (float)zs[grow * TM_BR + 2 * cp];
                    zb1 = MAGIC + (float)zs[grow * TM_BR + 2 * cp + 1];
                };
                group();
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    if (left == 0) {             // code j starts the next group
                        ++grow;
                        left = gs;
                        group();
                    }
                    --left;
                    const float v0 = code_minus_zero<BITS>(w.x, j, zb0) * s0;
                    const float v1 = code_minus_zero<BITS>(w.y, j, zb1) * s1;
                    const uint32_t hi = Mma<T>::pack(v0, v1);
                    T* dst = bt + (r * P + j) * MMA_LD + 2 * cp;
                    *reinterpret_cast<uint32_t*>(dst) = hi;
                    if constexpr (TM_SPLIT == 2) {
                        const float2 h = Mma<T>::unpack(hi);
                        *reinterpret_cast<uint32_t*>(dst + MMA_BN * MMA_LD) =
                            Mma<T>::pack(v0 - h.x, v1 - h.y);
                    }
                }
            } else {
                const int grow = (k0 + r * P) / gs - g_lo;
                const uint2 w = *reinterpret_cast<const uint2*>(ws + r * TM_BR + 2 * cp);
                const __half2 s2 = *reinterpret_cast<const __half2*>(ss + grow * TM_BR + 2 * cp);
                const float s0 = __low2float(s2), s1 = __high2float(s2);
                const float zb0 = MAGIC + (float)zs[grow * TM_BR + 2 * cp];
                const float zb1 = MAGIC + (float)zs[grow * TM_BR + 2 * cp + 1];
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    const float v0 = code_minus_zero<BITS>(w.x, j, zb0) * s0;
                    const float v1 = code_minus_zero<BITS>(w.y, j, zb1) * s1;
                    const uint32_t hi = Mma<T>::pack(v0, v1);
                    T* dst = bt + (r * P + j) * MMA_LD + 2 * cp;
                    *reinterpret_cast<uint32_t*>(dst) = hi;
                    if constexpr (TM_SPLIT == 2) {
                        const float2 h = Mma<T>::unpack(hi);
                        *reinterpret_cast<uint32_t*>(dst + MMA_BN * MMA_LD) =
                            Mma<T>::pack(v0 - h.x, v1 - h.y);
                    }
                }
            }
        }
    };

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

#pragma unroll
    for (int s = 0; s < TM_STAGES - 1; ++s) {
        if (s < ntiles) fetch(s, smem + s * sbytes);
        cp_async_commit();
    }
    cp_async_wait<TM_STAGES - 2>();
    __syncthreads();
#pragma unroll
    for (int part = 0; part < TM_BR / 16; ++part) dequant(0, bts, part);
    // A 16-row step's fragments, loaded one step ahead: g by ldmatrix.x4, and the B tile's
    // two 8-column pairs by ldmatrix.x4 without .trans (its rows are K, N contiguous).
    uint32_t a[2][4][4];
    uint32_t b[2][TM_SPLIT][2][4];   // [step buffer][hi, lo][8-column pair][fragment]
    auto load = [&](int buf, const T* gsm, const T* bt, int ks) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
            ldmatrix_x4(a[buf][mt], gsm + (wm * 64 + mt * 16 + (lane & 15)) * MMA_LD + ks * 16 +
                                        (lane >> 4) * 8);
#pragma unroll
        for (int h = 0; h < TM_SPLIT; ++h)
#pragma unroll
            for (int np = 0; np < 2; ++np)
                ldmatrix_x4(b[buf][h][np],
                            bt + h * (MMA_BN * MMA_LD) +
                                (wn * 32 + np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * MMA_LD +
                                ks * 16 + ((lane >> 3) & 1) * 8);
    };
    for (int t = 0; t < ntiles; ++t) {
        // Tile t+1 has landed (tile t+2 may still fly), tile t's B tile is complete, and
        // every warp is done with tile t-1 (its stage and the other B tile are free).
        cp_async_wait<TM_STAGES - 3>();
        __syncthreads();
        const int nxt = t + TM_STAGES - 1;
        if (nxt < ntiles) fetch(nxt, smem + (nxt % TM_STAGES) * sbytes);
        cp_async_commit();
        const T* gsm = reinterpret_cast<const T*>(smem + (t % TM_STAGES) * sbytes + L::X);
        const T* bt = bts + (t & 1) * (TM_SPLIT * MMA_BN * MMA_LD);
        load(0, gsm, bt, 0);
#pragma unroll
        for (int ks = 0; ks < TM_BR / 16; ++ks) {
            const int cur = ks & 1;
            if (ks + 1 < TM_BR / 16) load(cur ^ 1, gsm, bt, ks + 1);
#pragma unroll
            for (int h = 0; h < TM_SPLIT; ++h)
#pragma unroll
                for (int np = 0; np < 2; ++np)
#pragma unroll
                    for (int mt = 0; mt < 4; ++mt) {
                        const uint32_t* bb = b[cur][h][np];
                        Mma<T>::run(acc[mt][2 * np], a[cur][mt], bb[0], bb[1]);
                        Mma<T>::run(acc[mt][2 * np + 1], a[cur][mt], bb[2], bb[3]);
                    }
            // a part of the next tile's dequant after each step's MMAs, so it interleaves
            // with them
            if (t + 1 < ntiles)
                dequant(t + 1, bts + ((t + 1) & 1) * (TM_SPLIT * MMA_BN * MMA_LD), ks);
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const int k = k0 + wn * 32 + nt * 8 + 2 * (lane & 3);
        if (k >= K) continue;                     // K even: k < K means k + 1 < K
        const int64_t c0 = kperm != nullptr ? kperm[k] : (int64_t)k;
        const int64_t c1 = kperm != nullptr ? kperm[k + 1] : (int64_t)k + 1;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * h;
                if (row >= M) continue;
                T* o = dx + (int64_t)row * K;
                if (kperm == nullptr) {
                    store2(o + k, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
                } else {
                    o[c0] = from_f32<T>(acc[mt][nt][2 * h]);
                    o[c1] = from_f32<T>(acc[mt][nt][2 * h + 1]);
                }
            }
        }
    }
}

template <int BITS, typename T, typename Words, bool ANY_GS = false>
cudaError_t launch_t_mma(const void* g, const int64_t* kperm, const int32_t* qweight,
                         const __half* scales, const uint8_t* zeros, void* dx, int M, int K,
                         int N, int gs, Words words, int ldsz, cudaStream_t stream) {
    using L = TmStage<BITS>;
    constexpr int fixed = TM_STAGES * L::BYTES + 2 * TM_SPLIT * L::B_TILE;
    // ANY_GS: the stage grows with the groups a block's K rows touch (ops/gemm.py:mma_smem_bytes)
    const int smem = ANY_GS ? TM_STAGES * L::bytes(stage_groups(gs, MMA_BN)) +
                                  2 * TM_SPLIT * L::B_TILE
                            : fixed;
    if (smem > MMA_SMEM_LIMIT) return cudaErrorInvalidValue;
    static const cudaError_t attr = allow_smem(wna16_t_mma_kernel<BITS, T, Words, ANY_GS>,
                                               ANY_GS ? MMA_SMEM_LIMIT : fixed);
    if (attr != cudaSuccess) return attr;
    const int gather = N % 8 != 0 || (reinterpret_cast<uintptr_t>(g) & 15) != 0;
    const dim3 grid((K + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
    wna16_t_mma_kernel<BITS, T, Words, ANY_GS><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const T*>(g), kperm, qweight, scales, zeros, static_cast<T*>(dx), M, K, N,
        gs, words, ldsz, gather);
    return cudaGetLastError();
}

template <int BITS, typename Words, bool ANY_GS = false>
int launch_t_mma_dtype(const void* g, const int64_t* kperm, const int32_t* qweight,
                       const void* scales, const uint8_t* zeros, void* dx, int dtype, int M,
                       int K, int N, int gs, Words words, int ldsz, void* stream) {
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F16:
            return (int)launch_t_mma<BITS, __half, Words, ANY_GS>(g, kperm, qweight, s, zeros, dx,
                                                                  M, K, N, gs, words, ldsz, st);
        case DT_BF16:
            return (int)launch_t_mma<BITS, __nv_bfloat16, Words, ANY_GS>(
                g, kperm, qweight, s, zeros, dx, M, K, N, gs, words, ldsz, st);
        default:   // f32 cotangents take the SIMT kernel
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Exports `int NAME_mma(...)`: the tensor-core forward over GPTQ words of BITS-bit codes.
#define WNA16_MMA_DEFINE_ENTRY(NAME, BITS)                                                      \
    extern "C" int NAME##_mma(const void* x, const int64_t* kperm, const int32_t* qweight,      \
                              const void* scales, const uint8_t* zeros, const void* bias,       \
                              void* out, int dtype, int M, int K, int N, int gs, void* stream) { \
        return wna16_gemm_mma<BITS>(x, kperm, qweight, scales, zeros, bias, out, dtype, M, K,   \
                                    N, gs, stream);                                             \
    }

// Exports `int NAME_mma_norm(...)`: the tensor-core forward with the fused RMS-norm prologue
// (M < 32), the arguments of NAME_mma and the norm weight, its dtype code, eps and plus_one
// before the stream.
#define WNA16_MMA_NORM_DEFINE_ENTRY(NAME, BITS)                                                 \
    extern "C" int NAME##_mma_norm(const void* x, const int64_t* kperm, const int32_t* qweight, \
                                   const void* scales, const uint8_t* zeros, const void* bias,  \
                                   void* out, int dtype, int M, int K, int N, int gs,           \
                                   const void* nw, int nw_dtype, float eps, int plus_one,       \
                                   void* stream) {                                              \
        return wna16_gemm_mma<BITS, true>(x, kperm, qweight, scales, zeros, bias, out, dtype,   \
                                          M, K, N, gs, stream,                                  \
                                          Prenorm{nw, nw_dtype, eps, plus_one});                \
    }
