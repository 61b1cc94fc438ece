// Shared source of the wNa16 dequant-matmul kernels for Hopper (sm_90a):
//   y[M,N] = x[M,K] @ ((q - z) * s)[K,N] (+ bias),  q a BITS-bit code, BITS in {2, 4, 8}.
//
// One template, three libraries: w4a16_gemm.cu (K1), w8a16_gemm.cu (K4) and w2a16_gemm.cu
// (K5) each include this file and export one C entry point through WNA16_DEFINE_ENTRY.
// They replace the TPU kernels of autogptq_tpu/ops/pallas/gemm.py: _kernel_kb32 and
// _kernel_ki32 (3/4-bit words), _kernel_kpair (nibbles, and bytes as "koct"),
// _kernel_k2i32 and _kernel_kquad (2-bit) and the planar _kernel (8-bit, and the rest class).
//
// Weight layout (built by ops/quantlinear.py:from_packed): GPTQ's own K-packed words, with
// P = 32 / BITS codes per word,
//   qweight int32 [K/P, N]  word (r, n) holds rows P*r..P*r+P-1 of column n, row P*r+j in
//                           bits BITS*j..BITS*j+BITS-1
//   scales  fp16  [G, N]    as stored in the checkpoint
//   zeros   uint8 [G, N]    effective zero points: the checkpoint's qzeros + 1, wrapped to
//                           BITS bits; for 3-bit codes kept in nibbles (BITS = 4) it is
//                           (stored & 7) + 1, up to 8, which is why it lives in a byte
//   kperm   int64 [K]       optional (desc_act): rows were sorted by group at load, so the
//                           kernel reads x[m, kperm[k]] for sorted row k
// Group g covers sorted rows [g*gs, min(K, (g+1)*gs)), G = ceil(K / gs): the last group may be
// partial (gs = 100, K = 4096 gives 41 groups), as in the plain version. Any group size is taken;
// where P does not divide it (a "rest class": 3/4-bit gs % 8, 2-bit gs % 16, 8-bit gs % 4), a
// word may hold codes of two groups or more and the group is looked up per code.
//
// Bound on the H100 (3.35 TB/s HBM): at M <= 16 the kernel is bound by the bytes of the
// quantized weight, BITS/8 B per weight plus fp16 scales and uint8 zeros per group and
// column. The arithmetic (2*M*K*N) only overtakes the bytes far above the decode regime.
//
// Design:
//  * Decode regime (M <= 16), the SIMT GEMV: it serves f32 activations, and bf16 and f16
//    ones at group sizes below 16 (and kernel="simt"); bf16 and f16 activations at a group
//    size of 16 or more take the tensor-core GEMV of wna16_gemv.cuh instead
//    (ops/gemm.py:route), one launch per call with its split-K combine folded in. Below 16
//    rows per group every 16-row step of that GEMV spans groups and its exact masked MMA sets
//    cost more than this kernel's call (PERF.md). Each thread owns 4 adjacent output columns
//    and reads one 16-byte int4 (4 words = P K-rows x 4 columns) per P K-rows, so a warp reads
//    512 contiguous bytes of a weight row. The group's scale and zero are loaded once per group.
//    A code becomes (q - z) without an int->float conversion: the float with bit pattern
//    0x4B000000 | q is 2^23 + q, and subtracting 2^23 + z is exact (q, z < 256). The M rows
//    accumulate x * (q - z) per group in f32 registers and fold the scale in once per group.
//    x[:, k-chunk] (gathered through kperm) is staged in shared memory as f32; all threads
//    of a warp read the same element, which shared memory broadcasts. A rest-class layer (f32,
//    or bf16/f16 below gs 16) takes the STRADDLE instance, which looks the group up per code, g = (P*kw + j) / gs, and scales
//    each code before it accumulates; the launch picks it by the layer's static group size, so
//    every other layer keeps the per-group instance.
//  * Split K: Llama's N = 4096 gives only 8 column blocks of 512 columns, far too few for
//    132 SMs, so blockIdx.y splits K into chunks. Each split writes its f32 partial sums to
//    a workspace [splits, M, N]; a second kernel adds the splits in a fixed order, adds the
//    bias and casts once to the activation type. No float atomics, so results are
//    deterministic (the STRADDLE instance too: its splits are whole words).
//  * Tile regime (M > 16), SIMT: a 32 x 64 weight tile is dequantized into shared memory as
//    f32 next to a 64 x 32 f32 tile of x; each of 256 threads accumulates a 4 x 4 block of
//    outputs in f32. The weight is never rounded below f32, so an f32 model computes at f32
//    in both regimes. It takes f32 activations and group sizes that 16 does not divide (the
//    rest classes per code, as the decode regime); bf16 and f16 activations with 16 | gs take
//    the tensor-core kernel of wna16_mma.cuh instead (ops/gemm.py:tile_kernel decides). The
//    kernel takes the word address as a functor (GptqWords here, Kb32lWords of
//    kb32l_tile.cuh for K6) and the row stride of scales and zeros, so K6's tile regime is
//    this kernel over the tile-contiguous words.
// Every entry point returns cudaGetLastError() and the Python wrapper raises when it is
// non-zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2 };

constexpr int DEC_THREADS = 128;   // decode: threads per block, 4 columns each
constexpr int RED_THREADS = 256;   // split-K reduction
constexpr int PF_BM = 64;          // prefill tile rows
constexpr int PF_BN = 64;          // prefill tile columns
constexpr int PF_BK = 32;          // prefill tile depth in K rows
constexpr int PF_THREADS = 256;
constexpr float MAGIC = 8388608.0f;  // 2^23

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// (q - z) for code j of word w, exact in f32; zb = 2^23 + z.
template <int BITS>
__device__ __forceinline__ float code_minus_zero(uint32_t w, int j, float zb) {
    return __uint_as_float(0x4B000000u | ((w >> (BITS * j)) & ((1u << BITS) - 1u))) - zb;
}

// ---- the fused RMS-norm prologue (K1's PRENORM instances) -------------------------------------
//
// Replaces autogptq_tpu/ops/pallas/gemm.py:_prenorm_x (:332) inside _kernel_kb32 and
// _kernel_ki32, reached with norm_w= through _matmul_kb32 / _matmul_ki32 (matmul_pallas'
// prenorm=): the product takes x_n = to_act(f32(x) * rstd * f32(w)) (1 + w with plus_one) in
// place of x, rstd = rsqrt(mean(x^2) + eps) over the row's full K in f32, the value the
// unfused arch.rms_norm would feed it. Each block reduces the squares of its own rows (at most
// 31: ops/gemm.py:prenorm_eligible) from global memory or L2, never from its K chunk's stage
// alone, with every thread of the block on every row and one fixed order (so every block of
// a launch, and every call, gets the same rstd); the norm weight is staged beside x (the GEMV
// and the tensor-core tile kernel copy it with x's cp.async; the SIMT kernels read it where
// they stage x). It adds M * K activation bytes per block, read from L2, to the weight stream
// of the product. The tensor-core GEMV (wna16_gemv.cuh) takes the rows' rstd from a launch just
// before it instead (Prenorm::rstd, from wg_rstd_kernel of wna16_wgmma.cuh), which it overlaps
// by programmatic dependent launch.

constexpr int PN_MAX_ROWS = 32;   // rows of x a prologue takes (the fused route's M < 32)

struct Prenorm {
    const void* w;   // norm weight [K] of type wdt (DT_F32, DT_F16 or DT_BF16)
    int wdt;
    float eps;
    int plus_one;    // the norm scales by 1 + w
    const float* rstd = nullptr;   // the GEMV: rstd [M] of the launch just before it
};

// Element i of a norm weight of type wdt at base (global or shared memory), as the norm scales.
__device__ __forceinline__ float prenorm_weight_at(const void* base, int wdt, int64_t i,
                                                   int plus_one) {
    float w;
    if (wdt == DT_F32)
        w = static_cast<const float*>(base)[i];
    else if (wdt == DT_F16)
        w = __half2float(static_cast<const __half*>(base)[i]);
    else
        w = __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
    return plus_one ? 1.0f + w : w;
}

__device__ __forceinline__ float prenorm_weight(const Prenorm& p, int64_t k) {
    return prenorm_weight_at(p.w, p.wdt, k, p.plus_one);
}

// Bytes of one norm weight element.
__host__ __device__ constexpr int prenorm_wsize(int wdt) { return wdt == DT_F32 ? 4 : 2; }

// x_n of one element: f32, times rstd, times the weight, one rounding to T (arch.rms_norm).
template <typename T>
__device__ __forceinline__ T prenorm_apply(T v, float rstd, float w) {
    return from_f32<T>(to_f32(v) * rstd * w);
}

// Sum of squares of the 16-byte run v of T values, in element order.
template <typename T>
__device__ __forceinline__ float sumsq16(const uint4& v) {
    const T* e = reinterpret_cast<const T*>(&v);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) s = fmaf(to_f32(e[i]), to_f32(e[i]), s);
    return s;
}

// rstd[i] = rsqrt(mean(x[i, 0:K]^2) + eps) for the rows i < rows <= MAXR of x (row stride K),
// by the whole block: each thread sums the squares of its 16-byte runs of a row, four rows at a
// time with four runs of each in flight (one trip to L2 for up to 4 rows of 4096 bf16 at 128
// threads), then the warps' sums of a row are added in warp order. red holds
// MAXR * (blockDim.x / 32) floats. Ends with a barrier: rstd is then visible to the block.
template <typename T, int MAXR>
__device__ __forceinline__ void prenorm_rstd(const T* __restrict__ x, int K, int rows, float eps,
                                             float* rstd, float* red) {
    constexpr int VEC = 16 / (int)sizeof(T);
    constexpr int RG = 4, U = 4;              // rows per group, runs in flight per row
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
    const int warps = nt >> 5;
    const bool vec = K % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    for (int i0 = 0; i0 < rows; i0 += RG) {
        float s[RG];
#pragma unroll
        for (int g = 0; g < RG; ++g) s[g] = 0.0f;
        if (vec) {
            const int runs = K / VEC;
            for (int c0 = tid; c0 < runs; c0 += U * nt) {
                uint4 v[RG][U];
#pragma unroll
                for (int g = 0; g < RG; ++g)
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int c = c0 + u * nt;
                        v[g][u] = i0 + g < rows && c < runs
                                      ? *reinterpret_cast<const uint4*>(x + (int64_t)(i0 + g) * K +
                                                                        (int64_t)c * VEC)
                                      : make_uint4(0u, 0u, 0u, 0u);
                    }
#pragma unroll
                for (int g = 0; g < RG; ++g)
#pragma unroll
                    for (int u = 0; u < U; ++u) s[g] += sumsq16<T>(v[g][u]);
            }
        } else {
            for (int k = tid; k < K; k += nt) {
#pragma unroll
                for (int g = 0; g < RG; ++g)
                    if (i0 + g < rows) {
                        const float v = to_f32(x[(int64_t)(i0 + g) * K + k]);
                        s[g] = fmaf(v, v, s[g]);
                    }
            }
        }
#pragma unroll
        for (int g = 0; g < RG; ++g) {
            if (i0 + g < rows) {             // uniform over the block
                float t = s[g];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xFFFFFFFFu, t, o);
                if (lane == 0) red[(i0 + g) * warps + warp] = t;
            }
        }
    }
    __syncthreads();
    if (tid < rows) {
        float t = 0.0f;
        for (int w = 0; w < warps; ++w) t += red[tid * warps + w];
        rstd[tid] = rsqrtf(t / (float)K + eps);
    }
    __syncthreads();
}

template <int BITS, typename T, int MT, bool STRADDLE, bool PRENORM = false>
__global__ void __launch_bounds__(DEC_THREADS)
wna16_decode_kernel(const T* __restrict__ x, const int64_t* __restrict__ kperm,
                    const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                    const uint8_t* __restrict__ zeros, const T* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ partial,
                    int M, int K, int N, int gs, int kc, Prenorm pn) {
    constexpr int P = 32 / BITS;   // codes per word
    extern __shared__ float xs[];  // [MT][kc]
    __shared__ float rstd[PRENORM ? MT : 1];
    __shared__ float red[PRENORM ? MT * (DEC_THREADS / 32) : 1];
    const int split = blockIdx.y;
    const int k0 = split * kc;
    const int k1 = min(K, k0 + kc);
    const int klen = k1 - k0;
    if constexpr (PRENORM) prenorm_rstd<T, MT>(x, K, M, pn.eps, rstd, red);
    for (int i = threadIdx.x; i < MT * kc; i += DEC_THREADS) {
        const int m = i / kc;
        const int kk = i - m * kc;
        float v = 0.0f;
        if (m < M && kk < klen) {
            const int k = k0 + kk;
            const int64_t src = kperm != nullptr ? kperm[k] : (int64_t)k;
            if constexpr (PRENORM)
                v = to_f32(prenorm_apply(x[(int64_t)m * K + src], rstd[m], prenorm_weight(pn, src)));
            else
                v = to_f32(x[(int64_t)m * K + src]);
        }
        xs[i] = v;
    }
    __syncthreads();

    const int n = 4 * (blockIdx.x * DEC_THREADS + threadIdx.x);
    if (n >= N) return;

    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

    if constexpr (STRADDLE) {
        // gs % P != 0: a word may hold codes of two groups or more, so the group is looked up
        // per code (g = (P*kw + j) / gs) and each code is scaled before it accumulates. Splits
        // are whole words (kc % P == 0, ops/gemm.py:split_k).
        int gcur = -1;
        float s[4], zb[4];
        for (int kw = k0 / P; kw < k1 / P; ++kw) {
            const int4 wv = __ldg(reinterpret_cast<const int4*>(qweight + (int64_t)kw * N + n));
            const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
            const float* xk = xs + (kw * P - k0);
#pragma unroll
            for (int j = 0; j < P; ++j) {
                const int g = (kw * P + j) / gs;
                if (g != gcur) {
                    gcur = g;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        s[c] = __half2float(scales[(int64_t)g * N + n + c]);
                        zb[c] = MAGIC + (float)zeros[(int64_t)g * N + n + c];
                    }
                }
                float d[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) d[c] = code_minus_zero<BITS>(w[c], j, zb[c]) * s[c];
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    const float xv = xk[m * kc + j];
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, d[c], acc[m][c]);
                }
            }
        }
    } else {
        const int g_first = k0 / gs;
        const int g_last = (k1 - 1) / gs;
        for (int g = g_first; g <= g_last; ++g) {
            const int ka = max(k0, g * gs);
            const int kb = min(k1, (g + 1) * gs);
            const uint2 sraw = *reinterpret_cast<const uint2*>(scales + (int64_t)g * N + n);
            const uint32_t zraw = *reinterpret_cast<const uint32_t*>(zeros + (int64_t)g * N + n);
            const __half2 s01 = *reinterpret_cast<const __half2*>(&sraw.x);
            const __half2 s23 = *reinterpret_cast<const __half2*>(&sraw.y);
            const float s[4] = {__low2float(s01), __high2float(s01), __low2float(s23), __high2float(s23)};
            float zb[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) zb[c] = MAGIC + (float)((zraw >> (8 * c)) & 0xFFu);

            float gacc[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) gacc[m][c] = 0.0f;

            for (int kw = ka / P; kw < kb / P; ++kw) {
                const int4 wv = __ldg(reinterpret_cast<const int4*>(qweight + (int64_t)kw * N + n));
                const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
                const float* xk = xs + (kw * P - k0);
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    float d[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) d[c] = code_minus_zero<BITS>(w[c], j, zb[c]);
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        const float xv = xk[m * kc + j];
#pragma unroll
                        for (int c = 0; c < 4; ++c) gacc[m][c] = fmaf(xv, d[c], gacc[m][c]);
                    }
                }
            }
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(gacc[m][c], s[c], acc[m][c]);
        }
    }

    if (partial != nullptr) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            if (m < M) {
                *reinterpret_cast<float4*>(partial + ((int64_t)split * M + m) * N + n) =
                    make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
            }
        }
        return;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        if (m < M) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float v = acc[m][c];
                if (bias != nullptr) v += to_f32(bias[n + c]);
                out[(int64_t)m * N + n + c] = from_f32<T>(v);
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
splitk_reduce_kernel(const float* __restrict__ partial, const T* __restrict__ bias,
                     T* __restrict__ out, int M, int N, int splits) {
    const int64_t i = (int64_t)blockIdx.x * RED_THREADS + threadIdx.x;
    const int64_t total = (int64_t)M * N;
    if (i >= total) return;
    float v = 0.0f;
    for (int sp = 0; sp < splits; ++sp) v += partial[sp * total + i];
    if (bias != nullptr) v += to_f32(bias[i % N]);
    out[i] = from_f32<T>(v);
}

// GPTQ's K-packed words [K/P, N]: word row kw of column n.
struct GptqWords {
    int n;     // row stride in words
    __device__ __forceinline__ int64_t operator()(int kw, int col) const {
        return (int64_t)kw * n + col;
    }
};

// Words are read at words(kw, n); scales and zeros are [G, ldsz] (ldsz >= N).
// PRENORM: the fused RMS-norm prologue, for M < PN_MAX_ROWS (one row block).
template <int BITS, typename T, typename Words, bool PRENORM = false>
__global__ void __launch_bounds__(PF_THREADS)
wna16_prefill_kernel(const T* __restrict__ x, const int64_t* __restrict__ kperm,
                     const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                     const uint8_t* __restrict__ zeros, const T* __restrict__ bias,
                     T* __restrict__ out, int M, int K, int N, int gs, Words words, int ldsz,
                     Prenorm pn) {
    constexpr int P = 32 / BITS;   // codes per word
    __shared__ __align__(16) float xs[PF_BK][PF_BM];
    __shared__ __align__(16) float ws[PF_BK][PF_BN];
    __shared__ float rstd[PRENORM ? PN_MAX_ROWS : 1];
    __shared__ float red[PRENORM ? PN_MAX_ROWS * (PF_THREADS / 32) : 1];
    const int m0 = blockIdx.y * PF_BM;
    const int n0 = blockIdx.x * PF_BN;
    if constexpr (PRENORM)
        prenorm_rstd<T, PN_MAX_ROWS>(x + (int64_t)m0 * K, K, min(M - m0, PN_MAX_ROWS), pn.eps,
                                     rstd, red);
    const int tx = threadIdx.x % 16;  // 4 output columns each
    const int ty = threadIdx.x / 16;  // 4 output rows each
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    const int kwords = K / P;
    for (int kt = 0; kt < K; kt += PF_BK) {
        for (int i = threadIdx.x; i < PF_BM * PF_BK; i += PF_THREADS) {
            const int mm = i / PF_BK;
            const int kk = i - mm * PF_BK;
            const int m = m0 + mm;
            const int k = kt + kk;
            float v = 0.0f;
            if (m < M && k < K) {
                const int64_t src = kperm != nullptr ? kperm[k] : (int64_t)k;
                if constexpr (PRENORM)
                    v = to_f32(prenorm_apply(x[(int64_t)m * K + src], rstd[mm],
                                             prenorm_weight(pn, src)));
                else
                    v = to_f32(x[(int64_t)m * K + src]);
            }
            xs[kk][mm] = v;
        }
        for (int i = threadIdx.x; i < (PF_BK / P) * PF_BN; i += PF_THREADS) {
            const int r = i / PF_BN;  // word row within the tile
            const int c = i % PF_BN;
            const int kw = kt / P + r;
            const int n = n0 + c;
            if (kw < kwords && n < N) {
                const uint32_t w = (uint32_t)qweight[words(kw, n)];
                if (gs % P == 0) {   // the word lies in one group
                    const int g = (kw * P) / gs;
                    const float s = __half2float(scales[(int64_t)g * ldsz + n]);
                    const float zb = MAGIC + (float)zeros[(int64_t)g * ldsz + n];
#pragma unroll
                    for (int j = 0; j < P; ++j)
                        ws[r * P + j][c] = code_minus_zero<BITS>(w, j, zb) * s;
                } else {             // rest class: the group of each code
#pragma unroll
                    for (int j = 0; j < P; ++j) {
                        const int g = (kw * P + j) / gs;
                        const float s = __half2float(scales[(int64_t)g * ldsz + n]);
                        const float zb = MAGIC + (float)zeros[(int64_t)g * ldsz + n];
                        ws[r * P + j][c] = code_minus_zero<BITS>(w, j, zb) * s;
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < P; ++j) ws[r * P + j][c] = 0.0f;
            }
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < PF_BK; ++kk) {
            const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
            const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (n >= N) continue;
            float v = acc[i][j];
            if (bias != nullptr) v += to_f32(bias[n]);
            out[(int64_t)m * N + n] = from_f32<T>(v);
        }
    }
}

template <int BITS, typename T, int MT, bool PRENORM>
cudaError_t launch_decode(const void* x, const int64_t* kperm, const int32_t* qweight,
                          const __half* scales, const uint8_t* zeros, const void* bias, void* out,
                          float* partial, int M, int K, int N, int gs, int kc, int splits,
                          cudaStream_t stream, Prenorm pn) {
    const dim3 grid((N / 4 + DEC_THREADS - 1) / DEC_THREADS, splits);
    const size_t smem = sizeof(float) * MT * kc;
    float* part = splits > 1 ? partial : nullptr;
    if (gs % (32 / BITS) == 0)
        wna16_decode_kernel<BITS, T, MT, false, PRENORM><<<grid, DEC_THREADS, smem, stream>>>(
            static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
            static_cast<T*>(out), part, M, K, N, gs, kc, pn);
    else if constexpr (!PRENORM)   // a rest-class layer: the per-code group instance
        wna16_decode_kernel<BITS, T, MT, true><<<grid, DEC_THREADS, smem, stream>>>(
            static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
            static_cast<T*>(out), part, M, K, N, gs, kc, pn);
    else                           // the prologue takes whole words per group (32 | gs)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const int64_t total = (int64_t)M * N;
    const unsigned blocks = (unsigned)((total + RED_THREADS - 1) / RED_THREADS);
    splitk_reduce_kernel<T><<<blocks, RED_THREADS, 0, stream>>>(
        partial, static_cast<const T*>(bias), static_cast<T*>(out), M, N, splits);
    return cudaGetLastError();
}

template <int BITS, typename T, bool PRENORM>
cudaError_t launch(const void* x, const int64_t* kperm, const int32_t* qweight,
                   const __half* scales, const uint8_t* zeros, const void* bias, void* out,
                   float* partial, int M, int K, int N, int gs, int kc, int splits,
                   cudaStream_t stream, Prenorm pn) {
    if (M <= 1)
        return launch_decode<BITS, T, 1, PRENORM>(x, kperm, qweight, scales, zeros, bias, out, partial, M, K, N, gs, kc, splits, stream, pn);
    if (M <= 2)
        return launch_decode<BITS, T, 2, PRENORM>(x, kperm, qweight, scales, zeros, bias, out, partial, M, K, N, gs, kc, splits, stream, pn);
    if (M <= 4)
        return launch_decode<BITS, T, 4, PRENORM>(x, kperm, qweight, scales, zeros, bias, out, partial, M, K, N, gs, kc, splits, stream, pn);
    if (M <= 8)
        return launch_decode<BITS, T, 8, PRENORM>(x, kperm, qweight, scales, zeros, bias, out, partial, M, K, N, gs, kc, splits, stream, pn);
    if (M <= 16)
        return launch_decode<BITS, T, 16, PRENORM>(x, kperm, qweight, scales, zeros, bias, out, partial, M, K, N, gs, kc, splits, stream, pn);
    const dim3 grid((N + PF_BN - 1) / PF_BN, (M + PF_BM - 1) / PF_BM);
    wna16_prefill_kernel<BITS, T, GptqWords, PRENORM><<<grid, PF_THREADS, 0, stream>>>(
        static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
        static_cast<T*>(out), M, K, N, gs, GptqWords{N}, N, pn);
    return cudaGetLastError();
}

// The checks of a fused-prologue entry: a norm weight of a known type and M < PN_MAX_ROWS.
inline bool prenorm_ok(int M, const Prenorm& pn) {
    return M < PN_MAX_ROWS && pn.w != nullptr && pn.wdt >= DT_F32 && pn.wdt <= DT_BF16;
}

template <int BITS, bool PRENORM = false>
int wna16_gemm(const void* x, const int64_t* kperm, const int32_t* qweight, const void* scales,
         const uint8_t* zeros, const void* bias, void* out, float* partial, int dtype, int M,
         int K, int N, int gs, int kc, int splits, void* stream, Prenorm pn = Prenorm{}) {
    constexpr int P = 32 / BITS;
    if (M <= 0 || K <= 0 || N <= 0 || K % P != 0 || N % 4 != 0 || gs <= 0 ||
        (M <= 16 && (kc <= 0 || kc % P != 0 || splits <= 0 || (splits > 1 && partial == nullptr))) ||
        (PRENORM && !prenorm_ok(M, pn)))
        return (int)cudaErrorInvalidValue;
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F32:
            return (int)launch<BITS, float, PRENORM>(x, kperm, qweight, s, zeros, bias, out, partial, M, K, N, gs, kc, splits, st, pn);
        case DT_F16:
            return (int)launch<BITS, __half, PRENORM>(x, kperm, qweight, s, zeros, bias, out, partial, M, K, N, gs, kc, splits, st, pn);
        case DT_BF16:
            return (int)launch<BITS, __nv_bfloat16, PRENORM>(x, kperm, qweight, s, zeros, bias, out, partial, M, K, N, gs, kc, splits, st, pn);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Exports `int NAME(...)` for BITS-bit codes and `const char* NAME_error_string(int)`.
#define WNA16_DEFINE_ENTRY(NAME, BITS)                                                          \
    extern "C" int NAME(const void* x, const int64_t* kperm, const int32_t* qweight,            \
                        const void* scales, const uint8_t* zeros, const void* bias, void* out,  \
                        float* partial, int dtype, int M, int K, int N, int gs, int kc,         \
                        int splits, void* stream) {                                             \
        return wna16_gemm<BITS>(x, kperm, qweight, scales, zeros, bias, out, partial, dtype,    \
                                M, K, N, gs, kc, splits, stream);                               \
    }                                                                                           \
    extern "C" const char* NAME##_error_string(int code) {                                      \
        return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
    }

// Exports `int NAME_norm(...)`: NAME's SIMT kernels with the fused RMS-norm prologue (M < 32),
// the arguments of NAME and the norm weight, its dtype code, eps and plus_one before the stream.
#define WNA16_NORM_DEFINE_ENTRY(NAME, BITS)                                                     \
    extern "C" int NAME##_norm(const void* x, const int64_t* kperm, const int32_t* qweight,     \
                               const void* scales, const uint8_t* zeros, const void* bias,      \
                               void* out, float* partial, int dtype, int M, int K, int N,       \
                               int gs, int kc, int splits, const void* nw, int nw_dtype,        \
                               float eps, int plus_one, void* stream) {                         \
        return wna16_gemm<BITS, true>(x, kperm, qweight, scales, zeros, bias, out, partial,     \
                                      dtype, M, K, N, gs, kc, splits, stream,                   \
                                      Prenorm{nw, nw_dtype, eps, plus_one});                    \
    }
