// K10: the backward of the wNa16 dequant-matmul for Hopper (sm_90a),
//   dx[M,K] = g[M,N] @ ((q - z) * s)[K,N]^T,  q a BITS-bit code, BITS in {2, 4, 8},
// the input cotangent of y = x @ dequant(W) (ops/quantlinear.py, the autograd Function).
//
// Replaces the TPU kernels of autogptq_tpu/ops/pallas/gemm.py that back the JAX custom VJP
// (autogptq_tpu/ops/quantlinear.py:761-783, matmul_t :710): _kernel_kb32_t / _matmul_kb32_t
// (:811 / :844), _kernel_ki32_t / _matmul_ki32_t (:1031 / :1395) and _kernel_kpair_t /
// _matmul_kpair_t (:1289 / :1334), dispatched by matmul_t_pallas (:1445). Those cover 3- and
// 4-bit codes; this template is instantiated for 4-bit storage (4-bit codes and 3-bit codes
// kept in nibbles), and for 2- and 8-bit storage, so every width the port loads trains
// through a kernel (wna16_gemm_t.cu exports the three entry points from one library).
//
// Weight layout: as the forward kernels (wna16_gemm.cuh), GPTQ's own K-packed words with
// P = 32 / BITS codes per word, fp16 scales [G, N], uint8 effective zeros [G, N], and kperm
// int64 [K] or null. kperm is a permutation (ops/quantlinear.py:group_order), so sorted row k
// of the product is dx column kperm[k]: a plain store, no scatter-add and no atomics. The
// kernel reads words through an address functor and scales and zeros with a row stride, so
// it also runs over the tile-contiguous kb32l words of K6 (kb32l_tile.cuh: Kb32lWords,
// scales and zeros [G_pad, N_pad]); that entry replaces the backward of the JAX kb32l layout,
// which has no transpose kernel of its own (the JAX package dequantizes it through XLA).
//
// Bound on the H100: at the training shape (M = 2048 rows of a 4 x 512 batch) the kernel is
// bound by operations, 2*M*K*N flops: a 4096x4096 projection takes at least 0.0695 ms at
// 989 TFLOP/s bf16 dense, 4096x11008 and 11008x4096 0.187 ms each, one Llama-2-7B layer's 7
// projections 0.838 ms; its bytes (g, the quantized weight, dx) would take about 0.013 ms per
// 4096^2 call.
//
// Design: an NT-GEMM with the dequant fused, the tile kernel of K1 with the roles of K and N
// exchanged. Each block owns a 64 x 64 tile of dx (64 rows of M, 64 sorted K rows) and loops
// over N in chunks of 32: the g chunk is staged in shared memory as f32, the weight chunk is
// dequantized into shared memory as f32 with the 0x4B000000 | q trick and the group's scale
// and zero (looked up per code where P does not divide gs, so a word may straddle groups:
// the rest classes), and each of 256 threads
// accumulates a 4 x 4 block of dx in f32 registers. The result is written once, through
// kperm, rounded once to g's dtype. No split over N across blocks and no atomics, so the
// result is deterministic, like K1's.
//
// Precision: f32 cotangents stay f32 end to end; bf16 and fp16 cotangents are widened to f32
// in shared memory, accumulate in f32 against the f32 weight and round once. This differs on
// purpose from the JAX kernels, which dot in bf16 even for f32 cotangents
// (dot_dtype=jnp.bfloat16 at gemm.py:1452; tests/test_matmul_vjp.py allows 2e-2 for that).
//
// This SIMT kernel takes f32 cotangents (and bf16/f16 ones only where a caller names it:
// kernel="simt"). bf16 and f16 cotangents take the tensor cores at every group size: above 16
// rows the tile K10 of wna16_mma.cuh (wna16_t_mma_kernel: mma.sync with the scaled weight as a
// hi/lo pair of the cotangent's type; its ANY_GS instance for the group sizes 16 does not
// divide), exported beside it as NAME_mma; at M <= 16 the split-N decode regime of
// wna16_gemv_t.cuh (the same hi/lo pair), exported as NAME_gemv (and w4a16_kb32l_gemm_t_gemv);
// ops/gemm.py:t_route decides by dtype and rows. wgmma and TMA are not used. Every entry
// point returns cudaGetLastError() and the Python wrapper raises when it is non-zero.

#pragma once

#include "kb32l_tile.cuh"
#include "wna16_gemv_t.cuh"
#include "wna16_mma.cuh"

namespace {

constexpr int T_BM = 64;        // dx rows (M) per block
constexpr int T_BK = 64;        // dx columns (sorted K rows of W) per block
constexpr int T_BN = 32;        // N, the reduction, per shared-memory stage
constexpr int T_PAD = 4;        // keeps rows 16-byte aligned for float4 reads
constexpr int T_THREADS = 256;

template <int BITS, typename T, typename Words>
__global__ void __launch_bounds__(T_THREADS)
wna16_t_kernel(const T* __restrict__ g, const int64_t* __restrict__ kperm,
               const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
               const uint8_t* __restrict__ zeros, T* __restrict__ dx, int M, int K, int N,
               int gs, Words words, int ldsz) {
    constexpr int P = 32 / BITS;       // codes per word
    constexpr int WR = T_BK / P;       // word rows per K tile
    __shared__ __align__(16) float gsm[T_BN][T_BM + T_PAD];
    __shared__ __align__(16) float wsm[T_BN][T_BK + T_PAD];
    const int k0 = blockIdx.x * T_BK;
    const int m0 = blockIdx.y * T_BM;
    const int tx = threadIdx.x % 16;   // 4 dx columns each
    const int ty = threadIdx.x / 16;   // 4 dx rows each
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    const int kwords = K / P;
    const int kw0 = k0 / P;
    for (int nt = 0; nt < N; nt += T_BN) {
        for (int i = threadIdx.x; i < T_BM * T_BN; i += T_THREADS) {
            const int mm = i / T_BN;
            const int nn = i - mm * T_BN;
            const int m = m0 + mm;
            const int n = nt + nn;
            gsm[nn][mm] = (m < M && n < N) ? to_f32(g[(int64_t)m * N + n]) : 0.0f;
        }
        for (int i = threadIdx.x; i < WR * T_BN; i += T_THREADS) {
            const int r = i / T_BN;    // word row within the tile
            const int c = i - r * T_BN;
            const int kw = kw0 + r;
            const int n = nt + c;
            if (kw < kwords && n < N) {
                const uint32_t w = (uint32_t)qweight[words(kw, n)];
                if (gs % P == 0) {   // the word lies in one group
                    const int grp = (kw * P) / gs;
                    const float s = __half2float(scales[(int64_t)grp * ldsz + n]);
                    const float zb = MAGIC + (float)zeros[(int64_t)grp * ldsz + n];
#pragma unroll
                    for (int j = 0; j < P; ++j)
                        wsm[c][r * P + j] = code_minus_zero<BITS>(w, j, zb) * s;
                } else {             // rest class: the group of each code
#pragma unroll
                    for (int j = 0; j < P; ++j) {
                        const int grp = (kw * P + j) / gs;
                        const float s = __half2float(scales[(int64_t)grp * ldsz + n]);
                        const float zb = MAGIC + (float)zeros[(int64_t)grp * ldsz + n];
                        wsm[c][r * P + j] = code_minus_zero<BITS>(w, j, zb) * s;
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < P; ++j) wsm[c][r * P + j] = 0.0f;
            }
        }
        __syncthreads();
#pragma unroll 8
        for (int nn = 0; nn < T_BN; ++nn) {
            const float4 a4 = *reinterpret_cast<const float4*>(&gsm[nn][ty * 4]);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            const float4 b4 = *reinterpret_cast<const float4*>(&wsm[nn][tx * 4]);
            const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx * 4 + j;
        if (k >= K) continue;
        const int64_t col = kperm != nullptr ? kperm[k] : (int64_t)k;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + ty * 4 + i;
            if (m < M) dx[(int64_t)m * K + col] = from_f32<T>(acc[i][j]);
        }
    }
}

template <int BITS, typename T, typename Words>
cudaError_t launch_t(const void* g, const int64_t* kperm, const int32_t* qweight,
                     const __half* scales, const uint8_t* zeros, void* dx, int M, int K, int N,
                     int gs, Words words, int ldsz, cudaStream_t stream) {
    const dim3 grid((K + T_BK - 1) / T_BK, (M + T_BM - 1) / T_BM);
    wna16_t_kernel<BITS, T, Words><<<grid, T_THREADS, 0, stream>>>(
        static_cast<const T*>(g), kperm, qweight, scales, zeros, static_cast<T*>(dx), M, K, N,
        gs, words, ldsz);
    return cudaGetLastError();
}

template <int BITS, typename Words>
int launch_t_dtype(const void* g, const int64_t* kperm, const int32_t* qweight,
                   const void* scales, const uint8_t* zeros, void* dx, int dtype, int M, int K,
                   int N, int gs, Words words, int ldsz, void* stream) {
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F32:
            return (int)launch_t<BITS, float>(g, kperm, qweight, s, zeros, dx, M, K, N, gs,
                                              words, ldsz, st);
        case DT_F16:
            return (int)launch_t<BITS, __half>(g, kperm, qweight, s, zeros, dx, M, K, N, gs,
                                               words, ldsz, st);
        case DT_BF16:
            return (int)launch_t<BITS, __nv_bfloat16>(g, kperm, qweight, s, zeros, dx, M, K, N,
                                                      gs, words, ldsz, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

template <int BITS>
int wna16_gemm_t(const void* g, const int64_t* kperm, const int32_t* qweight,
                 const void* scales, const uint8_t* zeros, void* dx, int dtype, int M, int K,
                 int N, int gs, void* stream) {
    constexpr int P = 32 / BITS;
    if (M <= 0 || K <= 0 || N <= 0 || K % P != 0 || N % 4 != 0 || gs <= 0 ||
        (M + T_BM - 1) / T_BM > 65535)
        return (int)cudaErrorInvalidValue;
    return launch_t_dtype<BITS>(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, gs,
                                GptqWords{N}, N, stream);
}

// K10 over K6's kb32l words: 4-bit storage, n_pad the padded width of scales and zeros.
int kb32l_gemm_t(const void* g, const int64_t* kperm, const int32_t* qweight,
                 const void* scales, const uint8_t* zeros, void* dx, int dtype, int M, int K,
                 int N, int n_pad, int gs, void* stream) {
    if (M <= 0 || K <= 0 || N <= 0 || gs < 32 || KB32L_KB % gs != 0 || gs % 32 != 0 ||
        K % gs != 0 || n_pad % KB32L_BN != 0 || n_pad < N || n_pad - N >= KB32L_BN ||
        (M + T_BM - 1) / T_BM > 65535)
        return (int)cudaErrorInvalidValue;
    const int nbk = (K + KB32L_KB - 1) / KB32L_KB;
    return launch_t_dtype<4>(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, gs,
                             Kb32lWords{nbk}, n_pad, stream);
}

// The tensor-core K10 (wna16_mma.cuh) over GPTQ words, bf16 or f16 cotangents, any M; a group
// size that 16 does not divide takes its ANY_GS instance.
template <int BITS>
int wna16_gemm_t_mma(const void* g, const int64_t* kperm, const int32_t* qweight,
                     const void* scales, const uint8_t* zeros, void* dx, int dtype, int M, int K,
                     int N, int gs, void* stream) {
    constexpr int P = 32 / BITS;
    if (M <= 0 || K <= 0 || N <= 0 || K % P != 0 || N % 4 != 0 || gs <= 0 ||
        (M + MMA_BM - 1) / MMA_BM > 65535)
        return (int)cudaErrorInvalidValue;
    if (gs % 16 != 0)
        return launch_t_mma_dtype<BITS, GptqWords, true>(g, kperm, qweight, scales, zeros, dx,
                                                         dtype, M, K, N, gs, GptqWords{N}, N,
                                                         stream);
    return launch_t_mma_dtype<BITS>(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, gs,
                                    GptqWords{N}, N, stream);
}

// The tensor-core K10 over K6's kb32l words.
int kb32l_gemm_t_mma(const void* g, const int64_t* kperm, const int32_t* qweight,
                     const void* scales, const uint8_t* zeros, void* dx, int dtype, int M, int K,
                     int N, int n_pad, int gs, void* stream) {
    if (M <= 0 || K <= 0 || N <= 0 || gs < 32 || KB32L_KB % gs != 0 || gs % 32 != 0 ||
        K % gs != 0 || n_pad % KB32L_BN != 0 || n_pad < N || n_pad - N >= KB32L_BN ||
        (M + MMA_BM - 1) / MMA_BM > 65535)
        return (int)cudaErrorInvalidValue;
    const int nbk = (K + KB32L_KB - 1) / KB32L_KB;
    return launch_t_mma_dtype<4>(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, gs,
                                 Kb32lWords{nbk}, n_pad, stream);
}

// K10's decode regime (wna16_gemv_t.cuh) over GPTQ words, bf16 or f16 cotangents, M <= 16, any
// group size: nc N columns per split, splits of them (ops/gemm.py:t_gemv_plan), the f32 partials
// in ws [splits, M, K] and one ticket counter per K tile in counters when splits > 1.
template <int BITS>
int wna16_gemm_t_gemv(const void* g, const int64_t* kperm, const int32_t* qweight,
                      const void* scales, const uint8_t* zeros, void* dx, float* ws,
                      int* counters, int dtype, int M, int K, int N, int gs, int nc, int splits,
                      void* stream) {
    return launch_t_gemv_dtype<BITS>(g, kperm, qweight, scales, zeros, dx, ws, counters, dtype,
                                     M, K, N, gs, nc, splits, GptqWords{N}, N, stream);
}

// K10's decode regime over K6's kb32l words.
int kb32l_gemm_t_gemv(const void* g, const int64_t* kperm, const int32_t* qweight,
                      const void* scales, const uint8_t* zeros, void* dx, float* ws, int* counters,
                      int dtype, int M, int K, int N, int n_pad, int gs, int nc, int splits,
                      void* stream) {
    if (K <= 0 || gs < 32 || KB32L_KB % gs != 0 || gs % 32 != 0 || K % gs != 0 ||
        n_pad % KB32L_BN != 0 || n_pad < N || n_pad - N >= KB32L_BN)
        return (int)cudaErrorInvalidValue;
    const int nbk = (K + KB32L_KB - 1) / KB32L_KB;
    return launch_t_gemv_dtype<4>(g, kperm, qweight, scales, zeros, dx, ws, counters, dtype, M, K,
                                  N, gs, nc, splits, Kb32lWords{nbk}, n_pad, stream);
}

}  // namespace

// Exports `int NAME(...)` (the SIMT kernel), `int NAME_mma(...)` (the tensor-core tile kernel)
// and `int NAME_gemv(...)` (the decode regime: ws, counters after dx, nc and splits after gs)
// for BITS-bit codes.
#define WNA16_T_DEFINE_ENTRY(NAME, BITS)                                                        \
    extern "C" int NAME(const void* g, const int64_t* kperm, const int32_t* qweight,            \
                        const void* scales, const uint8_t* zeros, void* dx, int dtype, int M,   \
                        int K, int N, int gs, void* stream) {                                   \
        return wna16_gemm_t<BITS>(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, gs,     \
                                  stream);                                                      \
    }                                                                                           \
    extern "C" int NAME##_mma(const void* g, const int64_t* kperm, const int32_t* qweight,      \
                              const void* scales, const uint8_t* zeros, void* dx, int dtype,    \
                              int M, int K, int N, int gs, void* stream) {                      \
        return wna16_gemm_t_mma<BITS>(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, gs, \
                                      stream);                                                  \
    }                                                                                           \
    extern "C" int NAME##_gemv(const void* g, const int64_t* kperm, const int32_t* qweight,     \
                               const void* scales, const uint8_t* zeros, void* dx, float* ws,   \
                               int* counters, int dtype, int M, int K, int N, int gs, int nc,   \
                               int splits, void* stream) {                                      \
        return wna16_gemm_t_gemv<BITS>(g, kperm, qweight, scales, zeros, dx, ws, counters,      \
                                       dtype, M, K, N, gs, nc, splits, stream);                 \
    }
