// K9: routed-expert w4a16 dequant-GEMV for Hopper (sm_90a), the MoE top-k decode product
//   y[p, :] = x[p, :] @ ((q - z) * s)  of expert sel[p],  p < P,
// for 4-bit codes (3-bit codes ride in nibbles), f32 accumulation, output in x's dtype
// (f32, f16 or bf16).
//
// Replaces the TPU kernel autogptq_tpu/ops/pallas/gemm.py:_kernel_routed_kb32 (reached
// through _matmul_routed_kb32 / matmul_routed_pallas), which the JAX package's
// models/arch.py:moe_mlp runs for every gate/up/down projection of a decode step when
// pairs = tokens * top_k <= experts. That kernel gets the selection by scalar prefetch; here
// each block reads sel[p] from device memory itself, so no routing decision ever goes to the
// host (no sync per layer).
//
// Layout (ops/quantlinear.py:StackedQuantLinear): the per-expert runtime layout of K1
// stacked on a leading expert axis,
//   qweight int32 [E, K/8, N]  GPTQ's K-packed words, row 8*r+j of column n in bits 4j..4j+3
//   scales  fp16  [E, G, N]
//   zeros   uint8 [E, G, N]    effective zero points
//   sel     int32 [P]          expert of each pair
//
// Bound on the H100 (3.35 TB/s HBM): the bytes of the experts the pairs select, each counted
// once, K*N/2 B of words plus 3*G*N B of scales and zeros each. Mixtral-8x7B decode at P = 2
// (one token, top-2) reads 2 x (29.4 + 1.4) MB per 4096x14336 projection: 0.0184 ms per call,
// and 0.0550 ms for a layer's gate, up and down. The arithmetic (2*P*K*N) is far below that.
//
// Two kernels, chosen on the host by dtype, group size and P (ops/gemm.py:routed_route):
//  * bf16/f16 with P <= 16 and a group size of 16 or more (the ANY_GS instance, gemv_block's
//    masked MMA sets, where 16 does not divide it): routed_gemv_kernel (entry and launch count
//    w4a16_routed_gemm_gemv), the tensor-core GEMV of wna16_gemv.cuh, expert-major. Its grid is
//    (column tiles of 64, K splits, min(P, E) expert slices), planned from shapes alone
//    (ops/gemm.py:routed_plan); slice z serves the z-th distinct expert the pairs chose and
//    gathers the x rows of the pairs that chose it into its MMA operand, so each selected
//    expert streams once per call however many pairs chose it, and a slice beyond the distinct
//    experts exits before its first copy. One
//    launch per call: the last block of each (expert, column tile) adds the splits' partials in
//    split order (bit-equal from call to call) and writes its pairs' rows.
//  * f32, group sizes below 16 (every 16-row step of the GEMV spans groups there, and its
//    masked sets were slower than this kernel: PERF.md) and P > 16: routed_decode_kernel below
//    with routed_reduce_kernel (launch count w4a16_routed_gemm; also what kernel="simt" names).
//
// Design of routed_decode_kernel (a routed copy of wna16_decode_kernel in wna16_gemm.cuh):
//  * Grid (ceil(N/4/128), splits, P). Block z is pair p: it reads e = sel[p], offsets
//    qweight, scales and zeros by expert e's stride and stages x[p, k-chunk] in shared
//    memory as f32. Each thread owns 4 adjacent columns and reads one 16-byte int4
//    (8 K-rows x 4 columns) per word row, so a warp reads 512 contiguous bytes; the codes
//    become (q - z) by the 2^23 bit trick (code_minus_zero) and each group's scale is
//    folded in once. A group size that 8 does not divide (a rest class) takes the STRADDLE
//    instance, which looks the group up per code as K1's decode regime does.
//  * Split K as K1 does (ops/gemm.py:split_k): a pair has only 28 column blocks at
//    N = 14336 and 8 at N = 4096, too few for 132 SMs. Each split writes f32 partial sums to
//    [splits, P, N]; routed_reduce_kernel adds them in a fixed order and casts once, so
//    results are deterministic and there are no float atomics.
//  * A bad expert id (sel[p] < 0 or >= E), in both kernels: the pair's row of out is not
//    written, and one thread sets bit ERR_BAD_EXPERT of the device flag *err, which the host
//    reads when it chooses (ops/gemm.py:check_routed_errors), as K8a/K8b do for page ids.
// The entry point returns cudaGetLastError() and the Python wrapper raises when it is
// non-zero.

#include "wna16_gemv.cuh"

namespace {

template <typename T, bool STRADDLE>
__global__ void __launch_bounds__(DEC_THREADS)
routed_decode_kernel(const T* __restrict__ x, const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                     const uint8_t* __restrict__ zeros, T* __restrict__ out,
                     float* __restrict__ partial, int* __restrict__ err, int E, int P, int K,
                     int N, int gs, int kc) {
    constexpr int BITS = 4;
    constexpr int PK = 32 / BITS;  // codes per word
    extern __shared__ float xs[];  // [kc]
    const int p = blockIdx.z;
    const int e = sel[p];
    if (e < 0 || e >= E) {         // uniform over the block: nobody reaches the barrier
        if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) atomicOr(err, ERR_BAD_EXPERT);
        return;
    }
    const int G = (K + gs - 1) / gs;
    const int32_t* qw = qweight + (int64_t)e * (K / PK) * N;
    const __half* sc = scales + (int64_t)e * G * N;
    const uint8_t* zr = zeros + (int64_t)e * G * N;

    const int split = blockIdx.y;
    const int k0 = split * kc;
    const int k1 = min(K, k0 + kc);
    const int klen = k1 - k0;
    for (int kk = threadIdx.x; kk < kc; kk += DEC_THREADS)
        xs[kk] = kk < klen ? to_f32(x[(int64_t)p * K + k0 + kk]) : 0.0f;
    __syncthreads();

    const int n = 4 * (blockIdx.x * DEC_THREADS + threadIdx.x);
    if (n >= N) return;

    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (STRADDLE) {
        // gs % 8 != 0: the group of each code (wna16_decode_kernel's STRADDLE instance)
        int gcur = -1;
        float s[4], zb[4];
        for (int kw = k0 / PK; kw < k1 / PK; ++kw) {
            const int4 wv = __ldg(reinterpret_cast<const int4*>(qw + (int64_t)kw * N + n));
            const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
            const float* xk = xs + (kw * PK - k0);
#pragma unroll
            for (int j = 0; j < PK; ++j) {
                const int g = (kw * PK + j) / gs;
                if (g != gcur) {
                    gcur = g;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        s[c] = __half2float(sc[(int64_t)g * N + n + c]);
                        zb[c] = MAGIC + (float)zr[(int64_t)g * N + n + c];
                    }
                }
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[c] = fmaf(xk[j], code_minus_zero<BITS>(w[c], j, zb[c]) * s[c], acc[c]);
            }
        }
    } else {
        const int g_first = k0 / gs;
        const int g_last = (k1 - 1) / gs;
        for (int g = g_first; g <= g_last; ++g) {
            const int ka = max(k0, g * gs);
            const int kb = min(k1, (g + 1) * gs);
            const uint2 sraw = *reinterpret_cast<const uint2*>(sc + (int64_t)g * N + n);
            const uint32_t zraw = *reinterpret_cast<const uint32_t*>(zr + (int64_t)g * N + n);
            const __half2 s01 = *reinterpret_cast<const __half2*>(&sraw.x);
            const __half2 s23 = *reinterpret_cast<const __half2*>(&sraw.y);
            const float s[4] = {__low2float(s01), __high2float(s01), __low2float(s23), __high2float(s23)};
            float zb[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) zb[c] = MAGIC + (float)((zraw >> (8 * c)) & 0xFFu);

            float gacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int kw = ka / PK; kw < kb / PK; ++kw) {
                const int4 wv = __ldg(reinterpret_cast<const int4*>(qw + (int64_t)kw * N + n));
                const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
                const float* xk = xs + (kw * PK - k0);
#pragma unroll
                for (int j = 0; j < PK; ++j) {
                    const float xv = xk[j];
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        gacc[c] = fmaf(xv, code_minus_zero<BITS>(w[c], j, zb[c]), gacc[c]);
                }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = fmaf(gacc[c], s[c], acc[c]);
        }
    }

    if (partial != nullptr) {
        *reinterpret_cast<float4*>(partial + ((int64_t)split * P + p) * N + n) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(int64_t)p * N + n + c] = from_f32<T>(acc[c]);
}

// Adds the splits of every valid pair's row in a fixed order and casts once; rows of pairs
// with a bad expert id are left as they were.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
routed_reduce_kernel(const float* __restrict__ partial, const int32_t* __restrict__ sel,
                     T* __restrict__ out, int E, int P, int N, int splits) {
    const int64_t i = (int64_t)blockIdx.x * RED_THREADS + threadIdx.x;
    const int64_t total = (int64_t)P * N;
    if (i >= total) return;
    const int e = sel[i / N];
    if (e < 0 || e >= E) return;
    float v = 0.0f;
    for (int sp = 0; sp < splits; ++sp) v += partial[sp * total + i];
    out[i] = from_f32<T>(v);
}

template <typename T>
cudaError_t launch_routed(const void* x, const int32_t* sel, const int32_t* qweight,
                          const __half* scales, const uint8_t* zeros, void* out, float* partial,
                          int* err, int E, int P, int K, int N, int gs, int kc, int splits,
                          cudaStream_t stream) {
    const dim3 grid((N / 4 + DEC_THREADS - 1) / DEC_THREADS, splits, P);
    const size_t smem = sizeof(float) * kc;
    float* part = splits > 1 ? partial : nullptr;
    if (gs % 8 == 0)
        routed_decode_kernel<T, false><<<grid, DEC_THREADS, smem, stream>>>(
            static_cast<const T*>(x), sel, qweight, scales, zeros, static_cast<T*>(out), part,
            err, E, P, K, N, gs, kc);
    else   // a rest-class layer: the per-code group instance
        routed_decode_kernel<T, true><<<grid, DEC_THREADS, smem, stream>>>(
            static_cast<const T*>(x), sel, qweight, scales, zeros, static_cast<T*>(out), part,
            err, E, P, K, N, gs, kc);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return e;
    const int64_t total = (int64_t)P * N;
    const unsigned blocks = (unsigned)((total + RED_THREADS - 1) / RED_THREADS);
    routed_reduce_kernel<T><<<blocks, RED_THREADS, 0, stream>>>(
        partial, sel, static_cast<T*>(out), E, P, N, splits);
    return cudaGetLastError();
}

// The expert-major tensor-core GEMV (bf16, f16; P <= 16): grid (column tiles, splits,
// min(P, E) expert slices); the x stage holds the P rows. ANY_GS for the group sizes 16 does
// not divide (gemv_block's masked MMA sets).
template <typename T, int MT, bool ANY_GS>
__global__ void __launch_bounds__(GV_THREADS, 4)
routed_gemv_kernel(const T* __restrict__ x, const int32_t* __restrict__ sel,
                   const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                   const uint8_t* __restrict__ zeros, T* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int* __restrict__ err, int E, int P, int K, int N,
                   int gs, int kc, int splits, int gather) {
    gemv_block<4, T, MT, GptqWords, true, false, ANY_GS>(
        x, nullptr, qweight, scales, zeros, nullptr, out, ws, counters, sel, err, P, K, N, gs, kc,
        splits, gather, GptqWords{N}, N, E, P);
}

template <typename T, int MT, bool ANY_GS>
cudaError_t launch_routed_gemv(const void* x, const int32_t* sel, const int32_t* qweight,
                               const __half* scales, const uint8_t* zeros, void* out, float* ws,
                               int* counters, int* err, int E, int P, int K, int N, int gs,
                               int kc, int splits, cudaStream_t stream) {
    static const cudaError_t attr = allow_smem(routed_gemv_kernel<T, MT, ANY_GS>, GV_SMEM_LIMIT);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((N + GV_BN - 1) / GV_BN, splits, P < E ? P : E);
    routed_gemv_kernel<T, MT, ANY_GS><<<grid, GV_THREADS, gv_smem_bytes<4>(P, kc, gs), stream>>>(
        static_cast<const T*>(x), sel, qweight, scales, zeros, static_cast<T*>(out), ws,
        counters, err, E, P, K, N, gs, kc, splits, gv_gather(x, nullptr, K));
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_routed_gemv_rows(const void* x, const int32_t* sel, const int32_t* qweight,
                                    const __half* scales, const uint8_t* zeros, void* out,
                                    float* ws, int* counters, int* err, int E, int P, int K,
                                    int N, int gs, int kc, int splits, cudaStream_t stream) {
    // a block takes the pairs that chose its expert: at most P of them
    if (gs % 16 != 0) {
        if (P <= 8)
            return launch_routed_gemv<T, 8, true>(x, sel, qweight, scales, zeros, out, ws,
                                                  counters, err, E, P, K, N, gs, kc, splits,
                                                  stream);
        return launch_routed_gemv<T, 16, true>(x, sel, qweight, scales, zeros, out, ws, counters,
                                               err, E, P, K, N, gs, kc, splits, stream);
    }
    if (P <= 8)
        return launch_routed_gemv<T, 8, false>(x, sel, qweight, scales, zeros, out, ws, counters,
                                               err, E, P, K, N, gs, kc, splits, stream);
    return launch_routed_gemv<T, 16, false>(x, sel, qweight, scales, zeros, out, ws, counters,
                                            err, E, P, K, N, gs, kc, splits, stream);
}

}  // namespace

// The expert-major tensor-core GEMV: x [P, K] bf16/f16, sel int32 [P], a stack of E experts
// (qweight [E, K/8, N], scales [E, G, N], zeros [E, G, N]), out [P, N]; kc K rows per split,
// splits of them (ops/gemm.py:routed_plan), the f32 partials in ws [splits, P, N] and one ticket
// counter per (expert slice, 64-column tile) in counters when splits > 1.
extern "C" int w4a16_routed_gemm_gemv(const void* x, const int32_t* sel, const int32_t* qweight,
                                      const void* scales, const uint8_t* zeros, void* out,
                                      float* ws, int* counters, int* err, int dtype, int E, int P,
                                      int K, int N, int gs, int kc, int splits, void* stream) {
    if (E <= 0 || E > 65535 || P <= 0 || P > 16 || K <= 0 || N <= 0 || K % 8 != 0 ||
        N % 4 != 0 || !gv_plan_ok(K, gs, kc, splits, ws, counters) || err == nullptr ||
        gv_smem_bytes<4>(P, kc, gs) > GV_SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F16:
            return (int)launch_routed_gemv_rows<__half>(x, sel, qweight, s, zeros, out, ws,
                                                        counters, err, E, P, K, N, gs, kc, splits,
                                                        st);
        case DT_BF16:
            return (int)launch_routed_gemv_rows<__nv_bfloat16>(x, sel, qweight, s, zeros, out, ws,
                                                               counters, err, E, P, K, N, gs, kc,
                                                               splits, st);
        default:   // f32 activations take routed_decode_kernel
            return (int)cudaErrorInvalidValue;
    }
}

// Blocks of the routed GEMV one SM holds at once for `dtype`, P pairs, a K chunk of kc rows and
// group size gs.
extern "C" int w4a16_routed_gemm_gemv_occupancy(int dtype, int P, int kc, int gs, int* blocks) {
    if (P <= 0 || P > 16 || kc <= 0 || gs <= 0 || blocks == nullptr)
        return (int)cudaErrorInvalidValue;
    const size_t smem = gv_smem_bytes<4>(P, kc, gs);
    auto occ = [&](auto kernel) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, GV_THREADS, smem);
    };
    const bool any = gs % 16 != 0, m8 = P <= 8;
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == DT_BF16) {
        using B = __nv_bfloat16;
        err = any ? (m8 ? occ(routed_gemv_kernel<B, 8, true>) : occ(routed_gemv_kernel<B, 16, true>))
                  : (m8 ? occ(routed_gemv_kernel<B, 8, false>)
                        : occ(routed_gemv_kernel<B, 16, false>));
    } else if (dtype == DT_F16) {
        using H = __half;
        err = any ? (m8 ? occ(routed_gemv_kernel<H, 8, true>) : occ(routed_gemv_kernel<H, 16, true>))
                  : (m8 ? occ(routed_gemv_kernel<H, 8, false>)
                        : occ(routed_gemv_kernel<H, 16, false>));
    }
    return (int)err;
}

extern "C" int w4a16_routed_gemm(const void* x, const int32_t* sel, const int32_t* qweight,
                                 const void* scales, const uint8_t* zeros, void* out,
                                 float* partial, int* err, int dtype, int E, int P, int K, int N,
                                 int gs, int kc, int splits, void* stream) {
    if (E <= 0 || P <= 0 || P > 65535 || K <= 0 || N <= 0 || K % 8 != 0 || N % 4 != 0 ||
        gs <= 0 || kc <= 0 || kc % 8 != 0 || splits <= 0 ||
        (splits > 1 && partial == nullptr) || err == nullptr)
        return (int)cudaErrorInvalidValue;
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F32:
            return (int)launch_routed<float>(x, sel, qweight, s, zeros, out, partial, err, E, P, K, N, gs, kc, splits, st);
        case DT_F16:
            return (int)launch_routed<__half>(x, sel, qweight, s, zeros, out, partial, err, E, P, K, N, gs, kc, splits, st);
        case DT_BF16:
            return (int)launch_routed<__nv_bfloat16>(x, sel, qweight, s, zeros, out, partial, err, E, P, K, N, gs, kc, splits, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* w4a16_routed_gemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
