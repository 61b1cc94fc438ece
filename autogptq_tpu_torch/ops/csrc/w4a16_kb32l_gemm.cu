// K6: w4a16 dequant-matmul over the tile-contiguous kb32l words, for Hopper (sm_90a),
//   y[M,N] = x[M,K] @ ((q - z) * s)[K,N] (+ bias),  4-bit codes (3-bit codes in nibbles),
// f32 accumulation, one cast to x's dtype (f32, f16 or bf16).
//
// Replaces the TPU kernels autogptq_tpu/ops/pallas/gemm.py:_matmul_kb32l (:635, body
// _kernel_kb32 with lin=True, :487), both regimes, and _kernel_kb32l_manual /
// _matmul_kb32l_manual (:692 / :752), the decode regime's nbuf-deep manual DMA ring. The JAX
// package reaches them through from_packed(layout="kb32l"); the port through
// from_packed(..., layout="kb32l") and from_quantized(..., layout="kb32l").
//
// Layout (kb32l_tile.cuh, built by ops/quantlinear.py:kb32l_pack):
//   qweight int32 [nbn * nbk, 32, 128]  tile (j, kb) = K rows 256*kb.., columns 128*j..,
//                                       one contiguous 16 KB span of GPTQ nibble words
//   scales  fp16  [G_pad, N_pad]        G_pad = K_pad / gs; padded rows and columns are 0
//   zeros   uint8 [G_pad, N_pad]        effective zero points
//   kperm   int64 [K] or null           desc_act: sorted row k reads x[m, kperm[k]]
// with gs in {32, 64, 128, 256}, so every tile holds whole groups (256 / gs of them).
//
// Bound on the H100 (3.35 TB/s HBM): at M <= 16 the bytes of the weight, K*N/2 B of words plus
// 3*K*N/gs B of scales and zeros: 0.0317 ms for one Llama-2-7B layer's 7 projections at g128.
//
// Design:
//  * Decode regime (M <= 16) for bf16 and f16 activations, kb32l_gemv_kernel (entry and launch
//    count w4a16_kb32l_gemm_gemv): K1's tensor-core GEMV (wna16_gemv.cuh) with the word address
//    of kb32l_tile.cuh and the scales' row stride N_pad, planned by ops/gemm.py:gemv_plan on the
//    true K and N (the tiles' padding is never read). One launch per call: the split-K combine
//    is folded into the last block of each column tile. Every kb32l group size (32, 64, 128,
//    256) is a multiple of 16, so every bf16/f16 product at M <= 16 takes it.
//  * Decode regime for f32 activations, kb32l_decode_kernel (the ring, launch count
//    w4a16_kb32l_gemm, also what kernel="simt" names at M <= 16): the grid is (column tile, K
//    split), with
//    enough splits for about two blocks per SM (ops/gemm.py:kb32l_plan). Each block streams
//    its run of tiles through a ring of NBUF = 4 shared-memory stages. A stage holds a tile's
//    words (16 KB) and its 256/gs rows of scales and zeros, filled with cp.async.cg 16-byte
//    copies, one commit group per tile; the block waits for tile i (wait_group NBUF - 1),
//    consumes it, and only then refills that stage with tile i + NBUF, as
//    _kernel_kb32l_manual does (gemm.py:728-732). Up to NBUF tiles, 64 KB and more, are in
//    flight per block while the dequant and the dot run, and no thread waits on a load of
//    its own. x[:, the block's K range], gathered through kperm, is staged once in shared
//    memory as f32 (zero past K), while the first copies fly.
//  * Warp w takes word rows 8w..8w+7 of every tile and lane l columns 4l..4l+3, so a warp
//    reads 512 contiguous bytes of the stage per word row. Codes become (q - z) by K1's
//    2^23 trick (code_minus_zero), x * (q - z) accumulates per 32 K rows in f32 and the
//    scale is folded in once there. The four warps' partial sums meet in shared memory and
//    are added in a fixed order; splits write f32 partials that K1's splitk_reduce_kernel
//    adds in a fixed order, with the bias and one cast. No float atomics: deterministic.
//  * Tile regime (M > 16): for bf16 and f16 activations K1's wgmma/TMA tile kernel
//    (wna16_wgmma.cuh, kb32l_wgmma_kernel, entry and launch count w4a16_kb32l_gemm_wgmma): the
//    words reach each stage through a 3-D tensor map of the tiles, [N_pad/128][K_pad/8][128]
//    int32 (a column tile's K tiles are contiguous), whose (128, 8, 1) box at (0, 8t, j) is the
//    same [8][128] words GPTQ's map gives for reduction tile t of column block j, so the
//    consumers' dequant is K1's; the scales and zeros [K_pad/gs, N_pad] by 2-D maps of row
//    stride N_pad; x [M, K] is zero-filled past K, where the padded word rows carry zero scales.
//    Every kb32l group size is a multiple of 32, so every unit lies in one group, and the maps
//    are N_pad wide, so it takes every N % 4 == 0 (its epilogue stores column pairs). The
//    mma.sync kernel over the kb32l address (wna16_mma.cuh, w4a16_kb32l_gemm_mma) stays
//    nameable (kernel="mma") and takes the other N; the SIMT kernel (wna16_prefill_kernel)
//    takes f32 (ops/gemm.py:kb32l_route).
// Every entry point returns cudaGetLastError() and the Python wrapper raises when it is
// non-zero.

#include "kb32l_tile.cuh"
#include "wna16_gemv.cuh"
#include "wna16_wgmma.cuh"

namespace {

constexpr int K6_THREADS = 128;     // 4 warps
constexpr int K6_NBUF = 4;          // ring stages
constexpr int K6_FOLD = 4;          // word rows (32 K rows, the least group) per scale fold
constexpr int K6_WORDS_BYTES = KB32L_TILE_WORDS * 4;

__host__ __device__ __forceinline__ int stage_bytes(int gs) {
    return K6_WORDS_BYTES + (KB32L_KB / gs) * KB32L_BN * 3;   // words, fp16 scales, u8 zeros
}

__host__ __forceinline__ size_t decode_smem(int mt, int gs, int tps) {
    return (size_t)K6_NBUF * stage_bytes(gs) + sizeof(float) * mt * tps * KB32L_KB;
}

// Copy tile (j, kb) with its scales and zeros into a stage: 1024 16-byte chunks of words,
// then gpt rows of 16 chunks of scales and gpt rows of 8 chunks of zeros.
__device__ __forceinline__ void issue_tile(unsigned char* stage, const int32_t* qweight,
                                           const __half* scales, const uint8_t* zeros, int j,
                                           int kb, int nbk, int gpt, int n_pad) {
    const int4* wsrc =
        reinterpret_cast<const int4*>(qweight + ((int64_t)j * nbk + kb) * KB32L_TILE_WORDS);
    int4* wdst = reinterpret_cast<int4*>(stage);
    for (int c = threadIdx.x; c < KB32L_TILE_WORDS / 4; c += K6_THREADS)
        cp_async16(wdst + c, wsrc + c);
    const int64_t col0 = (int64_t)j * KB32L_BN;
    const int64_t g0 = (int64_t)kb * gpt;
    for (int c = threadIdx.x; c < gpt * 24; c += K6_THREADS) {
        if (c < gpt * 16) {
            const int r = c / 16, q = c % 16;
            cp_async16(stage + K6_WORDS_BYTES + (r * KB32L_BN + q * 8) * 2,
                       scales + (g0 + r) * n_pad + col0 + q * 8);
        } else {
            const int r = (c - gpt * 16) / 8, q = (c - gpt * 16) % 8;
            cp_async16(stage + K6_WORDS_BYTES + gpt * KB32L_BN * 2 + r * KB32L_BN + q * 16,
                       zeros + (g0 + r) * n_pad + col0 + q * 16);
        }
    }
}

template <typename T, int MT>
__global__ void __launch_bounds__(K6_THREADS)
kb32l_decode_kernel(const T* __restrict__ x, const int64_t* __restrict__ kperm,
                    const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                    const uint8_t* __restrict__ zeros, const T* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ partial, int M, int K, int N,
                    int n_pad, int gs, int tps) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int gpt = KB32L_KB / gs;                 // groups per tile
    const int sbytes = stage_bytes(gs);
    const int klen = tps * KB32L_KB;               // K rows of this block's x stage
    float* xs = reinterpret_cast<float*>(smem + K6_NBUF * sbytes);   // [MT][klen]
    const int j = blockIdx.x;                      // column tile
    const int split = blockIdx.y;
    const int nbk = (K + KB32L_KB - 1) / KB32L_KB;
    const int kb0 = split * tps;
    const int ntiles = min(tps, nbk - kb0);
    const int k0 = kb0 * KB32L_KB;

    // Prologue: the first NBUF tiles in flight (one commit group each, empty past the run, so
    // that wait_group counts alike in every block), then x while they fly.
#pragma unroll
    for (int i = 0; i < K6_NBUF; ++i) {
        if (i < ntiles)
            issue_tile(smem + i * sbytes, qweight, scales, zeros, j, kb0 + i, nbk, gpt, n_pad);
        cp_async_commit();
    }
    for (int i = threadIdx.x; i < MT * klen; i += K6_THREADS) {
        const int m = i / klen;
        const int kk = i - m * klen;
        const int k = k0 + kk;
        float v = 0.0f;
        if (m < M && k < K) {
            const int64_t src = kperm != nullptr ? kperm[k] : (int64_t)k;
            v = to_f32(x[(int64_t)m * K + src]);
        }
        xs[i] = v;
    }

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

    for (int i = 0; i < ntiles; ++i) {
        cp_async_wait<K6_NBUF - 1>();   // this thread's copies of tile i have landed
        __syncthreads();                // everyone's have, and x is staged
        const unsigned char* st = smem + (i % K6_NBUF) * sbytes;
        const int32_t* wt = reinterpret_cast<const int32_t*>(st);
        const __half* ss = reinterpret_cast<const __half*>(st + K6_WORDS_BYTES);
        const uint8_t* zs = st + K6_WORDS_BYTES + gpt * KB32L_BN * 2;
#pragma unroll
        for (int f = 0; f < 8; f += K6_FOLD) {
            const int r0 = warp * 8 + f;                  // first word row of this fold
            const int g = (r0 * 8) / gs;                  // its group within the tile
            const uint2 sraw = *reinterpret_cast<const uint2*>(ss + g * KB32L_BN + 4 * lane);
            const uint32_t zraw = *reinterpret_cast<const uint32_t*>(zs + g * KB32L_BN + 4 * lane);
            const __half2 s01 = *reinterpret_cast<const __half2*>(&sraw.x);
            const __half2 s23 = *reinterpret_cast<const __half2*>(&sraw.y);
            const float s[4] = {__low2float(s01), __high2float(s01), __low2float(s23),
                                __high2float(s23)};
            float zb[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) zb[c] = MAGIC + (float)((zraw >> (8 * c)) & 0xFFu);
            float gacc[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) gacc[m][c] = 0.0f;
#pragma unroll
            for (int rr = 0; rr < K6_FOLD; ++rr) {
                const int r = r0 + rr;
                const int4 wv = *reinterpret_cast<const int4*>(wt + r * KB32L_BN + 4 * lane);
                const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z,
                                       (uint32_t)wv.w};
                const float* xk = xs + i * KB32L_KB + r * 8;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    float d[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) d[c] = code_minus_zero<4>(w[c], jj, zb[c]);
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        const float xv = xk[m * klen + jj];
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
        __syncthreads();                // every warp is done with this stage
        if (i + K6_NBUF < ntiles)
            issue_tile(smem + (i % K6_NBUF) * sbytes, qweight, scales, zeros, j,
                       kb0 + i + K6_NBUF, nbk, gpt, n_pad);
        cp_async_commit();
    }

    // The four warps' sums over their word rows meet in the ring (4 * MT * 128 floats, at
    // most 32 KB of its 64 KB and more) and are added in warp order.
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int m = 0; m < MT; ++m)
        if (m < M)
            *reinterpret_cast<float4*>(red + (warp * MT + m) * KB32L_BN + 4 * lane) =
                make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    __syncthreads();
    const int n = j * KB32L_BN + threadIdx.x;
    if (n >= N) return;
    for (int m = 0; m < M; ++m) {
        float v = red[(0 * MT + m) * KB32L_BN + threadIdx.x];
        v += red[(1 * MT + m) * KB32L_BN + threadIdx.x];
        v += red[(2 * MT + m) * KB32L_BN + threadIdx.x];
        v += red[(3 * MT + m) * KB32L_BN + threadIdx.x];
        if (partial != nullptr) {
            partial[((int64_t)split * M + m) * N + n] = v;
        } else {
            if (bias != nullptr) v += to_f32(bias[n]);
            out[(int64_t)m * N + n] = from_f32<T>(v);
        }
    }
}

template <typename T, int MT>
cudaError_t launch_kb32l_decode(const void* x, const int64_t* kperm, const int32_t* qweight,
                                const __half* scales, const uint8_t* zeros, const void* bias,
                                void* out, float* partial, int M, int K, int N, int n_pad,
                                int gs, int tps, int splits, cudaStream_t stream) {
    const size_t smem = decode_smem(MT, gs, tps);
    // function-local static: the attribute is set once per instantiation, thread-safely
    static const cudaError_t attr = cudaFuncSetAttribute(
        kb32l_decode_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(n_pad / KB32L_BN, splits);
    float* part = splits > 1 ? partial : nullptr;
    kb32l_decode_kernel<T, MT><<<grid, K6_THREADS, smem, stream>>>(
        static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
        static_cast<T*>(out), part, M, K, N, n_pad, gs, tps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const int64_t total = (int64_t)M * N;
    const unsigned blocks = (unsigned)((total + RED_THREADS - 1) / RED_THREADS);
    splitk_reduce_kernel<T><<<blocks, RED_THREADS, 0, stream>>>(
        partial, static_cast<const T*>(bias), static_cast<T*>(out), M, N, splits);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kb32l(const void* x, const int64_t* kperm, const int32_t* qweight,
                         const __half* scales, const uint8_t* zeros, const void* bias, void* out,
                         float* partial, int M, int K, int N, int n_pad, int gs, int tps,
                         int splits, cudaStream_t stream) {
#define K6_DECODE(MT)                                                                        \
    return launch_kb32l_decode<T, MT>(x, kperm, qweight, scales, zeros, bias, out, partial, M, \
                                      K, N, n_pad, gs, tps, splits, stream)
    if (M <= 1) K6_DECODE(1);
    if (M <= 2) K6_DECODE(2);
    if (M <= 4) K6_DECODE(4);
    if (M <= 8) K6_DECODE(8);
    if (M <= 16) K6_DECODE(16);
#undef K6_DECODE
    const int nbk = (K + KB32L_KB - 1) / KB32L_KB;
    const dim3 grid((N + PF_BN - 1) / PF_BN, (M + PF_BM - 1) / PF_BM);
    wna16_prefill_kernel<4, T, Kb32lWords><<<grid, PF_THREADS, 0, stream>>>(
        static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
        static_cast<T*>(out), M, K, N, gs, Kb32lWords{nbk}, n_pad, Prenorm{});
    return cudaGetLastError();
}

// The tensor-core GEMV over kb32l tiles (bf16, f16; M <= 16).
template <typename T, int MT>
__global__ void __launch_bounds__(GV_THREADS, 4)
kb32l_gemv_kernel(const T* __restrict__ x, const int64_t* __restrict__ kperm,
                  const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                  const uint8_t* __restrict__ zeros, const T* __restrict__ bias,
                  T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                  int M, int K, int N, int n_pad, int gs, int kc, int splits, int gather) {
    gemv_block<4, T, MT, Kb32lWords, false>(x, kperm, qweight, scales, zeros, bias, out, ws,
                                            counters, nullptr, nullptr, M, K, N, gs, kc, splits,
                                            gather, Kb32lWords{(K + KB32L_KB - 1) / KB32L_KB},
                                            n_pad, 1, MT);
}

template <typename T, int MT>
cudaError_t launch_kb32l_gemv(const void* x, const int64_t* kperm, const int32_t* qweight,
                              const __half* scales, const uint8_t* zeros, const void* bias,
                              void* out, float* ws, int* counters, int M, int K, int N, int n_pad,
                              int gs, int kc, int splits, cudaStream_t stream) {
    static const cudaError_t attr = allow_smem(kb32l_gemv_kernel<T, MT>, GV_SMEM_LIMIT);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((N + GV_BN - 1) / GV_BN, splits);
    kb32l_gemv_kernel<T, MT><<<grid, GV_THREADS, gv_smem_bytes<4>(MT, kc), stream>>>(
        static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
        static_cast<T*>(out), ws, counters, M, K, N, n_pad, gs, kc, splits,
        gv_gather(x, kperm, K));
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kb32l_gemv_rows(const void* x, const int64_t* kperm, const int32_t* qweight,
                                   const __half* scales, const uint8_t* zeros, const void* bias,
                                   void* out, float* ws, int* counters, int M, int K, int N,
                                   int n_pad, int gs, int kc, int splits, cudaStream_t stream) {
    if (M <= 8)
        return launch_kb32l_gemv<T, 8>(x, kperm, qweight, scales, zeros, bias, out, ws, counters,
                                       M, K, N, n_pad, gs, kc, splits, stream);
    return launch_kb32l_gemv<T, 16>(x, kperm, qweight, scales, zeros, bias, out, ws, counters, M,
                                    K, N, n_pad, gs, kc, splits, stream);
}

int mt_of(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16; }

bool valid_shape(int M, int K, int N, int n_pad, int gs) {
    return M > 0 && K > 0 && N > 0 && gs >= 32 && gs % 32 == 0 && KB32L_KB % gs == 0 &&
           K % gs == 0 && n_pad % KB32L_BN == 0 && n_pad >= N && n_pad - N < KB32L_BN &&
           (M + PF_BM - 1) / PF_BM <= 65535;
}

}  // namespace

// y = x @ dequant(W) (+ bias) over kb32l words. At M <= 16, tps tiles per K split and splits
// splits (ops/gemm.py:kb32l_plan), partial an f32 [splits, M, N] workspace when splits > 1.
extern "C" int w4a16_kb32l_gemm(const void* x, const int64_t* kperm, const int32_t* qweight,
                                const void* scales, const uint8_t* zeros, const void* bias,
                                void* out, float* partial, int dtype, int M, int K, int N,
                                int n_pad, int gs, int tps, int splits, void* stream) {
    const int nbk = (K + KB32L_KB - 1) / KB32L_KB;
    if (!valid_shape(M, K, N, n_pad, gs) ||
        (M <= 16 && (tps <= 0 || splits <= 0 || (int64_t)(splits - 1) * tps >= nbk ||
                     (int64_t)splits * tps < nbk || (splits > 1 && partial == nullptr) ||
                     decode_smem(mt_of(M), gs, tps) > 232448)))
        return (int)cudaErrorInvalidValue;
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F32:
            return (int)launch_kb32l<float>(x, kperm, qweight, s, zeros, bias, out, partial, M, K, N, n_pad, gs, tps, splits, st);
        case DT_F16:
            return (int)launch_kb32l<__half>(x, kperm, qweight, s, zeros, bias, out, partial, M, K, N, n_pad, gs, tps, splits, st);
        case DT_BF16:
            return (int)launch_kb32l<__nv_bfloat16>(x, kperm, qweight, s, zeros, bias, out, partial, M, K, N, n_pad, gs, tps, splits, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// Blocks of the decode kernel that fit on one SM at once for these operands (the occupancy
// calculator over its registers, threads and shared memory), written to *blocks.
extern "C" int w4a16_kb32l_gemm_occupancy(int dtype, int M, int gs, int tps, int* blocks) {
    if (M <= 0 || M > 16 || gs < 32 || KB32L_KB % gs != 0 || tps <= 0 || blocks == nullptr)
        return (int)cudaErrorInvalidValue;
    const size_t smem = decode_smem(mt_of(M), gs, tps);
    cudaError_t err;
#define K6_OCC(T, MT)                                                                         \
    do {                                                                                      \
        err = cudaFuncSetAttribute(kb32l_decode_kernel<T, MT>,                                \
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);      \
        if (err == cudaSuccess)                                                               \
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                              \
                blocks, kb32l_decode_kernel<T, MT>, K6_THREADS, smem);                        \
    } while (0)
#define K6_OCC_MT(T)                                                                          \
    switch (mt_of(M)) {                                                                       \
        case 1: K6_OCC(T, 1); break;                                                          \
        case 2: K6_OCC(T, 2); break;                                                          \
        case 4: K6_OCC(T, 4); break;                                                          \
        case 8: K6_OCC(T, 8); break;                                                          \
        default: K6_OCC(T, 16); break;                                                        \
    }
    switch (dtype) {
        case DT_F32: K6_OCC_MT(float); break;
        case DT_F16: K6_OCC_MT(__half); break;
        case DT_BF16: K6_OCC_MT(__nv_bfloat16); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef K6_OCC_MT
#undef K6_OCC
    return (int)err;
}

// The tensor-core GEMV over kb32l words (bf16, f16; M <= 16): kc K rows per split, splits of
// them (ops/gemm.py:gemv_plan on the true K and N), the f32 partials in ws [splits, M, N] and
// one ticket counter per 64-column tile in counters when splits > 1.
extern "C" int w4a16_kb32l_gemm_gemv(const void* x, const int64_t* kperm, const int32_t* qweight,
                                     const void* scales, const uint8_t* zeros, const void* bias,
                                     void* out, float* ws, int* counters, int dtype, int M, int K,
                                     int N, int n_pad, int gs, int kc, int splits, void* stream) {
    if (!valid_shape(M, K, N, n_pad, gs) || M > 16 || N % 4 != 0 ||
        !gv_plan_ok(K, gs, kc, splits, ws, counters) ||
        gv_smem_bytes<4>(M <= 8 ? 8 : 16, kc) > GV_SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F16:
            return (int)launch_kb32l_gemv_rows<__half>(x, kperm, qweight, s, zeros, bias, out, ws,
                                                       counters, M, K, N, n_pad, gs, kc, splits,
                                                       st);
        case DT_BF16:
            return (int)launch_kb32l_gemv_rows<__nv_bfloat16>(x, kperm, qweight, s, zeros, bias,
                                                              out, ws, counters, M, K, N, n_pad,
                                                              gs, kc, splits, st);
        default:   // f32 activations take the ring
            return (int)cudaErrorInvalidValue;
    }
}

// Blocks of the kb32l GEMV one SM holds at once for `dtype`, M rows and a K chunk of kc rows
// (gs, the group size, as K1's occupancy entry takes it: kb32l's are multiples of 32, so its
// stage never grows with it).
extern "C" int w4a16_kb32l_gemm_gemv_occupancy(int dtype, int M, int kc, int gs, int* blocks) {
    if (M <= 0 || M > 16 || kc <= 0 || gs <= 0 || gs % 16 != 0 || blocks == nullptr)
        return (int)cudaErrorInvalidValue;
    const int mt = M <= 8 ? 8 : 16;
    const size_t smem = gv_smem_bytes<4>(mt, kc);
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == DT_BF16)
        err = mt == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks, kb32l_gemv_kernel<__nv_bfloat16, 8>, GV_THREADS, smem)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks, kb32l_gemv_kernel<__nv_bfloat16, 16>, GV_THREADS, smem);
    else if (dtype == DT_F16)
        err = mt == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks, kb32l_gemv_kernel<__half, 8>, GV_THREADS, smem)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks, kb32l_gemv_kernel<__half, 16>, GV_THREADS, smem);
    return (int)err;
}

// The tensor-core tile kernel of wna16_mma.cuh over kb32l words, bf16 or f16 activations.
extern "C" int w4a16_kb32l_gemm_mma(const void* x, const int64_t* kperm, const int32_t* qweight,
                                    const void* scales, const uint8_t* zeros, const void* bias,
                                    void* out, int dtype, int M, int K, int N, int n_pad, int gs,
                                    void* stream) {
    if (!valid_shape(M, K, N, n_pad, gs) || (M + MMA_BM - 1) / MMA_BM > 65535)
        return (int)cudaErrorInvalidValue;
    const int nbk = (K + KB32L_KB - 1) / KB32L_KB;
    return launch_mma_dtype<4>(x, kperm, qweight, scales, zeros, bias, out, dtype, M, K, N, gs,
                               Kb32lWords{nbk}, n_pad, stream);
}

// The wgmma/TMA tile kernel over kb32l words (bf16, f16; M > 16): bm, stages and splits from
// ops/gemm.py:wgmma_plan, the f32 partials in ws [splits, M, N] and one ticket counter per
// output tile in counters when splits > 1; x already gathered by kperm.
extern "C" int w4a16_kb32l_gemm_wgmma(const void* x, const int32_t* qweight, const void* scales,
                                      const uint8_t* zeros, const void* bias, void* out,
                                      float* ws, int* counters, int dtype, int M, int K, int N,
                                      int n_pad, int gs, int bm, int stages, int splits,
                                      void* stream) {
    if (!valid_shape(M, K, N, n_pad, gs)) return (int)cudaErrorInvalidValue;
    return wna16_wgmma<4, false, true>(x, qweight, scales, zeros, bias, nullptr, out, ws,
                                       counters, dtype, M, K, N, gs, bm, stages, splits, stream,
                                       n_pad);
}

extern "C" const char* w4a16_kb32l_gemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
