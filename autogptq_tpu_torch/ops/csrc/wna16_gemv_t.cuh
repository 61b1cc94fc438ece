// K10's decode regime for Hopper (sm_90a), bf16 and f16 cotangents, M <= 16 rows, every group
// size, BITS in {2, 4, 8} (3-bit codes ride in nibbles):
//   wna16_t_gemv_kernel  dx[M,K] = g[M,N] @ ((q - z) * s)[K,N]^T
// over GPTQ words (wna16_gemm_t.cu exports it as NAME_gemv beside the SIMT K10 NAME and the
// tensor-core tile K10 NAME_mma, launch key wna16_gemm_t_gemv) and over K6's kb32l words
// (w4a16_kb32l_gemm_t_gemv). ops/gemm.py:t_route sends bf16/f16 cotangents of at most 16
// rows here; above 16 rows they take the tile K10 of wna16_mma.cuh, and f32 cotangents the SIMT K10
// of wna16_gemm_t.cuh.
//
// It replaces the small-M regime of the TPU kernels autogptq_tpu/ops/pallas/gemm.py:
// _kernel_kb32_t (:811, _matmul_kb32_t :844), _kernel_ki32_t (:1031, _matmul_ki32_t :1395) and
// _kernel_kpair_t (:1289, _matmul_kpair_t :1334), dispatched by matmul_t_pallas (:1445), the
// transposed products of the JAX custom VJP (autogptq_tpu/ops/quantlinear.py matmul_t :710).
//
// Bound on the H100 (3.35 TB/s HBM): the bytes of the weight, as the forward GEMV's; one
// Llama-2-7B layer's 7 projections at 4-bit g128 move 106 MB, 0.0317 ms; 2*M*K*N operations are
// far below the tensor cores' rate at M <= 16.
//
// Why not the tile K10: its block takes 128 rows of M (7/8 empty at M = 16) by 128 K rows and
// reduces the whole of N alone, so a 4096-row K gives 32 blocks for 132 SMs.
//
// Design:
//  * Split N: the grid is (tiles of 8 word rows, i.e. 8 * P output K rows, N splits), planned on
//    the host from shapes alone (ops/gemm.py:t_gemv_plan: about 4 blocks per SM, at most 32
//    splits, the f32 partials [splits, M, K] within a quarter of the weight's bytes). A block
//    streams its words [8 word rows, its N chunk] once, through a 4-stage cp.async ring of
//    128-column stages; the words are [K/P, N] rows, so the copies run along N and are
//    coalesced. A stage also holds g[0..MT, the stage's 128 columns] and the fp16 scales and
//    uint8 zeros of the groups the block's K rows touch (stage_groups(gs, 8 * P) rows).
//  * Tensor cores do the products, mma.sync.m16n8k16 with f32 accumulators: A is the weight,
//    16 output K rows by 16 N, B is g^T, 16 N by 8 rows of M (a second MMA for rows 8-15).
//    Lane l of a warp takes word row l / 4 of the block's 8 (A rows l/4 and l/4 + 8 are codes
//    2c and 2c + 1 of that word in MMA tile c, so the P codes of a word feed P / 2 tiles and
//    each loaded word is used whole) and the 4 adjacent N columns 4t .. 4t + 3 of a 16-column
//    step (t = l % 4): the reduction slots 2t, 2t + 1, 2t + 8, 2t + 9 stand for those columns,
//    in A and in B alike, so one 16-byte shared load gives a lane its 4 words and one 8-byte
//    load its B fragment of g. The 4 warps take alternate 16-column steps of each stage, each
//    over all the block's K rows, and add their accumulators in warp order at the end; where a
//    warp would hold more than 4 accumulator fragments (2-bit codes, 4-bit at 16 rows: registers
//    over the 128 that 4 blocks per SM leave) the warps split the codes instead, two pairs of
//    warps taking half of them each, or (2-bit at 16 rows) each warp a quarter.
//  * Precision, K10's rule (wna16_mma.cuh): the scale varies along the reduction (N), so it
//    cannot be folded in after the MMA. Each code's w = (q - z) * s is formed in f32 (exact:
//    a 9-bit integer times an fp16 scale) and goes into the MMA as a pair of the cotangent's
//    type, hi = round(w) and lo = round(w - hi), two MMAs: dx keeps about 16 significant bits
//    of the weight, as the tile K10 does (a bf16 weight rounded once moved a 32-layer LoRA run
//    off its descent: chip_mma_probe.py). This design was taken over folding the scale into B
//    per group (g * s_g as a hi/lo pair, exact q - z in A) because the group is then looked up
//    per code (a bit per code marks where a group starts in the lane's word, fixed for the
//    block), so every group size takes the same code, with no masking, where the B-side fold
//    needs 16 | gs (16 K rows of one group per MMA).
//  * One launch per call: each split writes its f32 partial [M, its K rows] into the persistent
//    workspace (ops/build.py:split_scratch), fences and takes a ticket from its K tile's counter;
//    the block that draws the last ticket adds the partials in split order (bit-equal from call
//    to call), casts once, stores through kperm (a permutation: a plain store, no atomics) and
//    sets the counter back to 0. One split stores dx itself.
// Every entry point returns cudaGetLastError() and the Python wrapper raises when it is
// non-zero.

#pragma once

#include "wna16_gemv.cuh"

namespace {

constexpr int TG_WARPS = 4;
constexpr int TG_THREADS = 32 * TG_WARPS;
constexpr int TG_WROWS = 8;              // word rows per block: one per MMA row group g8
constexpr int TG_BN = 128;               // N (the reduction) per stage: 8 steps of 16
constexpr int TG_LDW = TG_BN + 16;       // words per staged word row: 16 mod 32 banks
constexpr int TG_LDG = TG_BN + 16;       // halves per staged row of g: 8 mod 32 banks
constexpr int TG_STAGES = 4;

// Parts the warps split a word's codes into (see the design note): a warp holds at most 4
// accumulator fragments.
template <int BITS, int MT>
__host__ __device__ constexpr int tg_code_split() {
    return (32 / BITS / 2) * (MT / 8) > 4 ? (32 / BITS / 2) * (MT / 8) / 4 : 1;
}

// hi = round(a), lo = round(a - hi) of two values, packed as one operand register each (the
// scaled weight as a pair of the cotangent's type).
template <typename T>
__device__ __forceinline__ void hi_lo(float a, float b, uint32_t& hi, uint32_t& lo) {
    hi = Mma<T>::pack(a, b);
    const float2 h = Mma<T>::unpack(hi);
    lo = Mma<T>::pack(a - h.x, b - h.y);
}

template <int BITS> struct TgStage {     // byte offsets within one stage of MT rows of g
    static constexpr int P = 32 / BITS;
    static constexpr int KT = TG_WROWS * P;                      // output K rows per block
    static constexpr int W = 0;                                  // i32 [TG_WROWS][TG_LDW]
    static constexpr int G = W + TG_WROWS * TG_LDW * 4;          // T   [MT][TG_LDG]
    static __host__ __device__ constexpr int s_at(int mt) { return G + mt * TG_LDG * 2; }
    static __host__ __device__ constexpr int z_at(int mt, int ng) {   // after f16 [ng][TG_BN]
        return s_at(mt) + ng * TG_BN * 2;
    }
    static __host__ __device__ constexpr int bytes(int mt, int ng) {  // after u8 [ng][TG_BN]
        return (z_at(mt, ng) + ng * TG_BN + 15) / 16 * 16;
    }
    static constexpr int LDR = KT + 4;                           // the warps' partials [4][MT][LDR]
};

// Dynamic shared memory of a block: the ring, whose space the warps' partials take at the end.
template <int BITS>
__host__ __device__ constexpr int tg_smem_bytes(int mt, int gs) {
    using L = TgStage<BITS>;
    const int ring = TG_STAGES * L::bytes(mt, stage_groups(gs, L::KT));
    const int red = TG_WARPS * mt * L::LDR * 4;
    return ring > red ? ring : red;
}

template <int BITS, typename T, int MT, typename Words>
__global__ void __launch_bounds__(TG_THREADS, 4)
wna16_t_gemv_kernel(const T* __restrict__ g, const int64_t* __restrict__ kperm,
                    const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                    const uint8_t* __restrict__ zeros, T* __restrict__ dx, float* __restrict__ ws,
                    int* __restrict__ counters, int M, int K, int N, int gs, int nc, int splits,
                    int gather, Words words, int ldsz) {
    using L = TgStage<BITS>;
    constexpr int P = L::P;
    constexpr int KT = L::KT;
    constexpr int NT = MT / 8;               // MMAs per A fragment: rows 0-7, 8-15 of M
    constexpr int LDR = L::LDR;
    constexpr int CS = tg_code_split<BITS, MT>();
    constexpr int NW = TG_WARPS / CS;        // warps per code part, over alternate steps
    constexpr int TILES = P / 2 / CS;        // MMA tiles (code pairs) per warp
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int last_block;
    const int soff = L::s_at(MT);
    const int zoff = L::z_at(MT, stage_groups(gs, KT));
    const int sbytes = L::bytes(MT, stage_groups(gs, KT));
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int j0 = 2 * TILES * (warp / NW);  // the warp's first code
    const int kt0 = blockIdx.x * KT;         // the block's first output (sorted) K row
    const int kw0 = kt0 / P;                 // its first word row
    const int split = blockIdx.y;
    const int n0 = split * nc;
    const int n1 = min(N, n0 + nc);
    const int G = (K + gs - 1) / gs;
    const int kwords = K / P;
    const int g_lo = kt0 / gs;               // the block's first group
    const int ng = min(G - 1, (min(kt0 + KT, K) - 1) / gs) - g_lo + 1;   // the groups it touches
    const int ntiles = (n1 - n0 + TG_BN - 1) / TG_BN;

    // N columns nt .. nt + TG_BN of the block's words, g, scales and zeros into stage st
    // (columns past the split's end zero-filled; rows of g past M zero).
    auto fetch = [&](int tile, unsigned char* st) {
        const int nt = n0 + tile * TG_BN;
        int32_t* wsm = reinterpret_cast<int32_t*>(st + L::W);
        for (int c = tid; c < TG_WROWS * (TG_BN / 4); c += TG_THREADS) {
            const int r = c / (TG_BN / 4), q = c % (TG_BN / 4);
            const int kw = kw0 + r, n = nt + 4 * q;
            const bool ok = kw < kwords && n < n1;   // N % 4 == 0, nc % TG_BN == 0
            cp_async16_zfill(wsm + r * TG_LDW + 4 * q, ok ? qweight + words(kw, n) : qweight, ok);
        }
        T* gsm = reinterpret_cast<T*>(st + L::G);
        if (!gather) {                               // N % 8 == 0, g 16-byte aligned
            for (int c = tid; c < MT * (TG_BN / 8); c += TG_THREADS) {
                const int m = c / (TG_BN / 8), q = c % (TG_BN / 8);
                const int n = nt + 8 * q;
                const bool ok = m < M && n < n1;
                cp_async16_zfill(gsm + m * TG_LDG + 8 * q, ok ? g + (int64_t)m * N + n : g, ok);
            }
        } else {
            for (int i = tid; i < MT * TG_BN; i += TG_THREADS) {
                const int m = i / TG_BN, nn = i % TG_BN, n = nt + nn;
                gsm[m * TG_LDG + nn] = m < M && n < n1 ? g[(int64_t)m * N + n] : from_f32<T>(0.0f);
            }
        }
        __half* ss = reinterpret_cast<__half*>(st + soff);
        uint8_t* zs = st + zoff;
        for (int c = tid; c < ng * (TG_BN / 2 + TG_BN / 4); c += TG_THREADS) {
            if (c < ng * (TG_BN / 2)) {              // scales, 2 columns per copy
                const int r = c / (TG_BN / 2), q = c % (TG_BN / 2);
                const int n = nt + 2 * q;
                const bool ok = n < n1;
                cp_async4_zfill(ss + r * TG_BN + 2 * q,
                                ok ? scales + (int64_t)(g_lo + r) * ldsz + n : scales, ok);
            } else {                                 // zeros, 4 columns per copy
                const int c2 = c - ng * (TG_BN / 2);
                const int r = c2 / (TG_BN / 4), q = c2 % (TG_BN / 4);
                const int n = nt + 4 * q;
                const bool ok = n < n1;
                cp_async4_zfill(zs + r * TG_BN + 4 * q,
                                ok ? zeros + (int64_t)(g_lo + r) * ldsz + n : zeros, ok);
            }
        }
    };

#pragma unroll
    for (int s = 0; s < TG_STAGES - 1; ++s) {
        if (s < ntiles) fetch(s, smem + s * sbytes);
        cp_async_commit();   // one group per stage, empty past the end: wait counts alike
    }

    const int g8 = lane >> 2;                // the lane's word row: A rows g8 and g8 + 8
    const int t = lane & 3;                  // its columns 4t .. 4t + 3 of a 16-column step
    // The groups of the lane's codes: code j is K row kr + j (rows past K take K - 1's group,
    // so every scale read is a staged one); bit j of `starts` marks a code that starts a group.
    const int kr = kt0 + g8 * P;
    unsigned starts = 0;
#pragma unroll
    for (int j = 1; j < P; ++j)
        if (kr + j < K && (kr + j) % gs == 0) starts |= 1u << j;
    // the group of the warp's first code j0
    const int grow0 = min(kr, K - 1) / gs - g_lo + __popc(starts & ((2u << j0) - 1u));

    float acc[TILES][NT][4];
#pragma unroll
    for (int c = 0; c < TILES; ++c)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.0f;

    for (int tile = 0; tile < ntiles; ++tile) {
        cp_async_wait<TG_STAGES - 2>();      // this thread's copies of the tile have landed
        __syncthreads();                     // everyone's have, the previous stage is free
        const int nxt = tile + TG_STAGES - 1;
        if (nxt < ntiles) fetch(nxt, smem + (nxt % TG_STAGES) * sbytes);
        cp_async_commit();

        const unsigned char* st = smem + (tile % TG_STAGES) * sbytes;
        const uint32_t* wsm = reinterpret_cast<const uint32_t*>(st + L::W) + g8 * TG_LDW + 4 * t;
        const T* gsm = reinterpret_cast<const T*>(st + L::G) + g8 * TG_LDG + 4 * t;
        const __half* ss = reinterpret_cast<const __half*>(st + soff) + 4 * t;
        const uint8_t* zs = st + zoff + 4 * t;
#pragma unroll
        for (int h = 0; h < TG_BN / 16 / NW; ++h) {
            const int c16 = 16 * (warp % NW + NW * h);       // the warp's step in the stage
            const uint4 wv = *reinterpret_cast<const uint4*>(wsm + c16);
            const uint32_t w[4] = {wv.x, wv.y, wv.z, wv.w};
            uint32_t b[NT][2];                   // g^T: slots 2t, 2t+1 | 2t+8, 2t+9 of row g8
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const uint2 bv = *reinterpret_cast<const uint2*>(gsm + 8 * j * TG_LDG + c16);
                b[j][0] = bv.x;
                b[j][1] = bv.y;
            }
            int grow = grow0;
            float s[4], zb[4];                   // the group's scales and 2^23 + zeros
            auto group = [&]() {
                const uint2 sv = *reinterpret_cast<const uint2*>(ss + grow * TG_BN + c16);
                const float2 s01 = __half22float2(*reinterpret_cast<const __half2*>(&sv.x));
                const float2 s23 = __half22float2(*reinterpret_cast<const __half2*>(&sv.y));
                s[0] = s01.x;
                s[1] = s01.y;
                s[2] = s23.x;
                s[3] = s23.y;
                const uint32_t z4 = *reinterpret_cast<const uint32_t*>(zs + grow * TG_BN + c16);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    zb[e] = __uint_as_float(__byte_perm(z4, 0x4B000000u, 0x7440 + e));
            };
            group();
#pragma unroll
            for (int c = 0; c < TILES; ++c) {    // codes j0 + 2c (A row g8), j0 + 2c + 1 (g8 + 8)
                float v[2][4];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = j0 + 2 * c + e;
                    if (c + e > 0 && ((starts >> j) & 1u)) {   // code j starts the next group
                        ++grow;
                        group();
                    }
#pragma unroll
                    for (int col = 0; col < 4; ++col)
                        v[e][col] = code_minus_zero<BITS>(w[col], j, zb[col]) * s[col];
                }
                uint32_t hi[4], lo[4];           // a0 / a2: row g8, a1 / a3: row g8 + 8
                hi_lo<T>(v[0][0], v[0][1], hi[0], lo[0]);
                hi_lo<T>(v[1][0], v[1][1], hi[1], lo[1]);
                hi_lo<T>(v[0][2], v[0][3], hi[2], lo[2]);
                hi_lo<T>(v[1][2], v[1][3], hi[3], lo[3]);
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    Mma<T>::run(acc[c][j], hi, b[j][0], b[j][1]);
                    Mma<T>::run(acc[c][j], lo, b[j][0], b[j][1]);
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();                         // every warp is done with the ring

    // acc[c][j]: K rows g8 * P + j0 + 2c (fragment 0, 1) and + 1 (2, 3) of rows 8j + 2t (0, 2)
    // and 8j + 2t + 1 (1, 3) of M; the warps' partials in shared memory, then added in order
    float* red = reinterpret_cast<float*>(smem);   // [TG_WARPS][MT][LDR]
#pragma unroll
    for (int c = 0; c < TILES; ++c)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int m = 8 * j + 2 * t, kl = g8 * P + j0 + 2 * c;
            float* r = red + (warp * MT + m) * LDR + kl;
            *reinterpret_cast<float2*>(r) = make_float2(acc[c][j][0], acc[c][j][2]);
            *reinterpret_cast<float2*>(r + LDR) = make_float2(acc[c][j][1], acc[c][j][3]);
        }
    __syncthreads();
    auto store = [&](int m, int k, float v) {    // dx column kperm[k] takes sorted row k
        dx[(int64_t)m * K + (kperm != nullptr ? kperm[k] : (int64_t)k)] = from_f32<T>(v);
    };
    for (int i = tid; i < M * KT; i += TG_THREADS) {
        const int m = i / KT, kl = i % KT, k = kt0 + kl;
        if (k >= K) continue;
        const int w0 = (kl % P) / (2 * TILES) * NW;   // the warps of the row's code part
        float v = 0.0f;
#pragma unroll
        for (int w = w0; w < w0 + NW; ++w) v += red[(w * MT + m) * LDR + kl];
        if (splits == 1)
            store(m, k, v);
        else
            ws[((int64_t)split * M + m) * K + k] = v;
    }
    if (splits == 1) return;
    // The ticket, as the forward GEMV's (wna16_gemv.cuh): the barrier orders every thread's
    // partial before thread 0's acquire-release add, which for the last block also makes the
    // other splits' partials visible to the reads after the next barrier.
    __syncthreads();
    int* ticket_ctr = counters + blockIdx.x;
    if (tid == 0) {
        int ticket;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(ticket) : "l"(ticket_ctr) : "memory");
        last_block = ticket == splits - 1;
        if (last_block) *ticket_ctr = 0;         // every split of the tile has its ticket
    }
    __syncthreads();
    if (!last_block) return;
    const int64_t stride = (int64_t)M * K;       // the partials of the K tile in split order
    for (int i = tid; i < M * KT; i += TG_THREADS) {
        const int m = i / KT, k = kt0 + i % KT;
        if (k >= K) continue;
        const float* p = ws + (int64_t)m * K + k;
        float v = 0.0f;
        for (int s = 0; s < splits; ++s) v += __ldcg(p + s * stride);
        store(m, k, v);
    }
}

// The plan's checks: nc N columns per split (whole stages), splits of them cover N once.
inline bool tg_plan_ok(int N, int nc, int splits, const float* ws, const int* counters) {
    return nc > 0 && nc % TG_BN == 0 && splits > 0 && splits <= GV_MAX_SPLITS &&
           (int64_t)(splits - 1) * nc < N && (int64_t)splits * nc >= N &&
           (splits == 1 || (ws != nullptr && counters != nullptr));
}

template <int BITS, typename T, int MT, typename Words>
cudaError_t launch_t_gemv(const void* g, const int64_t* kperm, const int32_t* qweight,
                          const __half* scales, const uint8_t* zeros, void* dx, float* ws,
                          int* counters, int M, int K, int N, int gs, int nc, int splits,
                          Words words, int ldsz, cudaStream_t stream) {
    static const cudaError_t attr = allow_smem(wna16_t_gemv_kernel<BITS, T, MT, Words>,
                                               GV_SMEM_LIMIT);
    if (attr != cudaSuccess) return attr;
    const int gather = N % 8 != 0 || (reinterpret_cast<uintptr_t>(g) & 15) != 0;
    const dim3 grid((K + TgStage<BITS>::KT - 1) / TgStage<BITS>::KT, splits);
    wna16_t_gemv_kernel<BITS, T, MT, Words><<<grid, TG_THREADS, tg_smem_bytes<BITS>(MT, gs),
                                              stream>>>(
        static_cast<const T*>(g), kperm, qweight, scales, zeros, static_cast<T*>(dx), ws,
        counters, M, K, N, gs, nc, splits, gather, words, ldsz);
    return cudaGetLastError();
}

template <int BITS, typename Words>
int launch_t_gemv_dtype(const void* g, const int64_t* kperm, const int32_t* qweight,
                        const void* scales, const uint8_t* zeros, void* dx, float* ws,
                        int* counters, int dtype, int M, int K, int N, int gs, int nc, int splits,
                        Words words, int ldsz, void* stream) {
    constexpr int P = 32 / BITS;
    if (M <= 0 || M > 16 || K <= 0 || N <= 0 || K % P != 0 || N % 4 != 0 || gs <= 0 ||
        !tg_plan_ok(N, nc, splits, ws, counters) ||
        tg_smem_bytes<BITS>(M <= 8 ? 8 : 16, gs) > GV_SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F16:
            return M <= 8 ? (int)launch_t_gemv<BITS, __half, 8>(g, kperm, qweight, s, zeros, dx,
                                                               ws, counters, M, K, N, gs, nc,
                                                               splits, words, ldsz, st)
                          : (int)launch_t_gemv<BITS, __half, 16>(g, kperm, qweight, s, zeros, dx,
                                                                ws, counters, M, K, N, gs, nc,
                                                                splits, words, ldsz, st);
        case DT_BF16:
            return M <= 8 ? (int)launch_t_gemv<BITS, __nv_bfloat16, 8>(
                                g, kperm, qweight, s, zeros, dx, ws, counters, M, K, N, gs, nc,
                                splits, words, ldsz, st)
                          : (int)launch_t_gemv<BITS, __nv_bfloat16, 16>(
                                g, kperm, qweight, s, zeros, dx, ws, counters, M, K, N, gs, nc,
                                splits, words, ldsz, st);
        default:   // f32 cotangents take the SIMT K10
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace
