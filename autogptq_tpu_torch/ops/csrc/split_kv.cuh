// Split-KV decode attention for Hopper (sm_90a): the pieces K2 (flash_decode.cu, contiguous
// cache) and K7 (paged_attn.cu, paged pools) share. Each kernel computes, for one query token
// per row and one KV head per block row, f32 softmax attention over a span of cache positions.
//
// Plan (chosen on the host from shapes alone: ops/flash_decode.py:split_plan,
// ops/paged_attn.py:split_plan). A row's positions [0, S) are cut into n_split chunks of C
// positions, C a multiple of CHUNK_UNIT (and, for K7, of the page size). The grid is
// (B * Hkv, n_split): block (bh, c) attends the live positions of chunk c, [c * C, (c + 1) * C)
// intersected with the row's live range, which only the card reads. Every block works out
// from that range which chunks hold live positions; a block of any other chunk loads and
// writes nothing and exits at once (an empty partial, m = -1e30 and l = 0, would add exact
// zeros to the merge). A row with nothing to attend is one empty chunk that writes zeros.
//
// Block. WARPS = 4 warps keep the rep query heads of the KV head in registers, D / 32 elements
// per lane, pre-multiplied by the softmax scale. Each warp takes batches of PB consecutive
// positions (8; 4 for the widest slices, batch_positions) interleaved across the warps, and
// issues the K and V loads of all PB positions (one contiguous D-vector each, coalesced across
// the warp, streaming: evict first; for D = 128 a lane loads 4 elements, 8 bytes in bf16)
// before its first FMA. Then per query head: the PB dot products reduced by warp shuffles, one
// online-softmax update of the running max m, denominator l and weighted sum acc. The warps'
// states merge in shared memory in warp order. Instances with small slices (rep * D <= 128)
// are held to 5 blocks per SM of registers (min_blocks), so the main paths' grids run in one
// wave.
//
// Combine, in the same launch, over the row's n_live live chunks. With n_live == 1 the block
// writes out = acc / l. Otherwise it writes its f32 partial (acc[rep][D], m, l) to the
// workspace [B * Hkv, n_split, rep, D + 2] at its index among the live chunks, fences, and
// takes a ticket from the (row, KV head)'s counter with atomicAdd. The block that draws the
// last ticket reads the n_live (<= n_split <= MAX_SPLITS) partials through L2 (__ldcg, after
// a fence): their maxima and denominators staged in shared memory with one load each, the
// sums with 32 loads in flight per thread. It merges them in split order (so results are
// bit-identical from run to run), writes out and sets the counter back to 0 for the next
// launch. The workspace and counters are the wrapper's persistent per-device buffers
// (ops/build.py:split_scratch); two launches sharing them must not overlap, which one stream
// guarantees.
//
// Bound: the bytes of the live K and V (plus the scales and page ids for K7): about rep FLOP
// per byte, far below the 295 the H100 needs before its tensor cores limit, so the design is
// about bytes in flight and filling the 132 SMs, not about tensor cores. On an H100 a call
// costs 8-10 us at a short window, 5.6 of them the launch as CUDA events see it (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace splitkv {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK_UNIT = WARPS * 8;     // a chunk is a whole number of the warps' batches
constexpr int MAX_SPLITS = 32;            // chunks per row at most: the last block's merge
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Positions a warp loads before its first FMA: 8, or 4 where a lane's slice of a vector is 32
// bytes (f32, D = 256) or its query and sum slices already take 64 registers (rep * D = 1024),
// which keeps every instance free of spills.
template <typename T, int E, int REP>
__host__ __device__ constexpr int batch_positions() {
    return ((int)sizeof(T) * E >= 32 || REP * E >= 32) ? 4 : 8;
}

// Blocks per SM the register budget is set for: 5 where a lane's query and sum slices are
// small (rep * D <= 128), so that the main paths' 544-640 blocks run in one wave on 132 SMs.
template <int REP, int E>
__host__ __device__ constexpr int min_blocks() {
    return REP * E <= 4 ? 5 : 1;
}

// E consecutive elements of T, kept packed in 32-bit words until they are used.
template <typename T, int E>
struct Packed {
    static constexpr int BYTES = (int)sizeof(T) * E;
    static constexpr int WORDS = (BYTES + 3) / 4;
    uint32_t w[WORDS];
};

// Streaming loads (evict first): each K/V byte is read once per launch.
template <typename T, int E>
__device__ __forceinline__ void load_packed(const T* __restrict__ p, Packed<T, E>& o) {
    constexpr int BYTES = Packed<T, E>::BYTES;
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
        for (int c = 0; c < BYTES / 16; ++c) {
            const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + c);
            o.w[4 * c] = v.x;
            o.w[4 * c + 1] = v.y;
            o.w[4 * c + 2] = v.z;
            o.w[4 * c + 3] = v.w;
        }
    } else if constexpr (BYTES == 8) {
        const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
        o.w[0] = v.x;
        o.w[1] = v.y;
    } else if constexpr (BYTES == 4) {
        o.w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
    } else {
        static_assert(BYTES == 2, "a lane's slice is 2 to 32 bytes");
        o.w[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
    }
}

template <typename T, int E>
__device__ __forceinline__ void zero_packed(Packed<T, E>& o) {
#pragma unroll
    for (int i = 0; i < Packed<T, E>::WORDS; ++i) o.w[i] = 0u;
}

// Element e of a packed slice, widened to f32 (int8: the code itself).
template <typename T, int E>
__device__ __forceinline__ float elem(const Packed<T, E>& v, int e) {
    if constexpr (std::is_same<T, float>::value) {
        return __uint_as_float(v.w[e]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const uint32_t x = v.w[e >> 1];
        return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
    } else if constexpr (std::is_same<T, __half>::value) {
        const uint32_t x = v.w[e >> 1];
        const unsigned short h = (unsigned short)((e & 1) ? (x >> 16) : (x & 0xffffu));
        return __half2float(__ushort_as_half(h));
    } else {
        static_assert(std::is_same<T, int8_t>::value, "f32, f16, bf16 or int8");
        return (float)(int8_t)((v.w[e >> 2] >> (8 * (e & 3))) & 0xffu);
    }
}

// The REP query vectors at `q_heads` (the query heads of one KV head), times `scale`; the lane
// holds elements [lane * E, lane * E + E) of each.
template <typename T, int E, int REP>
__device__ __forceinline__ void load_queries(const T* __restrict__ q_heads, int lane, float scale,
                                             float (&qr)[REP][E]) {
    constexpr int D = 32 * E;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        Packed<T, E> v;
        load_packed<T, E>(q_heads + r * D + lane * E, v);
#pragma unroll
        for (int e = 0; e < E; ++e) qr[r][e] = elem<T, E>(v, e) * scale;
    }
}

// Running state of one warp: max, denominator and weighted sum per query head.
template <int REP, int E>
struct WarpState {
    float m[REP], l[REP], acc[REP][E];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int r = 0; r < REP; ++r) {
            m[r] = NEG_INF;
            l[r] = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
        }
    }
};

// One online-softmax update over a batch of PB loaded positions; bit p of `valid` says that
// position p is live. QUANT folds the int8 scales into the score (ksc) and the weight (vsc).
template <typename T, int E, int REP, int PB, bool QUANT>
__device__ __forceinline__ void attend_batch(const float (&qr)[REP][E],
                                             const Packed<T, E> (&kv)[PB],
                                             const Packed<T, E> (&vv)[PB],
                                             const float (&ksc)[PB], const float (&vsc)[PB],
                                             unsigned valid, WarpState<REP, E>& st) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        float sc[PB];
#pragma unroll
        for (int p = 0; p < PB; ++p) {
            float d = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], elem<T, E>(kv[p], e), d);
            sc[p] = d;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int p = 0; p < PB; ++p) sc[p] += __shfl_xor_sync(FULL, sc[p], off);
        float mx = st.m[r];
#pragma unroll
        for (int p = 0; p < PB; ++p) {
            if constexpr (QUANT) sc[p] *= ksc[p];
            if ((valid >> p) & 1u) mx = fmaxf(mx, sc[p]);
        }
        const float alpha = expf(st.m[r] - mx);
        float pw[PB];
        float psum = 0.0f;
#pragma unroll
        for (int p = 0; p < PB; ++p) {
            pw[p] = ((valid >> p) & 1u) ? expf(sc[p] - mx) : 0.0f;
            psum += pw[p];
            if constexpr (QUANT) pw[p] *= vsc[p];
        }
        st.l[r] = st.l[r] * alpha + psum;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            float a = st.acc[r][e] * alpha;
#pragma unroll
            for (int p = 0; p < PB; ++p) a = fmaf(pw[p], elem<T, E>(vv[p], e), a);
            st.acc[r][e] = a;
        }
        st.m[r] = mx;
    }
}

template <int REP, int D>
struct Shared {
    float m[WARPS][REP];
    float l[WARPS][REP];
    float acc[WARPS][REP][D];
    float pm[MAX_SPLITS][REP];     // the last block's view of the partials: max, then weight
    float pl[MAX_SPLITS][REP];
    float den[REP];
    int last;
};

// Merge the warps' states; write `out` ([REP][D] of this row and KV head) directly when the
// row has one live chunk, else this chunk's partial into `ws` ([n_live][REP][D + 2] of this
// row and KV head, at index `split` among the live chunks) and, in the block that takes the
// last ticket of `counter`, the merge of all partials in split order.
template <int REP, int D>
__device__ __forceinline__ void finish(Shared<REP, D>& sm, const WarpState<REP, D / 32>& st,
                                       float* __restrict__ out, float* __restrict__ ws,
                                       int* __restrict__ counter, int split, int n_live) {
    constexpr int E = D / 32;
    constexpr int STRIDE = REP * (D + 2);      // floats of one split's partial
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        if (lane == 0) {
            sm.m[warp][r] = st.m[r];
            sm.l[warp][r] = st.l[r];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) sm.acc[warp][r][lane * E + e] = st.acc[r][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < REP * D; i += THREADS) {
        const int r = i / D;
        const int d = i - r * D;
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm.m[w][r]);
        float den = 0.0f, num = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float f = expf(sm.m[w][r] - mx);
            den = fmaf(sm.l[w][r], f, den);
            num = fmaf(sm.acc[w][r][d], f, num);
        }
        if (n_live == 1) {
            out[i] = num / fmaxf(den, 1e-30f);
        } else {
            float* p = ws + (int64_t)split * STRIDE + r * (D + 2);
            p[d] = num;
            if (d == 0) {
                p[D] = mx;
                p[D + 1] = den;
            }
        }
    }
    if (n_live == 1) return;
    __threadfence();                 // this block's partial is visible before its ticket
    __syncthreads();
    if (threadIdx.x == 0) {
        const int ticket = atomicAdd(counter, 1);
        sm.last = ticket == n_live - 1;
        if (sm.last) *counter = 0;   // every block of this (row, KV head) has taken its ticket
        __threadfence();
    }
    __syncthreads();
    if (!sm.last) return;
    // Every partial's (m, l), one load each, all in flight; then per query head the max, the
    // partials' weights exp(m - max) (in place of m) and the denominator.
    for (int t = threadIdx.x; t < n_live * REP; t += THREADS) {
        const int c = t / REP;
        const int r = t - c * REP;
        const float* pc = ws + (int64_t)c * STRIDE + r * (D + 2);
        sm.pm[c][r] = __ldcg(pc + D);
        sm.pl[c][r] = __ldcg(pc + D + 1);
    }
    __syncthreads();
    if (threadIdx.x < REP) {
        const int r = threadIdx.x;
        float mx = NEG_INF;
        for (int c = 0; c < n_live; ++c) mx = fmaxf(mx, sm.pm[c][r]);
        float den = 0.0f;
        for (int c = 0; c < n_live; ++c) {
            const float f = expf(sm.pm[c][r] - mx);
            sm.pm[c][r] = f;
            den = fmaf(sm.pl[c][r], f, den);
        }
        sm.den[r] = den;
    }
    __syncthreads();
    // The weighted sums, in split order; each thread keeps ELEMS * GROUP loads in flight.
    constexpr int ELEMS = (REP * D + THREADS - 1) / THREADS;
    constexpr int GROUP = 32 / ELEMS;
    float num[ELEMS];
#pragma unroll
    for (int k = 0; k < ELEMS; ++k) num[k] = 0.0f;
    for (int c0 = 0; c0 < n_live; c0 += GROUP) {
        float pa[ELEMS][GROUP];
#pragma unroll
        for (int k = 0; k < ELEMS; ++k) {
            const int i = min((int)threadIdx.x + k * THREADS, REP * D - 1);
            const float* p = ws + (i / D) * (D + 2) + i % D;
#pragma unroll
            for (int j = 0; j < GROUP; ++j)
                pa[k][j] = __ldcg(p + (int64_t)min(c0 + j, n_live - 1) * STRIDE);
        }
#pragma unroll
        for (int k = 0; k < ELEMS; ++k) {
            const int r = min((int)threadIdx.x + k * THREADS, REP * D - 1) / D;
#pragma unroll
            for (int j = 0; j < GROUP; ++j)
                if (c0 + j < n_live) num[k] = fmaf(pa[k][j], sm.pm[c0 + j][r], num[k]);
        }
    }
#pragma unroll
    for (int k = 0; k < ELEMS; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < REP * D) out[i] = num[k] / fmaxf(sm.den[i / D], 1e-30f);
    }
}

}  // namespace splitkv
