// K7: decode attention over a paged KV cache for Hopper (sm_90a). One query token per row
// attends its positions [0, lengths[b]), position s living in page tables[b, s / ps] at slot
// s % ps of one layer of the stacked page-major pools.
//
// Replaces the TPU kernel autogptq_tpu/ops/pallas/paged_attn.py:paged_attention_mh (body
// _mh_kernel), which runs the attention of every layer of every step of paged beam search.
//
//   q          [B, H, D]             f32, f16 or bf16
//   k/v pools  [L, P, Hkv, ps, D]    q's type, or int8; read in place at `layer`
//   k/v scales [L, P, Hkv, ps]       f32, int8 pools only: value = q * s / 127.5
//   lengths    int32 [B]
//   tables     int32 [B, W]          page ids (clamped to [0, P))
//   out        f32 [B, H, D]
// Query head h attends KV head h / rep (GQA, rep = H / Hkv). Scores, softmax and the weighted
// sum are f32. A row of length 0 gets zeros, never NaN.
//
// Bound on the H100 (3.35 TB/s HBM): the K and V bytes of the live positions, 2 * len * Hkv *
// D * sizeof(T) per row (plus the scales for int8); at Llama-2-7B beam 4 with 528 live slots
// per row, 34.6 MB per layer in bf16.
//
// Design. The TPU kernel computes q[H, D] @ page[Hkv * ps, D]^T densely with a block-diagonal
// head mask, spending Hkv times the FLOPs to buy one large DMA per page, and walks the whole
// table width it is given. Neither carries over: here one block per (row, KV head) with 8
// warps keeps the rep query heads of its group in registers (D / 32 elements per lane,
// pre-multiplied by the softmax scale), reads its row's table entries itself, and walks only
// the live positions. Each warp takes 4 positions at a time: it loads 4 K and 4 V vectors
// (each a contiguous D-element slab of one page, coalesced across the warp), reduces the
// 4 x rep dot products with warp shuffles and updates a running max, denominator and weighted
// sum (online softmax). int8 scales fold into the score and into the softmax weight. The 8
// warps' partial states are merged in shared memory at the end. Splitting a row's positions
// across blocks (split-KV) is later work: at beam 4 and Hkv = 32 this launches 128 blocks on
// 132 SMs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2, DT_I8 = 3 };

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_POS = 4;          // positions per warp iteration
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// Load E consecutive elements of T and widen them to f32, with the widest aligned access.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&o)[E]) {
    constexpr int BYTES = (int)sizeof(T) * E;
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
        for (int c = 0; c < BYTES / 16; ++c) {
            const uint4 raw = *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(p) + 16 * c);
            const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int e = 0; e < 16 / (int)sizeof(T); ++e) o[c * (16 / (int)sizeof(T)) + e] = to_f32(t[e]);
        }
    } else if constexpr (BYTES == 8) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = to_f32(t[e]);
    } else if constexpr (BYTES == 4) {
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
        const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = to_f32(t[e]);
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = to_f32(p[e]);
    }
}

template <typename TQ, typename TKV, int D, int REP>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ tables, float* __restrict__ out,
                       int P, int Hkv, int ps, int W, float scale) {
    constexpr int E = D / 32;
    constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
    __shared__ float sm_m[PA_WARPS][REP];
    __shared__ float sm_l[PA_WARPS][REP];
    __shared__ float sm_acc[PA_WARPS][REP][D];

    const int b = blockIdx.x / Hkv;
    const int kvh = blockIdx.x - b * Hkv;
    const int H = Hkv * REP;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int len = min(max(lengths[b], 0), W * ps);
    const int32_t* trow = tables + (int64_t)b * W;

    float qr[REP][E];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        load_vec<TQ, E>(q + ((int64_t)b * H + kvh * REP + r) * D + lane * E, qr[r]);
#pragma unroll
        for (int e = 0; e < E; ++e) qr[r][e] *= scale;
    }
    float m[REP], l[REP], acc[REP][E];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
    }

    for (int s0 = warp * PA_POS; s0 < len; s0 += PA_WARPS * PA_POS) {
        float kv[PA_POS][E], vv[PA_POS][E];
        float ksc[PA_POS], vsc[PA_POS];
#pragma unroll
        for (int p = 0; p < PA_POS; ++p) {
            const int s = s0 + p;
            ksc[p] = vsc[p] = 1.0f;
            if (s < len) {
                const int pg = min(max(trow[s / ps], 0), P - 1);
                const int64_t slot = ((int64_t)pg * Hkv + kvh) * ps + (s % ps);
                load_vec<TKV, E>(k_pool + slot * D + lane * E, kv[p]);
                load_vec<TKV, E>(v_pool + slot * D + lane * E, vv[p]);
                if constexpr (QUANT) {
                    ksc[p] = k_scales[slot] / 127.5f;
                    vsc[p] = v_scales[slot] / 127.5f;
                }
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) kv[p][e] = vv[p][e] = 0.0f;
            }
        }
        float sc[REP][PA_POS];
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
            for (int p = 0; p < PA_POS; ++p) {
                float d = 0.0f;
#pragma unroll
                for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kv[p][e], d);
                sc[r][p] = d;
            }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int r = 0; r < REP; ++r)
#pragma unroll
                for (int p = 0; p < PA_POS; ++p)
                    sc[r][p] += __shfl_xor_sync(0xffffffffu, sc[r][p], off);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
            if constexpr (QUANT) {
#pragma unroll
                for (int p = 0; p < PA_POS; ++p) sc[r][p] *= ksc[p];
            }
            float mx = m[r];
#pragma unroll
            for (int p = 0; p < PA_POS; ++p)
                if (s0 + p < len) mx = fmaxf(mx, sc[r][p]);
            const float alpha = expf(m[r] - mx);
            float pw[PA_POS];
            float psum = 0.0f;
#pragma unroll
            for (int p = 0; p < PA_POS; ++p) {
                pw[p] = (s0 + p < len) ? expf(sc[r][p] - mx) : 0.0f;
                psum += pw[p];
                if constexpr (QUANT) pw[p] *= vsc[p];
            }
            l[r] = l[r] * alpha + psum;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                float a = acc[r][e] * alpha;
#pragma unroll
                for (int p = 0; p < PA_POS; ++p) a = fmaf(pw[p], vv[p][e], a);
                acc[r][e] = a;
            }
            m[r] = mx;
        }
    }

#pragma unroll
    for (int r = 0; r < REP; ++r) {
        if (lane == 0) {
            sm_m[warp][r] = m[r];
            sm_l[warp][r] = l[r];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < REP * D; i += PA_THREADS) {
        const int r = i / D;
        const int d = i - r * D;
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < PA_WARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
        float den = 0.0f, num = 0.0f;
#pragma unroll
        for (int w = 0; w < PA_WARPS; ++w) {
            const float f = expf(sm_m[w][r] - mx);
            den = fmaf(sm_l[w][r], f, den);
            num = fmaf(sm_acc[w][r][d], f, num);
        }
        out[((int64_t)b * H + kvh * REP + r) * D + d] = num / fmaxf(den, 1e-30f);
    }
}

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const float* ks;
    const float* vs;
    const int32_t* lengths;
    const int32_t* tables;
    float* out;
    int B, P, Hkv, ps, W;
    float scale;
    cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int REP>
cudaError_t launch4(const Args& a) {
    paged_attention_kernel<TQ, TKV, D, REP><<<a.B * a.Hkv, PA_THREADS, 0, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
        a.ks, a.vs, a.lengths, a.tables, a.out, a.P, a.Hkv, a.ps, a.W, a.scale);
    return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch3(int rep, const Args& a) {
    switch (rep) {
        case 1: return launch4<TQ, TKV, D, 1>(a);
        case 2: return launch4<TQ, TKV, D, 2>(a);
        case 4: return launch4<TQ, TKV, D, 4>(a);
        case 8:
            if constexpr (D <= 128) return launch4<TQ, TKV, D, 8>(a);
            return cudaErrorInvalidValue;
        default: return cudaErrorInvalidValue;
    }
}

template <typename TQ, typename TKV>
cudaError_t launch2(int d, int rep, const Args& a) {
    switch (d) {
        case 64: return launch3<TQ, TKV, 64>(rep, a);
        case 128: return launch3<TQ, TKV, 128>(rep, a);
        case 256: return launch3<TQ, TKV, 256>(rep, a);
        default: return cudaErrorInvalidValue;
    }
}

template <typename TQ>
cudaError_t launch1(int kv_dtype, int q_dtype, int d, int rep, const Args& a) {
    if (kv_dtype == DT_I8) return launch2<TQ, int8_t>(d, rep, a);
    if (kv_dtype == q_dtype) return launch2<TQ, TQ>(d, rep, a);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scales, const float* v_scales,
                               const int32_t* lengths, const int32_t* tables, float* out,
                               int q_dtype, int kv_dtype, int B, int L, int P, int Hkv, int ps,
                               int D, int rep, int W, int layer, float sm_scale, void* stream) {
    if (B <= 0 || L <= 0 || P <= 0 || Hkv <= 0 || ps <= 0 || W <= 0 || layer < 0 || layer >= L)
        return (int)cudaErrorInvalidValue;
    if (kv_dtype == DT_I8 && (k_scales == nullptr || v_scales == nullptr))
        return (int)cudaErrorInvalidValue;
    const int64_t layer_slots = (int64_t)layer * P * Hkv * ps;
    const int64_t elem = kv_dtype == DT_I8 ? 1 : (q_dtype == DT_F32 ? 4 : 2);
    Args a;
    a.q = q;
    a.k = static_cast<const char*>(k_pool) + layer_slots * D * elem;
    a.v = static_cast<const char*>(v_pool) + layer_slots * D * elem;
    a.ks = kv_dtype == DT_I8 ? k_scales + layer_slots : nullptr;
    a.vs = kv_dtype == DT_I8 ? v_scales + layer_slots : nullptr;
    a.lengths = lengths;
    a.tables = tables;
    a.out = out;
    a.B = B;
    a.P = P;
    a.Hkv = Hkv;
    a.ps = ps;
    a.W = W;
    a.scale = sm_scale;
    a.stream = static_cast<cudaStream_t>(stream);
    switch (q_dtype) {
        case DT_F32: return (int)launch1<float>(kv_dtype, q_dtype, D, rep, a);
        case DT_F16: return (int)launch1<__half>(kv_dtype, q_dtype, D, rep, a);
        case DT_BF16: return (int)launch1<__nv_bfloat16>(kv_dtype, q_dtype, D, rep, a);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* paged_attn_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
