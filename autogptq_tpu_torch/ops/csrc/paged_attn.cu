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
// table width it is given along a sequential grid axis. None of that carries over: here a
// row's positions [0, W * ps) are cut into n_split chunks of `chunk` positions, a whole number
// of pages (plan from the shapes alone: ops/paged_attn.py:split_plan), that run in parallel,
// grid (B * Hkv, n_split), and the block drawing a (row, KV head)'s last ticket merges the
// chunks' partials in the same launch (split_kv.cuh). A block reads only the live positions
// [0, lengths[b]) of its chunk. A warp's batch of 8 positions reads each page id it touches
// once (lane i reads the batch's i-th page id, shuffled to its positions), then issues all
// its K and V loads (each a contiguous D-element slab of one page, coalesced across the
// warp) and, for int8 pools, the per-position scales, before its first FMA; the scales fold
// into the score and into the softmax weight, times the f32 reciprocal of 127.5 (within an
// ulp of the plain version's division). At beam 4 and Hkv = 32 with 40-page tables of 16
// slots: 5 chunks of 128 positions, 640 blocks of 4 warps (the unsplit kernel ran 128).

#include "split_kv.cuh"

namespace {

using namespace splitkv;

enum DType { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2, DT_I8 = 3 };

template <typename TQ, typename TKV, int D, int REP>
__global__ void __launch_bounds__(THREADS, (min_blocks<REP, D / 32>()))
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ tables, float* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters, int P, int Hkv,
                       int ps, int W, float scale, int chunk, int n_split) {
    constexpr int E = D / 32;
    constexpr int PB = batch_positions<TKV, E, REP>();
    constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
    __shared__ Shared<REP, D> sm;

    const int bh = blockIdx.x;
    const int split = blockIdx.y;
    const int b = bh / Hkv;
    const int kvh = bh - b * Hkv;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int len = min(max(lengths[b], 0), W * ps);
    // The row's live chunks [0, n_live): the others exit at once. A row of length 0 is one
    // (empty) chunk, 0, which writes its zeros.
    const int n_live = len > 0 ? (len - 1) / chunk + 1 : 1;
    if (split >= n_live) return;
    const int c0 = split * chunk;
    const int s_hi = min(len, c0 + chunk);
    const int32_t* trow = tables + (int64_t)b * W;

    float qr[REP][E];
    if (c0 < s_hi)   // a chunk with no live position loads nothing
        load_queries<TQ, E, REP>(q + ((int64_t)b * Hkv + kvh) * REP * D, lane, scale, qr);
    WarpState<REP, E> st;
    st.init();

    for (int s0 = c0 + warp * PB; s0 < s_hi; s0 += WARPS * PB) {
        // lane i < PB reads the id of the i-th page the batch touches
        const int pg0 = s0 / ps;
        int my_pg = 0;
        if (lane < PB && (pg0 + lane) * ps < s_hi)
            my_pg = min(max(__ldg(trow + pg0 + lane), 0), P - 1);
        Packed<TKV, E> kv[PB], vv[PB];
        float ksc[PB], vsc[PB];
        unsigned valid = 0;
#pragma unroll
        for (int p = 0; p < PB; ++p) {
            const int s = s0 + p;
            const int j = s / ps;
            const int pg = __shfl_sync(FULL, my_pg, j - pg0);
            ksc[p] = vsc[p] = 1.0f;
            if (s < s_hi) {
                valid |= 1u << p;
                const int64_t slot = ((int64_t)pg * Hkv + kvh) * ps + (s - j * ps);
                load_packed<TKV, E>(k_pool + slot * D + lane * E, kv[p]);
                load_packed<TKV, E>(v_pool + slot * D + lane * E, vv[p]);
                if constexpr (QUANT) {   // a multiply: an IEEE divide here cost 16% of K7
                    ksc[p] = __ldg(k_scales + slot) * (1.0f / 127.5f);
                    vsc[p] = __ldg(v_scales + slot) * (1.0f / 127.5f);
                }
            } else {
                zero_packed(kv[p]);
                zero_packed(vv[p]);
            }
        }
        attend_batch<TKV, E, REP, PB, QUANT>(qr, kv, vv, ksc, vsc, valid, st);
    }
    finish<REP, D>(sm, st, out + ((int64_t)b * Hkv + kvh) * REP * D,
                   ws + (int64_t)bh * n_split * REP * (D + 2), counters + bh, split, n_live);
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
    float* ws;
    int* counters;
    int B, P, Hkv, ps, W;
    float scale;
    int chunk, n_split;
    cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int REP>
cudaError_t launch4(const Args& a) {
    paged_attention_kernel<TQ, TKV, D, REP><<<dim3(a.B * a.Hkv, a.n_split), THREADS, 0, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
        a.ks, a.vs, a.lengths, a.tables, a.out, a.ws, a.counters, a.P, a.Hkv, a.ps, a.W, a.scale,
        a.chunk, a.n_split);
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

// The arguments up to `stream` are the unsplit kernel's; `ws`, `counters`, `chunk` and
// `n_split` carry the split plan and its persistent buffers.
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scales, const float* v_scales,
                               const int32_t* lengths, const int32_t* tables, float* out,
                               int q_dtype, int kv_dtype, int B, int L, int P, int Hkv, int ps,
                               int D, int rep, int W, int layer, float sm_scale, void* stream,
                               float* ws, int* counters, int chunk, int n_split) {
    if (B <= 0 || L <= 0 || P <= 0 || Hkv <= 0 || ps <= 0 || W <= 0 || layer < 0 || layer >= L)
        return (int)cudaErrorInvalidValue;
    const int64_t positions = (int64_t)W * ps;
    if (positions > 0x7fffffff || chunk <= 0 || chunk % CHUNK_UNIT || chunk % ps
        || n_split != (positions + chunk - 1) / chunk || n_split > MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    if (n_split > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
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
    a.ws = ws;
    a.counters = counters;
    a.chunk = chunk;
    a.n_split = n_split;
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
