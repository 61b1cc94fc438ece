// K2: flash-decode attention for Hopper (sm_90a): one query token per batch row attends the
// slots [lo[b], hi[b]) of one layer of the stacked KV cache.
//
// Replaces the TPU kernel autogptq_tpu/ops/pallas/flash_decode.py:_kernel (reached through
// flash_decode), which runs the attention of every decode step of the Llama path.
//
//   q        [B, H, D]           activation type (f32, f16 or bf16)
//   k_cache  [L, B, S, Hkv, D]   same type; read in place at `layer`, never copied
//   v_cache  [L, B, S, Hkv, D]
//   lo, hi   int32 [B]           first attendable slot (left padding) and exclusive end
//   out      f32 [B, H, D]
//   ws       f32 [B * Hkv, n_split, rep, D + 2]   partials (unused when n_split == 1)
//   counters int32 [B * Hkv]     tickets, 0 before and after every launch
// Query head h attends KV head h / rep (GQA, rep = H / Hkv). Scores, softmax and the weighted
// sum are f32. hi is clamped to S; a row with hi <= lo has nothing to attend and gets zeros,
// never NaN.
//
// Bound on the H100 (3.35 TB/s HBM): the K and V bytes of the live slots, 2 * (hi - lo) *
// Hkv * D * sizeof(T) per row; for Llama-2-7B at a 528-slot window one layer reads 8.65 MB.
//
// Design: split-KV in one launch (split_kv.cuh). The TPU kernel walks a row's slots in order
// along a sequential grid axis, carrying its running softmax in VMEM; here the row's slots are
// cut into n_split chunks of `chunk` slots that run in parallel, grid (B * Hkv, n_split), and
// the block drawing a (row, KV head)'s last ticket merges the chunks' partials. The plan comes
// from the shapes alone (ops/flash_decode.py:split_plan), so the grid is fixed for a cache
// capacity: at B = 1, Hkv = 32 and 528 slots, 17 chunks of 32 slots, 544 blocks of 4 warps
// (the unsplit kernel ran 32 blocks on 132 SMs).

#include "split_kv.cuh"

namespace {

using namespace splitkv;

enum DType { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2 };

template <typename T, int D, int REP>
__global__ void __launch_bounds__(THREADS, (min_blocks<REP, D / 32>()))
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int32_t* __restrict__ lo_p,
                    const int32_t* __restrict__ hi_p, float* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int B, int S, int Hkv,
                    int layer, float scale, int chunk, int n_split) {
    constexpr int E = D / 32;
    constexpr int PB = batch_positions<T, E, REP>();
    __shared__ Shared<REP, D> sm;

    const int bh = blockIdx.x;
    const int split = blockIdx.y;
    const int b = bh / Hkv;
    const int kvh = bh - b * Hkv;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int lo = max(lo_p[b], 0);
    const int hi = min(hi_p[b], S);
    // The row's live chunks [first, first + n_live): the others exit at once. A row with
    // nothing to attend is one (empty) chunk, 0, which writes its zeros.
    const int first = hi > lo ? lo / chunk : 0;
    const int n_live = hi > lo ? (hi - 1) / chunk - first + 1 : 1;
    if (split < first || split >= first + n_live) return;
    const int c0 = split * chunk;
    const int s_lo = max(lo, c0);
    const int s_hi = min(hi, c0 + chunk);

    float qr[REP][E];
    if (s_lo < s_hi)   // a chunk with no live position loads nothing
        load_queries<T, E, REP>(q + ((int64_t)b * Hkv + kvh) * REP * D, lane, scale, qr);
    WarpState<REP, E> st;
    st.init();

    const int64_t pos_stride = (int64_t)Hkv * D;
    const int64_t base = (((int64_t)layer * B + b) * S) * pos_stride + (int64_t)kvh * D + lane * E;
    const T* kb = k_cache + base;
    const T* vb = v_cache + base;
    const float no_scale[PB] = {};

    for (int s0 = c0 + warp * PB; s0 < s_hi; s0 += WARPS * PB) {
        if (s0 + PB <= s_lo) continue;
        Packed<T, E> kv[PB], vv[PB];
        unsigned valid = 0;
#pragma unroll
        for (int p = 0; p < PB; ++p) {
            const int s = s0 + p;
            if (s >= s_lo && s < s_hi) {
                valid |= 1u << p;
                load_packed<T, E>(kb + s * pos_stride, kv[p]);
                load_packed<T, E>(vb + s * pos_stride, vv[p]);
            } else {
                zero_packed(kv[p]);
                zero_packed(vv[p]);
            }
        }
        attend_batch<T, E, REP, PB, false>(qr, kv, vv, no_scale, no_scale, valid, st);
    }
    finish<REP, D>(sm, st, out + ((int64_t)b * Hkv + kvh) * REP * D,
                   ws + (int64_t)bh * n_split * REP * (D + 2), counters + bh, split - first,
                   n_live);
}

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const int32_t* lo;
    const int32_t* hi;
    float* out;
    float* ws;
    int* counters;
    int B, S, Hkv, layer;
    float scale;
    int chunk, n_split;
    cudaStream_t stream;
};

template <typename T, int D, int REP>
cudaError_t launch3(const Args& a) {
    flash_decode_kernel<T, D, REP><<<dim3(a.B * a.Hkv, a.n_split), THREADS, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.lo, a.hi, a.out, a.ws, a.counters, a.B, a.S, a.Hkv, a.layer, a.scale, a.chunk,
        a.n_split);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch2(int rep, const Args& a) {
    switch (rep) {
        case 1: return launch3<T, D, 1>(a);
        case 2: return launch3<T, D, 2>(a);
        case 4: return launch3<T, D, 4>(a);
        case 8:
            if constexpr (D <= 128) return launch3<T, D, 8>(a);
            return cudaErrorInvalidValue;
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch1(int d, int rep, const Args& a) {
    switch (d) {
        case 64: return launch2<T, 64>(rep, a);
        case 128: return launch2<T, 128>(rep, a);
        case 256: return launch2<T, 256>(rep, a);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// The arguments up to `stream` are the unsplit kernel's; `ws`, `counters`, `chunk` and
// `n_split` carry the split plan and its persistent buffers.
extern "C" int flash_decode(const void* q, const void* k_cache, const void* v_cache,
                            const int32_t* lo, const int32_t* hi, float* out, int dtype, int B,
                            int S, int Hkv, int D, int rep, int layer, float sm_scale,
                            void* stream, float* ws, int* counters, int chunk, int n_split) {
    if (B <= 0 || S <= 0 || Hkv <= 0 || layer < 0) return (int)cudaErrorInvalidValue;
    if (chunk <= 0 || chunk % CHUNK_UNIT || n_split != (S + chunk - 1) / chunk
        || n_split > MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    if (n_split > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
    Args a{q, k_cache, v_cache, lo, hi, out, ws, counters, B, S, Hkv, layer, sm_scale, chunk,
           n_split, static_cast<cudaStream_t>(stream)};
    switch (dtype) {
        case DT_F32: return (int)launch1<float>(D, rep, a);
        case DT_F16: return (int)launch1<__half>(D, rep, a);
        case DT_BF16: return (int)launch1<__nv_bfloat16>(D, rep, a);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* flash_decode_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
