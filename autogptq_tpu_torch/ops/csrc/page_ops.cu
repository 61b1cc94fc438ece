// K8a and K8b: in-place updates of page-major KV pools for Hopper (sm_90a).
//
// K8a write_token_rows replaces autogptq_tpu/ops/pallas/paged_attn.py:write_token_pages_kernel
// (body _write_kernel): every decode step writes each sequence's new K and V row into the page
// it owns,  pool[layer, page_of[b], h, off[b], :] = rows[b, h, :]  for both pools of a layer.
// K8b copy_pages (a gather and a scatter kernel) replaces paged_attn.py:copy_pages_pair (bodies
// _gather_pages_kernel, _scatter_pages_kernel): beam search's copy-on-share,
// pool[:, dst[i]] = pool[:, src[i]]  for both pools.
//
// Both are plain byte movers: a pool is [L, P, Hkv, ps, R] of any element type, with R = D for
// the K/V pools (bf16, f16, f32 or int8) and R = 1 for the 4-D f32 scale pools of an int8
// cache, so one kernel serves every dtype. Accesses are `unit` bytes wide (16 when the row or
// page size and the pointers allow it: a 16-byte vector load and store per thread).
//
// Bounds on the H100 (3.35 TB/s HBM), both bytes:
// - K8a moves 2 * B * Hkv * R * sizeof(T) bytes in and out (64 KiB per Llama-2-7B layer at
//   beam 4 in bf16): a few microseconds of launch latency, nothing else. The TPU kernel
//   rewrites the whole page with a masked select because Mosaic cannot store at a dynamic
//   sublane offset; this kernel writes only the row.
// - K8b reads n pages and writes n pages per pool and layer (32 MiB each way per beam-4
//   Llama-2-7B step). Hazard: a src may be another copy's dst in the same call, and blocks run
//   in no order, so one in-place kernel would race. copy_pages launches two kernels on one
//   stream, as the TPU does: gather every src page into a compact scratch [L, n, page], then
//   scatter the scratch to dst. The scratch round trip doubles the bytes; at 32 MiB it mostly
//   stays in the 50 MB L2.
//
// Bad ids. A row target outside the pool (K8a), a page id outside [0, P) or a repeated dst
// (K8b) makes the launch write nothing to the pools: every block checks all B targets, or all
// n src/dst pairs, before it writes, and a block that finds a bad one sets a bit in the
// device-side flag *err (ERR_* below) and returns. The host reads the flag when it chooses
// (ops/paged_attn.py:check_page_errors), so a launch never waits for the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;                       // units in flight per thread (K8b)
constexpr int CHUNK = THREADS * PER_THREAD;         // units per block (K8b)
constexpr int ERR_WRITE_TARGET = 1;                 // K8a: page_of or off outside the pool
constexpr int ERR_COPY_ID = 2;                      // K8b: a src or dst outside [0, P)
constexpr int ERR_COPY_DUP = 4;                     // K8b: a dst named twice

// Rows: one thread per unit. Item i covers (pool, b, h, u) for u < units_per_row.
template <typename U>
__global__ void __launch_bounds__(THREADS)
write_rows_kernel(char* __restrict__ k_pool, char* __restrict__ v_pool,
                  const char* __restrict__ krows, const char* __restrict__ vrows,
                  const int32_t* __restrict__ page_of, const int32_t* __restrict__ off,
                  int B, int P, int Hkv, int ps, int64_t units_per_row, int layer,
                  int* __restrict__ err) {
    bool bad = false;
    for (int t = threadIdx.x; t < B; t += THREADS) {
        const int pg = page_of[t];
        const int o = off[t];
        bad |= pg < 0 || pg >= P || o < 0 || o >= ps;
    }
    if (__syncthreads_or(bad)) {
        if (blockIdx.x == 0 && threadIdx.x == 0) atomicOr(err, ERR_WRITE_TARGET);
        return;
    }
    const int64_t per_pool = (int64_t)B * Hkv * units_per_row;
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= 2 * per_pool) return;
    const int pool = (int)(i / per_pool);
    const int64_t rem = i - pool * per_pool;
    const int64_t row = rem / units_per_row;        // b * Hkv + h
    const int64_t u = rem - row * units_per_row;
    const int b = (int)(row / Hkv);
    const int h = (int)(row - (int64_t)b * Hkv);
    const int64_t dst_row = ((((int64_t)layer * P + page_of[b]) * Hkv + h) * ps + off[b]);
    const U* from = reinterpret_cast<const U*>(pool ? vrows : krows);
    U* to = reinterpret_cast<U*>(pool ? v_pool : k_pool);
    to[dst_row * units_per_row + u] = from[row * units_per_row + u];
}

// Pages: block g * chunks + c moves chunk c of page copy g = (pool, l, i).
// GATHER: pool[l, src[i]] -> scratch[l, i]; otherwise scratch[l, i] -> pool[l, dst[i]], after
// every block has checked all ids (a gather of a bad src is skipped, and its scratch is then
// never scattered).
template <typename U, bool GATHER>
__global__ void __launch_bounds__(THREADS)
move_pages_kernel(char* __restrict__ k_pool, char* __restrict__ v_pool,
                  char* __restrict__ k_scr, char* __restrict__ v_scr,
                  const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                  int L, int P, int n, int64_t units_per_page, int chunks,
                  int* __restrict__ err) {
    if (!GATHER) {
        bool bad_id = false, dup = false;
        for (int t = threadIdx.x; t < n; t += THREADS) {
            const int s = src[t];
            const int d = dst[t];
            bad_id |= s < 0 || s >= P || d < 0 || d >= P;
            for (int j = 0; j < t; ++j) dup |= dst[j] == d;
        }
        const int bad = (__syncthreads_or(bad_id) ? ERR_COPY_ID : 0) |
                        (__syncthreads_or(dup) ? ERR_COPY_DUP : 0);
        if (bad) {
            if (blockIdx.x == 0 && threadIdx.x == 0) atomicOr(err, bad);
            return;
        }
    }
    const int64_t g = blockIdx.x / chunks;
    const int c = (int)(blockIdx.x - g * chunks);
    const int64_t per_pool = (int64_t)L * n;
    const int pool = (int)(g / per_pool);
    const int64_t rem = g - pool * per_pool;
    const int l = (int)(rem / n);
    const int i = (int)(rem - (int64_t)l * n);
    const int page = GATHER ? src[i] : dst[i];
    if (GATHER && (page < 0 || page >= P)) return;
    U* pool_page = reinterpret_cast<U*>(pool ? v_pool : k_pool)
                   + ((int64_t)l * P + page) * units_per_page;
    U* scr_page = reinterpret_cast<U*>(pool ? v_scr : k_scr) + ((int64_t)l * n + i) * units_per_page;
    const U* from = GATHER ? pool_page : scr_page;
    U* to = GATHER ? scr_page : pool_page;
    const int64_t base = (int64_t)c * CHUNK + threadIdx.x;
    U tmp[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const int64_t u = base + k * THREADS;
        if (u < units_per_page) tmp[k] = from[u];
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const int64_t u = base + k * THREADS;
        if (u < units_per_page) to[u] = tmp[k];
    }
}

template <typename U>
cudaError_t write_rows(void* k_pool, void* v_pool, const void* krows, const void* vrows,
                       const int32_t* page_of, const int32_t* off, int B, int P, int Hkv, int ps,
                       int64_t row_bytes, int layer, int* err, cudaStream_t st) {
    const int64_t upr = row_bytes / (int64_t)sizeof(U);
    const int64_t items = 2 * (int64_t)B * Hkv * upr;
    const int64_t blocks = (items + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    write_rows_kernel<U><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<char*>(k_pool), static_cast<char*>(v_pool), static_cast<const char*>(krows),
        static_cast<const char*>(vrows), page_of, off, B, P, Hkv, ps, upr, layer, err);
    return cudaGetLastError();
}

template <typename U>
cudaError_t copy_pages_as(void* k_pool, void* v_pool, void* k_scr, void* v_scr,
                          const int32_t* src, const int32_t* dst, int L, int P, int n,
                          int64_t page_bytes, int* err, cudaStream_t st) {
    const int64_t upp = page_bytes / (int64_t)sizeof(U);
    const int64_t chunks = (upp + CHUNK - 1) / CHUNK;
    const int64_t blocks = 2 * (int64_t)L * n * chunks;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    char *kp = static_cast<char*>(k_pool), *vp = static_cast<char*>(v_pool);
    char *ks = static_cast<char*>(k_scr), *vs = static_cast<char*>(v_scr);
    move_pages_kernel<U, true><<<(unsigned)blocks, THREADS, 0, st>>>(
        kp, vp, ks, vs, src, dst, L, P, n, upp, (int)chunks, err);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    move_pages_kernel<U, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        kp, vp, ks, vs, src, dst, L, P, n, upp, (int)chunks, err);
    return cudaGetLastError();
}

}  // namespace

extern "C" int write_token_rows(void* k_pool, void* v_pool, const void* krows, const void* vrows,
                                const int32_t* page_of, const int32_t* off, int B, int P,
                                int Hkv, int ps, long long row_bytes, int layer, int unit,
                                int* err, void* stream) {
    if (B < 0 || P <= 0 || Hkv <= 0 || ps <= 0 || layer < 0 || unit <= 0 || row_bytes % unit ||
        err == nullptr)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (unit) {
        case 16: return (int)write_rows<uint4>(k_pool, v_pool, krows, vrows, page_of, off, B, P, Hkv, ps, row_bytes, layer, err, st);
        case 8: return (int)write_rows<uint2>(k_pool, v_pool, krows, vrows, page_of, off, B, P, Hkv, ps, row_bytes, layer, err, st);
        case 4: return (int)write_rows<uint32_t>(k_pool, v_pool, krows, vrows, page_of, off, B, P, Hkv, ps, row_bytes, layer, err, st);
        case 2: return (int)write_rows<uint16_t>(k_pool, v_pool, krows, vrows, page_of, off, B, P, Hkv, ps, row_bytes, layer, err, st);
        case 1: return (int)write_rows<uint8_t>(k_pool, v_pool, krows, vrows, page_of, off, B, P, Hkv, ps, row_bytes, layer, err, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K8b: the gather into the scratch, then the scatter to dst, on one stream.
extern "C" int copy_pages(void* k_pool, void* v_pool, void* k_scr, void* v_scr,
                          const int32_t* src, const int32_t* dst, int L, int P, int n,
                          long long page_bytes, int unit, int* err, void* stream) {
    if (L <= 0 || P <= 0 || n < 0 || unit <= 0 || page_bytes <= 0 || page_bytes % unit ||
        err == nullptr)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (unit) {
        case 16: return (int)copy_pages_as<uint4>(k_pool, v_pool, k_scr, v_scr, src, dst, L, P, n, page_bytes, err, st);
        case 8: return (int)copy_pages_as<uint2>(k_pool, v_pool, k_scr, v_scr, src, dst, L, P, n, page_bytes, err, st);
        case 4: return (int)copy_pages_as<uint32_t>(k_pool, v_pool, k_scr, v_scr, src, dst, L, P, n, page_bytes, err, st);
        case 2: return (int)copy_pages_as<uint16_t>(k_pool, v_pool, k_scr, v_scr, src, dst, L, P, n, page_bytes, err, st);
        case 1: return (int)copy_pages_as<uint8_t>(k_pool, v_pool, k_scr, v_scr, src, dst, L, P, n, page_bytes, err, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* page_ops_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
