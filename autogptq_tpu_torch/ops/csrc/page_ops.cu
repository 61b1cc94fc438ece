// K8a and K8b: in-place updates of KV caches for Hopper (sm_90a).
//
// K8a kv_write replaces autogptq_tpu/ops/pallas/paged_attn.py:write_token_pages_kernel (body
// _write_kernel): every decode step writes each sequence's new K and V row into the cache,
//   cache[layer, page(b), h, slot(b), :] = rows[b, h, :]  for both caches of a layer.
// Under XLA's jit the JAX package fuses the RoPE of q and k into the ops around that write. So
// does this kernel: kv_write_kernel<T, ROPE=true> takes the q/k/v projections of one layer, turns
// q and k by their positions (rotate-halves RoPE, angles pos * inv_freq in f32, sincosf, the
// rotation in f32 rounded once to T), returns q rotated and writes the rotated K and the V rows,
// and for an int8 cache quantizes each (slot, head) row in the same launch, the f32 scale beside
// it, in one of the JAX package's two schemes, which round differently and are never mixed:
//   QUANT_PAGED   the paged pools' (utils/generation.py:613-617): s = max|x|, floored at 1e-8,
//                 code = rint(x * (127.5 / s)) clipped to [-127, 127];
//   QUANT_CONTIG  the contiguous cache's (models/arch.py:_kv_quantize): s = max|x| / 127,
//                 code = rint(x / max(s, 1e-10)), s stored unfloored. One launch per
// layer and decode step in place of about two dozen eager ops (the angles, the rotation's
// multiplies, adds and concatenations, the casts, the copies or the quantization). The
// destination is a strided 5-D cache whose rows are D contiguous elements:
//   MODE_TABLES  page-major pools [L, P, Hkv, ps, D]: page = tables[b, pos[b] / ps],
//                slot = pos[b] % ps, read by the kernel (the paged beam step);
//   MODE_CURSOR  the contiguous cache [L, B, S, Hkv, D]: page = b, slot = cursor[0], the device
//                cursor of the captured greedy step;
//   MODE_ROW_CURSOR  the slot engine's contiguous cache [L, Bc, S, Hkv, D], one cursor per cache
//                row: the B = Bc * T input rows are T tokens per cache row, input row b going to
//                page = b / T, slot = cursor[b / T] + b % T (T = 1: the engine's decode step;
//                T = gamma + 1: the speculative verify window, positions [Bc * T] for RoPE);
//   MODE_ROWS    explicit page_of[b], off[b] (write_token_pages_kernel, rotation off: ROPE =
//                false copies rows of any element type, 4-D scale pools included as D = 1).
// One warp per (sequence, row): q heads, then K heads, then V heads; a lane holds D / 64 pairs
// (x[i], x[i + D/2]), and the int8 row's max is a warp shuffle. Bound: bytes, 2 * B * (H + 2 *
// Hkv) * D * sizeof(T) at most (about 200 KB per Llama-2-7B layer at beam 4), far below a launch:
// the gain is the launches it takes off the step, not the kernel's speed.
//
// K8b copy_pages_cluster replaces paged_attn.py:copy_pages_pair (bodies _gather_pages_kernel,
// _scatter_pages_kernel): beam search's copy-on-share, pool[:, dst[i]] = pool[:, src[i]] for
// both pools. Hazard: a src may be another copy's dst, but only within one (layer, pool). So
// each (layer, pool) is one thread-block cluster of n * slices blocks, block (i, part) holding
// slice `part` of copy i's page in shared memory: every block bulk-loads its src slice
// (cp.async.bulk, an mbarrier with the bytes expected), the cluster meets at a barrier, and
// every block bulk-stores its slice to dst. No scratch, one launch, the bound's bytes (2 * n *
// page per layer and pool, self-copies src == dst skipped). The ids are checked once per
// cluster by its first block, which the others read through distributed shared memory. A page
// is cut into slices of at most SLICE_MAX bytes; where n * slices exceeds MAX_CLUSTER (16, the
// non-portable limit) the two kernels of copy_pages (a gather into a scratch, then a scatter,
// on one stream; twice the bytes) keep the shape: ops/paged_attn.copy_plan decides from shapes.
//
// Bad ids. A target outside the cache (K8a: a page or slot outside it, a position past the
// table, a cursor past S, a negative per-row cursor), a page id outside [0, P) or a repeated dst
// (K8b) makes the launch write nothing to the caches: K8a's blocks check all B targets before
// writing, K8b's clusters all n pairs; a bad one ORs a bit into the device-side flag *err
// (ERR_* below) and the launch returns. The host reads the flag when it chooses
// (ops/paged_attn.py:check_page_errors). Dropped, not bad: in MODE_ROW_CURSOR a slot at or past
// n_slots (the S of the view written; the engine passes a view narrowed to its attention window)
// is not written and raises no flag, as the JAX package's scatter with mode="drop" discards it
// (models/arch.py:724-738: a slot parked at S - 1 outside the window); every other row of the
// launch is written and q is turned for every row.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PAIRS = 4;                        // D / 2 / 32 per lane: D <= 256
constexpr int PER_THREAD = 4;                       // units in flight per thread (copy_pages)
constexpr int CHUNK = THREADS * PER_THREAD;         // units per block (copy_pages)
constexpr int COPY_THREADS = 128;                   // copy_pages_cluster: one thread issues
constexpr int SLICE_MAX = 64 << 10;                 // bytes of a page slice in one block
constexpr int MAX_CLUSTER = 16;
constexpr int BULK_PIECE = 16 << 10;                // bytes per cp.async.bulk instruction
constexpr int ERR_WRITE_TARGET = 1;                 // K8a: a target outside the cache
constexpr int ERR_COPY_ID = 2;                      // K8b: a src or dst outside [0, P)
constexpr int ERR_COPY_DUP = 4;                     // K8b: a dst named twice
constexpr int MODE_ROWS = 0, MODE_TABLES = 1, MODE_CURSOR = 2, MODE_ROW_CURSOR = 3;
constexpr int DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2;  // ops/paged_attn.py FLOAT_CODES
constexpr int QUANT_NONE = 0, QUANT_PAGED = 1, QUANT_CONTIG = 2;   // ops/paged_attn.py QUANT_*

struct KvArgs {
    const void* q;              // [B, H, D] (ROPE; may be null)
    const void* k;              // [B, Hkv, D]
    const void* v;
    void* q_out;                // [B, H, D]: q rotated
    void* k_dst;                // the caches (element strides s_*; a row is D contiguous)
    void* v_dst;
    float* k_scale;             // QUANT: the scale pools, the caches' strides / D
    float* v_scale;
    const void* pos;            // [B] int32 or int64, stride pos_stride: RoPE angle, table slot
    const float* inv_freq;      // [D / 2]
    const int32_t* page_of;     // MODE_ROWS
    const int32_t* off;
    const int32_t* tables;      // MODE_TABLES: [B, W]
    const int64_t* cursor;      // MODE_CURSOR: [1]; MODE_ROW_CURSOR: [B / T]
    int* err;
    long long s_layer, s_page, s_head, s_slot, pos_stride;
    int mode, pos64, B, H, Hkv, D, n_pages, n_slots, W, layer, T;
};

__device__ __forceinline__ long long position(const KvArgs& a, int b) {
    const long long i = (long long)b * a.pos_stride;
    return a.pos64 ? static_cast<const int64_t*>(a.pos)[i] : static_cast<const int32_t*>(a.pos)[i];
}

struct Target {
    long long page, slot;
    bool ok;     // a valid target (a dropped one included)
    bool drop;   // MODE_ROW_CURSOR: at or past n_slots, not written
};

// Row b's page and slot.
__device__ __forceinline__ Target target(const KvArgs& a, int b) {
    Target t{b, 0, true, false};
    if (a.mode == MODE_ROW_CURSOR) {
        t.page = b / a.T;
        const long long c = a.cursor[t.page];
        t.slot = c + b % a.T;
        t.ok = c >= 0 && t.page < a.n_pages;
        t.drop = t.slot >= a.n_slots;
        return t;
    }
    if (a.mode == MODE_ROWS) {
        t.page = a.page_of[b];
        t.slot = a.off[b];
    } else if (a.mode == MODE_TABLES) {
        const long long p = position(a, b);
        if (p < 0 || p / a.n_slots >= a.W) return Target{0, 0, false, false};
        t.page = a.tables[(long long)b * a.W + p / a.n_slots];
        t.slot = p % a.n_slots;
    } else {
        t.slot = a.cursor[0];
    }
    t.ok = t.page >= 0 && t.page < a.n_pages && t.slot >= 0 && t.slot < a.n_slots;
    return t;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// ROPE: T is the activations' type and the float caches' (int8 ones with QUANT); q and k turn,
// v is copied (or quantized). !ROPE: T is an unsigned type of the caches' element size and the
// rows are copied as they are.
template <typename T, bool ROPE, int QUANT>
__global__ void __launch_bounds__(THREADS) kv_write_kernel(const KvArgs a) {
    bool bad = false;
    for (int t = threadIdx.x; t < a.B; t += THREADS) bad |= !target(a, t).ok;
    if (__syncthreads_or(bad)) {
        if (blockIdx.x == 0 && threadIdx.x == 0) atomicOr(a.err, ERR_WRITE_TARGET);
        return;
    }
    const int nq = ROPE && a.q != nullptr ? a.H : 0;
    const int per_b = nq + 2 * a.Hkv;
    const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    if (row >= (long long)a.B * per_b) return;      // whole warps
    const int lane = threadIdx.x % 32;
    const int b = (int)(row / per_b);
    const int j = (int)(row - (long long)b * per_b);
    const bool is_q = j < nq, is_v = j >= nq + a.Hkv;
    const int h = is_q ? j : j - nq - (is_v ? a.Hkv : 0);
    const long long src_off = ((long long)b * (is_q ? a.H : a.Hkv) + h) * a.D;
    const T* src = static_cast<const T*>(is_q ? a.q : is_v ? a.v : a.k) + src_off;
    long long dst_off = 0;
    if (!is_q) {
        const Target t = target(a, b);
        if (t.drop) return;                         // whole warps: nothing of this row is written
        dst_off = a.layer * a.s_layer + t.page * a.s_page + h * a.s_head + t.slot * a.s_slot;
    }
    if constexpr (!ROPE) {
        T* dst = static_cast<T*>(is_v ? a.v_dst : a.k_dst) + dst_off;
        for (int i = lane; i < a.D; i += 32) dst[i] = src[i];
    } else {
        const int half = a.D / 2;
        const float p = (float)position(a, b);
        T* out = is_q ? static_cast<T*>(a.q_out) + src_off
                      : static_cast<T*>(is_v ? a.v_dst : a.k_dst) + dst_off;
        float y1[MAX_PAIRS], y2[MAX_PAIRS];
        float amax = 0.f;
#pragma unroll
        for (int u = 0; u < MAX_PAIRS; ++u) {
            const int i = lane + 32 * u;
            y1[u] = y2[u] = 0.f;
            if (i >= half) continue;
            float x1 = to_f(src[i]), x2 = to_f(src[i + half]);
            if (!is_v) {   // apply_rope's order: the products and the sum in f32, no fma
                float s, c;
                sincosf(__fmul_rn(p, a.inv_freq[i]), &s, &c);
                const float r1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
                const float r2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
                x1 = r1;
                x2 = r2;
            }
            const T t1 = from_f<T>(x1), t2 = from_f<T>(x2);   // rounded once
            if (QUANT != QUANT_NONE && !is_q) {
                y1[u] = to_f(t1);
                y2[u] = to_f(t2);
                amax = fmaxf(amax, fmaxf(fabsf(y1[u]), fabsf(y2[u])));
            } else {
                out[i] = t1;
                out[i + half] = t2;
            }
        }
        if constexpr (QUANT != QUANT_NONE) {
            if (is_q) return;                       // whole warps
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
            int8_t* codes = static_cast<int8_t*>(is_v ? a.v_dst : a.k_dst) + dst_off;
            float s;
            if constexpr (QUANT == QUANT_PAGED) {
                s = fmaxf(amax, 1e-8f);
                const float mul = __fmul_rn(__frcp_rn(s), 127.5f);   // torch's 127.5 / s
#pragma unroll
                for (int u = 0; u < MAX_PAIRS; ++u) {
                    const int i = lane + 32 * u;
                    if (i >= half) continue;
                    codes[i] = (int8_t)fminf(fmaxf(rintf(__fmul_rn(y1[u], mul)), -127.f), 127.f);
                    codes[i + half] =
                        (int8_t)fminf(fmaxf(rintf(__fmul_rn(y2[u], mul)), -127.f), 127.f);
                }
            } else {   // _kv_quantize's divisions, correctly rounded; |x| / s <= 127 needs no clip
                s = __fdiv_rn(amax, 127.0f);
                const float den = fmaxf(s, 1e-10f);
#pragma unroll
                for (int u = 0; u < MAX_PAIRS; ++u) {
                    const int i = lane + 32 * u;
                    if (i >= half) continue;
                    codes[i] = (int8_t)rintf(__fdiv_rn(y1[u], den));
                    codes[i + half] = (int8_t)rintf(__fdiv_rn(y2[u], den));
                }
            }
            // the scale caches have the code caches' shape with D = 1
            if (lane == 0) (is_v ? a.v_scale : a.k_scale)[dst_off / a.D] = s;
        }
    }
}

template <typename T, bool ROPE, int QUANT>
cudaError_t launch_kv_write(const KvArgs& a, cudaStream_t st) {
    const int per_b = (ROPE && a.q != nullptr ? a.H : 0) + 2 * a.Hkv;
    const long long blocks = ((long long)a.B * per_b + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    kv_write_kernel<T, ROPE, QUANT><<<(unsigned)blocks, THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

// ---- K8b ----------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// Grid (n * slices, L, 2 pools), clusters of n * slices along x: cluster (layer, pool), block
// rank i * slices + part. Dynamic shared memory: one slice.
__global__ void __launch_bounds__(COPY_THREADS)
copy_pages_cluster_kernel(char* __restrict__ k_pool, char* __restrict__ v_pool,
                          const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                          int P, int n, int slices, long long page_bytes,
                          int* __restrict__ err) {
    extern __shared__ __align__(128) unsigned char slice[];
    __shared__ __align__(8) uint64_t bar;
    __shared__ int bad_bits;
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const int i = (int)rank / slices, part = (int)rank % slices;
    const uint32_t bar_a = smem_u32(&bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (rank == 0) {   // the cluster's id check
        bool bad_id = false, dup = false;
        for (int t = threadIdx.x; t < n; t += COPY_THREADS) {
            const int s = src[t], d = dst[t];
            bad_id |= s < 0 || s >= P || d < 0 || d >= P;
            for (int u = 0; u < t; ++u) dup |= dst[u] == d;
        }
        const int bits = (__syncthreads_or(bad_id) ? ERR_COPY_ID : 0) |
                         (__syncthreads_or(dup) ? ERR_COPY_DUP : 0);
        if (threadIdx.x == 0) bad_bits = bits;
    }
    cluster.sync();                                 // every block started, the check is done
    const int bits = *cluster.map_shared_rank(&bad_bits, 0);
    const int s = src[i], d = dst[i];
    const bool move = bits == 0 && s != d;
    const long long sb = page_bytes / slices;
    char* base = (blockIdx.z ? v_pool : k_pool) + (long long)blockIdx.y * P * page_bytes +
                 (long long)part * sb;
    const uint32_t to = smem_u32(slice);
    if (move && threadIdx.x == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a),
                     "r"((uint32_t)sb)
                     : "memory");
        for (long long o = 0; o < sb; o += BULK_PIECE) {
            const uint32_t bytes = (uint32_t)(sb - o < BULK_PIECE ? sb - o : BULK_PIECE);
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1], %2, [%3];\n" ::"r"(to + (uint32_t)o),
                "l"(base + (long long)s * page_bytes + o), "r"(bytes), "r"(bar_a)
                : "memory");
        }
        mbar_wait(bar_a, 0);
    }
    cluster.sync();   // every src slice of this (layer, pool) has been read; rank 0 may exit
    if (bits) {
        if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0)
            atomicOr(err, bits);
        return;
    }
    if (move && threadIdx.x == 0) {
        for (long long o = 0; o < sb; o += BULK_PIECE) {
            const uint32_t bytes = (uint32_t)(sb - o < BULK_PIECE ? sb - o : BULK_PIECE);
            asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                             base + (long long)d * page_bytes + o),
                         "r"(to + (uint32_t)o), "r"(bytes)
                         : "memory");
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
}

// The two-kernel path. Pages: block g * chunks + c moves chunk c of page copy g = (pool, l, i).
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

cudaError_t cluster_attributes() {
    cudaError_t e = cudaFuncSetAttribute(copy_pages_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SLICE_MAX);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(copy_pages_cluster_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
}

}  // namespace

// K8a: the fused RoPE + K/V write (rope = 1; dtype the activations' FLOAT code; quant for int8
// caches with their scale caches: QUANT_PAGED for page pools, QUANT_CONTIG for the contiguous
// cache) or the plain row write (rope = 0, elem_bytes the caches' element size). Strides in
// elements of the caches.
extern "C" int kv_write(const void* q, const void* k, const void* v, void* q_out, void* k_dst,
                        void* v_dst, float* k_scale, float* v_scale, const void* pos, int pos64,
                        long long pos_stride, const float* inv_freq, const int32_t* page_of,
                        const int32_t* off, const int32_t* tables, const int64_t* cursor,
                        int mode, int rope, int quant, int dtype, int elem_bytes, int B, int H,
                        int Hkv, int D, int n_pages, int n_slots, int W, int layer, int T,
                        long long s_layer, long long s_page, long long s_head, long long s_slot,
                        int* err, void* stream) {
    if (B < 0 || Hkv <= 0 || D <= 0 || n_pages <= 0 || n_slots <= 0 || layer < 0 || err == nullptr ||
        mode < MODE_ROWS || mode > MODE_ROW_CURSOR || (mode == MODE_TABLES && (W <= 0 || !tables)) ||
        (mode == MODE_CURSOR && !cursor) || (mode == MODE_ROWS && (!page_of || !off)) ||
        (mode == MODE_ROW_CURSOR && (!cursor || T <= 0 || B % T || B / T > n_pages)))
        return (int)cudaErrorInvalidValue;
    if (quant < QUANT_NONE || quant > QUANT_CONTIG || (quant && !rope) ||
        (rope && (D % 2 || D / 2 > 32 * MAX_PAIRS || !inv_freq || !pos ||
                  (q && (!q_out || H <= 0)) || (quant && (!k_scale || !v_scale)))))
        return (int)cudaErrorInvalidValue;
    if (mode == MODE_TABLES && !pos) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const KvArgs a{q,      k,       v,      q_out,   k_dst,   v_dst,      k_scale,
                   v_scale, pos,    inv_freq, page_of, off,   tables,     cursor,
                   err,     s_layer, s_page, s_head,  s_slot, pos_stride, mode,
                   pos64,   B,       H,      Hkv,     D,      n_pages,    n_slots,
                   W,       layer,   T};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (rope) {
        switch (dtype * 3 + quant) {
            case DT_F32 * 3 + QUANT_NONE: return (int)launch_kv_write<float, true, QUANT_NONE>(a, st);
            case DT_F32 * 3 + QUANT_PAGED: return (int)launch_kv_write<float, true, QUANT_PAGED>(a, st);
            case DT_F32 * 3 + QUANT_CONTIG: return (int)launch_kv_write<float, true, QUANT_CONTIG>(a, st);
            case DT_F16 * 3 + QUANT_NONE: return (int)launch_kv_write<__half, true, QUANT_NONE>(a, st);
            case DT_F16 * 3 + QUANT_PAGED: return (int)launch_kv_write<__half, true, QUANT_PAGED>(a, st);
            case DT_F16 * 3 + QUANT_CONTIG: return (int)launch_kv_write<__half, true, QUANT_CONTIG>(a, st);
            case DT_BF16 * 3 + QUANT_NONE:
                return (int)launch_kv_write<__nv_bfloat16, true, QUANT_NONE>(a, st);
            case DT_BF16 * 3 + QUANT_PAGED:
                return (int)launch_kv_write<__nv_bfloat16, true, QUANT_PAGED>(a, st);
            case DT_BF16 * 3 + QUANT_CONTIG:
                return (int)launch_kv_write<__nv_bfloat16, true, QUANT_CONTIG>(a, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    switch (elem_bytes) {
        case 1: return (int)launch_kv_write<uint8_t, false, QUANT_NONE>(a, st);
        case 2: return (int)launch_kv_write<uint16_t, false, QUANT_NONE>(a, st);
        case 4: return (int)launch_kv_write<uint32_t, false, QUANT_NONE>(a, st);
        case 8: return (int)launch_kv_write<uint64_t, false, QUANT_NONE>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K8b: one launch of L * 2 clusters of n * slices blocks (ops/paged_attn.copy_plan).
extern "C" int copy_pages_cluster(void* k_pool, void* v_pool, const int32_t* src,
                                  const int32_t* dst, int L, int P, int n, long long page_bytes,
                                  int slices, int* err, void* stream) {
    if (L <= 0 || P <= 0 || n < 0 || slices <= 0 || n * slices > MAX_CLUSTER ||
        page_bytes <= 0 || page_bytes % (16LL * slices) || page_bytes / slices > SLICE_MAX ||
        L > 65535 || err == nullptr ||
        (reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) & 15)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    static const cudaError_t attr = cluster_attributes();
    if (attr != cudaSuccess) return (int)attr;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)(n * slices);
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n * slices), (unsigned)L, 2);
    cfg.blockDim = dim3(COPY_THREADS);
    cfg.dynamicSmemBytes = (size_t)(page_bytes / slices);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = at;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, copy_pages_cluster_kernel, static_cast<char*>(k_pool),
                                   static_cast<char*>(v_pool), src, dst, P, n, slices,
                                   page_bytes, err);
}

// K8b where copy_plan finds no cluster: the gather into the scratch, then the scatter to dst.
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
