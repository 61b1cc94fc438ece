// Tensor-core decode GEMV of the wNa16 dequant-matmuls for Hopper (sm_90a), bf16 and f16
// activations, M <= 16 rows, every group size, BITS in {2, 4, 8} (3-bit codes ride in nibbles).
// One block body (gemv_block), three kernels that differ only in where the words lie and which
// rows of x a block takes:
//   wna16_gemv_kernel   y[M,N] = x[M,K] @ ((q - z) * s)[K,N] (+ bias)   K1, K4, K5: GPTQ words
//   kb32l_gemv_kernel   the same over the kb32l tiles of kb32l_tile.cuh  K6 (w4a16_kb32l_gemm.cu)
//   routed_gemv_kernel  y[p] = x[p] @ W[sel[p]], a stack of E experts    K9 (w4a16_routed_gemm.cu)
// w4a16_gemm.cu, w8a16_gemm.cu and w2a16_gemm.cu instantiate the first beside their SIMT and tile
// kernels and export it as NAME_gemv; ops/gemm.py:route sends a product here when the
// activations are bf16 or f16, M <= 16 and the group size is 16 rows or more (the ANY_GS
// instance where 16 does not divide it). f32 activations and group sizes below 16 keep the
// SIMT GEMV of wna16_gemm.cuh. K6 and K9 route the same way (gemm.route, gemm.routed_route).
//
// It replaces the decode regime of the TPU kernels autogptq_tpu/ops/pallas/gemm.py:
// _kernel_kb32 (:487, entry _matmul_kb32 :559), _kernel_ki32 (:414), _kernel_kpair (:255), the
// planar _kernel (:46, _matmul_planar :1479) and _kernel_k2i32 (:1061), which stream the packed
// words through VMEM and dot each dequantized tile on the MXU; _kernel_kb32l_manual (:692, the
// kb32l decode ring) and _kernel_routed_kb32 (:894, the routed experts of MoE decode).
//
// Bound on the H100 (3.35 TB/s HBM): the bytes of the weight, BITS/8 B per weight plus fp16
// scales and uint8 zeros per group and column; one Llama-2-7B layer's 7 projections at 4-bit
// g128 move 106 MB, 0.0317 ms. The arithmetic, 2*M*K*N, is far below the tensor cores' rate.
//
// Design:
//  * Tensor cores do the products: mma.sync.m16n8k16 with f32 accumulators, the weight as the
//    16-row operand A (16 output columns x 16 K rows) and x as the 8-column operand B (8 rows
//    of M; a second MMA for rows 8-15 when M > 8). A warp owns 16 output columns: A row g is
//    column 2g of its tile and row g + 8 column 2g + 1, so a thread's two columns are adjacent
//    words and one 8-byte shared load reads both.
//  * Codes become A fragments with about one instruction per code. Inside a 16-row step the K
//    rows may be given to the MMA in any order, as long as x's B fragment uses the same order.
//    Thread t of a quad takes four codes of each of its columns from one word, two pairs whose
//    codes sit 16 bits apart (codes j and j + P/2 of a word of P codes), so a shift and one
//    LOP3 put both codes of a pair into the two halves of a register, under the exponent of
//    2^7 (bf16: 128 + q) or 2^10 (f16: 1024 + q); one packed subtraction of (that + z) leaves
//    q - z, exact in bf16 and f16. The K order this implies (perm_slot below) is applied to x
//    when it is staged, so ldmatrix loads B fragments in the same order. bf16 cannot hold
//    128 + q for 8-bit codes (q >= 128 needs a ninth bit), so that instance takes the 2^23
//    route of wna16_gemm.cuh in f32 (byte_perm builds 2^23 + q, one subtraction, one cvt
//    packs two values). Each group's product accumulates into its own fragment and is folded
//    in once per group, acc += s[g, n] * part, with the f32 scale: the same arithmetic as the
//    tile kernel of wna16_mma.cuh, and 16 | gs keeps a step inside one group.
//  * The group sizes 16 does not divide (the rest classes; ANY_GS, a separate instance, so the
//    16 | gs ones keep their code and registers): a step inside one group runs as above. The
//    stage holds each K row's group row (a byte per row), so every slot of a step that spans
//    groups finds its own group's zero, and a word straddling groups is right. Such a step
//    stays exact: its codes are decoded once, each slot with its own group's zero, and it runs
//    one MMA set per group it touches, x of the slots of other groups' rows masked to 0 (the
//    mask follows perm_slot, ge[lo] & ~ge[hi] from a table of 17 x 4); a set whose group ends
//    in the step folds in, acc += s[g, n] * (d + the group's earlier part), and a last set
//    whose group goes on becomes its first part. From gs 16 on about 16/gs of the steps span
//    two groups. Below gs 16 every step does, with up to ceil(15/gs) + 1 sets, and the sets
//    cost more than the SIMT GEMV's whole call (PERF.md: 3-bit gs 12, 8-bit gs 6), so
//    ops/gemm.py:route keeps those group sizes on the SIMT GEMV; the kernel still takes them
//    when asked (kernel="gemv"). A group cut by a split is folded in each split with the same
//    scale (linear, so the combine stays bit-equal). A stage holds (BK - 1) / gs + 2 group
//    rows (GvStage::groups, ops/gemm.py:_gemv_plan). Each step's words and x fragments are
//    read one step ahead, and the step loop stays rolled with one accumulator chain: its body
//    is large.
//  * A deep weight stream: a 4-stage cp.async ring of word tiles. A stage holds 16 word rows
//    (512 / BITS K rows) of the block's 64 columns, 4 KB of words at every width, rows padded
//    by 16 words so the 8-byte loads of a warp hit distinct banks, and the fp16 scales and
//    uint8 zeros of the groups the stage touches. Three stages are in flight while one is
//    consumed (one barrier per stage). x[:, the block's K chunk] is staged once per block in
//    the activation type while the first stages fly: copied by cp.async ahead of them and put
//    in slot order in place, or gathered through kperm (desc_act) by register loads.
//  * One launch per call: the grid is (column tiles of 64, K splits), planned on the host from
//    shapes alone (ops/gemm.py:gemv_plan: about 4 blocks per SM, at most 32 splits, the f32
//    workspace within a quarter of the weight's bytes). Each split writes its f32 partial
//    [M, 64] into the persistent workspace (ops/build.py:split_scratch), fences and takes a
//    ticket from its column tile's counter; the block that draws the last ticket adds the
//    partials in split order (results are bit-equal from call to call), adds the bias, casts
//    once and sets the counter back to 0. One split writes the output itself. Two launches
//    that share the workspace must not overlap, which one stream guarantees.
//  * kb32l (K6): the word address is a template parameter (Words: GptqWords [K/P, N] rows, or
//    Kb32lWords, tile (n/128, kw/32) at (kw%32)*128 + n%128), the scales' and zeros' row stride
//    an argument (N, or N_pad). A stage's 16 word rows of 64 columns lie inside one 32 x 128
//    tile (splits start on whole stages), so its copies are 16 runs of 256 B of one 16 KB span.
//    The plan is gemv_plan's on the true K and N: words of rows past K and columns past N are
//    not read (the copies zero-fill them), so the tiles' padding costs no bytes.
//  * Routed (K9), expert-major: the grid is (column tiles, K splits, min(P, E) expert slices),
//    planned from shapes alone (gemm.routed_plan). Each warp reads sel[0..P) (P <= 16); slice z
//    serves the z-th distinct valid expert in order of first appearance (a match and two
//    ballots: the compact list of the selected experts, built in the launch) and takes the
//    pairs that chose it, in pair order, as the block's rows of x (gathered into the B operand)
//    and of out. A slice beyond the distinct experts exits before its first copy. So each
//    selected expert's words, scales and zeros stream once per call however many pairs chose
//    it, and at P <= E every block works when the pairs' experts differ. The x stage holds P
//    rows (ldmatrix reads clamp to them), which keeps the block within 4 per SM. Partials are
//    indexed by pair and the tickets by (slice, column tile). A pair whose id lies outside
//    [0, E) is served by no block (its row of out keeps what it held) and one warp of the grid
//    sets ERR_BAD_EXPERT in the device flag *err (ops/gemm.py:check_routed_errors reads it).
// Every entry point returns cudaGetLastError() and the Python wrapper raises when it is
// non-zero.

#pragma once

#include <type_traits>

#include "wna16_mma.cuh"

namespace {

constexpr int GV_WARPS = 4;
constexpr int GV_THREADS = 32 * GV_WARPS;
constexpr int GV_BN = 16 * GV_WARPS;      // output columns per block, 16 per warp
constexpr int GV_LDW = GV_BN + 16;        // words per staged word row: 320 B, 64 mod 128
constexpr int GV_WROWS = 16;              // word rows per stage: 4 KB of words at every width
constexpr int GV_STAGES = 4;
constexpr int GV_MAX_SPLITS = 32;         // partials the last block adds, at most
constexpr int GV_XPAD = 8;                // halves of padding per staged x row
constexpr int GV_SMEM_LIMIT = 200 * 1024; // dynamic shared memory a block may ask for
constexpr int ERR_BAD_EXPERT = 1;         // K9's device-flag bit: a pair named no expert

template <int BITS> struct GvStage {      // byte offsets within one stage
    static constexpr int P = 32 / BITS;
    static constexpr int BK = GV_WROWS * P;           // K rows per stage
    static constexpr int GROUPS = BK / 16;            // group rows a stage can touch (16 | gs)
    static constexpr int W = 0;                                   // i32 [GV_WROWS][GV_LDW]
    static constexpr int S = W + GV_WROWS * GV_LDW * 4;           // f16 [GROUPS][GV_BN]
    static constexpr int Z = S + GROUPS * GV_BN * 2;              // u8  [GROUPS][GV_BN]
    static constexpr int BYTES = (Z + GROUPS * GV_BN + 15) / 16 * 16;
    // ANY_GS: ng group rows of scales and zeros in place of GROUPS, then each K row's group
    // row in the stage, u8 [BK]
    static __host__ __device__ constexpr int z_at(int ng) { return S + ng * GV_BN * 2; }
    static __host__ __device__ constexpr int ix_at(int ng) { return z_at(ng) + ng * GV_BN; }
    static __host__ __device__ constexpr int bytes(int ng) {
        return (ix_at(ng) + BK + 15) / 16 * 16;
    }
    // the group rows a stage holds at group size gs: BK / 16 where 16 divides gs, else every
    // group BK rows at any offset can touch (wna16_mma.cuh:stage_groups)
    static __host__ __device__ constexpr int groups(int gs) {
        return gs % 16 == 0 ? GROUPS : stage_groups(gs, BK);
    }
    static __host__ __device__ constexpr int stage_bytes(int gs) {
        return gs % 16 == 0 ? BYTES : bytes(groups(gs));
    }
};

__host__ __device__ constexpr int gv_x_bytes(int mt, int kc) { return mt * (kc + GV_XPAD) * 2; }

// Dynamic shared memory of the ring and the x stage at group size gs (ops/gemm.py:_gemv_plan).
template <int BITS>
__host__ __device__ constexpr int gv_smem_bytes(int mt, int kc, int gs = 16) {
    return GV_STAGES * GvStage<BITS>::stage_bytes(gs) + gv_x_bytes(mt, kc);
}

// The K row (within a 16-row step) that MMA slot s (0..15) of every fragment stands for. Slot
// s belongs to thread t = (s % 8) / 2 of a quad, pair e = s / 8 (register a0/a1 or a2/a3) and
// half h = s % 2. Thread t reads word row t / (P/4) of the step, code u = t % (P/4) onwards:
// pair e holds codes j = u + e * P/4 (low half) and j + P/2 (high half), 16 bits apart.
template <int BITS>
__host__ __device__ constexpr int perm_slot(int s) {
    constexpr int P = 32 / BITS;
    constexpr int Q = P / 4;                  // threads of a quad that share a word
    const int t = (s % 8) / 2;
    return (t / Q) * P + t % Q + (s / 8) * Q + (s % 2) * (P / 2);
}

template <typename T>
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
    if constexpr (std::is_same<T, __half>::value) {
        const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&a),
                                  *reinterpret_cast<const __half2*>(&b));
        return *reinterpret_cast<const uint32_t*>(&r);
    } else {
        const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                         *reinterpret_cast<const __nv_bfloat162*>(&b));
        return *reinterpret_cast<const uint32_t*>(&r);
    }
}

// Codes of one word into the two registers of a thread's column: e = 0 (slots 2t, 2t+1) and
// e = 1 (slots 2t+8, 2t+9), each (q - z) for codes (j, j + P/2), j = sh / BITS + e * P/4.
template <int BITS, typename T, bool F32 = (BITS == 8 && std::is_same<T, __nv_bfloat16>::value)>
struct GvCodes {
    static constexpr uint32_t MASK = ((1u << BITS) - 1u) * 0x00010001u;
    static constexpr uint32_t BIAS = std::is_same<T, __half>::value ? 0x64006400u : 0x43004300u;
    using Zero = uint32_t;            // (bias + z) in both halves
    static __device__ __forceinline__ Zero zero(uint32_t z) { return BIAS | z | (z << 16); }
    // (v & MASK) | BIAS in one LOP3: the compiler, given two immediates, splits it in two
    static __device__ __forceinline__ uint32_t biased(uint32_t v) {
        uint32_t r;
        asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(v), "n"(MASK), "r"(BIAS));
        return r;
    }
    static __device__ __forceinline__ void pairs(uint32_t w, int sh, Zero zz, uint32_t& e0,
                                                 uint32_t& e1) {
        e0 = sub2<T>(biased(w >> sh), zz);
        e1 = sub2<T>(biased(w >> (sh + 8)), zz);
    }
    // ANY_GS: the thread's four slots with their own groups' zeros; z_s holds slot s's
    // zeros of columns wcol (low byte) and wcol + 1
    static __device__ __forceinline__ void slot_pairs(uint2 w, int sh, uint32_t z0, uint32_t z1,
                                                      uint32_t z8, uint32_t z9,
                                                      uint32_t (&a)[4]) {
        // (bias + z) of a pair's low and high slot in the two halves: column wcol's bytes
        // (selector 0x6420: z_lo.b0, 0, z_hi.b0, 0) or wcol + 1's (0x6521)
        a[0] = sub2<T>(biased(w.x >> sh), BIAS | __byte_perm(z0, z1, 0x6420));
        a[2] = sub2<T>(biased(w.x >> (sh + 8)), BIAS | __byte_perm(z8, z9, 0x6420));
        a[1] = sub2<T>(biased(w.y >> sh), BIAS | __byte_perm(z0, z1, 0x6521));
        a[3] = sub2<T>(biased(w.y >> (sh + 8)), BIAS | __byte_perm(z8, z9, 0x6521));
    }
};

// 8-bit codes, bf16: 2^23 + q in f32 (byte_perm puts the byte under the exponent byte 0x4B),
// minus 2^23 + z, exact; one cvt rounds the (exact, |q - z| <= 255) pair to bf16.
template <typename T>
struct GvCodes<8, T, true> {
    using Zero = float;               // 2^23 + z
    static __device__ __forceinline__ Zero zero(uint32_t z) { return MAGIC + (float)z; }
    static __device__ __forceinline__ float code(uint32_t w, int byte_sel, float zb) {
        return __uint_as_float(__byte_perm(w, 0x4B000000u, byte_sel)) - zb;
    }
    static __device__ __forceinline__ void pairs(uint32_t w, int, Zero zb, uint32_t& e0,
                                                 uint32_t& e1) {
        e0 = Mma<T>::pack(code(w, 0x7440, zb), code(w, 0x7442, zb));
        e1 = Mma<T>::pack(code(w, 0x7441, zb), code(w, 0x7443, zb));
    }
    static __device__ __forceinline__ void slot_pairs(uint2 w, int, uint32_t z0, uint32_t z1,
                                                      uint32_t z8, uint32_t z9,
                                                      uint32_t (&a)[4]) {
        auto zb = [](uint32_t z, int c) {           // 2^23 + z of column c's byte
            return __uint_as_float(__byte_perm(z, 0x4B000000u, 0x7440 + c));
        };
        a[0] = Mma<T>::pack(code(w.x, 0x7440, zb(z0, 0)), code(w.x, 0x7442, zb(z1, 0)));
        a[2] = Mma<T>::pack(code(w.x, 0x7441, zb(z8, 0)), code(w.x, 0x7443, zb(z9, 0)));
        a[1] = Mma<T>::pack(code(w.y, 0x7440, zb(z0, 1)), code(w.y, 0x7442, zb(z1, 1)));
        a[3] = Mma<T>::pack(code(w.y, 0x7441, zb(z8, 1)), code(w.y, 0x7443, zb(z9, 1)));
    }
};

template <typename T>
__device__ __forceinline__ uint32_t bits16(T v) {
    return *reinterpret_cast<const unsigned short*>(&v);
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
}

// PRENORM: the chunk's staged norm weight [kc] of type pn.wdt turned into the f32 values the
// norm scales by (1 + w under plus_one) in place, in the kc * 4 bytes staged for it, so that
// each element is converted once per block and not once per row of x. Rounds of GV_THREADS * 8
// elements from the last: a round's f32 writes overwrite only raw elements of its own round,
// read before its barrier, or of later ones, already done. Ends with a barrier.
__device__ __forceinline__ void gv_norm_weights_f32(unsigned char* nws, const Prenorm& pn,
                                                    int kc) {
    constexpr int R = 8, ROUND = GV_THREADS * R;
    float* const wf = reinterpret_cast<float*>(nws);
    for (int base = (kc - 1) / ROUND * ROUND; base >= 0; base -= ROUND) {
        float w[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = base + r * GV_THREADS + (int)threadIdx.x;
            w[r] = i < kc ? prenorm_weight_at(nws, pn.wdt, i, pn.plus_one) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = base + r * GV_THREADS + (int)threadIdx.x;
            if (i < kc) wf[i] = w[r];
        }
        __syncthreads();
    }
}

// One block of the GEMV. Words addresses word row kw of column n (words(kw, n), in words from
// qweight); scales and zeros are [G, ldsz]. M is the number of rows of x and out; the x stage
// holds xrows <= MT of them. ROUTED: the operands are a stack of E experts ([E, K/P, N] words,
// [E, G, N] scales and zeros); slice z (blockIdx.z) serves the z-th distinct expert of
// sel[0..M) and takes the rows p with sel[p] equal to it (M <= 16: a warp's ballot).
// PRENORM (not with ROUTED): the fused RMS-norm prologue of wna16_gemm.cuh. The block takes the
// rstd of its M rows while its first weight stages fly, then normalizes its staged K chunk as
// it puts it in slot order, each element rounded once to T; the chunk's norm weight is copied
// with x into kc * 4 bytes after the x stage and turned into f32 there once (gathered x reads it
// from global memory by column).
// rstd (pn.rstd) comes from wg_rstd_kernel (wna16_wgmma.cuh), which the entry launches once per
// call just before this one, so that no block reads all M rows of x from L2 for it (M * K * 2
// bytes each, 128 KB at M = 16, K = 4096): launched by programmatic dependent launch, the block
// copies x and fills its weight ring while that kernel runs, and only then waits for it
// (griddepcontrol.wait) and reads M floats.
// ANY_GS (not with PRENORM): any group size, the instance of the group sizes 16 does not
// divide. A 16-row step that spans groups runs one MMA set per group it touches: each takes
// q - z with that group's zero for the step's slots whose K row (perm_slot) lies in the group
// and exactly 0 for the others, so a word straddling groups gives each code its own group's
// zero, and a group's scale is folded in once its last row, or the split's, has gone in. The
// step's words and x fragments are read once for all its sets; group boundaries are K rows,
// the same for every thread, so the loop stays uniform. A stage holds GvStage::groups(gs).
template <int BITS, typename T, int MT, typename Words, bool ROUTED, bool PRENORM = false,
          bool ANY_GS = false>
__device__ __forceinline__ void gemv_block(
    const T* __restrict__ x, const int64_t* __restrict__ kperm,
    const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
    const uint8_t* __restrict__ zeros, const T* __restrict__ bias, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, const int32_t* __restrict__ sel,
    int* __restrict__ err, int M, int K, int N, int gs, int kc, int splits, int gather,
    Words words, int ldsz, int E, int xrows, Prenorm pn = Prenorm{}) {
    static_assert(!(PRENORM && ROUTED), "the prologue takes rows 0..M of x");
    static_assert(!(PRENORM && ANY_GS), "the fused prologue takes 32 | gs only");
    using L = GvStage<BITS>;
    using C = GvCodes<BITS, T>;
    constexpr int P = L::P;
    constexpr int BK = L::BK;
    constexpr int NT = MT / 8;               // MMAs per A fragment: rows 0-7, 8-15
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int last_block;
    __shared__ int pair_of[ROUTED ? MT : 1]; // ROUTED: the row of x and out of each block row
    __shared__ float rstd[PRENORM ? MT : 1];  // PRENORM: 1 / rms of each row of x
    // ANY_GS: [r][t] the slots of quad thread t whose K row within a step is r or more (pair
    // e = 0 in .x, e = 1 in .y), r = 0..16: the mask of rows [lo, hi) is ge[lo] & ~ge[hi]
    __shared__ uint2 ge_mask[ANY_GS ? 17 * 4 : 1];
    // group rows per stage, the offset of its zeros and a stage's bytes
    const int ngroups = ANY_GS ? L::groups(gs) : L::GROUPS;
    const int zoff = ANY_GS ? L::z_at(ngroups) : L::Z;
    [[maybe_unused]] const int ixoff = L::ix_at(ngroups);   // ANY_GS: the rows' group rows
    const int sbytes = ANY_GS ? L::bytes(ngroups) : L::BYTES;
    T* const xs = reinterpret_cast<T*>(smem + GV_STAGES * sbytes);   // [MT][kc + GV_XPAD]
    const int ldx = kc + GV_XPAD;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int n0 = blockIdx.x * GV_BN;
    const int split = blockIdx.y;
    const int k0 = split * kc;
    const int k1 = min(K, k0 + kc);
    const int G = (K + gs - 1) / gs;
    const int kwords = K / P;
    const int ntiles = (k1 - k0 + BK - 1) / BK;
    int rows = M;                            // rows of x this block multiplies
    int* ticket_ctr = counters + blockIdx.x;
    if constexpr (ROUTED) {
        const unsigned all = 0xFFFFFFFFu;
        const int s = lane < M ? sel[lane] : -1;
        const bool ok = lane < M && s >= 0 && s < E;
        if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid < 32) {   // one warp
            const unsigned bad = __ballot_sync(all, lane < M && !ok);
            if (bad != 0u && lane == 0) atomicOr(err, ERR_BAD_EXPERT);
        }
        // the first pair of each distinct valid expert, and the one of this slice's
        const unsigned same = __match_any_sync(all, ok ? s : -1 - lane);
        const bool first = ok && __ffs(same) - 1 == lane;
        const unsigned firsts = __ballot_sync(all, first);
        const unsigned mine = __ballot_sync(
            all, first && __popc(firsts & ((1u << lane) - 1u)) == (int)blockIdx.z);
        if (mine == 0u) return;              // every warp holds the same masks: uniform
        const int e = __shfl_sync(all, s, __ffs(mine) - 1);
        const unsigned chose = __ballot_sync(all, ok && s == e);
        rows = __popc(chose);
        if (tid < 32 && ((chose >> lane) & 1u)) pair_of[__popc(chose & ((1u << lane) - 1u))] = lane;
        __syncthreads();
        qweight += (int64_t)e * kwords * N;
        scales += (int64_t)e * G * ldsz;
        zeros += (int64_t)e * G * ldsz;
        ticket_ctr += blockIdx.z * gridDim.x;
    }
    auto row = [&](int m) -> int {           // block row m's row of x and out
        if constexpr (ROUTED)
            return pair_of[m];
        else
            return m;
    };

    // ANY_GS: scales and zeros in 16-byte copies (rows of 16-column multiples)
    [[maybe_unused]] const bool wide = ldsz % 16 == 0 && N % 16 == 0;
    auto fetch = [&](int tile, unsigned char* st) {
        const int kt = k0 + tile * BK;
        int32_t* wsm = reinterpret_cast<int32_t*>(st + L::W);
        for (int c = tid; c < GV_WROWS * (GV_BN / 4); c += GV_THREADS) {
            const int r = c / (GV_BN / 4), q = c % (GV_BN / 4);
            const int kw = kt / P + r, n = n0 + 4 * q;
            const bool ok = kw < kwords && n < N;
            cp_async16_zfill(wsm + r * GV_LDW + 4 * q, ok ? qweight + words(kw, n) : qweight,
                             ok);
        }
        const int g0 = kt / gs;
        const int ng = min(G - 1, (min(kt + BK, k1) - 1) / gs) - g0 + 1;   // <= ngroups
        __half* ss = reinterpret_cast<__half*>(st + L::S);
        uint8_t* zs = st + zoff;
        if constexpr (ANY_GS) {
            uint8_t* ix = st + ixoff;                // each K row's group row (rows past the
            for (int r = tid; r < BK; r += GV_THREADS)   // split take its last one's)
                ix[r] = (uint8_t)(min(kt + r, k1 - 1) / gs - g0);
            if (wide) {                              // many short group rows: 16-byte copies
                for (int c = tid; c < ng * (GV_BN / 8 + GV_BN / 16); c += GV_THREADS) {
                    const bool sc = c < ng * (GV_BN / 8);
                    const int c2 = sc ? c : c - ng * (GV_BN / 8);
                    const int per = sc ? GV_BN / 8 : GV_BN / 16, cols = sc ? 8 : 16;
                    const int r = c2 / per, n = n0 + cols * (c2 % per);
                    const bool ok = n < N;
                    const int64_t at = (int64_t)(g0 + r) * ldsz + n;
                    if (sc)
                        cp_async16_zfill(ss + r * GV_BN + (n - n0), ok ? scales + at : scales, ok);
                    else
                        cp_async16_zfill(zs + r * GV_BN + (n - n0), ok ? zeros + at : zeros, ok);
                }
                return;
            }
        }
        for (int c = tid; c < ng * (GV_BN / 2 + GV_BN / 4); c += GV_THREADS) {
            if (c < ng * (GV_BN / 2)) {              // scales, 2 columns per copy
                const int r = c / (GV_BN / 2), q = c % (GV_BN / 2);
                const int n = n0 + 2 * q;
                const bool ok = n < N;
                cp_async4_zfill(ss + r * GV_BN + 2 * q,
                                ok ? scales + (int64_t)(g0 + r) * ldsz + n : scales, ok);
            } else {                                 // zeros, 4 columns per copy
                const int c2 = c - ng * (GV_BN / 2);
                const int r = c2 / (GV_BN / 4), q = c2 % (GV_BN / 4);
                const int n = n0 + 4 * q;
                const bool ok = n < N;
                cp_async4_zfill(zs + r * GV_BN + 4 * q,
                                ok ? zeros + (int64_t)(g0 + r) * ldsz + n : zeros, ok);
            }
        }
    };

    // x[row(m), k0 .. k0 + kc) in slot order (rows past K zero). Rows past `rows` are left as
    // they are: they feed only output rows that are never written. Without kperm the rows are
    // copied as they are by cp.async, one commit group ahead of the weight stages, and each
    // 16-row step is then put in slot order in place; with kperm each step's sorted rows are
    // gathered by register loads, the step's indices read once for four rows of x.
    const int nsteps = kc / 16;
    auto store_x = [&](int m, int step, const T (&v)[16]) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(xs + m * ldx + 16 * step);
#pragma unroll
        for (int s = 0; s < 16; s += 2)
            dst[s / 2] = bits16(v[perm_slot<BITS>(s)]) | (bits16(v[perm_slot<BITS>(s + 1)]) << 16);
    };
    // PRENORM: the chunk's norm weight [kc] of type pn.wdt, after the x stage
    unsigned char* const nws = reinterpret_cast<unsigned char*>(xs) + gv_x_bytes(MT, kc);
    if (!gather) {                               // K % 8 == 0, x 16-byte aligned
        for (int c = tid; c < rows * (kc / 8); c += GV_THREADS) {
            const int m = c / (kc / 8), q = c - m * (kc / 8);
            const int k = k0 + 8 * q;
            cp_async16_zfill(xs + m * ldx + 8 * q, k < K ? x + (int64_t)row(m) * K + k : x,
                             k < K);
        }
        if constexpr (PRENORM) {                 // pn.w 16-byte aligned too (gv_gather)
            const int wsz = prenorm_wsize(pn.wdt), per = 16 / wsz;
            const unsigned char* w = static_cast<const unsigned char*>(pn.w);
            for (int c = tid; c < kc / per; c += GV_THREADS) {
                const int k = k0 + c * per;      // K % 8 == 0: a copy lies inside K or past it
                cp_async16_zfill(nws + c * 16, k < K ? w + (int64_t)k * wsz : w, k < K);
            }
        }
    }
    cp_async_commit();

#pragma unroll
    for (int s = 0; s < GV_STAGES - 1; ++s) {
        if (s < ntiles) fetch(s, smem + s * sbytes);
        cp_async_commit();   // one group per stage, empty past the end: wait counts alike
    }
    if constexpr (PRENORM) {                     // the launch before this one wrote it
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
        if (tid < rows) rstd[tid] = pn.rstd[tid];
        __syncthreads();
    }
    // x_n of row m, K rows kb.. of a step (past K: left as staged, zero), the chunk's norm
    // weight already in f32 (gv_norm_weights_f32)
    auto normalize = [&](int m, int kb, T (&v)[16]) {
        if constexpr (PRENORM) {
            const float4* w4 = reinterpret_cast<const float4*>(nws) + (kb - k0) / 4;
            float w[16];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 t = w4[q];
                w[4 * q] = t.x;
                w[4 * q + 1] = t.y;
                w[4 * q + 2] = t.z;
                w[4 * q + 3] = t.w;
            }
            const float r = rstd[m];
#pragma unroll
            for (int i = 0; i < 16; ++i)
                if (kb + i < K) v[i] = prenorm_apply(v[i], r, w[i]);
        }
    };
    if (!gather) {
        cp_async_wait<GV_STAGES - 1>();          // x has landed; the weight stages may still fly
        __syncthreads();
        if constexpr (PRENORM) gv_norm_weights_f32(nws, pn, kc);
        for (int it = tid; it < rows * nsteps; it += GV_THREADS) {
            const int m = it / nsteps, step = it - m * nsteps;
            const uint4* src = reinterpret_cast<const uint4*>(xs + m * ldx + 16 * step);
            const uint4 raw[2] = {src[0], src[1]};
            T v[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) v[i] = reinterpret_cast<const T*>(raw)[i];
            normalize(m, k0 + 16 * step, v);
            store_x(m, step, v);                 // this thread's own 32 bytes: in place
        }
    } else {
        const int mq = (rows + 3) / 4;
        for (int it = tid; it < nsteps * mq; it += GV_THREADS) {
            const int step = it / mq, m0 = 4 * (it - step * mq);
            const int kb = k0 + 16 * step;
            int src[16];
#pragma unroll
            for (int i = 0; i < 16; ++i)
                src[i] = kb + i < K ? (kperm != nullptr ? (int)kperm[kb + i] : kb + i) : -1;
            T v[4][16];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    v[r][i] = m0 + r < rows && src[i] >= 0
                                  ? x[(int64_t)row(m0 + r) * K + src[i]] : from_f32<T>(0.0f);
                    if constexpr (PRENORM)   // the norm weight of x's own column
                        if (m0 + r < rows && src[i] >= 0)
                            v[r][i] = prenorm_apply(v[r][i], rstd[m0 + r],
                                                    prenorm_weight(pn, src[i]));
                }
#pragma unroll
            for (int r = 0; r < 4; ++r)
                if (m0 + r < rows) store_x(m0 + r, step, v[r]);
        }
    }

    const int g8 = lane >> 2;                    // A rows g8, g8 + 8: columns wcol, wcol + 1
    const int t = lane & 3;
    const int wcol = (tid >> 5) * 16 + 2 * g8;   // within the block's 64 columns
    const int wrow = t / (P / 4);                // word row within a 16-row step
    const int sh = BITS * (t % (P / 4));         // the thread's first code in that word
    // ldmatrix rows: lane l addresses row l % 8 (+ 8 for the x4's matrices 2, 3) of x, slots
    // 8 * ((l / 8) % 2) onwards of the step
    const int xrow = min((lane & 7) + (MT == 16 ? 8 * ((lane >> 4) & 1) : 0), xrows - 1);
    const T* xl = xs + xrow * ldx + 8 * ((lane >> 3) & 1);

    // part[0] takes the even steps and part[1] the odd ones, two independent MMA chains
    float acc[NT][4], part[2][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = part[0][j][c] = part[1][j][c] = 0.0f;

    typename C::Zero zz0 = {}, zz1 = {};
    auto zeros_of = [&](const uint8_t* zrow) {   // the group's zeros of columns wcol, wcol + 1
        const uint32_t z2 = *reinterpret_cast<const uint16_t*>(zrow + wcol);
        zz0 = C::zero(z2 & 0xFFu);
        zz1 = C::zero(z2 >> 8);
    };
    auto step = [&](const uint32_t* wp, const T* xp, float (&p)[NT][4]) {
        const uint2 w = *reinterpret_cast<const uint2*>(wp);
        uint32_t a[4];
        C::pairs(w.x, sh, zz0, a[0], a[2]);
        C::pairs(w.y, sh, zz1, a[1], a[3]);
        uint32_t b[4];
        if constexpr (MT == 16)
            ldmatrix_x4(b, xp);
        else
            ldmatrix_x2(b, xp);
#pragma unroll
        for (int j = 0; j < NT; ++j) Mma<T>::run(p[j], a, b[2 * j], b[2 * j + 1]);
    };
    auto fold = [&](const __half* srow) {        // the group ends: fold its scale in
        const __half2 s2 = *reinterpret_cast<const __half2*>(srow + wcol);
        const float s0 = __low2float(s2), s1 = __high2float(s2);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            acc[j][0] = fmaf(part[0][j][0] + part[1][j][0], s0, acc[j][0]);
            acc[j][1] = fmaf(part[0][j][1] + part[1][j][1], s0, acc[j][1]);
            acc[j][2] = fmaf(part[0][j][2] + part[1][j][2], s1, acc[j][2]);
            acc[j][3] = fmaf(part[0][j][3] + part[1][j][3], s1, acc[j][3]);
#pragma unroll
            for (int c = 0; c < 4; ++c) part[0][j][c] = part[1][j][c] = 0.0f;
        }
    };

    if constexpr (!ANY_GS) {
        const int gsteps = gs / 16;
        int gcur = k0 / gs;                          // the group of the current step
        int left = gsteps - (k0 % gs) / 16;          // its steps still to come
        bool fresh = true;                           // its zeros are still to be read
        for (int tile = 0; tile < ntiles; ++tile) {
            cp_async_wait<GV_STAGES - 2>();      // this thread's copies of the tile have landed
            __syncthreads();                     // everyone's have, the previous stage is free
            const int nxt = tile + GV_STAGES - 1;
            if (nxt < ntiles) fetch(nxt, smem + (nxt % GV_STAGES) * L::BYTES);
            cp_async_commit();

            const unsigned char* st = smem + (tile % GV_STAGES) * L::BYTES;
            const uint32_t* wp =
                reinterpret_cast<const uint32_t*>(st + L::W) + wrow * GV_LDW + wcol;
            const __half* ss = reinterpret_cast<const __half*>(st + L::S);
            const uint8_t* zs = st + L::Z;
            const int kt = k0 + tile * BK;
            const T* xp = xl + (kt - k0);
            const int grow0 = gcur - kt / gs;        // the current group's row in the stage
            if (left >= BK / 16 && kt + BK <= k1) {  // the whole stage lies in the current group
                if (fresh) zeros_of(zs + grow0 * GV_BN);
                fresh = false;
#pragma unroll
                for (int ks = 0; ks < BK / 16; ++ks)
                    step(wp + (ks * 16 / P) * GV_LDW, xp + 16 * ks, part[ks & 1]);
                left -= BK / 16;
                if (left == 0 || kt + BK >= k1) fold(ss + grow0 * GV_BN);
                if (left == 0) {
                    ++gcur;
                    left = gsteps;
                    fresh = true;
                }
                continue;
            }
#pragma unroll
            for (int ks = 0; ks < BK / 16; ++ks) {   // a group starts or the split ends inside
                const int k16 = kt + 16 * ks;
                if (k16 >= k1) break;                // uniform over the block
                const int grow = gcur - kt / gs;
                if (fresh) zeros_of(zs + grow * GV_BN);
                fresh = false;
                step(wp + (ks * 16 / P) * GV_LDW, xp + 16 * ks, part[ks & 1]);
                if (--left == 0 || k16 + 16 >= k1) fold(ss + grow * GV_BN);
                if (left == 0) {
                    ++gcur;
                    left = gsteps;
                    fresh = true;
                }
            }
        }
    } else {
        for (int i = tid; i < 17 * 4; i += GV_THREADS) {   // read after the loop's first barrier
            const int r = i / 4, q = i % 4;
            auto from = [&](int slot, uint32_t bits) {
                return perm_slot<BITS>(slot) >= r ? bits : 0u;
            };
            ge_mask[i] = make_uint2(from(2 * q, 0xFFFFu) | from(2 * q + 1, 0xFFFF0000u),
                                    from(2 * q + 8, 0xFFFFu) | from(2 * q + 9, 0xFFFF0000u));
        }
        // the K rows (within a step) of the thread's slots: pair e = 0 holds slots 2t, 2t + 1
        // (low, high half), e = 1 slots 2t + 8, 2t + 9
        const int r0 = perm_slot<BITS>(2 * t), r1 = perm_slot<BITS>(2 * t + 1);
        const int r8 = perm_slot<BITS>(2 * t + 8), r9 = perm_slot<BITS>(2 * t + 9);
        int gcur = k0 / gs;                          // the current group: K rows [glo, ghi)
        int glo = gcur * gs, ghi = min(glo + gs, K);
        bool fresh = true;                           // its zeros are still to be read
        bool live = false;                           // part[0] holds some of its product
        auto next_group = [&]() {
            ++gcur;
            glo = ghi;
            ghi = min(ghi + gs, K);
            fresh = true;
        };
        for (int tile = 0; tile < ntiles; ++tile) {
            cp_async_wait<GV_STAGES - 2>();
            __syncthreads();
            const int nxt = tile + GV_STAGES - 1;
            if (nxt < ntiles) fetch(nxt, smem + (nxt % GV_STAGES) * sbytes);
            cp_async_commit();

            const unsigned char* st = smem + (tile % GV_STAGES) * sbytes;
            const uint32_t* wp =
                reinterpret_cast<const uint32_t*>(st + L::W) + wrow * GV_LDW + wcol;
            const __half* ss = reinterpret_cast<const __half*>(st + L::S);
            const uint8_t* zs = st + zoff;
            const int kt = k0 + tile * BK;
            const int g0 = kt / gs;                  // the stage's first group row
            const T* xp = xl + (kt - k0);
            // each step's words and x fragments are read one step ahead
            auto load = [&](int ks, uint2& w, uint32_t (&b)[4]) {
                w = *reinterpret_cast<const uint2*>(wp + (ks * 16 / P) * GV_LDW);
                if constexpr (MT == 16)
                    ldmatrix_x4(b, xp + 16 * ks);
                else
                    ldmatrix_x2(b, xp + 16 * ks);
            };
            uint2 wn;
            uint32_t bn[4];
            load(0, wn, bn);
            const int nst = (min(kt + BK, k1) - kt + 15) / 16;   // the tile's steps
            // The loops stay rolled and the products go into one chain, part[0]: the body
            // is large, and unrolled copies of it overflow the instruction cache.
#pragma unroll 1
            for (int ks = 0; ks < nst; ++ks) {
                const int k16 = kt + 16 * ks;
                const uint2 w = wn;
                const uint32_t b[4] = {bn[0], bn[1], bn[2], bn[3]};
                if (ks + 1 < nst) load(ks + 1, wn, bn);
                uint32_t a[4];
                if (k16 + 16 <= ghi) {               // the step lies in the current group
                    if (fresh) zeros_of(zs + (gcur - g0) * GV_BN);
                    fresh = false;
                    C::pairs(w.x, sh, zz0, a[0], a[2]);
                    C::pairs(w.y, sh, zz1, a[1], a[3]);
#pragma unroll
                    for (int j = 0; j < NT; ++j)
                        Mma<T>::run(part[0][j], a, b[2 * j], b[2 * j + 1]);
                    live = true;
                    if (k16 + 16 == ghi || k16 + 16 >= k1) {   // the group or the split ends
                        fold(ss + (gcur - g0) * GV_BN);
                        live = false;
                    }
                    if (k16 + 16 == ghi) next_group();
                    continue;
                }
                // The step spans groups (or K ends inside it), exact: its codes are decoded
                // once, each slot with its own group's zero (the stage holds each row's group
                // row in ix; q - z in the MMA, as above), then one MMA set per group: x with the
                // slots of other groups' rows masked to 0 (the mask follows perm_slot,
                // ge[lo] & ~ge[hi]). A set whose group ends in the step (or the split does)
                // multiplies from a zero accumulator and folds in at once, with the group's
                // earlier part if any; a last set whose group goes on becomes its first part.
                const uint8_t* ix = st + ixoff + (k16 - kt);
                const int rs[4] = {r0, r1, r8, r9};
                uint32_t z2[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    z2[i] = *reinterpret_cast<const uint16_t*>(zs + ix[rs[i]] * GV_BN + wcol);
                fresh = true;                        // the fast path reloads its group's zeros
                C::slot_pairs(w, sh, z2[0], z2[1], z2[2], z2[3], a);
                const int kend = min(k16 + 16, k1);
#pragma unroll 1
                for (;;) {
                    const uint2 m_lo = ge_mask[max(glo - k16, 0) * 4 + t];
                    const uint2 m_hi = ge_mask[min(ghi - k16, 16) * 4 + t];
                    const uint32_t m0 = m_lo.x & ~m_hi.x, m8 = m_lo.y & ~m_hi.y;
                    const bool ends = ghi <= k16 + 16;   // the group's last row is in the step
                    if (ends || k16 + 16 >= k1) {
                        const __half2 s2 =
                            *reinterpret_cast<const __half2*>(ss + (gcur - g0) * GV_BN + wcol);
                        const float s0 = __low2float(s2), s1 = __high2float(s2);
#pragma unroll
                        for (int j = 0; j < NT; ++j) {
                            float d[4];
                            Mma<T>::run0(d, a, b[2 * j] & m0, b[2 * j + 1] & m8);
#pragma unroll
                            for (int c = 0; c < 4; ++c) {
                                if (live) d[c] += part[0][j][c];
                                acc[j][c] = fmaf(d[c], c < 2 ? s0 : s1, acc[j][c]);
                                part[0][j][c] = 0.0f;
                            }
                        }
                        live = false;
                    } else {
#pragma unroll
                        for (int j = 0; j < NT; ++j)
                            Mma<T>::run(part[0][j], a, b[2 * j] & m0, b[2 * j + 1] & m8);
                        live = true;
                    }
                    if (!ends) break;
                    ++gcur;
                    glo = ghi;
                    ghi = min(ghi + gs, K);
                    if (glo >= kend) break;
                }
            }
        }
    }
    cp_async_wait<0>();

    // acc[j][h] is row 8j + 2t + h of column wcol, acc[j][2 + h] of column wcol + 1
    const int n = n0 + wcol;                     // N % 4 == 0: n < N means n + 1 < N
    if (splits == 1) {
        if (n < N) {
            const float b0 = bias != nullptr ? to_f32(bias[n]) : 0.0f;
            const float b1 = bias != nullptr ? to_f32(bias[n + 1]) : 0.0f;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int m = 8 * j + 2 * t + h;
                    if (m < rows)
                        store2(out + (int64_t)row(m) * N + n, acc[j][h] + b0, acc[j][2 + h] + b1);
                }
        }
        return;
    }
    if (n < N) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = 8 * j + 2 * t + h;
                if (m < rows)
                    *reinterpret_cast<float2*>(ws + ((int64_t)split * M + row(m)) * N + n) =
                        make_float2(acc[j][h], acc[j][2 + h]);
            }
    }
    // The ticket: after the barrier, one acquire-release add by thread 0 publishes the block's
    // partial (release covers the writes the barrier ordered before it) and, for the last
    // block, makes every other split's partial visible to the reads after the next barrier.
    __syncthreads();
    if (tid == 0) {
        int ticket;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(ticket) : "l"(ticket_ctr) : "memory");
        last_block = ticket == splits - 1;
        if (last_block) *ticket_ctr = 0;         // every split of the tile has its ticket
    }
    __syncthreads();
    if (!last_block) return;
    // The partials of the column tile in split order (through L2), the bias, one cast.
    constexpr int UNROLL = 8;
    for (int i = tid; i < rows * (GV_BN / 2); i += GV_THREADS) {
        const int m = row(i / (GV_BN / 2));
        const int nn = n0 + 2 * (i % (GV_BN / 2));
        if (nn >= N) continue;
        const float* p = ws + (int64_t)m * N + nn;
        const int64_t stride = (int64_t)M * N;
        float v0 = 0.0f, v1 = 0.0f;
        for (int s0 = 0; s0 < splits; s0 += UNROLL) {
            float2 pv[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                pv[u] = __ldcg(reinterpret_cast<const float2*>(p + min(s0 + u, splits - 1) * stride));
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                if (s0 + u < splits) {
                    v0 += pv[u].x;
                    v1 += pv[u].y;
                }
        }
        if (bias != nullptr) {
            v0 += to_f32(bias[nn]);
            v1 += to_f32(bias[nn + 1]);
        }
        store2(out + (int64_t)m * N + nn, v0, v1);
    }
}

// K1/K4/K5: GPTQ words [K/P, N], scales and zeros [G, N]; PRENORM (K1 only) with the fused
// RMS-norm prologue; ANY_GS for the group sizes 16 does not divide.
template <int BITS, typename T, int MT, bool PRENORM = false, bool ANY_GS = false>
__global__ void __launch_bounds__(GV_THREADS, 4)
wna16_gemv_kernel(const T* __restrict__ x, const int64_t* __restrict__ kperm,
                  const int32_t* __restrict__ qweight, const __half* __restrict__ scales,
                  const uint8_t* __restrict__ zeros, const T* __restrict__ bias,
                  T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                  int M, int K, int N, int gs, int kc, int splits, int gather, Prenorm pn) {
    gemv_block<BITS, T, MT, GptqWords, false, PRENORM, ANY_GS>(
        x, kperm, qweight, scales, zeros, bias, out, ws, counters, nullptr, nullptr, M, K, N, gs,
        kc, splits, gather, GptqWords{N}, N, 1, MT, pn);
}

// Whether x must be gathered by register loads (kperm, or rows not in 16-byte copies; with the
// fused prologue also a norm weight that is not 16-byte aligned).
inline int gv_gather(const void* x, const int64_t* kperm, int K, const void* nw = nullptr) {
    return kperm != nullptr || K % 8 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
           (reinterpret_cast<uintptr_t>(nw) & 15) != 0;
}

// Dynamic shared memory of a GEMV block at group size gs; the fused prologue adds its chunk of
// norm weight.
template <int BITS, bool PRENORM>
constexpr int gv_block_smem(int mt, int kc, int gs) {
    return gv_smem_bytes<BITS>(mt, kc, gs) + (PRENORM ? kc * 4 : 0);
}

// The checks every GEMV entry makes on its plan: kc rows per split (whole 16-row steps), splits
// of them cover K once.
inline bool gv_plan_ok(int K, int gs, int kc, int splits, const float* ws, const int* counters) {
    return gs > 0 && kc > 0 && kc % 16 == 0 && splits > 0 &&
           splits <= GV_MAX_SPLITS && (int64_t)(splits - 1) * kc < K && (int64_t)splits * kc >= K &&
           (splits == 1 || (ws != nullptr && counters != nullptr));
}

template <int BITS, typename T, int MT, bool PRENORM, bool ANY_GS>
cudaError_t launch_gemv(const void* x, const int64_t* kperm, const int32_t* qweight,
                        const __half* scales, const uint8_t* zeros, const void* bias, void* out,
                        float* ws, int* counters, int M, int K, int N, int gs, int kc, int splits,
                        cudaStream_t stream, Prenorm pn) {
    static const cudaError_t attr = allow_smem(wna16_gemv_kernel<BITS, T, MT, PRENORM, ANY_GS>,
                                               GV_SMEM_LIMIT);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((N + GV_BN - 1) / GV_BN, splits);
    const int smem = gv_block_smem<BITS, PRENORM>(MT, kc, gs);
    const int gather = gv_gather(x, kperm, K, PRENORM ? pn.w : nullptr);
    if constexpr (PRENORM) {                     // may start while wg_rstd_kernel runs
        cudaLaunchAttribute pdl[1];
        pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        pdl[0].val.programmaticStreamSerializationAllowed = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(GV_THREADS);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        cfg.attrs = pdl;
        cfg.numAttrs = 1;
        return cudaLaunchKernelEx(&cfg, wna16_gemv_kernel<BITS, T, MT, PRENORM, ANY_GS>,
                                  static_cast<const T*>(x), kperm, qweight, scales, zeros,
                                  static_cast<const T*>(bias), static_cast<T*>(out), ws, counters,
                                  M, K, N, gs, kc, splits, gather, pn);
    }
    wna16_gemv_kernel<BITS, T, MT, PRENORM, ANY_GS><<<grid, GV_THREADS, smem, stream>>>(
        static_cast<const T*>(x), kperm, qweight, scales, zeros, static_cast<const T*>(bias),
        static_cast<T*>(out), ws, counters, M, K, N, gs, kc, splits, gather, pn);
    return cudaGetLastError();
}

template <int BITS, typename T, bool PRENORM, bool ANY_GS>
cudaError_t launch_gemv_rows(const void* x, const int64_t* kperm, const int32_t* qweight,
                             const __half* scales, const uint8_t* zeros, const void* bias,
                             void* out, float* ws, int* counters, int M, int K, int N, int gs,
                             int kc, int splits, cudaStream_t stream, Prenorm pn) {
    if (M <= 8)
        return launch_gemv<BITS, T, 8, PRENORM, ANY_GS>(x, kperm, qweight, scales, zeros, bias,
                                                        out, ws, counters, M, K, N, gs, kc,
                                                        splits, stream, pn);
    return launch_gemv<BITS, T, 16, PRENORM, ANY_GS>(x, kperm, qweight, scales, zeros, bias, out,
                                                     ws, counters, M, K, N, gs, kc, splits,
                                                     stream, pn);
}

template <int BITS, bool PRENORM, bool ANY_GS>
int launch_gemv_dtype(const void* x, const int64_t* kperm, const int32_t* qweight,
                      const void* scales, const uint8_t* zeros, const void* bias, void* out,
                      float* ws, int* counters, int dtype, int M, int K, int N, int gs, int kc,
                      int splits, void* stream, Prenorm pn) {
    const __half* s = static_cast<const __half*>(scales);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DT_F16:
            return (int)launch_gemv_rows<BITS, __half, PRENORM, ANY_GS>(
                x, kperm, qweight, s, zeros, bias, out, ws, counters, M, K, N, gs, kc, splits, st,
                pn);
        case DT_BF16:
            return (int)launch_gemv_rows<BITS, __nv_bfloat16, PRENORM, ANY_GS>(
                x, kperm, qweight, s, zeros, bias, out, ws, counters, M, K, N, gs, kc, splits, st,
                pn);
        default:   // f32 activations take the SIMT GEMV
            return (int)cudaErrorInvalidValue;
    }
}

// The GEMV over GPTQ words [K/P, N] (K1, K4, K5): kc K rows per split, splits of them;
// PRENORM with the fused RMS-norm prologue (16 | gs). A group size that 16 does not divide takes
// the ANY_GS instance.
template <int BITS, bool PRENORM = false>
int wna16_gemm_gemv(const void* x, const int64_t* kperm, const int32_t* qweight,
                    const void* scales, const uint8_t* zeros, const void* bias, void* out,
                    float* ws, int* counters, int dtype, int M, int K, int N, int gs, int kc,
                    int splits, void* stream, Prenorm pn = Prenorm{}) {
    constexpr int P = 32 / BITS;
    if (M <= 0 || M > 16 || K <= 0 || N <= 0 || K % P != 0 || N % 4 != 0 ||
        !gv_plan_ok(K, gs, kc, splits, ws, counters) ||
        gv_block_smem<BITS, PRENORM>(M <= 8 ? 8 : 16, kc, gs) > GV_SMEM_LIMIT ||
        (PRENORM && (!prenorm_ok(M, pn) || gs % 16 != 0 || pn.rstd == nullptr)))
        return (int)cudaErrorInvalidValue;
    if constexpr (!PRENORM) {
        if (gs % 16 != 0)
            return launch_gemv_dtype<BITS, false, true>(x, kperm, qweight, scales, zeros, bias,
                                                        out, ws, counters, dtype, M, K, N, gs, kc,
                                                        splits, stream, pn);
    }
    return launch_gemv_dtype<BITS, PRENORM, false>(x, kperm, qweight, scales, zeros, bias, out, ws,
                                                   counters, dtype, M, K, N, gs, kc, splits,
                                                   stream, pn);
}

// Blocks of the GEMV one SM holds at once (the CUDA occupancy calculator over its registers
// and shared memory) for `dtype`, M rows, a K chunk of kc rows and group size gs (the ANY_GS
// instance and its stage where 16 does not divide gs).
template <int BITS>
int wna16_gemv_occupancy(int dtype, int M, int kc, int gs, int* blocks) {
    if (M <= 0 || M > 16 || kc <= 0 || gs <= 0 || blocks == nullptr)
        return (int)cudaErrorInvalidValue;
    const size_t smem = gv_smem_bytes<BITS>(M <= 8 ? 8 : 16, kc, gs);
    auto occ = [&](auto kernel) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, GV_THREADS, smem);
    };
    const bool any = gs % 16 != 0, m8 = M <= 8;
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == DT_BF16) {
        using B = __nv_bfloat16;
        err = any ? (m8 ? occ(wna16_gemv_kernel<BITS, B, 8, false, true>)
                        : occ(wna16_gemv_kernel<BITS, B, 16, false, true>))
                  : (m8 ? occ(wna16_gemv_kernel<BITS, B, 8>) : occ(wna16_gemv_kernel<BITS, B, 16>));
    } else if (dtype == DT_F16) {
        using H = __half;
        err = any ? (m8 ? occ(wna16_gemv_kernel<BITS, H, 8, false, true>)
                        : occ(wna16_gemv_kernel<BITS, H, 16, false, true>))
                  : (m8 ? occ(wna16_gemv_kernel<BITS, H, 8>) : occ(wna16_gemv_kernel<BITS, H, 16>));
    }
    return (int)err;
}

}  // namespace

// Exports `int NAME_gemv(...)`, the tensor-core decode GEMV over GPTQ words of BITS-bit codes,
// and `int NAME_gemv_occupancy(dtype, M, kc, gs, int* blocks)`.
#define WNA16_GEMV_DEFINE_ENTRY(NAME, BITS)                                                     \
    extern "C" int NAME##_gemv(const void* x, const int64_t* kperm, const int32_t* qweight,     \
                               const void* scales, const uint8_t* zeros, const void* bias,      \
                               void* out, float* ws, int* counters, int dtype, int M, int K,    \
                               int N, int gs, int kc, int splits, void* stream) {               \
        return wna16_gemm_gemv<BITS>(x, kperm, qweight, scales, zeros, bias, out, ws, counters, \
                                     dtype, M, K, N, gs, kc, splits, stream);                   \
    }                                                                                           \
    extern "C" int NAME##_gemv_occupancy(int dtype, int M, int kc, int gs, int* blocks) {       \
        return wna16_gemv_occupancy<BITS>(dtype, M, kc, gs, blocks);                            \
    }

// Exports `int NAME_gemv_norm(...)`: the tensor-core decode GEMV with the fused RMS-norm
// prologue, the arguments of NAME_gemv with room for the rows' rstd [M] after the counters and
// the norm weight, its dtype code, eps and plus_one before the stream. It launches
// wg_rstd_kernel into that room (NAME_wgmma_norm_rstd's kernel; x 16-byte aligned), then the
// GEMV, which waits for it.
#define WNA16_GEMV_NORM_DEFINE_ENTRY(NAME, BITS)                                                \
    extern "C" int NAME##_gemv_norm(const void* x, const int64_t* kperm,                        \
                                    const int32_t* qweight, const void* scales,                 \
                                    const uint8_t* zeros, const void* bias, void* out,          \
                                    float* ws, int* counters, float* rstd, int dtype, int M,    \
                                    int K, int N, int gs, int kc, int splits, const void* nw,   \
                                    int nw_dtype, float eps, int plus_one, void* stream) {      \
        const int code = wg_rstd(x, rstd, dtype, M, K, eps, stream);                            \
        if (code != 0) return code;                                                             \
        return wna16_gemm_gemv<BITS, true>(x, kperm, qweight, scales, zeros, bias, out, ws,     \
                                           counters, dtype, M, K, N, gs, kc, splits, stream,    \
                                           Prenorm{nw, nw_dtype, eps, plus_one, rstd});         \
    }
