// The port's tile-contiguous "kb32l" runtime layout of 4-bit words (ops/quantlinear.py,
// kb32l_pack), read by K6 (w4a16_kb32l_gemm.cu) in both regimes and by K10
// (wna16_gemm_t.cuh) for the backward.
//
// Words are GPTQ's K-packed 4-bit words (row 8*r+j of a column in bits 4j..4j+3, 3-bit codes
// in nibbles), cut into tiles of KB32L_KB K rows by KB32L_BN columns. Each tile is one
// contiguous span of KB32L_WR x KB32L_BN int32 words (16 KB), row-major inside, and tiles are
// ordered column tile first, then K: tile (j, kb) starts at word (j * nbk + kb) * 4096, with
// nbk = K_pad / KB32L_KB. N is padded to KB32L_BN with zero-scale columns and K to KB32L_KB
// with zero-scale groups, so a padded word contributes exactly 0. The counterpart of the
// JAX package's kb32l storage (autogptq_tpu/ops/quantlinear.py:434-443), with tiles sized for
// an SM's shared memory instead of a TPU core's VMEM.

#pragma once

#include <stdint.h>

namespace {

constexpr int KB32L_KB = 256;                              // K rows per tile
constexpr int KB32L_BN = 128;                              // columns per tile
constexpr int KB32L_WR = KB32L_KB / 8;                     // word rows per tile
constexpr int KB32L_TILE_WORDS = KB32L_WR * KB32L_BN;      // 4096 int32 words, 16 KB

// Offset in words of word row kw (K rows 8*kw..8*kw+7) of column n.
__device__ __forceinline__ int64_t kb32l_word(int kw, int n, int nbk) {
    const int tile = (n / KB32L_BN) * nbk + kw / KB32L_WR;
    return (int64_t)tile * KB32L_TILE_WORDS + (kw % KB32L_WR) * KB32L_BN + n % KB32L_BN;
}

// The address functor of the kernels templated on the word layout (wna16_gemm.cuh:GptqWords).
struct Kb32lWords {
    int nbk;   // K tiles per column tile
    __device__ __forceinline__ int64_t operator()(int kw, int n) const {
        return kb32l_word(kw, n, nbk);
    }
};

}  // namespace
