// K10: dx[M,K] = g[M,N] @ ((q - z) * s)[K,N]^T for Hopper (sm_90a), one library with an
// entry point per storage width: w4a16_gemm_t (4-bit codes, and 3-bit codes kept in nibbles;
// the width of the TPU kernels it replaces), w8a16_gemm_t and w2a16_gemm_t, and
// w4a16_kb32l_gemm_t over K6's tile-contiguous kb32l words; each has tensor-core twins for
// bf16 and f16 cotangents, NAME_wgmma (wna16_wgmma.cuh, above 16 rows; launch key
// wna16_gemm_t_wgmma, over kb32l words w4a16_kb32l_gemm_t_wgmma), NAME_mma (wna16_mma.cuh, above
// 16 rows for shapes TMA cannot address) and NAME_gemv (wna16_gemv_t.cuh, the split-N decode
// regime at M <= 16).
//
// Replaces the TPU kernels autogptq_tpu/ops/pallas/gemm.py:_kernel_kb32_t (_matmul_kb32_t),
// _kernel_ki32_t (_matmul_ki32_t) and _kernel_kpair_t (_matmul_kpair_t). The kernels, their
// layout, bound and design are in wna16_gemm_t.cuh, wna16_mma.cuh, wna16_wgmma.cuh and
// wna16_gemv_t.cuh.

#include "wna16_gemm_t.cuh"
#include "wna16_wgmma.cuh"

WNA16_T_DEFINE_ENTRY(w4a16_gemm_t, 4)
WNA16_T_WGMMA_DEFINE_ENTRY(w4a16_gemm_t, 4)
WNA16_T_DEFINE_ENTRY(w8a16_gemm_t, 8)
WNA16_T_WGMMA_DEFINE_ENTRY(w8a16_gemm_t, 8)
WNA16_T_DEFINE_ENTRY(w2a16_gemm_t, 2)
WNA16_T_WGMMA_DEFINE_ENTRY(w2a16_gemm_t, 2)

// The same kernel over K6's tile-contiguous kb32l words (kb32l_tile.cuh).
extern "C" int w4a16_kb32l_gemm_t(const void* g, const int64_t* kperm, const int32_t* qweight,
                                  const void* scales, const uint8_t* zeros, void* dx, int dtype,
                                  int M, int K, int N, int n_pad, int gs, void* stream) {
    return kb32l_gemm_t(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, n_pad, gs, stream);
}

extern "C" int w4a16_kb32l_gemm_t_mma(const void* g, const int64_t* kperm,
                                      const int32_t* qweight, const void* scales,
                                      const uint8_t* zeros, void* dx, int dtype, int M, int K,
                                      int N, int n_pad, int gs, void* stream) {
    return kb32l_gemm_t_mma(g, kperm, qweight, scales, zeros, dx, dtype, M, K, N, n_pad, gs,
                            stream);
}

// The wgmma/TMA K10 over kb32l words (bf16, f16; M > 16, N % 8): the words through a 3-D map of
// the tiles, scales and zeros n_pad wide; bm, stages and splits from ops/gemm.py:wgmma_plan, the
// f32 partials in ws [splits, M, K] and one ticket counter per output tile in counters.
extern "C" int w4a16_kb32l_gemm_t_wgmma(const void* g, const int64_t* kperm,
                                        const int32_t* qweight, const void* scales,
                                        const uint8_t* zeros, void* dx, float* ws, int* counters,
                                        int dtype, int M, int K, int N, int n_pad, int gs, int bm,
                                        int stages, int splits, void* stream) {
    return wna16_wgmma<4, true, true>(g, qweight, scales, zeros, nullptr, kperm, dx, ws, counters,
                                      dtype, M, K, N, gs, bm, stages, splits, stream, n_pad);
}

extern "C" int w4a16_kb32l_gemm_t_gemv(const void* g, const int64_t* kperm,
                                       const int32_t* qweight, const void* scales,
                                       const uint8_t* zeros, void* dx, float* ws, int* counters,
                                       int dtype, int M, int K, int N, int n_pad, int gs, int nc,
                                       int splits, void* stream) {
    return kb32l_gemm_t_gemv(g, kperm, qweight, scales, zeros, dx, ws, counters, dtype, M, K, N,
                             n_pad, gs, nc, splits, stream);
}

extern "C" const char* wna16_gemm_t_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
