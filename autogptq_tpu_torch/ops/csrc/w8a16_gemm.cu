// K4: w8a16 dequant-matmul for Hopper (sm_90a), y[M,N] = x[M,K] @ ((q - z) * s)[K,N] (+ bias),
// for 8-bit codes: int32 [K/4, N] words, 4 K rows per word.
//
// Replaces the TPU kernels autogptq_tpu/ops/pallas/gemm.py:_kernel (reached through
// _matmul_planar, the default for 8-bit layers) and the "koct" variant of _kernel_kpair.
// The effective zero is (stored + 1) & 255, so a stored 255 wraps to 0 and every zero fits
// the uint8 array. The kernels, their layout, bound and design are in wna16_gemm.cuh,
// wna16_mma.cuh, wna16_wgmma.cuh (the wgmma/TMA tile kernel above 16 rows, w8a16_gemm_wgmma)
// and wna16_gemv.cuh (the tensor-core decode GEMV for bf16/f16); the bound is one byte per
// weight.

#include "wna16_gemv.cuh"
#include "wna16_wgmma.cuh"

WNA16_DEFINE_ENTRY(w8a16_gemm, 8)
WNA16_MMA_DEFINE_ENTRY(w8a16_gemm, 8)
WNA16_WGMMA_DEFINE_ENTRY(w8a16_gemm, 8)
WNA16_GEMV_DEFINE_ENTRY(w8a16_gemm, 8)
