// K5: w2a16 dequant-matmul for Hopper (sm_90a), y[M,N] = x[M,K] @ ((q - z) * s)[K,N] (+ bias),
// for 2-bit codes: int32 [K/16, N] words, 16 K rows per word.
//
// Replaces the TPU kernels autogptq_tpu/ops/pallas/gemm.py:_kernel_k2i32 (_matmul_k2i32),
// _kernel_kquad (_matmul_kquad) and the 2-bit class of the planar _kernel. Their eighth-split
// and half-split word orders serve the TPU's compiler and are not carried over: the words are
// GPTQ's own. The kernels, their layout, bound and design are in wna16_gemm.cuh, wna16_mma.cuh,
// wna16_wgmma.cuh (the wgmma/TMA tile kernel above 16 rows, w2a16_gemm_wgmma) and
// wna16_gemv.cuh (the tensor-core decode GEMV for bf16/f16); the bound is a quarter byte per
// weight plus 3 bytes per group and column.

#include "wna16_gemv.cuh"
#include "wna16_wgmma.cuh"

WNA16_DEFINE_ENTRY(w2a16_gemm, 2)
WNA16_MMA_DEFINE_ENTRY(w2a16_gemm, 2)
WNA16_WGMMA_DEFINE_ENTRY(w2a16_gemm, 2)
WNA16_GEMV_DEFINE_ENTRY(w2a16_gemm, 2)
