// K1: w4a16 dequant-matmul for Hopper (sm_90a), y[M,N] = x[M,K] @ ((q - z) * s)[K,N] (+ bias),
// for 4-bit codes, and for 3-bit codes kept in nibbles.
//
// Replaces the TPU kernels autogptq_tpu/ops/pallas/gemm.py:_kernel_kb32 (reached through
// _matmul_kb32 / matmul_pallas), _kernel_ki32 and the 3/4-bit part of _kernel_kpair, which
// every q/k/v/o/gate/up/down projection of a 3- or 4-bit model runs. The kernels, their
// layout, bound and design are in wna16_gemm.cuh, wna16_mma.cuh, wna16_wgmma.cuh (the
// wgmma/TMA tile kernel above 16 rows, w4a16_gemm_wgmma) and wna16_gemv.cuh (the
// tensor-core decode GEMV); for Llama-2-7B a 4096x4096 projection
// moves 8.6 MB and a 4096x11008 one 23.2 MB at group size 128.
//
// Each of them also has a PRENORM instance, the fused RMS-norm prologue of
// autogptq_tpu/ops/pallas/gemm.py:_prenorm_x (:332; _kernel_kb32's and _kernel_ki32's norm_w=
// operand), exported as w4a16_gemm_norm (the SIMT GEMV and tile kernel), w4a16_gemm_mma_norm,
// w4a16_gemm_wgmma_norm (the wgmma/TMA tile kernel's, the route of the 17-31 rows the prologue
// takes above the GEMV; its rows' rstd comes from w4a16_gemm_wgmma_norm_rstd, launched just
// before it) and w4a16_gemm_gemv_norm (whose entry launches that rstd kernel just before the
// GEMV). Only 3- and 4-bit layers are eligible
// (ops/gemm.py:prenorm_eligible), so only this library holds them. The prologue itself is
// described in wna16_gemm.cuh (its wgmma form in wna16_wgmma.cuh); it reads M x K activations
// per block from L2 on top of the weight stream that bounds the product (five Llama-2-7B
// q/k/v/gate/up projections at 4-bit g128 move 73.5 MB, 0.0220 ms at 3.35 TB/s).

#include "wna16_gemv.cuh"
#include "wna16_wgmma.cuh"

WNA16_DEFINE_ENTRY(w4a16_gemm, 4)
WNA16_NORM_DEFINE_ENTRY(w4a16_gemm, 4)
WNA16_MMA_DEFINE_ENTRY(w4a16_gemm, 4)
WNA16_WGMMA_DEFINE_ENTRY(w4a16_gemm, 4)
WNA16_WGMMA_NORM_DEFINE_ENTRY(w4a16_gemm, 4)
WNA16_MMA_NORM_DEFINE_ENTRY(w4a16_gemm, 4)
WNA16_GEMV_DEFINE_ENTRY(w4a16_gemm, 4)
WNA16_GEMV_NORM_DEFINE_ENTRY(w4a16_gemm, 4)
