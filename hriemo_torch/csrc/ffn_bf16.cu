// Float FFN block (hriemo_torch/ops/fused_ffn.py ffn_block_bf16):
//
//   h   = T(gelu(x . W1^T + b1))      fp32 sums, fp32 bias and GELU, rounded to T
//   y   = (x + h . W2^T) + b2         fp32
//   out = T(LayerNorm(y) * g + b)     fp32 statistics
//
// over x [M, D] of type T (bf16 or fp32), torch-layout weights W1 [F, D]
// and W2 [D, F] of type T, fp32 biases and LayerNorm parameters.
//
// Replaces hriemo/ops/fused_ffn.py::_kernel_bf16 (pallas_call at :192).
// Three launches: the two products here, each one large-tile GEMM of
// csrc/float_wgmma.cuh (bf16 on wgmma, fp32 in 3xTF32), then the fp32
// LayerNorm pass of csrc/quant_gemm.cu (hr_layernorm, the int8 FFN's).
//   1. h = GEMM(x, W1) with the bias-GELU epilogue, stored [M, F] in T;
//   2. y = GEMM(h, W2) with the residual epilogue (x read in T), fp32 [M, D];
//   3. out = LayerNorm(y), stored in T.
// The TPU kernel keeps h on chip; here it makes a round trip through device
// memory: 24.5 MB written and read again in bf16 at M=3992 and F=3072, about
// 0.015 ms at 3.35 TB/s, 0.03 ms in fp32. In exchange each weight element
// staged in shared memory feeds 128 rows of a tile, where the first version
// kept h in shared memory and so could hold only 16 rows (bf16) or 8 (fp32)
// a block, each block reading both weight matrices from L2 again (about
// 2.4 GB of L2 reads at M=3992 in bf16, 9.4 GB in fp32).
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// hriemo_torch/utils/float_gemm_variants.py, PERF.md §6): the two products'
// tensor-core operations, 4*M*D*F, bound the work (0.038 ms in bf16 at M=3992,
// 0.228 in fp32 as three TF32 products), and the GEMM's pipeline holds them to
// 20-30% of that rate: at M=3992 the block takes 0.18 ms in bf16 (GEMM1 0.093,
// GEMM2 0.079, LayerNorm 0.012) and 0.75 in fp32 (0.340, 0.398, 0.014), against
// 0.32 and 0.96 for its cuBLAS + LayerNorm route. h's round trip is not what
// bounds it.
#include "float_wgmma.cuh"

namespace hr {

template <typename T>
void ffn_gemms(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               int M, int D, int F, int fast, void* h, void* y, cudaStream_t s) {
  FloatGemmArgs g{};
  g.a = x, g.lda = D, g.w = w1, g.ldw = D, g.ktap = D;
  g.M = M, g.N = F, g.K = D, g.bias = static_cast<const float*>(b1);
  g.out = h, g.ldo = F, g.fast = fast;
  launch_float_gemm<T, kFepBiasGelu>(g, 1, s);
  g = FloatGemmArgs{};
  g.a = h, g.lda = F, g.w = w2, g.ldw = F, g.ktap = F;
  g.M = M, g.N = D, g.K = F, g.bias = static_cast<const float*>(b2);
  g.resid = x, g.ldr = D, g.out = y, g.ldo = D, g.fast = fast;
  launch_float_gemm<T, kFepResidBias>(g, 1, s);
}

}  // namespace hr

using namespace hr;

extern "C" {

// x [M, D], w1 [F, D], w2 [D, F] and h [M, F]: fp32 (fp32 != 0) or bf16,
// contiguous, 16-byte aligned; b1 [F], b2 [D] and y [M, D] fp32. D and F
// multiples of 32. Writes h and y; the caller runs the LayerNorm on y.
int hr_ffn_gemms(int fp32, const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, int M, int D, int F, int fast_gelu, void* h, void* y,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    ffn_gemms<float>(x, w1, b1, w2, b2, M, D, F, fast_gelu, h, y, s);
  else
    ffn_gemms<__nv_bfloat16>(x, w1, b1, w2, b2, M, D, F, fast_gelu, h, y, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
