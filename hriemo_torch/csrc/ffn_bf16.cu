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
// Three launches: the two products here, each one GEMM (bf16 on the TMA
// GEMM of csrc/tma_gemm.cuh, hr_ffn_gemms_tma; fp32 in 3xTF32 on the
// large-tile GEMM of csrc/float_wgmma.cuh, hr_ffn_gemms), then the fp32
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
// tensor-core operations, 4*M*D*F, bound the work (0.038 ms in bf16 at
// M=3992, 0.228 in fp32 as three TF32 products). At M=3992 the block takes
// 0.155 ms in bf16 with erf GELU (0.141 with tanh; 0.187 on
// csrc/float_wgmma.cuh's pipeline, which bf16 left) and 0.75 in fp32 (GEMM1
// 0.340, GEMM2 0.398, LayerNorm 0.014), against 0.32 and 0.96 for its
// cuBLAS + LayerNorm route. h's round trip is not what bounds it.
#include <type_traits>

#include "float_wgmma.cuh"
#include "tma_gemm.cuh"

using namespace hr;

extern "C" {

// x [M, D], w1 [F, D], w2 [D, F] and h [M, F] fp32, contiguous, 16-byte
// aligned; b1 [F], b2 [D] and y [M, D] fp32. D and F multiples of 32.
// Writes h and y; the caller runs the LayerNorm on y.
int hr_ffn_gemms(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 int M, int D, int F, int fast_gelu, void* h, void* y, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FloatGemmArgs g{};
  g.a = x, g.lda = D, g.w = w1, g.ldw = D, g.ktap = D;
  g.M = M, g.N = F, g.K = D, g.bias = static_cast<const float*>(b1);
  g.out = h, g.ldo = F, g.fast = fast_gelu;
  launch_float_gemm<float, kFepBiasGelu>(g, 1, s);
  g = FloatGemmArgs{};
  g.a = h, g.lda = F, g.w = w2, g.ldw = F, g.ktap = F;
  g.M = M, g.N = D, g.K = F, g.bias = static_cast<const float*>(b2);
  g.resid = x, g.ldr = D, g.out = y, g.ldo = D, g.fast = fast_gelu;
  launch_float_gemm<float, kFepResidBias>(g, 1, s);
  return (int)cudaGetLastError();
}

// The same two products in bf16 on the TMA GEMM (csrc/tma_gemm.cuh): x, w1,
// w2 and h bf16, D and F multiples of 8; bn1 / grid1 and bn2 / grid2 the
// column tile (128 or 256) and persistent blocks of each product
// (ops/_cuda.py tma_gemm_plan). Returns cudaErrorInvalidValue for arguments
// it does not take and where the driver refuses a tensor map.
int hr_ffn_gemms_tma(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, int M, int D, int F, int fast_gelu, void* h, void* y,
                     int bn1, int grid1, int bn2, int grid2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || D % 8 || F % 8 || grid1 < 1 || grid2 < 1 || (bn1 != 128 && bn1 != 256) ||
      (bn2 != 128 && bn2 != 256))
    return (int)cudaErrorInvalidValue;
  // one product: A [M, K] (row stride K), W [N, K]
  auto gemm = [&](auto epi, const void* a, const void* w, int K, int N, int bn, int grid,
                  const void* bias, const void* resid, void* out) {
    CUtensorMap am, wm;
    if (!tg_a_map(&am, a, K, M, 1, K, (long long)M * K) || !tg_w_map(&wm, w, K, N, bn))
      return (int)cudaErrorInvalidValue;
    TgArgs g{};
    g.taps = 1, g.ksteps_tap = (K + kTgBK - 1) / kTgBK, g.wrow_tap = 0;
    g.m_tiles = (M + kTgBM - 1) / kTgBM, g.n_tiles = (N + bn - 1) / bn;
    g.tiles = g.m_tiles * g.n_tiles;
    g.f.M = M, g.f.N = N, g.f.fast = fast_gelu, g.f.bias = static_cast<const float*>(bias);
    g.f.resid = resid, g.f.ldr = D, g.f.out = out, g.f.ldo = N;
    return launch_tma_gemm_bn<decltype(epi)::value>(bn, am, am, wm, wm, g, grid, s);
  };
  const int err = gemm(std::integral_constant<int, kFepBiasGelu>(), x, w1, D, F, bn1, grid1, b1,
                       nullptr, h);
  if (err != 0) return err;
  return gemm(std::integral_constant<int, kFepResidBias>(), h, w2, F, D, bn2, grid2, b2, x, y);
}

}  // extern "C"
