// Row quantization, the shared int8 GEMM and the fp32 LayerNorm pass.
//
// These are the launches from which the port builds int8_linear
// (hriemo_torch/ops/quant.py), the second product and the LayerNorm of
// ffn_block_int8 and mlp2_int8 (hriemo_torch/ops/fused_ffn.py) on their
// chain route (thin grids, the beta gates, route="chain"), the whole of the
// chain that the TMA route (csrc/ffn_tma.cu) replaces, and the
// projections of the attention kernels (hriemo_torch/ops/attention_block.py;
// the WavLM sublayer's and int8_linear's on their chain route only, their
// fused route is csrc/proj_int8.cu).
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError()
// after its launch and runs on the caller's stream.
#include "int8_gemm.cuh"

namespace hr {

// 16 bytes of a row as fp32: eight bf16 or four fp32 values.
__device__ __forceinline__ void load8or4(const __nv_bfloat16* p, float* v) { load8(p, v); }
__device__ __forceinline__ void load8or4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

// amax -> scale -> round half to even -> clip +-127, one block per row.
// div127 selects the scale formula:
//   0: max(amax, 1e-8) * (1/127)  -- the kernels' _quant_rows
//      (hriemo/ops/fused_ffn.py:66, hriemo/ops/attention_block.py:100)
//   1: max(amax, 1e-8) / 127      -- quantize_rowwise (hriemo/ops/quant.py:63)
// Rows whose length is a multiple of 16 bytes of T are read and written by
// vectors (16 bytes of x, 4 or 8 bytes of q a thread), others element by
// element; the arithmetic per element is the same.
template <typename T>
__global__ void rowquant_kernel(const T* __restrict__ x, int K, int div127,
                                int8_t* __restrict__ q, float* __restrict__ s) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = q + row * K;
  const bool vec = K % VEC == 0;
  float amax = 0.f;
  if (vec) {
    for (int i = threadIdx.x * VEC; i < K; i += blockDim.x * VEC) {
      float v[VEC];
      load8or4(xr + i, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x) amax = fmaxf(amax, fabsf(load_f(xr + i)));
  }
  amax = block_reduce<true>(amax, red);
  const float sc = div127 ? __fdiv_rn(fmaxf(amax, (float)1e-8), 127.0f) : row_scale(amax);
  const auto quant = [&](float v) { return quant_code(v, sc); };
  if (vec) {
    for (int i = threadIdx.x * VEC; i < K; i += blockDim.x * VEC) {
      float v[VEC];
      load8or4(xr + i, v);
      alignas(8) int8_t o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = quant(v[e]);
      if (VEC == 8) *reinterpret_cast<uint2*>(qr + i) = *reinterpret_cast<const uint2*>(o);
      else *reinterpret_cast<uint32_t*>(qr + i) = *reinterpret_cast<const uint32_t*>(o);
    }
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x) qr[i] = quant(load_f(xr + i));
  }
  if (threadIdx.x == 0) s[row] = sc;
}

// out = LayerNorm(y) with fp32 statistics, one block per row, stored as T
// (bf16, or fp32 for fp32 activations):
// mean = sum/N, var = sum((y-mean)^2)/N, (y-mean)*(1/sqrt(var+eps))*g + b.
template <typename T>
__global__ void layernorm_kernel(const float* __restrict__ y, const float* __restrict__ g,
                                 const float* __restrict__ b, int N, float eps,
                                 T* __restrict__ out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const float* yr = y + row * N;
  float acc = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) acc += yr[i];
  const float mean = __fdiv_rn(block_reduce<false>(acc, red), (float)N);
  acc = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float c = __fadd_rn(yr[i], -mean);
    acc = __fadd_rn(acc, __fmul_rn(c, c));
  }
  const float var = __fdiv_rn(block_reduce<false>(acc, red), (float)N);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float c = __fmul_rn(__fadd_rn(yr[i], -mean), rstd);
    out[row * N + i] = from_f<T>(__fadd_rn(__fmul_rn(c, g[i]), b[i]));
  }
}

struct GemmArgs {
  const int8_t* a;
  const float* as;
  const int8_t* w;
  const float* ws;
  const float* bias;
  const void* resid;    // bf16, or fp32 when resid_f32
  int resid_f32;
  int M, N, K;
  void* out;
  cudaStream_t stream;
};

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

template <int WG, int BN, int STAGES, bool OVERLAP, int EPI, typename RT = __nv_bfloat16>
void launch_gemm(const GemmArgs& g) {
  using T = GemmTile<WG, BN, STAGES, OVERLAP>;
  const auto kernel = int8_gemm_kernel<WG, BN, STAGES, OVERLAP, EPI, RT>;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    attr_set = true;
  }
  dim3 grid((g.N + BN - 1) / BN, (g.M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, T::SMEM, g.stream>>>(g.a, g.as, g.w, g.ws, g.bias,
                                                  static_cast<const RT*>(g.resid), g.M, g.N,
                                                  g.K, g.out);
}

// The residual epilogues in both residual types; the others read none.
template <int WG, int BN, int STAGES, bool OVERLAP, int EPI>
void launch_gemm_resid(const GemmArgs& g) {
  if (g.resid_f32) launch_gemm<WG, BN, STAGES, OVERLAP, EPI, float>(g);
  else launch_gemm<WG, BN, STAGES, OVERLAP, EPI, __nv_bfloat16>(g);
}

template <int WG, int BN, int STAGES, bool OVERLAP>
void launch_gemm_epi(const GemmArgs& g, int epi) {
  switch (epi) {
    case kEpiGeluF32: return launch_gemm<WG, BN, STAGES, OVERLAP, kEpiGeluF32>(g);
    case kEpiReluF32: return launch_gemm<WG, BN, STAGES, OVERLAP, kEpiReluF32>(g);
    case kEpiResidFirst: return launch_gemm_resid<WG, BN, STAGES, OVERLAP, kEpiResidFirst>(g);
    case kEpiResidLast: return launch_gemm_resid<WG, BN, STAGES, OVERLAP, kEpiResidLast>(g);
    case kEpiGeluErfF32: return launch_gemm<WG, BN, STAGES, OVERLAP, kEpiGeluErfF32>(g);
    case kEpiF32: return launch_gemm<WG, BN, STAGES, OVERLAP, kEpiF32>(g);
    default: return launch_gemm<WG, BN, STAGES, OVERLAP, kEpiBf16>(g);
  }
}

}  // namespace

}  // namespace hr

using namespace hr;

extern "C" {

// x: [M, K] fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); q: [M, K] int8; s: [M] fp32.
int hr_rowquant(const void* x, int x_bf16, int M, int K, int div127, void* q, void* s,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    if (x_bf16)
      rowquant_kernel<<<M, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x), K, div127,
                                         static_cast<int8_t*>(q), static_cast<float*>(s));
    else
      rowquant_kernel<<<M, 256, 0, st>>>(static_cast<const float*>(x), K, div127,
                                         static_cast<int8_t*>(q), static_cast<float*>(s));
  }
  return (int)cudaGetLastError();
}

// a: [M, K] int8, as: [M] fp32, w: [N, K] int8, ws: [N] fp32, bias: [N] fp32 or
// NULL, resid: [M, N] bf16 (resid_f32 = 0) or fp32 (1), or NULL; out: [M, N]
// bf16 (epi 0) or fp32. K % 16
// == 0 and 16-byte aligned a and w (the wrapper checks). config: the block
// configuration (0: 64x64 tiles, 4 stages; 1: 64x64, 6 stages, one wgmma
// batch in flight; 2: 128x128, 3 stages), or -1 to choose it by shape:
// 64x64 tiles with four stages, three blocks an SM, are the fastest or near
// it at most of the path's shapes; a long K on a grid of under two blocks
// an SM takes six stages with a batch in flight; 128x128 tiles (two blocks
// an SM) win at the FFN's 3072 columns over thousands of rows
// (chip_smoke.py times all three at each bare-GEMM row).
int hr_int8_gemm(const void* a, const void* as, const void* w, const void* ws,
                 const void* bias, const void* resid, int resid_f32, int M, int N, int K,
                 int epi, int config, void* out, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const GemmArgs g{static_cast<const int8_t*>(a), static_cast<const float*>(as),
                   static_cast<const int8_t*>(w), static_cast<const float*>(ws),
                   static_cast<const float*>(bias), resid, resid_f32, M, N, K, out,
                   static_cast<cudaStream_t>(stream)};
  if (config < 0) {
    const bool small_grid = ((M + 63) / 64) * ((N + 63) / 64) < 2 * sms;
    config = K >= 2048 && small_grid ? 1 : M >= 1024 && N >= 3072 ? 2 : 0;
  }
  switch (config) {
    case 0: launch_gemm_epi<1, 64, 4, false>(g, epi); break;
    case 1: launch_gemm_epi<1, 64, 6, true>(g, epi); break;
    case 2: launch_gemm_epi<2, 128, 3, false>(g, epi); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y: [M, N] fp32; g, b: [N] fp32; out: [M, N] bf16 (out_f32 = 0) or fp32 (1).
int hr_layernorm(const void* y, const void* g, const void* b, int M, int N, float eps,
                 int out_f32, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *yf = static_cast<const float*>(y), *gf = static_cast<const float*>(g),
              *bf = static_cast<const float*>(b);
  if (M > 0 && out_f32)
    layernorm_kernel<<<M, 256, 0, st>>>(yf, gf, bf, N, eps, static_cast<float*>(out));
  else if (M > 0)
    layernorm_kernel<<<M, 256, 0, st>>>(yf, gf, bf, N, eps, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
