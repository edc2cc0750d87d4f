// W8A8 projections that quantize their own rows (hriemo_torch/ops/quant.py
// int8_linear; the projections of the two int8 attention sublayers of
// hriemo_torch/ops/attention_block.py, attention_block_int8 and
// mha_block_int8):
//
//   store:      out = epilogue<EPI>(W . quant_rows(x))            (x's rows
//               quantized by the kernels' _quant_rows, or DIV127 by
//               quantize_rowwise's max(amax, 1e-8) / 127)
//   LayerNorm:  out = LN((W . quant_rows(ctx)) * cs * ws + b + x)  (x: the
//               residual, out in x's dtype; WavLM's sublayer)
//   rounded:    out = LN(rnd(rnd((W . quant_rows(ctx)) * cs * ws + b) + x))
//               (rnd: to x's dtype; the MHA sublayer's caller adds its
//               residual to the stored output in x's dtype, then takes its
//               post-norm LayerNorm, as BERT and the fusion layers do)
//
// in one launch each, over the torch-layout int8 W [N, K]. They replace the
// chain of a row-quantize launch (csrc/quant_gemm.cu hr_rowquant), the
// shared int8 GEMM (csrc/int8_gemm.cuh) and, for the out-projection, the
// LayerNorm pass that reads the fp32 y back; with them (and the gated core
// of csrc/onepass_mma.cuh) the WavLM attention sublayer, the Pallas kernel
// hriemo/ops/attention_block.py::_kernel (:169, pallas_call at :474), is
// three launches, and int8_linear, XLA's int8 dot in the JAX package
// (hriemo/ops/quant.py:85, no Pallas kernel), one. The TPU kernel quantizes
// x (:193) and ctx (:302) in VMEM and never writes y; here neither the int8
// rows nor their scales nor the fp32 y reach device memory:
//
// - the product is csrc/cluster_gemm.cuh's: a cluster of N / BN blocks spans all N
//   columns of 64 rows (6 x 384 at N=2304; 2 x 384 or 3 x 256 at 768), x is
//   quantized once for the cluster into every block's shared memory;
// - the store epilogue applies int8_gemm.cuh's own epilogue<EPI> to the
//   accumulators in registers (kEpiBf16 for q/k/v, 1/sqrt(hd) already in q's
//   scales and bias; kEpiBf16 or kEpiF32, x's dtype, for int8_linear), so
//   the outputs are the chain's bits; the block's 64 rows are staged in the
//   freed shared memory and stored as 16-byte vectors;
// - the LayerNorm epilogue forms y = ((acc * cs) * ws + b) + x as
//   kEpiResidLast does (rounded form: the store epilogue's value rounded to
//   x's dtype, plus x, rounded again: the chain's stored output and the
//   caller's add, bit for bit), then the rows' sums: over each thread's columns in
//   order, its quad, the block's warpgroups in order, and the cluster's
//   blocks in rank order over distributed shared memory; the mean as
//   hr_layernorm takes it (an IEEE quotient), then the centred squares the
//   same way, 1 / sqrt(var + eps), and (y - mean) * rstd * g + b stored in
//   x's dtype. Only the order of the two sums differs from the pass's.
//
// What bounds them: the products' int8 tensor-core operations at the
// sublayer's rows (2 * M * K * N), and at the decoder's few rows W's bytes.
// What holds them back is what held the FFN pair's first product on the
// same blocks (now csrc/ffn_tma.cu): a block of 384 columns holds its SM alone, so its quantize, products and epilogue do not
// overlap; on a thin grid the chain's smaller blocks win, and the wrappers
// choose the route by rows (hriemo_torch/ops/_cuda.py proj_route, measured
// by chip_proj_routes.py).
#include "cluster_gemm.cuh"

namespace hr {

// Static shared memory of proj_gemm_kernel: the rows' scales, |max| bits,
// the LayerNorm's block sums and the rows' mean and rstd.
constexpr int kProjStatic = 6 * 64 * 4;
constexpr int kProjMaxDynamic = 232448 - kProjStatic;

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x, b = f.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  a = f.x, b = f.y;
}

// The two row sums of a lane's rows over its quad (the four lanes that hold
// a row's columns), in the same order in every lane.
__device__ __forceinline__ float quad_total(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A: [M, K] of T; W: [N, K] int8; ws, bias (or NULL) [N] fp32; a cluster of
// gridDim.x blocks spans N. LN: resid [M, N] of OT, ln_g, ln_b [N] fp32;
// EPI kEpiResidLast adds resid in fp32, a store epilogue (kEpiBf16,
// kEpiF32) is the rounded form. out [M, N] of OT. K % 16 == 0, N % BN == 0.
template <int BNW, int WGN, int STAGES, int WK, int MINB, int EPI, bool DIV127, bool LN,
          typename T, typename OT>
__global__ void __launch_bounds__(128 * WGN, MINB)
proj_gemm_kernel(const T* __restrict__ A, const int8_t* __restrict__ W,
                 const float* __restrict__ ws, const float* __restrict__ bias,
                 const OT* __restrict__ resid, const float* __restrict__ ln_g,
                 const float* __restrict__ ln_b, float eps, int M, int N, int K,
                 OT* __restrict__ out) {
  using C = FfnTile<BNW, WGN, STAGES, WK, MINB>;
  constexpr int SLD = C::BN + 8;  // a staged output row: 16 (bf16) or 32 (fp32) bytes of pad
  extern __shared__ uint8_t smem_raw[];
  __shared__ float a_scale[C::BM];  // the A rows' scales
  __shared__ int a_max[C::BM];      // |max| bits of the A rows
  __shared__ float red[2][C::BM];   // LN: the block's row sums, then sums of squares
  __shared__ float stat[2][C::BM];  // LN: the rows' mean and rstd
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* a_res = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  // the ring, free after the products: the warpgroups' partial row sums
  float* part = reinterpret_cast<float*>(a_res + (K + kGemmBK - 1) / kGemmBK * C::A_TILE);
  int acc[BNW / 2];
  cluster_quant_gemm<BNW, WGN, STAGES, WK, MINB, DIV127>(A, W, M, N, K, a_res, a_scale, a_max,
                                                         acc);

  // accumulator layout (Wgmma): acc[4j + e] holds row r_lo (e < 2) or r_hi,
  // column c0 + 8j + (e & 1) of the block
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = (warp & 3) * 16 + g, r_hi = r_lo + 8;
  const int c0 = wg * BNW + 2 * t;
  const bool in_lo = m0 + r_lo < M, in_hi = m0 + r_hi < M;
  const float xs_lo = a_scale[r_lo], xs_hi = a_scale[r_hi];
  float s_lo = 0.f, s_hi = 0.f;  // LN: this thread's part of its rows' sums
#pragma unroll
  for (int j = 0; j < BNW / 8; ++j) {
    const int n = n0 + c0 + 8 * j;
    const float2 w2 = *reinterpret_cast<const float2*>(ws + n);
    const float2 b2 = bias ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;  // the residual (LN)
    if (LN && in_lo) load2(resid + (size_t)(m0 + r_lo) * N + n, x0, x1);
    if (LN && in_hi) load2(resid + (size_t)(m0 + r_hi) * N + n, x2, x3);
    float v0 = epilogue<EPI>(acc[4 * j], xs_lo, w2.x, b2.x, x0);
    float v1 = epilogue<EPI>(acc[4 * j + 1], xs_lo, w2.y, b2.y, x1);
    float v2 = epilogue<EPI>(acc[4 * j + 2], xs_hi, w2.x, b2.x, x2);
    float v3 = epilogue<EPI>(acc[4 * j + 3], xs_hi, w2.y, b2.y, x3);
    if (LN && EPI != kEpiResidLast) {  // the rounded form
      v0 = round_as<OT>(__fadd_rn(round_as<OT>(v0), x0));
      v1 = round_as<OT>(__fadd_rn(round_as<OT>(v1), x1));
      v2 = round_as<OT>(__fadd_rn(round_as<OT>(v2), x2));
      v3 = round_as<OT>(__fadd_rn(round_as<OT>(v3), x3));
    }
    if (LN) {
      s_lo = __fadd_rn(__fadd_rn(s_lo, v0), v1);
      s_hi = __fadd_rn(__fadd_rn(s_hi, v2), v3);
    }
    acc[4 * j] = __float_as_int(v0);
    acc[4 * j + 1] = __float_as_int(v1);
    acc[4 * j + 2] = __float_as_int(v2);
    acc[4 * j + 3] = __float_as_int(v3);
  }
  // every warpgroup's products (its reads of a_res and the ring) are done
  __syncthreads();

  if constexpr (LN) {
    cg::cluster_group cluster = cg::this_cluster();
    const int cn = (int)cluster.num_blocks();
    // a row's total over the block (warpgroups in order) into red[k], then
    // over the cluster (blocks in rank order) into stat[k] / N
    auto row_total = [&](int k, float lo, float hi) {
      lo = quad_total(lo);
      hi = quad_total(hi);
      if (t == 0) {
        part[wg * C::BM + r_lo] = lo;
        part[wg * C::BM + r_hi] = hi;
      }
      __syncthreads();
      if (tid < C::BM) {
        float v = part[tid];
#pragma unroll
        for (int w = 1; w < WGN; ++w) v = __fadd_rn(v, part[w * C::BM + tid]);
        red[k][tid] = v;
      }
      cluster.sync();  // every block's sums are in (and every read of part is done)
      if (tid < C::BM) {
        float v = 0.f;
        for (int p = 0; p < cn; ++p) v = __fadd_rn(v, *cluster.map_shared_rank(&red[k][tid], p));
        stat[k][tid] = __fdiv_rn(v, (float)N);
      }
      __syncthreads();
    };
    row_total(0, s_lo, s_hi);
    const float mean_lo = stat[0][r_lo], mean_hi = stat[0][r_hi];
    float q_lo = 0.f, q_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BNW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float c_lo = __fadd_rn(__int_as_float(acc[4 * j + e]), -mean_lo);
        const float c_hi = __fadd_rn(__int_as_float(acc[4 * j + 2 + e]), -mean_hi);
        q_lo = __fadd_rn(q_lo, __fmul_rn(c_lo, c_lo));
        q_hi = __fadd_rn(q_hi, __fmul_rn(c_hi, c_hi));
      }
    }
    row_total(1, q_lo, q_hi);  // stat[1]: the variance
    cluster_arrive();          // this block reads no peer any more
    const float rs_lo = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(stat[1][r_lo], eps)));
    const float rs_hi = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(stat[1][r_hi], eps)));
#pragma unroll
    for (int j = 0; j < BNW / 8; ++j) {
      const int n = n0 + c0 + 8 * j;
      const float2 g2 = *reinterpret_cast<const float2*>(ln_g + n);
      const float2 bb = *reinterpret_cast<const float2*>(ln_b + n);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ge = e ? g2.y : g2.x, be = e ? bb.y : bb.x;
        const float c_lo = __fmul_rn(__fadd_rn(__int_as_float(acc[4 * j + e]), -mean_lo), rs_lo);
        const float c_hi =
            __fmul_rn(__fadd_rn(__int_as_float(acc[4 * j + 2 + e]), -mean_hi), rs_hi);
        acc[4 * j + e] = __float_as_int(__fadd_rn(__fmul_rn(c_lo, ge), be));
        acc[4 * j + 2 + e] = __float_as_int(__fadd_rn(__fmul_rn(c_hi, ge), be));
      }
    }
  }

  // the block's 64 rows in OT, staged over the freed A tiles and ring, then
  // stored as 16-byte vectors
  OT* st = reinterpret_cast<OT*>(a_res);
#pragma unroll
  for (int j = 0; j < BNW / 8; ++j) {
    const int c = c0 + 8 * j;
    store2(st + r_lo * SLD + c, __int_as_float(acc[4 * j]), __int_as_float(acc[4 * j + 1]));
    store2(st + r_hi * SLD + c, __int_as_float(acc[4 * j + 2]), __int_as_float(acc[4 * j + 3]));
  }
  __syncthreads();
  constexpr int VEC = 16 / sizeof(OT);
  for (int idx = tid; idx < C::BM * C::BN / VEC; idx += C::THREADS) {
    const int r = idx / (C::BN / VEC), c = (idx - r * (C::BN / VEC)) * VEC;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(st + r * SLD + c);
  }
  if constexpr (LN) cluster_wait();  // no block leaves while a peer may still read its sums
}

struct ProjArgs {
  const void* a;
  const int8_t* w;
  const float* ws;
  const float* bias;
  const void* resid;
  const float* ln_g;
  const float* ln_b;
  float eps;
  int M, N, K;
  void* out;
  cudaStream_t stream;
};

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

template <int BNW, int WGN, int STAGES, int WK, int MINB, int EPI, bool DIV127, bool LN,
          typename T, typename OT>
cudaError_t proj_launch(const ProjArgs& g, int* clusters) {
  using C = FfnTile<BNW, WGN, STAGES, WK, MINB>;
  const auto kernel = proj_gemm_kernel<BNW, WGN, STAGES, WK, MINB, EPI, DIV127, LN, T, OT>;
  const int ktiles = (g.K + kGemmBK - 1) / kGemmBK;
  const int smem = ktiles * C::A_TILE + STAGES * C::W_TILE + 1024, cn = g.N / C::BN;
  // the staged output over the A tiles and the ring
  const int staged = C::BM * (C::BN + 8) * (int)sizeof(OT);
  if (smem > kProjMaxDynamic || staged > smem - 1024 || g.N % C::BN || cn < 1 || cn > 16)
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kProjMaxDynamic);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cn, (g.M + C::BM - 1) / C::BM, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = g.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(g.a), g.w, g.ws, g.bias,
                            static_cast<const OT*>(g.resid), g.ln_g, g.ln_b, g.eps, g.M, g.N,
                            g.K, static_cast<OT*>(g.out));
}

// The block configurations (hriemo_torch/ops/_cuda.py
// PROJ_CONFIGS): 0 six warpgroups of 64 columns, one block an SM; 1 two of
// 128 on 64-byte W tiles, two blocks an SM up to K = 896.
template <int EPI, bool DIV127, bool LN, typename T, typename OT>
cudaError_t proj_config(const ProjArgs& g, int config, int* clusters = nullptr) {
  switch (config) {
    case 0: return proj_launch<64, 6, 3, 128, 1, EPI, DIV127, LN, T, OT>(g, clusters);
    case 1: return proj_launch<128, 2, 3, 64, 2, EPI, DIV127, LN, T, OT>(g, clusters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace hr

using namespace hr;

extern "C" {

// x [M, K] fp32 (x_f32 = 1) or bf16; w [N, K] int8; ws [N], b [N] (or NULL)
// fp32; out [M, N]: epilogue<epi>(w . quant_rows(x)), bit-equal to
// hr_rowquant(x, div127) and hr_int8_gemm(epi) of its codes. The forms on
// the path: epi kEpiBf16 (bf16 out) at div127 0 (q/k/v; the MHA's
// out-projection over bf16 ctx) over bf16 or fp32 x, and at div127 1
// (int8_linear) over bf16 x; epi kEpiF32 (fp32 out) at div127 1 over fp32 x
// (int8_linear) and at div127 0 over bf16 x (the MHA's out-projection on an
// fp32 tree). config 0 or 1 of proj_config: N
// a multiple of its columns, in a cluster of at most 16 blocks, K % 16 ==
// 0, every pointer 16-byte aligned (the wrapper checks).
int hr_proj_gemm(const void* x, int x_f32, int M, int K, const void* w, const void* ws,
                 const void* b, int N, int epi, int div127, int config, void* out,
                 void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (K % 16) return (int)cudaErrorInvalidValue;
  const ProjArgs g{x, static_cast<const int8_t*>(w), static_cast<const float*>(ws),
                   static_cast<const float*>(b), nullptr, nullptr, nullptr, 0.f, M, N, K,
                   out, static_cast<cudaStream_t>(stream)};
  using bf = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (epi == kEpiBf16 && !div127)
    err = x_f32 ? proj_config<kEpiBf16, false, false, float, bf>(g, config)
                : proj_config<kEpiBf16, false, false, bf, bf>(g, config);
  else if (epi == kEpiBf16 && !x_f32)
    err = proj_config<kEpiBf16, true, false, bf, bf>(g, config);
  else if (epi == kEpiF32 && div127 && x_f32)
    err = proj_config<kEpiF32, true, false, float, float>(g, config);
  else if (epi == kEpiF32 && !div127 && !x_f32)
    err = proj_config<kEpiF32, false, false, bf, float>(g, config);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// a [M, K] bf16 (the attention context); w [N, K] int8; ws, b [N] fp32;
// resid [M, N] bf16 (resid_f32 = 0) or fp32; g, beta [N] fp32; out [M, N]
// in resid's dtype: LayerNorm(((w . quant_rows(a)) * cs * ws + b) + resid)
// with fp32 statistics. Its y is hr_int8_gemm's kEpiResidLast of
// hr_rowquant's codes bit for bit; the LayerNorm is hr_layernorm's formula
// with its two sums in another order. rounded (non-zero): y = rnd(rnd(w .
// quant_rows(a) * cs * ws + b) + resid), rnd to resid's dtype: hr_int8_gemm's
// store epilogue in resid's dtype plus resid in that dtype, bit for bit.
// config as hr_proj_gemm's.
int hr_proj_gemm_ln(const void* a, int M, int K, const void* w, const void* ws, const void* b,
                    int N, const void* resid, int resid_f32, const void* g, const void* beta,
                    float eps, int rounded, int config, void* out, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (K % 16) return (int)cudaErrorInvalidValue;
  const ProjArgs args{a, static_cast<const int8_t*>(w), static_cast<const float*>(ws),
                      static_cast<const float*>(b), resid, static_cast<const float*>(g),
                      static_cast<const float*>(beta), eps, M, N, K, out,
                      static_cast<cudaStream_t>(stream)};
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (rounded)
    err = resid_f32 ? proj_config<kEpiF32, false, true, bf, float>(args, config)
                    : proj_config<kEpiBf16, false, true, bf, bf>(args, config);
  else
    err = resid_f32 ? proj_config<kEpiResidLast, false, true, bf, float>(args, config)
                    : proj_config<kEpiResidLast, false, true, bf, bf>(args, config);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many clusters of hr_proj_gemm's bf16-storing instance over bf16 x at
// these arguments the card runs at once (cudaOccupancyMaxActiveClusters), or
// minus the CUDA error.
int hr_proj_gemm_clusters(int M, int K, int N, int config) {
  const ProjArgs g{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0.f, M, N, K,
                   nullptr, nullptr};
  int n = 0;
  const cudaError_t err =
      proj_config<kEpiBf16, false, false, __nv_bfloat16, __nv_bfloat16>(g, config, &n);
  return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
