// W8A8 FFN blocks (hriemo_torch/ops/fused_ffn.py ffn_block_int8, mlp2_int8):
// the first product with both row quantizations folded in,
//
//   hq, hs = quant_rows(act((W1 . quant_rows(x)) * xs * s1 + b1))
//
// in one launch, over x [M, K] bf16 or fp32 and the torch-layout int8 W1
// [F, K]; act is the tanh or erf GELU (FFN) or ReLU (mlp2). The second
// product is the shared GEMM of csrc/int8_gemm.cuh (hr_int8_gemm) over hq,
// and the FFN's LayerNorm the pass of csrc/quant_gemm.cu: three launches for
// the FFN, two for mlp2.
//
// Replaces, with those, the Pallas kernels hriemo/ops/fused_ffn.py::
// _kernel_int8 (:94, pallas_call at :157) and ::_kernel_mlp2_int8 (:71,
// :286), which keep h in VMEM and requantize it there (:64-68). Until this
// file the port ran x's row quantize, GEMM1 with an fp32 [M, F] output, a
// separate row quantize that read h back, GEMM2 (and the LayerNorm): at
// M=1996 and F=3072, 24.5 MB of fp32 h written and read and 6.1 MB of int8 h
// written by one pass and read by the next, twice the block's operation
// bound in bytes alone. Here h never leaves the registers:
//
// - a block owns 64 rows and BN columns of h (six warpgroups of 64 columns
//   or two of 128), and a thread-block cluster of F / BN blocks along N
//   spans all F columns of its rows (8 x 384 at F=3072, 4 x 256 at 1024, one
//   block of 256 at 256; ffn_cluster in hriemo_torch/ops/_cuda.py chooses);
// - x's row quantize, once for the cluster: block `rank` takes every
//   cn-th of the 64 rows, a 16-element chunk a thread (several in flight),
//   reads them for the rows' |max| (a shared-memory atomicMax on the bits)
//   and, past the first few, again for the codes, and stores each 16-byte
//   chunk of codes and each row's scale into the shared memory of every
//   block of the cluster (once a cluster barrier, whose arrival the |max|
//   pass hides, shows every block started), where the 64 rows of int8 x stay for the
//   whole product (K <= 1280 or 2816 by block), tile by tile in the
//   128-byte swizzle that the wgmma descriptors of int8_gemm.cuh name; int8
//   x never reaches device memory either;
// - the W1 tiles stream through a ring by cp.async; the products are
//   int8_gemm.cuh's wgmma m64n{64,128}k32 s8, one warpgroup per column slice;
// - the epilogue computes h = epilogue<EPI>(acc, xs, s1, b1) in registers,
//   the very function the chain's GEMM1 stores, so h is bit-equal; each
//   row's |h| maximum goes from the thread over its quad (shuffles), the
//   block's warpgroups (shared memory) and the cluster's blocks
//   (distributed shared memory, after a cluster barrier); a maximum is
//   exact in any order, so the scale row_scale(amax) and the codes equal
//   quant_rows of the whole fp32 row (quant_byte: a multiply by the
//   rounded reciprocal, the IEEE quotient only near a half-integer);
// - the codes are staged in the freed ring and stored as 16-byte vectors;
//   rank 0 of the cluster stores the row scale.
//
// What bounds it: its operation bound is the product's 2*M*K*F int8
// tensor-core operations, and its bytes are x, W1 and the int8 h, a quarter
// of what the fp32 h alone moved. What holds it back is that a block of 384
// columns holds the SM alone (its accumulators and ring leave no room for a
// second), so nothing overlaps its three phases: the x quantize, the
// products, which stream W1 from L2 once for every 64 rows, and the
// epilogue's activation and quantize of every element of h. On the H100 at
// M=23808 the products alone take 0.23 ms and the epilogue adds 0.19
// (chip_ffn_int8_variants.py, PERF.md section 6). On a grid of few row
// blocks that costs more than the chain's launches, whose smaller blocks
// overlap, so the wrappers take the chain there (ffn_route in
// hriemo_torch/ops/_cuda.py, measured by chip_ffn_routes.py); a block of 64
// columns, which alone held the beta gate's 64 rows of 3072 inputs, lost to
// the chain at every row count and was taken out.
//
// The x quantize and the products live in csrc/cluster_gemm.cuh, which the
// projections of csrc/proj_int8.cu share; this file keeps the requantizing
// epilogue.
#include "cluster_gemm.cuh"

namespace hr {

template <int BNW, int WGN, int STAGES, int WK, int MINB, int EPI, typename T>
__global__ void __launch_bounds__(128 * WGN, MINB)
ffn_gemm_kernel(const T* __restrict__ A, const int8_t* __restrict__ W,
                const float* __restrict__ ws, const float* __restrict__ bias, int M, int N,
                int K, int8_t* __restrict__ out, float* __restrict__ out_s) {
  using C = FfnTile<BNW, WGN, STAGES, WK, MINB>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float a_scale[C::BM];    // the A rows' scales (then h's, for the store)
  __shared__ float row_max[C::BM];    // |h| row maxima over the block's columns, for the cluster
  __shared__ int a_max[C::BM];        // |max| bits of the A rows, then of h's over the cluster
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* a_res = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  uint8_t* ring = a_res + (K + kGemmBK - 1) / kGemmBK * C::A_TILE;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cn = (int)cluster.num_blocks();
  int acc[BNW / 2];
  cluster_quant_gemm<BNW, WGN, STAGES, WK, MINB, false>(A, W, M, N, K, a_res, a_scale, a_max,
                                                        acc);

  // accumulator layout (Wgmma): acc[4j + e] holds row r_lo (e < 2) or r_hi,
  // column c0 + 8j + (e & 1) of the block
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = (warp & 3) * 16 + g, r_hi = r_lo + 8;
  const int c0 = wg * BNW + 2 * t;
  // h = act((acc * xs) * s1 + b1), as the chain's GEMM1 stores it
  const float xs_lo = a_scale[r_lo], xs_hi = a_scale[r_hi];
  float mx_lo = 0.f, mx_hi = 0.f;
#pragma unroll
  for (int j = 0; j < BNW / 8; ++j) {
    const int n = n0 + c0 + 8 * j;
    const float2 w2 = *reinterpret_cast<const float2*>(ws + n);
    const float2 b2 = *reinterpret_cast<const float2*>(bias + n);
    const float h0 = epilogue<EPI>(acc[4 * j], xs_lo, w2.x, b2.x, 0.f);
    const float h1 = epilogue<EPI>(acc[4 * j + 1], xs_lo, w2.y, b2.y, 0.f);
    const float h2 = epilogue<EPI>(acc[4 * j + 2], xs_hi, w2.x, b2.x, 0.f);
    const float h3 = epilogue<EPI>(acc[4 * j + 3], xs_hi, w2.y, b2.y, 0.f);
    mx_lo = fmaxf(mx_lo, fmaxf(fabsf(h0), fabsf(h1)));
    mx_hi = fmaxf(mx_hi, fmaxf(fabsf(h2), fabsf(h3)));
    acc[4 * j] = __float_as_int(h0);
    acc[4 * j + 1] = __float_as_int(h1);
    acc[4 * j + 2] = __float_as_int(h2);
    acc[4 * j + 3] = __float_as_int(h3);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {  // the quad's four threads hold a row's columns
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
  }
  // the ring is free (every thread waited for its products and copies,
  // and passes the barrier below before any write): the warpgroups'
  // partial maxima after the int8 staging tile
  int8_t* ot = reinterpret_cast<int8_t*>(ring);
  float* part = reinterpret_cast<float*>(ring + C::BM * C::OUT_LD);
  __syncthreads();
  if (t == 0) {
    part[wg * C::BM + r_lo] = mx_lo;
    part[wg * C::BM + r_hi] = mx_hi;
  }
  __syncthreads();
  if (tid < C::BM) {
    float mx = part[tid];
#pragma unroll
    for (int w = 1; w < WGN; ++w) mx = fmaxf(mx, part[w * C::BM + tid]);
    row_max[tid] = mx;
    a_max[tid] = 0;
  }
  cluster.sync();  // every block's row maxima are in
  // every (peer, row) pair at once, into the |max| bits of each row
  for (int i = tid; i < C::BM * cn; i += C::THREADS)
    atomicMax(&a_max[i % C::BM],
              __float_as_int(*cluster.map_shared_rank(&row_max[i % C::BM], i / C::BM)));
  __syncthreads();
  cluster_arrive();  // this block reads no peer any more
  const float s_lo = row_scale(__int_as_float(a_max[r_lo]));
  const float s_hi = row_scale(__int_as_float(a_max[r_hi]));
  const float i_lo = __frcp_rn(s_lo), i_hi = __frcp_rn(s_hi);
#pragma unroll
  for (int j = 0; j < BNW / 8; ++j) {
    const int c = c0 + 8 * j;
    *reinterpret_cast<uint16_t*>(ot + r_lo * C::OUT_LD + c) = (uint16_t)(
        quant_byte(__int_as_float(acc[4 * j]), s_lo, i_lo) |
        quant_byte(__int_as_float(acc[4 * j + 1]), s_lo, i_lo) << 8);
    *reinterpret_cast<uint16_t*>(ot + r_hi * C::OUT_LD + c) = (uint16_t)(
        quant_byte(__int_as_float(acc[4 * j + 2]), s_hi, i_hi) |
        quant_byte(__int_as_float(acc[4 * j + 3]), s_hi, i_hi) << 8);
  }
  if (wg == 0 && t == 0) {  // warpgroup 0's quads cover the 64 rows
    a_scale[r_lo] = s_lo;
    a_scale[r_hi] = s_hi;
  }
  __syncthreads();
  for (int idx = tid; idx < C::BM * C::BN / 16; idx += C::THREADS) {
    const int r = idx / (C::BN / 16), c = (idx - r * (C::BN / 16)) * 16;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(ot + r * C::OUT_LD + c);
  }
  if (rank == 0 && tid < C::BM && m0 + tid < M) out_s[m0 + tid] = a_scale[tid];
  cluster_wait();  // no block leaves while a peer may still read its row maxima
}

struct FfnArgs {
  const void* a;
  const int8_t* w;
  const float* ws;
  const float* bias;
  int M, N, K;
  int8_t* out;
  float* out_s;
  cudaStream_t stream;
};

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

// Launches one instance (a cluster of gridDim.x blocks), or with `clusters`
// asks how many of its clusters the card runs at once.
template <int BNW, int WGN, int STAGES, int WK, int MINB, int EPI, typename T>
cudaError_t ffn_launch(const FfnArgs& g, int* clusters) {
  using C = FfnTile<BNW, WGN, STAGES, WK, MINB>;
  const auto kernel = ffn_gemm_kernel<BNW, WGN, STAGES, WK, MINB, EPI, T>;
  const int smem = C::smem(g.K), cn = g.N / C::BN;
  if (smem == 0 || g.N % C::BN || cn < 1 || cn > 16) return cudaErrorInvalidValue;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::MAX_DYNAMIC);
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
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(g.a), g.w, g.ws, g.bias, g.M,
                            g.N, g.K, g.out, g.out_s);
}

template <int BNW, int WGN, int STAGES, int WK, int MINB, typename T>
cudaError_t requant_epi(const FfnArgs& g, int epi, int* clusters) {
  switch (epi) {
    case kEpiGeluF32:
      return ffn_launch<BNW, WGN, STAGES, WK, MINB, kEpiGeluF32, T>(g, clusters);
    case kEpiGeluErfF32:
      return ffn_launch<BNW, WGN, STAGES, WK, MINB, kEpiGeluErfF32, T>(g, clusters);
    case kEpiReluF32:
      return ffn_launch<BNW, WGN, STAGES, WK, MINB, kEpiReluF32, T>(g, clusters);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t requant_config(const FfnArgs& g, int epi, int config, int* clusters) {
  switch (config) {
    // 384 columns in six warpgroups of 64, one block an SM, K <= 1280
    case 0: return requant_epi<64, 6, 3, 128, 1, T>(g, epi, clusters);
    // 256 columns in two of 128 on 64-byte W tiles, two blocks an SM up to
    // K = 896, K <= 2816
    case 1: return requant_epi<128, 2, 3, 64, 2, T>(g, epi, clusters);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t requant(const void* x, int x_f32, int M, int K, const void* w, const void* ws,
                    const void* b, int F, int epi, int config, void* hq, void* hs,
                    cudaStream_t stream, int* clusters) {
  if (config < 0 || config > 1 || K % 16) return cudaErrorInvalidValue;
  const FfnArgs g{x, static_cast<const int8_t*>(w), static_cast<const float*>(ws),
                  static_cast<const float*>(b), M, F, K, static_cast<int8_t*>(hq),
                  static_cast<float*>(hs), stream};
  return x_f32 ? requant_config<float>(g, epi, config, clusters)
               : requant_config<__nv_bfloat16>(g, epi, config, clusters);
}

}  // namespace

}  // namespace hr

using namespace hr;

extern "C" {

// x [M, K] fp32 (x_f32 = 1) or bf16; w [F, K] int8; ws [F], b [F] fp32; out
// hq [M, F] int8 and hs [M] fp32, bit-equal to quant_rows of the fp32 h that
// hr_int8_gemm's epilogue `epi` (kEpiGeluF32, kEpiGeluErfF32, kEpiReluF32)
// stores. config picks the block (hriemo_torch/ops/_cuda.py FFN_CONFIGS): 0
// six warpgroups of 64 columns, 1 two of 128; F must be a multiple of its
// columns, in a cluster of at most 16 blocks (above 8 a non-portable size),
// and 64 rows of K int8 must fit its shared memory (K <= 1280, 2816). K % 16
// == 0, every pointer 16-byte aligned (the wrapper checks).
int hr_ffn_gemm1(const void* x, int x_f32, int M, int K, const void* w, const void* ws,
                 const void* b, int F, int epi, int config, void* hq, void* hs, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  const cudaError_t err = requant(x, x_f32, M, K, w, ws, b, F, epi, config, hq, hs,
                                  static_cast<cudaStream_t>(stream), nullptr);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many clusters of hr_ffn_gemm1's instance at these arguments the card
// runs at once (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int hr_ffn_gemm1_clusters(int x_f32, int M, int K, int F, int epi, int config) {
  int n = 0;
  const cudaError_t err = requant(nullptr, x_f32, M, K, nullptr, nullptr, nullptr, F, epi,
                                  config, nullptr, nullptr, nullptr, &n);
  return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
