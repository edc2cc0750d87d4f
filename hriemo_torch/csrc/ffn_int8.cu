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
#include <cooperative_groups.h>

#include "int8_gemm.cuh"

namespace hr {

namespace cg = cooperative_groups;

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

// The byte of quant_code(v, scale) (common.cuh) from q = v * inv, inv = 1 /
// scale rounded, with no conversion instruction: for |v| up to 127 * scale
// (the row's |max|) q is within 2.3e-5 of the rounded quotient, so the two
// round to one integer unless q lies near a half-integer, where the
// quotient is taken; q + 1.5 * 2^23 rounds q to an integer, half to even,
// as rintf does, and holds it in its low mantissa bits.
__device__ __forceinline__ uint32_t quant_byte(float v, float scale, float inv) {
  const float q = __fmul_rn(v, inv);
  const float r = __fsub_rn(__fadd_rn(q, kMagic), kMagic);
  if (!(fabsf(fabsf(__fsub_rn(q, r)) - 0.5f) >= 1.0f / 8192))  // or NaN
    return (uint8_t)quant_code(v, scale);
  return (uint32_t)__float_as_int(__fadd_rn(fminf(fmaxf(r, -127.f), 127.f), kMagic)) & 0xFF;
}

__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}
// the two halves of a cluster barrier (cluster.sync() is both at once)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A W tile of R rows of 64 K-bytes in the 64-byte swizzle (16-byte chunk c
// of row r at chunk c ^ ((r / 2) % 4), 8-row groups 512 bytes apart), chunks
// past `rows` or K zero-filled; as load_tile (csrc/int8_gemm.cuh) does for
// 128-byte rows.
template <int R, int THREADS>
__device__ __forceinline__ void load_tile64(uint8_t* tile, const int8_t* src, int row0, int rows,
                                            size_t ld, int K, int k0, int tid) {
  for (int idx = tid; idx < R * 4; idx += THREADS) {
    const int r = idx >> 2, c = idx & 3;
    const bool ok = row0 + r < rows && k0 + 16 * c < K;
    cp_async16(tile + r * 64 + ((c ^ ((r >> 1) & 3)) << 4),
               ok ? src + (size_t)(row0 + r) * ld + k0 + 16 * c : src, ok ? 16 : 0);
  }
}

// wgmma descriptor of a K-major tile in the 64-byte swizzle: 8-row groups
// 512 bytes apart, layout type 2.
__device__ __forceinline__ uint64_t wgmma_desc64(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// 64 rows, WGN warpgroups of BNW columns, a ring of STAGES W tiles of WK
// K-bytes (128, or 64 where a second block an SM needs the room); A (64 rows
// x K, int8) resident in shared memory in front of the ring, one swizzled 64
// x 128-byte tile per 128 K-bytes; at most MINB blocks an SM by registers.
template <int BNW, int WGN, int STAGES, int WK, int MINB>
struct FfnTile {
  static constexpr int BM = 64, BN = BNW * WGN, THREADS = 128 * WGN;
  static constexpr int A_TILE = BM * kGemmBK, W_TILE = BN * WK;
  static constexpr int OUT_LD = BN + 16;  // bytes of a row of the int8 staging tile
  static constexpr int STATIC = 3 * BM * 4;
  static constexpr int MAX_DYNAMIC = 232448 - STATIC;
  // dynamic shared memory at K, 0 where it does not fit one block
  static constexpr int smem(int K) {
    return (K + kGemmBK - 1) / kGemmBK * A_TILE + STAGES * W_TILE + 1024 <= MAX_DYNAMIC
               ? (K + kGemmBK - 1) / kGemmBK * A_TILE + STAGES * W_TILE + 1024
               : 0;
  }
  static_assert(BM * OUT_LD + WGN * BM * 4 <= STAGES * W_TILE, "staging fits the ring");
  static_assert(WK == 64 || WK == 128, "64- or 128-byte W rows");
};

// A: [M, K] rows of x (T); W: [N, K] int8; ws, bias [N] fp32; a cluster of
// gridDim.x blocks spans N. out: int8 h [M, N], out_s [M] its row scales.
// K % 16 == 0, N % BN == 0.
template <int BNW, int WGN, int STAGES, int WK, int MINB, int EPI, typename T>
__global__ void __launch_bounds__(128 * WGN, MINB)
ffn_gemm_kernel(const T* __restrict__ A, const int8_t* __restrict__ W,
                const float* __restrict__ ws, const float* __restrict__ bias, int M, int N,
                int K, int8_t* __restrict__ out, float* __restrict__ out_s) {
  using C = FfnTile<BNW, WGN, STAGES, WK, MINB>;
  constexpr int AHEAD = STAGES - 1;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float a_scale[C::BM];    // the A rows' scales (then h's, for the store)
  __shared__ float row_max[C::BM];    // |h| row maxima over the block's columns, for the cluster
  __shared__ int a_max[C::BM];        // |max| bits of the A rows, then of h's over the cluster
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* a_res = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int ktiles = (K + kGemmBK - 1) / kGemmBK;  // A tiles
  const int wtiles = (K + WK - 1) / WK;              // W tiles
  uint8_t* ring = a_res + ktiles * C::A_TILE;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cn = (int)cluster.num_blocks();

  auto load_w = [&](int kt) {
    uint8_t* tile = ring + (kt % STAGES) * C::W_TILE;
    if constexpr (WK == 128)
      load_tile<C::BN, C::THREADS>(tile, W, n0, N, (size_t)K, K, kt * WK, tid);
    else
      load_tile64<C::BN, C::THREADS>(tile, W, n0, N, (size_t)K, K, kt * WK, tid);
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < wtiles) load_w(s);
    cp_async_commit();  // one group per tile, empty past the last
  }

  // A, quantized once for the cluster: block `rank` takes rows rank, rank +
  // cn, ... of the 64, and of those below M their 16-element chunks, a chunk
  // a thread, U chunks in flight (the first U kept in registers between the
  // passes); each row's |max| gives its scale, sent to every block of the
  // cluster with the chunks' codes (zeros past K). Rows past M stay as they
  // are: their products are never stored.
  constexpr int U = C::THREADS >= 512 ? 1 : 512 / C::THREADS;
  const int row_chunks = ktiles * 8;  // chunks of a row, the last tile's padding included
  const int rows_mine = (C::BM - rank + cn - 1) / cn;
  const int rows_in = max(0, (min(C::BM, M - m0) - rank + cn - 1) / cn);
  const int nchunks = rows_in * row_chunks;
  auto row_of = [&](int q) { return rank + cn * (q / row_chunks); };
  auto load_chunk = [&](int q, float (&v)[16]) {
    const int r = row_of(q), c16 = q % row_chunks;
    if (q < nchunks && 16 * c16 < K) {
      load8(A + (size_t)(m0 + r) * K + 16 * c16, v);
      load8(A + (size_t)(m0 + r) * K + 16 * c16 + 8, v + 8);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = 0.f;
    }
  };
  auto amax_of = [&](int r) { return m0 + r < M ? __int_as_float(a_max[r]) : 0.f; };
  auto chunk_max = [&](int q, const float (&v)[16]) {
    if (q >= nchunks) return;
    float mx = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) mx = fmaxf(mx, fabsf(v[e]));
    atomicMax(&a_max[row_of(q)], __float_as_int(mx));  // non-negative floats order as their bits
  };
  float v0[U][16];
#pragma unroll
  for (int u = 0; u < U; ++u) load_chunk(tid + u * C::THREADS, v0[u]);
  for (int r = tid; r < C::BM; r += C::THREADS) a_max[r] = 0;
  __syncthreads();
  // no block may touch a peer's shared memory before every block of the
  // cluster has started: the barrier's arrival here and its wait before the
  // first store to a peer, the |max| pass between them
  cluster_arrive_relaxed();
#pragma unroll
  for (int u = 0; u < U; ++u) chunk_max(tid + u * C::THREADS, v0[u]);
  for (int q0 = tid + U * C::THREADS; q0 < nchunks; q0 += U * C::THREADS) {
    float v[U][16];
#pragma unroll
    for (int u = 0; u < U; ++u) load_chunk(q0 + u * C::THREADS, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) chunk_max(q0 + u * C::THREADS, v[u]);
  }
  __syncthreads();
  cluster_wait();
  for (int i = tid; i < rows_mine; i += C::THREADS) {
    const int r = rank + cn * i;
    const float sc = row_scale(amax_of(r));
    for (int p = 0; p < cn; ++p) cluster.map_shared_rank(&a_scale[0], p)[r] = sc;
  }
  auto emit = [&](int q, const float (&v)[16]) {
    if (q >= nchunks) return;
    const int r = row_of(q), c16 = q % row_chunks;
    const float sc = row_scale(amax_of(r)), inv = __frcp_rn(sc);
    uint32_t pk[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      pk[w] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) pk[w] |= quant_byte(v[4 * w + e], sc, inv) << (8 * e);
    }
    const uint4 chunk = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    uint4* dst = reinterpret_cast<uint4*>(a_res + (c16 >> 3) * C::A_TILE + r * 128 +
                                          (((c16 & 7) ^ (r & 7)) << 4));
    for (int p = 0; p < cn; ++p) *cluster.map_shared_rank(dst, p) = chunk;
  };
#pragma unroll
  for (int u = 0; u < U; ++u) emit(tid + u * C::THREADS, v0[u]);
  for (int q0 = tid + U * C::THREADS; q0 < nchunks; q0 += U * C::THREADS) {
    float v[U][16];
#pragma unroll
    for (int u = 0; u < U; ++u) load_chunk(q0 + u * C::THREADS, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) emit(q0 + u * C::THREADS, v[u]);
  }
  fence_proxy_async_cluster();  // the codes, for the cluster's wgmma reads
  cluster.sync();               // every block's rows are in every block
  fence_proxy_async();

  const uint32_t a_base = smem_addr(a_res);
  const uint32_t b_off = wg * BNW * WK;  // this warpgroup's columns of a W tile
  int acc[BNW / 2];
#pragma unroll
  for (int i = 0; i < BNW / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < wtiles; ++kt) {
    cp_async_wait<AHEAD - 1>();  // tile kt's copies from this thread are in
    fence_proxy_async();
    // ... and everyone's; the stage refilled next was last read by the
    // products of tile kt - 1, which every warpgroup has waited for
    __syncthreads();
    if (kt + AHEAD < wtiles) load_w(kt + AHEAD);
    cp_async_commit();
    // W tile kt is K-bytes [kt * WK, + WK): a whole A tile, or half of one
    const uint64_t da = wgmma_desc(a_base + (kt * WK / kGemmBK) * C::A_TILE) +
                        (kt * WK % kGemmBK) / 16;
    const uint32_t w_st = smem_addr(ring + (kt % STAGES) * C::W_TILE) + b_off;
    const uint64_t db = WK == 128 ? wgmma_desc(w_st) : wgmma_desc64(w_st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 32; ++kk)  // 32 bytes = 2 units of the start field
      Wgmma<BNW>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

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
