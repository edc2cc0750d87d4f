// The prologue and main loop of the W8A8 projections whose A operand is
// quantized by rows inside the product, over a thread-block cluster
// (csrc/proj_int8.cu: the projections, which store, or add the residual and
// take the LayerNorm). The design, first written for the FFN pair's first
// product (since replaced by csrc/ffn_tma.cu, which keeps quant_byte):
// - a block owns 64 rows and BN columns (six warpgroups of 64 columns or
//   two of 128), and a cluster of N / BN blocks spans all N columns of its
//   rows;
// - x's row quantize, once for the cluster: block `rank` takes every cn-th
//   of the 64 rows, a 16-element chunk a thread, reads them for the rows'
//   |max| (a shared-memory atomicMax on the bits) and again for the codes,
//   and stores each 16-byte chunk of codes and each row's scale into the
//   shared memory of every block of the cluster (over distributed shared
//   memory, once a cluster barrier shows every block started), where the
//   64 rows of int8 x stay for the whole product, tile by tile in the
//   128-byte swizzle that the wgmma descriptors of int8_gemm.cuh name;
// - the W tiles stream through a ring by cp.async into int8_gemm.cuh's
//   wgmma m64n{64,128}k32 s8, one warpgroup per column slice.
// A block of 384 columns holds its SM alone, so its quantize, products and
// epilogue run one after another.
#pragma once

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

// The scale of a row whose largest |value| is amax: the kernels' _quant_rows
// (row_scale, max(amax, 1e-8) * (1/127)) or, DIV127, quantize_rowwise's
// max(amax, 1e-8) / 127 (hriemo/ops/quant.py:63), as hr_rowquant's div127
// (csrc/quant_gemm.cu) takes them.
template <bool DIV127>
__device__ __forceinline__ float act_scale(float amax) {
  return DIV127 ? __fdiv_rn(fmaxf(amax, (float)1e-8), 127.0f) : row_scale(amax);
}

// The block's part of A [M, K] (T: bf16 or fp32) . W[N, K]^T int8 over the
// cluster of gridDim.x blocks that spans N: A's 64 rows are quantized into
// a_res (every block's copy) with their scales in a_scale (the 64 rows', in
// every block), and acc (int32, Wgmma's layout: acc[4j + e] holds row
// (warp % 4) * 16 + lane / 4 (+ 8 for e >= 2), column wg * BNW + 8j +
// 2 * (lane % 4) + (e & 1) of the block) holds the block's product. a_res
// starts on 1024 bytes, ktiles A tiles and then the ring of W tiles; on
// return every thread's copies and products are done, and no peer writes
// this block's shared memory any more. a_max: 64 ints of scratch.
template <int BNW, int WGN, int STAGES, int WK, int MINB, bool DIV127, typename T>
__device__ __forceinline__ void cluster_quant_gemm(const T* __restrict__ A,
                                                   const int8_t* __restrict__ W, int M, int N,
                                                   int K, uint8_t* a_res, float* a_scale,
                                                   int* a_max, int (&acc)[BNW / 2]) {
  using C = FfnTile<BNW, WGN, STAGES, WK, MINB>;
  constexpr int AHEAD = STAGES - 1;
  const int tid = threadIdx.x, warp = tid >> 5, wg = warp >> 2;
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
    const float sc = act_scale<DIV127>(amax_of(r));
    for (int p = 0; p < cn; ++p) cluster.map_shared_rank(&a_scale[0], p)[r] = sc;
  }
  auto emit = [&](int q, const float (&v)[16]) {
    if (q >= nchunks) return;
    const int r = row_of(q), c16 = q % row_chunks;
    const float sc = act_scale<DIV127>(amax_of(r)), inv = __frcp_rn(sc);
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
}

}  // namespace hr
