// The W8A8 FFN pair (hriemo_torch/ops/fused_ffn.py ffn_block_int8,
// mlp2_int8) on the Tensor Memory Accelerator: x's row quantize and two
// persistent, warp-specialised products,
//
//   x quantize:      xq, xs = quant_rows(x)                        (one warp a row)
//   first product:   hq, hs = quant_rows(act((W1 . xq) * xs * s1 + b1))
//   second product:  y = LN((x + (W2 . hq) * hs * s2) + b2)      (the FFN)
//                    y = (W2 . hq) * hs * s2 + b2                 (mlp2)
//
// over the torch-layout int8 W1 [F, K] and W2 [N, F]; act is the tanh or
// erf GELU (FFN) or ReLU (mlp2). Three launches. With them the port
// replaces the Pallas kernels hriemo/ops/fused_ffn.py::_kernel_int8 (:94,
// pallas_call at :157) and ::_kernel_mlp2_int8 (:71, pallas_call at :286)
// where they are faster than the chain of the row quantize and the shared
// int8 GEMM (ffn_route in hriemo_torch/ops/_cuda.py).
//
// What bounds them: int8 tensor-core operations, 2 * M * K * F for each
// product (0.057 ms each at 23,808 rows of 768 -> 3072 -> 768 at 1979
// TOP/s); the bytes of x, h and y (x and y 37 MB each in bf16, the int8 h
// 73 MB) come to about 0.05 ms. What held the earlier one-launch cluster
// design of the first product back (retired: a block of 64 rows by 384
// columns, its ring fed by cp.async from every thread): the block held its
// SM alone, so its x quantize, products and epilogue ran one after the
// other, and every 64 rows streamed all of W1 from L2 again; the shared
// GEMM's second product streamed 128 x 128 tiles of both operands through
// cp.async rings, and the LayerNorm pass read the fp32 y back. Design:
//
// First product (ffn_tma_gemm1_kernel<BN, EPI>):
// - a thread-block cluster of CN = F / BN blocks (16 x 192 at F = 3072, a
//   non-portable size of which an H100 runs 7 at once; 8 x 128 at 1024)
//   spans all F columns of its row tiles; each block keeps its BN x K slice
//   of W1 in shared memory for the whole launch (one TMA load, 144 KB at K
//   = 768), so only x streams, 64 rows by 128 bytes a stage;
// - the grid is persistent: as many clusters as the card runs at once, the
//   cluster taking row tiles cid, cid + clusters, ...; one producer warp
//   keeps TMA loads of x in flight into an mbarrier ring; two consumer sets
//   of two warpgroups take the cluster's tiles in turn (ping-pong on named
//   barriers), each warpgroup m64n(BN/2)k32 s8 wgmma over its half of the
//   W slice, so one set's epilogue (activation, row maximum, quantize,
//   store) runs while the other set's products run and the producer stays
//   ahead;
// - h = epilogue<EPI>(acc, xs, s1, b1), int8_gemm.cuh's own function, so h
//   is the chain's fp32 h bit for bit; each row's |h| maximum over the
//   block goes to slot `rank` of every block's exchange slots by 16-byte
//   asynchronous stores (st.async) that complete on the receiving block's
//   mbarrier, which its set arms for cn * 256 bytes a tile; a maximum is
//   exact in any order, so the scale row_scale(amax) and the codes are
//   quant_rows of the whole fp32 row: hq and hs are the chain's bits. Two
//   slots and barriers a set, by the parity of its tile count: a peer writes
//   tile k + 2's maxima only after tile k + 1's exchange, which needs this
//   block's stores, made after it read tile k's;
// - the codes are quant_byte's (csrc/cluster_gemm.cuh) in two passes, 32 at
//   a time: by the multiply with no branch, then, where a quotient lies near
//   a half-integer (rare), by quant_byte's IEEE-quotient fallback; staged in
//   shared memory and stored as 16-byte vectors, rows past M never; rank 0
//   stores the row scales.
//
// Second product (ffn_tma_gemm2_kernel<BN, LN, OT>):
// - a tile is 128 rows by BN columns, the two consumer warpgroups taking 64
//   rows each of one stage (A: 128 rows of hq, W: BN rows of W2, 128
//   K-bytes each, by TMA from the producer warp), so each W2 tile staged
//   feeds 128 rows; the grid is persistent, and the producer fills the ring
//   with the next tile's stages while the consumers run an epilogue;
// - the FFN (LN): a cluster of CN = N / BN blocks spans the N = 768 output
//   columns of its rows (6 x 128: a 192-column block held 96 values of y
//   a thread across two exchanges, spilled them and was slower, so the
//   LayerNorm has no such instance); y = (x + v) + b2 as kEpiResidFirst
//   rounds it, then the LayerNorm in fp32 over the cluster: each row's sum
//   over the thread's columns in order, its quad, then the blocks in rank
//   order (each block's 64 row sums into every block's slots, as above);
//   mean = sum / N (an IEEE quotient), the centred squares the same way, 1
//   / sqrt(var + eps), (y - mean) * rstd * g + b in x's dtype. Only the
//   order of the two sums differs from hr_layernorm's: the output is held to
//   the plain version at phase 3's tolerance, not to the chain's bits.
//   Neither the fp32 y nor a second pass exists;
// - mlp2: no cluster; the dequant-and-bias epilogue of int8_gemm.cuh
//   (kEpiBf16 or kEpiF32), stored in x's dtype, bit-equal to the chain.
//
// - the weights' tensor maps are encoded once a weight and block width
//   (hr_ffn_tma_wmap; the wrapper keeps the 128 bytes while the weight lives)
//   and passed by value as __grid_constant__ parameters; only the maps of
//   the activations, x's codes and hq, are encoded at each launch, for the
//   pointers of that launch, so a captured CUDA graph replays the maps of
//   its own buffers.
//
// ptxas (sm_90a): the first product 96 registers a thread (17 warps), 60-68
// bytes spilled at BN 192, 0-8 at 128; the second 168 (9 warps) with the
// LayerNorm at BN 128, none spilled; 124-125 without it at 192, none
// spilled; the x quantize 30-31.
//
// What holds them (NVIDIA H100 80GB HBM3, 700 W; chip_ffn_routes.py --split and
// chip_ffn_tma_variants.py, PERF.md section 6): the first product's epilogue.
// At 23,808 rows of 768 -> 3072 its products alone take 0.079 ms, the whole
// launch 0.287: about 55 instructions an element of h (the tanh GELU alone
// about 28, its two MUFU operations and the conversions among them) on 112 of
// the 132 SMs (7 clusters of 16) put the epilogue's instruction-throughput
// bound near 0.16 ms, and four warps a sub-partition do not reach it. One
// warpgroup a set (2 warps a sub-partition) took 0.478 ms; a branch around each
// code's IEEE fallback kept the codes from overlapping, and the release at
// cluster scope of the first exchange compiled to a full MEMBAR.GPU (both
// replaced, above); three warpgroups a set (72 registers) took 0.304. The
// second product with the LayerNorm takes 0.177 ms (6 x 128; 0.188 at 4 x
// 192, whose 96 values of y a thread spilled), 0.120 without it: its 128-row
// tiles stream W2 once every 128 rows from L2 and its epilogue, two cluster
// exchanges a tile and the residual read, does not overlap the next tile's
// products.
//
// Where the trouble lies, and what the design does:
// - a block waits for every exchange it takes part in, and all blocks of a
//   cluster take the same tiles, so every remote store into a block lands
//   before its last wait: no block leaves while a peer may still write it;
//   a cluster barrier after the barriers' initialization keeps any remote
//   store from reaching a block that has not started;
// - a peer's bytes may complete on a block's barrier before that block arms
//   it for the tile: the phase completes only when both the arrival and
//   every byte are in;
// - with two sets on one ring a parity wait cannot tell a stage's fill for
//   this set from the previous fill, consumed by the other set: the main
//   loops take turns (named barriers), so that fill has completed first;
// - the W1 slice must fit beside the ring: BN * K bytes, K <= 768 at 192
//   columns and 1280 at 128 (the beta gate's 3072 inputs do not fit: it
//   stays on the chain);
// - wgmma writes the sums asynchronously: they are fenced as registers after
//   the last wait of a tile (as csrc/tma_gemm.cuh does);
// - the warpgroup's index is broadcast by a shuffle so that the compiler
//   knows it uniform;
// - the "// variant NAME {" ... "}" comments mark the parts that
//   chip_ffn_tma_variants.py replaces in its copies of this file.
#include <cstring>

#include "cluster_gemm.cuh"
#include "tma.cuh"

namespace hr {

constexpr int kFtConsumers = 2;                       // the second product's consumers
constexpr int kFtThreads = 128 * kFtConsumers + 32;   // + the producer warp
constexpr int kFtBK = 128;                            // K bytes of a stage or W tile
constexpr int kFtMaxStages = 8;
constexpr int kFtSmemMax = 232448;
constexpr int kFtMaxCluster1 = 16;                    // the first product's cluster
constexpr int kFtMaxCluster2 = 8;                     // the second product's cluster

// d (+)= A . B^T over 32 K-bytes: A 64 rows, B BN rows, both K-major in the
// 128-byte swizzle; d = A . B^T where `accumulate` is 0. Layout as
// int8_gemm.cuh's Wgmma: d[4j + e] of warp w holds row 16w + g (+ 8 for
// e >= 2), column 8j + 2t + (e & 1).
template <int BN>
struct FtMma;

template <>
struct FtMma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct FtMma<96> {
  static __device__ __forceinline__ void mma(int (&d)[48], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct FtMma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct FtMma<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <int N>
__device__ __forceinline__ void ft_fence_sums(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// named barrier of consumer warpgroup `wg`'s 128 threads (0 is __syncthreads)
__device__ __forceinline__ void ft_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The first product's ping-pong: consumer set `set` (`threads` threads
// each) waits on barrier 3 + set before its main loop, which the other set
// opens after its own, so the main loops run in turn. That also keeps a set
// from waiting on a ring stage's barrier before the stage's previous fill,
// consumed by the other set, has completed its phase (a parity wait cannot
// tell the two apart).
__device__ __forceinline__ void ft_turn_wait(int set, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + set), "r"(2 * threads) : "memory");
}
__device__ __forceinline__ void ft_turn_open(int set, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + set), "r"(2 * threads) : "memory");
}
// named barrier of the first product's consumer set `set`
__device__ __forceinline__ void ft_set_sync(int set, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + set), "r"(threads) : "memory");
}

// The shared::cluster address of `addr` (this block's shared memory) in the
// block of cluster rank `rank`.
__device__ __forceinline__ uint32_t ft_mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// 16 bytes into the shared memory of a block of the cluster, completing
// their 16 bytes on that block's barrier `bar` (an asynchronous store: no
// fence orders it, the receiving barrier counts its bytes)
__device__ __forceinline__ void ft_st_async(uint32_t cluster_addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(cluster_addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
// Waits for the phase of parity `parity` of a barrier of this block that
// peers arrive on; acquire at cluster scope, so their writes before their
// arrivals are seen. Traps after 2^22 polls, as mbar_wait does.
__device__ __forceinline__ void ft_wait_cluster(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// A row exchange of a consumer warpgroup: its 64 row values (in `vals`, set
// before a warpgroup barrier) into slot `rank` of the same exchange slots
// (64 floats a block of the cluster) in every block, by 16-byte
// asynchronous stores completing on each block's barrier `bar`; a block
// arms its own barrier for cn * 256 bytes an exchange (mbar_expect_tx).
__device__ __forceinline__ void ft_send_rows(const float* vals, float* slots, uint32_t bar,
                                             int rank, int cn, int ltid) {
  for (int i = ltid; i < cn * 16; i += 128) {
    const int p = i % cn, c = i / cn;  // the peer, four rows
    ft_st_async(ft_mapa(smem_addr(slots + rank * 64 + 4 * c), p),
                *reinterpret_cast<const float4*>(vals + 4 * c), ft_mapa(bar, p));
  }
}

// ------------------------------------------------------------ first product

// Two consumer sets of two warpgroups: a set takes a 64-row tile, each of
// its warpgroups BN / 2 of the block's BN columns.
constexpr int kFt1Sets = 2;
constexpr int kFt1Wgs = 2;  // warpgroups of a set
__host__ __device__ constexpr int ft1_threads(int bn) {
  return 128 * kFt1Wgs * kFt1Sets + 32;  // + the producer warp
}

// Shared memory of the first product's block, in bytes from a 1024-byte
// aligned base: the resident W1 slice (ktiles tiles of BN rows x 128
// bytes), the ring of x tiles (64 rows x 128 bytes), each set's staging
// tile of int8 codes, the 64 row maxima of each of its warpgroups, its two
// exchange slots ([cn][64] floats each), then the barriers.
struct Ft1Layout {
  int ring, out, rowmax, xmax, bars, total;
  __host__ __device__ Ft1Layout(int bn, int ktiles, int stages, int cn) {
    ring = ktiles * bn * kFtBK;
    out = ring + stages * 64 * kFtBK;
    rowmax = out + kFt1Sets * 64 * (bn + 16);
    xmax = rowmax + kFt1Sets * kFt1Wgs * 64 * 4;
    bars = xmax + kFt1Sets * 2 * cn * 64 * 4;
    total = bars + (2 * kFtMaxStages + 1 + 2 * kFt1Sets) * 8 + 1024;  // + the alignment
  }
};

struct Ft1Args {
  const float* xs;    // [M] x's row scales
  const float* ws;    // [F] W1's column scales
  const float* bias;  // [F]
  int M, F, tiles, ktiles, stages;
  int8_t* hq;         // [M, F]
  float* hs;          // [M]
};

// amap: int8 x [M, K], boxes of 128 K-bytes x 64 rows; wmap: int8 W1 [F,
// K], boxes of 128 K-bytes x BN rows; both in the 128-byte swizzle.
template <int BN, int EPI>
__global__ void __launch_bounds__(ft1_threads(BN), 1)
    ffn_tma_gemm1_kernel(const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap wmap, const Ft1Args g) {
  constexpr int WGS = kFt1Wgs, BW = BN / WGS;  // a set's warpgroups, a warpgroup's columns
  constexpr int ST = 128 * WGS;              // a set's threads
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* const sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Ft1Layout ly(BN, g.ktiles, g.stages, cn);
  const uint32_t s0 = smem_addr(sm), bar0 = s0 + ly.bars;
  auto full = [&](int st) { return bar0 + 8 * st; };
  auto empty = [&](int st) { return bar0 + 8 * (kFtMaxStages + st); };
  const uint32_t wbar = bar0 + 8 * 2 * kFtMaxStages;
  auto xbar = [&](int set, int slot) { return wbar + 8 * (1 + 2 * set + slot); };
  float* const xmax = reinterpret_cast<float*>(sm + ly.xmax);      // [set][slot][cn][64]
  float* const rowmax = reinterpret_cast<float*>(sm + ly.rowmax);  // [set][wg of set][64]
  const int cid = blockIdx.x / cn, ncl = gridDim.x / cn, n0 = rank * BN;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) {
      mbar_init(full(st), 1);   // the producer's expect_tx
      mbar_init(empty(st), 4 * WGS);  // one arrival a warp of the consuming set
    }
    mbar_init(wbar, 1);
    for (int i = 0; i < 2 * kFt1Sets; ++i) mbar_init(wbar + 8 * (1 + i), 1);  // armed a tile
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers are set before any peer's store reaches them
  cluster_arrive();
  cluster_wait();
  // the warpgroup's index, broadcast so that the compiler knows it uniform
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (wgi == WGS * kFt1Sets) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      prefetch_tensormap(&amap);
      prefetch_tensormap(&wmap);
      mbar_expect_tx(wbar, g.ktiles * BN * kFtBK);
      for (int kt = 0; kt < g.ktiles; ++kt)
        tma_load2(s0 + kt * BN * kFtBK, &wmap, kt * kFtBK, n0, wbar);
      int st = 0;
      uint32_t ph = 0;
      for (int t = cid; t < g.tiles; t += ncl) {
        for (int kt = 0; kt < g.ktiles; ++kt) {
          mbar_wait(empty(st), ph ^ 1);  // the first pass finds every stage free
          mbar_expect_tx(full(st), 64 * kFtBK);
          tma_load2(s0 + ly.ring + st * 64 * kFtBK, &amap, kt * kFtBK, t * 64, full(st));
          if (++st == g.stages) st = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // consumer set `set`: tiles set, set + 2, ... of this cluster's; its
  // warpgroup `part` takes columns part * BW .. part * BW + BW - 1
  const int set = wgi / WGS, part = wgi % WGS, stid = tid - set * ST;
  const int ltid = tid & 127, warp = ltid >> 5, g8 = lane >> 2, t4 = lane & 3;
  const int r_lo = warp * 16 + g8, r_hi = r_lo + 8;
  const int c0 = part * BW + 2 * t4;  // + 8j: this thread's columns of the block
  uint8_t* const ot = sm + ly.out + set * 64 * (BN + 16);
  float* const rmax = rowmax + set * WGS * 64;
  int acc[BW / 2];
  mbar_wait(wbar, 0);
  int k = 0;  // this set's tiles so far: the exchange's phase and slot
  for (int i = set, t = cid + set * ncl; t < g.tiles; i += kFt1Sets, t += kFt1Sets * ncl) {
    if (i > 0) ft_turn_wait(set, ST);  // the other set's main loop of tile i - 1 is done
    // the ring holds the cluster's tiles in order, ktiles stages each
    const int step = i * g.ktiles;
    int st = step % g.stages, prev = 0;
    uint32_t ph = (step / g.stages) & 1;
    for (int kt = 0; kt < g.ktiles; ++kt) {
      mbar_wait(full(st), ph);
      const uint64_t da = wgmma_desc(s0 + ly.ring + st * 64 * kFtBK);
      const uint64_t db = wgmma_desc(s0 + kt * BN * kFtBK + part * BW * kFtBK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFtBK / 32; ++kk)  // 32 bytes = 2 units of the start field
        FtMma<BW>::mma(acc, da + 2 * kk, db + 2 * kk, kt | kk);
      wgmma_commit();
      wgmma_wait<1>();  // the batch of K-step kt - 1 has retired: free its stage
      if (kt > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = st;
      if (++st == g.stages) st = 0, ph ^= 1;
    }
    if (t + ncl < g.tiles) ft_turn_open(set ^ 1, ST);  // tile i + 1 may start its main loop
    wgmma_wait<0>();
    ft_fence_sums(acc);
    if (lane == 0) mbar_arrive(empty(prev));
    // variant tail {
    // variant tail }

    // h = act((acc * xs) * s1 + b1), as the chain's first GEMM stores it;
    // rows past M hold zero sums and are never stored
    const int m0 = t * 64;
    const float xs_lo = m0 + r_lo < g.M ? g.xs[m0 + r_lo] : 0.f;
    const float xs_hi = m0 + r_hi < g.M ? g.xs[m0 + r_hi] : 0.f;
    float mx_lo = 0.f, mx_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BW / 8; ++j) {
      const int n = n0 + c0 + 8 * j;
      const float2 w2 = *reinterpret_cast<const float2*>(g.ws + n);
      const float2 b2 = *reinterpret_cast<const float2*>(g.bias + n);
      // variant act {
      const float h0 = epilogue<EPI>(acc[4 * j], xs_lo, w2.x, b2.x, 0.f);
      const float h1 = epilogue<EPI>(acc[4 * j + 1], xs_lo, w2.y, b2.y, 0.f);
      const float h2 = epilogue<EPI>(acc[4 * j + 2], xs_hi, w2.x, b2.x, 0.f);
      const float h3 = epilogue<EPI>(acc[4 * j + 3], xs_hi, w2.y, b2.y, 0.f);
      // variant act }
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
    if (t4 == 0) {
      rmax[part * 64 + r_lo] = mx_lo;
      rmax[part * 64 + r_hi] = mx_hi;
    }
    // every warpgroup's row maxima are in; every thread also stored the
    // previous tile's codes
    ft_set_sync(set, ST);
    float* const slot = xmax + (set * 2 + (k & 1)) * cn * 64;
    // variant exchange {
    // this exchange's barrier expects every block's 64 row maxima (a peer's
    // bytes may land before this arrival: the phase waits for both)
    if (stid == 0) mbar_expect_tx(xbar(set, k & 1), cn * 64 * 4);
    // the block's maxima, 16 bytes at a time, into slot `rank` of every block
    for (int q = stid; q < cn * 16; q += ST) {
      const int p = q % cn, c = q / cn;  // the peer, four rows
      float4 a = *reinterpret_cast<const float4*>(rmax + 4 * c);
#pragma unroll
      for (int w = 1; w < WGS; ++w) {
        const float4 b = *reinterpret_cast<const float4*>(rmax + w * 64 + 4 * c);
        a = make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
      }
      ft_st_async(ft_mapa(smem_addr(slot + rank * 64 + 4 * c), p), a,
                  ft_mapa(xbar(set, k & 1), p));
    }
    ft_wait_cluster(xbar(set, k & 1), (k >> 1) & 1);  // every block's maxima are in
    // variant exchange }
    float a_lo = 0.f, a_hi = 0.f;  // a maximum is exact in any order
    for (int p = 0; p < cn; ++p) {
      a_lo = fmaxf(a_lo, slot[p * 64 + r_lo]);
      a_hi = fmaxf(a_hi, slot[p * 64 + r_hi]);
    }
    const float s_lo = row_scale(a_lo), s_hi = row_scale(a_hi);
    const float i_lo = __frcp_rn(s_lo), i_hi = __frcp_rn(s_hi);
    // variant store {
    // quant_byte's codes, 32 at a time in two passes: each code by the
    // multiply, with no branch, marking in `near` the few whose quotient
    // lies near a half-integer (or is NaN); then, in the rare thread that
    // has one, those codes again by the IEEE quotient (quant_byte's own
    // fallback). A branch for each code, as quant_byte has, kept the codes
    // from overlapping. The clip to +-127 never acts here: |h| is at most
    // the row's maximum, so |q| <= 127 * (1 + 4 * 2^-24) rounds to 127.
#pragma unroll
    for (int j0 = 0; j0 < BW / 8; j0 += 8) {
      uint32_t near = 0;
#pragma unroll
      for (int j = j0; j < j0 + 8 && j < BW / 8; ++j) {
        const int c = c0 + 8 * j;
        uint32_t b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float q = __fmul_rn(__int_as_float(acc[4 * j + e]), e < 2 ? i_lo : i_hi);
          const float r = rintf(q);
          near |= (uint32_t)!(fabsf(fabsf(__fsub_rn(q, r)) - 0.5f) >= 1.0f / 8192)
                  << (4 * (j - j0) + e);
          b[e] = (uint32_t)__float2int_rn(r) & 0xFF;
        }
        *reinterpret_cast<uint16_t*>(ot + r_lo * (BN + 16) + c) = (uint16_t)(b[0] | b[1] << 8);
        *reinterpret_cast<uint16_t*>(ot + r_hi * (BN + 16) + c) = (uint16_t)(b[2] | b[3] << 8);
      }
      if (near) {
#pragma unroll
        for (int j = j0; j < j0 + 8 && j < BW / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (near >> (4 * (j - j0) + e) & 1)
              ot[(e < 2 ? r_lo : r_hi) * (BN + 16) + c0 + 8 * j + (e & 1)] =
                  (uint8_t)quant_code(__int_as_float(acc[4 * j + e]), e < 2 ? s_lo : s_hi);
          }
        }
      }
    }
    if (rank == 0 && part == 0 && t4 == 0) {
      if (m0 + r_lo < g.M) g.hs[m0 + r_lo] = s_lo;
      if (m0 + r_hi < g.M) g.hs[m0 + r_hi] = s_hi;
    }
    ft_set_sync(set, ST);  // the staging tile is whole
    for (int idx = stid; idx < 64 * (BN / 16); idx += ST) {
      const int r = idx / (BN / 16), c = (idx - r * (BN / 16)) * 16;
      if (m0 + r < g.M)
        *reinterpret_cast<uint4*>(g.hq + (size_t)(m0 + r) * g.F + n0 + c) =
            *reinterpret_cast<const uint4*>(ot + r * (BN + 16) + c);
    }
    // variant store }
    ++k;
  }
}

// ----------------------------------------------------------- second product

// Shared memory of the second product's block: the ring (a stage is 128
// rows of hq, then BN rows of W2, 128 K-bytes each), each consumer's row
// sums of the two LayerNorm exchanges, its exchange slots ([kind][slot]
// [rank][64]), then the barriers.
struct Ft2Layout {
  int stage, rowsum, xsum, bars, total;
  __host__ __device__ Ft2Layout(int bn, int stages) {
    stage = 128 * kFtBK + bn * kFtBK;
    rowsum = stages * stage;
    xsum = rowsum + kFtConsumers * 2 * 64 * 4;
    bars = xsum + kFtConsumers * 2 * 2 * kFtMaxCluster2 * 64 * 4;
    total = bars + (2 * kFtMaxStages + 4 * kFtConsumers) * 8 + 1024;  // + the alignment
  }
};

struct Ft2Args {
  const float* hs;     // [M] hq's row scales
  const float* ws;     // [N] W2's column scales
  const float* bias;   // [N]
  const void* resid;   // LN: x [M, N] of OT
  const float* ln_g;   // LN: [N]
  const float* ln_b;   // LN: [N]
  float eps;
  int M, N, tiles, ktiles, stages, col_tiles;
  void* out;           // [M, N] of OT
};

__device__ __forceinline__ void ft_load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x, b = f.y;
}
__device__ __forceinline__ void ft_load2(const float* p, float& a, float& b) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  a = f.x, b = f.y;
}

// amap: int8 hq [M, K], boxes of 128 K-bytes x 128 rows; wmap: int8 W2 [N,
// K], boxes of 128 K-bytes x BN rows. LN: a cluster of N / BN blocks spans
// N; else clusters of one, col_tiles column tiles a row tile.
template <int BN, bool LN, typename OT>
__global__ void __launch_bounds__(kFtThreads, 1)
    ffn_tma_gemm2_kernel(const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap wmap, const Ft2Args g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Ft2Layout ly(BN, g.stages);
  const uint32_t s0 = smem_addr(sm), bar0 = s0 + ly.bars;
  auto full = [&](int st) { return bar0 + 8 * st; };
  auto empty = [&](int st) { return bar0 + 8 * (kFtMaxStages + st); };
  auto xbar = [&](int wg, int kind, int slot) {
    return bar0 + 8 * (2 * kFtMaxStages + 4 * wg + 2 * kind + slot);
  };
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cn, ncl = gridDim.x / cn;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kFtConsumers);  // one arrival a consumer warp
    }
    for (int i = 0; i < 4 * kFtConsumers; ++i)  // armed by ft_arm: one arrival, the bytes
      mbar_init(bar0 + 8 * (2 * kFtMaxStages + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();
  cluster_wait();
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  // tile t: row tile t / col_tiles, this block's columns of column tile t % col_tiles
  auto col0 = [&](int t) { return ((t % g.col_tiles) * cn + rank) * BN; };

  if (wgi == kFtConsumers) {
    if (lane == 0) {
      prefetch_tensormap(&amap);
      prefetch_tensormap(&wmap);
      int st = 0;
      uint32_t ph = 0;
      for (int t = cid; t < g.tiles; t += ncl) {
        const int m0 = t / g.col_tiles * 128, n0 = col0(t);
        for (int kt = 0; kt < g.ktiles; ++kt) {
          mbar_wait(empty(st), ph ^ 1);
          const uint32_t dst = s0 + st * ly.stage;
          mbar_expect_tx(full(st), ly.stage);
          tma_load2(dst, &amap, kt * kFtBK, m0, full(st));
          tma_load2(dst + 128 * kFtBK, &wmap, kt * kFtBK, n0, full(st));
          if (++st == g.stages) st = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of every tile
  const int wg = wgi, ltid = tid & 127, warp = ltid >> 5, g8 = lane >> 2, t4 = lane & 3;
  float* const rsum = reinterpret_cast<float*>(sm + ly.rowsum) + wg * 2 * 64;  // [kind][64]
  float* const xsum = reinterpret_cast<float*>(sm + ly.xsum) + wg * 2 * 2 * kFtMaxCluster2 * 64;
  int acc[BN / 2];
  int st = 0, k = 0;
  uint32_t ph = 0;
  for (int t = cid; t < g.tiles; t += ncl, ++k) {
    int prev = 0;
    for (int kt = 0; kt < g.ktiles; ++kt) {
      mbar_wait(full(st), ph);
      const uint32_t a = s0 + st * ly.stage;
      const uint64_t da = wgmma_desc(a + wg * 64 * kFtBK), db = wgmma_desc(a + 128 * kFtBK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFtBK / 32; ++kk)
        FtMma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, kt | kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = st;
      if (++st == g.stages) st = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    ft_fence_sums(acc);
    if (lane == 0) mbar_arrive(empty(prev));

    const int m_lo = t / g.col_tiles * 128 + wg * 64 + warp * 16 + g8, m_hi = m_lo + 8;
    const int n0 = col0(t);
    const bool in_lo = m_lo < g.M, in_hi = m_hi < g.M;
    const float hs_lo = in_lo ? g.hs[m_lo] : 0.f, hs_hi = in_hi ? g.hs[m_hi] : 0.f;
    OT* const out = static_cast<OT*>(g.out);
    if constexpr (!LN) {
      constexpr int EPI = sizeof(OT) == 4 ? kEpiF32 : kEpiBf16;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        const float2 w2 = *reinterpret_cast<const float2*>(g.ws + n);
        const float2 b2 = *reinterpret_cast<const float2*>(g.bias + n);
        if (in_lo)
          store2(out + (size_t)m_lo * g.N + n, epilogue<EPI>(acc[4 * j], hs_lo, w2.x, b2.x, 0.f),
                 epilogue<EPI>(acc[4 * j + 1], hs_lo, w2.y, b2.y, 0.f));
        if (in_hi)
          store2(out + (size_t)m_hi * g.N + n,
                 epilogue<EPI>(acc[4 * j + 2], hs_hi, w2.x, b2.x, 0.f),
                 epilogue<EPI>(acc[4 * j + 3], hs_hi, w2.y, b2.y, 0.f));
      }
    } else {
      const OT* const resid = static_cast<const OT*>(g.resid);
      if (ltid == 0) {  // this tile's two exchanges expect every block's 64 row sums
        mbar_expect_tx(xbar(wg, 0, k & 1), cn * 64 * 4);
        mbar_expect_tx(xbar(wg, 1, k & 1), cn * 64 * 4);
      }
      float s_lo = 0.f, s_hi = 0.f;  // this thread's part of its rows' sums
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        const float2 w2 = *reinterpret_cast<const float2*>(g.ws + n);
        const float2 b2 = *reinterpret_cast<const float2*>(g.bias + n);
        float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
        if (in_lo) ft_load2(resid + (size_t)m_lo * g.N + n, x0, x1);
        if (in_hi) ft_load2(resid + (size_t)m_hi * g.N + n, x2, x3);
        const float v0 = epilogue<kEpiResidFirst>(acc[4 * j], hs_lo, w2.x, b2.x, x0);
        const float v1 = epilogue<kEpiResidFirst>(acc[4 * j + 1], hs_lo, w2.y, b2.y, x1);
        const float v2 = epilogue<kEpiResidFirst>(acc[4 * j + 2], hs_hi, w2.x, b2.x, x2);
        const float v3 = epilogue<kEpiResidFirst>(acc[4 * j + 3], hs_hi, w2.y, b2.y, x3);
        s_lo = __fadd_rn(__fadd_rn(s_lo, v0), v1);
        s_hi = __fadd_rn(__fadd_rn(s_hi, v2), v3);
        acc[4 * j] = __float_as_int(v0);
        acc[4 * j + 1] = __float_as_int(v1);
        acc[4 * j + 2] = __float_as_int(v2);
        acc[4 * j + 3] = __float_as_int(v3);
      }
      // a row's total over the cluster, blocks in rank order, over N
      const int r_lo = warp * 16 + g8, r_hi = r_lo + 8;
      auto row_total = [&](int kind, float lo, float hi, float& out_lo, float& out_hi) {
        lo = __fadd_rn(lo, __shfl_xor_sync(0xffffffffu, lo, 1));
        lo = __fadd_rn(lo, __shfl_xor_sync(0xffffffffu, lo, 2));
        hi = __fadd_rn(hi, __shfl_xor_sync(0xffffffffu, hi, 1));
        hi = __fadd_rn(hi, __shfl_xor_sync(0xffffffffu, hi, 2));
        if (t4 == 0) {
          rsum[kind * 64 + r_lo] = lo;
          rsum[kind * 64 + r_hi] = hi;
        }
        ft_wg_sync(wg);
        float* const slot = xsum + (kind * 2 + (k & 1)) * kFtMaxCluster2 * 64;
        ft_send_rows(rsum + kind * 64, slot, xbar(wg, kind, k & 1), rank, cn, ltid);
        ft_wait_cluster(xbar(wg, kind, k & 1), (k >> 1) & 1);
        float a = 0.f, b = 0.f;
        for (int p = 0; p < cn; ++p) {
          a = __fadd_rn(a, slot[p * 64 + r_lo]);
          b = __fadd_rn(b, slot[p * 64 + r_hi]);
        }
        out_lo = __fdiv_rn(a, (float)g.N);
        out_hi = __fdiv_rn(b, (float)g.N);
      };
      float mean_lo, mean_hi, var_lo, var_hi;
      row_total(0, s_lo, s_hi, mean_lo, mean_hi);
      float q_lo = 0.f, q_hi = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c_lo = __fadd_rn(__int_as_float(acc[4 * j + e]), -mean_lo);
          const float c_hi = __fadd_rn(__int_as_float(acc[4 * j + 2 + e]), -mean_hi);
          q_lo = __fadd_rn(q_lo, __fmul_rn(c_lo, c_lo));
          q_hi = __fadd_rn(q_hi, __fmul_rn(c_hi, c_hi));
        }
      }
      row_total(1, q_lo, q_hi, var_lo, var_hi);
      const float rs_lo = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var_lo, g.eps)));
      const float rs_hi = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var_hi, g.eps)));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        const float2 g2 = *reinterpret_cast<const float2*>(g.ln_g + n);
        const float2 bb = *reinterpret_cast<const float2*>(g.ln_b + n);
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mean = e < 2 ? mean_lo : mean_hi, rs = e < 2 ? rs_lo : rs_hi;
          const float c = __fmul_rn(__fadd_rn(__int_as_float(acc[4 * j + e]), -mean), rs);
          o[e] = __fadd_rn(__fmul_rn(c, (e & 1) ? g2.y : g2.x), (e & 1) ? bb.y : bb.x);
        }
        if (in_lo) store2(out + (size_t)m_lo * g.N + n, o[0], o[1]);
        if (in_hi) store2(out + (size_t)m_hi * g.N + n, o[2], o[3]);
      }
    }
  }
}

// ---------------------------------------------------------------- x's rows

// x's row quantize for the first product (hr_rowquant's, div127 = 0): one
// warp a row, 16-byte loads, eight rows a block. The row's |max| is exact
// in any order, and quant_byte (csrc/cluster_gemm.cuh) gives quant_code's
// byte for every |v| up to it, so scales and codes are hr_rowquant's bits.
// hr_rowquant's block of 256 threads a row left most of them idle at the
// served 768 columns. K % 16 == 0.
template <typename T>
__global__ void __launch_bounds__(256) ffn_tma_xquant_kernel(const T* __restrict__ x, int M,
                                                             int K, int8_t* __restrict__ q,
                                                             float* __restrict__ s) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte load
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* const xr = x + (size_t)row * K;
  int8_t* const qr = q + (size_t)row * K;
  auto load = [&](int i, float (&v)[8]) {
    if constexpr (VEC == 8) {
      load8(xr + i, v);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(xr + i);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    }
  };
  float amax = 0.f;
  for (int i = lane * VEC; i < K; i += 32 * VEC) {
    float v[8];
    load(i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = warp_max(amax);
  const float sc = row_scale(amax), inv = __frcp_rn(sc);
  for (int i = lane * VEC; i < K; i += 32 * VEC) {
    float v[8];
    load(i, v);
    uint32_t pk[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < VEC; ++e) pk[e >> 2] |= quant_byte(v[e], sc, inv) << (8 * (e & 3));
    if constexpr (VEC == 8)
      *reinterpret_cast<uint2*>(qr + i) = make_uint2(pk[0], pk[1]);
    else
      *reinterpret_cast<uint32_t*>(qr + i) = pk[0];
  }
  if (lane == 0) s[row] = sc;
}

// int8 [rows, K] for TMA boxes of 128 K-bytes x box_rows rows in the
// 128-byte swizzle (rows and K-bytes past the dims read as zeros). False
// where cuTensorMapEncodeTiled refuses it.
inline bool ft_map(CUtensorMap* map, const void* base, int K, long long rows, int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {kFtBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The most stages of the ring that fit beside the rest, or 0 below two.
inline int ft1_stages(int bn, int K, int cn) {
  const int kt = (K + kFtBK - 1) / kFtBK;
  const int fixed = Ft1Layout(bn, kt, 0, cn).total;
  const int n = (kFtSmemMax - fixed) / (64 * kFtBK);
  return n < 2 ? 0 : (n > kFtMaxStages ? kFtMaxStages : n);
}
inline int ft2_stages(int bn) {
  const Ft2Layout ly(bn, 0);
  const int n = (kFtSmemMax - ly.total) / ly.stage;
  return n < 2 ? 0 : (n > kFtMaxStages ? kFtMaxStages : n);
}

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

// Launches `kernel` on `clusters` clusters of cn blocks with `smem` bytes,
// or with `query` asks how many such clusters the card runs at once.
template <typename Args>
cudaError_t ft_launch(const void* kernel, bool* attr_set, int threads, int cn, int clusters,
                      int smem,
                      const CUtensorMap& a, const CUtensorMap& w, const Args& g, cudaStream_t s,
                      int* query) {
  if (!*attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFtSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cn * (clusters > 0 ? clusters : 1), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (query) return cudaOccupancyMaxActiveClusters(query, kernel, &cfg);
  void* args[3] = {const_cast<CUtensorMap*>(&a), const_cast<CUtensorMap*>(&w),
                   const_cast<Args*>(&g)};
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

template <int BN, int EPI>
cudaError_t ft1_instance(int cn, int clusters, int smem, const CUtensorMap& a,
                         const CUtensorMap& w, const Ft1Args& g, cudaStream_t s, int* query) {
  static bool attr_set = false;  // one per instantiation
  return ft_launch((const void*)ffn_tma_gemm1_kernel<BN, EPI>, &attr_set, ft1_threads(BN), cn,
                   clusters, smem, a, w, g, s, query);
}

template <int BN>
cudaError_t ft1_epi(int epi, int cn, int clusters, int smem, const CUtensorMap& a,
                    const CUtensorMap& w, const Ft1Args& g, cudaStream_t s, int* query) {
  switch (epi) {
    case kEpiGeluF32: return ft1_instance<BN, kEpiGeluF32>(cn, clusters, smem, a, w, g, s, query);
    case kEpiGeluErfF32:
      return ft1_instance<BN, kEpiGeluErfF32>(cn, clusters, smem, a, w, g, s, query);
    case kEpiReluF32: return ft1_instance<BN, kEpiReluF32>(cn, clusters, smem, a, w, g, s, query);
    default: return cudaErrorInvalidValue;
  }
}

// The first product at F = cn * bn (cn a power of two up to 16), K % 16 ==
// 0; with `query`, the clusters the card runs at once.
cudaError_t ft1(const void* xq, const void* xs, int M, int K, const void* wmap_bytes,
                const void* ws, const void* b, int F, int epi, int bn, int clusters, void* hq,
                void* hs, cudaStream_t stream, int* query) {
  if ((bn != 128 && bn != 192) || F % bn || K % 16 || K <= 0) return cudaErrorInvalidValue;
  const int cn = F / bn;
  if (cn < 1 || cn > kFtMaxCluster1 || (cn & (cn - 1))) return cudaErrorInvalidValue;
  const int stages = ft1_stages(bn, K, cn);
  if (stages == 0) return cudaErrorInvalidValue;
  const int kt = (K + kFtBK - 1) / kFtBK;
  const int smem = Ft1Layout(bn, kt, stages, cn).total;
  CUtensorMap amap, wmap;
  memset(&amap, 0, sizeof(amap));
  memset(&wmap, 0, sizeof(wmap));
  if (!query && (wmap_bytes == nullptr || !ft_map(&amap, xq, K, M, 64)))
    return cudaErrorInvalidValue;
  if (!query) memcpy(&wmap, wmap_bytes, sizeof(wmap));
  const Ft1Args g{static_cast<const float*>(xs), static_cast<const float*>(ws),
                  static_cast<const float*>(b),  M, F, (M + 63) / 64, kt, stages,
                  static_cast<int8_t*>(hq), static_cast<float*>(hs)};
  if (!query && clusters > g.tiles) clusters = g.tiles;
  return bn == 192 ? ft1_epi<192>(epi, cn, clusters, smem, amap, wmap, g, stream, query)
                   : ft1_epi<128>(epi, cn, clusters, smem, amap, wmap, g, stream, query);
}

template <int BN, bool LN, typename OT>
cudaError_t ft2_instance(int cn, int clusters, int smem, const CUtensorMap& a,
                         const CUtensorMap& w, const Ft2Args& g, cudaStream_t s, int* query) {
  static bool attr_set = false;
  return ft_launch((const void*)ffn_tma_gemm2_kernel<BN, LN, OT>, &attr_set, kFtThreads, cn,
                   clusters, smem, a, w, g, s, query);
}

template <int BN>
cudaError_t ft2_form(int ln, int out_f32, int cn, int clusters, int smem, const CUtensorMap& a,
                     const CUtensorMap& w, const Ft2Args& g, cudaStream_t s, int* query) {
  if (ln) {
    if constexpr (BN == 128)
      return out_f32
                 ? ft2_instance<BN, true, float>(cn, clusters, smem, a, w, g, s, query)
                 : ft2_instance<BN, true, __nv_bfloat16>(cn, clusters, smem, a, w, g, s, query);
    else
      return cudaErrorInvalidValue;
  }
  return out_f32 ? ft2_instance<BN, false, float>(cn, clusters, smem, a, w, g, s, query)
                 : ft2_instance<BN, false, __nv_bfloat16>(cn, clusters, smem, a, w, g, s, query);
}

// The second product over K inputs and N = cn * bn outputs (LN: 128
// columns a block, cn up to 8; else one-block clusters over N / bn column
// tiles); with `query`, the clusters the card runs at once.
cudaError_t ft2(const void* hq, const void* hs, int M, int K, const void* wmap_bytes,
                const void* ws, const void* b, int N, const void* resid, const void* ln_g,
                const void* ln_b, float eps, int out_f32, int ln, int bn, int clusters, void* out,
                cudaStream_t stream, int* query) {
  if ((bn != 128 && bn != 192) || (ln && bn != 128) || N % bn || K % 16 || K <= 0)
    return cudaErrorInvalidValue;
  const int cn = ln ? N / bn : 1;
  if (cn < 1 || cn > kFtMaxCluster2) return cudaErrorInvalidValue;
  const int stages = ft2_stages(bn);
  if (stages == 0) return cudaErrorInvalidValue;
  const int smem = Ft2Layout(bn, stages).total;
  CUtensorMap amap, wmap;
  memset(&amap, 0, sizeof(amap));
  memset(&wmap, 0, sizeof(wmap));
  if (!query && (wmap_bytes == nullptr || !ft_map(&amap, hq, K, M, 128)))
    return cudaErrorInvalidValue;
  if (!query) memcpy(&wmap, wmap_bytes, sizeof(wmap));
  const int col_tiles = N / (bn * cn);
  const Ft2Args g{static_cast<const float*>(hs), static_cast<const float*>(ws),
                  static_cast<const float*>(b),  resid, static_cast<const float*>(ln_g),
                  static_cast<const float*>(ln_b), eps, M, N, (M + 127) / 128 * col_tiles,
                  (K + kFtBK - 1) / kFtBK, stages, col_tiles, out};
  if (!query && clusters > g.tiles) clusters = g.tiles;
  return bn == 192 ? ft2_form<192>(ln, out_f32, cn, clusters, smem, amap, wmap, g, stream, query)
                   : ft2_form<128>(ln, out_f32, cn, clusters, smem, amap, wmap, g, stream, query);
}

}  // namespace

}  // namespace hr

using namespace hr;

extern "C" {

// x [M, K] bf16 or fp32 (x_f32) -> q [M, K] int8 and s [M] fp32, hr_rowquant's
// bits (div127 = 0). K % 16 == 0, pointers 16-byte aligned.
int hr_ffn_tma_xquant(const void* x, int x_f32, int M, int K, void* q, void* s, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + 7) / 8);
  if (x_f32)
    ffn_tma_xquant_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x), M, K,
                                                static_cast<int8_t*>(q), static_cast<float*>(s));
  else
    ffn_tma_xquant_kernel<<<grid, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x), M, K,
                                                static_cast<int8_t*>(q), static_cast<float*>(s));
  return (int)cudaGetLastError();
}

// A weight's tensor map for either product: w [rows, K] int8 in boxes of
// box_rows (128 or 192) rows by 128 K-bytes, in the 128-byte swizzle,
// written to the 128 host bytes at `map`. The map holds w's address: it is
// encoded once a weight and block width (the wrapper keeps it while w lives)
// and stays valid while w does.
int hr_ffn_tma_wmap(const void* w, int K, int rows, int box_rows, void* map) {
  if (w == nullptr || map == nullptr || K <= 0 || K % 16 || rows <= 0 ||
      (box_rows != 128 && box_rows != 192))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memset(&m, 0, sizeof(m));
  if (!ft_map(&m, w, K, rows, box_rows)) return (int)cudaErrorInvalidValue;
  memcpy(map, &m, sizeof(m));
  return 0;
}

// xq [M, K] int8 and xs [M] fp32 (hr_ffn_tma_xquant or hr_rowquant of x);
// wmap W1's map (hr_ffn_tma_wmap of w [F, K] int8 at box_rows bn), ws [F]
// and b [F] fp32; out hq [M, F] int8 and hs [M] fp32, bit-equal to
// hr_rowquant of hr_int8_gemm's epilogue `epi` (kEpiGeluF32,
// kEpiGeluErfF32, kEpiReluF32). bn (128 or 192) columns a block, F / bn a
// power of two up to 16 blocks a cluster; `clusters` persistent clusters
// (at most the row tiles; hr_ffn_tma_gemm1_clusters says how many fit).
// K % 16 == 0, every pointer 16-byte aligned (the wrapper checks).
int hr_ffn_tma_gemm1(const void* xq, const void* xs, int M, int K, const void* wmap,
                     const void* ws, const void* b, int F, int epi, int bn, int clusters,
                     void* hq, void* hs, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  const cudaError_t err = ft1(xq, xs, M, K, wmap, ws, b, F, epi, bn, clusters, hq, hs,
                              static_cast<cudaStream_t>(stream), nullptr);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many clusters of hr_ffn_tma_gemm1's instance the card runs at once
// (cudaOccupancyMaxActiveClusters), 0 where it fits none, or minus the CUDA
// error (an invalid shape).
int hr_ffn_tma_gemm1_clusters(int K, int F, int epi, int bn) {
  int n = 0;
  const cudaError_t err = ft1(nullptr, nullptr, 1, K, nullptr, nullptr, nullptr, F, epi, bn, 1,
                              nullptr, nullptr, nullptr, &n);
  return err != cudaSuccess ? -(int)err : n;
}

// hq [M, K] int8 and hs [M] fp32; wmap W2's map (hr_ffn_tma_wmap of w
// [N, K] int8 at box_rows bn), ws [N] and b [N] fp32; out [M, N] bf16 or
// fp32 (out_f32). ln: LN((resid + v) + b) with resid [M, N] of out's type
// and ln_g, ln_b [N] fp32, bn 128, a cluster of N / 128 blocks (up to 8);
// else v + b as hr_int8_gemm's kEpiBf16 / kEpiF32 stores it, bn 128 or
// 192; `clusters` persistent clusters.
int hr_ffn_tma_gemm2(const void* hq, const void* hs, int M, int K, const void* wmap,
                     const void* ws, const void* b, int N, const void* resid, const void* ln_g,
                     const void* ln_b, float eps, int out_f32, int ln, int bn, int clusters,
                     void* out, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  const cudaError_t err = ft2(hq, hs, M, K, wmap, ws, b, N, resid, ln_g, ln_b, eps, out_f32, ln, bn,
                              clusters, out, static_cast<cudaStream_t>(stream), nullptr);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int hr_ffn_tma_gemm2_clusters(int K, int N, int out_f32, int ln, int bn) {
  int n = 0;
  const cudaError_t err = ft2(nullptr, nullptr, 1, K, nullptr, nullptr, nullptr, N, nullptr,
                              nullptr, nullptr, 0.f, out_f32, ln, bn, 1, nullptr, nullptr, &n);
  return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
