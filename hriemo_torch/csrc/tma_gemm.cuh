// A bf16 GEMM in the form of a fast Hopper kernel (tma_gemm_kernel): TMA
// loads issued by one producer warp into a ring of shared-memory stages
// guarded by mbarriers, two consumer warpgroups on wgmma, and a persistent
// grid whose epilogues overlap the next tile's loads. It carries the conv
// stack's stride-2 convs conv1..6 in bf16 (csrc/conv_stack.cu
// hr_conv_s2_tma: K1's conv1..3 and K2's conv4..6, the GEMMs of
// hriemo/ops/conv_stack.py::_k1_kernel and ::_k2_kernel, pallas_calls at
// :243 and :263) and, where it is no slower, the float FFN's two products
// (csrc/ffn_bf16.cu hr_ffn_gemms_tma). It stands beside csrc/float_wgmma.cuh,
// whose all-thread cp.async pipeline keeps the fp32 3xTF32 instances.
//
// C = epilogue(A . W^T), fp32 sums, bf16 operands, K taken in taps: K-step
// s lies in tap j = s / ksteps_tap at K-offset (s % ksteps_tap) * 64 of the
// tap; A's rows of tap j are rows m + (j >> 1) of tensor map j & 1, W's
// rows of tap j are rows j * wrow_tap + n of the W map. A plain GEMM is one
// tap on map 0. A stride-2 conv with k taps over x [B, t_in, C] reads its
// output row r of tap j as input row 2r + j: map 0 holds x's even rows
// (global row stride 2C, ceil(t_in / 2) rows), map 1 its odd rows (base x +
// C, floor(t_in / 2) rows), so tap 0 is even row r, tap 1 odd row r, tap 2
// even row r + 1. W is the tap-major [k, C_out, C_in] weights as they are.
//
// Design.
// - A tile is 128 rows by BN = 256 (or 128) columns: consumer warpgroup c
//   owns rows 64c..64c+63 and all BN columns (wgmma.m64nBNk16, 128 or 64
//   fp32 sums a thread), so every W tile staged feeds 128 rows and every A
//   tile BN columns. A stage is one 128-byte swizzle row of K (64 bf16) of
//   the A tile and the W tile: 48 KB at BN = 256 in a 4-stage ring, 32 KB
//   at 128 in a 6-stage ring (192 KB either way).
// - The producer warp (one lane) walks the block's tiles and K-steps ahead
//   of the consumers: it waits for a stage's empty barrier, arms its full
//   barrier with the stage's bytes and issues the A and W boxes by TMA,
//   which write the 128-byte swizzle that the wgmma descriptors name and
//   fill rows past a map's dims with zeros. The consumers wait on the full
//   barrier, issue four wgmma (k16 each), keep one batch in flight, and
//   free the previous stage by arriving on its empty barrier (one arrival a
//   warp): the main loop has no __syncthreads.
// - The grid is persistent: about one block an SM (the caller's plan,
//   ops/_cuda.py tma_gemm_plan), block i taking tiles i, i + grid, ...;
//   tiles are numbered with the column tile fastest, then the row tile,
//   then the batch element, so the blocks that read one A row tile run
//   side by side and share it in L2. While the consumers run a tile's
//   epilogue, the producer already fills the ring with the next tile's
//   first stages.
// - Epilogue (kFepGelu, the convs): T(gelu(acc)) in IEEE operations, as
//   csrc/float_epilogue.cuh's epi_store rounds it, 64 columns a pass, written
//   by each warpgroup into a 64 x 64 staging tile in the 128-byte swizzle
//   (conflict-free: the 8 rows of a store land in 8 distinct 16-byte
//   chunks), then stored by one TMA store from two alternating buffers; the
//   output map's row count is the conv's length, so rows past M are never
//   stored. The GELU's form (tanh or erf) is chosen once a pass: chosen per
//   element, the compiler computed both forms of every sum and the 256-
//   column tile ran at 22% of its bound. The FFN's forms (bias + GELU to T,
//   residual + bias to fp32) store from registers through epi_store.
// - The "// variant NAME {" ... "}" comments mark the parts that
//   chip_conv_gemm_variants.py replaces in its copies of this file.
// - 288 threads (two consumer warpgroups and the producer warp), one block
//   an SM, no setmaxnreg. At this launch bound ptxas allots at most 168
//   registers a thread: the convs' instances take 165 (BN 128) and 168 (BN
//   256) with no spill; the FFN's take 126 (bias-GELU) and 128 (residual) at
//   BN 128, and 168 at BN 256 with 104 and 32 bytes spilled.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_conv_routes.py
// --gemms and chip_conv_gemm_variants.py, PERF.md section 6): the
// epilogue, which no product overlaps (a 128 x 256 tile's sums take both
// warpgroups' registers). At the served pairs the convs run at 50-60% of
// their bf16 bound (K1's three at 1.25 s x 384: 3.85 ms against 2.14, the
// parent pipeline 7.07); without the epilogue the 256-column main loop
// reads 88-99% of it, without the GELU (the stores kept) 67-74%. The
// 128-column tile stages A twice as often for each product and its main
// loop alone reads 57-79%; at one wave it takes 1.05-1.17 times half the
// 256-column tile's time, so the plan takes it only where it cuts waves.
//
// Where the trouble lies, and what the design does:
// - TMA's box is at most 256 elements a dimension and its global strides
//   multiples of 16 bytes. A stride-2 box (elementStrides 2) of 128 rows
//   would need 256 elements; instead each parity of the rows is a map of
//   its own, with a row stride of 2C (2048 bytes), so every box is a plain
//   128-row box and the maps' row counts bound every tap exactly. An odd
//   t_in gives the even map one row more than the odd one: the last output
//   row's tap 2 reads row t_in - 1, the even map's last row.
// - The batch dimension of each map bounds each element: a row tile that
//   runs past the conv's rows reads zeros, never the next element's rows.
// - The 128-byte swizzle TMA writes (16-byte chunk c of row r at c ^ (r %
//   8), tiles on 1024-byte boundaries) is the layout that wgmma_desc
//   (csrc/int8_gemm.cuh) names, as its cp.async loader writes it.
// - wgmma writes the sums asynchronously, which the compiler does not
//   see: they are fenced as registers after the last wait of a tile, so no
//   epilogue read moves above it.
// - wgmma is serialized where the compiler takes the warpgroup index for
//   divergent: the index is broadcast by a shuffle (as in
//   csrc/onepass_wgmma.cuh).
// - setmaxnreg: the convs' 128 sums a thread fit in the 168 registers
//   without it; the FFN's 256-column instances spill a little (above), which
//   its readings include.
// - Thin grids (conv5 and conv6 of one short clip: a few tiles) leave SMs
//   idle: the plan takes 128-column tiles where they cut the waves, as many
//   blocks as the parent's 128 x 128 tiles gave there.
#pragma once

#include "float_epilogue.cuh"
#include "int8_gemm.cuh"
#include "tma.cuh"

namespace hr {

constexpr int kTgBM = 128;                            // rows of a tile
constexpr int kTgBK = 64;                             // bf16 K elements of a stage (128 bytes)
constexpr int kTgConsumers = 2;                       // consumer warpgroups of 64 rows
constexpr int kTgThreads = 128 * kTgConsumers + 32;   // + the producer warp
constexpr int kTgEpiBytes = 64 * 128;                 // a 64 x 64 bf16 staging tile

template <int BN>
struct TgLayout {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = kTgBM * 128, STAGE = A_BYTES + BN * 128;
  static constexpr int EPI_OFF = STAGES * STAGE;                  // two staging tiles a consumer
  static constexpr int BAR_OFF = EPI_OFF + kTgConsumers * 2 * kTgEpiBytes;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;   // + the alignment
  static_assert(SMEM <= 232448, "shared memory of one block");
};

struct TgArgs {
  int taps, ksteps_tap;   // K = taps * ksteps_tap * 64 (past K: zeros from the maps)
  int wrow_tap;           // W rows of tap j start at row j * wrow_tap of the W map
  int m_tiles, n_tiles, tiles;
  FloatGemmArgs f;        // M, N, fast and, for epi_store, bias, resid, out, ldo
};

// d (+)= A . B^T over 16 K elements: A 64 rows, B BN rows, both K-major in
// the 128-byte swizzle; d = A . B^T when `accumulate` is 0. Layout as
// csrc/float_wgmma.cuh's wgmma_bf16: d[4j + e] of warp w holds row 16w + g
// (+ 8 for e >= 2), column 8j + 2t + (e & 1).
template <int BN>
struct TgMma;

template <>
struct TgMma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct TgMma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

// The sums as registers the compiler may not read before this point: wgmma
// writes them asynchronously, which the compiler does not see, so without
// this it could move the epilogue's first reads above wgmma.wait_group.
template <int N>
__device__ __forceinline__ void tg_fence_sums(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One epilogue pass of the convs: T(gelu(acc)) of columns 64c .. 64c + 63
// of this thread's two rows, into its warpgroup's staging tile e (64 rows of
// 128 bytes in the 128-byte swizzle: 16-byte chunk jj of row r at jj ^ (r %
// 8); the 8 rows of one store land in 8 distinct chunks, no bank conflict).
template <bool FAST, int N>
__device__ __forceinline__ void tg_gelu_pass(const float (&acc)[N], int c, uint8_t* e, int warp,
                                             int g8, int t4) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g8 + 8 * h, i = 4 * (8 * c + jj) + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(e + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t4) =
          // variant gelu {
          FAST ? __floats2bfloat162_rn(gelu_tanh(acc[i]), gelu_tanh(acc[i + 1]))
               : __floats2bfloat162_rn(gelu_erf(acc[i]), gelu_erf(acc[i + 1]));
          // variant gelu }
    }
  }
}

// One register epilogue pass of the FFN's forms: epi_store of acc[0, 32),
// columns n0 .. n0 + 63 of this thread's rows r0 and r0 + 8, in the GELU
// form FAST.
template <int EPI, int FAST, int N>
__device__ __forceinline__ void tg_store_pass(const FloatGemmArgs& f, const float (&acc)[N],
                                              size_t zo, int r0, int n0, int t4) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int n = n0 + 8 * jj + 2 * t4;  // N is even: n + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (n < f.N && m < f.M)
        epi_store<EPI, __nv_bfloat16, FAST>(f, zo + (size_t)m * f.ldo + n, m, n,
                                            acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
  }
}

// named barrier of consumer warpgroup `wg`'s 128 threads (0 is __syncthreads)
__device__ __forceinline__ void tg_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Output tile t: (batch element, first row, first column)
struct TgTile {
  int b, m0, n0;
};
__device__ __forceinline__ TgTile tg_tile(const TgArgs& g, int t, int bn) {
  const int nt = t % g.n_tiles, r = t / g.n_tiles;
  return {r / g.m_tiles, (r % g.m_tiles) * kTgBM, nt * bn};
}

// A maps amap0 / amap1 [B, rows, K of a tap] (3D), W map [rows, K of a tap]
// (2D), out map [B, M, N] (3D; kFepGelu only, boxes of 64 x 64).
template <int BN, int EPI>
__global__ void __launch_bounds__(kTgThreads, 1)
    tma_gemm_kernel(const __grid_constant__ CUtensorMap amap0,
                    const __grid_constant__ CUtensorMap amap1,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap, const TgArgs g) {
  using T = __nv_bfloat16;
  using Ly = TgLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* const sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(sm), bar0 = s0 + Ly::BAR_OFF;
  auto full = [&](int st) { return bar0 + 8 * st; };
  auto empty = [&](int st) { return bar0 + 8 * (Ly::STAGES + st); };
  const int tid = threadIdx.x, lane = tid & 31;
  const int ksteps = g.taps * g.ksteps_tap;

  if (tid == 0) {
    for (int st = 0; st < Ly::STAGES; ++st) {
      mbar_init(full(st), 1);                     // the producer's expect_tx
      mbar_init(empty(st), 4 * kTgConsumers);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup's index, broadcast so that the compiler knows it uniform
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (wgi == kTgConsumers) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      prefetch_tensormap(&amap0);
      prefetch_tensormap(&amap1);
      prefetch_tensormap(&wmap);
      int st = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const TgTile tl = tg_tile(g, t, BN);
        for (int s = 0; s < ksteps; ++s) {
          const int tap = s / g.ksteps_tap, k0 = (s - tap * g.ksteps_tap) * kTgBK;
          mbar_wait(empty(st), ph ^ 1);  // the first pass finds every stage free
          const uint32_t dst = s0 + st * Ly::STAGE;
          // variant loads {
          mbar_expect_tx(full(st), Ly::STAGE);
          if (tap & 1)
            tma_load3(dst, &amap1, k0, tl.m0 + (tap >> 1), tl.b, full(st));
          else
            tma_load3(dst, &amap0, k0, tl.m0 + (tap >> 1), tl.b, full(st));
          tma_load2(dst + Ly::A_BYTES, &wmap, k0, tap * g.wrow_tap + tl.n0, full(st));
          // variant loads }
          if (++st == Ly::STAGES) st = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile
  const int wg = wgi, ltid = tid & 127, warp = ltid >> 5, g8 = lane >> 2, t4 = lane & 3;
  uint8_t* const ebase = sm + Ly::EPI_OFF + wg * 2 * kTgEpiBytes;
  float acc[BN / 2];
  int st = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const TgTile tl = tg_tile(g, t, BN);
    int prev = 0;
    for (int s = 0; s < ksteps; ++s) {
      mbar_wait(full(st), ph);
      const uint32_t a = s0 + st * Ly::STAGE;
      const uint64_t da = wgmma_desc(a + wg * 64 * 128), db = wgmma_desc(a + Ly::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 32 bytes = 2 units of the start field
        // variant mma {
        TgMma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, s | kk);
        // variant mma }
      wgmma_commit();
      wgmma_wait<1>();  // the batch of K-step s - 1 has retired: free its stage
      if (s > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = st;
      if (++st == Ly::STAGES) st = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    tg_fence_sums(acc);
    if (lane == 0) mbar_arrive(empty(prev));

    // The epilogue, 64 columns a pass, with the GELU's form chosen once a
    // pass (a select inside it computes both forms of every element).
    if constexpr (EPI == kFepGelu) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
        // variant pass {
        uint8_t* const e = ebase + (c & 1) * kTgEpiBytes;  // BN / 64 is even
        if (ltid == 0) bulk_wait_read<1>();  // the store that last read e is done with it
        tg_wg_sync(wg);
        if (g.f.fast)
          tg_gelu_pass<true>(acc, c, e, warp, g8, t4);
        else
          tg_gelu_pass<false>(acc, c, e, warp, g8, t4);
        fence_proxy_async();  // the staging tile's writes, visible to the TMA store
        tg_wg_sync(wg);
        if (ltid == 0) {
          tma_store3(&omap, smem_addr(e), tl.n0 + 64 * c, tl.m0 + 64 * wg, tl.b);
          bulk_commit();
        }
        // variant pass }
      }
    } else {
      // The FFN's forms store from registers, a pass on acc[0, 32) at a
      // time with the rest shifted down after it: one pass's code, which
      // reads bias and residual too (unrolled, the passes ran 1.4x slower
      // in erf at M = 3992)
      const int r0 = tl.m0 + wg * 64 + warp * 16 + g8;
      const size_t zo = (size_t)tl.b * g.f.out_batch;
#pragma unroll 1
      for (int c = 0; c < BN / 64; ++c) {
        if (g.f.fast)
          tg_store_pass<EPI, 1>(g.f, acc, zo, r0, tl.n0 + 64 * c, t4);
        else
          tg_store_pass<EPI, 0>(g.f, acc, zo, r0, tl.n0 + 64 * c, t4);
#pragma unroll
        for (int i = 0; i < BN / 2 - 32; ++i) acc[i] = acc[i + 32];
      }
    }
  }
  if (EPI == kFepGelu && ltid == 0) bulk_wait<0>();
}

// A bf16 tensor map for TMA boxes in the 128-byte swizzle (rows past dims
// read as zeros): rank 2 or 3, dims innermost first, strides in bytes of
// dims 1.. . False where the driver refuses it.
inline bool tg_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [B, rows, K] at `base`, rows `ld` elements apart and batch elements
// `batch` apart: boxes of 64 K elements by 128 rows of one element.
inline bool tg_a_map(CUtensorMap* map, const void* base, int K, long long rows, int B,
                     long long ld, long long batch) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)batch * 2};
  const cuuint32_t box[3] = {kTgBK, kTgBM, 1};
  return tg_map(map, base, 3, dims, strides, box);
}
// W [rows, K] contiguous: boxes of 64 K elements by bn rows.
inline bool tg_w_map(CUtensorMap* map, const void* base, int K, long long rows, int bn) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {kTgBK, (cuuint32_t)bn};
  return tg_map(map, base, 2, dims, strides, box);
}

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

// Launches `grid` persistent blocks (at most one a tile) of the BN instance
// with epilogue EPI. Returns a CUDA error code.
template <int BN, int EPI>
int launch_tma_gemm(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& w,
                    const CUtensorMap& o, const TgArgs& g, int grid, cudaStream_t s) {
  const auto kernel = tma_gemm_kernel<BN, EPI>;
  constexpr int smem = TgLayout<BN>::SMEM;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if (g.tiles <= 0) return (int)cudaSuccess;
  kernel<<<grid < g.tiles ? grid : g.tiles, kTgThreads, smem, s>>>(a0, a1, w, o, g);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_tma_gemm_bn(int bn, const CUtensorMap& a0, const CUtensorMap& a1,
                       const CUtensorMap& w, const CUtensorMap& o, const TgArgs& g, int grid,
                       cudaStream_t s) {
  return bn == 256 ? launch_tma_gemm<256, EPI>(a0, a1, w, o, g, grid, s)
                   : launch_tma_gemm<128, EPI>(a0, a1, w, o, g, grid, s);
}

}  // namespace

}  // namespace hr
