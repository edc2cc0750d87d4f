// Large-tile float GEMM for Hopper: C = epilogue(A . W^T), fp32 sums, over
// operands of T = bf16 (wgmma bf16 x bf16 -> fp32) or T = fp32 (3xTF32 on
// wgmma tf32). It carries, in fp32, the float FFN block's two products
// (csrc/ffn_bf16.cu) and the conv stack's stride-2 convs conv1..6
// (csrc/conv_stack.cu: K1's conv1..3, K2's conv4..6). In bf16 both run on
// csrc/tma_gemm.cuh; this file's bf16 instance serves only the convs as
// the yardstick that GEMM is timed beside (ops/conv_stack.py _conv_launches
// with cp_async=True). The epilogues and FloatGemmArgs are
// csrc/float_epilogue.cuh's, which both GEMMs include.
//
// Operands. A row m (of M) is K contiguous elements at a + m * lda, batch
// element z (the grid's z axis) at a + z * a_batch: a stride-2 conv with k
// taps over x [t_in, C] reads its output row r as the k*C elements from x
// row 2r on (lda = 2C, K = k*C), a view of x with no copy. W is K-major:
// K-element k of output column n lies in tap k / ktap, at
// w + tap * w_tap + n * ldw + k % ktap, so one base pointer per K-step takes
// the convs' tap-major [k, C_out, C_in] weights as they are (one tap of ktap
// = K for a plain [N, K] weight).
//
// Design. A block takes BM = 128 rows x BN = 128 columns: two consumer
// warpgroups of 64 rows each share every W tile that the block stages in
// shared memory, so each weight element read from L2 feeds 128 rows (the
// kernels this replaces streamed W from L2 for 8-16 rows a warp). A ring of
// A and W tiles of 128 K-bytes per row (64 bf16 or 32 fp32 elements) is
// filled by 16-byte cp.async from all 256 threads in the 128-byte swizzle
// that the wgmma descriptors name, with the int8 GEMM's loader and
// descriptors (csrc/int8_gemm.cuh); chunks past M, N or K are zero-filled by
// the copy.
// - bf16: wgmma.m64n128k16, four a stage, from a 3-stage ring (97 KB), two
//   blocks an SM (120 registers), so that one block's epilogue runs beside
//   the other's products; one wgmma batch stays in flight across K-steps.
// - fp32, 3xTF32: when tile kt + 1 lands, the block writes its small parts,
//   small = x - big with big = x's 13 low mantissa bits cleared (exact in
//   fp32), to one of two small-part tiles, while the wgmma of tile kt run;
//   big is the tile as it stands, since the tensor core reads the top 19
//   bits of each fp32 element, and it truncates small the same way. Each
//   K-step runs wgmma.m64n128k8 tf32 three times, small.big + big.small +
//   big.big; no product is rounded to one TF32. The tensor core rounds its
//   own sums toward zero, which over K = 3072 biases a sum by ~1e-4 of
//   itself, so each stage's products go to a partial sum (the first wgmma
//   with scale-d 0) that is added to the block's sums in fp32, rounded to
//   nearest. 4-stage ring and two small tiles (193 KB), one block an SM
//   (175 registers). wgmma rather than mma.sync: the split runs once per
//   element staged, not once per fragment load of every warp, and both
//   types share one pipeline; both operands are K-major, as tf32 wgmma
//   requires.
// The epilogue (a template parameter) runs on the accumulators in
// registers, in the plain versions' rounding order, each thread storing two
// adjacent columns: T(gelu(acc + b)), (resid + acc) + b in fp32, or
// T(gelu(acc)). IEEE operations only (no fast math).
//
// Readings (NVIDIA H100 80GB HBM3, 700 W; hriemo_torch/utils/
// float_gemm_variants.py, chip_conv_routes.py --gemms, PERF.md §6): the
// float FFN at M = 3992, fp32, max |error| 4.9e-6 against the plain version,
// 8.1e-5 without the fp32 partial sums, 3.6e-3 with one TF32 product; K1 at
// 8 x 10 s 8.8e-6, 1.5e-4, 1.1e-2. bf16 with one block an SM and a 5- or
// 7-stage ring: 0.2475 / 0.2554 ms for that FFN against 0.1813.
// What bounds it: the tensor cores wait on the pipeline. In bf16 K1's three
// conv GEMMs at 1.25 s x 384 take 7.07 ms (30% of their bound; the TMA
// GEMM 3.85) and the FFN at M = 3992 0.187 ms (erf; the TMA GEMM 0.155);
// fp32 runs at 29-41% of its three TF32 products at 495. Every thread
// issues copies and the block synchronises each stage (no producer warp,
// no TMA), and in fp32 the split and three products' operand reads load
// shared memory.
#pragma once

#include "float_epilogue.cuh"
#include "int8_gemm.cuh"

namespace hr {

template <typename T>
struct FloatTile {
  static constexpr int BM = 128, BN = 128, THREADS = 256;
  static constexpr bool SPLIT = sizeof(T) == 4;          // fp32: 3xTF32
  static constexpr int KS = kGemmBK / sizeof(T);         // K elements a stage
  static constexpr int A_BYTES = BM * kGemmBK, TILE = (BM + BN) * kGemmBK;
  // bf16: tile kt + STAGES - 2 loads while the wgmma batches of kt - 1 and kt
  // run, two blocks an SM (one block's epilogue runs beside the other's
  // products); fp32: the batch of kt - 1 has retired when kt + STAGES - 1
  // loads, one block an SM
  static constexpr int STAGES = SPLIT ? 4 : 3, BLOCKS = SPLIT ? 1 : 2;
  static constexpr int AHEAD = SPLIT ? STAGES - 1 : STAGES - 2;
  // the ring and, in fp32, two tiles of small parts; + alignment to 1024
  static constexpr int SMEM = (STAGES + (SPLIT ? 2 : 0)) * TILE + 1024;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// the 64 fp32 accumulators of an m64n128 wgmma, in order
#define HR_F8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HR_ACC64                                                                      \
  HR_F8(0), HR_F8(8), HR_F8(16), HR_F8(24), HR_F8(32), HR_F8(40), HR_F8(48), HR_F8(56)
#define HR_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63}"

// d (+)= A . B^T over 32 K-bytes (16 bf16 or 8 tf32 elements): A 64 rows, B
// 128 rows, both K-major in shared memory; d = A . B^T when `accumulate` is
// 0. The accumulator layout of csrc/int8_gemm.cuh's Wgmma: d[4j + e] holds
// row 16w + g (+ 8 for e >= 2), column 8j + 2t + (e & 1) of warp w of the
// warpgroup.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HR_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HR_ACC64
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HR_REGS64 ", %64, %65, p, 1, 1;\n}\n"
      : HR_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef HR_F8
#undef HR_ACC64
#undef HR_REGS64

// The small parts of an fp32 tile, at the same offsets (so the swizzle
// carries over): small = x - big, big = x with its 13 low mantissa bits
// cleared, exact in fp32. big is the tile itself: the tensor core reads the
// top 19 bits of each fp32 element, which is big.
template <class C>
__device__ __forceinline__ void split_tile(const uint8_t* tile, uint8_t* small, int tid) {
  const float4* t = reinterpret_cast<const float4*>(tile);
  float4* s = reinterpret_cast<float4*>(small);
  const auto part = [](float x) {
    return __fsub_rn(x, __uint_as_float(__float_as_uint(x) & 0xffffe000u));
  };
  for (int i = tid; i < C::TILE / 16; i += C::THREADS) {
    const float4 v = t[i];
    s[i] = make_float4(part(v.x), part(v.y), part(v.z), part(v.w));
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(256, FloatTile<T>::BLOCKS)
float_wgmma_kernel(const FloatGemmArgs g) {
  using C = FloatTile<T>;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* small = ring + C::STAGES * C::TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const T* A = static_cast<const T*>(g.a) + (size_t)blockIdx.z * g.a_batch;
  const T* W = static_cast<const T*>(g.w);
  const int ktiles = (g.K + C::KS - 1) / C::KS;

  // a stage lies in one tap (ktap is K or a multiple of KS)
  auto load = [&](int kt) {
    uint8_t* st = ring + (kt % C::STAGES) * C::TILE;
    const int k0 = kt * C::KS, tap = k0 / g.ktap;
    load_tile<C::BM, C::THREADS>(st, A, m0, g.M, (size_t)g.lda, g.K, k0, tid);
    load_tile<BN, C::THREADS>(st + C::A_BYTES, W + (size_t)tap * g.w_tap, n0, g.N,
                              (size_t)g.ldw, g.ktap, k0 - tap * g.ktap, tid);
  };
  const auto desc = [&](const uint8_t* base, uint32_t off) {
    return wgmma_desc(smem_addr(base) + off);
  };
  const uint32_t a_row = (warp >> 2) * 64 * kGemmBK;  // this warpgroup's 64 rows

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < C::AHEAD; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();  // one group per tile, empty past the last
  }
  if constexpr (C::SPLIT) {
    // 3xTF32. Each stage's three products go to a partial sum p (the first
    // with scale-d 0), which is then added to acc in fp32, rounded to
    // nearest: the tensor core rounds its sums toward zero, and over K = 3072
    // (1152 accumulating wgmma) that bias alone would reach ~1e-4 of a sum.
    // While stage kt's wgmma run, tile kt + 1 is split.
    float p[BN / 2];
    cp_async_wait<C::AHEAD - 1>();
    __syncthreads();
    split_tile<C>(ring, small, tid);
    fence_proxy_async();
    __syncthreads();
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint8_t* st = ring + (kt % C::STAGES) * C::TILE;
      const uint8_t* sm = small + (kt & 1) * C::TILE;
      const uint64_t da = desc(st, a_row), db = desc(st, C::A_BYTES);
      const uint64_t dsa = desc(sm, a_row), dsb = desc(sm, C::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 32; ++kk) {  // 32 bytes = 2 units of the start field
        wgmma_tf32(p, dsa + 2 * kk, db + 2 * kk, kk);
        wgmma_tf32(p, da + 2 * kk, dsb + 2 * kk, 1);
        wgmma_tf32(p, da + 2 * kk, db + 2 * kk, 1);
      }
      wgmma_commit();
      // the stage refilled here was last read by the batch of kt - 1, retired
      if (kt + C::AHEAD < ktiles) load(kt + C::AHEAD);
      cp_async_commit();
      if (kt + 1 < ktiles) {
        cp_async_wait<C::AHEAD - 1>();  // tile kt + 1, from this thread
        __syncthreads();                // ... and everyone
        // the small tile of kt - 1, the last reader of this one, has retired
        split_tile<C>(ring + ((kt + 1) % C::STAGES) * C::TILE, small + ((kt + 1) & 1) * C::TILE,
                      tid);
        fence_proxy_async();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
      __syncthreads();  // tile kt + 1 split by every thread; stage kt free
    }
  } else {
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<C::AHEAD - 1>();  // tile kt's copies from this thread are in
      fence_proxy_async();
      // ... and everyone's; the stage refilled next was last read by the wgmma
      // batch of tile kt - 2, which every warpgroup has waited for
      __syncthreads();
      if (kt + C::AHEAD < ktiles) load(kt + C::AHEAD);
      cp_async_commit();
      const uint8_t* st = ring + (kt % C::STAGES) * C::TILE;
      const uint64_t da = desc(st, a_row), db = desc(st, C::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 32; ++kk) wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  const int g8 = lane >> 2, t = lane & 3;
  const int r0 = m0 + (warp >> 2) * 64 + (warp & 3) * 16 + g8;
  const size_t zo = (size_t)blockIdx.z * g.out_batch;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= g.N) break;  // N is even: n + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m < g.M)
        epi_store<EPI, T>(g, zo + (size_t)m * g.ldo + n, m, n, acc[4 * j + 2 * h],
                          acc[4 * j + 2 * h + 1]);
    }
  }
}

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

// Launches over `batches` batch elements (the grid's z axis). Needs: N even;
// K a multiple of 16 bytes; ktap = K, or ktap a multiple of 128 bytes that
// divides K; 16-byte aligned a, w and every row (lda, ldw, w_tap, a_batch).
template <typename T, int EPI>
void launch_float_gemm(const FloatGemmArgs& g, int batches, cudaStream_t stream) {
  using C = FloatTile<T>;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(float_wgmma_kernel<T, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         C::SMEM);
    cudaFuncSetAttribute(float_wgmma_kernel<T, EPI>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    attr_set = true;
  }
  if (g.M <= 0 || g.N <= 0 || batches <= 0) return;
  // column tiles fastest: the blocks that share an A row tile run together
  const dim3 grid((g.N + C::BN - 1) / C::BN, (g.M + C::BM - 1) / C::BM, batches);
  float_wgmma_kernel<T, EPI><<<grid, C::THREADS, C::SMEM, stream>>>(g);
}

}  // namespace

}  // namespace hr
