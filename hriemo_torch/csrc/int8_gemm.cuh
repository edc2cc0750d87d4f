// Shared W8A8 GEMM: C[M,N] = epilogue(A[M,K] int8 . W[N,K]^T int8).
//
// Both operands keep K contiguous: A is the row-quantized activation and W
// the torch-layout [out, in] int8 weight of hriemo/ops/quant.py. The int32
// sum is exact, so every correct int8 GEMM gives the same bits; the
// epilogue then applies the dequant (acc * row_scale) * col_scale, the bias
// and an op-specific tail in the reference's rounding order.
//
// It carries both int8 matmuls of the Pallas kernels
// hriemo/ops/fused_ffn.py::_kernel_int8 and ::_kernel_mlp2_int8 on their
// chain route (their TMA route, csrc/ffn_tma.cu, takes this file's
// epilogues), the projections of
// hriemo/ops/attention_block.py::_mha_kernel, and on their chain routes
// those of ::_kernel and XLA's int8 dot of hriemo/ops/quant.py::int8_linear
// (their fused routes are csrc/proj_int8.cu, on this file's epilogues).
//
// What bounds it on the card: int8 tensor-core operations at the main
// path's 2k rows (1979 TOP/s), which only wgmma reaches; the bytes of W at
// the decoder's few rows. Design:
// - wgmma.mma_async m64nBNk32 s8.s8 -> s32, both operands K-major from
//   shared memory, as A and W already are; each consumer warpgroup owns 64
//   rows of the block (WG warpgroups, BM = 64 * WG rows) and all BN columns;
// - a STAGES-deep ring of A and W tiles of 128 K-bytes, filled by
//   16-byte cp.async from every thread, written in the 128-byte swizzle that
//   the wgmma descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8),
//   8-row groups 1024 bytes apart); chunks past M, N or K are zero-filled by
//   the copy (K % 16 == 0, so a chunk is all in or all out). cp.async rather
//   than TMA: no tensor-map descriptor to build per call on a host-bound
//   path, and the w_rows slices need no alignment beyond 16 bytes;
// - tile kt + 3 is in flight while tile kt is multiplied; after the last
//   tile the int32 block goes through shared memory so that each thread
//   applies the epilogue (a template parameter, no per-element switch) to
//   16 consecutive output bytes and stores them with one vector store;
// - the block shape and ring depth are chosen per call in hr_int8_gemm
//   (csrc/quant_gemm.cu), by shape, among three configurations;
// - activations follow x's dtype, as the JAX wrappers store x.dtype: the
//   residual epilogues read a residual of type RT (bf16 or fp32), and
//   kEpiF32 stores the dequantized fp32 value where kEpiBf16 rounds it.
// The ring's tile loader, the swizzle and the wgmma descriptor and fences
// below also carry the float GEMM (csrc/float_wgmma.cuh).
#pragma once

#include "common.cuh"

namespace hr {

enum Epilogue : int {
  kEpiBf16 = 0,         // bf16 out = (acc*as)*ws [+ b]
  kEpiGeluF32 = 1,      // f32 out = gelu_tanh((acc*as)*ws + b)
  kEpiReluF32 = 2,      // f32 out = relu((acc*as)*ws + b)
  kEpiResidFirst = 3,   // f32 out = (resid + (acc*as)*ws) + b   (fused FFN)
  kEpiResidLast = 4,    // f32 out = ((acc*as)*ws + b) + resid   (attention block)
  kEpiGeluErfF32 = 5,   // f32 out = gelu_erf((acc*as)*ws + b)
  kEpiF32 = 6,          // f32 out = (acc*as)*ws [+ b]             (fp32 activations)
};

// b is 0 without a bias, resid 0 without a residual: v + 0 is v, as the
// plain versions that add no bias give it. kEpiBf16 and kEpiF32 compute the
// same value and differ only in the type they store.
template <int EPI>
__device__ __forceinline__ float epilogue(int acc, float as, float ws, float b, float resid) {
  const float v = __fmul_rn(__fmul_rn((float)acc, as), ws);
  if (EPI == kEpiGeluF32) return gelu_tanh(__fadd_rn(v, b));
  if (EPI == kEpiGeluErfF32) return gelu_erf(__fadd_rn(v, b));
  if (EPI == kEpiReluF32) return fmaxf(__fadd_rn(v, b), 0.f);
  if (EPI == kEpiResidFirst) return __fadd_rn(__fadd_rn(resid, v), b);
  if (EPI == kEpiResidLast) return __fadd_rn(__fadd_rn(v, b), resid);
  return __fadd_rn(v, b);
}

constexpr int kGemmBK = 128;    // K bytes of a ring stage: one 128-byte swizzle row

// WG consumer warpgroups of 64 rows, BN columns, a ring of STAGES tiles;
// OVERLAP keeps one tile's wgmma in flight while the next is issued (the
// refill then runs STAGES - 2 tiles ahead instead of STAGES - 1).
template <int WG, int BN, int STAGES, bool OVERLAP>
struct GemmTile {
  static constexpr int BM = 64 * WG, THREADS = 128 * WG;
  static constexpr int A_BYTES = BM * kGemmBK, STAGE = (BM + BN) * kGemmBK;
  static constexpr int C_LD = BN + 4;  // int32 row of the epilogue's staging tile
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment to 1024
  static constexpr int AHEAD = OVERLAP ? STAGES - 2 : STAGES - 1;
  // blocks per SM that shared memory allows (at most 3), for the register cap
  static constexpr int MIN_BLOCKS = 232448 / SMEM < 1 ? 1 : (232448 / SMEM > 3 ? 3 : 232448 / SMEM);
  static_assert(BM * C_LD * 4 <= STAGES * STAGE, "staging tile fits the ring");
  static_assert(AHEAD >= 1, "at least one tile in flight");
};

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address, leading offset (unused by this layout), 8-row groups 1024
// bytes apart, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes become visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A . B^T over 32 K-bytes: A 64 x 32, B BN x 32 (both K-major in
// shared memory, named by descriptors). Accumulator layout: d[4j + e] of
// warp w holds row 16w + g (e < 2) or 16w + g + 8 (e >= 2), column
// 8j + 2t + (e & 1), g = lane / 4, t = lane % 4.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Rows row0 .. row0+R-1 of an operand of T whose rows are ld elements apart,
// elements k0 .. k0 + 128/sizeof(T) - 1 of each (128 bytes), into one
// swizzled tile of R rows; 16-byte chunks of rows >= rows or at K or past it
// are zero-filled (K is a multiple of 16 bytes: a chunk is all in or all
// out). Shared with the float GEMM (csrc/float_wgmma.cuh).
template <int R, int THREADS, typename T>
__device__ __forceinline__ void load_tile(uint8_t* tile, const T* src, int row0, int rows,
                                          size_t ld, int K, int k0, int tid) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte chunk
  for (int idx = tid; idx < R * 8; idx += THREADS) {
    const int r = idx >> 3, c = idx & 7;
    const bool ok = row0 + r < rows && k0 + E * c < K;
    cp_async16(tile + r * 128 + ((c ^ (r & 7)) << 4),
               ok ? src + (size_t)(row0 + r) * ld + k0 + E * c : src, ok ? 16 : 0);
  }
}

template <int WG, int BN, int STAGES, bool OVERLAP, int EPI, typename RT>
__global__ void __launch_bounds__(128 * WG, (GemmTile<WG, BN, STAGES, OVERLAP>::MIN_BLOCKS))
int8_gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ as,
                 const int8_t* __restrict__ W, const float* __restrict__ ws,
                 const float* __restrict__ bias, const RT* __restrict__ resid,
                 int M, int N, int K, void* __restrict__ out) {
  using T = GemmTile<WG, BN, STAGES, OVERLAP>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + kGemmBK - 1) / kGemmBK;

  auto load = [&](int kt) {
    uint8_t* st = ring + (kt % STAGES) * T::STAGE;
    load_tile<T::BM, T::THREADS>(st, A, m0, M, (size_t)K, K, kt * kGemmBK, tid);
    load_tile<BN, T::THREADS>(st + T::A_BYTES, W, n0, N, (size_t)K, K, kt * kGemmBK, tid);
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < T::AHEAD; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();  // one group per tile, empty past the last
  }
  const uint32_t a_row = (warp >> 2) * 64 * kGemmBK;  // this warpgroup's 64 rows
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<T::AHEAD - 1>();  // tile kt's copies from this thread are in
    fence_proxy_async();
    // ... and everyone's; the stage refilled next was last read by the wgmma
    // of tile kt - 1 (kt - 2 with OVERLAP), which every warpgroup has waited for
    __syncthreads();
    if (kt + T::AHEAD < ktiles) load(kt + T::AHEAD);
    cp_async_commit();
    const uint32_t st = smem_addr(ring + (kt % STAGES) * T::STAGE);
    const uint64_t da = wgmma_desc(st + a_row), db = wgmma_desc(st + T::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 32; ++kk)  // 32 bytes = 2 units of the start field
      Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<OVERLAP ? 1 : 0>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the int32 block through it

  int* cs = reinterpret_cast<int*>(ring);
  {
    const int g = lane >> 2, t = lane & 3, r = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<int2*>(cs + r * T::C_LD + 8 * j + 2 * t) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(cs + (r + 8) * T::C_LD + 8 * j + 2 * t) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();

  constexpr bool kBf16 = EPI == kEpiBf16;
  constexpr bool kResid = EPI == kEpiResidFirst || EPI == kEpiResidLast;
  constexpr int VEC = kBf16 ? 8 : 4;  // 16 bytes of output
  const bool aligned = N % VEC == 0;
  for (int idx = tid; idx < T::BM * BN / VEC; idx += T::THREADS) {
    const int r = idx / (BN / VEC), c = (idx - r * (BN / VEC)) * VEC;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float a_s = as[m];
    const size_t o = (size_t)m * N + n;
    float v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int nn = min(n + e, N - 1);  // columns past N are computed and not stored
      v[e] = epilogue<EPI>(cs[r * T::C_LD + c + e], a_s, ws[nn], bias ? bias[nn] : 0.f,
                           kResid ? load_f(resid + o + (nn - n)) : 0.f);
    }
    if (aligned && n + VEC <= N) {
      if (kBf16) {
        uint4 pk;
        uint32_t* p = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
          p[e] = *reinterpret_cast<uint32_t*>(&h2);
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) = pk;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (n + e >= N) break;
        if (kBf16) static_cast<__nv_bfloat16*>(out)[o + e] = f2bf(v[e]);
        else static_cast<float*>(out)[o + e] = v[e];
      }
    }
  }
}

}  // namespace hr
