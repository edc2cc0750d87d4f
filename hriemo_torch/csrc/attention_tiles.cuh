// Tensor-core tile machinery shared by the 16-bit float attention kernels
// (csrc/wavlm_attention.cu, csrc/flash_attention.cu, and the int8 route's
// core in csrc/attention.cu), FlashAttention-2 style on mma.sync.m16n8k16
// (bf16 or fp16 in, fp32 accumulate; the element type T picks the
// instruction's type suffix, and ldmatrix moves 16-bit elements of either
// type alike); the fp32 kernels of csrc/attention_tf32.cuh share its block
// shapes, key masking, row reductions and pair barrier.
//
// Which kernel serves which head dim (hd % 8 == 0, hd <= 256): the smallest
// tile head dim HD of 32, 64, 96, 128, 192 and 256 at or above hd
// (tile_head_dim). hd 8-32 runs at 32, 40-64 at 64, 72-96 at 96, 104-128
// at 128 (the narrow tiles), 136-192 at 192 and 200-256 at 256 (the wide
// tiles). A head dim below its HD is zero-padded to HD inside the tile and
// never in device memory: the q, K and V copies fill zeros past hd (src-size
// 0, nothing read), and no column past hd is stored. Zero columns add exact
// zeros to every q.k sum and give zero output columns. Each HD has an
// unpadded instance (PAD false), whose hd is the constant HD, so that none
// of these tests is left in its code, and a padded one.
//
// Narrow tiles (HD <= 128): a block is kTcWarps = 4 warps and kTcRows = 64
// query rows, 16 a warp; each warp keeps its 16 rows of q in registers as A
// fragments for the whole key loop (load_q), and its slice of the output,
// all HD columns, in fp32 C fragments.
//
// Wide tiles (HD 192, 256): a block is kWideWarps = 8 warps and the same 64
// query rows, two warps (a pair) on each 16 rows. What forces the split is
// registers: at HD 256 one warp's q as A fragments is 64 registers a lane
// and its fp32 output slice 128, beside a 64-key score tile's 32, where the
// narrow streaming kernel already takes all 255 at HD 128. So q stays in
// shared memory and its A fragments come by ldmatrix at each k step
// (qk_tile_smem), and each warp of a pair owns half the output columns
// (HD / 2) and half of each key tile's scores: QK^T and the softmax over
// its half of the keys, PV over all the tile's keys for its columns. The
// pair shares the tile's p (rounded to T, store_p / load_pa) and its row
// maxima and sums through shared memory, behind a named barrier of the
// pair's 64 threads (pair_sync), so that neither QK^T nor the softmax is
// done twice. (The other route, wgmma with a warpgroup's 64 x HD
// accumulator over 128 threads, would need the scores in a layout of its
// own and a second softmax code path; mma.sync keeps the narrow tiles'
// fragments, helpers and numerics.)
//
// Both shapes:
// - K and V tiles arrive in shared memory by cp.async 16-byte copies into
//   rows of HD + 8 elements (the 16-byte pad puts the eight rows that one
//   ldmatrix reads on distinct banks); rows past the key length are zeroed
//   by the copy itself (src-size 0), so p = 0 never meets garbage in V;
// - QK^T takes its B fragments from K by ldmatrix, PV from V by
//   ldmatrix.trans; in the narrow tiles the scores' C fragments, rounded to
//   T, are PV's A fragments without leaving registers;
// - each lane holds two rows of a score tile (g = lane / 4 and g + 8), and
//   a row's four lanes are adjacent, so row max and row sum are two xor
//   shuffles.
//
// Lane layout of a C fragment c[n][0..3] of n-tile n (8 keys or columns):
// c[n][0], c[n][1] at row g, columns 8n + 2t, 8n + 2t + 1 (t = lane % 4);
// c[n][2], c[n][3] at row g + 8, the same columns.
#pragma once

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace hr {

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;   // query rows per block
constexpr int kWideWarps = 2 * kTcWarps;  // wide tiles: a pair of warps per 16 rows
constexpr int kWideThreads = 32 * kWideWarps;

// The attention kernel that this library launched last, as (kernel << 16) |
// head dim (the tile instance's HD, or hd for a CUDA-core kernel), set on
// the host where each kernel is launched and read (and cleared) by
// hr_last_kernel: a check names the kernel that a call ran without a
// device trace. Inside a CUDA graph capture it records the captured launch.
enum LaunchedKernel : int {
  kOnepassAttnKernel = 1,
  kStreamingAttnKernel,
  kAttnCoreKernel,
  kOnepassMmaKernel,
  kOnepassWideKernel,
  kStreamingMmaKernel,
  kStreamingWideKernel,
  kAttnTf32Kernel,
  kAttnTf32WideKernel,
};

inline std::atomic<int>& last_launch() {
  static std::atomic<int> code{0};
  return code;
}

inline void note_launch(LaunchedKernel kernel, int hd) { last_launch() = kernel << 16 | hd; }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The tile head dim HD of the instance that serves head dim hd (hd % 8 ==
// 0): the smallest of 32, 64, 96, 128, 192 and 256 at or above hd; 0 above
// 256, which no kernel takes.
inline int tile_head_dim(int hd) {
  return hd > 256 ? 0 : hd > 192 ? 256 : hd > 128 ? 192 : (hd + 31) / 32 * 32;
}

// f(std::integral_constant<int, HD>(), std::bool_constant<PAD>()) for the
// instance that serves head dim hd (hd <= 256): HD = tile_head_dim(hd),
// PAD = hd < HD.
template <typename F>
void with_tile(int hd, F&& f) {
  const int inst = tile_head_dim(hd);
  const bool pad = hd != inst;
  auto at = [&](auto HD) {
    if (pad) f(HD, std::true_type());
    else f(HD, std::false_type());
  };
  switch (inst) {
    case 32: return at(std::integral_constant<int, 32>());
    case 64: return at(std::integral_constant<int, 64>());
    case 96: return at(std::integral_constant<int, 96>());
    case 128: return at(std::integral_constant<int, 128>());
    case 192: return at(std::integral_constant<int, 192>());
    default: return at(std::integral_constant<int, 256>());
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b on one m16n8k16 tile: T (bf16 or fp16) in, fp32 accumulate.
// The two forms differ only in their type suffix: read with the other
// suffix, the operands give wrong numbers and no error.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                      uint32_t a3, uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(float (&c)[4], uint32_t a0, uint32_t a1,
                                                     uint32_t a2, uint32_t a3, uint32_t b0,
                                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float (&c)[4], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two values rounded to T (to nearest even), the first in the low half (the
// lower k index of an mma operand pair).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// p / l rounded to nearest, as __fdiv_rn gives it, from y = __frcp_rn(l)
// (1 <= l): the product and two remainder corrections (Markstein), with no
// branch to a slow path. Only a quotient below 2^-126 (a denormal) may differ
// in its last bit, far below one bf16 step.
__device__ __forceinline__ float div_rn(float p, float l, float y) {
  float q = __fmul_rn(p, y);
  q = __fmaf_rn(__fmaf_rn(-q, l, p), y, q);
  return __fmaf_rn(__fmaf_rn(-q, l, p), y, q);
}

// Scores of the tile's absent keys (from tile-local key nk on) become -inf,
// so exp gives exact zeros.
template <int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int nk, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n * 8 + 2 * t + (e & 1) >= nk) s[n][e] = neg_inf();
}

// This warp's 16 query rows (row0 = its first) as A fragments of HD
// columns, zeros for rows at or past Lq and columns at or past hd (hd % 8
// == 0, so each 8-column half of a k step is all in or all out). q: the
// head's row 0, rows sl elements apart.
template <int HD, typename T>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 16][4], const T* q, int sl,
                                       int row0, int Lq, int hd, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + g, rb = ra + 8;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(q + (size_t)ra * sl);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(q + (size_t)rb * sl);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const bool lo = ks * 16 < hd, hi = ks * 16 + 8 < hd;
    qf[ks][0] = ra < Lq && lo ? pa[ks * 8 + t] : 0u;       // row g,     k 2t, 2t+1
    qf[ks][1] = rb < Lq && lo ? pb[ks * 8 + t] : 0u;       // row g + 8, k 2t, 2t+1
    qf[ks][2] = ra < Lq && hi ? pa[ks * 8 + 4 + t] : 0u;   // row g,     k 2t+8, 2t+9
    qf[ks][3] = rb < Lq && hi ? pb[ks * 8 + 4 + t] : 0u;   // row g + 8, k 2t+8, 2t+9
  }
}

// Rows j0 .. j0+R-1 of a [L, hd] head (rows sl elements apart) into R
// shared rows of HD + 8 elements, by the block's NTHR threads; rows at or
// past L and, PAD, columns at or past hd are zeroed by the copy (src-size 0,
// nothing read).
template <int HD, int R, bool PAD, int NTHR = kTcThreads, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int sl,
                                          int j0, int L, int hd, int tid) {
  constexpr int kChunks = HD / 8;
  for (int idx = tid; idx < R * kChunks; idx += NTHR) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool ok = j0 + r < L && (!PAD || c * 8 < hd);
    cp_async16(dst + r * (HD + 8) + c * 8,
               src + (size_t)(ok ? j0 + r : 0) * sl + (PAD && !ok ? 0 : c * 8), ok ? 16 : 0);
  }
}

// R fp32 key biases from j0 on; zeros past L.
template <int R, int NTHR = kTcThreads>
__device__ __forceinline__ void load_bias(float* dst, const float* src, int j0, int L, int tid) {
  for (int idx = tid; idx < R; idx += NTHR) {
    const bool ok = j0 + idx < L;
    cp_async4(dst + idx, src + (ok ? j0 + idx : 0), ok ? 4 : 0);
  }
}

// s[n] = this warp's 16 query rows . keys 8n .. 8n+7 of the tile, fp32
// sums over HD. ks: the K tile in shared memory, rows of HD + 8.
template <int HD, int NT, typename T>
__device__ __forceinline__ void qk_tile(float (&s)[NT][4], const uint32_t (&qf)[HD / 16][4],
                                        const T* ks, int lane) {
  // ldmatrix.x4 matrices: keys +0..7 at k +0..7 and +8..15 (b0, b1 of
  // n-tile 2m), keys +8..15 at the same k (b0, b1 of n-tile 2m + 1)
  const int kr = (lane & 7) + ((lane >> 4) << 3), kc = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
#pragma unroll
    for (int m = 0; m < NT / 2; ++m) {
      uint32_t b[4];
      ldsm_x4(b, ks + (m * 16 + kr) * (HD + 8) + k * 16 + kc);
      mma16<T>(s[2 * m], qf[k][0], qf[k][1], qf[k][2], qf[k][3], b[0], b[1]);
      mma16<T>(s[2 * m + 1], qf[k][0], qf[k][1], qf[k][2], qf[k][3], b[2], b[3]);
    }
  }
}

// o += P . V over the tile's NT * 8 keys, for COLS columns of V: pa[m]
// holds keys 16m .. 16m+15 of this warp's 16 rows as an A fragment; vs: the
// V tile's first column of the COLS, rows of HD + 8.
template <int HD, int NT, typename T, int COLS = HD>
__device__ __forceinline__ void pv_tile(float (&o)[COLS / 8][4], const uint32_t (&pa)[NT / 2][4],
                                        const T* vs, int lane) {
  // ldmatrix.x4.trans matrices: keys +0..7 and +8..15 at columns +0..7 (b0,
  // b1 of column tile 2d), the same keys at columns +8..15 (tile 2d + 1)
  const int vr = (lane & 7) + (((lane >> 3) & 1) << 3), vc = (lane >> 4) << 3;
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
#pragma unroll
    for (int d = 0; d < COLS / 16; ++d) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (m * 16 + vr) * (HD + 8) + d * 16 + vc);
      mma16<T>(o[2 * d], pa[m][0], pa[m][1], pa[m][2], pa[m][3], b[0], b[1]);
      mma16<T>(o[2 * d + 1], pa[m][0], pa[m][1], pa[m][2], pa[m][3], b[2], b[3]);
    }
  }
}

// Wide tiles. The lane's row and column of a 16 x 16 A operand for
// ldmatrix.x4 (matrices: rows 0-7 and 8-15 at columns 0-7, then the same
// rows at columns 8-15: a0..a3 of mma.m16n8k16), and of a V tile's 16 keys
// for ldmatrix.x4.trans (pv_tile).
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }

// s[n] = the 16 query rows at qs (shared, rows of HD + 8) . keys 8n .. 8n+7
// of ks, fp32 sums over HD; q's A fragments by ldmatrix at each k step.
template <int HD, int NT, typename T>
__device__ __forceinline__ void qk_tile_smem(float (&s)[NT][4], const T* qs, const T* ks,
                                             int lane) {
  const int kr = (lane & 7) + ((lane >> 4) << 3), kc = ((lane >> 3) & 1) << 3;
  const T* qa = qs + a_row(lane) * (HD + 8) + a_col(lane);
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    uint32_t a[4];
    ldsm_x4(a, qa + k * 16);
#pragma unroll
    for (int m = 0; m < NT / 2; ++m) {
      uint32_t b[4];
      ldsm_x4(b, ks + (m * 16 + kr) * (HD + 8) + k * 16 + kc);
      mma16<T>(s[2 * m], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma16<T>(s[2 * m + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }
}

// The named barrier of pair pr's 64 threads (ids 1-4; __syncthreads is 0):
// orders their shared-memory accesses as __syncthreads does the block's.
__device__ __forceinline__ void pair_sync(int pr) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pr), "r"(64) : "memory");
}

// p of this warp's 16 rows and NT * 8 keys, rounded to T, into shared rows
// of ld elements (ps: the column of key 0).
template <int NT, typename T>
__device__ __forceinline__ void store_p(T* ps, int ld, const float (&p)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(ps + g * ld + 8 * n + 2 * t) = pack2<T>(p[n][0], p[n][1]);
    *reinterpret_cast<uint32_t*>(ps + (g + 8) * ld + 8 * n + 2 * t) = pack2<T>(p[n][2], p[n][3]);
  }
}

// PV's A fragments of KS 16-key steps from shared p rows of ld elements
// (ps: the column of the first key).
template <int KS, typename T>
__device__ __forceinline__ void load_pa(uint32_t (&pa)[KS][4], const T* ps, int ld, int lane) {
  const T* pr = ps + a_row(lane) * ld + a_col(lane);
#pragma unroll
  for (int m = 0; m < KS; ++m) ldsm_x4(pa[m], pr + m * 16);
}

// The warp's output rows (row0 + g and row0 + g + 8, those below Lq) as T
// (bf16 or fp16, or fp32 for csrc/attention_tf32.cuh), columns below hd
// only. o: the head's row 0, rows sl elements apart.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* o, int sl, int row0, int Lq, int hd,
                                           const float (&acc)[HD / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + g, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (n * 8 >= hd) break;
    if (ra < Lq) store2(o + (size_t)ra * sl + n * 8 + 2 * t, acc[n][0], acc[n][1]);
    if (rb < Lq) store2(o + (size_t)rb * sl + n * 8 + 2 * t, acc[n][2], acc[n][3]);
  }
}

}  // namespace hr

// Each library that includes this header is one translation unit, so each
// exports its own record.
extern "C" int hr_last_kernel() { return hr::last_launch().exchange(0); }
