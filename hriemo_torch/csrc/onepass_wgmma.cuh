// The one-pass attention cores on Hopper's own machinery: wgmma warpgroups
// fed by a producer warp through mbarriers. Two kernels:
//
// onepass_wgmma_kernel, the held form (up to kWgMaxKeys, 512, keys): every
// score of a 64-row block in registers, each computed once. It serves
//   - the int8 sublayers' core at head dims 64 and 96 (csrc/attention.cu),
//     replacing, for the key rows it holds, the core of the Pallas kernels
//     hriemo/ops/attention_block.py::_kernel (WavLM, gated relative position
//     bias, :218-257) and ::_mha_kernel (a key-padding bias, :576-605); the
//     gate computed from x, 1/sqrt(hd) already in q;
//   - the float route at head dims 64 and 96 in bf16 and fp16
//     (csrc/attention_wgmma.cu), replacing hriemo/ops/wavlm_attention.py::
//     _kernel (:34-53) up to 512 keys; the gate read from its [B, H, Lq]
//     array and the scale applied after the product.
// onepass_sweeps_kernel, the two sweeps on warpgroups (any key count up to
// kSwMaxKeys, 2048), float route only: WavLM's gated core at head dims 64
// and 96, and hriemo/ops/flash_attention_pallas.py::_onepass_kernel
// (:81-104) ungated at 64, 96 and the wide tiles 192 (hd 136-192) and 256
// (hd 200-256). ops/wavlm_attention.py onepass_kernel routes between these
// and csrc/onepass_mma.cuh's mma.sync kernels, and ops/attention_block.py
// core_kernel for the int8 route.
//
// The function is the one-pass kernels':
//   s = (q . k^T) [* scale] [+ gate[i] * pos[h,i,j]] + key bias[b,j]
//       (__fmul_rn/__fadd_rn, in the TPU kernel's order; keys past Lk at
//       -inf; the int8 route has 1/sqrt(hd) in q and no multiply)
//   m = max_j s,  l = sum_j exp(s - m)
//   out = T(p / l rounded to nearest) . v, fp32 sums, stored as T (bf16 or
//       fp16: wgmma's .bf16 or .f16 form, p / l rounded to T before PV).
// A fully masked row (every key bias -1e9) comes out as a finite average of v.
//
// Operands. q/k/v are [B, H, L, hd] views read in place (the projections'
// [B, L, H*hd] outputs, or the int8 route's column blocks of the packed
// [B*L, 3D] projection), each described as a 4D tensor map [B, H, L, hd]
// through its own strides (multiples of 16 bytes, a 16-byte-aligned base:
// ops/wavlm_attention.py tma_view decides that before any launch). TMA
// fills rows past L and, on the wide tiles, columns past hd with zeros
// itself, with no padded copy in device memory; a key past Lk is masked.
// Every tile is cut into slabs of 32 columns (64-byte rows) in the 64-byte
// swizzle, one TMA box each: Q and K read K-major (a k16 step is 32 bytes
// into a slab), V MN-major (the slabs one slab apart along the output
// columns, 8 keys 512 bytes apart).
//
// The held form. A block takes 64 query rows of one (batch element, head)
// and all their keys: two consumer warpgroups and one producer warp (288
// threads, one block an SM). Consumer c takes key tiles c, c + 2, c + 4, ...
// and keeps every score of its tiles in registers (KT tiles of 64 x 64
// fp32, 32 a thread each; KT 2 up to 256 keys, 4 up to 512), so each score
// is computed once and each exp taken once:
//   1. S = Q K^T by wgmma.m64n64k16 from shared memory, the next tile's
//      product in flight while this tile's epilogue (scale, gate * pos, key
//      bias, mask) runs; the rows' maxima over the warpgroup's keys,
//      exchanged with the other warpgroup through shared memory;
//   2. e = exp(s - m) in place, the rows' sums exchanged the same way, so
//      both warpgroups hold the same l = l0 + l1 (in that order);
//   3. p = e / l rounded to nearest (csrc/attention_tiles.cuh div_rn), then
//      to T straight from the S accumulator's fragments into wgmma's A
//      registers; O += P V by wgmma.m64nHDk16 with V from shared memory;
//   4. each warpgroup hands the other the half of its O that the other
//      stores, which stores O0 + O1.
// One warpgroup's exp and division (FMA and MUFU) run beside the other's
// asynchronous wgmma. The producer warp issues every load of the block up
// front, each completing on an mbarrier: lane 0 the gate Linear's weight
// (int8 route) and the block's pos rows by bulk copies and Q by TMA, one
// lane a tile every K tile by TMA (with its key biases: fp32 by cp.async,
// the bool mask turned into -1e9 / 0 by plain stores), and V by TMA once the
// K tiles and pos have landed. Every K tile stays resident; V takes eight
// stages too where shared memory allows (a ring of two at HD 96 gated,
// released by the consumers through empty barriers). 288 threads are nine
// warps, three of them on one of the SM's four 16K-register partitions, so
// ptxas caps every instance at 168 registers: at HD 96 the four-tile
// instances spill 536-540 bytes (S 128 and O 48 registers; ptxas -v). With a
// producer warpgroup (384 threads) and setmaxnreg 40 / 232, ptxas kept the
// consumers at the same 168 and spilled more.
// pos [H, Lq, Lk] rows are only 2-byte aligned at odd Lk, so no tensor map
// describes them; the block's 64 rows are one span of the tensor, so one
// bulk copy takes it from the 16-byte boundary below its first element (the
// consumers read it at that offset), and where the span ends inside the
// tensor's last 16 bytes that chunk comes by a copy that fills zeros past
// the end. A copy a realigned row (64 a tile) kept the TMA unit far behind.
//
// The two sweeps. A block takes 128 query rows of one (batch element, head):
// consumer warpgroup c owns rows 64c .. 64c + 63 and all their keys, so the
// two need no exchange; the producer warp streams the key tiles (BK keys:
// 64 at HD 64 and 96, 32 at HD 192 and 256) through a ring of NS stages that
// both consumers read and release (an empty barrier of their 8 warps), K
// alone in sweep 1, K again (from L2) and V in sweep 2; the key biases of
// the whole row (up to 2048 fp32) land once in shared memory by cp.async.
//   sweep 1: S = Q K^T by wgmma, the next tile's product in flight while
//     this tile's epilogue runs; the running row max m and the running sum
//     l = l * exp(m_old - m) + sum exp(s - m), in csrc/onepass_mma.cuh's
//     order (l differs from the held sum in fp32 order and rescaling only);
//   sweep 2: S again, p = div_rn(exp(s - m), l) rounded to T into wgmma's A
//     registers, O += P V by wgmma; the next tile's QK^T in flight while
//     this tile's exps and divisions run.
// Gated, the producer is a warpgroup whose 128 threads also copy the block's
// 128 pos rows of each step's keys into the stage by cp.async (each row from
// the 16-byte boundary at or below its first key, read at its offset, as
// csrc/onepass_mma.cuh does), completing on the stage's barrier: a block's
// pos rows are not one span of a tile's width. Consumer threads that read
// pos straight from device memory (2-byte loads before the product's wait)
// took 2.3x the parent's time at B=2 L=1499, and one producer warp's
// copies 1.6x.
// Registers bind on the wide tiles: O alone is HD / 2 fp32 a thread (128 at
// HD 256) under the 168 that nine warps leave, so the S tile narrows to 32
// keys (16 registers), PV runs as HD / 64 products of 64 columns each, and
// at HD 256 the next tile's QK^T waits for this tile's epilogue (one S
// buffer; two spilled 608 bytes).
#pragma once

#include <type_traits>

#include "int8_gemm.cuh"
#include "onepass_mma.cuh"
#include "tma.cuh"

namespace hr {

constexpr int kWgConsumers = 2;                       // consumer warpgroups
constexpr int kWgThreads = 128 * kWgConsumers + 32;   // + the producer warp
constexpr int kWgSlab = 32;                           // columns of a slab (a TMA box)
constexpr int kWgSlabBytes = kOneBK * kWgSlab * 2;    // 64 rows of 64 bytes
constexpr int kWgMaxKT = 4;                            // key tiles a consumer holds
constexpr int kWgKTiles = kWgConsumers * kWgMaxKT;     // every K tile of a row block
constexpr int kWgMaxKeys = kWgKTiles * kOneBK;
constexpr int kSwMaxKeys = 2048;                       // the two sweeps' key biases in smem
constexpr int kSwRows = kWgConsumers * kTcRows;        // query rows of a sweeps block
// producer threads of a sweeps block: a warp, or gated a warpgroup, whose
// 128 threads copy the pos rows (registers are no scarcer: nine warps
// already cap a thread at 168)
template <bool GATED>
constexpr int kSwProducers = GATED ? 128 : 32;

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// Shared memory of one held block, from a 1024-byte boundary: Q's slabs;
// every K tile of the row block with its key biases (K is never reloaded, so
// the K tiles need no empty barrier); gated, the block's rows of pos (one
// span of the tensor) and the gate Linear's weight; a ring of V tiles, every
// tile where it fits (VS); the row maxima and sums of both consumers; the
// gate Linear's outputs; the barriers.
template <int HD, bool GATED>
struct WgLayout {
  static constexpr int TILE = HD / kWgSlab * kWgSlabBytes;
  static constexpr int KSTAGE = (TILE + kOneBK * 4 + 1023) / 1024 * 1024;
  static constexpr int K_OFF = TILE;
  static constexpr int POS_OFF = K_OFF + kWgKTiles * KSTAGE;
  // 64 rows of up to kWgMaxKeys keys, from the 16-byte boundary below the
  // first, and a 16-byte tail
  static constexpr int POS = GATED ? (kTcRows * kWgMaxKeys * 2 + 64 + 1023) / 1024 * 1024 : 0;
  static constexpr int WG_OFF = POS_OFF + POS;  // [8, HD] fp32
  static constexpr int V_OFF = WG_OFF + (GATED ? 8 * HD * 4 : 0);
  static constexpr int REST = 4 * kTcRows * 4 + kTcRows * 8 * 4 + 64 + 1024;
  static constexpr int VS = (232448 - V_OFF - REST) / TILE < kWgKTiles
                                ? (232448 - V_OFF - REST) / TILE : kWgKTiles;
  static constexpr int X_OFF = V_OFF + VS * TILE;         // m[2][64], l[2][64]
  static constexpr int GP_OFF = X_OFF + 4 * kTcRows * 4;  // the gate Linear's [64][8]
  static constexpr int BAR_OFF = GP_OFF + kTcRows * 8 * 4;
  static constexpr int NBAR = 3 + kWgKTiles + 2 * VS;
  static constexpr int SMEM = BAR_OFF + NBAR * 8 + 1024;  // + the alignment
  static_assert(kWgKTiles * KSTAGE >= kTcRows * HD * 4, "consumer 1's O fits the K tiles");
  static_assert(SMEM <= 232448 && VS >= 2, "shared memory of one block");
};

// Shared memory of one sweeps block, from a 1024-byte boundary: each
// consumer's 64 rows of Q; a ring of NS stages, each a K tile and a V tile
// of BK keys and, gated, the block's 128 realigned pos rows of the tile's
// keys; the row's key biases; the barriers.
template <int HD, int BK, bool GATED>
struct SwLayout {
  static constexpr int SLABS = HD / kWgSlab;
  static constexpr int QT = SLABS * kWgSlabBytes;    // a consumer's 64 rows of Q
  static constexpr int KSLAB = BK * kWgSlab * 2;     // one slab of a K or V tile
  static constexpr int KTILE = SLABS * KSLAB;
  static constexpr int POS = GATED ? kSwRows * (BK + 8) * 2 : 0;  // rows of BK + 8 keys
  static constexpr int STAGE = (2 * KTILE + POS + 1023) / 1024 * 1024;  // K, V, pos
  static constexpr int RING_OFF = kWgConsumers * QT;
  static constexpr int FIXED = RING_OFF + kSwMaxKeys * 4 + 2048;
  static constexpr int NS = (232448 - FIXED) / STAGE < 6 ? (232448 - FIXED) / STAGE : 6;
  static constexpr int KB_OFF = RING_OFF + NS * STAGE;
  static constexpr int BAR_OFF = KB_OFF + kSwMaxKeys * 4;
  static constexpr int NBAR = 2 + 2 * NS;            // Q, key biases; full and empty
  static constexpr int SMEM = BAR_OFF + NBAR * 8 + 1024;
  static_assert(NS >= 3 && SMEM <= 232448, "shared memory of one block");
};

// wgmma descriptor of a slab in the 64-byte swizzle: 8-row groups 512 bytes
// apart (K-major: the rows; MN-major: 8 keys), `lbo` the next slab along the
// columns (MN-major only), layout type 2.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// the two consumer warpgroups' named barrier (0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWgConsumers) : "memory");
}

#define HR_W4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HR_W16(d) HR_W4(d, 0), HR_W4(d, 4), HR_W4(d, 8), HR_W4(d, 12)
#define HR_W32(d) HR_W16(d), HR_W4(d, 16), HR_W4(d, 20), HR_W4(d, 24), HR_W4(d, 28)
#define HR_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HR_R32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HR_WG(N, TY) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "

// s (+)= Q . K^T over 16 head columns: 64 query rows by 64 (or 32) keys,
// both operands K-major in shared memory; s = Q . K^T when `acc` is 0.
// s[4n + e] holds row 16w + g (+ 8 for e >= 2) and key 8n + 2t + (e & 1) of
// warp w.
#define HR_QK64(TY)                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" HR_WG(64, TY) HR_R32 \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                            \
               : HR_W32(s)                                                  \
               : "l"(da), "l"(db), "r"(acc))
#define HR_QK32(TY)                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" HR_WG(32, TY) HR_R16 \
               ", %16, %17, p, 1, 1, 0, 0;\n}\n"                            \
               : HR_W16(s)                                                  \
               : "l"(da), "l"(db), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (kIsHalf<T>) HR_QK64("f16");
  else HR_QK64("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&s)[16], uint64_t da, uint64_t db, int acc) {
  if constexpr (kIsHalf<T>) HR_QK32("f16");
  else HR_QK32("bf16");
}

// o += P . V over 16 keys: P's A fragment in registers (rows as the S
// accumulator's), V MN-major in shared memory, N output columns.
#define HR_PV64(TY)                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" HR_WG(64, TY) HR_R32 \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"              \
               : HR_W32(o)                                                  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define HR_PV96(TY)                                                                         \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n" HR_WG(96, TY)                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"               \
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"                                       \
      : HR_W32(o), HR_W4(o, 32), HR_W4(o, 36), HR_W4(o, 40), HR_W4(o, 44)                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsHalf<T>) HR_PV64("f16");
  else HR_PV64("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&o)[48], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsHalf<T>) HR_PV96("f16");
  else HR_PV96("bf16");
}
#undef HR_QK64
#undef HR_QK32
#undef HR_PV64
#undef HR_PV96
#undef HR_WG
#undef HR_W4
#undef HR_W16
#undef HR_W32
#undef HR_R16
#undef HR_R32

// O (HD / 2 fp32 a thread) += P . V over 16 keys, V's 16 key rows at `vs`
// (slabs `slab` bytes apart): one product of all HD columns at HD 64 and
// 96, HD / 64 products of 64 columns (two slabs) each on the wide tiles.
template <typename T, int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2], const uint32_t (&a)[4], uint32_t vs,
                                        uint32_t slab) {
  if constexpr (HD <= 96) {
    wgmma_pv<T>(o, a, wg_desc(vs, slab));
  } else {
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
      wgmma_pv<T>(*reinterpret_cast<float(*)[32]>(o + 32 * c), a,
                  wg_desc(vs + 2 * c * slab, slab));
  }
}

// The scores' epilogue of a BK-key tile whose key 0 is j0 (s[4n + e]: rows
// rr = e >> 1, key j0 + 8n + 2t + (e & 1)): [* scale] [+ gate * pos] + key
// bias, keys past Lk at -inf. pv(rr, key) is this lane's pos element.
template <int BK, bool SCALED, bool GATED, typename Pos>
__device__ __forceinline__ void score_epilogue(float (&s)[BK / 2], const float* kb, int j0,
                                               int Lk, float scale, const float (&gt)[2],
                                               Pos&& pv, int t) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const int cc = n * 8 + 2 * t;
    const float2 kb2 = *reinterpret_cast<const float2*>(kb + cc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e];
      if (SCALED) x = __fmul_rn(x, scale);
      if (GATED) x = __fadd_rn(x, __fmul_rn(gt[e >> 1], pv(4 * n + e, cc + (e & 1))));
      s[4 * n + e] = __fadd_rn(x, (e & 1) ? kb2.y : kb2.x);
    }
  }
  if (j0 + BK > Lk) {
    const int nk = Lk - j0;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 + 2 * t + (e & 1) >= nk) s[4 * n + e] = neg_inf();
  }
}

// KT: key tiles a consumer holds (Lk <= 2 * KT * 64). GATE: kNoGate,
// kGateArray (gate [B, H, Lq] fp32) or kGateFromX (WavLM's gate Linear over
// x); gated, gate * pos is added to each score. SCALED: the product is
// multiplied by a.scale (the float route; the int8 route has it in q). The
// key bias is a.kbias (fp32 [B, Lk]) or, without it, a.kpm (bool [B, Lk],
// True = PAD; NULL: none).
template <typename T, int HD, int KT, int GATE, bool SCALED>
__global__ void __launch_bounds__(kWgThreads, 1)
    onepass_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const OnepassArgsT<T> a) {
  constexpr bool GATED = GATE != kNoGate;
  using Ly = WgLayout<HD, GATED>;
  constexpr int VS = Ly::VS, SLABS = HD / kWgSlab;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: slabs start on 1024 bytes
  uint8_t* const sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(sm), bar0 = s0 + Ly::BAR_OFF;
  // Q; gated, the pos rows and the gate weight; the K tiles; the V ring
  const uint32_t qfull = bar0, pfull = bar0 + 8, wfull = bar0 + 16;
  auto kfull = [&](int j) { return bar0 + 8 * (3 + j); };
  auto vfull = [&](int st) { return bar0 + 8 * (3 + kWgKTiles + st); };
  auto vempty = [&](int st) { return bar0 + 8 * (3 + kWgKTiles + VS + st); };
  auto ktile = [&](int j) { return sm + Ly::K_OFF + j * Ly::KSTAGE; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, i0 = blockIdx.y * kTcRows, h = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk, nt = (Lk + kOneBK - 1) / kOneBK;
  const size_t krow0 = (size_t)b * Lk;  // this element's key 0 in kbias / kpm

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(pfull, 2);  // lane 0's expect_tx and its tail copy's completion
    mbar_init(wfull, 1);
    // the producer's lane 0 expect_tx, its lanes' cp.async completions and
    // their stores
    for (int j = 0; j < kWgKTiles; ++j) mbar_init(kfull(j), 1 + 2 * 32);
    for (int st = 0; st < VS; ++st) {
      mbar_init(vfull(st), 1);
      mbar_init(vempty(st), 4);  // the owning consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup's index, broadcast so that the compiler knows it uniform
  // (wgmma in a branch it takes for divergent serialize)
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (wgi == kWgConsumers) {  // the producer warp: every load of the block, up front
    // pos element (i0, 0) of this head, and the 16-byte boundary at or below it
    const size_t pos_i0 = ((size_t)h * Lq + i0) * Lk, pos_st = pos_i0 & ~(size_t)7;
    if (lane == 0) {  // the gate weight and Q by lane 0, then K by one lane a tile
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      if (GATE == kGateFromX) {
        mbar_expect_tx(wfull, 8 * HD * 4);
        bulk_load(s0 + Ly::WG_OFF, a.wg, 8 * HD * 4, wfull);
      }
      mbar_expect_tx(qfull, Ly::TILE);
      for (int s = 0; s < SLABS; ++s)
        tma_load4(s0 + s * kWgSlabBytes, &qmap, s * kWgSlab, i0, h, b, qfull);
      if (GATED) {
        // rows i0 .. i0 + nq - 1 of pos are one span: whole 16-byte chunks by
        // one bulk copy, and where the span ends within the tensor's last
        // chunk, that chunk by a copy that fills zeros past the end
        const size_t pos_len = (size_t)a.H * Lq * Lk;
        const size_t n = pos_i0 - pos_st + (size_t)min(kTcRows, Lq - i0) * Lk;
        size_t nb = (n + 7) & ~(size_t)7;
        if (pos_st + nb > pos_len) nb = (pos_len - pos_st) & ~(size_t)7;
        T* const ps = reinterpret_cast<T*>(sm + Ly::POS_OFF);
        mbar_expect_tx(pfull, (int)(2 * nb));
        if (nb > 0) bulk_load(smem_addr(ps), a.pos + pos_st, (int)(2 * nb), pfull);
        if (nb < n) cp_async16(ps + nb, a.pos + pos_st + nb, (int)(2 * (pos_len - pos_st - nb)));
        mbar_arrive_cp_async(pfull);
      }
    }
    __syncwarp();
    if (lane < nt) {
      mbar_expect_tx(kfull(lane), Ly::TILE);
      for (int s = 0; s < SLABS; ++s)
        tma_load4(smem_addr(ktile(lane)) + s * kWgSlabBytes, &kmap, s * kWgSlab, lane * kOneBK,
                  h, b, kfull(lane));
    }
    // the padding mask's bytes, read now (any alignment: plain loads)
    constexpr int kPad = kWgMaxKeys / 32;
    uint8_t pad[kPad];
#pragma unroll
    for (int i = 0; i < kPad; ++i) {
      const int jj = lane + 32 * i;
      pad[i] = a.kbias == nullptr && a.kpm != nullptr && jj < Lk ? a.kpm[krow0 + jj] : 0;
    }
    for (int j = 0; j < nt; ++j) {
      uint8_t* const stg = ktile(j);
      const int j0 = j * kOneBK;
      if (a.kbias != nullptr) {
        float* const bs = reinterpret_cast<float*>(stg + Ly::TILE);
        for (int idx = lane; idx < kOneBK; idx += 32) {
          const bool ok = j0 + idx < Lk;
          cp_async4(bs + idx, a.kbias + krow0 + (ok ? j0 + idx : 0), ok ? 4 : 0);
        }
      }
      mbar_arrive_cp_async(kfull(j));
    }
    // the mask's biases (-1e9 / 0; zeros past Lk and without a mask), then
    // every K tile's second arrival
    if (a.kbias == nullptr) {
#pragma unroll
      for (int i = 0; i < kPad; ++i) {
        const int jj = lane + 32 * i;
        if (jj < nt * kOneBK)
          reinterpret_cast<float*>(ktile(jj / kOneBK) + Ly::TILE)[jj % kOneBK] =
              pad[i] ? kNegInf : 0.f;
      }
    }
    for (int j = 0; j < nt; ++j) mbar_arrive(kfull(j));
    // V is needed last: its loads wait until the K tiles and pos have landed,
    // so that they do not share the SM's bandwidth with them
    mbar_wait(kfull(nt - 1), 0);
    if (GATED) mbar_wait(pfull, 0);
    if (VS >= kWgKTiles && lane < nt) {  // V by TMA: one lane a tile
      mbar_expect_tx(vfull(lane), Ly::TILE);
      for (int s = 0; s < SLABS; ++s)
        tma_load4(s0 + Ly::V_OFF + lane * Ly::TILE + s * kWgSlabBytes, &vmap, s * kWgSlab,
                  lane * kOneBK, h, b, vfull(lane));
    }
    if (VS < kWgKTiles && lane == 0) {  // through a ring of fewer stages than tiles
      for (int j = 0; j < nt; ++j) {
        const int st = j % VS;
        mbar_wait(vempty(st), ((j / VS) & 1) ^ 1);
        mbar_expect_tx(vfull(st), Ly::TILE);
        for (int s = 0; s < SLABS; ++s)
          tma_load4(s0 + Ly::V_OFF + st * Ly::TILE + s * kWgSlabBytes, &vmap, s * kWgSlab,
                    j * kOneBK, h, b, vfull(st));
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- the consumers ----
  const int c = wgi, w = warp & 3, ltid = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = w * 16 + g;  // this lane's rows r0 and r0 + 8 of the block
  float* const xm = reinterpret_cast<float*>(sm + Ly::X_OFF);  // [2][64] row maxima
  float* const xl = xm + 2 * kTcRows;                          // [2][64] row sums

  // the gate of this lane's two rows: from its array, or (int8 route)
  // WavLM's gate from x while the first tiles load: the [8, hd] gate Linear
  // by consumer thread (row ct % 64, outputs 2 (ct / 64) and + 1), x read as
  // bf16, fp32 sums, into shared memory; then each lane its rows' two
  // sigmoids, each step rounded.
  float gt[2] = {0.f, 0.f};
  const T* pr[2] = {nullptr, nullptr};  // this lane's rows of pos, at key 0
  if constexpr (GATE == kGateArray) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = i0 + r0 + 8 * rr;
      if (i < Lq) gt[rr] = a.gate[((size_t)b * a.H + h) * Lq + i];
    }
  }
  if constexpr (GATE == kGateFromX) {
    float* const gp = reinterpret_cast<float*>(sm + Ly::GP_OFF);  // [64][8]
    const int r = tid & (kTcRows - 1), c2 = 2 * (tid >> 6);
    float xv[HD];
    if (i0 + r < Lq) {
      const size_t xo = ((size_t)b * Lq + i0 + r) * a.x_ld + h * HD;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 8) {
        if (a.x_f32) load8(static_cast<const float*>(a.x) + xo + d0, xv + d0);
        else load8(static_cast<const __nv_bfloat16*>(a.x) + xo + d0, xv + d0);
      }
    } else {
#pragma unroll
      for (int d = 0; d < HD; ++d) xv[d] = 0.f;
    }
    mbar_wait(wfull, 0);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float4* wr = reinterpret_cast<const float4*>(sm + Ly::WG_OFF) + (c2 + o) * HD / 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 wv = wr[d4];
        float& ac = acc[d4 & 3];
        ac += round_as<__nv_bfloat16>(xv[4 * d4]) * wv.x;
        ac += round_as<__nv_bfloat16>(xv[4 * d4 + 1]) * wv.y;
        ac += round_as<__nv_bfloat16>(xv[4 * d4 + 2]) * wv.z;
        ac += round_as<__nv_bfloat16>(xv[4 * d4 + 3]) * wv.w;
      }
      gp[r * 8 + c2 + o] = __fadd_rn((acc[0] + acc[1]) + (acc[2] + acc[3]), a.bg[c2 + o]);
    }
    consumers_sync();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* g8 = gp + (r0 + 8 * rr) * 8;
      const float ga = sigmoid(__fadd_rn(__fadd_rn(__fadd_rn(g8[0], g8[1]), g8[2]), g8[3]));
      const float gb = sigmoid(__fadd_rn(__fadd_rn(__fadd_rn(g8[4], g8[5]), g8[6]), g8[7]));
      gt[rr] = __fadd_rn(__fmul_rn(ga, __fadd_rn(__fmul_rn(gb, a.gconst[h]), -1.0f)), 2.0f);
    }
  }
  if (GATED) {
    const T* const pb = reinterpret_cast<const T*>(sm + Ly::POS_OFF) +
                        (((size_t)h * Lq + i0) * Lk & 7);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) pr[rr] = pb + (r0 + 8 * rr) * Lk;
  }

  // 1. the scores of this consumer's tiles j = c + 2k, and its row maxima
  float S[KT][32];
  float mx[2] = {neg_inf(), neg_inf()};
  const uint32_t qs = s0;
  mbar_wait(qfull, 0);
  auto issue_qk = [&](float (&s)[32], int j) {
    if (j < nt) {  // uniform over the warpgroup
      mbar_wait(kfull(j), 0);
      const uint32_t ks = smem_addr(ktile(j));
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < HD / 16; ++k16) {
        const uint32_t off = (k16 >> 1) * kWgSlabBytes + (k16 & 1) * 32;
        wgmma_qk<T>(s, wg_desc(qs + off, 0), wg_desc(ks + off, 0), k16 > 0);
      }
    }
    wgmma_commit();  // one group a slot, empty past the last tile
  };
  issue_qk(S[0], c);
  if (GATED) mbar_wait(pfull, 0);
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int j = c + 2 * k;
    if (k + 1 < KT) {
      issue_qk(S[k + 1 < KT ? k + 1 : k], j + 2);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    if (j < nt) {
      const int j0 = j * kOneBK;
      score_epilogue<kOneBK, SCALED, GATED>(
          S[k], reinterpret_cast<const float*>(ktile(j) + Ly::TILE), j0, Lk, a.scale, gt,
          [&](int i, int cc) { return load_f(pr[(i >> 1) & 1] + j0 + cc); }, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(S[k][4 * n], S[k][4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(S[k][4 * n + 2], S[k][4 * n + 3]));
      }
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  if (t == 0) xm[c * kTcRows + r0] = mx[0], xm[c * kTcRows + r0 + 8] = mx[1];
  consumers_sync();
  float m[2], l[2], rl[2];  // rl = 1 / l
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) m[rr] = fmaxf(xm[r0 + 8 * rr], xm[kTcRows + r0 + 8 * rr]);

  // 2. one exp a score, the rows' sums over both consumers
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (c + 2 * k < nt) {
      float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // by row and n-tile parity: 4 chains
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        S[k][i] = expf(__fadd_rn(S[k][i], -m[(i >> 1) & 1]));
        part[(i >> 1) & 1][(i >> 2) & 1] += S[k][i];
      }
      sum[0] += part[0][0] + part[0][1];
      sum[1] += part[1][0] + part[1][1];
    }
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  if (t == 0) xl[c * kTcRows + r0] = sum[0], xl[c * kTcRows + r0 + 8] = sum[1];
  consumers_sync();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] = __fadd_rn(xl[r0 + 8 * rr], xl[kTcRows + r0 + 8 * rr]);
    rl[rr] = __frcp_rn(l[rr]);
  }

  // 3. p / l rounded to T into wgmma's A fragments, every slot first (the
  //    scores die as they are packed), then O += P V slot by slot
  uint32_t pa[KT][4][4];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (c + 2 * k < nt) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = div_rn(S[k][4 * n + e], l[e >> 1], rl[e >> 1]);
        pa[k][n >> 1][2 * (n & 1)] = pack2<T>(p[0], p[1]);
        pa[k][n >> 1][2 * (n & 1) + 1] = pack2<T>(p[2], p[3]);
      }
    }
  }
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int j = c + 2 * k;
    if (VS < kWgKTiles && k > 0) {
      // a ring of fewer V tiles than the block's: slot k's tile may take the
      // stage of slot k - 1's, so that product retires and the stage is
      // released first
      wgmma_wait<0>();
      if (j - 2 < nt) {
        __syncwarp();
        if (lane == 0) mbar_arrive(vempty((j - 2) % VS));
      }
    }
    if (j < nt) {
      const int st = j % VS;
      mbar_wait(vfull(st), (j / VS) & 1);
      const uint32_t vs = s0 + Ly::V_OFF + st * Ly::TILE;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16) pv_step<T, HD>(o, pa[k][k16], vs + k16 * 16 * 64, kWgSlabBytes);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  // the last slot's V stage needs no release: the producer loads no more

  // 4. each consumer hands the other the half of its O that the other
  //    stores (through the K tiles: every one was consumed before the row
  //    maxima were exchanged); consumer c stores columns c * HD / 2 on, as
  //    O0 + O1
  constexpr int NH = HD / 16;  // n-tiles of a half
  float4* const ox = reinterpret_cast<float4*>(sm + Ly::K_OFF);  // [2 * NH][128]
  T* const out = a.out + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
  const int ra = i0 + r0, rb = ra + 8;
  auto store = [&](int n, float4 o0, float4 o1) {  // columns of n-tile n: O0 + O1
    const int col = n * 8 + 2 * t;
    if (ra < Lq)
      store2(out + (size_t)ra * a.o_sl + col, __fadd_rn(o0.x, o1.x), __fadd_rn(o0.y, o1.y));
    if (rb < Lq)
      store2(out + (size_t)rb * a.o_sl + col, __fadd_rn(o0.z, o1.z), __fadd_rn(o0.w, o1.w));
  };
  auto tile = [&](int n) { return make_float4(o[4 * n], o[4 * n + 1], o[4 * n + 2], o[4 * n + 3]); };
  if (c == 0) {  // indices stay compile-time in each branch
#pragma unroll
    for (int n = 0; n < NH; ++n) ox[(NH + n) * 128 + ltid] = tile(NH + n);
  } else {
#pragma unroll
    for (int n = 0; n < NH; ++n) ox[n * 128 + ltid] = tile(n);
  }
  consumers_sync();
  if (c == 0) {
#pragma unroll
    for (int n = 0; n < NH; ++n) store(n, tile(n), ox[n * 128 + ltid]);
  } else {
#pragma unroll
    for (int n = 0; n < NH; ++n) store(NH + n, ox[(NH + n) * 128 + ltid], tile(NH + n));
  }
}

// The two sweeps on warpgroups (float route): HD 64 or 96 (hd = HD), gated
// or not, or the wide tiles HD 192 and 256 ungated (hd <= HD, the columns
// past hd zero-filled by TMA and never stored). BK: keys a tile. The gate
// comes from a.gate, the key bias from a.kbias (fp32 [B, Lk], Lk <=
// kSwMaxKeys), the scale multiplies the product.
template <typename T, int HD, int BK, bool GATED>
__global__ void __launch_bounds__(128 * kWgConsumers + kSwProducers<GATED>, 1)
    onepass_sweeps_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const OnepassArgsT<T> a) {
  using Ly = SwLayout<HD, BK, GATED>;
  constexpr int NS = Ly::NS, SLABS = Ly::SLABS, NSC = BK / 2;  // S registers a thread
  constexpr int NP = kSwProducers<GATED>;
  constexpr int PLD = BK + 8;  // a realigned pos row: the tile's keys + up to 7
  // the next step's QK^T in flight during this step's epilogue, where
  // registers allow: at HD 256 O alone is 128 a thread
  constexpr bool PIPE = HD <= 192;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(sm), bar0 = s0 + Ly::BAR_OFF;
  const uint32_t qfull = bar0, bfull = bar0 + 8;
  auto full = [&](int st) { return bar0 + 8 * (2 + st); };
  auto empty = [&](int st) { return bar0 + 8 * (2 + NS + st); };
  auto stage = [&](int it) { return Ly::RING_OFF + (it % NS) * Ly::STAGE; };  // offset
  float* const kb = reinterpret_cast<float*>(sm + Ly::KB_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, i0 = blockIdx.y * kSwRows, h = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk, nt = (Lk + BK - 1) / BK, steps = 2 * nt;
  // pos element (i0, 0) of this head; the tensor's length bounds every copy
  const size_t pos_i0 = ((size_t)h * Lq + i0) * Lk, pos_len = (size_t)a.H * Lq * Lk;

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(bfull, NP);  // each producer thread's cp.async completion
    for (int st = 0; st < NS; ++st) {
      // producer thread 0's expect_tx and, gated, every producer thread's
      // pos copies
      mbar_init(full(st), 1 + (GATED ? NP : 0));
      mbar_init(empty(st), 4 * kWgConsumers);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (wgi == kWgConsumers) {  // the producer warp (gated: warpgroup)
    const int pt = tid - 128 * kWgConsumers;
    if (pt == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_expect_tx(qfull, kWgConsumers * Ly::QT);
      for (int c = 0; c < kWgConsumers; ++c)
        for (int s = 0; s < SLABS; ++s)
          tma_load4(s0 + c * Ly::QT + s * kWgSlabBytes, &qmap, s * kWgSlab, i0 + c * kTcRows, h,
                    b, qfull);
    }
    // the row's key biases by every thread (any alignment: 4-byte copies)
    const float* const kbg = a.kbias + (size_t)b * Lk;
    for (int j = pt; j < Lk; j += NP) cp_async4(kb + j, kbg + j, 4);
    mbar_arrive_cp_async(bfull);
    // step it: K tile it % nt, in sweep 2 its V tile (thread 0, TMA), and,
    // gated, the block's pos rows of its keys (every thread, cp.async: each
    // row from the 16-byte boundary at or below its key j0, read by the
    // consumers at its offset; zeros past the tensor's end and Lq)
    const int nq = min(kSwRows, Lq - i0);
    for (int it = 0; it < steps; ++it) {
      const int st = it % NS, j0 = (it % nt) * BK;
      mbar_wait(empty(st), ((it / NS) & 1) ^ 1);
      const uint32_t stg = s0 + stage(it);
      if (pt == 0) {
        mbar_expect_tx(full(st), it < nt ? Ly::KTILE : 2 * Ly::KTILE);
        for (int s = 0; s < SLABS; ++s)
          tma_load4(stg + s * Ly::KSLAB, &kmap, s * kWgSlab, j0, h, b, full(st));
        if (it >= nt)
          for (int s = 0; s < SLABS; ++s)
            tma_load4(stg + Ly::KTILE + s * Ly::KSLAB, &vmap, s * kWgSlab, j0, h, b, full(st));
      }
      if (GATED) {
        T* const ps = reinterpret_cast<T*>(sm + stage(it) + 2 * Ly::KTILE);
        constexpr int kChunks = PLD / 8;
        for (int idx = pt; idx < kSwRows * kChunks; idx += NP) {
          const int r = idx / kChunks, cc = idx - r * kChunks;
          const size_t ad = ((pos_i0 + (size_t)r * Lk + j0) & ~(size_t)7) + 8 * cc;
          const size_t left = r < nq && ad < pos_len ? 2 * (pos_len - ad) : 0;  // bytes
          const int bytes = left < 16 ? (int)left : 16;
          cp_async16(ps + r * PLD + 8 * cc, a.pos + (bytes ? ad : 0), bytes);
        }
        mbar_arrive_cp_async(full(st));
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- the consumers: warpgroup c owns rows i0 + 64c .. i0 + 64c + 63 ----
  const int c = wgi;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = c * kTcRows + (warp & 3) * 16 + g;  // this lane's rows r0 and r0 + 8 of the block
  const int ra = i0 + r0;
  float gt[2] = {0.f, 0.f};
  int psh[2] = {0, 0};  // gated: the column of key 0 in this lane's realigned pos rows
  if (GATED) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = ra + 8 * rr;
      if (i < Lq) gt[rr] = a.gate[((size_t)b * a.H + h) * Lq + i];
      psh[rr] = (int)((pos_i0 + (size_t)(r0 + 8 * rr) * Lk) & 7);
    }
  }
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const uint32_t qs = s0 + c * Ly::QT;
  mbar_wait(qfull, 0);
  mbar_wait(bfull, 0);

  auto issue_qk = [&](float (&s)[NSC], int it) {
    if (it < steps) {  // uniform
      mbar_wait(full(it % NS), (it / NS) & 1);
      const uint32_t ks = s0 + stage(it);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < HD / 16; ++k16)
        wgmma_qk<T>(s, wg_desc(qs + (k16 >> 1) * kWgSlabBytes + (k16 & 1) * 32, 0),
                    wg_desc(ks + (k16 >> 1) * Ly::KSLAB + (k16 & 1) * 32, 0), k16 > 0);
    }
    wgmma_commit();  // one group a step, empty past the last
  };
  auto release = [&](int it) {  // every product that read step it's stage has retired
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(it % NS));
  };

  // One step: this step's tile from s. PIPE: the next step's QK^T into sn
  // first, so that pending at the wait are this step's QK^T, the last
  // step's PV (sweep 2) and the next QK^T, and wait<1> leaves only the next
  // in flight; else the next QK^T is issued into s once this step has
  // packed it, and the wait takes every group.
  auto step = [&](int it, float (&s)[NSC], float (&sn)[NSC]) {
    const int j0 = (it % nt) * BK;
    if constexpr (PIPE) {
      issue_qk(sn, it + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    if (it > nt) release(it - 1);  // sweep 2: the last step's K, V and pos
    const T* const ps = reinterpret_cast<const T*>(sm + stage(it) + 2 * Ly::KTILE) +
                        r0 * PLD;
    score_epilogue<BK, true, GATED>(
        s, kb + j0, j0, Lk, a.scale, gt,
        [&](int i, int cc) {
          const int rr = (i >> 1) & 1;
          return load_f(ps + rr * 8 * PLD + psh[rr] + cc);
        },
        t);
    // sweep 1: K, read by this step's QK^T, and pos, read by its epilogue
    if (it < nt) release(it);
    if (it < nt) {  // sweep 1: running max and rescaled running sum
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = neg_inf();
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * rr], s[4 * n + 2 * rr + 1]));
        const float mn = fmaxf(m[rr], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          sum += expf(__fadd_rn(s[4 * n + 2 * rr], -mn)) +
                 expf(__fadd_rn(s[4 * n + 2 * rr + 1], -mn));
        l[rr] = __fadd_rn(__fmul_rn(l[rr], expf(__fadd_rn(m[rr], -mn))), quad_sum(sum));
        m[rr] = mn;
      }
      if (it == nt - 1) rl[0] = __frcp_rn(l[0]), rl[1] = __frcp_rn(l[1]);
    } else {  // sweep 2: p / l rounded to T, then PV
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = div_rn(expf(__fadd_rn(s[4 * n + e], -m[e >> 1])), l[e >> 1], rl[e >> 1]);
        pa[n >> 1][2 * (n & 1)] = pack2<T>(p[0], p[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack2<T>(p[2], p[3]);
      }
      const uint32_t vs = s0 + stage(it) + Ly::KTILE;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < BK / 16; ++k16) pv_step<T, HD>(o, pa[k16], vs + k16 * 16 * 64, Ly::KSLAB);
      wgmma_commit();
    }
    if constexpr (!PIPE) issue_qk(s, it + 1);
  };

  float sa[NSC], sb[PIPE ? NSC : 1];
  issue_qk(sa, 0);
  if constexpr (PIPE) {
    for (int it = 0; it < steps; it += 2) {  // two steps a turn: the S buffers stay registers
      step(it, sa, sb);
      if (it + 1 < steps) step(it + 1, sb, sa);
    }
  } else {
    for (int it = 0; it < steps; ++it) step(it, sa, sa);
  }
  wgmma_wait<0>();

  T* const out = a.out + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
  const int hd = a.hd;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (HD > 96 && col >= hd) continue;
    if (ra < Lq) store2(out + (size_t)ra * a.o_sl + col, o[4 * n], o[4 * n + 1]);
    if (ra + 8 < Lq) store2(out + (size_t)(ra + 8) * a.o_sl + col, o[4 * n + 2], o[4 * n + 3]);
  }
}

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

// A [B, H, L, hd] operand of T (2 bytes) at `base`, element (b, h, i, d) at
// b*sb + h*sh + i*sl + d (strides in elements): boxes of one slab (32
// columns) by `rows` rows of one (element, head), 64-byte swizzle; rows past
// L and columns past hd read as zeros. A stride of a dimension of size 1
// (0 from the caller) is never used and is given a legal value.
inline bool wg_tensor_map(CUtensorMap* map, const void* base, bool f16, int hd, int L, int H,
                          int B, long long sl, long long sh, long long sb, int rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  if (sl == 0) sl = hd;
  if (sh == 0) sh = sl * L;
  if (sb == 0) sb = sh * H > sl * L ? sh * H : sl * L;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kWgSlab, (cuuint32_t)rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q's, k's and v's maps: q in boxes of 64 rows, k and v of `key_rows`.
template <typename T>
bool wg_maps(const OnepassArgsT<T>& a, int B, int key_rows, CUtensorMap* qm, CUtensorMap* km,
             CUtensorMap* vm) {
  constexpr bool f16 = kIsHalf<T>;
  return wg_tensor_map(qm, a.q, f16, a.hd, a.Lq, a.H, B, a.q_sl, a.q_sh, a.q_sb, kTcRows) &&
         wg_tensor_map(km, a.k, f16, a.hd, a.Lk, a.H, B, a.k_sl, a.k_sh, a.k_sb, key_rows) &&
         wg_tensor_map(vm, a.v, f16, a.hd, a.Lk, a.H, B, a.v_sl, a.v_sh, a.v_sb, key_rows);
}

template <typename T, int HD, int KT, int GATE, bool SCALED>
void launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                  const OnepassArgsT<T>& a, int B, cudaStream_t s) {
  const auto kernel = onepass_wgmma_kernel<T, HD, KT, GATE, SCALED>;
  constexpr int smem = WgLayout<HD, GATE != kNoGate>::SMEM;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  note_launch(kOnepassWgmmaKernel, HD);
  // batch element fastest: the blocks that read one pos tile run together
  kernel<<<dim3(B, (a.Lq + kTcRows - 1) / kTcRows, a.H), kWgThreads, smem, s>>>(qm, km, vm, a);
}

// The held core on onepass_wgmma_kernel: a.hd 64 or 96, Lk <= kWgMaxKeys
// (the caller checks), gate GATE (kNoGate or the route's gate), SCALED as
// the kernel. Returns a CUDA error code, cudaErrorInvalidValue where a
// tensor map cannot be made.
template <int GATE, bool SCALED, typename T>
int launch_onepass_wgmma(const OnepassArgsT<T>& a, int B, cudaStream_t s) {
  CUtensorMap qm, km, vm;
  if (!wg_maps(a, B, kOneBK, &qm, &km, &vm)) return (int)cudaErrorInvalidValue;
  const bool wide = a.Lk > kWgConsumers * 2 * kOneBK;  // more than 2 tiles a consumer
  auto go = [&](auto HD, auto KT) {
    launch_wgmma<T, decltype(HD)::value, decltype(KT)::value, GATE, SCALED>(qm, km, vm, a, B, s);
  };
  using I64 = std::integral_constant<int, 64>;
  using I96 = std::integral_constant<int, 96>;
  using K2 = std::integral_constant<int, 2>;
  using K4 = std::integral_constant<int, kWgMaxKT>;
  if (a.hd == 64) wide ? go(I64(), K4()) : go(I64(), K2());
  else wide ? go(I96(), K4()) : go(I96(), K2());
  return (int)cudaGetLastError();
}

// The tile instance of the sweeps kernel that serves head dim hd (gated: 64
// and 96 only), or 0 for none.
inline int sweeps_instance(int hd, bool gated) {
  if (hd == 64 || hd == 96) return hd;
  if (gated || hd < 136 || hd > 256 || hd % 8) return 0;
  return tile_head_dim(hd);
}

// The core on onepass_sweeps_kernel at the instance sweeps_instance names
// (the caller checks that it is not 0, and Lk <= kSwMaxKeys).
template <bool GATED, typename T>
int launch_onepass_sweeps(const OnepassArgsT<T>& a, int B, cudaStream_t s) {
  const int inst = sweeps_instance(a.hd, GATED);
  const int bk = inst <= 96 ? 64 : 32;
  CUtensorMap qm, km, vm;
  if (!wg_maps(a, B, bk, &qm, &km, &vm)) return (int)cudaErrorInvalidValue;
  auto go = [&](auto HD, auto BK) {
    constexpr int hd_ = decltype(HD)::value, bk_ = decltype(BK)::value;
    const auto kernel = onepass_sweeps_kernel<T, hd_, bk_, GATED>;
    constexpr int smem = SwLayout<hd_, bk_, GATED>::SMEM;
    static bool attr_set = false;  // one per instantiation
    if (!attr_set) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      attr_set = true;
    }
    note_launch(kOnepassSweepsKernel, hd_);
    kernel<<<dim3(B, (a.Lq + kSwRows - 1) / kSwRows, a.H), 128 * kWgConsumers + kSwProducers<GATED>,
             smem, s>>>(qm, km, vm, a);
  };
  using K64 = std::integral_constant<int, 64>;
  using K32 = std::integral_constant<int, 32>;
  if (inst == 64) go(std::integral_constant<int, 64>(), K64());
  else if (inst == 96) go(std::integral_constant<int, 96>(), K64());
  else if constexpr (!GATED) {
    if (inst == 192) go(std::integral_constant<int, 192>(), K32());
    else go(std::integral_constant<int, 256>(), K32());
  }
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace hr
