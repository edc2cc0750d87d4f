// The int8 sublayers' attention core at head dims 64 and 96 on Hopper's own
// machinery: wgmma warpgroups fed by a producer warp through mbarriers
// (onepass_wgmma_kernel). It replaces, for the key rows it holds
// (kWgMaxKeys, 512), the core of the Pallas kernels
// hriemo/ops/attention_block.py::_kernel (WavLM, gated relative position
// bias, :218-257) and ::_mha_kernel (a key-padding bias, :576-605). Its
// earlier counterparts stay beside it: csrc/onepass_mma.cuh's two sweeps on
// mma.sync (longer rows, the sublayers' chain routes, the float routes) and
// csrc/attention.cu's score panel; ops/attention_block.py core_kernel
// routes between the three by the card's readings.
//
// The function is the two-sweep kernel's:
//   s = q . k^T (1/sqrt(hd) is in q: scale 1, exact, so no multiply)
//       [+ gate[i] * pos[h,i,j]] + key bias[b,j]    (__fmul_rn/__fadd_rn, in
//       the TPU kernel's order; keys past Lk at -inf)
//   m = max_j s,  l = sum_j exp(s - m)  (l over the final maximum, as the
//       TPU kernel and the plain version take it)
//   out = bf16(p / l rounded to nearest) . v, fp32 sums, stored as bf16.
// A fully masked row (every key bias -1e9) comes out as a finite average of v.
//
// Design. A block takes 64 query rows of one (batch element, head) and all
// their keys: two consumer warpgroups and one producer warp (288 threads,
// one block an SM). Consumer c takes key tiles c, c + 2, c + 4, ... and keeps
// every score of its tiles in registers (KT tiles of 64 x 64 fp32, 32 a
// thread each; KT 2 up to 256 keys, 4 up to 512), so each score is computed
// once and each exp taken once, where the two sweeps compute QK^T, the
// epilogue and the exp twice:
//   1. S = Q K^T by wgmma.m64n64k16 from shared memory (Q and K K-major),
//      the next tile's product in flight while this tile's epilogue (gate *
//      pos, key bias, mask) runs; the rows' maxima over the warpgroup's keys,
//      exchanged with the other warpgroup through shared memory;
//   2. e = exp(s - m) in place, the rows' sums exchanged the same way, so
//      both warpgroups hold the same l = l0 + l1 (in that order);
//   3. p = e / l rounded to nearest (csrc/attention_tiles.cuh div_rn), then
//      to bf16 straight from the S accumulator's fragments into wgmma's A
//      registers; O += P V by wgmma.m64nHDk16 with V from shared memory
//      (MN-major, the transposed-B form);
//   4. each warpgroup hands the other the half of its O that the other
//      stores, which stores O0 + O1.
// One warpgroup's exp and division (FMA and MUFU) run beside the other's
// asynchronous wgmma.
//
// The producer warp issues every load of the block up front, each
// completing on an mbarrier: lane 0 the gate Linear's weight and the block's
// pos rows by bulk copies and Q by TMA, one lane a tile every K tile by TMA
// (with its key biases: fp32 by cp.async, the bool mask turned into -1e9 / 0
// by plain stores), and V by TMA once the K tiles and pos have landed, so
// that V does not share the SM's bandwidth with what the first products
// need. Every K tile stays resident (eight stages of K and its biases, no
// reuse, so no empty barriers); V takes eight stages too where shared
// memory allows (a ring of two at HD 96 gated, released by the consumers
// through empty barriers). The consumers compute WavLM's gate from x (vector
// loads, the weight from shared memory) while the first tiles land.
// The block is one producer warp and no setmaxnreg: with a producer
// warpgroup (384 threads) and setmaxnreg 40 / 232, ptxas kept the consumers
// at the launch bound's 168 registers and spilled the four-tile instances;
// at 288 threads every instance may take 224 (at HD 96 four tiles still
// spill 536 bytes: S 128 and O 48 registers).
//
// Where the trouble lies, and what the design does:
// - pos [H, Lq, Lk] bf16 rows are only 2-byte aligned at odd Lk, and a TMA
//   global stride must be a multiple of 16 bytes, so no tensor map describes
//   them; but the block's 64 rows are one span of the tensor, so one bulk
//   copy takes it from the 16-byte boundary below its first element (the
//   consumers read it at that offset), and where the span ends inside the
//   tensor's last 16 bytes that chunk comes by a copy that fills zeros past
//   the end. A copy a realigned row (64 a tile) kept the TMA unit far behind
//   the consumers.
// - K and V are column blocks of the packed [B*L, 3D] (self) or [B*Lk, 2D]
//   (cross) projection output. A 2D box of 64 keys would run into the next
//   element's rows at the tail, so each of q, k and v is described as a 3D
//   tensor [B, L, cols] (row stride ld, element stride L * ld, both multiples
//   of 16 bytes): TMA fills the rows past L with zeros itself and reads
//   nothing past the array's end; the scores of those keys are set to -inf.
// - At head dim 96 a row is 192 bytes, more than one 128-byte swizzle atom.
//   Every tile is cut into slabs of 32 columns (64-byte rows) in the 64-byte
//   swizzle, one TMA box each (2 slabs at 64, 3 at 96): K and Q read K-major
//   (a k16 step is 32 bytes into a slab), V MN-major (the slabs 4096 bytes
//   apart along the output columns, 8 keys 512 bytes apart).
// - At 62 keys one key tile leaves one consumer idle: the rule keeps the
//   score panel there.
// What bounds it on this card (NVIDIA H100 80GB HBM3 at 700 W;
// chip_proj_routes.py --cores, chip_core_stamps.py, PERF.md section 6): a
// block moves about 200 KB (Q, K, V, pos) from L2 at about
// 24 bytes a cycle, and with one block an SM nothing overlaps that; then the
// per-score work, about 26 lane instructions a score against about 40 for
// the two sweeps (cuobjdump -sass by opcode class). B=32 L=499 12 x 64
// takes 20,800-21,600 cycles a block (chip_core_stamps.py, query tiles 0 and
// 7): 8,200-9,600 until the gate, Q, the first K tile and pos are in,
// 4,300-4,800 for QK^T and the epilogue, 3,200-3,400 for the exps and as
// many for PV; 0.268 ms against the two sweeps' 0.508 and SDPA's 0.258.
#pragma once

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

// Shared memory of one block, from a 1024-byte boundary: Q's slabs; every K
// tile of the row block with its key biases (K is never reloaded, so the K
// tiles need no empty barrier); gated, the block's rows of pos (one span of
// the tensor) and the gate Linear's weight; a ring of V tiles, every tile
// where it fits (VS); the row maxima and sums of both consumers; the gate
// Linear's outputs; the barriers.
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
#define HR_W32(d)                                                                   \
  HR_W4(d, 0), HR_W4(d, 4), HR_W4(d, 8), HR_W4(d, 12), HR_W4(d, 16), HR_W4(d, 20), \
      HR_W4(d, 24), HR_W4(d, 28)
#define HR_R32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// s (+)= Q . K^T over 16 head columns: 64 query rows by 64 keys, both
// operands K-major in shared memory; s = Q . K^T when `acc` is 0. s[4n + e]
// holds row 16w + g (+ 8 for e >= 2) and key 8n + 2t + (e & 1) of warp w.
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HR_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HR_W32(s)
      : "l"(da), "l"(db), "r"(acc));
}

// o += P . V over 16 keys: P's A fragment in registers (rows as the S
// accumulator's), V MN-major in shared memory, HD output columns.
template <int HD>
struct WgmmaPv;

template <>
struct WgmmaPv<64> {
  static __device__ __forceinline__ void mma(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HR_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HR_W32(o)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaPv<96> {
  static __device__ __forceinline__ void mma(float (&o)[48], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
        ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : HR_W32(o), HR_W4(o, 32), HR_W4(o, 36), HR_W4(o, 40), HR_W4(o, 44)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
#undef HR_W4
#undef HR_W32
#undef HR_R32

// KT: key tiles a consumer holds (Lk <= 2 * KT * 64). GATED: WavLM's gate
// from x times pos added to each score. The key bias is a.kbias (fp32
// [B, Lk]) or, without it, a.kpm (bool [B, Lk], True = PAD; NULL: none).
template <int HD, int KT, bool GATED>
__global__ void __launch_bounds__(kWgThreads, 1)
    onepass_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const OnepassArgs a) {
  using T = __nv_bfloat16;
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
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)));
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)));
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)));
      if (GATED) {
        mbar_expect_tx(wfull, 8 * HD * 4);
        bulk_load(s0 + Ly::WG_OFF, a.wg, 8 * HD * 4, wfull);
      }
      mbar_expect_tx(qfull, Ly::TILE);
      for (int s = 0; s < SLABS; ++s)
        tma_load3(s0 + s * kWgSlabBytes, &qmap, h * HD + s * kWgSlab, i0, b, qfull);
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
        tma_load3(smem_addr(ktile(lane)) + s * kWgSlabBytes, &kmap, h * HD + s * kWgSlab,
                  lane * kOneBK, b, kfull(lane));
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
        tma_load3(s0 + Ly::V_OFF + lane * Ly::TILE + s * kWgSlabBytes, &vmap,
                  h * HD + s * kWgSlab, lane * kOneBK, b, vfull(lane));
    }
    if (VS < kWgKTiles && lane == 0) {  // through a ring of fewer stages than tiles
      for (int j = 0; j < nt; ++j) {
        const int st = j % VS;
        mbar_wait(vempty(st), ((j / VS) & 1) ^ 1);
        mbar_expect_tx(vfull(st), Ly::TILE);
        for (int s = 0; s < SLABS; ++s)
          tma_load3(s0 + Ly::V_OFF + st * Ly::TILE + s * kWgSlabBytes, &vmap,
                    h * HD + s * kWgSlab, j * kOneBK, b, vfull(st));
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

  // WavLM's gate of this lane's two rows, while the first tiles load: the
  // [8, hd] gate Linear by consumer thread (row ct % 64, outputs 2 (ct / 64)
  // and + 1), x read as bf16, fp32 sums, into shared memory; then each lane
  // its rows' two sigmoids, each step rounded.
  float gt[2] = {0.f, 0.f};
  const T* pr[2] = {nullptr, nullptr};  // this lane's rows of pos, at key 0
  if (GATED) {
    float* const gp = reinterpret_cast<float*>(sm + Ly::GP_OFF);  // [64][8]
    const int r = tid & (kTcRows - 1), c2 = 2 * (tid >> 6);
    float xv[HD];
    if (i0 + r < Lq) {
      const size_t xo = ((size_t)b * Lq + i0 + r) * a.x_ld + h * HD;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 8) {
        if (a.x_f32) load8(static_cast<const float*>(a.x) + xo + d0, xv + d0);
        else load8(static_cast<const T*>(a.x) + xo + d0, xv + d0);
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
        ac += round_as<T>(xv[4 * d4]) * wv.x;
        ac += round_as<T>(xv[4 * d4 + 1]) * wv.y;
        ac += round_as<T>(xv[4 * d4 + 2]) * wv.z;
        ac += round_as<T>(xv[4 * d4 + 3]) * wv.w;
      }
      gp[r * 8 + c2 + o] = __fadd_rn((acc[0] + acc[1]) + (acc[2] + acc[3]), a.bg[c2 + o]);
    }
    consumers_sync();
    const T* const pb = reinterpret_cast<const T*>(sm + Ly::POS_OFF) +
                        (((size_t)h * Lq + i0) * Lk & 7);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* g8 = gp + (r0 + 8 * rr) * 8;
      const float ga = sigmoid(__fadd_rn(__fadd_rn(__fadd_rn(g8[0], g8[1]), g8[2]), g8[3]));
      const float gb = sigmoid(__fadd_rn(__fadd_rn(__fadd_rn(g8[4], g8[5]), g8[6]), g8[7]));
      gt[rr] = __fadd_rn(__fmul_rn(ga, __fadd_rn(__fmul_rn(gb, a.gconst[h]), -1.0f)), 2.0f);
      pr[rr] = pb + (r0 + 8 * rr) * Lk;
    }
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
        wgmma_qk(s, wg_desc(qs + off, 0), wg_desc(ks + off, 0), k16 > 0);
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
      const float* const bs = reinterpret_cast<const float*>(ktile(j) + Ly::TILE);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int cc = n * 8 + 2 * t;
        const float2 kb2 = *reinterpret_cast<const float2*>(bs + cc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          float x = S[k][4 * n + e];
          if (GATED)
            x = __fadd_rn(x, __fmul_rn(gt[rr], load_f(pr[rr] + j * kOneBK + cc + (e & 1))));
          S[k][4 * n + e] = __fadd_rn(x, (e & 1) ? kb2.y : kb2.x);
        }
      }
      if ((j + 1) * kOneBK > Lk) {
        const int nk = Lk - j * kOneBK;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n * 8 + 2 * t + (e & 1) >= nk) S[k][4 * n + e] = neg_inf();
      }
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

  // 3. p / l rounded to bf16 into wgmma's A fragments, every slot first (the
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
      for (int k16 = 0; k16 < 4; ++k16)
        WgmmaPv<HD>::mma(o, pa[k][k16], wg_desc(vs + k16 * 16 * 64, kWgSlabBytes));
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

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

// [B, L, cols] bf16 at `base`, rows `ld` elements apart: boxes of one slab
// (32 columns) by 64 rows of one element, 64-byte swizzle; rows past L read
// as zeros.
inline bool wg_tensor_map(CUtensorMap* map, const void* base, int cols, int L, int B, int ld) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)L * ld * 2};
  const cuuint32_t box[3] = {kWgSlab, kOneBK, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int KT, bool GATED>
void launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                  const OnepassArgs& a, int B, cudaStream_t s) {
  const auto kernel = onepass_wgmma_kernel<HD, KT, GATED>;
  constexpr int smem = WgLayout<HD, GATED>::SMEM;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  note_launch(kOnepassWgmmaKernel, HD);
  // batch element fastest: the blocks that read one pos tile run together
  kernel<<<dim3(B, (a.Lq + kTcRows - 1) / kTcRows, a.H), kWgThreads, smem, s>>>(qm, km, vm, a);
}

// The core on onepass_wgmma_kernel: hd 64 or 96, Lk <= kWgMaxKeys (the
// caller checks). a's q/k/v row strides are their ld; H * hd columns from
// each pointer. Returns a CUDA error code, cudaErrorInvalidValue where a
// tensor map cannot be made.
inline int launch_onepass_wgmma(const OnepassArgs& a, int B, int hd, bool gated,
                                cudaStream_t s) {
  CUtensorMap qm, km, vm;
  const int cols = a.H * hd;
  if (!wg_tensor_map(&qm, a.q, cols, a.Lq, B, a.q_sl) ||
      !wg_tensor_map(&km, a.k, cols, a.Lk, B, a.k_sl) ||
      !wg_tensor_map(&vm, a.v, cols, a.Lk, B, a.v_sl))
    return (int)cudaErrorInvalidValue;
  const bool wide = a.Lk > kWgConsumers * 2 * kOneBK;  // more than 2 tiles a consumer
  auto go = [&](auto HD, auto KT) {
    constexpr int hd_ = decltype(HD)::value, kt = decltype(KT)::value;
    if (gated) launch_wgmma<hd_, kt, true>(qm, km, vm, a, B, s);
    else launch_wgmma<hd_, kt, false>(qm, km, vm, a, B, s);
  };
  using I64 = std::integral_constant<int, 64>;
  using I96 = std::integral_constant<int, 96>;
  using K2 = std::integral_constant<int, 2>;
  using K4 = std::integral_constant<int, kWgMaxKT>;
  if (hd == 64) wide ? go(I64(), K4()) : go(I64(), K2());
  else wide ? go(I96(), K4()) : go(I96(), K2());
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace hr
