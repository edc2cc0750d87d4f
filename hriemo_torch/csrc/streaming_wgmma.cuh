// The streaming (online-softmax) attention core on Hopper's own machinery:
// wgmma warpgroups fed by a producer warp through mbarriers
// (hriemo_torch/ops/flash_attention.py streaming_attention, for the shapes
// that ops/flash_attention.py streaming_kernel gives to "wgmma" or
// "wgmma_split"). Replaces, in bf16 and fp16, the Pallas kernel
// hriemo/ops/flash_attention_pallas.py::_flash_kernel (:38, launched at
// :182) beyond 2048 keys, in place of csrc/flash_attention.cu's mma.sync
// kernels, which stay built as the yardstick and for fp32.
//
// The function is the TPU kernel's, step for step. For each step of kStBK =
// 128 keys, in order (the step is semantics: m moves once a step):
//   s     = (q . k^T) * scale + kbias                 (fp32, __fmul_rn, __fadd_rn)
//   m_new = max(m, max_j s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l     = l * alpha + sum_j p
//   pv    = (p -> T) . v                               (its own fp32 sum)
//   acc   = acc * alpha + pv
// out = (acc / l) -> T. Keys past Lk get s = -inf (TMA fills their K and V
// rows with zeros), query rows past Lq read zeros and are never stored, a
// row whose keys are all masked (kbias -1e9) comes out as a finite average.
//
// Operands. q/k/v are [B, H, L, hd] views read in place through 4D tensor
// maps (csrc/onepass_wgmma.cuh wg_tensor_map: 32-column slabs in the 64-byte
// swizzle, one TMA box each; ops/wavlm_attention.py tma_view decides before
// any launch that the strides allow one). A head dim below its instance is
// zero-filled by TMA up to it (8-32 at 32, 40-64 at 64, 72-96 at 96, 104-128
// at 128, 136-192 at 192, 200-256 at 256) and no column past hd is stored.
// Every block is two consumer warpgroups and one producer warp (288 threads,
// one block an SM: nine warps cap a thread at 168 registers). The producer
// loads Q once, then each step's K tile (128 keys, with the step's 128 key
// biases by cp.async beside it) and V tile by TMA into a ring of NS stages,
// K and V on barriers of their own, so that K(it + 1) lands while step it's
// softmax and PV run and V(it + 1) while QK^T(it + 1) runs; the consumers
// release each tile once their products have read it.
//
// Two forms, by ROWS (query rows of a block):
//   - ROWS 128, HD 32, 64, 96 and 128: consumer warpgroup c owns rows 64c ..
//     64c + 63 and every key, so K and V are read once for 128 rows. Each
//     step: S = Q K^T by two wgmma.m64n64k16 chains (64 fp32 a thread), the
//     epilogue, the row maxima and sums by quad shuffles in the mma.sync
//     kernel's order (l has its bits), p rounded to T straight from S's
//     fragments into wgmma's A registers, pv = P V by wgmma (at HD 128 as two
//     64-column products, each into a fresh accumulator), then acc = acc *
//     alpha + pv. The two warpgroups take turns to issue their QK^T on two
//     named barriers (ping-pong), so that one's exps run beside the other's
//     products; registers leave no room to keep the next step's QK^T in
//     flight during the softmax (S 64, acc up to 64, pv up to 48).
//   - ROWS 64, HD 128, 192 and 256 (the O split): here O alone is HD / 2
//     fp32 a thread over 64 rows, too many beside two S halves. Both
//     warpgroups hold the same 64 rows; consumer c takes the step's keys 64c
//     .. 64c + 63 for S and O's columns c * HD / 2 on for PV. Each step: S
//     over its 64 keys (32 fp32 a thread), its rows' maxima exchanged
//     through shared memory, p rounded to T into a shared [64, 128] P tile
//     (the 64-byte swizzle that wgmma reads) and its sums exchanged, l = l *
//     alpha + (l0 + l1) in that order, then pv = P V over all 128 keys for
//     its half of the columns, with A read from shared memory (64-column
//     products at HD 256, one of 96 at 192). Twice the blocks of the
//     128-row form: the grids of the 45 s clips (B = 2) fill the card.
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 3 and
// chip_onepass_routes.py --streaming, PERF.md sections 6-7): the softmax's
// work per score (one exp, about nine fp32 operations and the conversion to
// T) and its latency, each warpgroup's QK^T, softmax and PV in turn with two
// warpgroups an SM. B=2 2249^2 8x96 takes 0.149 ms against a 0.031 ms
// operations bound (the parent mma.sync kernel 0.229, SDPA 0.263); the
// eval's B=16 2267^2 4x64 0.374 against 0.085 (0.558, 0.627); the split at
// 4x192 0.129 and 1x256 0.246 (the parent's wide tiles 0.283 and 0.581,
// SDPA 0.241 and 0.527).
#pragma once

#include "onepass_wgmma.cuh"

namespace hr {

constexpr int kStBK = 128;                           // keys a step (the TPU kernel's BK)
constexpr int kStSlabBytes = kStBK * kWgSlab * 2;    // one slab of a K or V tile

// Shared memory of one block, from a 1024-byte boundary: Q (ROWS / 64 tiles
// of 64 rows); the O split's P tile [64, 128] (four 32-key slabs) and its
// exchanged row maxima and sums; a ring of NS stages, each a K tile with the
// step's key biases and a V tile; the barriers.
template <int HD, int ROWS>
struct StLayout {
  static constexpr int SLABS = HD / kWgSlab;
  static constexpr int QT = SLABS * kWgSlabBytes;    // 64 rows of Q
  static constexpr int TILE = SLABS * kStSlabBytes;  // 128 keys of K or V
  static constexpr int KSTAGE = TILE + 1024;         // + 128 fp32 key biases
  static constexpr int STAGE = KSTAGE + TILE;
  static constexpr int P_OFF = ROWS / kTcRows * QT;
  static constexpr int PT = ROWS == kTcRows ? 4 * kWgSlabBytes : 0;
  static constexpr int XS = ROWS == kTcRows ? 2 * kWgConsumers * kTcRows * 4 : 0;
  static constexpr int RING_OFF = P_OFF + PT;
  static constexpr int FIXED = RING_OFF + XS + 2048;
  static constexpr int NS = (232448 - FIXED) / STAGE < 4 ? (232448 - FIXED) / STAGE : 4;
  static constexpr int X_OFF = RING_OFF + NS * STAGE;  // m[2][64], l[2][64]
  static constexpr int BAR_OFF = X_OFF + XS;
  static constexpr int NBAR = 1 + 4 * NS;            // Q; K and V full, K and V empty
  static constexpr int SMEM = BAR_OFF + NBAR * 8 + 1024;  // + the alignment
  static_assert(NS >= 1 && SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * kWgConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * kWgConsumers) : "memory");
}

#define HS_W4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HS_W16(d) HS_W4(d, 0), HS_W4(d, 4), HS_W4(d, 8), HS_W4(d, 12)
#define HS_W32(d) HS_W16(d), HS_W4(d, 16), HS_W4(d, 20), HS_W4(d, 24), HS_W4(d, 28)
#define HS_W48(d) HS_W32(d), HS_W4(d, 32), HS_W4(d, 36), HS_W4(d, 40), HS_W4(d, 44)
#define HS_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HS_R32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HS_R48                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "     \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
#define HS_WG(N, TY) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "

// o += P . V over 16 keys at 32 output columns (HD 32): P's A fragment in
// registers, V MN-major in shared memory.
#define HS_PV32(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" HS_WG(32, TY) HS_R16 \
               ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                   \
               : HS_W16(o)                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&o)[16], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsHalf<T>) HS_PV32("f16");
  else HS_PV32("bf16");
}
// o += P . V over 16 keys with P (K-major) read from shared memory too: 64 or
// 96 output columns.
#define HS_PVS64(TY)                                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" HS_WG(64, TY) HS_R32     \
               ", %32, %33, p, 1, 1, 0, 1;\n}\n"                                     \
               : HS_W32(o)                                                           \
               : "l"(da), "l"(db), "r"(1))
#define HS_PVS96(TY)                                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n" HS_WG(96, TY) HS_R48     \
               ", %48, %49, p, 1, 1, 0, 1;\n}\n"                                     \
               : HS_W48(o)                                                           \
               : "l"(da), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_pv_ss(float (&o)[32], uint64_t da, uint64_t db) {
  if constexpr (kIsHalf<T>) HS_PVS64("f16");
  else HS_PVS64("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_pv_ss(float (&o)[48], uint64_t da, uint64_t db) {
  if constexpr (kIsHalf<T>) HS_PVS96("f16");
  else HS_PVS96("bf16");
}
#undef HS_PV32
#undef HS_PVS64
#undef HS_PVS96
#undef HS_WG
#undef HS_W4
#undef HS_W16
#undef HS_W32
#undef HS_W48
#undef HS_R16
#undef HS_R32
#undef HS_R48

// acc = acc * alpha + pv over n fp32 of the accumulator layout (element i
// of a thread is row (i >> 1) & 1 of its two), the TPU kernel's order.
template <int N>
__device__ __forceinline__ void rescale_add(float* acc, const float (&pv)[N],
                                            const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha[(i >> 1) & 1]), pv[i]);
}

// The streaming core: ROWS 128 at HD 32, 64, 96 and 128; ROWS 64 (the O
// split) at HD 128, 192 and 256. q/k/v of T (bf16 or fp16), a.kbias fp32
// [B, Lk], the scale multiplying the product, a.hd <= HD.
template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kWgThreads, 1)
    streaming_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const OnepassArgsT<T> a) {
  constexpr bool SPLIT = ROWS == kTcRows;
  static_assert(SPLIT ? HD >= 128 : HD <= 128, "the instances");
  using Ly = StLayout<HD, ROWS>;
  constexpr int NS = Ly::NS, SLABS = Ly::SLABS;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: slabs start on 1024 bytes
  uint8_t* const sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(sm), bar0 = s0 + Ly::BAR_OFF;
  const uint32_t qfull = bar0;
  auto kfull = [&](int st) { return bar0 + 8 * (1 + st); };
  auto vfull = [&](int st) { return bar0 + 8 * (1 + NS + st); };
  auto kempty = [&](int st) { return bar0 + 8 * (1 + 2 * NS + st); };
  auto vempty = [&](int st) { return bar0 + 8 * (1 + 3 * NS + st); };
  auto kstage = [&](int st) { return Ly::RING_OFF + st * Ly::STAGE; };  // offsets
  auto vstage = [&](int st) { return Ly::RING_OFF + st * Ly::STAGE + Ly::KSTAGE; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk, nt = (Lk + kStBK - 1) / kStBK;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(kfull(st), 1 + 32);  // lane 0's expect_tx, every lane's key-bias copies
      mbar_init(vfull(st), 1);
      mbar_init(kempty(st), 4 * kWgConsumers);  // every consumer warp
      mbar_init(vempty(st), 4 * kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup's index, broadcast so that the compiler knows it uniform
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (wgi == kWgConsumers) {  // the producer warp
    if (lane == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_expect_tx(qfull, ROWS / kTcRows * Ly::QT);
      for (int r = 0; r < ROWS / kTcRows; ++r)
        for (int s = 0; s < SLABS; ++s)
          tma_load4(s0 + r * Ly::QT + s * kWgSlabBytes, &qmap, s * kWgSlab, i0 + r * kTcRows, h,
                    b, qfull);
    }
    const float* const kbg = a.kbias + (size_t)b * Lk;
    for (int it = 0; it < nt; ++it) {
      const int st = it % NS, j0 = it * kStBK;
      const uint32_t ph = ((it / NS) & 1) ^ 1;
      mbar_wait(kempty(st), ph);
      if (lane == 0) {
        mbar_expect_tx(kfull(st), Ly::TILE);
        for (int s = 0; s < SLABS; ++s)
          tma_load4(s0 + kstage(st) + s * kStSlabBytes, &kmap, s * kWgSlab, j0, h, b, kfull(st));
      }
      float* const bs = reinterpret_cast<float*>(sm + kstage(st) + Ly::TILE);
      for (int idx = lane; idx < kStBK; idx += 32) {  // zeros past Lk
        const bool ok = j0 + idx < Lk;
        cp_async4(bs + idx, kbg + (ok ? j0 + idx : 0), ok ? 4 : 0);
      }
      mbar_arrive_cp_async(kfull(st));
      mbar_wait(vempty(st), ph);
      if (lane == 0) {
        mbar_expect_tx(vfull(st), Ly::TILE);
        for (int s = 0; s < SLABS; ++s)
          tma_load4(s0 + vstage(st) + s * kStSlabBytes, &vmap, s * kWgSlab, j0, h, b, vfull(st));
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- the consumers ----
  const int c = wgi, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // this lane's rows r0 and r0 + 8 of the block
  const int r0 = (SPLIT ? 0 : c * kTcRows) + w * 16 + g;
  const int ra = i0 + r0;
  const uint32_t qs = s0 + (SPLIT ? 0 : c * Ly::QT);
  const float gt[2] = {0.f, 0.f};  // no gate
  auto no_pos = [](int, int) { return 0.f; };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  constexpr int NACC = SPLIT ? HD / 4 : HD / 2;  // this thread's share of O
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  mbar_wait(qfull, 0);

  if constexpr (!SPLIT) {
    // ping-pong: consumer c issues its QK^T between bar.sync 2 + c and its
    // bar.arrive on the other's barrier; consumer 1 opens consumer 0's first
    // turn and skips its last arrive, so every phase of each barrier is
    // completed
    if (c == 1) named_arrive(2);
    for (int it = 0; it < nt; ++it) {
      const int st = it % NS, j0 = it * kStBK;
      const uint32_t ph = (it / NS) & 1;
      const uint32_t ks = s0 + kstage(st);
      float S[2][32];
      mbar_wait(kfull(st), ph);
      named_sync(2 + c);
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int k16 = 0; k16 < HD / 16; ++k16) {
          const uint32_t off = (k16 >> 1) * kWgSlabBytes + (k16 & 1) * 32;
          wgmma_qk<T>(S[hh], wg_desc(qs + off, 0),
                      wg_desc(ks + (k16 >> 1) * kStSlabBytes + hh * kWgSlabBytes + (k16 & 1) * 32,
                              0),
                      k16 > 0);
        }
      wgmma_commit();
      if (c == 0 || it + 1 < nt) named_arrive(2 + (c ^ 1));
      wgmma_wait<0>();
      const float* const kb = reinterpret_cast<const float*>(sm + kstage(st) + Ly::TILE);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        score_epilogue<64, true, false>(S[hh], kb + 64 * hh, j0 + 64 * hh, Lk, a.scale, gt,
                                        no_pos, t);
      release(kempty(st));  // K and its key biases are read

      // the running max, the exps and the rescaled running sum, as the
      // mma.sync kernel takes them (keys in order, pairs first)
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = neg_inf();
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mx = fmaxf(mx, fmaxf(S[hh][4 * n + 2 * rr], S[hh][4 * n + 2 * rr + 1]));
        const float mc = fmaxf(quad_max(mx), m[rr]);
        float ps = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            S[hh][4 * n + 2 * rr] = expf(__fadd_rn(S[hh][4 * n + 2 * rr], -mc));
            S[hh][4 * n + 2 * rr + 1] = expf(__fadd_rn(S[hh][4 * n + 2 * rr + 1], -mc));
            ps += S[hh][4 * n + 2 * rr] + S[hh][4 * n + 2 * rr + 1];
          }
        alpha[rr] = expf(__fadd_rn(m[rr], -mc));  // exp(-inf) = 0 at the first step
        l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), quad_sum(ps));
        m[rr] = mc;
      }
      // p rounded to T into wgmma's A fragments: 16 keys a fragment
      uint32_t pa[kStBK / 16][4];
#pragma unroll
      for (int k16 = 0; k16 < kStBK / 16; ++k16)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 2 * (k16 & 3) + j;  // the n-tile in its half of S
          pa[k16][2 * j] = pack2<T>(S[k16 >> 2][4 * n], S[k16 >> 2][4 * n + 1]);
          pa[k16][2 * j + 1] = pack2<T>(S[k16 >> 2][4 * n + 2], S[k16 >> 2][4 * n + 3]);
        }
      const uint32_t vs = s0 + vstage(st);
      mbar_wait(vfull(st), ph);
      // pv = P V in products of at most 96 columns, each into a fresh sum
      constexpr int CW = HD > 96 ? 64 : HD;
#pragma unroll
      for (int c0 = 0; c0 < HD / CW; ++c0) {
        float pv[CW / 2];
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) pv[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < kStBK / 16; ++k16)
          wgmma_pv<T>(pv, pa[k16],
                      wg_desc(vs + c0 * (CW / kWgSlab) * kStSlabBytes + k16 * 16 * 64,
                              kStSlabBytes));
        wgmma_commit();
        wgmma_wait<0>();
        rescale_add(acc + c0 * (CW / 2), pv, alpha);
      }
      release(vempty(st));
    }
  } else {
    // the O split: the exchanged row maxima and sums of both consumers, and
    // the step's P tile. Each is read by the other consumer before it
    // passes the next exchange, so one copy of each serves every step.
    float* const xm = reinterpret_cast<float*>(sm + Ly::X_OFF);  // [2][64]
    float* const xl = xm + kWgConsumers * kTcRows;                // [2][64]
    uint8_t* const pt = sm + Ly::P_OFF;
    const uint32_t ps_addr = s0 + Ly::P_OFF;
    for (int it = 0; it < nt; ++it) {
      const int st = it % NS, j0 = it * kStBK;
      const uint32_t ph = (it / NS) & 1;
      const uint32_t ks = s0 + kstage(st);
      float S[32];
      mbar_wait(kfull(st), ph);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < HD / 16; ++k16)
        wgmma_qk<T>(S, wg_desc(qs + (k16 >> 1) * kWgSlabBytes + (k16 & 1) * 32, 0),
                    wg_desc(ks + (k16 >> 1) * kStSlabBytes + c * kWgSlabBytes + (k16 & 1) * 32, 0),
                    k16 > 0);
      wgmma_commit();
      wgmma_wait<0>();
      const float* const kb = reinterpret_cast<const float*>(sm + kstage(st) + Ly::TILE);
      score_epilogue<64, true, false>(S, kb + 64 * c, j0 + 64 * c, Lk, a.scale, gt, no_pos, t);
      release(kempty(st));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = neg_inf();
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(S[4 * n + 2 * rr], S[4 * n + 2 * rr + 1]));
        mx = quad_max(mx);
        if (t == 0) xm[c * kTcRows + r0 + 8 * rr] = mx;
      }
      consumers_sync();
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
        const float mc = fmaxf(fmaxf(xm[r], xm[kTcRows + r]), m[rr]);
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          S[4 * n + 2 * rr] = expf(__fadd_rn(S[4 * n + 2 * rr], -mc));
          S[4 * n + 2 * rr + 1] = expf(__fadd_rn(S[4 * n + 2 * rr + 1], -mc));
          ps += S[4 * n + 2 * rr] + S[4 * n + 2 * rr + 1];
        }
        ps = quad_sum(ps);
        if (t == 0) xl[c * kTcRows + r] = ps;
        alpha[rr] = expf(__fadd_rn(m[rr], -mc));
        m[rr] = mc;
      }
      // p rounded to T into the P tile: key 64c + 8n + 2t of row r is slab
      // 2c + n / 4, 16-byte chunk n % 4 of the row's 64 bytes, swizzled by
      // the row's bits 1-2 as the 64-byte swizzle places it
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = r0 + 8 * rr;
          const int chunk = (n & 3) ^ ((r >> 1) & 3);
          *reinterpret_cast<uint32_t*>(pt + (2 * c + (n >> 2)) * kWgSlabBytes + r * 64 +
                                       chunk * 16 + 4 * t) =
              pack2<T>(S[4 * n + 2 * rr], S[4 * n + 2 * rr + 1]);
        }
      fence_proxy_async();
      consumers_sync();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
        l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), __fadd_rn(xl[r], xl[kTcRows + r]));
      }
      const uint32_t vs = s0 + vstage(st) + c * (SLABS / 2) * kStSlabBytes;
      mbar_wait(vfull(st), ph);
      // this consumer's HD / 2 columns: one product of 96 (HD 192) or 64-column ones
      constexpr int CW = HD == 192 ? 96 : 64;
#pragma unroll
      for (int c0 = 0; c0 < HD / 2 / CW; ++c0) {
        float pv[CW / 2];
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) pv[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < kStBK / 16; ++k16)
          wgmma_pv_ss<T>(pv, wg_desc(ps_addr + (k16 >> 1) * kWgSlabBytes + (k16 & 1) * 32, 0),
                         wg_desc(vs + c0 * (CW / kWgSlab) * kStSlabBytes + k16 * 16 * 64,
                                 kStSlabBytes));
        wgmma_commit();
        wgmma_wait<0>();
        rescale_add(acc + c0 * (CW / 2), pv, alpha);
      }
      release(vempty(st));
    }
  }

  // out = acc / l, rounded to T; the split's consumer c stores its columns
  T* const out = a.out + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
  const int col0 = SPLIT ? c * (HD / 2) : 0;
#pragma unroll
  for (int n = 0; n < NACC / 4; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    if (col >= a.hd) continue;
    if (ra < Lq)
      store2(out + (size_t)ra * a.o_sl + col, __fdiv_rn(acc[4 * n], l[0]),
             __fdiv_rn(acc[4 * n + 1], l[0]));
    if (ra + 8 < Lq)
      store2(out + (size_t)(ra + 8) * a.o_sl + col, __fdiv_rn(acc[4 * n + 2], l[1]),
             __fdiv_rn(acc[4 * n + 3], l[1]));
  }
}

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

// The tile head dim of the instance of `kernel` (1: the 128-row form, 2: the
// O split) that serves head dim hd, or 0 where that kernel takes none.
inline int streaming_wgmma_instance(int hd, int kernel) {
  if (hd < 8 || hd > 256 || hd % 8) return 0;
  const int inst = tile_head_dim(hd);
  if (kernel == 1) return inst <= 128 ? inst : 0;
  return kernel == 2 && inst >= 128 ? inst : 0;
}

// The streaming core at the instance streaming_wgmma_instance names (the
// caller checks that it is not 0). Returns a CUDA error code,
// cudaErrorInvalidValue where a tensor map cannot be made.
template <typename T>
int launch_streaming_wgmma(const OnepassArgsT<T>& a, int B, int kernel, cudaStream_t s) {
  const int inst = streaming_wgmma_instance(a.hd, kernel);
  CUtensorMap qm, km, vm;
  if (!wg_maps(a, B, kStBK, &qm, &km, &vm)) return (int)cudaErrorInvalidValue;
  auto go = [&](auto HD, auto ROWS) {
    constexpr int hd_ = decltype(HD)::value, rows_ = decltype(ROWS)::value;
    const auto fn = streaming_wgmma_kernel<T, hd_, rows_>;
    constexpr int smem = StLayout<hd_, rows_>::SMEM;
    static bool attr_set = false;  // one per instantiation
    if (!attr_set) {
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      attr_set = true;
    }
    note_launch(kStreamingWgmmaKernel, hd_);
    fn<<<dim3((a.Lq + rows_ - 1) / rows_, a.H, B), kWgThreads, smem, s>>>(qm, km, vm, a);
  };
  using R128 = std::integral_constant<int, 2 * kTcRows>;
  using R64 = std::integral_constant<int, kTcRows>;
  if (kernel == 1) {
    if (inst == 32) go(std::integral_constant<int, 32>(), R128());
    else if (inst == 64) go(std::integral_constant<int, 64>(), R128());
    else if (inst == 96) go(std::integral_constant<int, 96>(), R128());
    else go(std::integral_constant<int, 128>(), R128());
  } else {
    if (inst == 128) go(std::integral_constant<int, 128>(), R64());
    else if (inst == 192) go(std::integral_constant<int, 192>(), R64());
    else go(std::integral_constant<int, 256>(), R64());
  }
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace hr
