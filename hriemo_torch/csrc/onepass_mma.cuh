// The one-pass 16-bit attention core on mma.sync, shared by the float route
// (csrc/wavlm_attention.cu: wavlm_fused_attention, onepass_attention; bf16
// or fp16; where ops/wavlm_attention.py onepass_kernel keeps "mma": head
// dims 32, 40, 128 and the others off 64, 96 and 136-256, past 2048 keys,
// and the grids where the card read it faster than csrc/onepass_wgmma.cuh's
// warpgroups, which take the rest) and the int8 sublayers' core
// (csrc/attention.cu: attention_block_int8, mha_block_int8; bf16; on their
// chain routes, past 512 keys and at head dims other than 64 and 96: from 65
// keys their fused routes mostly take csrc/onepass_wgmma.cuh):
//
//   s   = (q . k^T) * scale  [+ gate[i] * pos[h,i,j]]  + key bias[b,j]   (fp32)
//   out = ((exp(s - max s) / sum) -> T) . v                          (fp32 sums -> T)
//
// over q/k/v of type T (bf16 or fp16) read in place through their batch,
// head and row strides; pos and out are T too. fp16 keeps the bf16
// numerics, as the TPU kernels cast p / l to v's dtype whatever it is: fp32
// scores and sums, p / l rounded to fp16 before PV on the f16 form of the
// same mma.sync.
// The int8 route's q/k/v are column blocks of the projection GEMM's packed
// [B*L, 3D] (or [B*Lq, D] and [B*Lk, 2D]) output, its 1/sqrt(hd) already in
// q (scale 1, exact), and its ctx [B*Lq, D].
//
// Two kernels, by the tile head dim HD that serves hd (csrc/
// attention_tiles.cuh): onepass_mma_kernel at HD 32, 64, 96 and 128 (4
// warps, q in registers; gated at 64 and 96 only) and onepass_wide_kernel
// at HD 192 and 256 (8 warps, a pair of warps on each 16 query rows, q in
// shared memory, each warp with half the keys of a tile and half the output
// columns; ungated). Registers decide the split: at HD 256 q's A fragments
// (64 a lane) and an output slice of all 256 columns (128) leave too little
// beside the scores and p; the pair keeps 64 output registers a lane, as
// HD 128 does. Both go through the same steps in the same order.
// A block takes 64 query rows, 16 per warp or per pair, and
// walks the keys in tiles of 64 twice:
//   sweep 1: s for each tile (mma.sync QK^T, then scale, gate * pos and the
//     key bias in the TPU kernels' order, __fmul_rn/__fadd_rn), the running
//     row max m and the running sum l = l * exp(m_old - m) + sum exp(s - m);
//   sweep 2: s again, p = exp(s - m) / l (rounded to nearest: the
//     reciprocal of l and two remainder corrections, div_rn), rounded to T as
//     the TPU kernels cast p / l to v's dtype before PV, then PV on mma.sync
//     with fp32 sums.
// The contract rounds p / l, so l must be known before PV: the price of
// keeping no score panel is 1.5x the products and twice the exps. l differs
// from the panel's sum in fp32 order and rescaling only, before p / l is
// rounded. Keys past Lk get s = -inf, so exp gives exact zeros; query rows
// past Lq read zeros and are never stored; a row whose keys are all masked
// (every key bias -1e9) comes out as a finite average of v.
// Shared memory does not grow with Lk: a two-stage cp.async ring of K, V,
// the key biases and (gated) the [64, 64] pos tile: gated 55 KB at HD 64
// and 72 KB at HD 96, ungated 21 KB at HD 32 and 69 KB at HD 128, so three
// or more blocks share an SM; the wide kernel adds q and the pairs' p tiles
// to its ring, 139 KB at HD 192 and 180 KB at 256, one block an SM. pos rows are only
// 2-byte aligned at odd Lk, so each row is copied from the 16-byte boundary
// below its first key and read at its offset (e & 7) in shared memory,
// without a padded copy in device memory. Blocks run batch element
// fastest, so the blocks that read the same pos tile run together and share
// it through L2.
//
// The gate comes from a [B, H, Lq] fp32 array (float route) or is computed
// in the block's prologue from x (int8 route, bf16 or fp32 x): WavLM's
// sigmoid(sum g[0:4]) * (sigmoid(sum g[4:8]) * c_h - 1) + 2 over the shared
// [8, hd] gate Linear (wavlm_gate, which the CUDA-core kernel of
// csrc/attention.cu calls too). The key bias is an fp32 [B, Lk] additive array, or a
// bool [B, Lk] key-padding mask (True = PAD -> -1e9; none: every key valid).
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): the
// per-score work on the FMA and MUFU pipes, not the tensor cores or device
// memory: the epilogue and an accurate expf in both sweeps and a division
// in the second, about 35 instructions a score.
#pragma once

#include "attention_tiles.cuh"

namespace hr {

constexpr int kOneBK = 64;              // keys per tile
constexpr int kPosLd = kOneBK + 8;      // a realigned pos row: the tile's keys + up to 7

enum GateFrom : int { kNoGate = 0, kGateArray = 1, kGateFromX = 2 };
enum KeyMask : int { kKeysBias = 0, kKeysPad = 1 };

template <typename T>
struct OnepassArgsT {
  const T *q, *k, *v;                       // element (b, h, i, d) at b*sb + h*sh + i*sl + d
  int q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  int H, Lq, Lk;
  float scale;
  const float* kbias;                       // kKeysBias: [B, Lk] fp32 additive
  const uint8_t* kpm;                       // kKeysPad: [B, Lk] bool or NULL
  const float* gate;                        // kGateArray: [B, H, Lq] fp32
  const void* x;                            // kGateFromX: [B*Lq, x_ld], head h at column h*hd,
  int x_ld, x_f32;                          //   bf16, or fp32 when x_f32
  const float *wg, *bg, *gconst;            // [8, hd], [8], [H]
  const T* pos;                             // gated: [H, Lq, Lk]
  T* out;
  int o_sb, o_sh, o_sl;
  int hd;                                   // the head dim (padded instances: below HD)
};
using OnepassArgs = OnepassArgsT<__nv_bfloat16>;  // the int8 route's

// Bytes of one ring stage: K and V tiles, the key biases and, gated, the
// realigned pos tile.
__host__ __device__ constexpr int mma_stage_bytes(int hd, bool gated) {
  return 2 * kOneBK * (hd + 8) * 2 + kOneBK * 4 + (gated ? kTcRows * kPosLd * 2 : 0);
}

// WavLM's gate of one query row from its head's hd columns of x (xr), every
// lane of the warp taking part: the [8, hd] Linear by lane-strided fp32
// sums and a warp reduction, then the two sigmoids, each step rounded. x is
// read as bf16 (an fp32 x rounded to it), as the TPU kernel's
// x.astype(wg.dtype) with bf16 gate weights. Every lane returns the gate.
// Shared with the CUDA-core kernel of csrc/attention.cu.
template <typename T>
__device__ __forceinline__ float wavlm_gate(const T* xr, const float* wg, const float* bg,
                                            float c_h, int hd, int lane) {
  float gp[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) gp[c] = 0.f;
  for (int d = lane; d < hd; d += 32) {
    const float xv = round_as<__nv_bfloat16>(load_f(xr + d));
#pragma unroll
    for (int c = 0; c < 8; ++c) gp[c] += xv * wg[c * hd + d];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) gp[c] = __fadd_rn(warp_sum(gp[c]), bg[c]);
  const float ga = sigmoid(__fadd_rn(__fadd_rn(__fadd_rn(gp[0], gp[1]), gp[2]), gp[3]));
  const float gb = sigmoid(__fadd_rn(__fadd_rn(__fadd_rn(gp[4], gp[5]), gp[6]), gp[7]));
  return __fadd_rn(__fmul_rn(ga, __fadd_rn(__fmul_rn(gb, c_h), -1.0f)), 2.0f);
}

// PAD: the head dim a.hd is below HD (csrc/attention_tiles.cuh); without it
// the head dim is HD.
template <typename T, int HD, int GATE, int KEYS, bool PAD>
__global__ void __launch_bounds__(kTcThreads) onepass_mma_kernel(const OnepassArgsT<T> a) {
  constexpr int NT = kOneBK / 8;  // n-tiles of a score tile
  const int hd = PAD ? a.hd : HD;
  constexpr bool kGated = GATE != kNoGate;
  constexpr int kStage = mma_stage_bytes(HD, kGated);
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, i0 = blockIdx.y * kTcRows, h = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk;
  const int row0 = i0 + warp * 16;  // this warp's first query row
  const T* qh = a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh;
  const T* kh = a.k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const T* vh = a.v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;
  const size_t krow0 = (size_t)b * Lk;  // this element's key 0 in kbias / kpm
  // pos element (i0, 0) of this head; the tensor's length bounds every copy
  const size_t pos_i0 = ((size_t)h * Lq + i0) * Lk, pos_len = (size_t)a.H * Lq * Lk;
  const int nq = min(kTcRows, Lq - i0);

  auto Ks = [&](int st) { return reinterpret_cast<T*>(ring + st * kStage); };
  auto Vs = [&](int st) { return Ks(st) + kOneBK * (HD + 8); };
  auto Bs = [&](int st) { return reinterpret_cast<float*>(Vs(st) + kOneBK * (HD + 8)); };
  auto Ps = [&](int st) { return reinterpret_cast<T*>(Bs(st) + kOneBK); };

  const int ntiles = (Lk + kOneBK - 1) / kOneBK, steps = 2 * ntiles;
  // step it: tile it % ntiles of sweep it / ntiles (V only in sweep 2)
  auto issue = [&](int it) {
    const int st = it & 1, j0 = (it % ntiles) * kOneBK;
    load_rows<HD, kOneBK, PAD>(Ks(st), kh, a.k_sl, j0, Lk, hd, tid);
    if (it >= ntiles) load_rows<HD, kOneBK, PAD>(Vs(st), vh, a.v_sl, j0, Lk, hd, tid);
    if (KEYS == kKeysBias) load_bias<kOneBK>(Bs(st), a.kbias + krow0, j0, Lk, tid);
    if (kGated) {
      // row r from the 16-byte boundary at or below its key j0
      constexpr int kChunks = kPosLd / 8;
      for (int idx = tid; idx < kTcRows * kChunks; idx += kTcThreads) {
        const int r = idx / kChunks, c = idx - r * kChunks;
        const size_t ad = ((pos_i0 + (size_t)r * Lk + j0) & ~(size_t)7) + 8 * c;
        const size_t left = r < nq && ad < pos_len ? 2 * (pos_len - ad) : 0;  // bytes
        const int bytes = left < 16 ? (int)left : 16;
        cp_async16(Ps(st) + r * kPosLd + 8 * c, a.pos + (bytes ? ad : 0), bytes);
      }
    }
    cp_async_commit();
    if (KEYS == kKeysPad) {
      // bytes at any alignment: plain loads; the stage is free (see the loop)
      for (int idx = tid; idx < kOneBK; idx += kTcThreads) {
        const int j = j0 + idx;
        Bs(st)[idx] = j < Lk && a.kpm != nullptr && a.kpm[krow0 + j] ? kNegInf : 0.f;
      }
    }
  };
  issue(0);

  uint32_t qf[HD / 16][4];
  load_q<HD>(qf, qh, a.q_sl, row0, Lq, hd, lane);
  // this lane's rows g and g + 8: gate, and the column of key 0 in its
  // realigned pos row
  float gt[2] = {0.f, 0.f};
  int psh[2] = {0, 0};
  if (GATE == kGateArray) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = row0 + g + 8 * rr;
      if (i < Lq) gt[rr] = a.gate[((size_t)b * a.H + h) * Lq + i];
    }
  }
  if (GATE == kGateFromX) {
#pragma unroll 1
    for (int r = 0; r < 16 && row0 + r < Lq; ++r) {  // warp-uniform
      const size_t xo = ((size_t)b * Lq + row0 + r) * a.x_ld + h * hd;
      const float gr = a.x_f32 ? wavlm_gate(static_cast<const float*>(a.x) + xo, a.wg, a.bg,
                                            a.gconst[h], hd, lane)
                               : wavlm_gate(static_cast<const __nv_bfloat16*>(a.x) + xo, a.wg,
                                            a.bg, a.gconst[h], hd, lane);
      if (r == g) gt[0] = gr;
      if (r == g + 8) gt[1] = gr;
    }
  }
  if (kGated) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      psh[rr] = (int)((pos_i0 + (size_t)(warp * 16 + g + 8 * rr) * Lk) & 7);
  }
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f}, rl[2];  // rl = 1 / l
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait_all();
    __syncthreads();  // step it's tiles are in; step it - 1 is done with the other stage
    if (it + 1 < steps) issue(it + 1);
    const int st = it & 1, j0 = (it % ntiles) * kOneBK;
    const float* bs = Bs(st);
    const T* ps = Ps(st) + (warp * 16 + g) * kPosLd;

    float s[NT][4];
    qk_tile<HD, NT>(s, qf, Ks(st), lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 kb2 = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        float x = __fmul_rn(s[n][e], a.scale);
        if (kGated)
          x = __fadd_rn(x, __fmul_rn(gt[rr], load_f(ps + rr * 8 * kPosLd + psh[rr] + c + (e & 1))));
        s[n][e] = __fadd_rn(x, (e & 1) ? kb2.y : kb2.x);
      }
    }
    if (j0 + kOneBK > Lk) mask_keys<NT>(s, Lk - j0, lane);

    if (it < ntiles) {  // sweep 1: running max and rescaled running sum
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = neg_inf();
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
        const float mn = fmaxf(m[rr], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          sum += expf(__fadd_rn(s[n][2 * rr], -mn)) + expf(__fadd_rn(s[n][2 * rr + 1], -mn));
        l[rr] = __fadd_rn(__fmul_rn(l[rr], expf(__fadd_rn(m[rr], -mn))), quad_sum(sum));
        m[rr] = mn;
      }
    } else {  // sweep 2: p / l rounded to T, then PV
      if (it == ntiles) rl[0] = __frcp_rn(l[0]), rl[1] = __frcp_rn(l[1]);
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = div_rn(expf(__fadd_rn(s[n][e], -m[e >> 1])), l[e >> 1], rl[e >> 1]);
        pa[n >> 1][2 * (n & 1)] = pack2<T>(p[0], p[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack2<T>(p[2], p[3]);
      }
      pv_tile<HD, NT>(o, pa, Vs(st), lane);
    }
  }
  store_rows<HD>(a.out + (size_t)b * a.o_sb + (size_t)h * a.o_sh, a.o_sl, row0, Lq, hd, o,
                 lane);
}

// The wide tiles (HD 192, 256; csrc/attention_tiles.cuh), ungated: the same
// two sweeps, scores, masks and roundings as onepass_mma_kernel, with a pair
// of warps on each 16 query rows. Warp `half` of a pair takes keys
// half * 32 .. half * 32 + 31 of each 64-key tile for QK^T and the softmax,
// and output columns half * HD/2 .. for PV over all 64 keys. In sweep 1
// each warp keeps the running max and sum of its own keys; at the start of
// sweep 2 the pair merges them through shared memory, in the same order in
// both warps (half 0's first), so both hold the same m and l:
//   m = max(m0, m1),  l = l0 * exp(m0 - m) + l1 * exp(m1 - m)
// (l differs from the narrow kernel's in fp32 order and rescaling only,
// before p / l is rounded). In sweep 2 each warp forms p / l of its keys,
// rounded to T, into the pair's [16, 64] p tile in shared memory, and after
// the pair's barrier reads the whole tile back as PV's A fragments. The
// block barrier of the ring, at the top of each step, keeps the p tile from
// being overwritten while the other warp still reads it.
// Shared memory (wide_onepass_smem_bytes): the two-stage ring of K, V and
// the key biases (2 x 51.5 KB at HD 192, 2 x 67.8 KB at 256), q (25.6 KB,
// 33.8 KB), the four pairs' p tiles (9.2 KB) and the merge's m and l (1
// KB): 138.8 KB at HD 192 and 179.7 KB at 256, one block of 8 warps an SM;
// ptxas gives 124 registers at HD 192 and 148 at 256, no spill. What bounds
// it (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): as the narrow kernel,
// the per-score softmax work, here with one block an SM to hide it and a
// second wave of blocks at small grids: B=2 1499^2 4x192 takes 0.218 ms
// against a 0.014 ms bound (the bf16 operations) and SDPA's 0.091; B=16
// 1951^2 1x256 0.649 against 0.063 and 0.332. The CUDA-core kernel took
// 1.013 and 4.150.
__host__ __device__ constexpr int wide_onepass_smem_bytes(int hd) {
  return 2 * mma_stage_bytes(hd, false) + kTcRows * (hd + 8) * 2 +
         kTcWarps * 16 * (kOneBK + 8) * 2 + kWideWarps * 2 * 16 * 4;
}

template <typename T, int HD, int KEYS, bool PAD>
__global__ void __launch_bounds__(kWideThreads, 1) onepass_wide_kernel(const OnepassArgsT<T> a) {
  constexpr int kHalf = kOneBK / 2;     // keys of a tile per warp
  constexpr int NT = kHalf / 8;         // n-tiles of a warp's scores
  constexpr int kCols = HD / 2;         // output columns per warp
  constexpr int kPLd = kOneBK + 8;      // a shared p row
  constexpr int kStage = mma_stage_bytes(HD, false);
  const int hd = PAD ? a.hd : HD;
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pr = warp >> 1, half = warp & 1;  // pair (16 query rows), half (keys, columns)
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, i0 = blockIdx.y * kTcRows, h = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk;
  const T* qh = a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh;
  const T* kh = a.k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const T* vh = a.v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;
  const size_t krow0 = (size_t)b * Lk;  // this element's key 0 in kbias / kpm

  auto Ks = [&](int st) { return reinterpret_cast<T*>(ring + st * kStage); };
  auto Vs = [&](int st) { return Ks(st) + kOneBK * (HD + 8); };
  auto Bs = [&](int st) { return reinterpret_cast<float*>(Vs(st) + kOneBK * (HD + 8)); };
  T* const qs = reinterpret_cast<T*>(ring + 2 * kStage);        // [64][HD + 8]
  T* const ps = qs + kTcRows * (HD + 8) + pr * 16 * kPLd;       // this pair's [16][kPLd]
  float* const ml = reinterpret_cast<float*>(qs + kTcRows * (HD + 8) + kTcWarps * 16 * kPLd);

  const int ntiles = (Lk + kOneBK - 1) / kOneBK, steps = 2 * ntiles;
  // step it: tile it % ntiles of sweep it / ntiles (V only in sweep 2)
  auto issue = [&](int it) {
    const int st = it & 1, j0 = (it % ntiles) * kOneBK;
    load_rows<HD, kOneBK, PAD, kWideThreads>(Ks(st), kh, a.k_sl, j0, Lk, hd, tid);
    if (it >= ntiles) load_rows<HD, kOneBK, PAD, kWideThreads>(Vs(st), vh, a.v_sl, j0, Lk, hd, tid);
    if (KEYS == kKeysBias) load_bias<kOneBK, kWideThreads>(Bs(st), a.kbias + krow0, j0, Lk, tid);
    cp_async_commit();
    if (KEYS == kKeysPad) {
      // bytes at any alignment: plain loads; the stage is free (see the loop)
      for (int idx = tid; idx < kOneBK; idx += kWideThreads) {
        const int j = j0 + idx;
        Bs(st)[idx] = j < Lk && a.kpm != nullptr && a.kpm[krow0 + j] ? kNegInf : 0.f;
      }
    }
  };
  // q's rows (zeros past Lq and, PAD, past hd) in the same group as tile 0
  load_rows<HD, kTcRows, PAD, kWideThreads>(qs, qh, a.q_sl, i0, Lq, hd, tid);
  issue(0);

  const T* qw = qs + pr * 16 * (HD + 8);
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f}, rl[2];  // rl = 1 / l
  float o[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait_all();
    __syncthreads();  // step it's tiles are in; step it - 1 is done with the other stage
    if (it + 1 < steps) issue(it + 1);
    const int st = it & 1, jw = (it % ntiles) * kOneBK + half * kHalf;  // this warp's key 0
    const float* bs = Bs(st) + half * kHalf;

    float s[NT][4];
    qk_tile_smem<HD, NT>(s, qw, Ks(st) + half * kHalf * (HD + 8), lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 kb2 = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fadd_rn(__fmul_rn(s[n][e], a.scale), (e & 1) ? kb2.y : kb2.x);
    }
    if (jw + kHalf > Lk) mask_keys<NT>(s, Lk - jw, lane);  // all of them when jw >= Lk

    if (it < ntiles) {  // sweep 1: running max and rescaled running sum of this warp's keys
      if (jw < Lk) {    // warp-uniform; a warp with no key yet keeps m = -inf, l = 0
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = neg_inf();
#pragma unroll
          for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
          const float mn = fmaxf(m[rr], quad_max(mx));
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            sum += expf(__fadd_rn(s[n][2 * rr], -mn)) + expf(__fadd_rn(s[n][2 * rr + 1], -mn));
          l[rr] = __fadd_rn(__fmul_rn(l[rr], expf(__fadd_rn(m[rr], -mn))), quad_sum(sum));
          m[rr] = mn;
        }
      }
    } else {  // sweep 2: p / l rounded to T into the pair's p tile, then PV
      if (it == ntiles) {  // merge the pair's m and l; half 0 holds key 0, so m0 is finite
        if (t == 0) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            ml[(warp * 2 + 0) * 16 + g + 8 * rr] = m[rr];
            ml[(warp * 2 + 1) * 16 + g + 8 * rr] = l[rr];
          }
        }
        pair_sync(pr);
        const float* m0 = ml + (pr * 2 + 0) * 32;  // half 0's m, then its l
        const float* m1 = ml + (pr * 2 + 1) * 32;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = g + 8 * rr;
          const float mn = fmaxf(m0[r], m1[r]);
          l[rr] = __fadd_rn(__fmul_rn(m0[16 + r], expf(__fadd_rn(m0[r], -mn))),
                            __fmul_rn(m1[16 + r], expf(__fadd_rn(m1[r], -mn))));
          m[rr] = mn;
          rl[rr] = __frcp_rn(l[rr]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = div_rn(expf(__fadd_rn(s[n][e], -m[e >> 1])), l[e >> 1], rl[e >> 1]);
      store_p<NT>(ps + half * kHalf, kPLd, s, lane);
      pair_sync(pr);
      uint32_t pa[kOneBK / 16][4];
      load_pa<kOneBK / 16>(pa, ps, kPLd, lane);
      pv_tile<HD, kOneBK / 8, T, kCols>(o, pa, Vs(st) + half * kCols, lane);
    }
  }
  store_rows<kCols>(a.out + (size_t)b * a.o_sb + (size_t)h * a.o_sh + half * kCols, a.o_sl,
                    i0 + pr * 16, Lq, hd - half * kCols, o, lane);
}

// The launch helpers keep a per-library flag for the shared-memory opt-in:
// internal linkage, or the flag of a template instantiated in two libraries
// (csrc/attention.cu, csrc/wavlm_attention.cu) would be one process-wide symbol
// and the second library's kernel would never opt in.
namespace {

template <int HD, int GATE, int KEYS, bool PAD = false, typename T>
void launch_onepass_mma(const OnepassArgsT<T>& a, int B, cudaStream_t stream) {
  // batch element fastest: the blocks that read one pos tile run together
  dim3 grid(B, (a.Lq + kTcRows - 1) / kTcRows, a.H);
  static bool attr_set = false;  // one per instantiation
  if constexpr (HD > 128) {
    static_assert(GATE == kNoGate, "the wide tiles have no gated instance");
    constexpr int smem = wide_onepass_smem_bytes(HD);
    if (!attr_set) {
      cudaFuncSetAttribute(onepass_wide_kernel<T, HD, KEYS, PAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      attr_set = true;
    }
    note_launch(kOnepassWideKernel, HD);
    onepass_wide_kernel<T, HD, KEYS, PAD><<<grid, kWideThreads, smem, stream>>>(a);
  } else {
    constexpr int smem = 2 * mma_stage_bytes(HD, GATE != kNoGate);
    if (!attr_set) {
      cudaFuncSetAttribute(onepass_mma_kernel<T, HD, GATE, KEYS, PAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      attr_set = true;
    }
    note_launch(kOnepassMmaKernel, HD);
    onepass_mma_kernel<T, HD, GATE, KEYS, PAD><<<grid, kTcThreads, smem, stream>>>(a);
  }
}

// Shared memory of the tile instance HD (gated: 64 or 96 only).
inline int onepass_tile_smem_bytes(int HD, bool gated) {
  return HD > 128 ? wide_onepass_smem_bytes(HD) : 2 * mma_stage_bytes(HD, gated);
}

// The gated launch for head dim hd (64 or 96, the caller checks) and the
// key-mask kind chosen at run time. A template, so that only the library
// that calls it (csrc/attention.cu) builds its instances.
template <int GATE>
void launch_onepass_mma_keys(const OnepassArgs& a, int B, int hd, int keys, cudaStream_t s) {
  if (hd == 64 && keys == kKeysBias) launch_onepass_mma<64, GATE, kKeysBias>(a, B, s);
  else if (hd == 64) launch_onepass_mma<64, GATE, kKeysPad>(a, B, s);
  else if (keys == kKeysBias) launch_onepass_mma<96, GATE, kKeysBias>(a, B, s);
  else launch_onepass_mma<96, GATE, kKeysPad>(a, B, s);
}

// The ungated launch at the tile instance that serves head dim a.hd (<=
// 256), key-mask kind KEYS.
template <int KEYS, typename T>
void launch_onepass_tile(const OnepassArgsT<T>& a, int B, cudaStream_t s) {
  with_tile(a.hd, [&](auto HD, auto PAD) {
    launch_onepass_mma<decltype(HD)::value, kNoGate, KEYS, decltype(PAD)::value>(a, B, s);
  });
}

}  // namespace

}  // namespace hr
