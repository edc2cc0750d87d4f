// Streaming (online-softmax) attention of the port's long-clip route
// (hriemo_torch/ops/flash_attention.py::streaming_attention):
//
//   for each block of kBK = 128 keys, in order:
//     s     = (q . k^T) * scale + kbias                        (fp32)
//     m_new = max(m, max_j s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//     l     = l * alpha + sum_j p
//     acc   = acc * alpha + (p -> T) . v                      (fp32 sums)
//   out = (acc / l) -> T
//
// over q/k/v of type T (bf16, fp16 or fp32) read in place through their
// batch, head and row strides.
//
// Replaces the Pallas kernel hriemo/ops/flash_attention_pallas.py::
// _flash_kernel, routed for Lk > 2048 (the dispatch at :274-277). The TPU
// kernel carries m, l and acc in VMEM scratch across the sequential key
// axis of its grid; here one block walks all key blocks of its query tile
// in a loop, so no state crosses blocks and Lk has no bound. The TPU kernel's numerics are
// kept apart from the one-pass kernels': the unnormalized p block is cast
// to T before PV, and the division by l happens once, at the end. Keys
// past Lk are simply absent (the TPU wrapper pads them with NEG_INF, which
// adds exact zeros unless a row's keys are all masked).
//
// Which kernel runs is decided by tile_head_dim alone (csrc/
// attention_tiles.cuh, exported as hr_streaming_instance): bf16 and fp16
// run every head dim up to 256 on the tensor cores at the tile instance HD,
// the smallest of 32, 64, 96, 128, 192 and 256 at or above hd (hd 8-32 at
// 32, 40-64 at 64, 72-96 at 96, 104-128 at 128, 136-192 at 192, 200-256 at
// 256), and so does fp32. A head dim below its instance
// runs on the instance's padded form (with_tile), zero-padded to HD inside
// the tile, never in device memory: the copies of q, K and V fill zeros
// past hd, and no column past hd is stored; the unpadded form takes hd as
// the constant HD.
//
// bf16 or fp16 up to HD 128: streaming_mma_kernel, on the tensor cores
// (csrc/attention_tiles.cuh; fp16 on the f16 form of the same mma.sync, p
// rounded to fp16 before PV). A block takes 64 query rows, 16 per warp,
// with q in registers as mma A fragments and m, l and acc in registers
// (two rows a lane); per 128-key block: s = QK^T on mma.sync, scale and key
// bias (__fmul_rn/__fadd_rn), row max and sum by quad shuffles, the
// unnormalized p rounded to T as PV's A fragments, pv = PV on mma.sync into
// its own fp32 fragment, then acc = acc * alpha + pv as the TPU kernel
// orders it; at HD 128 PV runs in two passes of 64 columns, each into its
// own fragment, so that pv, acc, q and p fit 255 registers. K, V and the key
// biases arrive through a two-stage cp.async ring (41 KB at HD 32, 73 KB at
// 64, 105 KB at 96, 137 KB at 128); the only block barrier per key block is
// the ring's. Keys past Lk get s = -inf (exact zeros after the exp) and
// zeroed K/V rows; query rows past Lq read zeros and are never stored.
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): the
// softmax's work per score on the FMA and MUFU pipes, with two or three
// blocks an SM (168 registers at HD 96, 255 at 128) to hide it. At B=2 2249^2 8x96 it takes 0.23
// ms against a 0.031 ms bound (the bf16 operations) and 0.26 ms for SDPA.
// The CUDA-core kernel that this replaces took 2.70 ms.
//
// bf16 or fp16 at HD 192 and 256: streaming_wide_kernel (below), a pair of
// warps on each 16 query rows, each owning half the output columns, q in
// shared memory, the 128-key softmax step streamed as 64-key halves
// through a four-tile ring. At HD 256 q as A fragments (64 registers a
// lane) and the output slice of all 256 columns (128) would not fit
// beside the scores, pv and p in the 255 a thread may take.
//
// fp32: attn_tf32_kernel<HD, false, true> (csrc/attention_tf32.cuh) at the
// narrow instances and attn_tf32_wide_kernel<HD, true> at HD 192 and 256 (a
// pair of warps on each 16 query rows, as streaming_wide_kernel), the same
// online softmax on mma.sync.m16n8k8 in 3xTF32:
// each fp32 operand is split into two TF32 parts and a product takes three
// mma, which keeps about 2^-20 of each product. One TF32 product (2^-11)
// does not hold the fp32 trees' 1e-4 at large scores (chip_tf32_terms.py),
// and fp32 FMAs run at a seventh of the TF32 rate. It steps every 32 keys:
// nothing is rounded to a narrower type between fp32 steps, so only fp32
// rounding moves. At B=2 2249^2 8x96 it takes about 0.66 ms against SDPA's
// 1.10 (chip_smoke.py), where the CUDA-core kernel below took 3.60.
//
// cuda_cores = 1: streaming_attn_kernel on CUDA cores in any type and at
// any head dim, the yardstick chip_smoke.py times beside each tile row; no
// path runs it otherwise. One block per (tile of kQT = 16 query rows, head,
// batch element), 4*hd threads; 8 KB of scores and 16*hd floats of queries
// in shared memory; m and l in shared memory, three block barriers per key
// block.
#include "attention_tf32.cuh"

namespace hr {

constexpr int kQT = 16;    // query rows per block
constexpr int kBK = 128;   // keys per block, as the TPU kernel's BK
constexpr int kRG = 4;     // row groups in PV: blockDim = kRG * hd

template <typename T>
__global__ void streaming_attn_kernel(const T* __restrict__ q, int q_sb, int q_sh, int q_sl,
                                      const T* __restrict__ k, int k_sb, int k_sh, int k_sl,
                                      const T* __restrict__ v, int v_sb, int v_sh, int v_sl,
                                      int Lq, int Lk, int hd, float scale,
                                      const float* __restrict__ kbias,
                                      T* __restrict__ out, int o_sb, int o_sh, int o_sl) {
  extern __shared__ float smem[];
  float* qs = smem;               // [kQT][hd]
  float* S = qs + kQT * hd;       // [kQT][kBK]
  float* ms = S + kQT * kBK;      // [kQT] running max
  float* ls = ms + kQT;           // [kQT] running sum
  float* al = ls + kQT;           // [kQT] this block's alpha
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int i0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(kQT, Lq - i0);
  const T* qh = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const T* kh = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const T* vh = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const float* kb = kbias + (size_t)b * Lk;

  for (int idx = tid; idx < kQT * hd; idx += nthr) {
    const int r = idx / hd, d = idx - r * hd;
    qs[idx] = r < nq ? load_f(qh + (size_t)(i0 + r) * q_sl + d) : 0.f;
  }
  if (tid < kQT) {
    ms[tid] = __int_as_float(0xff800000);  // -inf
    ls[tid] = 0.f;
  }

  constexpr int kRPT = kQT / kRG;  // rows per thread in PV
  const int d = tid % hd, rg = tid / hd;
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < Lk; j0 += kBK) {
    const int nk = min(kBK, Lk - j0);
    __syncthreads();  // the query tile is in; the previous block's PV is done with S

    for (int jj = tid; jj < nk; jj += nthr) {
      const T* kr = kh + (size_t)(j0 + jj) * k_sl;
      float dot[kQT];
#pragma unroll
      for (int r = 0; r < kQT; ++r) dot[r] = 0.f;
      for (int d0 = 0; d0 < hd; d0 += 8) {
        float kv[8];
        load8(kr + d0, kv);
#pragma unroll
        for (int r = 0; r < kQT; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(qs + r * hd + d0);
          const float4 c = *reinterpret_cast<const float4*>(qs + r * hd + d0 + 4);
          dot[r] += a.x * kv[0] + a.y * kv[1] + a.z * kv[2] + a.w * kv[3] + c.x * kv[4] +
                    c.y * kv[5] + c.z * kv[6] + c.w * kv[7];
        }
      }
      const float kbj = kb[j0 + jj];
#pragma unroll
      for (int r = 0; r < kQT; ++r) S[r * kBK + jj] = __fadd_rn(__fmul_rn(dot[r], scale), kbj);
    }
    __syncthreads();

    for (int r = warp; r < kQT; r += nwarps) {
      float* sr = S + r * kBK;
      float mx = __int_as_float(0xff800000);
      for (int jj = lane; jj < nk; jj += 32) mx = fmaxf(mx, sr[jj]);
      const float m_prev = ms[r];
      const float m_cur = fmaxf(warp_max(mx), m_prev);
      float psum = 0.f;
      for (int jj = lane; jj < nk; jj += 32) {
        const float p = expf(__fadd_rn(sr[jj], -m_cur));
        psum += p;
        sr[jj] = round_as<T>(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(__fadd_rn(m_prev, -m_cur));  // exp(-inf) = 0 at the first block
        ls[r] = __fadd_rn(__fmul_rn(ls[r], alpha), psum);
        ms[r] = m_cur;
        al[r] = alpha;
      }
    }
    __syncthreads();

    float pv[kRPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) pv[i] = 0.f;
    const T* vc = vh + (size_t)j0 * v_sl + d;
#pragma unroll 4
    for (int jj = 0; jj < nk; ++jj) {
      const float vv = load_f(vc + (size_t)jj * v_sl);
#pragma unroll
      for (int i = 0; i < kRPT; ++i) pv[i] += S[(rg + kRG * i) * kBK + jj] * vv;
    }
#pragma unroll
    for (int i = 0; i < kRPT; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], al[rg + kRG * i]), pv[i]);
  }

  T* oh = out + (size_t)b * o_sb + (size_t)h * o_sh + d;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = rg + kRG * i;
    if (r < nq) oh[(size_t)(i0 + r) * o_sl] = from_f<T>(__fdiv_rn(acc[i], ls[r]));
  }
}

template <typename T>
void launch(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb, int k_sh,
            int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B, int H, int Lq, int Lk,
            int hd, float scale, const void* kbias, void* out, int o_sb, int o_sh, int o_sl,
            cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (kQT * hd + kQT * kBK + 3 * kQT);
  dim3 grid((Lq + kQT - 1) / kQT, H, B);
  note_launch(kStreamingAttnKernel, hd);
  streaming_attn_kernel<T><<<grid, kRG * hd, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, q_sl, static_cast<const T*>(k), k_sb, k_sh, k_sl,
      static_cast<const T*>(v), v_sb, v_sh, v_sl, Lq, Lk, hd, scale,
      static_cast<const float*>(kbias), static_cast<T*>(out), o_sb, o_sh, o_sl);
}

__host__ __device__ constexpr int mma_stage_bytes(int hd) { return 2 * kBK * (hd + 8) * 2 + kBK * 4; }

// PAD: the head dim head_dim is below HD (csrc/attention_tiles.cuh); without
// it the head dim is HD. At HD 32 ptxas left alone takes 128 registers and
// spills; two blocks an SM let it take 204 and spill nothing (0 leaves the
// other instances to ptxas, as they were).
template <int HD, bool PAD, typename T>
__global__ void __launch_bounds__(kTcThreads, HD == 32 ? 2 : 0)
    streaming_mma_kernel(const T* __restrict__ q, int q_sb, int q_sh, int q_sl,
                         const T* __restrict__ k, int k_sb, int k_sh, int k_sl,
                         const T* __restrict__ v, int v_sb, int v_sh, int v_sl,
                         int Lq, int Lk, float scale, const float* __restrict__ kbias,
                         T* __restrict__ out, int o_sb, int o_sh, int o_sl, int head_dim) {
  constexpr int NT = kBK / 8;  // n-tiles of a score block
  const int hd = PAD ? head_dim : HD;
  constexpr int kPvCols = HD > 96 ? 64 : HD;  // columns of one PV pass
  constexpr int kStage = mma_stage_bytes(HD);
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int b = blockIdx.x, h = blockIdx.z;
  const int row0 = blockIdx.y * kTcRows + warp * 16;  // this warp's first query row
  const T* kh = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const T* vh = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const float* kb = kbias + (size_t)b * Lk;

  auto Ks = [&](int st) { return reinterpret_cast<T*>(ring + st * kStage); };
  auto Vs = [&](int st) { return Ks(st) + kBK * (HD + 8); };
  auto Bs = [&](int st) { return reinterpret_cast<float*>(Vs(st) + kBK * (HD + 8)); };
  const int nblocks = (Lk + kBK - 1) / kBK;
  auto issue = [&](int it) {
    const int st = it & 1, j0 = it * kBK;
    load_rows<HD, kBK, PAD>(Ks(st), kh, k_sl, j0, Lk, hd, tid);
    load_rows<HD, kBK, PAD>(Vs(st), vh, v_sl, j0, Lk, hd, tid);
    load_bias<kBK>(Bs(st), kb, j0, Lk, tid);
    cp_async_commit();
  };
  issue(0);

  uint32_t qf[HD / 16][4];
  load_q<HD>(qf, q + (size_t)b * q_sb + (size_t)h * q_sh, q_sl, row0, Lq, hd, lane);
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < nblocks; ++it) {
    cp_async_wait_all();
    __syncthreads();  // block it is in; block it - 1 is done with the other stage
    if (it + 1 < nblocks) issue(it + 1);
    const int st = it & 1, j0 = it * kBK;
    const float* bs = Bs(st);

    float s[NT][4];
    qk_tile<HD, NT>(s, qf, Ks(st), lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 kb2 = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), (e & 1) ? kb2.y : kb2.x);
    }
    if (j0 + kBK > Lk) mask_keys<NT>(s, Lk - j0, lane);

    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = neg_inf();
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
      const float m_cur = fmaxf(quad_max(mx), m[rr]);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * rr] = expf(__fadd_rn(s[n][2 * rr], -m_cur));
        s[n][2 * rr + 1] = expf(__fadd_rn(s[n][2 * rr + 1], -m_cur));
        psum += s[n][2 * rr] + s[n][2 * rr + 1];
      }
      alpha[rr] = expf(__fadd_rn(m[rr], -m_cur));  // exp(-inf) = 0 at the first block
      l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), quad_sum(psum));
      m[rr] = m_cur;
    }
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      pa[n >> 1][2 * (n & 1)] = pack2<T>(s[n][0], s[n][1]);
      pa[n >> 1][2 * (n & 1) + 1] = pack2<T>(s[n][2], s[n][3]);
    }
#pragma unroll
    for (int c0 = 0; c0 < HD; c0 += kPvCols) {
      float pv[kPvCols / 8][4];
#pragma unroll
      for (int n = 0; n < kPvCols / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
      pv_tile<HD, NT, T, kPvCols>(pv, pa, Vs(st) + c0, lane);
#pragma unroll
      for (int n = 0; n < kPvCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c0 / 8 + n][e] = __fadd_rn(__fmul_rn(acc[c0 / 8 + n][e], alpha[e >> 1]), pv[n][e]);
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fdiv_rn(acc[n][e], l[e >> 1]);
  store_rows<HD>(out + (size_t)b * o_sb + (size_t)h * o_sh, o_sl, row0, Lq, hd, acc, lane);
}

// The wide tiles (HD 192, 256; csrc/attention_tiles.cuh): the same online
// softmax over 128-key blocks, in the same order of operations, with a pair
// of warps on each 16 query rows, q in shared memory, and each warp owning
// half the output columns (HD / 2) and half of each block's scores. K and V
// of a 128-key block take 101 KB at HD 192 and 135 KB at 256, so a
// two-stage ring of whole blocks does not fit shared memory; the ring holds
// four 64-key tiles instead and walks them in the order they are used, K of
// the block's first and second half, then V of its first and second half
// (kWideSlots, three tiles in flight behind the one in use). Per block:
//   1-2. each warp's 32 keys of each K half: s = QK^T, scale, key bias,
//        keys past Lk -> -inf (32 scores a row, two halves kept);
//   3. the row max over the warp's 64 scores, exchanged with the other warp
//      of the pair: m_new = max(m, max over all 128 scores) before any p is
//      rounded, as the TPU kernel takes it;
//   4. alpha = exp(m - m_new), p = exp(s - m_new), rounded to T into the
//      pair's [16, 128] p tile; the two warps' sums of p (each over its 64
//      keys) added half 0's first, l = l * alpha + sum;
//   5-6. pv = P . V over the two V halves (fp32 sums of the 128 keys, this
//      warp's columns), then acc = acc * alpha + pv, as the narrow kernel
//      and the TPU kernel order it; out = acc / l at the end.
// The sum of p is formed in two halves, so l differs from the narrow
// kernel's in fp32 order only. Shared memory (wide_streaming_smem_bytes):
// the ring (4 x 25.3 KB at HD 192, 4 x 33.3 KB at 256), q (25.6 KB, 33.8
// KB), the pairs' p tiles (17.4 KB) and the exchanged maxima and sums (1
// KB): 144 KB at HD 192 and 184 KB at 256, one block of 8 warps an SM;
// ptxas gives 186 registers at HD 192 and 224 at 256 (pv and acc, 64 a
// lane each at 256, live across the two V halves), no spill. What bounds
// it (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): the softmax's work
// per score, as the narrow kernel: B=2 2249^2 4x192 takes 0.283 ms against
// a 0.031 ms bound (the bf16 operations) and SDPA's 0.242; B=16 2267^2
// 1x256 0.586 against 0.085 and 0.530. The CUDA-core kernel took 3.212 and
// 9.120.
constexpr int kWideHalf = kBK / 2;  // keys of a ring tile
constexpr int kWideSlots = 4;
constexpr int kWidePLd = kBK + 8;   // a shared p row
__host__ __device__ constexpr int wide_slot_bytes(int hd) {
  return kWideHalf * (hd + 8) * 2 + kWideHalf * 4;
}
__host__ __device__ constexpr int wide_streaming_smem_bytes(int hd) {
  return kWideSlots * wide_slot_bytes(hd) + kTcRows * (hd + 8) * 2 +
         kTcWarps * 16 * kWidePLd * 2 + kWideWarps * 2 * 16 * 4;
}

template <int HD, bool PAD, typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    streaming_wide_kernel(const T* __restrict__ q, int q_sb, int q_sh, int q_sl,
                          const T* __restrict__ k, int k_sb, int k_sh, int k_sl,
                          const T* __restrict__ v, int v_sb, int v_sh, int v_sl,
                          int Lq, int Lk, float scale, const float* __restrict__ kbias,
                          T* __restrict__ out, int o_sb, int o_sh, int o_sl, int head_dim) {
  constexpr int kKeys = kWideHalf / 2;  // keys of a ring tile per warp
  constexpr int NT = kKeys / 8;         // n-tiles of a warp's scores in one tile
  constexpr int kCols = HD / 2;         // output columns per warp
  constexpr int kSlot = wide_slot_bytes(HD);
  const int hd = PAD ? head_dim : HD;
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pr = warp >> 1, half = warp & 1;  // pair (16 query rows), half (keys, columns)
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, i0 = blockIdx.y * kTcRows, h = blockIdx.z;
  const T* kh = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const T* vh = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const float* kb = kbias + (size_t)b * Lk;

  auto Ts = [&](int j) { return reinterpret_cast<T*>(ring + (j % kWideSlots) * kSlot); };
  auto Bs = [&](int j) { return reinterpret_cast<float*>(Ts(j) + kWideHalf * (HD + 8)); };
  T* const qs = reinterpret_cast<T*>(ring + kWideSlots * kSlot);  // [64][HD + 8]
  T* const ps = qs + kTcRows * (HD + 8) + pr * 16 * kWidePLd;     // this pair's [16][kWidePLd]
  float* const xs = reinterpret_cast<float*>(qs + kTcRows * (HD + 8) + kTcWarps * 16 * kWidePLd);
  float* const mx_w = xs + warp * 32, *const sum_w = mx_w + 16;   // this warp's rows' max, sum
  float* const mx_o = xs + (warp ^ 1) * 32, *const sum_o = mx_o + 16;  // the other warp's
  float* const sum_0 = xs + (pr * 2) * 32 + 16, *const sum_1 = sum_0 + 32;  // half 0's, 1's

  const int nblocks = (Lk + kBK - 1) / kBK, steps = 4 * nblocks;
  // ring tile j: block j / 4; K of half j % 2 (with its key biases) for j % 4
  // < 2, else V of half j % 2. Every step commits a group, empty past the
  // end, so that "all but the two newest" is always tile j's.
  auto issue = [&](int j) {
    if (j < steps) {
      const int j0 = (j >> 2) * kBK + (j & 1) * kWideHalf;
      if ((j & 2) == 0) {
        load_rows<HD, kWideHalf, PAD, kWideThreads>(Ts(j), kh, k_sl, j0, Lk, hd, tid);
        load_bias<kWideHalf, kWideThreads>(Bs(j), kb, j0, Lk, tid);
      } else {
        load_rows<HD, kWideHalf, PAD, kWideThreads>(Ts(j), vh, v_sl, j0, Lk, hd, tid);
      }
    }
    cp_async_commit();
  };
  // q's rows (zeros past Lq and, PAD, past hd) in the same group as tile 0
  load_rows<HD, kTcRows, PAD, kWideThreads>(qs, q + (size_t)b * q_sb + (size_t)h * q_sh, q_sl,
                                            i0, Lq, hd, tid);
  issue(0);
  issue(1);
  issue(2);
  auto next = [&](int j) {  // wait for tile j, free the slot of j - 1, refill it with j + 3
    cp_async_wait<2>();
    __syncthreads();
    issue(j + 3);
  };

  const T* qw = qs + pr * 16 * (HD + 8);
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < nblocks; ++it) {
    float s[2][NT][4];  // this warp's 32 keys of each half
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 4 * it + hf, jw = it * kBK + hf * kWideHalf + half * kKeys;
      next(j);
      const float* bs = Bs(j) + half * kKeys;
      qk_tile_smem<HD, NT>(s[hf], qw, Ts(j) + half * kKeys * (HD + 8), lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kb2 = *reinterpret_cast<const float2*>(bs + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[hf][n][e] = __fadd_rn(__fmul_rn(s[hf][n][e], scale), (e & 1) ? kb2.y : kb2.x);
      }
      if (jw + kKeys > Lk) mask_keys<NT>(s[hf], Lk - jw, lane);  // all of them when jw >= Lk
    }

    float alpha[2], m_cur[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = neg_inf();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[hf][n][2 * rr], s[hf][n][2 * rr + 1]));
      m_cur[rr] = quad_max(mx);
      if (t == 0) mx_w[g + 8 * rr] = m_cur[rr];
    }
    pair_sync(pr);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // the block's first key is in half 0, so m_cur is finite from the first block on
      m_cur[rr] = fmaxf(fmaxf(m_cur[rr], mx_o[g + 8 * rr]), m[rr]);
      float psum = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          s[hf][n][2 * rr] = expf(__fadd_rn(s[hf][n][2 * rr], -m_cur[rr]));
          s[hf][n][2 * rr + 1] = expf(__fadd_rn(s[hf][n][2 * rr + 1], -m_cur[rr]));
          psum += s[hf][n][2 * rr] + s[hf][n][2 * rr + 1];
        }
      psum = quad_sum(psum);
      if (t == 0) sum_w[g + 8 * rr] = psum;
      alpha[rr] = expf(__fadd_rn(m[rr], -m_cur[rr]));  // exp(-inf) = 0 at the first block
      m[rr] = m_cur[rr];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) store_p<NT>(ps + hf * kWideHalf + half * kKeys, kWidePLd,
                                               s[hf], lane);
    pair_sync(pr);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = g + 8 * rr;
      l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), __fadd_rn(sum_0[r], sum_1[r]));
    }

    float pv[kCols / 8][4];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 4 * it + 2 + hf;
      next(j);
      uint32_t pa[kWideHalf / 16][4];
      load_pa<kWideHalf / 16>(pa, ps + hf * kWideHalf, kWidePLd, lane);
      pv_tile<HD, kWideHalf / 8, T, kCols>(pv, pa, Ts(j) + half * kCols, lane);
    }
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], alpha[e >> 1]), pv[n][e]);
  }
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fdiv_rn(acc[n][e], l[e >> 1]);
  store_rows<kCols>(out + (size_t)b * o_sb + (size_t)h * o_sh + half * kCols, o_sl,
                    i0 + pr * 16, Lq, hd - half * kCols, acc, lane);
}

template <int HD, bool PAD, typename T>
void launch_mma(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb, int k_sh,
                int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B, int H, int Lq,
                int Lk, int hd, float scale, const void* kbias, void* out, int o_sb, int o_sh,
                int o_sl, cudaStream_t stream) {
  dim3 grid(B, (Lq + kTcRows - 1) / kTcRows, H);
  auto go = [&](auto kernel, LaunchedKernel name, int threads, int smem) {
    static bool attr_set = false;  // one per instantiation
    if (!attr_set) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      attr_set = true;
    }
    note_launch(name, HD);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(q), q_sb, q_sh, q_sl, static_cast<const T*>(k), k_sb, k_sh, k_sl,
        static_cast<const T*>(v), v_sb, v_sh, v_sl, Lq, Lk, scale,
        static_cast<const float*>(kbias), static_cast<T*>(out), o_sb, o_sh, o_sl, hd);
  };
  if constexpr (HD > 128)
    go(streaming_wide_kernel<HD, PAD, T>, kStreamingWideKernel, kWideThreads, wide_streaming_smem_bytes(HD));
  else
    go(streaming_mma_kernel<HD, PAD, T>, kStreamingMmaKernel, kTcThreads, 2 * mma_stage_bytes(HD));
}

// The tensor-core launch at the instance that serves head dim hd (<= 256)
// on 16-bit q/k/v/out of type T.
template <typename T>
void launch_mma_tile(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb,
                     int k_sh, int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B,
                     int H, int Lq, int Lk, int hd, float scale, const void* kbias, void* out,
                     int o_sb, int o_sh, int o_sl, cudaStream_t s) {
  with_tile(hd, [&](auto HD, auto PAD) {
    launch_mma<decltype(HD)::value, decltype(PAD)::value, T>(
        q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk, hd, scale,
        kbias, out, o_sb, o_sh, o_sl, s);
  });
}

}  // namespace hr

using namespace hr;

extern "C" {

// The tile head dim of the instance that serves head dim hd in dtype
// (kDtBf16, kDtF32 or kDtF16; 0 for another code).
int hr_streaming_instance(int hd, int dtype) {
  return dtype == kDtBf16 || dtype == kDtF32 || dtype == kDtF16 ? tile_head_dim(hd) : 0;
}

// Operands as in hr_onepass_attention (csrc/wavlm_attention.cu), without a
// gate. Needs Lk >= 1, hd % 8 == 0 and hd <= 256 (blockDim 4*hd of the
// CUDA-core kernel, whose shared memory stays under 48 KB). Runs the
// instance of hr_streaming_instance: streaming_mma_kernel or
// streaming_wide_kernel (bf16, fp16), attn_tf32_kernel or
// attn_tf32_wide_kernel (fp32), or with cuda_cores = 1 streaming_attn_kernel
// on CUDA cores at any head dim and type (to time it beside the tile
// kernels). dtype: kDtBf16, kDtF32 or kDtF16.
int hr_streaming_attention(int dtype, const void* q, int q_sb, int q_sh, int q_sl, const void* k,
                           int k_sb, int k_sh, int k_sl, const void* v, int v_sb, int v_sh,
                           int v_sl, int B, int H, int Lq, int Lk, int hd, float scale,
                           const void* kbias, void* out, int o_sb, int o_sh, int o_sl,
                           int cuda_cores, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  const int inst = cuda_cores ? 0 : tile_head_dim(hd);
  if (inst && dtype == kDtF32) {
    Tf32Args a{};
    a.q = static_cast<const float*>(q), a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.q_sb = q_sb, a.q_sh = q_sh, a.q_sl = q_sl, a.k_sb = k_sb, a.k_sh = k_sh, a.k_sl = k_sl;
    a.v_sb = v_sb, a.v_sh = v_sh, a.v_sl = v_sl, a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd;
    a.scale = scale, a.kbias = static_cast<const float*>(kbias);
    a.out = static_cast<float*>(out), a.o_sb = o_sb, a.o_sh = o_sh, a.o_sl = o_sl;
    launch_attn_tf32_tile<true>(a, B, s);
    return (int)cudaGetLastError();
  }
  if (inst && dtype == kDtF16)
    launch_mma_tile<__half>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B,
                            H, Lq, Lk, hd, scale, kbias, out, o_sb, o_sh, o_sl, s);
  else if (inst)
    launch_mma_tile<__nv_bfloat16>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh,
                                   v_sl, B, H, Lq, Lk, hd, scale, kbias, out, o_sb, o_sh, o_sl,
                                   s);
  else if (dtype == kDtF32)
    launch<float>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk,
                  hd, scale, kbias, out, o_sb, o_sh, o_sl, s);
  else if (dtype == kDtF16)
    launch<__half>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk,
                   hd, scale, kbias, out, o_sb, o_sh, o_sl, s);
  else
    launch<__nv_bfloat16>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                          Lq, Lk, hd, scale, kbias, out, o_sb, o_sh, o_sl, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
