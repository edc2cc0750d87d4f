// The fp32 float attention cores on the tensor cores, in 3xTF32, at the
// narrow tile head dims of csrc/attention_tiles.cuh (32, 64, 96 and 128; a
// head dim below one is zero-padded to it in the tile, the gated core runs
// at 64 and 96 only; fp32 above 128 stays on the CUDA-core kernels): the
// one-pass kernel of
// csrc/wavlm_attention.cu (wavlm_fused_attention, onepass_attention) and
// the streaming kernel of csrc/flash_attention.cu (streaming_attention).
// They replace, for fp32 q/k/v, the Pallas kernels
// hriemo/ops/wavlm_attention.py::_kernel (gated one-pass),
// hriemo/ops/flash_attention_pallas.py::_onepass_kernel (one-pass, no gate)
// and ::_flash_kernel (online softmax, Lk > 2048).
//
// 3xTF32. mma.sync.m16n8k8 multiplies TF32 operands (10 mantissa bits) into
// fp32 sums. Each fp32 operand x is split into big = x truncated to TF32 and
// small = x - big (exact in fp32, truncated to TF32 by the tensor core), and
// a product takes three mma: small.big + big.small + big.big. The dropped
// small.small term and the truncation of small leave about 2^-20 of each
// product, where one TF32 product keeps 2^-11, too little for the fp32
// trees' 1e-4 at large scores. The split is two instructions, where
// cvt.rna.tf32.f32 lowers to several with its NaN checks and selects, for
// big and for small (chip_tf32_terms.py holds and times all three).
//
// A block takes 64 query rows, 16 per warp, as the bf16 kernels
// (csrc/attention_tiles.cuh). Each lane keeps its q A-fragment values in
// its own slots of shared memory, read by one float4 load per 8-dim step and
// split there, so that q takes no registers: 123-168 a thread, three blocks
// an SM at HD 64 and 96 (two at HD 128, by shared memory). K, V and the key
// biases (and, gated, the pos tile from the 16-byte boundary below its first
// key, read at its offset) arrive as fp32 through a two-stage cp.async ring
// of kTf32BK-key tiles, and each warp splits the K and V elements it loads,
// once per fragment load. The
// contraction index of an m16n8k8 step holds dims (or keys) 2t at index t
// and 2t + 1 at index t + 4 (a permutation of the eight summed terms), so a
// K fragment is one float2 load and the scores' C fragment of 8 keys is,
// element for element, PV's A fragment of those keys: p never leaves
// registers.
//
// Order of operations, those of the bf16 kernels and the plain versions:
//   one-pass, two sweeps: s = (q.k^T)*scale [+ gate*pos] + kbias; sweep 1
//     keeps the running max m and l = l*exp(m_old - m) + sum exp(s - m);
//     sweep 2 forms s again, p = exp(s - m) / l by div_rn, not rounded to a
//     narrower type, and o += p.v;
//   streaming, one sweep: per tile m_new, alpha = exp(m - m_new), p =
//     exp(s - m_new), l = l*alpha + sum p, o = o*alpha + p.v, and o / l once
//     at the end. The TPU kernel steps every 128 keys, this one every
//     kTf32BK: in fp32 nothing is rounded to a narrower type between steps,
//     so the step only moves fp32 rounding, as does summing p.v onto o*alpha
//     inside the tensor cores.
// Keys past Lk get s = -inf and zeroed K/V rows; masked keys keep -1e9, so
// an all-masked row averages v; query rows past Lq read zeros and are never
// stored. Shared memory does not grow with Lk: no score panel, no key limit.
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): not the
// three TF32 products per fp32 one (3 x 4*B*H*Lq*Lk*hd operations at 495
// TFLOP/s, 15-30% of the kernel's time), but the FMA-pipe work beside
// them: the split (two instructions per element loaded, each warp splitting
// the whole K and V tile) and the softmax per score (an accurate expf in both
// sweeps and a division in the second).
#pragma once

#include "attention_tiles.cuh"

namespace hr {

constexpr int kTf32BK = 32;                // keys per tile
constexpr int kTf32PosLd = kTf32BK + 4;    // a realigned fp32 pos row: the tile's keys + up to 3

// K rows of HD floats, each 8-float group of row r at group g ^ (r % 4)
// (tf32_kcol): a half warp's float2 fragment loads, rows g .. g + 3 at the
// same 8 columns, then fall on 32 distinct banks. V rows of HD + 4 floats:
// the loads of keys 2t and 2t + 1 at column g do.
__host__ __device__ constexpr int tf32_ldv(int hd) { return hd + 4; }
__device__ __forceinline__ int tf32_kcol(int r, int c) { return c ^ ((r & 3) << 3); }

// Bytes of one ring stage: K and V tiles, the key biases and, gated, the
// realigned pos tile.
__host__ __device__ constexpr int tf32_stage_bytes(int hd, bool gated) {
  return 4 * (kTf32BK * (hd + tf32_ldv(hd)) + kTf32BK + (gated ? kTcRows * kTf32PosLd : 0));
}

// Shared memory of a block: the two-stage ring and the block's q rows, kept
// by each lane in its own A-fragment order so that they take no registers
// (at hd 96 that is what lets three blocks share an SM).
__host__ __device__ constexpr int tf32_smem_bytes(int hd, bool gated) {
  return 2 * tf32_stage_bytes(hd, gated) + 4 * kTcRows * hd;
}

struct Tf32Args {
  const float *q, *k, *v;                   // element (b, h, i, d) at b*sb + h*sh + i*sl + d
  int q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  int H, Lq, Lk;
  float scale;
  const float* kbias;                       // [B, Lk] fp32 additive
  const float* gate;                        // [B, H, Lq], or NULL for no gate
  const float* pos;                         // gated: [H, Lq, Lk]
  float* out;
  int o_sb, o_sh, o_sl;
  int hd;                                   // the head dim (padded instances: below HD)
};

// x = big + small: big is x with its 13 low mantissa bits cleared (a TF32
// value), small = x - big is exact in fp32 and goes to the tensor core as
// it is, which reads its top 19 bits: small is truncated to TF32 there, to
// 2^-20 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the two small terms first, then big.big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// This warp's 16 query rows (row0 = its first) into the lane's own slots
// of qs: for each 8-dim step ks, the A-fragment values {q[g][8ks+2t],
// q[g+8][8ks+2t], q[g][8ks+2t+1], q[g+8][8ks+2t+1]} as one float4 at
// qs[(32 ks + lane) * 4]; zeros for rows at or past Lq and, PAD, for the
// 8-dim steps at or past hd. q: the head's row 0, rows sl elements apart.
template <int HD, bool PAD>
__device__ __forceinline__ void stage_q_f32(float* qs, const float* q, int sl, int row0, int Lq,
                                            int hd, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + g, rb = ra + 8;
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int ks = 0; ks < HD / 8; ++ks) {
    const int d = 8 * ks + 2 * t;
    const bool in = !PAD || 8 * ks < hd;
    const float2 x =
        ra < Lq && in ? *reinterpret_cast<const float2*>(q + (size_t)ra * sl + d) : zero;
    const float2 y =
        rb < Lq && in ? *reinterpret_cast<const float2*>(q + (size_t)rb * sl + d) : zero;
    *reinterpret_cast<float4*>(qs + (32 * ks + lane) * 4) = make_float4(x.x, y.x, x.y, y.y);
  }
}

// Rows j0 .. j0+R-1 of a [L, hd] fp32 head (rows sl elements apart) into R
// shared rows of LD floats, K's (SWZ) with their 8-float groups swizzled by
// tf32_kcol; rows at or past L and, PAD, columns at or past hd are zeroed.
template <int HD, int R, int LD, bool SWZ, bool PAD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int sl, int j0, int L,
                                              int hd, int tid) {
  constexpr int kChunks = HD / 4;
  for (int idx = tid; idx < R * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool ok = j0 + r < L && (!PAD || c * 4 < hd);
    cp_async16(dst + r * LD + (SWZ ? tf32_kcol(r, 4 * c) : 4 * c),
               src + (size_t)(ok ? j0 + r : 0) * sl + (PAD && !ok ? 0 : c * 4), ok ? 16 : 0);
  }
}

// s[n] = this warp's 16 query rows . keys 8n .. 8n+7 of the tile, 3xTF32
// with fp32 sums over HD. qs: the lane's q slots (stage_q_f32); ks: the K
// tile, swizzled rows of HD floats.
template <int HD, int NT>
__device__ __forceinline__ void qk_tile_tf32(float (&s)[NT][4], const float* qs, const float* ks,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int k = 0; k < HD / 8; ++k) {
    const float4 qv = *reinterpret_cast<const float4*>(qs + (32 * k + lane) * 4);
    uint32_t ab[4], as[4];
    split_tf32(qv.x, ab[0], as[0]);
    split_tf32(qv.y, ab[1], as[1]);
    split_tf32(qv.z, ab[2], as[2]);
    split_tf32(qv.w, ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // rows n*8 + g share g's swizzle
      const float2 kv =
          *reinterpret_cast<const float2*>(ks + (n * 8 + g) * HD + tf32_kcol(g, 8 * k) + 2 * t);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(kv.x, bb0, bs0);
      split_tf32(kv.y, bb1, bs1);
      mma_3xtf32(s[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// o += P.V over the tile's NT * 8 keys, 3xTF32: p[n] is this warp's C
// fragment of keys 8n .. 8n+7, the A fragment of that 8-key step (index t
// for key 2t, t + 4 for key 2t + 1); vs: the V tile, rows of tf32_ldv(HD)
// floats.
template <int HD, int NT>
__device__ __forceinline__ void pv_tile_tf32(float (&o)[HD / 8][4], const float (&p)[NT][4],
                                             const float* vs, int lane) {
  constexpr int LD = tf32_ldv(HD);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ab[4], as[4];
    split_tf32(p[n][0], ab[0], as[0]);  // row g,     key 2t
    split_tf32(p[n][2], ab[1], as[1]);  // row g + 8, key 2t
    split_tf32(p[n][1], ab[2], as[2]);  // row g,     key 2t + 1
    split_tf32(p[n][3], ab[3], as[3]);  // row g + 8, key 2t + 1
    const float* v0 = vs + (n * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(v0[d * 8], bb0, bs0);
      split_tf32(v0[LD + d * 8], bb1, bs1);
      mma_3xtf32(o[d], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// One-pass (two sweeps) or, STREAM, online-softmax attention over fp32
// q/k/v; GATED adds gate[b,h,i] * pos[h,i,j] to the scores; PAD: the head
// dim a.hd is below HD. Three blocks an SM: 168 registers a thread.
template <int HD, bool GATED, bool STREAM, bool PAD>
__global__ void __launch_bounds__(kTcThreads, 3) attn_tf32_kernel(const Tf32Args a) {
  constexpr int NT = kTf32BK / 8;  // n-tiles of a score tile
  const int hd = PAD ? a.hd : HD;
  constexpr int kStage = tf32_stage_bytes(HD, GATED);
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, i0 = blockIdx.y * kTcRows, h = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk;
  const int row0 = i0 + warp * 16;  // this warp's first query row
  const float* kh = a.k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const float* vh = a.v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;
  const size_t krow0 = (size_t)b * Lk;  // this element's key 0 in kbias
  // pos element (i0, 0) of this head; the tensor's length bounds every copy
  const size_t pos_i0 = ((size_t)h * Lq + i0) * Lk, pos_len = (size_t)a.H * Lq * Lk;
  const int nq = min(kTcRows, Lq - i0);

  auto Ks = [&](int st) { return reinterpret_cast<float*>(ring + st * kStage); };
  auto Vs = [&](int st) { return Ks(st) + kTf32BK * HD; };
  auto Bs = [&](int st) { return Vs(st) + kTf32BK * tf32_ldv(HD); };
  auto Ps = [&](int st) { return Bs(st) + kTf32BK; };

  const int ntiles = (Lk + kTf32BK - 1) / kTf32BK, steps = STREAM ? ntiles : 2 * ntiles;
  // step it: tile it % ntiles of sweep it / ntiles (one-pass: V only in sweep 2)
  auto issue = [&](int it) {
    const int st = it & 1, j0 = (it % ntiles) * kTf32BK;
    load_rows_f32<HD, kTf32BK, HD, true, PAD>(Ks(st), kh, a.k_sl, j0, Lk, hd, tid);
    if (STREAM || it >= ntiles)
      load_rows_f32<HD, kTf32BK, tf32_ldv(HD), false, PAD>(Vs(st), vh, a.v_sl, j0, Lk, hd, tid);
    load_bias<kTf32BK>(Bs(st), a.kbias + krow0, j0, Lk, tid);
    if (GATED) {
      // row r from the 16-byte boundary at or below its key j0
      constexpr int kChunks = kTf32PosLd / 4;
      for (int idx = tid; idx < kTcRows * kChunks; idx += kTcThreads) {
        const int r = idx / kChunks, c = idx - r * kChunks;
        const size_t ad = ((pos_i0 + (size_t)r * Lk + j0) & ~(size_t)3) + 4 * c;
        const size_t left = r < nq && ad < pos_len ? 4 * (pos_len - ad) : 0;  // bytes
        const int bytes = left < 16 ? (int)left : 16;
        cp_async16(Ps(st) + r * kTf32PosLd + 4 * c, a.pos + (bytes ? ad : 0), bytes);
      }
    }
    cp_async_commit();
  };
  issue(0);

  float* qs = reinterpret_cast<float*>(ring + 2 * kStage) + warp * 16 * HD;  // this lane's slots
  stage_q_f32<HD, PAD>(qs, a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh, a.q_sl, row0, Lq, hd,
                  lane);
  // this lane's rows g and g + 8: gate, and the column of key 0 in its
  // realigned pos row
  float gt[2] = {0.f, 0.f};
  int psh[2] = {0, 0};
  if (GATED) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = row0 + g + 8 * rr;
      if (i < Lq) gt[rr] = a.gate[((size_t)b * a.H + h) * Lq + i];
      psh[rr] = (int)((pos_i0 + (size_t)(warp * 16 + g + 8 * rr) * Lk) & 3);
    }
  }
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f}, rl[2] = {1.f, 1.f};  // rl = 1 / l
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait_all();
    __syncthreads();  // step it's tiles are in; step it - 1 is done with the other stage
    if (it + 1 < steps) issue(it + 1);
    const int st = it & 1, j0 = (it % ntiles) * kTf32BK;
    const float* bs = Bs(st);
    const float* ps = Ps(st) + (warp * 16 + g) * kTf32PosLd;

    float s[NT][4];
    qk_tile_tf32<HD, NT>(s, qs, Ks(st), lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 kb2 = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        float x = __fmul_rn(s[n][e], a.scale);
        if (GATED)
          x = __fadd_rn(x, __fmul_rn(gt[rr], ps[rr * 8 * kTf32PosLd + psh[rr] + c + (e & 1)]));
        s[n][e] = __fadd_rn(x, (e & 1) ? kb2.y : kb2.x);
      }
    }
    if (j0 + kTf32BK > Lk) mask_keys<NT>(s, Lk - j0, lane);

    if (STREAM) {  // online softmax: rescale, then p.v onto o
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
        alpha[rr] = expf(__fadd_rn(m[rr], -m_cur));  // exp(-inf) = 0 at the first tile
        l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), quad_sum(psum));
        m[rr] = m_cur;
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], alpha[e >> 1]);
      pv_tile_tf32<HD, NT>(o, s, Vs(st), lane);
    } else if (it < ntiles) {  // sweep 1: running max and rescaled running sum
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
    } else {  // sweep 2: p / l in fp32, then PV
      if (it == ntiles) rl[0] = __frcp_rn(l[0]), rl[1] = __frcp_rn(l[1]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = div_rn(expf(__fadd_rn(s[n][e], -m[e >> 1])), l[e >> 1], rl[e >> 1]);
      pv_tile_tf32<HD, NT>(o, s, Vs(st), lane);
    }
  }
  if (STREAM) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = __fdiv_rn(o[n][e], l[e >> 1]);
  }
  store_rows<HD>(a.out + (size_t)b * a.o_sb + (size_t)h * a.o_sh, a.o_sl, row0, Lq, hd, o,
                 lane);
}

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

template <int HD, bool GATED, bool STREAM, bool PAD = false>
void launch_attn_tf32(const Tf32Args& a, int B, cudaStream_t stream) {
  constexpr int smem = tf32_smem_bytes(HD, GATED);
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(attn_tf32_kernel<HD, GATED, STREAM, PAD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  // batch element fastest: the blocks that read one pos tile run together
  dim3 grid(B, (a.Lq + kTcRows - 1) / kTcRows, a.H);
  attn_tf32_kernel<HD, GATED, STREAM, PAD><<<grid, kTcThreads, smem, stream>>>(a);
}

// The ungated launch at the instance that serves head dim a.hd (<= 128).
template <bool STREAM>
void launch_attn_tf32_tile(const Tf32Args& a, int B, cudaStream_t s) {
  with_tile<128>(a.hd, [&](auto HD, auto PAD) {
    launch_attn_tf32<decltype(HD)::value, false, STREAM, decltype(PAD)::value>(a, B, s);
  });
}

}  // namespace

}  // namespace hr
