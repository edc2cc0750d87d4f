// One-pass attention core of the port's float attention routes
// (hriemo_torch/ops/wavlm_attention.py, hriemo_torch/ops/flash_attention.py):
//
//   s   = (q . k^T) * scale  [+ gate[b,h,i] * pos[h,i,j]]  + kbias[b,j]   (fp32)
//   out = ((exp(s - max s) / sum) -> T) . v                               (fp32 sums -> T)
//
// over q/k/v of type T (bf16 or fp32), read in place through their batch,
// head and row strides (the projections' [B, L, H*hd] outputs, no copy).
//
// Replaces the two Pallas kernels that compute this one-pass softmax with
// K/V resident in VMEM:
//   hriemo/ops/wavlm_attention.py::_kernel, WavLM's gated relative position
//     bias: gate [B, H, Lq] fp32 and pos [H, Lq, Lk] of type T given;
//   hriemo/ops/flash_attention_pallas.py::_onepass_kernel, gate = pos = NULL,
//     routed for 1024 <= Lq and 1024 <= Lk <= 2048.
//
// bf16 at head dim 64 (WavLM) or 96 (fusion): onepass_mma_kernel, on the
// tensor cores (csrc/attention_tiles.cuh). A block takes 64 query rows, 16
// per warp, and walks the keys in tiles of 64 twice:
//   sweep 1: s for each tile (mma.sync QK^T, then scale, gate * pos and the
//     key bias in the TPU kernels' order, __fmul_rn/__fadd_rn), the running
//     row max m and the running sum l = l * exp(m_old - m) + sum exp(s - m);
//   sweep 2: s again, p = exp(s - m) / l (rounded to nearest: the
//     reciprocal of l and two remainder corrections, div_rn), rounded to bf16 as
//     the TPU kernels cast p / l to v's dtype before PV, then PV on mma.sync
//     with fp32 sums.
// The contract rounds p / l, so l must be known before PV: the price of
// keeping no score panel is 1.5x the products and twice the exps. l differs
// from the panel's sum in fp32 order and rescaling only, before p / l is
// rounded. Keys past Lk get s = -inf, so exp gives exact zeros; query rows
// past Lq read zeros and are never stored; a row whose keys are all masked
// (every kbias NEG_INF) comes out as a finite average of v.
// Shared memory no longer grows with Lk: a two-stage cp.async ring of K, V,
// the key biases and (gated) the [64, 64] pos tile, 55 KB at hd 64 and
// 72 KB at hd 96, so three or four blocks share an SM. pos rows are only
// 2-byte aligned at odd Lk, so each row is copied from the 16-byte boundary
// below its first key and read at its offset (e & 7) in shared memory,
// without a padded copy in device memory. Blocks run batch element
// fastest, so the blocks that read the same pos tile run together and share
// it through L2.
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): the
// per-score work on the FMA and MUFU pipes, not the tensor cores or device
// memory. Each score takes the epilogue and an accurate expf in both
// sweeps, and a division in the second: about 35 instructions a score, so
// a 16x8 block of scores costs some 140 warp instructions beside its 12
// mma.sync at hd 64. At B=2 L=1499 the gated launch takes 0.26 ms against
// a 0.022 ms bound (the bytes). It took 0.35 ms with __fdiv_rn, which
// branches to a slow path after every division, and 1.84 ms on the
// CUDA-core kernel that this replaces. Blocks take 128 registers at hd 64,
// so four fit on an SM, and 576 blocks make 1.1 waves there.
//
// fp32, and bf16 at other head dims (hd % 8 == 0, hd <= 256):
// onepass_attn_kernel on CUDA cores, one block per 16 query rows with the
// fp32 score panel [16, Lk] in up to 227 KB of shared memory (no TF32: the
// fp32 trees are held at 1e-4):
//   1. the query tile goes to shared memory as fp32, with its 16 gates;
//   2. scores: each thread owns one key at a time and dots it with all 16
//      query rows (fp32 sums of the products), multiplies by scale, then
//      adds gate * pos and the key bias, in the TPU kernels' order;
//   3. softmax per row, one warp per row; p / l is rounded to T;
//   4. PV: thread (d, row group) sums p[r][j] * v[j][d] in fp32, stores T.
#include "attention_tiles.cuh"

namespace hr {

constexpr int kQT = 16;                 // query rows per block (CUDA cores)
constexpr int kRG = 4;                  // row groups in PV: blockDim = kRG * hd
constexpr int kMaxSmem = 227 * 1024;    // H100 dynamic shared memory per block
constexpr int kOneBK = 64;              // keys per tile (tensor cores)
constexpr int kPosLd = kOneBK + 8;      // a realigned pos row: the tile's keys + up to 7

template <typename T>
__global__ void onepass_attn_kernel(const T* __restrict__ q, int q_sb, int q_sh, int q_sl,
                                    const T* __restrict__ k, int k_sb, int k_sh, int k_sl,
                                    const T* __restrict__ v, int v_sb, int v_sh, int v_sl,
                                    int H, int Lq, int Lk, int hd, float scale,
                                    const float* __restrict__ kbias,
                                    const float* __restrict__ gate,
                                    const T* __restrict__ pos,
                                    T* __restrict__ out, int o_sb, int o_sh, int o_sl) {
  extern __shared__ float smem[];
  float* qs = smem;            // [kQT][hd]
  float* gs = qs + kQT * hd;   // [kQT]
  float* S = gs + kQT;         // [kQT][Lk]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int i0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(kQT, Lq - i0);
  const T* qh = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const T* kh = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const T* vh = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const float* kb = kbias + (size_t)b * Lk;
  const bool gated = gate != nullptr;

  for (int idx = tid; idx < kQT * hd; idx += nthr) {
    const int r = idx / hd, d = idx - r * hd;
    qs[idx] = r < nq ? load_f(qh + (size_t)(i0 + r) * q_sl + d) : 0.f;
  }
  if (tid < kQT) gs[tid] = gated && tid < nq ? gate[((size_t)b * H + h) * Lq + i0 + tid] : 0.f;
  __syncthreads();

  for (int j = tid; j < Lk; j += nthr) {
    const T* kr = kh + (size_t)j * k_sl;
    float acc[kQT];
#pragma unroll
    for (int r = 0; r < kQT; ++r) acc[r] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += 8) {
      float kv[8];
      load8(kr + d0, kv);
#pragma unroll
      for (int r = 0; r < kQT; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(qs + r * hd + d0);
        const float4 c = *reinterpret_cast<const float4*>(qs + r * hd + d0 + 4);
        acc[r] += a.x * kv[0] + a.y * kv[1] + a.z * kv[2] + a.w * kv[3] + c.x * kv[4] +
                  c.y * kv[5] + c.z * kv[6] + c.w * kv[7];
      }
    }
    const float kbj = kb[j];
#pragma unroll
    for (int r = 0; r < kQT; ++r) {
      float s = __fmul_rn(acc[r], scale);
      if (gated && r < nq)
        s = __fadd_rn(s, __fmul_rn(gs[r], load_f(pos + ((size_t)h * Lq + i0 + r) * Lk + j)));
      S[r * Lk + j] = __fadd_rn(s, kbj);
    }
  }
  __syncthreads();

  for (int r = warp; r < nq; r += nwarps) {
    float* sr = S + r * Lk;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float p = expf(__fadd_rn(sr[j], -m));
      sr[j] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int j = lane; j < Lk; j += 32) sr[j] = round_as<T>(__fdiv_rn(sr[j], l));
  }
  __syncthreads();

  constexpr int kRPT = kQT / kRG;  // rows per thread
  const int d = tid % hd, rg = tid / hd;
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i] = 0.f;
  const T* vc = vh + d;
#pragma unroll 4
  for (int j = 0; j < Lk; ++j) {
    const float vv = load_f(vc + (size_t)j * v_sl);
#pragma unroll
    for (int i = 0; i < kRPT; ++i) acc[i] += S[(rg + kRG * i) * Lk + j] * vv;
  }
  T* oh = out + (size_t)b * o_sb + (size_t)h * o_sh + d;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = rg + kRG * i;
    if (r < nq) oh[(size_t)(i0 + r) * o_sl] = from_f<T>(acc[i]);
  }
}

// Bytes of one ring stage of onepass_mma_kernel: K and V tiles, the key
// biases and, gated, the realigned pos tile.
__host__ __device__ constexpr int mma_stage_bytes(int hd, bool gated) {
  return 2 * kOneBK * (hd + 8) * 2 + kOneBK * 4 + (gated ? kTcRows * kPosLd * 2 : 0);
}

template <int HD, bool GATED>
__global__ void __launch_bounds__(kTcThreads)
    onepass_mma_kernel(const __nv_bfloat16* __restrict__ q, int q_sb, int q_sh, int q_sl,
                       const __nv_bfloat16* __restrict__ k, int k_sb, int k_sh, int k_sl,
                       const __nv_bfloat16* __restrict__ v, int v_sb, int v_sh, int v_sl,
                       int H, int Lq, int Lk, float scale, const float* __restrict__ kbias,
                       const float* __restrict__ gate, const __nv_bfloat16* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out, int o_sb, int o_sh, int o_sl) {
  constexpr int NT = kOneBK / 8;  // n-tiles of a score tile
  constexpr int kStage = mma_stage_bytes(HD, GATED);
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, i0 = blockIdx.y * kTcRows, h = blockIdx.z;
  const int row0 = i0 + warp * 16;  // this warp's first query row
  const __nv_bfloat16* qh = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const __nv_bfloat16* kh = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const __nv_bfloat16* vh = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const float* kb = kbias + (size_t)b * Lk;
  // pos element (i0, 0) of this head; the tensor's length bounds every copy
  const size_t pos_i0 = ((size_t)h * Lq + i0) * Lk, pos_len = (size_t)H * Lq * Lk;
  const int nq = min(kTcRows, Lq - i0);

  auto Ks = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(ring + st * kStage); };
  auto Vs = [&](int st) { return Ks(st) + kOneBK * (HD + 8); };
  auto Bs = [&](int st) { return reinterpret_cast<float*>(Vs(st) + kOneBK * (HD + 8)); };
  auto Ps = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(Bs(st) + kOneBK); };

  const int ntiles = (Lk + kOneBK - 1) / kOneBK, steps = 2 * ntiles;
  // step it: tile it % ntiles of sweep it / ntiles (V only in sweep 2)
  auto issue = [&](int it) {
    const int st = it & 1, j0 = (it % ntiles) * kOneBK;
    load_rows<HD, kOneBK>(Ks(st), kh, k_sl, j0, Lk, tid);
    if (it >= ntiles) load_rows<HD, kOneBK>(Vs(st), vh, v_sl, j0, Lk, tid);
    load_bias<kOneBK>(Bs(st), kb, j0, Lk, tid);
    if (GATED) {
      // row r from the 16-byte boundary at or below its key j0
      constexpr int kChunks = kPosLd / 8;
      for (int idx = tid; idx < kTcRows * kChunks; idx += kTcThreads) {
        const int r = idx / kChunks, c = idx - r * kChunks;
        const size_t a = ((pos_i0 + (size_t)r * Lk + j0) & ~(size_t)7) + 8 * c;
        const size_t left = r < nq && a < pos_len ? 2 * (pos_len - a) : 0;  // bytes
        const int bytes = left < 16 ? (int)left : 16;
        cp_async16(Ps(st) + r * kPosLd + 8 * c, pos + (bytes ? a : 0), bytes);
      }
    }
    cp_async_commit();
  };
  issue(0);

  uint32_t qf[HD / 16][4];
  load_q<HD>(qf, qh, q_sl, row0, Lq, lane);
  // this lane's rows: gate, and the column of key 0 in its realigned pos row
  float gt[2] = {0.f, 0.f};
  int psh[2] = {0, 0};
  if (GATED) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 16 + g + 8 * rr;
      if (i0 + r < Lq) gt[rr] = gate[((size_t)b * H + h) * Lq + i0 + r];
      psh[rr] = (int)((pos_i0 + (size_t)r * Lk) & 7);
    }
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
    const __nv_bfloat16* ps = Ps(st) + (warp * 16 + g) * kPosLd;

    float s[NT][4];
    qk_tile<HD, NT>(s, qf, Ks(st), lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 kb2 = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        float x = __fmul_rn(s[n][e], scale);
        if (GATED)
          x = __fadd_rn(x, __fmul_rn(gt[rr], bf2f(ps[rr * 8 * kPosLd + psh[rr] + c + (e & 1)])));
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
    } else {  // sweep 2: p / l rounded to bf16, then PV
      if (it == ntiles) rl[0] = __frcp_rn(l[0]), rl[1] = __frcp_rn(l[1]);
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = div_rn(expf(__fadd_rn(s[n][e], -m[e >> 1])), l[e >> 1], rl[e >> 1]);
        pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      pv_tile<HD, NT>(o, pa, Vs(st), lane);
    }
  }
  store_rows<HD>(out + (size_t)b * o_sb + (size_t)h * o_sh, o_sl, row0, Lq, o, lane);
}

template <typename T>
void launch(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb, int k_sh,
            int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B, int H, int Lq, int Lk,
            int hd, float scale, const void* kbias, const void* gate, const void* pos, void* out,
            int o_sb, int o_sh, int o_sl, int smem, cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(onepass_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    attr_set = true;
  }
  dim3 grid((Lq + kQT - 1) / kQT, H, B);
  onepass_attn_kernel<T><<<grid, kRG * hd, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, q_sl, static_cast<const T*>(k), k_sb, k_sh, k_sl,
      static_cast<const T*>(v), v_sb, v_sh, v_sl, H, Lq, Lk, hd, scale,
      static_cast<const float*>(kbias), static_cast<const float*>(gate),
      static_cast<const T*>(pos), static_cast<T*>(out), o_sb, o_sh, o_sl);
}

template <int HD, bool GATED>
void launch_mma(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb, int k_sh,
                int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B, int H, int Lq,
                int Lk, float scale, const void* kbias, const void* gate, const void* pos,
                void* out, int o_sb, int o_sh, int o_sl, cudaStream_t stream) {
  constexpr int smem = 2 * mma_stage_bytes(HD, GATED);
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(onepass_mma_kernel<HD, GATED>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  // batch element fastest: the blocks that read one pos tile run together
  dim3 grid(B, (Lq + kTcRows - 1) / kTcRows, H);
  using bf = __nv_bfloat16;
  onepass_mma_kernel<HD, GATED><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf*>(q), q_sb, q_sh, q_sl, static_cast<const bf*>(k), k_sb, k_sh, k_sl,
      static_cast<const bf*>(v), v_sb, v_sh, v_sl, H, Lq, Lk, scale,
      static_cast<const float*>(kbias), static_cast<const float*>(gate),
      static_cast<const bf*>(pos), static_cast<bf*>(out), o_sb, o_sh, o_sl);
}

bool on_tensor_cores(int fp32, int hd) { return !fp32 && (hd == 64 || hd == 96); }

}  // namespace hr

using namespace hr;

extern "C" {

// Shared memory one block needs (the gated launch's, the larger); the
// caller refuses shapes above kMaxSmem, which only the CUDA-core kernel's
// score panel can reach.
int hr_onepass_smem_bytes(int fp32, int Lk, int hd) {
  if (on_tensor_cores(fp32, hd)) return 2 * mma_stage_bytes(hd, true);
  return (int)sizeof(float) * (kQT * hd + kQT + kQT * Lk);
}

int hr_onepass_max_smem_bytes() { return kMaxSmem; }

// q/k/v/out: element (b, h, i, d) at b*sb + h*sh + i*sl + d, each row 16-byte
// aligned; fp32 != 0 for fp32 q/k/v/out/pos, else bf16. kbias [B, Lk] fp32
// additive. gate [B, H, Lq] fp32 and pos [H, Lq, Lk], or both NULL for no
// gate. Needs hd % 8 == 0 and hd <= 256 (blockDim 4*hd of the CUDA-core
// kernel).
int hr_onepass_attention(int fp32, const void* q, int q_sb, int q_sh, int q_sl, const void* k,
                         int k_sb, int k_sh, int k_sl, const void* v, int v_sb, int v_sh,
                         int v_sl, int B, int H, int Lq, int Lk, int hd, float scale,
                         const void* kbias, const void* gate, const void* pos, void* out,
                         int o_sb, int o_sh, int o_sl, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  if (on_tensor_cores(fp32, hd)) {
    const bool gated = gate != nullptr;
    if (hd == 64 && gated)
      launch_mma<64, true>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                           Lq, Lk, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, s);
    else if (hd == 64)
      launch_mma<64, false>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                            Lq, Lk, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, s);
    else if (gated)
      launch_mma<96, true>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                           Lq, Lk, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, s);
    else
      launch_mma<96, false>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                            Lq, Lk, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, s);
    return (int)cudaGetLastError();
  }
  const int smem = hr_onepass_smem_bytes(fp32, Lk, hd);
  if (fp32)
    launch<float>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk,
                  hd, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, smem, s);
  else
    launch<__nv_bfloat16>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                          Lq, Lk, hd, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, smem, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
