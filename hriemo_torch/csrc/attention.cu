// Attention core of the two int8 attention sublayers
// (hriemo_torch/ops/attention_block.py): softmax(q k^T + bias) v per head,
// over bf16 q/k/v that the int8 projection GEMM has already produced,
// read in place from its packed output.
//
// Replaces the per-(element, head) core of the Pallas kernels
// hriemo/ops/attention_block.py::_kernel (WavLM: gated relative position
// bias, :218-260) and ::_mha_kernel (plain key-padding bias, :576-605).
//
// Without the gate (mha_block_int8: BERT, the fusion stack's self and
// cross attention), every head dim up to 256 runs on the tensor-core
// kernels of csrc/onepass_mma.cuh at the tile instance that serves it
// (csrc/attention_tiles.cuh: 32, 64, 96, 128, 192, 256, a head dim between
// them zero-padded inside the tile): onepass_mma_kernel up to 128, 64
// query rows a block on mma.sync.m16n8k16 with q in registers, and
// onepass_wide_kernel at 192 and 256, a pair of warps on each 16 rows, each
// with half the output columns and q in shared memory (registers bound
// those: see csrc/attention_tiles.cuh). Both keep no score panel: a
// cp.async ring of 64-key K/V tiles walked twice. The key bias is a bool
// padding mask (or an fp32 array). The gated core (attention_block_int8:
// WavLM) runs there at its head dims 64 and 96, the gate computed in the
// block's prologue from x. What bounds them on the card: the per-score FMA
// and MUFU work of the exact-p/l contract (two sweeps, accurate expf, a
// rounded division per score), as in the float route.
//
// The core at 64 and 96, gated or not, runs on three kernels (hr_attention_core's
// `kernel`): the two sweeps above; onepass_wgmma_kernel (csrc/onepass_wgmma.cuh,
// key rows up to kWgMaxKeys, 512: wgmma warpgroups fed by a producer warp,
// every score of a 64-row block in registers); and onepass_panel_kernel below
// (key rows up to kPanelMaxKeys, 512), the counterpart of the TPU kernels' one
// pass over a held row of scores. The sublayers' fused routes take the one
// ops/attention_block.py core_kernel picks from the card's readings (the
// wgmma core gated from 65 keys; the panel gated for one key tile and,
// ungated, at the served batches up to 320 keys but for four key tiles): the
// gated core in the WavLM sublayer (three launches: csrc/proj_int8.cu's
// q/k/v projection, this core, the out-projection with the LayerNorm) and
// the ungated one in the MHA sublayer (BERT's 12 x 64 and the fusion stack's
// 8 x 96: text rows of 8-64 tokens, audio rows of 62-499 frames); their
// chain routes keep the two sweeps. The panel's first sweep computes
// each score once, QK^T on mma.sync and the scale, gate * pos and key bias
// in the TPU kernels' order (no gate: the scale and the key bias, as the
// two-sweep kernel's ungated form), into a panel in shared memory, with the
// rows' maxima; then one expf a score, e = exp(s - max) written back and
// summed into l; then PV over the V tiles with p = e / l rounded as in the
// two sweeps (the reciprocal and two remainder corrections, then to bf16).
// So QK^T and the pos tile are computed and read once, where the two-sweep
// kernel (longer rows, and route="chain") computes them twice and the exp
// twice. l is the sum over the final maximum, as the plain version's and
// the TPU kernel's are; it differs from the plain one in fp32 order only.
// The panel is the lane's own fragments (each lane reads back only what it
// wrote, as float4, consecutive lanes on consecutive 16 bytes): 64 query
// rows of 512 keys are 128 KB, so a block of 4 warps holds an SM alone at
// the longest rows (a block of 2 warps, 32 rows, halved the panel and was
// no faster at any length, PERF.md section 6: taken out). The ring holds
// K, the key biases and (gated) the pos tile in the first sweep and V in
// PV; ungated it is 27 KB at HD 96, so up to five key tiles (320 keys, a
// 109 KB block) two blocks share an SM. What bounds it (NVIDIA H100 80GB
// HBM3 at 700 W, chip_proj_routes.py --cores): the per-score FMA and MUFU
// work, as the two sweeps, and the latency that too few warps an SM leave
// unhidden: 4 warps a block take 0.2046 ms gated at B=384 L=62 (the two
// sweeps 0.2666, the wgmma core 0.2280, SDPA 0.1261) but 0.7581 at B=32
// L=499 (0.5084; the wgmma core 0.2682), where one block fits an SM;
// ungated 0.1827 at B=64 L=312 (0.2074; 0.2040) but 0.3668 at L=343
// (0.2812; 0.2471).
//
// The gated core at other head dims (hd % 8 == 0, hd <= 256), which no
// WavLM has: attn_core_kernel on CUDA cores. It stays because the gate-from-x
// prologue has no wide form and its narrow instances at 32 and 128 would add
// eight instances to this file's build for no model of the repo. One block
// per (query tile of kQT rows, head, batch element). The whole key row of
// scores stays in shared memory (Lk <= 1024 on every routed shape), so
// softmax is exact and one-pass, as in the TPU kernel:
#include "onepass_wgmma.cuh"

namespace hr {

constexpr int kQT = 16;  // query rows per block

// RG: row groups in PV, RG * hd threads (rounded up to whole warps; the rest
// take no part in PV): 4 up to hd 128, 2 beyond, where 4 * hd threads at the
// kernel's registers do not fit an SM's 65536.
template <int RG>
__global__ void attn_core_kernel(const __nv_bfloat16* __restrict__ q, int q_ld,
                                 const __nv_bfloat16* __restrict__ k, int k_ld,
                                 const __nv_bfloat16* __restrict__ v, int v_ld, int Lq, int Lk,
                                 int hd, const float* __restrict__ kbias,
                                 const uint8_t* __restrict__ kpm,
                                 const void* __restrict__ x, int x_ld, int x_f32,
                                 const float* __restrict__ wg, const float* __restrict__ bg,
                                 const float* __restrict__ gconst,
                                 const __nv_bfloat16* __restrict__ pos,
                                 __nv_bfloat16* __restrict__ ctx, int ctx_ld) {
  extern __shared__ float smem[];
  float* qs = smem;              // [kQT][hd]
  float* gate = qs + kQT * hd;   // [kQT]
  float* S = gate + kQT;         // [kQT][Lk]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int i0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(kQT, Lq - i0);
  const size_t qrow0 = (size_t)b * Lq + i0, krow0 = (size_t)b * Lk;

  for (int idx = tid; idx < kQT * hd; idx += nthr) {
    const int r = idx / hd, d = idx - r * hd;
    qs[idx] = r < nq ? bf2f(q[(qrow0 + r) * q_ld + h * hd + d]) : 0.f;
  }
  if (pos != nullptr) {
    for (int r = warp; r < nq; r += nwarps) {
      const size_t xo = (qrow0 + r) * x_ld + h * hd;
      const float gr = x_f32 ? wavlm_gate(static_cast<const float*>(x) + xo, wg, bg, gconst[h],
                                          hd, lane)
                             : wavlm_gate(static_cast<const __nv_bfloat16*>(x) + xo, wg, bg,
                                          gconst[h], hd, lane);
      if (lane == 0) gate[r] = gr;
    }
  }
  __syncthreads();

  for (int j = tid; j < Lk; j += nthr) {
    const __nv_bfloat16* kr = k + (krow0 + j) * k_ld + h * hd;
    float acc[kQT];
#pragma unroll
    for (int r = 0; r < kQT; ++r) acc[r] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kv[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(kp[e]);
        kv[2 * e] = f.x;
        kv[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < kQT; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(qs + r * hd + d0);
        const float4 c = *reinterpret_cast<const float4*>(qs + r * hd + d0 + 4);
        acc[r] += a.x * kv[0] + a.y * kv[1] + a.z * kv[2] + a.w * kv[3] + c.x * kv[4] +
                  c.y * kv[5] + c.z * kv[6] + c.w * kv[7];
      }
    }
    float kb = kbias != nullptr ? kbias[krow0 + j] : 0.f;
    if (kpm != nullptr && kpm[krow0 + j]) kb = kNegInf;
#pragma unroll
    for (int r = 0; r < kQT; ++r) {
      float s = acc[r];
      if (pos != nullptr && r < nq)
        s = __fadd_rn(s, __fmul_rn(gate[r], bf2f(pos[((size_t)h * Lq + i0 + r) * Lk + j])));
      S[r * Lk + j] = __fadd_rn(s, kb);
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
    const float rl = __frcp_rn(l);
    for (int j = lane; j < Lk; j += 32) sr[j] = bf2f(f2bf(div_rn(sr[j], l, rl)));
  }
  __syncthreads();

  constexpr int kRPT = kQT / RG;  // rows per thread
  const int d = tid % hd, rg = tid / hd;
  if (rg >= RG) return;
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i] = 0.f;
  const __nv_bfloat16* vc = v + krow0 * v_ld + h * hd + d;
  for (int j = 0; j < Lk; ++j) {
    const float vv = bf2f(vc[(size_t)j * v_ld]);
#pragma unroll
    for (int i = 0; i < kRPT; ++i) acc[i] += S[(rg + RG * i) * Lk + j] * vv;
  }
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = rg + RG * i;
    if (r < nq) ctx[(qrow0 + r) * ctx_ld + h * hd + d] = f2bf(acc[i]);
  }
}

constexpr int kPanelMaxKeys = 512;  // the panel kernel's longest key row

// The int8 core's kernels at head dims 64 and 96, as hr_attention_core takes
// them (ops/attention_block.py CORE_KERNELS)
enum CoreKernel : int { kCoreSweeps = 0, kCorePanel = 1, kCoreWgmma = 2 };

// Bytes of one ring stage of onepass_panel_kernel: the K tile, the key
// biases and, gated, the realigned pos tile (V reuses the stage).
__host__ __device__ constexpr int panel_stage_bytes(int hd, bool gated) {
  return kOneBK * (hd + 8) * 2 + kOneBK * 4 + (gated ? kTcRows * kPosLd * 2 : 0);
}
__host__ __device__ constexpr int panel_smem_bytes(int hd, int lk, bool gated) {
  return 2 * panel_stage_bytes(hd, gated) +
         (lk + kOneBK - 1) / kOneBK * kOneBK * kTcRows * 4;
}

// The core on a score panel, 4 warps of 16 query rows: Lk <= kPanelMaxKeys.
// GATED: WavLM's gate from x times pos added to each score.
template <int HD, int KEYS, bool GATED>
__global__ void __launch_bounds__(kTcThreads) onepass_panel_kernel(const OnepassArgs a) {
  using T = __nv_bfloat16;
  constexpr int NT = kOneBK / 8, ROWS = kTcRows, THREADS = kTcThreads;
  constexpr int kStage = panel_stage_bytes(HD, GATED);
  static_assert(kStage % 16 == 0, "the panel starts on 16 bytes");
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, i0 = blockIdx.y * ROWS, h = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk;
  const int row0 = i0 + warp * 16;  // this warp's first query row
  const T* qh = a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh;
  const T* kh = a.k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const T* vh = a.v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;
  const size_t krow0 = (size_t)b * Lk;  // this element's key 0 in kbias / kpm
  // pos element (i0, 0) of this head; the tensor's length bounds every copy
  const size_t pos_i0 = ((size_t)h * Lq + i0) * Lk, pos_len = (size_t)a.H * Lq * Lk;
  const int nq = min(ROWS, Lq - i0);

  auto Ks = [&](int st) { return reinterpret_cast<T*>(ring + st * kStage); };
  auto Bs = [&](int st) { return reinterpret_cast<float*>(Ks(st) + kOneBK * (HD + 8)); };
  auto Ps = [&](int st) { return reinterpret_cast<T*>(Bs(st) + kOneBK); };
  // [tile * NT + n][THREADS]: the lane's four scores of n-tile n, then their exps
  float4* const panel = reinterpret_cast<float4*>(ring + 2 * kStage);

  const int ntiles = (Lk + kOneBK - 1) / kOneBK, steps = 2 * ntiles;
  // step it: K (and biases, pos) of tile it in the first sweep, V of tile
  // it - ntiles in PV
  auto issue = [&](int it) {
    const int st = it & 1, j0 = (it % ntiles) * kOneBK;
    if (it >= ntiles) {
      load_rows<HD, kOneBK, false, THREADS>(Ks(st), vh, a.v_sl, j0, Lk, HD, tid);
      cp_async_commit();
      return;
    }
    load_rows<HD, kOneBK, false, THREADS>(Ks(st), kh, a.k_sl, j0, Lk, HD, tid);
    if (KEYS == kKeysBias) load_bias<kOneBK, THREADS>(Bs(st), a.kbias + krow0, j0, Lk, tid);
    if (GATED) {
      // row r from the 16-byte boundary at or below its key j0
      constexpr int kChunks = kPosLd / 8;
      for (int idx = tid; idx < ROWS * kChunks; idx += THREADS) {
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
      for (int idx = tid; idx < kOneBK; idx += THREADS) {
        const int j = j0 + idx;
        Bs(st)[idx] = j < Lk && a.kpm != nullptr && a.kpm[krow0 + j] ? kNegInf : 0.f;
      }
    }
  };
  issue(0);

  uint32_t qf[HD / 16][4];
  load_q<HD>(qf, qh, a.q_sl, row0, Lq, HD, lane);
  // this lane's rows g and g + 8: gate, and the column of key 0 in its
  // realigned pos row
  float gt[2] = {0.f, 0.f};
  int psh[2] = {0, 0};
  if (GATED) {
#pragma unroll 1
    for (int r = 0; r < 16 && row0 + r < Lq; ++r) {  // warp-uniform
      const size_t xo = ((size_t)b * Lq + row0 + r) * a.x_ld + h * HD;
      const float gr = a.x_f32 ? wavlm_gate(static_cast<const float*>(a.x) + xo, a.wg, a.bg,
                                            a.gconst[h], HD, lane)
                               : wavlm_gate(static_cast<const __nv_bfloat16*>(a.x) + xo, a.wg,
                                            a.bg, a.gconst[h], HD, lane);
      if (r == g) gt[0] = gr;
      if (r == g + 8) gt[1] = gr;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      psh[rr] = (int)((pos_i0 + (size_t)(warp * 16 + g + 8 * rr) * Lk) & 7);
  }
  float m[2] = {neg_inf(), neg_inf()}, l[2], rl[2];  // rl = 1 / l
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait_all();
    __syncthreads();  // step it's tiles are in; step it - 1 is done with the other stage
    if (it + 1 < steps) issue(it + 1);
    const int st = it & 1;
    if (it < ntiles) {  // the scores of tile it into the panel, and the lane's row maxima
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
          if (GATED)
            x = __fadd_rn(x, __fmul_rn(gt[rr], load_f(ps + rr * 8 * kPosLd + psh[rr] + c + (e & 1))));
          s[n][e] = __fadd_rn(x, (e & 1) ? kb2.y : kb2.x);
        }
      }
      if ((it + 1) * kOneBK > Lk) mask_keys<NT>(s, Lk - it * kOneBK, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        m[0] = fmaxf(m[0], fmaxf(s[n][0], s[n][1]));
        m[1] = fmaxf(m[1], fmaxf(s[n][2], s[n][3]));
        panel[(it * NT + n) * THREADS + tid] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
    } else {  // PV over V tile it - ntiles
      if (it == ntiles) {  // the rows' maxima, one exp a score, the sums
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 4
        for (int k = 0; k < ntiles * NT; ++k) {
          float4 v = panel[k * THREADS + tid];
          v.x = expf(__fadd_rn(v.x, -m[0]));
          v.y = expf(__fadd_rn(v.y, -m[0]));
          v.z = expf(__fadd_rn(v.z, -m[1]));
          v.w = expf(__fadd_rn(v.w, -m[1]));
          sum0 += v.x + v.y;
          sum1 += v.z + v.w;
          panel[k * THREADS + tid] = v;
        }
        l[0] = quad_sum(sum0);
        l[1] = quad_sum(sum1);
        rl[0] = __frcp_rn(l[0]);
        rl[1] = __frcp_rn(l[1]);
      }
      const int tt = it - ntiles;
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 e = panel[(tt * NT + n) * THREADS + tid];
        pa[n >> 1][2 * (n & 1)] =
            pack2<T>(div_rn(e.x, l[0], rl[0]), div_rn(e.y, l[0], rl[0]));
        pa[n >> 1][2 * (n & 1) + 1] =
            pack2<T>(div_rn(e.z, l[1], rl[1]), div_rn(e.w, l[1], rl[1]));
      }
      pv_tile<HD, NT>(o, pa, Ks(st), lane);
    }
  }
  store_rows<HD>(a.out + (size_t)b * a.o_sb + (size_t)h * a.o_sh, a.o_sl, row0, Lq, HD, o,
                 lane);
}

namespace {  // per-library opt-in flags (see csrc/onepass_mma.cuh)

template <int HD, int KEYS, bool GATED>
void launch_panel(const OnepassArgs& a, int B, cudaStream_t s) {
  const auto kernel = onepass_panel_kernel<HD, KEYS, GATED>;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         panel_smem_bytes(HD, kPanelMaxKeys, GATED));
    attr_set = true;
  }
  note_launch(kOnepassPanelKernel, HD);
  kernel<<<dim3(B, (a.Lq + kTcRows - 1) / kTcRows, a.H), kTcThreads,
           panel_smem_bytes(HD, a.Lk, GATED), s>>>(a);
}

// The panel kernel at head dim hd (64 or 96), gated or not, and the
// key-mask kind chosen at run time.
template <bool GATED>
void launch_panel_keys(const OnepassArgs& a, int B, int hd, int keys, cudaStream_t s) {
  if (hd == 64 && keys == kKeysBias) launch_panel<64, kKeysBias, GATED>(a, B, s);
  else if (hd == 64) launch_panel<64, kKeysPad, GATED>(a, B, s);
  else if (keys == kKeysBias) launch_panel<96, kKeysBias, GATED>(a, B, s);
  else launch_panel<96, kKeysPad, GATED>(a, B, s);
}

}  // namespace

}  // namespace hr

using namespace hr;

extern "C" {

// q/k/v point at head 0 of their regions; row r of batch element b is at
// (b*L + r)*ld, each row 16-byte aligned. kbias: [B, Lk] fp32 additive or
// NULL; kpm: [B, Lk] bool (True = PAD) or NULL, not both. WavLM gate (all
// NULL for plain MHA): x [B*Lq, x_ld] bf16 (x_f32 = 0) or fp32 (1), read as
// bf16 by the gate; wg [8, hd] fp32, bg [8] fp32, gconst [H] fp32, pos [H,
// Lq, Lk] bf16. ctx: [B*Lq, ctx_ld] bf16, head h at column h*hd. Needs
// hd % 8 == 0 and hd <= 256; gated at head dims other than 64 and 96, Lk <=
// 1024 (the CUDA-core kernel's score panel). kernel: the core at 64 and 96,
// gated or not, on the two sweeps of onepass_mma_kernel (kCoreSweeps; the
// wide tiles ungated above 128), on onepass_panel_kernel (kCorePanel, Lk <=
// kPanelMaxKeys) or on onepass_wgmma_kernel (kCoreWgmma, Lk <= kWgMaxKeys,
// csrc/onepass_wgmma.cuh); the gated CUDA-core kernel ignores it, and the
// ungated core at another head dim refuses all but the two sweeps.
int hr_attention_core(const void* q, int q_ld, const void* k, int k_ld, const void* v,
                      int v_ld, int B, int Lq, int Lk, int H, int hd, const void* kbias,
                      const void* kpm, const void* x, int x_ld, int x_f32, const void* wg,
                      const void* bg, const void* gconst, const void* pos, void* ctx,
                      int ctx_ld, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  using bf = __nv_bfloat16;
  if (pos == nullptr || hd == 64 || hd == 96) {
    OnepassArgs a{};
    a.q = static_cast<const bf*>(q), a.k = static_cast<const bf*>(k), a.v = static_cast<const bf*>(v);
    a.q_sb = Lq * q_ld, a.q_sh = hd, a.q_sl = q_ld;
    a.k_sb = Lk * k_ld, a.k_sh = hd, a.k_sl = k_ld;
    a.v_sb = Lk * v_ld, a.v_sh = hd, a.v_sl = v_ld;
    a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd, a.scale = 1.0f;  // 1/sqrt(hd) is in q already
    a.kbias = static_cast<const float*>(kbias), a.kpm = static_cast<const uint8_t*>(kpm);
    a.x = x, a.x_ld = x_ld, a.x_f32 = x_f32, a.wg = static_cast<const float*>(wg);
    a.bg = static_cast<const float*>(bg), a.gconst = static_cast<const float*>(gconst);
    a.pos = static_cast<const bf*>(pos), a.out = static_cast<bf*>(ctx);
    a.o_sb = Lq * ctx_ld, a.o_sh = hd, a.o_sl = ctx_ld;
    const int keys = kbias != nullptr ? kKeysBias : kKeysPad;
    if (kernel != kCoreSweeps && hd != 64 && hd != 96) return (int)cudaErrorInvalidValue;
    if (kernel == kCoreWgmma) {
      if (Lk > kWgMaxKeys) return (int)cudaErrorInvalidValue;
      return pos != nullptr ? launch_onepass_wgmma<kGateFromX, false>(a, B, s)
                            : launch_onepass_wgmma<kNoGate, false>(a, B, s);
    }
    if (kernel == kCorePanel) {
      if (Lk > kPanelMaxKeys) return (int)cudaErrorInvalidValue;
      if (pos != nullptr) launch_panel_keys<true>(a, B, hd, keys, s);
      else launch_panel_keys<false>(a, B, hd, keys, s);
    } else if (kernel != kCoreSweeps) {
      return (int)cudaErrorInvalidValue;
    } else if (pos != nullptr)
      launch_onepass_mma_keys<kGateFromX>(a, B, hd, keys, s);
    else if (keys == kKeysBias)
      launch_onepass_tile<kKeysBias>(a, B, s);
    else
      launch_onepass_tile<kKeysPad>(a, B, s);
    return (int)cudaGetLastError();
  }
  const int smem = (int)sizeof(float) * (kQT * hd + kQT + kQT * Lk);
  dim3 grid((Lq + kQT - 1) / kQT, H, B);
  auto go = [&](auto RG) {
    constexpr int rg = decltype(RG)::value;
    static bool attr_set = false;  // one per row-group count
    if (!attr_set) {
      cudaFuncSetAttribute(attn_core_kernel<rg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           200 * 1024);
      attr_set = true;
    }
    note_launch(kAttnCoreKernel, hd);
    attn_core_kernel<rg><<<grid, (rg * hd + 31) / 32 * 32, smem, s>>>(
        static_cast<const bf*>(q), q_ld, static_cast<const bf*>(k), k_ld,
        static_cast<const bf*>(v), v_ld, Lq, Lk, hd, static_cast<const float*>(kbias),
        static_cast<const uint8_t*>(kpm), x, x_ld, x_f32,
        static_cast<const float*>(wg), static_cast<const float*>(bg),
        static_cast<const float*>(gconst), static_cast<const bf*>(pos), static_cast<bf*>(ctx),
        ctx_ld);
  };
  if (hd <= 128)
    go(std::integral_constant<int, 4>());
  else
    go(std::integral_constant<int, 2>());
  return (int)cudaGetLastError();
}

}  // extern "C"
