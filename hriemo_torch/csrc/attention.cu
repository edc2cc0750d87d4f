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
// The gated core at other head dims (hd % 8 == 0, hd <= 256), which no
// WavLM has: attn_core_kernel on CUDA cores. It stays because the gate-from-x
// prologue has no wide form and its narrow instances at 32 and 128 would add
// eight instances to this file's build for no model of the repo. One block
// per (query tile of kQT rows, head, batch element). The whole key row of
// scores stays in shared memory (Lk <= 1024 on every routed shape), so
// softmax is exact and one-pass, as in the TPU kernel:
#include "onepass_mma.cuh"

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
// 1024 (the CUDA-core kernel's score panel).
int hr_attention_core(const void* q, int q_ld, const void* k, int k_ld, const void* v,
                      int v_ld, int B, int Lq, int Lk, int H, int hd, const void* kbias,
                      const void* kpm, const void* x, int x_ld, int x_f32, const void* wg,
                      const void* bg, const void* gconst, const void* pos, void* ctx,
                      int ctx_ld, void* stream) {
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
    if (pos != nullptr)
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
