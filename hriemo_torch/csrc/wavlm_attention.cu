// One-pass attention core of the port's float attention routes
// (hriemo_torch/ops/wavlm_attention.py, hriemo_torch/ops/flash_attention.py):
//
//   s   = (q . k^T) * scale  [+ gate[b,h,i] * pos[h,i,j]]  + kbias[b,j]   (fp32)
//   out = ((exp(s - max s) / sum) -> T) . v                               (fp32 sums -> T)
//
// over q/k/v of type T (bf16, fp16 or fp32), read in place through their
// batch, head and row strides (the projections' [B, L, H*hd] outputs, no
// copy).
//
// Replaces the two Pallas kernels that compute this one-pass softmax with
// K/V resident in VMEM:
//   hriemo/ops/wavlm_attention.py::_kernel, WavLM's gated relative position
//     bias: gate [B, H, Lq] fp32 and pos [H, Lq, Lk] of type T given;
//   hriemo/ops/flash_attention_pallas.py::_onepass_kernel, gate = pos = NULL,
//     routed for 1024 <= Lq and 1024 <= Lk <= 2048.
//
// Which library runs is decided first by the caller's rule,
// ops/wavlm_attention.py onepass_kernel (from the card's readings): in bf16
// and fp16 csrc/attention_wgmma.cu's wgmma warpgroups take head dims 64 and
// 96 (every score held up to 512 keys; the two sweeps to 2048 where their
// 128-row blocks fill enough of the card) and, ungated, 136-256 (the two
// sweeps where their rounds of blocks beat this library's). This library
// keeps fp32, head dims 8-56 and 72-88 and 104-128, the gate off 64 and 96,
// past 2048 keys, views TMA cannot describe, and the grids where its kernels
// read faster. Which of its kernels runs is decided by onepass_instance
// alone (exported as hr_onepass_instance): without a gate, bf16, fp16 and
// fp32 run every head dim up to 256 on the tensor cores at the tile instance
// HD = tile_head_dim(hd), the smallest of 32, 64, 96, 128, 192 and 256 at or
// above hd (hd 8-32 at 32, 40-64 at 64, 72-96 at 96, 104-128 at 128,
// 136-192 at 192, 200-256 at 256); the gate runs there only at its own
// instances' head dims, 64 (WavLM) and 96.
// A head dim below its instance runs on the instance's padded form
// (with_tile), zero-padded to HD inside the tile, never in device memory
// (csrc/attention_tiles.cuh); the unpadded form takes hd as the constant HD.
//
// bf16 or fp16: the two-sweep kernels of csrc/onepass_mma.cuh, with the gate
// read from its [B, H, Lq] array: onepass_mma_kernel at HD <= 128 (4 warps,
// q in registers), onepass_wide_kernel at HD 192 and 256 (8 warps, a pair
// on each 16 query rows, q in shared memory; see there); fp16 on the f16
// form of the same mma.sync, with the bf16 numerics (p / l rounded to fp16
// before PV). What bounds it (NVIDIA H100 80GB HBM3 at 700
// W, chip_smoke.py): the per-score work on the FMA and MUFU pipes, about 35
// instructions a score, so a 16x8 block of scores costs some 140 warp
// instructions beside its 12 mma.sync at hd 64. At B=2 L=1499 the gated
// launch takes 0.26 ms against a 0.022 ms bound (the bytes). It took 0.35 ms
// with __fdiv_rn, which branches to a slow path after every division, and
// 1.84 ms on the CUDA-core kernel that this replaces. Blocks take 128
// registers at hd 64, so four fit on an SM, and 576 blocks make 1.1 waves
// there. At HD 192 and 256 the QK^T and PV products per score grow with hd
// while the softmax's work does not, and one 8-warp block an SM (by shared
// memory) has to hide both.
//
// fp32: attn_tf32_kernel (csrc/attention_tf32.cuh) at the narrow instances
// and attn_tf32_wide_kernel at HD 192 and 256 (a pair of warps on each 16
// query rows, as onepass_wide_kernel), the same two sweeps on
// mma.sync.m16n8k8 in 3xTF32: each fp32 operand is
// split into two TF32 parts and a product takes three mma, which keeps
// about 2^-20 of each product. One TF32 product (2^-11) does not hold the
// fp32 trees' 1e-4 at large scores (chip_tf32_terms.py), and fp32 FMAs run
// at a seventh of the TF32 rate. No score panel, so Lk has no limit. At
// B=2 1499^2 8x96 it takes about 0.42 ms against SDPA's 0.45 (chip_smoke.py),
// where the CUDA-core kernel below took 1.85.
//
// The gate at head dims other than 64 and 96 (hd % 8 == 0, hd <= 256) in
// any type, which no model reaches: onepass_attn_kernel on CUDA cores,
// one block per 16 query rows with the fp32 score panel
// [16, Lk] in up to 227 KB of shared memory, RG * hd threads (RG = 4 row
// groups up to hd 128, 2 beyond: 1024 threads at its 103 registers do not
// fit an SM's 65536):
//   1. the query tile goes to shared memory as fp32, with its 16 gates;
//   2. scores: each thread owns one key at a time and dots it with all 16
//      query rows (fp32 sums of the products), multiplies by scale, then
//      adds gate * pos and the key bias, in the TPU kernels' order;
//   3. softmax per row, one warp per row; p / l is rounded to T;
//   4. PV: thread (d, row group) sums p[r][j] * v[j][d] in fp32, stores T.
// cuda_cores = 1 takes it at any head dim and type (the yardstick that
// chip_smoke.py times beside each tile row).
#include "attention_tf32.cuh"
#include "onepass_mma.cuh"

namespace hr {

constexpr int kQT = 16;                 // query rows per block (CUDA cores)
constexpr int kMaxSmem = 227 * 1024;    // H100 dynamic shared memory per block

// RG: row groups in PV, RG * hd threads of the block (rounded up to whole
// warps; the rest take no part in PV).
template <typename T, int RG>
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

  constexpr int kRPT = kQT / RG;  // rows per thread
  const int d = tid % hd, rg = tid / hd;
  if (rg >= RG) return;
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i] = 0.f;
  const T* vc = vh + d;
#pragma unroll 4
  for (int j = 0; j < Lk; ++j) {
    const float vv = load_f(vc + (size_t)j * v_sl);
#pragma unroll
    for (int i = 0; i < kRPT; ++i) acc[i] += S[(rg + RG * i) * Lk + j] * vv;
  }
  T* oh = out + (size_t)b * o_sb + (size_t)h * o_sh + d;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = rg + RG * i;
    if (r < nq) oh[(size_t)(i0 + r) * o_sl] = from_f<T>(acc[i]);
  }
}

template <typename T, int RG>
void launch_rg(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb, int k_sh,
               int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B, int H, int Lq,
               int Lk, int hd, float scale, const void* kbias, const void* gate, const void* pos,
               void* out, int o_sb, int o_sh, int o_sl, int smem, cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(onepass_attn_kernel<T, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    attr_set = true;
  }
  dim3 grid((Lq + kQT - 1) / kQT, H, B);
  note_launch(kOnepassAttnKernel, hd);
  onepass_attn_kernel<T, RG><<<grid, (RG * hd + 31) / 32 * 32, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, q_sl, static_cast<const T*>(k), k_sb, k_sh, k_sl,
      static_cast<const T*>(v), v_sb, v_sh, v_sl, H, Lq, Lk, hd, scale,
      static_cast<const float*>(kbias), static_cast<const float*>(gate),
      static_cast<const T*>(pos), static_cast<T*>(out), o_sb, o_sh, o_sl);
}

template <typename T>
void launch(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb, int k_sh,
            int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B, int H, int Lq, int Lk,
            int hd, float scale, const void* kbias, const void* gate, const void* pos, void* out,
            int o_sb, int o_sh, int o_sl, int smem, cudaStream_t stream) {
  const auto fn = hd <= 128 ? &launch_rg<T, 4> : &launch_rg<T, 2>;
  fn(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk, hd, scale, kbias,
     gate, pos, out, o_sb, o_sh, o_sl, smem, stream);
}

// The tile instance (its head dim HD) that serves head dim hd, or 0 for the
// CUDA-core kernel, in every float dtype: the gated core is instantiated at
// 64 and 96 only.
int onepass_instance(int hd, bool gated) {
  return gated && hd != 64 && hd != 96 ? 0 : tile_head_dim(hd);
}

// The tensor-core launch on 16-bit q/k/v/pos/out of type T: the gated core
// at hd 64 or 96, the ungated one at the instance that serves hd.
template <typename T>
void launch_mma(const void* q, int q_sb, int q_sh, int q_sl, const void* k, int k_sb, int k_sh,
                int k_sl, const void* v, int v_sb, int v_sh, int v_sl, int B, int H, int Lq,
                int Lk, int hd, float scale, const void* kbias, const void* gate,
                const void* pos, void* out, int o_sb, int o_sh, int o_sl, cudaStream_t s) {
  OnepassArgsT<T> a{};
  a.q = static_cast<const T*>(q), a.k = static_cast<const T*>(k), a.v = static_cast<const T*>(v);
  a.q_sb = q_sb, a.q_sh = q_sh, a.q_sl = q_sl, a.k_sb = k_sb, a.k_sh = k_sh, a.k_sl = k_sl;
  a.v_sb = v_sb, a.v_sh = v_sh, a.v_sl = v_sl, a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd;
  a.scale = scale, a.kbias = static_cast<const float*>(kbias);
  a.gate = static_cast<const float*>(gate);
  a.pos = static_cast<const T*>(pos), a.out = static_cast<T*>(out);
  a.o_sb = o_sb, a.o_sh = o_sh, a.o_sl = o_sl;
  if (gate != nullptr && hd == 64) launch_onepass_mma<64, kGateArray, kKeysBias>(a, B, s);
  else if (gate != nullptr) launch_onepass_mma<96, kGateArray, kKeysBias>(a, B, s);
  else launch_onepass_tile<kKeysBias>(a, B, s);
}

}  // namespace hr

using namespace hr;

extern "C" {

// The tile head dim of the instance that serves head dim hd in dtype
// (kDtBf16, kDtF32 or kDtF16; 0 for another code) with (gated = 1) or
// without a gate, or 0 for the CUDA-core kernel.
int hr_onepass_instance(int hd, int gated, int dtype) {
  return dtype == kDtBf16 || dtype == kDtF32 || dtype == kDtF16 ? onepass_instance(hd, gated != 0)
                                                                 : 0;
}

// Shared memory one block of hr_onepass_attention needs, with the same
// cuda_cores; the caller refuses shapes above kMaxSmem, which only the
// CUDA-core kernel's score panel can reach. dtype: kDtBf16, kDtF32 or kDtF16.
int hr_onepass_smem_bytes(int dtype, int Lk, int hd, int gated, int cuda_cores) {
  const int inst = cuda_cores ? 0 : onepass_instance(hd, gated != 0);
  if (inst)
    return dtype == kDtF32 ? tf32_tile_smem_bytes(inst, gated)
                           : onepass_tile_smem_bytes(inst, gated);
  return (int)sizeof(float) * (kQT * hd + kQT + kQT * Lk);
}

int hr_onepass_max_smem_bytes() { return kMaxSmem; }

// q/k/v/out: element (b, h, i, d) at b*sb + h*sh + i*sl + d, each row 16-byte
// aligned; dtype (kDtBf16, kDtF32, kDtF16) is the type of q/k/v/out/pos.
// kbias [B, Lk] fp32 additive. gate [B, H, Lq] fp32 and pos [H, Lq, Lk], or
// both NULL for no gate. Needs hd % 8 == 0 and hd <= 256 (the CUDA-core
// kernel's block of 4*hd or 2*hd threads). Runs the instance of
// onepass_instance: bf16 and fp16 onepass_mma_kernel or onepass_wide_kernel,
// fp32 attn_tf32_kernel or attn_tf32_wide_kernel, or onepass_attn_kernel on
// CUDA cores (the gate off 64 and 96), which cuda_cores = 1 takes at any
// head dim (to time it beside the tile kernels).
int hr_onepass_attention(int dtype, const void* q, int q_sb, int q_sh, int q_sl, const void* k,
                         int k_sb, int k_sh, int k_sl, const void* v, int v_sb, int v_sh,
                         int v_sl, int B, int H, int Lq, int Lk, int hd, float scale,
                         const void* kbias, const void* gate, const void* pos, void* out,
                         int o_sb, int o_sh, int o_sl, int cuda_cores, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  const bool gated = gate != nullptr;
  const int inst = cuda_cores ? 0 : onepass_instance(hd, gated);
  if (inst && dtype == kDtF32) {
    Tf32Args a{};
    a.q = static_cast<const float*>(q), a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.q_sb = q_sb, a.q_sh = q_sh, a.q_sl = q_sl, a.k_sb = k_sb, a.k_sh = k_sh, a.k_sl = k_sl;
    a.v_sb = v_sb, a.v_sh = v_sh, a.v_sl = v_sl, a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd;
    a.scale = scale, a.kbias = static_cast<const float*>(kbias);
    a.gate = static_cast<const float*>(gate);
    a.pos = static_cast<const float*>(pos), a.out = static_cast<float*>(out);
    a.o_sb = o_sb, a.o_sh = o_sh, a.o_sl = o_sl;
    if (gated && hd == 64) launch_attn_tf32<64, true, false>(a, B, s);
    else if (gated) launch_attn_tf32<96, true, false>(a, B, s);
    else launch_attn_tf32_tile<false>(a, B, s);
    return (int)cudaGetLastError();
  }
  if (inst) {
    if (dtype == kDtF16)
      launch_mma<__half>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                         Lq, Lk, hd, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, s);
    else
      launch_mma<__nv_bfloat16>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl,
                                B, H, Lq, Lk, hd, scale, kbias, gate, pos, out, o_sb, o_sh,
                                o_sl, s);
    return (int)cudaGetLastError();
  }
  const int smem = hr_onepass_smem_bytes(dtype, Lk, hd, gated, 1);
  if (dtype == kDtF32)
    launch<float>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk,
                  hd, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, smem, s);
  else if (dtype == kDtF16)
    launch<__half>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk,
                   hd, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, smem, s);
  else
    launch<__nv_bfloat16>(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H,
                          Lq, Lk, hd, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, smem, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
