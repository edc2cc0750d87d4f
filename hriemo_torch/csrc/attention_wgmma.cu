// The float route's one-pass attention core on wgmma warpgroups
// (hriemo_torch/ops/wavlm_attention.py onepass_launch, for the shapes that
// ops/wavlm_attention.py onepass_kernel gives to "wgmma" or "wgmma_sweeps"):
//
//   s   = (q . k^T) * scale  [+ gate[b,h,i] * pos[h,i,j]]  + kbias[b,j]   (fp32)
//   out = ((exp(s - max s) / sum) -> T) . v                               (fp32 sums -> T)
//
// over bf16 or fp16 q/k/v read in place through their batch, head and row
// strides, in the kernels of csrc/onepass_wgmma.cuh (see there for the
// design and what bounds them):
//   - the held form, onepass_wgmma_kernel, at head dims 64 and 96 up to 512
//     keys, gated or not: hriemo/ops/wavlm_attention.py::_kernel's shapes
//     (WavLM's gated core at every served bucket from 128 frames);
//   - the two sweeps, onepass_sweeps_kernel, up to 2048 keys at head dims
//     64 and 96, gated or not, and at 136-256 without the gate (the wide
//     tiles 192 and 256): WavLM at 1499 frames and
//     hriemo/ops/flash_attention_pallas.py::_onepass_kernel's shapes (Lq
//     and Lk from 1024, Lk up to 2048).
// The mma.sync kernels of csrc/wavlm_attention.cu keep every other shape.
// This is a library of its own so that its instances build beside the
// other sources.
#include "onepass_wgmma.cuh"

using namespace hr;

namespace {

enum WgKernel : int { kWgHeld = 1, kWgSweeps = 2 };

template <typename T>
int launch_float(int kernel, const void* q, int q_sb, int q_sh, int q_sl, const void* k,
                 int k_sb, int k_sh, int k_sl, const void* v, int v_sb, int v_sh, int v_sl,
                 int B, int H, int Lq, int Lk, int hd, float scale, const void* kbias,
                 const void* gate, const void* pos, void* out, int o_sb, int o_sh, int o_sl,
                 cudaStream_t s) {
  OnepassArgsT<T> a{};
  a.q = static_cast<const T*>(q), a.k = static_cast<const T*>(k), a.v = static_cast<const T*>(v);
  a.q_sb = q_sb, a.q_sh = q_sh, a.q_sl = q_sl, a.k_sb = k_sb, a.k_sh = k_sh, a.k_sl = k_sl;
  a.v_sb = v_sb, a.v_sh = v_sh, a.v_sl = v_sl, a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd;
  a.scale = scale, a.kbias = static_cast<const float*>(kbias);
  a.gate = static_cast<const float*>(gate);
  a.pos = static_cast<const T*>(pos), a.out = static_cast<T*>(out);
  a.o_sb = o_sb, a.o_sh = o_sh, a.o_sl = o_sl;
  const bool gated = gate != nullptr;
  if (kernel == kWgHeld)
    return gated ? launch_onepass_wgmma<kGateArray, true>(a, B, s)
                 : launch_onepass_wgmma<kNoGate, true>(a, B, s);
  return gated ? launch_onepass_sweeps<true>(a, B, s) : launch_onepass_sweeps<false>(a, B, s);
}

}  // namespace

extern "C" {

// The tile head dim of the instance of `kernel` (1: the held form, 2: the
// two sweeps) that serves head dim hd in dtype (kDtBf16 or kDtF16) with
// (gated = 1) or without a gate, or 0 where that kernel takes none.
int hr_onepass_wgmma_instance(int hd, int gated, int dtype, int kernel) {
  if (dtype != kDtBf16 && dtype != kDtF16) return 0;
  if (kernel == kWgHeld) return hd == 64 || hd == 96 ? hd : 0;
  return kernel == kWgSweeps ? sweeps_instance(hd, gated != 0) : 0;
}

// The longest key row each form takes: the held form's kWgMaxKeys, the two
// sweeps' kSwMaxKeys.
int hr_onepass_wgmma_max_keys(int kernel) {
  return kernel == kWgHeld ? kWgMaxKeys : kernel == kWgSweeps ? kSwMaxKeys : 0;
}

// q/k/v/out: element (b, h, i, d) at b*sb + h*sh + i*sl + d (elements), each
// stride a multiple of 8 elements and each pointer 16-byte aligned; dtype
// kDtBf16 or kDtF16 is the type of q/k/v/pos/out. kbias [B, Lk] fp32
// additive; gate [B, H, Lq] fp32 and pos [H, Lq, Lk], or both NULL.
// kernel: 1 the held form (hd 64 or 96, Lk <= 512), 2 the two sweeps (Lk <=
// 2048, hd 64 or 96, or 136-256 without the gate). Refuses any other shape
// with cudaErrorInvalidValue, as it does where a tensor map cannot be made;
// else returns cudaGetLastError() after the launch.
int hr_onepass_wgmma(int dtype, const void* q, int q_sb, int q_sh, int q_sl, const void* k,
                     int k_sb, int k_sh, int k_sl, const void* v, int v_sb, int v_sh, int v_sl,
                     int B, int H, int Lq, int Lk, int hd, float scale, const void* kbias,
                     const void* gate, const void* pos, void* out, int o_sb, int o_sh,
                     int o_sl, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hr_onepass_wgmma_instance(hd, gate != nullptr, dtype, kernel) == 0 || Lk < 1 ||
      Lk > hr_onepass_wgmma_max_keys(kernel) || kbias == nullptr ||
      (gate == nullptr) != (pos == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  const auto fn = dtype == kDtF16 ? &launch_float<__half> : &launch_float<__nv_bfloat16>;
  return fn(kernel, q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl, B, H, Lq, Lk,
            hd, scale, kbias, gate, pos, out, o_sb, o_sh, o_sl, s);
}

}  // extern "C"
