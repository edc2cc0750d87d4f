// The streaming attention core in bf16 and fp16 on wgmma warpgroups
// (hriemo_torch/ops/flash_attention.py streaming_launch, for the shapes that
// ops/flash_attention.py streaming_kernel gives to "wgmma" or
// "wgmma_split"): csrc/streaming_wgmma.cuh's streaming_wgmma_kernel (see
// there for the function, the design and what bounds it), replacing
// hriemo/ops/flash_attention_pallas.py::_flash_kernel. A library of its own
// so that its instances build beside the other sources.
#include "streaming_wgmma.cuh"

using namespace hr;

extern "C" {

// The tile head dim of the instance of `kernel` (1: 128 query rows a block,
// at hd 8-128; 2: the O split, 64 rows a block, at hd 104-256) that serves
// head dim hd in dtype (kDtBf16 or kDtF16), or 0 where that kernel takes
// none.
int hr_streaming_wgmma_instance(int hd, int dtype, int kernel) {
  return dtype == kDtBf16 || dtype == kDtF16 ? streaming_wgmma_instance(hd, kernel) : 0;
}

// q/k/v/out: element (b, h, i, d) at b*sb + h*sh + i*sl + d (elements), each
// stride a multiple of 8 elements and each pointer 16-byte aligned; dtype
// kDtBf16 or kDtF16 is the type of q/k/v/out; kbias [B, Lk] fp32 additive.
// kernel: 1 or 2, as hr_streaming_wgmma_instance. Refuses a shape that the
// kernel has no instance for, or Lk < 1, with cudaErrorInvalidValue, as it
// does where a tensor map cannot be made; else returns cudaGetLastError()
// after the launch.
int hr_streaming_wgmma(int dtype, const void* q, int q_sb, int q_sh, int q_sl, const void* k,
                       int k_sb, int k_sh, int k_sl, const void* v, int v_sb, int v_sh, int v_sl,
                       int B, int H, int Lq, int Lk, int hd, float scale, const void* kbias,
                       void* out, int o_sb, int o_sh, int o_sl, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hr_streaming_wgmma_instance(hd, dtype, kernel) == 0 || Lk < 1 || kbias == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  auto fill = [&](auto* a) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(a->q)>>;
    a->q = static_cast<const T*>(q), a->k = static_cast<const T*>(k);
    a->v = static_cast<const T*>(v);
    a->q_sb = q_sb, a->q_sh = q_sh, a->q_sl = q_sl, a->k_sb = k_sb, a->k_sh = k_sh;
    a->k_sl = k_sl, a->v_sb = v_sb, a->v_sh = v_sh, a->v_sl = v_sl;
    a->H = H, a->Lq = Lq, a->Lk = Lk, a->hd = hd, a->scale = scale;
    a->kbias = static_cast<const float*>(kbias), a->out = static_cast<T*>(out);
    a->o_sb = o_sb, a->o_sh = o_sh, a->o_sl = o_sl;
  };
  if (dtype == kDtF16) {
    OnepassArgsT<__half> a{};
    fill(&a);
    return launch_streaming_wgmma(a, B, kernel, s);
  }
  OnepassArgsT<__nv_bfloat16> a{};
  fill(&a);
  return launch_streaming_wgmma(a, B, kernel, s);
}

}  // extern "C"
