// Shared device helpers for the port's kernels (sm_90a, no fast math).
//
// Every floating-point step that the JAX reference rounds separately is
// written with the explicit round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fdiv_rn) so that nvcc cannot contract it into an FMA: the
// plain PyTorch versions round after every multiply and add, and so do the
// Pallas kernels they mirror.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hr {

// The reference's additive mask logit (hriemo/core/masking.py NEG_INF).
constexpr float kNegInf = -1e9f;

// Element type of the float attention kernels' q/k/v/out, as the C entry
// points take it (hriemo_torch/ops/_cuda.py DTYPE_CODES).
enum DType : int { kDtBf16 = 0, kDtF32 = 1, kDtF16 = 2 };

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return bf2f(*p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(*p); }

// x stored as T (bf16, fp16: round to nearest even; fp32: x itself)
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return f2bf(x); }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to T and widened back, as a cast to T and back in the reference
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float x) { return bf2f(f2bf(x)); }
template <> __device__ __forceinline__ float round_as<__half>(float x) {
  return __half2float(__float2half_rn(x));
}
template <> __device__ __forceinline__ float round_as<float>(float x) { return x; }

// Eight consecutive elements of a row as fp32; p must be 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The kernels' per-row int8 quantization (hriemo/ops/fused_ffn.py:64-68,
// ops/fused_ffn.py quant_rows): the scale of a row whose largest |value| is
// amax, max(amax, 1e-8) * (1/127), and one value's code, round half to even
// of an IEEE quotient, clipped to +-127.
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, (float)1e-8), (float)(1.0 / 127.0));
}
__device__ __forceinline__ int8_t quant_code(float v, float scale) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, of which the first `bytes` (0..16) come from
// src and the rest are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// 4 bytes (one fp32), or a zero when bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction; `red` is 32 floats of shared memory. Every thread
// gets the result. blockDim.x must be a multiple of 32.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  // 0 is neutral for both uses: sums, and maxima of absolute values
  float r = lane < nwarps ? red[lane] : 0.f;
  if (warp == 0) {
    r = kMax ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  return red[0];
}

// The tanh GELU of hriemo/ops/fused_ffn.py::_gelu(fast=True), operation
// for operation: 0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x))).
__device__ __forceinline__ float gelu_tanh(float x) {
  float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// The exact GELU of _gelu(fast=False): 0.5 * x * (1 + erf(x / sqrt(2))).
__device__ __forceinline__ float gelu_erf(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erff(__fdiv_rn(x, 1.4142135623730951f))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float gelu(float x, int fast) { return fast ? gelu_tanh(x) : gelu_erf(x); }

// Two adjacent columns, rounded to T.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(__half* p, float v0, float v1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

}  // namespace hr
