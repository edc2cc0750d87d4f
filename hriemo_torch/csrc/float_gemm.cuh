// Warp-level float GEMM pieces of the conv stack's K2 (csrc/conv_stack.cu
// conv_layer), their only GEMM user: an activation panel in shared memory
// times a weight panel read from device memory (L2) with the reduction axis
// contiguous, fp32 sums. (The float FFN and K1 run the large-tile GEMM of
// csrc/float_wgmma.cuh; the bf16 attention tiles, csrc/attention_tiles.cuh,
// take mma_bf16 from here.)
//
// bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Each lane loads 16
// bytes (8 consecutive channels) of a weight row and of an activation row
// per 32-channel step and feeds them to two k16 steps. Within a 32-channel
// step the channel order differs from the k order of the instruction's
// fragment layout, but A and B use the same order, so the product sums the
// same terms (in another order, which fp32 allows).
//
// fp32: CUDA-core FMAs (no TF32). Each lane owns NC output columns and
// every row of the panel; activation reads are shared-memory broadcasts.
#pragma once

#include "common.cuh"

namespace hr {

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 lds16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[mt][j] += A[rows of m-tile mt] . W[rows of n-tile j]^T over K channels.
// a[mt][0] / a[mt][1]: this lane's activation rows g and g+8 of m-tile mt,
// already offset by 8*t channels (shared memory, 16-byte aligned). w: this
// lane's weight row g of n-tile 0, offset by 8*t channels; n-tile j starts
// 8*j rows further (ldw elements a row). K is a multiple of 32. The next
// step's weights are loaded before this step's products.
template <int MT, int NT>
__device__ __forceinline__ void mma_panel(float (&acc)[MT][NT][4],
                                          const __nv_bfloat16* (&a)[MT][2],
                                          const __nv_bfloat16* w, int ldw, int K) {
  uint4 b[NT], bn[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    b[j] = ldg16(w + (size_t)j * 8 * ldw);
    bn[j] = b[j];
  }
  for (int k0 = 0; k0 < K; k0 += 32) {
    if (k0 + 32 < K) {
#pragma unroll
      for (int j = 0; j < NT; ++j) bn[j] = ldg16(w + (size_t)j * 8 * ldw + k0 + 32);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 lo = lds16(a[mt][0] + k0), hi = lds16(a[mt][1] + k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_bf16(acc[mt][j], lo.x, hi.x, lo.y, hi.y, b[j].x, b[j].y);
        mma_bf16(acc[mt][j], lo.z, hi.z, lo.w, hi.w, b[j].z, b[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = bn[j];
  }
}

// acc[r][j] += sum_k A[r][k] * W[j][k], fp32 FMAs over K channels (a
// multiple of 8). a: row 0 of the activation panel (shared memory), rows
// a_stride elements apart; w: this lane's first weight row (device memory),
// its j-th row ldw elements further.
template <int R, int NC>
__device__ __forceinline__ void fma_panel(float (&acc)[R][NC], const float* a, int a_stride,
                                          const float* w, int ldw, int K) {
  for (int k0 = 0; k0 < K; k0 += 8) {
    float4 p[NC][2];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      p[j][0] = ldg4(w + (size_t)j * ldw + k0);
      p[j][1] = ldg4(w + (size_t)j * ldw + k0 + 4);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x0 = lds4(a + r * a_stride + k0), x1 = lds4(a + r * a_stride + k0 + 4);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float s = acc[r][j];
        s = fmaf(x0.x, p[j][0].x, s);
        s = fmaf(x0.y, p[j][0].y, s);
        s = fmaf(x0.z, p[j][0].z, s);
        s = fmaf(x0.w, p[j][0].w, s);
        s = fmaf(x1.x, p[j][1].x, s);
        s = fmaf(x1.y, p[j][1].y, s);
        s = fmaf(x1.z, p[j][1].z, s);
        s = fmaf(x1.w, p[j][1].w, s);
        acc[r][j] = s;
      }
    }
  }
}

// Eight consecutive elements (16-byte aligned), copied or zeroed.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint4*>(dst) = ldg16(src);
}
__device__ __forceinline__ void copy8(float* dst, const float* src) {
  reinterpret_cast<float4*>(dst)[0] = ldg4(src);
  reinterpret_cast<float4*>(dst)[1] = ldg4(src + 4);
}
__device__ __forceinline__ void zero8(__nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void zero8(float* dst) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// H100 dynamic shared memory a block may opt in to.
constexpr int kMaxDynSmem = 227 * 1024;

}  // namespace hr
