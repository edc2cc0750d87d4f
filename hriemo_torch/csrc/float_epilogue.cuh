// The epilogues and arguments that the port's two float GEMMs share:
// csrc/float_wgmma.cuh (the cp.async pipeline, bf16 and fp32 3xTF32) and
// csrc/tma_gemm.cuh (bf16 on TMA and persistent warpgroups). epi_store runs
// on two adjacent fp32 sums in the plain versions' rounding order, in IEEE
// operations only (no fast math).
#pragma once

#include "common.cuh"

namespace hr {

enum FloatEpilogue : int {
  kFepBiasGelu = 0,   // T out = T(gelu(acc + bias))          the FFN's hidden h
  kFepResidBias = 1,  // fp32 out = (resid + acc) + bias       the FFN's y
  kFepGelu = 2,       // T out = T(gelu(acc))                  the convs
};

struct FloatGemmArgs {
  const void* a;         // A [M, K] of T, rows lda apart; batch z at a + z * a_batch
  long long a_batch;
  int lda;
  const void* w;         // W of T: K-element k of column n at w + (k/ktap)*w_tap + n*ldw + k%ktap
  long long w_tap;
  int ldw, ktap;
  int M, N, K;
  const float* bias;     // [N] (kFepBiasGelu, kFepResidBias)
  const void* resid;     // [M, ldr] of T (kFepResidBias)
  int ldr;
  void* out;             // row m of batch z at out + z * out_batch + m * ldo
  long long out_batch;
  int ldo;
  int fast;              // tanh GELU, else erf
};

// The epilogue of two adjacent columns n, n + 1 of row m; o is their offset
// in the output. FAST: the GELU's form, 1 tanh, 0 erf, -1 g.fast's.
template <int EPI, typename T, int FAST = -1>
__device__ __forceinline__ void epi_store(const FloatGemmArgs& g, size_t o, int m, int n,
                                          float v0, float v1) {
  if (EPI == kFepResidBias) {
    const T* r = static_cast<const T*>(g.resid) + (size_t)m * g.ldr + n;
    store2(static_cast<float*>(g.out) + o, __fadd_rn(__fadd_rn(load_f(r), v0), g.bias[n]),
           __fadd_rn(__fadd_rn(load_f(r + 1), v1), g.bias[n + 1]));
    return;
  }
  if (EPI == kFepBiasGelu) {
    v0 = __fadd_rn(v0, g.bias[n]);
    v1 = __fadd_rn(v1, g.bias[n + 1]);
  }
  const int fast = FAST < 0 ? g.fast : FAST;
  store2(static_cast<T*>(g.out) + o, gelu(v0, fast), gelu(v1, fast));
}

}  // namespace hr
