// Fused float FFN block (hriemo_torch/ops/fused_ffn.py ffn_block_bf16):
//
//   h   = T(gelu(x . W1^T + b1))      fp32 sums, fp32 bias and GELU, rounded to T
//   y   = (x + h . W2^T) + b2         fp32
//   out = T(LayerNorm(y) * g + b)     fp32 statistics
//
// over x [M, D] of type T (bf16 or fp32), torch-layout weights W1 [F, D]
// and W2 [D, F] of type T, fp32 biases and LayerNorm parameters.
//
// Replaces hriemo/ops/fused_ffn.py::_kernel_bf16 (pallas_call at :192),
// whose point is one pass: the [M, F] hidden activation never goes to
// device memory. Here one block owns BM rows (16 in bf16, 8 in fp32) and
// keeps them whole in shared memory: the x tile, the hidden panel
// [BM, F] in T (rounded where the TPU kernel rounds it, after GELU) and
// the fp32 y panel [BM, D] for the LayerNorm (174 KB in bf16 at 768/3072).
// Eight warps take 32-column slices of each product in turn:
//   1. h slices: x panel (shared) . W1 slice (streamed from L2), bias, GELU;
//   2. y slices: h panel (shared) . W2 slice, residual and bias;
//   3. LayerNorm, one warp per row.
// bf16 products run on mma.sync (float_gemm.cuh), fp32 ones on CUDA-core
// FMAs. What bounds it on the card: every block streams both weight
// matrices from L2 (9.4 MB in bf16 at 768/3072), so at BM = 16 the L2 reads
// (M/16 x 9.4 MB) and not the tensor cores set the time; larger row tiles
// need the hidden panel split across blocks or kept in registers (later
// work).
#include "float_gemm.cuh"

namespace hr {

constexpr int kFfnThreads = 256, kFfnWarps = kFfnThreads / 32;
constexpr int kSlice = 32;  // output columns of one warp task

template <typename T> struct FfnRows;
template <> struct FfnRows<__nv_bfloat16> { static constexpr int BM = 16; };
template <> struct FfnRows<float> { static constexpr int BM = 8; };

// Row stride (elements) of the shared x and h panels: n plus padding so
// that 16-byte reads of rows g and g+1 by one quarter-warp fall in
// different banks (stride = 64 bytes mod 128 for bf16).
__host__ __device__ constexpr int ffn_ld(int n) { return n + (96 - n % 64) % 64; }

template <typename T>
__host__ __device__ constexpr size_t ffn_smem(int D, int F) {
  return (size_t)FfnRows<T>::BM * (sizeof(T) * (ffn_ld(D) + ffn_ld(F)) + sizeof(float) * D);
}

// acc[r] over one 32-column slice: bf16 lanes hold the mma fragment layout
// (rows g and g+8, columns 8j + 2t and +1), fp32 lanes one column and all
// BM rows. `emit(row, col, v)` consumes each sum.
template <class Emit>
__device__ __forceinline__ void slice_product(const __nv_bfloat16* a, int lda,
                                              const __nv_bfloat16* w, int K, int n0,
                                              const Emit& emit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[1][4][4] = {};
  const __nv_bfloat16* ar[1][2] = {{a + g * lda + 8 * t, a + (g + 8) * lda + 8 * t}};
  mma_panel<1, 4>(acc, ar, w + (size_t)(n0 + g) * K + 8 * t, K, K);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) emit(g + 8 * (e >> 1), n0 + 8 * j + 2 * t + (e & 1), acc[0][j][e]);
}

template <class Emit>
__device__ __forceinline__ void slice_product(const float* a, int lda, const float* w, int K,
                                              int n0, const Emit& emit) {
  constexpr int BM = FfnRows<float>::BM;
  const int lane = threadIdx.x & 31;
  float acc[BM][1] = {};
  fma_panel<BM, 1>(acc, a, lda, w + (size_t)(n0 + lane) * K, K, K);
#pragma unroll
  for (int r = 0; r < BM; ++r) emit(r, n0 + lane, acc[r][0]);
}

template <typename T>
__global__ void __launch_bounds__(kFfnThreads)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ lg,
           const float* __restrict__ lb, int M, int D, int F, float eps, int fast,
           T* __restrict__ out) {
  constexpr int BM = FfnRows<T>::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = ffn_ld(D), ldh = ffn_ld(F);
  T* xs = reinterpret_cast<T*>(smem);                    // [BM][ldx]
  T* hs = xs + BM * ldx;                                  // [BM][ldh]
  float* ys = reinterpret_cast<float*>(hs + BM * ldh);    // [BM][D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;

  for (int i = tid; i < BM * D / 8; i += kFfnThreads) {
    const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
    if (m0 + r < M)
      copy8(xs + r * ldx + c, x + (size_t)(m0 + r) * D + c);
    else
      zero8(xs + r * ldx + c);  // rows past M: computed, never stored
  }
  __syncthreads();

  for (int s = warp; s < F / kSlice; s += kFfnWarps)
    slice_product(xs, ldx, w1, D, s * kSlice, [&](int r, int c, float v) {
      hs[r * ldh + c] = from_f<T>(gelu(__fadd_rn(v, b1[c]), fast));
    });
  __syncthreads();

  for (int s = warp; s < D / kSlice; s += kFfnWarps)
    slice_product(hs, ldh, w2, F, s * kSlice, [&](int r, int c, float v) {
      ys[r * D + c] = __fadd_rn(__fadd_rn(load_f(xs + r * ldx + c), v), b2[c]);
    });
  __syncthreads();

  for (int r = warp; r < BM; r += kFfnWarps) {
    if (m0 + r >= M) continue;
    const float* yr = ys + r * D;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum += yr[c];
    const float mean = __fdiv_rn(warp_sum(sum), (float)D);
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __fadd_rn(yr[c], -mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(warp_sum(sq), (float)D);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    T* orow = out + (size_t)(m0 + r) * D;
    for (int c = lane; c < D; c += 32) {
      const float n = __fmul_rn(__fadd_rn(yr[c], -mean), rstd);
      orow[c] = from_f<T>(__fadd_rn(__fmul_rn(n, lg[c]), lb[c]));
    }
  }
}

template <typename T>
void launch_ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                const void* lg, const void* lb, int M, int D, int F, float eps, int fast,
                void* out, cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    attr_set = true;
  }
  const int BM = FfnRows<T>::BM;
  ffn_kernel<T><<<(M + BM - 1) / BM, kFfnThreads, ffn_smem<T>(D, F), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const float*>(lg),
      static_cast<const float*>(lb), M, D, F, eps, fast, static_cast<T*>(out));
}

}  // namespace hr

using namespace hr;

extern "C" {

// Shared memory one block needs; the caller refuses widths above the limit.
int hr_ffn_smem_bytes(int fp32, int D, int F) {
  return (int)(fp32 ? ffn_smem<float>(D, F) : ffn_smem<__nv_bfloat16>(D, F));
}

int hr_ffn_max_smem_bytes() { return kMaxDynSmem; }

// x/out [M, D], w1 [F, D], w2 [D, F]: fp32 (fp32 != 0) or bf16, contiguous,
// 16-byte aligned; b1 [F], b2/lg/lb [D] fp32. D and F multiples of 32.
int hr_ffn_block(int fp32, const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, const void* lg, const void* lb, int M, int D, int F, float eps,
                 int fast_gelu, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    if (fp32)
      launch_ffn<float>(x, w1, b1, w2, b2, lg, lb, M, D, F, eps, fast_gelu, out, s);
    else
      launch_ffn<__nv_bfloat16>(x, w1, b1, w2, b2, lg, lb, M, D, F, eps, fast_gelu, out, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
