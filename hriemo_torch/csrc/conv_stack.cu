// WavLM feature-encoder conv stack (hriemo_torch/ops/conv_stack.py), three
// kernels over waveforms of type T (bf16 or fp32) and 512 channels:
//
//   stats: [B, 2, 512] fp32 sum and sum of squares of conv0 (k10 s5) over
//          its n0 = (Tw - 10) / 5 + 1 valid rows;
//   K1:    conv0, GroupNorm (mean = s/n0, var = s2/n0 - mean^2, no clamp),
//          GELU, then conv1..3 (k3 s2) -> conv3 rows [B, t3, 512] in T;
//   K2:    conv4 (k3 s2), conv5 and conv6 (k2 s2) -> [B, t_out, 512] in T.
//
// Replace hriemo/ops/conv_stack.py::_stats_kernel, _k1_kernel and
// _k2_kernel (pallas_calls at :228, :243, :263). Numerics follow them: fp32
// sums, GroupNorm and GELU (tanh or erf) in fp32, every conv's output
// rounded to T before the next conv, conv0's output normalised before any
// rounding. Weights come tap-major, [K, 512 out, 512 in] in T (conv0:
// [512, 10]).
//
// Design.
// - K1 (conv_stack_k1) is four launches: conv0 + GroupNorm + GELU on CUDA
//   cores over all n0 rows, the same arithmetic per element as the TPU
//   kernel, written [B, n0, 512] in T (conv0 has one input channel and 10
//   taps: 1.3% of the stack's operations); then conv1, conv2 and conv3,
//   each one large-tile GEMM of csrc/float_wgmma.cuh over a strided view of
//   its input (output row r of batch element b is the 3*512 contiguous
//   elements from input row 2r on: lda = 2*512, K = 3*512, tap k of the
//   tap-major weights read as they are, no copy; batch on the grid's z
//   axis, rows past t_i zero-filled by the copy and never stored). conv1
//   and conv2 go to workspaces from the caching allocator, conv3 straight
//   into out. The TPU kernel kept conv0 on chip; here it makes a round trip
//   through device memory (262 MB in bf16, 524 MB in fp32 at 8 x 10 s:
//   about 0.16 / 0.31 ms at 3.35 TB/s), and in exchange every weight tile
//   staged in shared memory feeds 128 output rows with no halo rows
//   recomputed, where the first version's blocks of 8 conv3 frames
//   recomputed 71 conv0, 35 conv1 and 17 conv2 rows and streamed each
//   conv's 1.5 MB of weights from L2 (about 19 GB of L2 reads at 8 x 10 s).
// - K2 keeps the first version: a block takes kF = 8 output frames and the
//   rows they need (halo rows are recomputed): 65 conv3 rows and 32 conv4
//   rows in shared memory, weights streamed from L2 by each warp for its 64
//   output channels (mma.sync in bf16, CUDA-core FMAs in fp32,
//   float_gemm.cuh). Reads are bounded: rows past t3 are zeros, and rows
//   past the true lengths only feed frames that are not stored.
// - The stats kernel loops over all rows of a (batch, 32-channel) chunk in
//   one block and adds its eight row groups in a fixed order, so the sums
//   (and K1's output) are the same on every run; no atomics.
//
// What bounds them (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// hriemo_torch/utils/float_gemm_variants.py, PERF.md §6): K1 at 8 x 10 s takes
// 1.52 ms in bf16 and 5.57 in fp32 (the first version 4.05 and 16.84): the
// three conv GEMMs 1.20 / 5.23 ms, 30% / 41% of their tensor-core bound (0.36
// ms in bf16, 2.14 in fp32 as three TF32 products), held back by the GEMM's
// pipeline (csrc/float_wgmma.cuh); the conv0 pass 0.31 / 0.30 ms, the CUDA
// cores' GroupNorm and accurate GELU per element more than its bytes. K2 and
// the stats pass, not redesigned yet: L2 weight reads per 8-frame block (K2)
// and one block per (batch, 32 channels) over all rows (stats).
#include "float_gemm.cuh"
#include "float_wgmma.cuh"

namespace hr {

constexpr int kC = 512;            // channels of every conv
constexpr int kF = 8;              // output frames of a K2 block (conv6)
constexpr int kConvThreads = 256;  // 8 warps, 64 output channels each
constexpr int kC0Rows = 64;        // conv0 rows of a K1 conv0 block
constexpr int kC0Samples = 5 * (kC0Rows - 1) + 10;
// K2 rows a tile needs: conv3, conv4, conv5
constexpr int kQ3 = 8 * kF + 1, kQ4 = 4 * kF, kQ5 = 2 * kF;

// Row stride (elements) of the shared activation rows. bf16: 1056 bytes,
// so 16-byte reads of rows two apart (conv taps of neighbouring output rows)
// fall in different banks; fp32 rows are read as broadcasts.
template <typename T> struct ConvLd;
template <> struct ConvLd<__nv_bfloat16> { static constexpr int v = kC + 16; };
template <> struct ConvLd<float> { static constexpr int v = kC; };

template <typename T> constexpr size_t k2_smem() {
  return sizeof(T) * (size_t)(kQ3 + kQ4) * ConvLd<T>::v;
}
static_assert(k2_smem<float>() <= kMaxDynSmem, "smem");

// GELU, rounded to T, stored for rows r < rows (row stride ld).
template <typename T>
struct GeluStore {
  T* base;
  int rows, ld, fast;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) const {
    if (r < rows) store2(base + (size_t)r * ld + c, gelu(v0, fast), gelu(v1, fast));
  }
};

// Output rows r < ROWS of a stride-2 conv with KT taps: the sum over taps k
// and input channels i of in[2r + k][i] * w[k][o][i], handed to
// st(r, o, v(o), v(o + 1)). `in` holds IN_ROWS rows in shared memory.
// bf16: mma.sync over m-tiles of 16 rows; the last m-tile's padding rows
// read a valid row and are never stored.
template <int KT, int ROWS, int IN_ROWS, class St>
__device__ __forceinline__ void conv_layer(const __nv_bfloat16* in, const __nv_bfloat16* w,
                                           const St& st) {
  constexpr int MT = (ROWS + 15) / 16, LD = ConvLd<__nv_bfloat16>::v;
  static_assert(2 * (ROWS - 1) + KT - 1 < IN_ROWS, "conv reads past its input rows");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = warp * 64;
  float acc[MT][8][4] = {};
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const __nv_bfloat16* a[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mt][h] = in + min(2 * (16 * mt + 8 * h + g) + k, IN_ROWS - 1) * LD + 8 * t;
    mma_panel<MT, 8>(acc, a, w + (size_t)k * kC * kC + (size_t)(n0 + g) * kC + 8 * t, kC, kC);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      st(16 * mt + g, c, acc[mt][j][0], acc[mt][j][1]);
      st(16 * mt + g + 8, c, acc[mt][j][2], acc[mt][j][3]);
    }
}

// fp32: each lane owns output channels 64 w + 2 lane and +1, every row.
template <int KT, int ROWS, int IN_ROWS, class St>
__device__ __forceinline__ void conv_layer(const float* in, const float* w, const St& st) {
  static_assert(2 * (ROWS - 1) + KT - 1 < IN_ROWS, "conv reads past its input rows");
  const int c = (threadIdx.x >> 5) * 64 + 2 * (threadIdx.x & 31);
  float acc[ROWS][2] = {};
#pragma unroll 1
  for (int k = 0; k < KT; ++k)
    fma_panel<ROWS, 2>(acc, in + k * kC, 2 * kC, w + (size_t)k * kC * kC + (size_t)c * kC, kC,
                       kC);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) st(r, c, acc[r][0], acc[r][1]);
}

// One block per (32-channel chunk, batch element); warp w sums rows w, w+8,
// ..., then the eight partial sums are added in order.
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv_stats_kernel(const T* __restrict__ wave, int Tw, const T* __restrict__ w0, int n0,
                  float* __restrict__ out) {
  __shared__ float red[2][kConvThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane, b = blockIdx.y;
  float w[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) w[i] = load_f(w0 + c * 10 + i);
  const T* wv = wave + (size_t)b * Tw;
  float s = 0.f, q = 0.f;
  for (int r = warp; r < n0; r += kConvThreads / 32) {
    const T* p = wv + (size_t)5 * r;
    float x = 0.f;
#pragma unroll
    for (int i = 0; i < 10; ++i) x = fmaf(load_f(p + i), w[i], x);
    s = __fadd_rn(s, x);
    q = __fadd_rn(q, __fmul_rn(x, x));
  }
  red[0][warp][lane] = s;
  red[1][warp][lane] = q;
  __syncthreads();
  if (warp < 2) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kConvThreads / 32; ++i) v = __fadd_rn(v, red[warp][i][lane]);
    out[((size_t)b * 2 + warp) * kC + c] = v;
  }
}

// K1's first launch: conv0, GroupNorm (statistics from the stats kernel)
// and GELU of rows r0 .. r0 + kC0Rows - 1 of batch element b, stored in T.
// One block per (row tile, batch element); thread tid owns channels 2 tid
// and 2 tid + 1.
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv0_gn_kernel(const T* __restrict__ wave, int Tw, const float* __restrict__ stats,
                const T* __restrict__ w0, const float* __restrict__ gnw,
                const float* __restrict__ gnb, float inv_n, float eps, int fast, int n0,
                T* __restrict__ out) {
  __shared__ float zs[kC0Samples];  // the tile's wave samples
  const int tid = threadIdx.x, b = blockIdx.y, r0 = blockIdx.x * kC0Rows;
  const size_t s0 = (size_t)5 * r0;
  const T* wv = wave + (size_t)b * Tw;
  for (int i = tid; i < kC0Samples; i += kConvThreads)
    zs[i] = s0 + i < (size_t)Tw ? load_f(wv + s0 + i) : 0.f;

  const int c = 2 * tid;
  float w[2][10], mean[2], rstd[2], gw[2], gb[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int i = 0; i < 10; ++i) w[e][i] = load_f(w0 + (c + e) * 10 + i);
    mean[e] = __fmul_rn(stats[(size_t)b * 2 * kC + c + e], inv_n);
    const float var = __fadd_rn(__fmul_rn(stats[((size_t)b * 2 + 1) * kC + c + e], inv_n),
                                -__fmul_rn(mean[e], mean[e]));
    rstd[e] = __frsqrt_rn(__fadd_rn(var, eps));
    gw[e] = gnw[c + e];
    gb[e] = gnb[c + e];
  }
  __syncthreads();
  const int rows = min(kC0Rows, n0 - r0);
  T* o = out + ((size_t)b * n0 + r0) * kC + c;
  for (int r = 0; r < rows; ++r) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < 10; ++i) x = fmaf(zs[5 * r + i], w[e][i], x);
      x = __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(x, -mean[e]), rstd[e]), gw[e]), gb[e]);
      v[e] = gelu(x, fast);
    }
    store2(o + (size_t)r * kC, v[0], v[1]);
  }
}

// One block per (tile of kF conv6 frames, batch element).
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv_k2_kernel(const T* __restrict__ x3, int t3, const T* __restrict__ w4,
               const T* __restrict__ w5, const T* __restrict__ w6, int fast, int t_out,
               T* __restrict__ out) {
  constexpr int LD = ConvLd<T>::v;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q3 = reinterpret_cast<T*>(smem);  // conv3 rows, later conv5 rows
  T* q4 = q3 + kQ3 * LD;               // conv4 rows
  const int tid = threadIdx.x, b = blockIdx.y, f0 = blockIdx.x * kF, r0 = 8 * f0;
  for (int i = tid; i < kQ3 * (kC / 8); i += kConvThreads) {
    const int r = i / (kC / 8), c = (i - r * (kC / 8)) * 8;
    if (r0 + r < t3)
      copy8(q3 + r * LD + c, x3 + ((size_t)b * t3 + r0 + r) * kC + c);
    else
      zero8(q3 + r * LD + c);
  }
  __syncthreads();
  conv_layer<3, kQ4, kQ3>(q3, w4, GeluStore<T>{q4, kQ4, LD, fast});
  __syncthreads();
  conv_layer<2, kQ5, kQ4>(q4, w5, GeluStore<T>{q3, kQ5, LD, fast});
  __syncthreads();
  conv_layer<2, kF, kQ5>(q3, w6,
                         GeluStore<T>{out + ((size_t)b * t_out + f0) * kC, min(kF, t_out - f0), kC,
                                      fast});
}

template <typename T>
void launch_conv0(const void* wave, int B, int Tw, const void* stats, const void* w0,
                  const void* gnw, const void* gnb, float inv_n, float eps, int fast, int n0,
                  void* out, cudaStream_t s) {
  conv0_gn_kernel<T><<<dim3((n0 + kC0Rows - 1) / kC0Rows, B), kConvThreads, 0, s>>>(
      static_cast<const T*>(wave), Tw, static_cast<const float*>(stats),
      static_cast<const T*>(w0), static_cast<const float*>(gnw), static_cast<const float*>(gnb),
      inv_n, eps, fast, n0, static_cast<T*>(out));
}

template <typename T>
void launch_k2(const void* x3, int B, int t3, const void* w4, const void* w5,
                      const void* w6, int fast, int t_out, void* out, cudaStream_t s) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaFuncSetAttribute(conv_k2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)k2_smem<T>());
    attr_set = true;
  }
  conv_k2_kernel<T><<<dim3((t_out + kF - 1) / kF, B), kConvThreads, k2_smem<T>(), s>>>(
      static_cast<const T*>(x3), t3, static_cast<const T*>(w4), static_cast<const T*>(w5),
      static_cast<const T*>(w6), fast, t_out, static_cast<T*>(out));
}

}  // namespace hr

using namespace hr;

extern "C" {

// wave [B, Tw] and w0 [512, 10]: fp32 (fp32 != 0) or bf16; out [B, 2, 512]
// fp32; n0 = (Tw - 10) / 5 + 1 >= 1.
int hr_conv_stats(int fp32, const void* wave, int B, int Tw, const void* w0, int n0, void* out,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kC / 32, B);
  if (B > 0) {
    if (fp32)
      conv_stats_kernel<float><<<grid, kConvThreads, 0, s>>>(
          static_cast<const float*>(wave), Tw, static_cast<const float*>(w0), n0,
          static_cast<float*>(out));
    else
      conv_stats_kernel<__nv_bfloat16><<<grid, kConvThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(wave), Tw, static_cast<const __nv_bfloat16*>(w0), n0,
          static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// K1's conv0 + GroupNorm + GELU: wave [B, Tw]; stats [B, 2, 512] fp32; w0
// [512, 10]; gnw/gnb [512] fp32; out [B, n0, 512]; T fp32 (fp32 != 0) or bf16.
int hr_conv0_gn(int fp32, const void* wave, int B, int Tw, const void* stats, const void* w0,
                const void* gnw, const void* gnb, float inv_n, float eps, int fast_gelu, int n0,
                void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && n0 > 0) {
    if (fp32)
      launch_conv0<float>(wave, B, Tw, stats, w0, gnw, gnb, inv_n, eps, fast_gelu, n0, out, s);
    else
      launch_conv0<__nv_bfloat16>(wave, B, Tw, stats, w0, gnw, gnb, inv_n, eps, fast_gelu, n0,
                                  out, s);
  }
  return (int)cudaGetLastError();
}

// K1's stride-2 convs: out [B, M, 512] = T(gelu(rows . taps)), where row r of
// batch element b is the K = kt * 512 elements at x + b * x_batch + r * lda
// (ops/conv_stack.py conv_rows: x_batch = t_in * 512, lda = 2 * 512) and
// taps [kt, 512, 512] tap-major; T fp32 (fp32 != 0) or bf16.
int hr_conv_s2(int fp32, const void* x, long long x_batch, int lda, int K, const void* taps,
               int B, int M, int fast_gelu, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FloatGemmArgs g{};
  g.a = x, g.a_batch = x_batch, g.lda = lda;
  g.w = taps, g.w_tap = (long long)kC * kC, g.ldw = kC, g.ktap = kC;
  g.M = M, g.N = kC, g.K = K;
  g.out = out, g.out_batch = (long long)M * kC, g.ldo = kC, g.fast = fast_gelu;
  if (fp32)
    launch_float_gemm<float, kFepGelu>(g, B, s);
  else
    launch_float_gemm<__nv_bfloat16, kFepGelu>(g, B, s);
  return (int)cudaGetLastError();
}

// x3 [B, t3, 512]; w4 [3, 512, 512]; w5/w6 [2, 512, 512]; out [B, t_out, 512].
int hr_conv_k2(int fp32, const void* x3, int B, int t3, const void* w4, const void* w5,
               const void* w6, int fast_gelu, int t_out, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && t_out > 0) {
    if (fp32)
      launch_k2<float>(x3, B, t3, w4, w5, w6, fast_gelu, t_out, out, s);
    else
      launch_k2<__nv_bfloat16>(x3, B, t3, w4, w5, w6, fast_gelu, t_out, out, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
