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
// - Every stride-2 conv, conv1..6, is one GEMM launch over a strided view of
//   its input: output row r of batch element b is the k*512 contiguous
//   elements from input row 2r on (K = k*512, tap j of the tap-major weights
//   read as it is, no copy). In bf16 it is hr_conv_s2_tma, the TMA GEMM of
//   csrc/tma_gemm.cuh (x's even and odd rows as two tensor maps bounded per
//   batch element, a producer warp's loads into an mbarrier ring, two
//   consumer warpgroups of 64 x 256, one persistent block an SM); in fp32
//   hr_conv_s2, the 3xTF32 large-tile GEMM of csrc/float_wgmma.cuh (lda =
//   2*512, batch on the grid's z axis, rows past the conv's length
//   zero-filled by the copy; its bf16 instance is kept as the yardstick of
//   the TMA GEMM). K1 is conv0's pass and three such launches, K2 three
//   (ops/conv_stack.py _conv_launches); their workspaces come from the
//   caching allocator. Every weight tile staged in shared memory feeds 128
//   output rows and no halo row is recomputed, where the first versions'
//   blocks of 8 output frames recomputed their halo rows and streamed every
//   conv's weights from L2, and ran fp32 on CUDA-core FMAs.
// - conv0 (one input channel, 10 taps: 1.3% of the stack's operations) runs
//   in K1's pass on CUDA cores, 10 FMAs an output in tap order; the pass
//   normalises it, applies GELU and writes [B, n0, 512] in T. The stats take
//   it on the tensor cores in bf16 (conv_stats_mma_kernel: the phase view's
//   rows against w0 padded to 16 taps, as the TPU kernel's _gemm), on CUDA
//   cores in fp32. The stats are a two-level sum in a fixed order: a block per (chunk of
//   kStatsRows rows, batch element) sums its chunk's rows in order for all
//   512 channels into a [B, chunks, 2, 512] fp32 workspace, then a second
//   launch adds the chunks in chunk order. No atomics: the sums, and K1's
//   output, have the same bits on every run. (Not the waveform's Gram
//   matrix, as group_norm_stats_from_waveform takes them: s2 taken from it
//   cancels when conv0's outputs are nearly constant, and K1's variance,
//   unclamped like the TPU kernel's, could go negative.)
//
// What bounds them (NVIDIA H100 80GB HBM3, 700 W; chip_conv_routes.py
// --gemms and chip_smoke.py, PERF.md sections 5-6):
// - The conv GEMMs, bound by bf16 tensor-core operations: at 1.25 s x 384
//   K1's three take 3.85 ms against a 2.14 ms bound (55%; the cp.async
//   pipeline 7.07), K2's 0.45 against 0.23 (51%; 0.86); at 8 x 10 s 0.59
//   and 0.074 against 0.36 and 0.038. The TMA GEMM's epilogue (the IEEE
//   GELU and the store), which no product overlaps, takes what its main
//   loop leaves (csrc/tma_gemm.cuh). fp32 at 8 x 10 s: K1 5.57 ms, K2 0.606,
//   the GEMMs at 41% and 38% of three TF32 products at 495 TFLOP/s.
// - conv0's pass (GroupNorm and the accurate GELU per element on CUDA cores)
//   and the stats: 1.48 and 0.14 ms at 1.25 s x 384, 0.31 and 0.031 at 8 x
//   10 s (bf16). The stats' CUDA-core kernel, 13 fp32 operations a conv0
//   output, took 0.44 and 0.082; on the tensor cores about two remain, and
//   they read 11% of their operations bound.
#include "float_wgmma.cuh"
#include "tma_gemm.cuh"

namespace hr {

constexpr int kC = 512;            // channels of every conv
constexpr int kConvThreads = 256;  // thread t owns channels 2t and 2t + 1
constexpr int kC0Rows = 64;        // conv0 rows of a K1 conv0 block
constexpr int kC0Samples = 5 * (kC0Rows - 1) + 10;
constexpr int kStatsRows = 256;    // conv0 rows of a stats chunk
constexpr int kStatsSamples = 5 * kStatsRows + 5;

// The stats' first level: conv0's per-channel sum and sum of squares over
// rows r0 .. r0 + kStatsRows - 1 (those below n0) of batch element b, into
// part[b][chunk][0 and 1][512]. One block per (chunk, batch element); each
// thread adds its rows in order, each row reusing the previous row's upper
// five samples as its lower five.
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv_stats_part_kernel(const T* __restrict__ wave, int Tw, const T* __restrict__ w0, int n0,
                       float* __restrict__ part) {
  __shared__ float zs[kStatsSamples];  // the chunk's wave samples
  const int tid = threadIdx.x, b = blockIdx.y, r0 = blockIdx.x * kStatsRows;
  const size_t s0 = (size_t)5 * r0;
  const T* wv = wave + (size_t)b * Tw;
  for (int i = tid; i < kStatsSamples; i += kConvThreads)
    zs[i] = s0 + i < (size_t)Tw ? load_f(wv + s0 + i) : 0.f;

  const int c = 2 * tid;
  float w[2][10];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < 10; ++i) w[e][i] = load_f(w0 + (c + e) * 10 + i);
  __syncthreads();
  const int rows = min(kStatsRows, n0 - r0);
  float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f}, lo[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) lo[i] = zs[i];
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float hi[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) hi[i] = zs[5 * r + 5 + i];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = 0.f;  // the taps in order, as K1's conv0 pass
#pragma unroll
      for (int i = 0; i < 5; ++i) x = fmaf(lo[i], w[e][i], x);
#pragma unroll
      for (int i = 0; i < 5; ++i) x = fmaf(hi[i], w[e][5 + i], x);
      s[e] = __fadd_rn(s[e], x);
      q[e] = __fadd_rn(q[e], __fmul_rn(x, x));
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) lo[i] = hi[i];
  }
  float* p = part + ((size_t)b * gridDim.x + blockIdx.x) * 2 * kC + c;
  store2(p, s[0], s[1]);
  store2(p + kC, q[0], q[1]);
}

// The stats' first level in bf16, conv0 on the tensor cores as the TPU
// kernel takes it (_gemm of the phase view [rows, 16] and w0 padded to 16
// taps): the same chunks and the same part[b][chunk][2][512] as
// conv_stats_part_kernel. The chunk's samples arrive by one bulk copy (the
// whole 16-byte chunks from the boundary at or below its first sample; a
// tail of the waveform's last chunk by a copy that fills zeros). Warp w owns
// channels 64w .. 64w + 63, eight n-tiles whose B fragments (w0's taps, k
// 10..15 zero) stay in registers; each 16-row tile of the chunk is one A
// fragment (row r's k-th element the sample 5r + k, rows past n0 zero) and
// eight mma.sync.m16n8k16 with fp32 sums. Each lane adds its outputs to its
// columns' s and q, row tile after row tile, its row g before g + 8; then
// the eight lanes that share columns are added by a fixed shuffle tree. No
// atomics: the same bits on every call. About two fp32 instructions an
// output remain (an add and an FMA), against the CUDA-core kernel's 13.
__global__ void __launch_bounds__(kConvThreads)
conv_stats_mma_kernel(const __nv_bfloat16* __restrict__ wave, int Tw, size_t total,
                      const __nv_bfloat16* __restrict__ w0, int n0, float* __restrict__ part) {
  // from the 16-byte boundary below the chunk's first sample: up to 7
  // samples before it, its 5 * kStatsRows + 5, and a zero-filled tail
  __shared__ __align__(128) uint16_t zs[(kStatsSamples + 7 + 7) / 8 * 8];
  __shared__ __align__(8) uint64_t bar_mem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, r0 = blockIdx.x * kStatsRows;
  const int rows = min(kStatsRows, n0 - r0);
  const size_t e0 = (size_t)b * Tw + (size_t)5 * r0, st = e0 & ~(size_t)7;
  const int off = (int)(e0 - st);
  const uint32_t bar = smem_addr(&bar_mem);
  if (tid == 0) {
    mbar_init(bar, 2);  // the expect_tx arrival and the tail copy's
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // the samples the chunk's rows read (within the waveform: row n0 - 1
    // ends at sample Tw - 1 at the latest), whole 16-byte chunks by one bulk
    // copy, and where the tensor ends within the last chunk, that chunk's
    // samples by a copy that fills zeros
    const size_t n = (size_t)off + 5 * rows + 5;
    size_t nb = (n + 7) & ~(size_t)7;
    if (st + nb > total) nb = (total - st) & ~(size_t)7;
    mbar_expect_tx(bar, (int)(2 * nb));
    if (nb > 0) bulk_load(smem_addr(zs), wave + st, (int)(2 * nb), bar);
    if (nb < n) cp_async16(zs + nb, wave + st + nb, (int)(2 * (n - nb)));
    mbar_arrive_cp_async(bar);
  }
  // w0's taps as the B fragments of this warp's n-tiles: column g of n-tile
  // j is channel 64 warp + 8 j + g; k 2t, 2t + 1 and (t = 0 only) 8, 9
  uint32_t bf[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat16* wr = w0 + (size_t)(64 * warp + 8 * j + g) * 10;
    bf[j][0] = *reinterpret_cast<const uint32_t*>(wr + 2 * t);
    bf[j][1] = t == 0 ? *reinterpret_cast<const uint32_t*>(wr + 8) : 0u;
  }
  mbar_wait(bar, 0);
  auto pair = [&](int i) {  // samples i and i + 1, the lower in the low half
    return (uint32_t)zs[i] | ((uint32_t)zs[i + 1] << 16);
  };
  float s[8][2] = {}, q[8][2] = {};
  for (int r = 0; r < rows; r += 16) {
    const int ra = r + g, rb = ra + 8;
    const uint32_t a0 = ra < rows ? pair(off + 5 * ra + 2 * t) : 0u;
    const uint32_t a1 = rb < rows ? pair(off + 5 * rb + 2 * t) : 0u;
    const uint32_t a2 = t == 0 && ra < rows ? pair(off + 5 * ra + 8) : 0u;
    const uint32_t a3 = t == 0 && rb < rows ? pair(off + 5 * rb + 8) : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};  // rows ra (0, 1) and rb (2, 3), columns 2t, 2t + 1
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(bf[j][0]), "r"(bf[j][1]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __fadd_rn(__fadd_rn(s[j][e], x[e]), x[2 + e]);
        q[j][e] = __fmaf_rn(x[2 + e], x[2 + e], __fmaf_rn(x[e], x[e], q[j][e]));
      }
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __fadd_rn(s[j][e], __shfl_xor_sync(0xffffffffu, s[j][e], o));
        q[j][e] = __fadd_rn(q[j][e], __shfl_xor_sync(0xffffffffu, q[j][e], o));
      }
  if (g == 0) {
    float* p = part + ((size_t)b * gridDim.x + blockIdx.x) * 2 * kC + 64 * warp + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store2(p + 8 * j, s[j][0], s[j][1]);
      store2(p + kC + 8 * j, q[j][0], q[j][1]);
    }
  }
}

// The stats' second level: element i of the [2, 512] sums of batch element
// b, its chunks' partial sums added in chunk order.
__global__ void __launch_bounds__(kConvThreads)
conv_stats_sum_kernel(const float* __restrict__ part, int chunks, float* __restrict__ out) {
  const int i = blockIdx.x * kConvThreads + threadIdx.x, b = blockIdx.y;
  const float* p = part + (size_t)b * chunks * 2 * kC + i;
  float v = 0.f;
#pragma unroll 8
  for (int k = 0; k < chunks; ++k) v = __fadd_rn(v, p[(size_t)k * 2 * kC]);
  out[(size_t)b * 2 * kC + i] = v;
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

template <typename T>
void launch_conv0(const void* wave, int B, int Tw, const void* stats, const void* w0,
                  const void* gnw, const void* gnb, float inv_n, float eps, int fast, int n0,
                  void* out, cudaStream_t s) {
  conv0_gn_kernel<T><<<dim3((n0 + kC0Rows - 1) / kC0Rows, B), kConvThreads, 0, s>>>(
      static_cast<const T*>(wave), Tw, static_cast<const float*>(stats),
      static_cast<const T*>(w0), static_cast<const float*>(gnw), static_cast<const float*>(gnb),
      inv_n, eps, fast, n0, static_cast<T*>(out));
}

}  // namespace hr

using namespace hr;

extern "C" {

// wave [B, Tw] and w0 [512, 10]: fp32 (fp32 != 0) or bf16; n0 = (Tw - 10)
// / 5 + 1 >= 1; part [B, chunks, 2, 512] fp32 workspace, chunks = ceil(n0 /
// 256); out [B, 2, 512] fp32. bf16 runs conv0 on the tensor cores
// (conv_stats_mma_kernel), or with cuda_cores = 1 on CUDA cores (the
// yardstick chip_smoke.py times beside it); fp32 runs on CUDA cores.
int hr_conv_stats(int fp32, const void* wave, int B, int Tw, const void* w0, int n0,
                  int chunks, void* part, void* out, int cuda_cores, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n0 < 1 || chunks != (n0 + kStatsRows - 1) / kStatsRows) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const dim3 grid(chunks, B);
    if (fp32)
      conv_stats_part_kernel<float><<<grid, kConvThreads, 0, s>>>(
          static_cast<const float*>(wave), Tw, static_cast<const float*>(w0), n0,
          static_cast<float*>(part));
    else if (cuda_cores)
      conv_stats_part_kernel<__nv_bfloat16><<<grid, kConvThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(wave), Tw, static_cast<const __nv_bfloat16*>(w0), n0,
          static_cast<float*>(part));
    else
      conv_stats_mma_kernel<<<grid, kConvThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(wave), Tw, (size_t)B * Tw,
          static_cast<const __nv_bfloat16*>(w0), n0, static_cast<float*>(part));
    conv_stats_sum_kernel<<<dim3(2 * kC / kConvThreads, B), kConvThreads, 0, s>>>(
        static_cast<const float*>(part), chunks, static_cast<float*>(out));
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

// The stride-2 convs conv1..6 (K1's last three launches, K2's three): out
// [B, M, 512] = T(gelu(rows . taps)), where row r of batch element b is the
// K = kt * 512 elements at x + b * x_batch + r * lda (ops/conv_stack.py
// conv_rows: x_batch = t_in * 512, lda = 2 * 512) and taps [kt, 512, 512]
// tap-major; T fp32 (fp32 != 0) or bf16.
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

// The same conv in bf16 on the TMA GEMM (csrc/tma_gemm.cuh): x [B, t_in,
// 512] and taps [k, 512, 512] bf16, k 2 or 3; out [B, M, 512], M = (t_in -
// k) / 2 + 1; column tiles of bn (128 or 256) columns, `grid` persistent
// blocks (ops/_cuda.py tma_gemm_plan). x's even rows are one tensor map and
// its odd rows another, each with a row stride of 2 * 512. Returns
// cudaErrorInvalidValue for arguments it does not take and where the driver
// refuses a tensor map.
int hr_conv_s2_tma(const void* x, int B, int t_in, int k, const void* taps, int M, int fast_gelu,
                   int bn, int grid, void* out, void* stream) {
  if (B < 1 || (k != 2 && k != 3) || t_in < k || M != (t_in - k) / 2 + 1 || grid < 1 ||
      (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  const long long elem = (long long)t_in * kC;
  CUtensorMap a0, a1, w, o;
  const cuuint64_t odims[3] = {kC, (cuuint64_t)M, (cuuint64_t)B};
  const cuuint64_t ostrides[2] = {kC * 2, (cuuint64_t)M * kC * 2};
  const cuuint32_t obox[3] = {64, 64, 1};
  if (!tg_a_map(&a0, x, kC, (t_in + 1) / 2, B, 2 * kC, elem) ||
      !tg_a_map(&a1, static_cast<const __nv_bfloat16*>(x) + kC, kC, t_in / 2, B, 2 * kC, elem) ||
      !tg_w_map(&w, taps, kC, (long long)k * kC, bn) ||
      !tg_map(&o, out, 3, odims, ostrides, obox))
    return (int)cudaErrorInvalidValue;
  TgArgs g{};
  g.taps = k, g.ksteps_tap = kC / kTgBK, g.wrow_tap = kC;
  g.m_tiles = (M + kTgBM - 1) / kTgBM, g.n_tiles = kC / bn;
  g.tiles = B * g.m_tiles * g.n_tiles;
  g.f.M = M, g.f.N = kC, g.f.fast = fast_gelu;
  g.f.out = out, g.f.out_batch = (long long)M * kC, g.f.ldo = kC;
  return launch_tma_gemm_bn<kFepGelu>(bn, a0, a1, w, o, g, grid,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
