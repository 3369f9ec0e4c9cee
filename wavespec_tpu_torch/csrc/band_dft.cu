// Band-limited real DFT: bins [0, n_bins) of every window of a batch,
// X[w, k] = sum_t x[w, t] * exp(-2 pi i k t / n), in float32.
//
// Replaces: wavespec_tpu/kernels/fused_dft.py::rfft_band_fused (and its
// `rfft_band_fused_any` wrapper), the TPU's four-step MXU band DFT. Held
// to its plain PyTorch version,
// wavespec_tpu_torch/ops/spectrum.py::band_dft_plain (one float32
// product of the windows with the same cos/sin basis), at
// |kernel - plain| <= 1e-4 * max|plain| per window.
//
// What bounds it: at the v7.57 batch shape (65,536 windows of 4096, 230
// bins) the function reads 1 GiB of windows and writes 121 MB of bins,
// about 0.36 ms at the 3.35 TB/s of HBM; an FFT of each window needs
// 8 GFLOP, under that. This design's direct sum does 2 * 2 * 4096 * 230
// flops per window, 247 GFLOP, so the float32 pipe (67 TFLOP/s, no TF32:
// its 10-bit mantissa would reorder the candidate powers) holds it to
// 3.7 ms at best, ten times the function's bound. An FFT-based band
// kernel, or the sliding DFT, is the way to that bound, not a faster
// direct sum.
//
// Design: a float32 GEMM, C[w, 2k + c] = sum_t x[w, t] * B[t, 2k + c],
// whose B tile is generated on the fly from a float32 twiddle table of
// length n, (cos, -sin)(2 pi m / n), indexed by (k t) & (n - 1): no sinf
// or cosf of large arguments, and no [n, 2 n_bins] basis in memory. A
// block computes 64 windows x 64 columns (32 bins, re and im
// interleaved, so the output is complex64 as it stands) in steps of 16
// samples: the window tile is staged transposed in shared memory, the
// basis tile is gathered from the table (32 KB, L1-resident), and each
// of 256 threads accumulates a 4 x 4 register tile with fused
// multiply-adds. The bin tiles of one window tile are neighbouring
// blocks, so the window rows are read from HBM about once and from L2
// for the other bin tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // windows per block
constexpr int kBN = 64;   // output columns per block (32 bins)
constexpr int kBK = 16;   // samples per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
band_dft_kernel(const float* __restrict__ x, const float2* __restrict__ tw,
                float* __restrict__ out, int rows, int n, int n_cols) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col0 = blockIdx.x * kBN;
  const long long row0 = (long long)blockIdx.y * kBM;
  const int mask = n - 1;

  // window tile loads: thread -> (row tid / 4, samples 4 * (tid % 4) + 0..3)
  const int a_row = tid / 4, a_t = 4 * (tid % 4);
  const bool a_ok = row0 + a_row < rows;
  const float* a_ptr = x + (row0 + a_row) * n + a_t;
  // basis tile: thread -> (sample tid / 16, columns 4 * (tid % 16) + 0..3)
  const int b_t = tid / 16, b_c = 4 * (tid % 16);

  float acc[4][4] = {};
  for (int t0 = 0; t0 < n; t0 += kBK) {
    const float4 a = a_ok ? *reinterpret_cast<const float4*>(a_ptr + t0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    As[a_t + 0][a_row] = a.x;
    As[a_t + 1][a_row] = a.y;
    As[a_t + 2][a_row] = a.z;
    As[a_t + 3][a_row] = a.w;
    const int t = t0 + b_t;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int k = (col0 + b_c + j) >> 1;
      const float2 w = __ldg(tw + ((k * t) & mask));
      Bs[b_t][b_c + j] = w.x;
      Bs[b_t][b_c + j + 1] = w.y;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + 4 * tx + j;
      if (c < n_cols) out[r * n_cols + c] = acc[i][j];
    }
  }
}

}  // namespace

// x: [rows, n] float32, contiguous, 16-byte aligned; tw: [n] float2
// (cos, -sin); out: [rows, 2 * n_bins] float32 (complex64 [rows, n_bins]).
extern "C" int band_dft_launch(const void* x, const void* tw, void* out,
                               long long rows, int n, int n_bins,
                               void* stream) {
  if (n < kBK || (n & (n - 1)) != 0 || n_bins < 1 || n_bins > n / 2 + 1 ||
      rows < 0 || (rows + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int n_cols = 2 * n_bins;
  const dim3 grid((n_cols + kBN - 1) / kBN, static_cast<unsigned>((rows + kBM - 1) / kBM));
  band_dft_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(tw),
      static_cast<float*>(out), static_cast<int>(rows), n, n_cols);
  return static_cast<int>(cudaGetLastError());
}
