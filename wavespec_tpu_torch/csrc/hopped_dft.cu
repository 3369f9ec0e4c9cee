// Overlap-shared band DFT of every rolling window of a series ("hopped
// DFT"): X[b, w, k] = sum_{t<n} x[b, w hop + t] exp(-2 pi i k t / n) for
// k < n_bins, in float32, without building the frame matrix.
//
// Replaces: wavespec_tpu/kernels/hopped_dft.py::rfft_band_hopped (XLA
// einsums and R - 1 shifted FMAs in the JAX package, not a Pallas
// kernel). Held to its plain PyTorch version,
// wavespec_tpu_torch/kernels/hopped_dft.py::rfft_band_hopped_plain (the
// same decomposition as chunked float32 products), at 1e-6 of the call's
// largest |bin|, and to the float64 rfft of each window at 2e-6.
//
// Decomposition (n = 128 R, rows s2d[b, q, j] = x[b, 128 q + j], window
// start w hop = 128 q0 + phi):
//   X[k] = T_phi[k] (lo + C + hi),
//   lo = sum_{j >= phi} s2d[b, q0, j] E[j, k]          (boundary row)
//   C  = sum_{r=1}^{R-1} W[r, k] G[b, q0 + r, k]        (full rows)
//   hi = sum_{j < phi} s2d[b, q0 + R, j] E[j, k]        (boundary row)
//   G[b, q, k] = sum_{j<128} s2d[b, q, j] E[j, k]       (shared by every
//                                                        window holding q)
// with E[j, k] = W_n^(j k), W[r, k] = W_n^(128 r k), T_phi[k] = W_n^(-phi k).
//
// Two launches: `rows_kernel` writes G for every needed row (scratch the
// wrapper allocates), `combine_kernel` writes X. Every twiddle is an entry
// of the float32 table ops/spectrum.py::twiddle_table(n) (cos, -sin of
// 2 pi m / n, built in float64), indexed (a b) mod n; no sinf or cosf.
//
// No repaint, bitwise: each output sums its terms in one fixed order (G
// with j ascending; lo as G[q0] minus the sum of row q0 below phi, j
// ascending; hi with j ascending; the chain with r ascending; then
// (lo + C) + hi), and every term reads only samples of its window, of the
// rows it starts in (wholly inside the series) or G rows, each computed
// from its own 128 samples in one fixed order. Nothing depends on the series length, the
// window count or the launch geometry, so appending samples leaves every
// earlier window's bins unchanged at the bit level, and a series gives the
// same bits alone or in a batch.
//
// What bounds it: at window 4096, hop 16, 16,384 windows and 230 bins,
// done window by window, each output costs ~770 float32 operations (512
// for the two boundary rows, 248 for the chain), 2.9 GFLOP, ~0.043 ms at
// the 67 TFLOP/s float32 peak, against ~0.009 ms for the 30 MB of bins
// written: operations bound it. The design shares that work across the
// P = 128 / gcd(hop, 128) windows that start in one row q0: a warp takes
// one row q0 and 32 bins (lane = bin, so the E and W tiles in shared
// memory are read without bank conflicts), computes the chain once, and
// gets every window's two boundary sums from one ascending pass over both
// boundary rows (lo as G[q0] less the part of row q0 before the window),
// about (256 + 31 x 4) x 2 / P operations an output (~95 at hop 16). G
// costs 256 operations a row and bin, one row for each 128 samples. Every
// row is first copied to shared memory by coalesced loads (the sums would
// otherwise wait on one cache miss after another) and read four samples
// at a time by 16-byte broadcast reads; one read of E feeds both rows'
// sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;        // samples a row
constexpr int kBins = 32;          // bins a block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 8;        // rows a warp (rows_kernel)
constexpr int kPerBlock = kWarps * kPerWarp;
constexpr int kChainRows = 32;     // W rows staged in shared memory at a time
constexpr int kMaxN = 1 << 22;     // 128 (n / 2) and R^2 stay below 2^32
// shared memory: the basis tile E[128][32], then the rows (rows_kernel) or
// a chunk of W and the two boundary rows of each warp (combine_kernel)
constexpr size_t kBasisBytes = sizeof(float2) * kLanes * kBins;
constexpr size_t kRowsSmem = kBasisBytes + sizeof(float) * kWarps * kPerWarp * kLanes;
constexpr size_t kCombineSmem =
    kBasisBytes + sizeof(float2) * kChainRows * kBins + sizeof(float) * kWarps * 2 * kLanes;

struct Geometry {
  long long batch;
  long long length;   // samples a series (row stride of x)
  long long nwin;
  long long q_rows;   // rows of G a series
  long long row_tiles;
  long long tasks;    // combine_kernel's warp tasks a series
  long long task_tiles;
  unsigned n;         // at most kMaxN, so that every twiddle index below fits 32 bits
  int r_rows;         // n / 128
  int hop;
  int n_bins;
};

// E[j][kk] = W_n^(j k) for the block's 32 bins (zero past n_bins), from
// the basis table `e_tab` [128][n_bins] (coalesced reads).
__device__ void load_basis(float2 (*e)[kBins], const float2* __restrict__ e_tab,
                           int k0, const Geometry& g) {
#pragma unroll
  for (int it = 0; it < kLanes * kBins / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int j = idx / kBins, kk = idx % kBins, k = k0 + kk;
    e[j][kk] = k < g.n_bins ? __ldg(e_tab + j * g.n_bins + k) : make_float2(0.f, 0.f);
  }
}

// G[b, q, k] for the block's 64 rows and 32 bins: each warp copies its 8
// rows to shared memory (coalesced), then sums j = 0..127 in order, four
// samples a 16-byte broadcast read.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ x, const float2* __restrict__ e_tab,
            float2* __restrict__ gout, Geometry g) {
  extern __shared__ __align__(16) float2 smem_rows[];
  float2 (*e)[kBins] = reinterpret_cast<float2 (*)[kBins]>(smem_rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = reinterpret_cast<float*>(smem_rows + kLanes * kBins) + warp * kPerWarp * kLanes;
  const long long b = blockIdx.x / g.row_tiles;
  const long long q_base = (blockIdx.x % g.row_tiles) * kPerBlock + warp * kPerWarp;
  const int k0 = blockIdx.y * kBins;
  load_basis(e, e_tab, k0, g);
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const float* row = x + b * g.length + (q_base + i) * kLanes;
#pragma unroll
    for (int m = 0; m < kLanes / 32; ++m)   // a row past the last: zeros, not stored
      xs[i * kLanes + m * 32 + lane] = q_base + i < g.q_rows ? __ldg(row + m * 32 + lane) : 0.f;
  }
  __syncthreads();
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  float re[kPerWarp], im[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) re[i] = im[i] = 0.f;
#pragma unroll 2
  for (int j4 = 0; j4 < kLanes / 4; ++j4) {
    const float2 e0 = e[4 * j4][lane], e1 = e[4 * j4 + 1][lane];
    const float2 e2 = e[4 * j4 + 2][lane], e3 = e[4 * j4 + 3][lane];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float4 v = xs4[i * (kLanes / 4) + j4];
      re[i] = fmaf(v.x, e0.x, re[i]);
      im[i] = fmaf(v.x, e0.y, im[i]);
      re[i] = fmaf(v.y, e1.x, re[i]);
      im[i] = fmaf(v.y, e1.y, im[i]);
      re[i] = fmaf(v.z, e2.x, re[i]);
      im[i] = fmaf(v.z, e2.y, im[i]);
      re[i] = fmaf(v.w, e3.x, re[i]);
      im[i] = fmaf(v.w, e3.y, im[i]);
    }
  }
  const int k = k0 + lane;
  if (k >= g.n_bins) return;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    if (q_base + i < g.q_rows)
      gout[(b * g.q_rows + q_base + i) * g.n_bins + k] = make_float2(re[i], im[i]);
  }
}

// X[b, w, k] for the windows of one row q0 a warp, 32 bins a block. A
// warp's task is a row q0 and the windows [w0, w1) that start in it (for
// hop < 128 every row holds one or more; for hop >= 128 a task is one
// window). They share the chain C(q0) and one ascending pass over the two
// boundary rows (copied to shared memory first), which accumulates
// A(phi) = sum_{j < phi} of row q0 and hi(phi) = sum_{j < phi} of row
// q0 + R together, one read of E for both; at each window's phase,
// lo = G[q0] - A(phi) (row q0 lies wholly in the series) and the bins are
// T_phi ((lo + C) + hi). Every sum keeps one fixed order whatever the
// task holds.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ x, const float2* __restrict__ tw,
               const float2* __restrict__ e_tab, const float2* __restrict__ gin,
               float2* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) float2 smem[];
  float2 (*e)[kBins] = reinterpret_cast<float2 (*)[kBins]>(smem);
  float2 (*wt)[kBins] = e + kLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = reinterpret_cast<float*>(smem + (kLanes + kChainRows) * kBins) + warp * 2 * kLanes;
  const long long b = blockIdx.x / g.task_tiles;
  const long long task = (blockIdx.x % g.task_tiles) * kWarps + warp;
  const int k0 = blockIdx.y * kBins;
  load_basis(e, e_tab, k0, g);

  long long q0 = 0, w0 = 0, w1 = 0;   // a warp past the last task: no windows
  if (task < g.tasks) {
    if (g.hop < kLanes) {
      q0 = task;
      w0 = (kLanes * task + g.hop - 1) / g.hop;
      w1 = (kLanes * (task + 1) + g.hop - 1) / g.hop;
      w1 = w1 < g.nwin ? w1 : g.nwin;
    } else {
      w0 = task;
      w1 = task + 1;
      q0 = task * g.hop / kLanes;
    }
  }
  const long long start0 = q0 * kLanes;
  const float* xb = x + b * g.length + start0;
  const int phi_last = w1 > w0 ? static_cast<int>((w1 - 1) * g.hop - start0) : 0;
  // the boundary rows below the last window's phase: row q0 (in the
  // series) and row q0 + R (past the phase its samples may not exist)
#pragma unroll
  for (int m = 0; m < kLanes / 32; ++m) {
    const int j = m * 32 + lane;
    xs[j] = j < phi_last ? __ldg(xb + j) : 0.f;
    xs[kLanes + j] = j < phi_last ? __ldg(xb + static_cast<long long>(g.n) + j) : 0.f;
  }
  const int k = k0 + lane;
  const int kc = k < g.n_bins ? k : g.n_bins - 1;   // lanes past the band read a valid bin

  // The chain over the full rows, r = 1 .. R - 1 in order; W_n^(128 r k) =
  // W_R^(r k) is the table's entry 128 ((r k) mod R).
  float c_re = 0.f, c_im = 0.f;
  const float2* gq = gin + (b * g.q_rows + q0) * g.n_bins + kc;
  for (int r0 = 1; r0 < g.r_rows; r0 += kChainRows) {
    const int rows = g.r_rows - r0 < kChainRows ? g.r_rows - r0 : kChainRows;
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * kBins; idx += kThreads) {
      const int rr = idx / kBins, kb = k0 + idx % kBins;
      const unsigned rk = (static_cast<unsigned>(r0 + rr) * (kb % g.r_rows)) % g.r_rows;
      wt[rr][idx % kBins] = kb < g.n_bins ? __ldg(tw + kLanes * rk) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    if (w0 < w1) {
#pragma unroll 8
      for (int rr = 0; rr < rows; ++rr) {
        const float2 wr = wt[rr][lane];
        const float2 gv = gq[static_cast<long long>(r0 + rr) * g.n_bins];
        c_re = fmaf(wr.x, gv.x, c_re);
        c_re = fmaf(-wr.y, gv.y, c_re);
        c_im = fmaf(wr.x, gv.y, c_im);
        c_im = fmaf(wr.y, gv.x, c_im);
      }
    }
  }
  if (w0 >= w1) return;
  const float2 g_q0 = gq[0];

  // one ascending pass over both boundary rows, four samples at a time
  // (phases are multiples of gcd(hop, 128) >= 8); a window at each phase
  const float4* lo4 = reinterpret_cast<const float4*>(xs);
  const float4* hi4 = reinterpret_cast<const float4*>(xs + kLanes);
  float a_re = 0.f, a_im = 0.f, h_re = 0.f, h_im = 0.f;
  int j4 = 0;
  for (long long w = w0; w < w1; ++w) {
    const int phi = static_cast<int>(w * g.hop - start0);
    for (; j4 < phi / 4; ++j4) {
      const float4 u = lo4[j4], v = hi4[j4];
      const float2 e0 = e[4 * j4][lane], e1 = e[4 * j4 + 1][lane];
      const float2 e2 = e[4 * j4 + 2][lane], e3 = e[4 * j4 + 3][lane];
      a_re = fmaf(u.x, e0.x, a_re);
      a_im = fmaf(u.x, e0.y, a_im);
      h_re = fmaf(v.x, e0.x, h_re);
      h_im = fmaf(v.x, e0.y, h_im);
      a_re = fmaf(u.y, e1.x, a_re);
      a_im = fmaf(u.y, e1.y, a_im);
      h_re = fmaf(v.y, e1.x, h_re);
      h_im = fmaf(v.y, e1.y, h_im);
      a_re = fmaf(u.z, e2.x, a_re);
      a_im = fmaf(u.z, e2.y, a_im);
      h_re = fmaf(v.z, e2.x, h_re);
      h_im = fmaf(v.z, e2.y, h_im);
      a_re = fmaf(u.w, e3.x, a_re);
      a_im = fmaf(u.w, e3.y, a_im);
      h_re = fmaf(v.w, e3.x, h_re);
      h_im = fmaf(v.w, e3.y, h_im);
    }
    if (k < g.n_bins) {
      const float y_re = ((g_q0.x - a_re) + c_re) + h_re;
      const float y_im = ((g_q0.y - a_im) + c_im) + h_im;
      // T_phi[k] = W_n^(-phi k): the table entry's conjugate
      const float2 tt = __ldg(tw + (static_cast<unsigned>(phi) * k) % g.n);
      const float t_re = tt.x, t_im = -tt.y;
      out[(b * g.nwin + w) * g.n_bins + k] =
          make_float2(t_re * y_re - t_im * y_im, t_re * y_im + t_im * y_re);
    }
  }
}

}  // namespace

// x: [batch, length] float32, contiguous rows, any alignment (scalar
// loads); tw: [n] float2 (cos, -sin) of 2 pi m / n; e_tab: [128, n_bins]
// float2, tw[(j k) mod n] (the basis E, gathered once); g: [batch, q_rows,
// n_bins] float2 scratch; out: [batch, nwin, n_bins] complex64 as float2.
// n = 128 R with R >= 2; q_rows = ((nwin - 1) hop) / 128 + R, the rows
// the windows' chains read; the last window ends inside the series.
extern "C" int hopped_dft_launch(const void* x, const void* tw, const void* e_tab, void* g, void* out,
                                 long long batch, long long length, int n, int hop,
                                 int n_bins, long long nwin, long long q_rows, void* stream) {
  int seg = kLanes;   // gcd(hop, 128)
  while (hop % seg) seg /= 2;
  if (n % kLanes != 0 || n < 2 * kLanes || n > kMaxN || hop < 1 || kLanes / seg > 16 ||
      n_bins < 1 || n_bins > n / 2 || batch < 0 || nwin < 1 || length < n + (nwin - 1) * hop ||
      q_rows != ((nwin - 1) * hop) / kLanes + n / kLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Geometry geo;
  geo.batch = batch;
  geo.length = length;
  geo.nwin = nwin;
  geo.q_rows = q_rows;
  geo.row_tiles = (q_rows + kPerBlock - 1) / kPerBlock;
  geo.tasks = hop < kLanes ? ((nwin - 1) * hop) / kLanes + 1 : nwin;
  geo.task_tiles = (geo.tasks + kWarps - 1) / kWarps;
  geo.n = n;
  geo.r_rows = n / kLanes;
  geo.hop = hop;
  geo.n_bins = n_bins;
  const long long bin_tiles = (n_bins + kBins - 1) / kBins;
  if (bin_tiles > 65535 || batch * geo.row_tiles > 0x7fffffffLL ||
      batch * geo.task_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kRowsSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kCombineSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xs = static_cast<const float*>(x);
  const float2* tab = static_cast<const float2*>(tw);
  const float2* etab = static_cast<const float2*>(e_tab);
  float2* gs = static_cast<float2*>(g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 rows_grid(static_cast<unsigned>(batch * geo.row_tiles), static_cast<unsigned>(bin_tiles));
  rows_kernel<<<rows_grid, kThreads, kRowsSmem, st>>>(xs, etab, gs, geo);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dim3 task_grid(static_cast<unsigned>(batch * geo.task_tiles), static_cast<unsigned>(bin_tiles));
  combine_kernel<<<task_grid, kThreads, kCombineSmem, st>>>(xs, tab, etab, gs,
                                                            static_cast<float2*>(out), geo);
  return static_cast<int>(cudaGetLastError());
}
