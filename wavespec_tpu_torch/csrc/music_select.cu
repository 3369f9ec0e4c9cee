// MUSIC candidate selection: per-band peaks -> ridge seeds -> dedupe ->
// parabola pre-rank -> keep the strongest `keep`, for every window.
//
// Replaces: wavespec_tpu/kernels/music_select_pallas.py::
// select_candidates_pallas (Pallas `_kernel`), which is bitwise equal to
// the XLA chain wavespec_tpu/analyze/music.py:912-1019. This kernel is
// held bitwise equal to its plain PyTorch twin,
// wavespec_tpu_torch/analyze/music.py::select_candidates_plain.
//
// What bounds it: a window reads its merged pseudospectrum row (G
// floats, 1747 at window 4096; ~116k at window 262144) k times per band
// and its FFT band power (Kb floats) k times, and writes 5 * keep words.
// That is a few tens of KB per window from L2, against a chain of
// R*k + k + keep dependent block-wide argmax rounds: the rounds'
// latency, not bandwidth or arithmetic, sets the time.
//
// Design: one block per window. Rows are read from global memory (L1/L2)
// and never staged in shared memory, so the same kernel serves every
// window size. The greedy exclusion state is not stored either: a grid
// point's masked value is recomputed each round from the row and the
// band's earlier picks (at most top_k <= 8), which is exactly the
// "zero within +/-excl of an earlier pick" rule of the reference. Every
// argmax is "max, then the lowest index holding it" (first-index ties,
// as jax.lax.top_k and the Pallas kernel); a thread scans a strided
// slice keeping the first best, then warps and the block reduce pairs
// (value, index). The C = R*k + k candidates then sit in shared memory
// and one warp runs the dedupe, the pre-rank and the keep top-k.
// This file must be compiled with --fmad=false: nvcc would otherwise
// contract the pre-rank expression into fused multiply-adds that the
// plain PyTorch version does not use, and near-ties would flip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCand = 128;
constexpr int kMaxTopK = 8;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v2, int i2, float v, int i) {
  return v2 > v || (v2 == v && i2 < i);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(kFull, v, o);
    const int i2 = __shfl_down_sync(kFull, i, o);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

// Block-wide (max value, lowest index holding it); every thread gets it.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[wid] = v;
    si[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sv[lane] : -INFINITY;
    i = lane < nw ? si[lane] : INT32_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

__global__ void music_select_kernel(
    const float* __restrict__ pseudo, const float* __restrict__ bpow,
    const float* __restrict__ freqs, const int32_t* __restrict__ core,
    const int32_t* __restrict__ band_off, const int32_t* __restrict__ b2g,
    float* __restrict__ freq_o, int32_t* __restrict__ valid_o,
    int32_t* __restrict__ gidx_o, float* __restrict__ vals_o,
    float* __restrict__ step_o, int G, int Kb, int R, int k, int keep, int n,
    int k_min, float excl, float tol, float grid_step, float ridge_step) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ float c_freq[kMaxCand];
  __shared__ float c_vals[kMaxCand];
  __shared__ int c_gidx[kMaxCand];
  __shared__ int c_valid[kMaxCand];
  __shared__ int d_valid[kMaxCand];
  __shared__ float c_key[kMaxCand];
  __shared__ float picks[kMaxTopK];
  __shared__ int ridge_idx[kMaxTopK];

  const long long w = blockIdx.x;
  const float* ps = pseudo + w * G;
  const float* bp = bpow + w * Kb;
  const int tid = threadIdx.x;
  const int c_count = R * k + k;

  // ---- per-band greedy top-k local maxima with +/-excl exclusion ----
  for (int b = 0; b < R; ++b) {
    const int s0 = band_off[b];
    const int gb = band_off[b + 1] - s0;
    for (int j = 0; j < k; ++j) {
      float bv = -INFINITY;
      int bi = INT32_MAX;
      for (int i = tid; i < gb; i += blockDim.x) {
        const float x = ps[s0 + i];
        const float left = ps[s0 + (i > 0 ? i - 1 : 0)];
        const float right = ps[s0 + (i < gb - 1 ? i + 1 : gb - 1)];
        float mval = (x >= left && x > right && core[s0 + i] != 0) ? x : 0.0f;
        const float fi = freqs[s0 + i];
        for (int jj = 0; jj < j; ++jj) {
          if (!(fabsf(fi - picks[jj]) > excl)) mval = 0.0f;
        }
        if (mval > bv) {
          bv = mval;
          bi = i;
        }
      }
      block_argmax(bv, bi, red_v, red_i);
      if (tid == 0) {
        const int c = b * k + j;
        const float f_pick = freqs[s0 + bi];
        picks[j] = f_pick;
        c_freq[c] = f_pick;
        c_vals[c] = bv;
        c_gidx[c] = s0 + bi;
        c_valid[c] = bv > 0.0f ? 1 : 0;
      }
      __syncthreads();
    }
  }

  // ---- ridge seeds: top-k FFT band-power bins (first-index ties) ----
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT32_MAX;
    for (int i = tid; i < Kb; i += blockDim.x) {
      float x = bp[i];
      for (int jj = 0; jj < j; ++jj) {
        if (ridge_idx[jj] == i) x = -kBig;
      }
      if (x > bv) {
        bv = x;
        bi = i;
      }
    }
    block_argmax(bv, bi, red_v, red_i);
    if (tid == 0) {
      const int c = R * k + j;
      const int g = b2g[bi];
      ridge_idx[j] = bi;
      c_freq[c] = static_cast<float>(bi + k_min) / static_cast<float>(n);
      c_vals[c] = ps[g];
      c_gidx[c] = g;
      c_valid[c] = bv > 0.0f ? 1 : 0;
    }
    __syncthreads();
  }

  if (tid >= 32) return;
  const int lane = tid;

  // ---- dedupe against EARLIER valid candidates ----
  for (int i = lane; i < c_count; i += 32) {
    int dup = 0;
    for (int jj = 0; jj < i; ++jj) {
      if (fabsf(c_freq[i] - c_freq[jj]) < tol && c_valid[jj] != 0) dup = 1;
    }
    d_valid[i] = (c_valid[i] != 0 && !dup) ? 1 : 0;
  }
  __syncwarp();

  // ---- pre-rank key: parabola through the edge-padded band power ----
  for (int i = lane; i < c_count; i += 32) {
    int k0 = static_cast<int>(rintf(c_freq[i] * static_cast<float>(n))) - k_min;
    k0 = min(max(k0, 0), Kb - 1);
    const float pm = bp[k0 > 0 ? k0 - 1 : 0];
    const float p0 = bp[k0];
    const float pp = bp[k0 < Kb - 1 ? k0 + 1 : Kb - 1];
    const float denom = pm - 2.0f * p0 + pp;
    float shift = (pm - pp) / (fabsf(denom) > 1e-30f ? 2.0f * denom : 1e-30f);
    shift = fminf(fmaxf(shift, -1.0f), 1.0f);
    const float pgram0 =
        p0 + 0.5f * (pp - pm) * shift + 0.5f * denom * shift * shift;
    c_key[i] = d_valid[i] ? pgram0 : -1.0f;
  }
  __syncwarp();

  // ---- keep the strongest `keep` candidates (first-index ties) ----
  for (int j = 0; j < keep; ++j) {
    float bv = -INFINITY;
    int bi = INT32_MAX;
    for (int i = lane; i < c_count; i += 32) {
      if (better(c_key[i], i, bv, bi)) {
        bv = c_key[i];
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    bi = __shfl_sync(kFull, bi, 0);
    if (lane == 0) {
      const long long o = w * keep + j;
      freq_o[o] = c_freq[bi];
      valid_o[o] = d_valid[bi];
      gidx_o[o] = c_gidx[bi];
      vals_o[o] = c_vals[bi];
      step_o[o] = bi < c_count - k ? grid_step : ridge_step;
      c_key[bi] = -kBig;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int music_select_launch(
    const void* pseudo, const void* band_power, const void* freqs,
    const void* core, const void* band_off, const void* b2g, void* freq_o,
    void* valid_o, void* gidx_o, void* vals_o, void* step_o, int n_windows,
    int G, int Kb, int R, int k, int keep, int n, int k_min, float excl,
    float tol, float grid_step, float ridge_step, int threads,
    void* stream) {
  if (R * k + k > kMaxCand || k > kMaxTopK || keep > R * k + k ||
      threads < 32 || threads > 1024 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0) return 0;
  music_select_kernel<<<n_windows, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pseudo), static_cast<const float*>(band_power),
      static_cast<const float*>(freqs), static_cast<const int32_t*>(core),
      static_cast<const int32_t*>(band_off), static_cast<const int32_t*>(b2g),
      static_cast<float*>(freq_o), static_cast<int32_t*>(valid_o),
      static_cast<int32_t*>(gidx_o), static_cast<float*>(vals_o),
      static_cast<float*>(step_o), G, Kb, R, k, keep, n, k_min, excl, tol,
      grid_step, ridge_step);
  return static_cast<int>(cudaGetLastError());
}
