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
// floats, 1747 at window 4096; ~116k at window 262144) and its FFT band
// power (Kb floats) and writes 5 * keep words, so bytes set the bound.
// The reference's greedy rounds (R*k + k dependent argmax passes over the
// rows) are what a direct port pays for instead.
//
// Design: one block of R + 1 warps per window (at most 32; a warp takes
// every nw-th task). Warp b < R streams band b of the pseudospectrum
// once, 4 points a lane per chunk, coalesced, the next chunk loaded while
// the current one is tested; the local-max predicate takes its
// neighbours by shuffles (lane 31 hands on the previous chunk's last
// point, lane 0 the next chunk's first). It keeps, sorted by (value desc,
// index asc), the top `cap` positive local maxima in a list spread over
// the warp (two entries a lane). A pick's +/-excl radius holds at most P
// maxima of the band (maxima are two points apart; the host counts P from
// the tables), so the j-th greedy pick lies among the top (j-1)*P + 1, and
// cap = (k-1)*P + 1 makes the k greedy rounds exact over the list alone:
// each round takes the first unexcluded entry (one ballot) and excludes
// by the reference's float32 test. The list holds at most kMaxList
// entries; where (k-1)*P + 1 is more, the list may run out while
// unexcluded maxima remain, and a round that finds every entry excluded
// in a full list rescans its band for the best positive local maximum
// that no earlier pick excludes (value desc, index asc). When none is
// left, the reference's argmax of the masked row is its first zero:
// point 0, or point 1 where point 0 is an unexcluded negative local
// maximum; that pick still excludes. Warp R streams the band power keeping a sorted top-8 per lane
// in registers, then k warp merges give the top-k with first-index ties.
// No block barrier inside a row pass or a round; one barrier then hands
// the C = R*k + k candidates in shared memory to warp 0, which dedupes,
// pre-ranks, and ranks them (a candidate's rank is the number of better
// keys, first-index ties) to keep `keep`.
// This file must be compiled with --fmad=false: nvcc would otherwise
// contract the pre-rank expression into fused multiply-adds that the
// plain PyTorch version does not use, and near-ties would flip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCand = 128;
constexpr int kMaxTopK = 8;
constexpr int kMaxList = 64;  // two list entries a lane
constexpr int kUnroll = 4;    // points a lane per chunk
constexpr int kChunk = 32 * kUnroll;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v2, int i2, float v, int i) {
  return v2 > v || (v2 == v && i2 < i);
}

// A sorted list of (value, index), position p at lane p & 31 of entry
// a (p < 32) or b (p >= 32); `cnt` positions are filled.
struct WarpList {
  float va, vb;
  int ia, ib;
};

// Insert (v, i), whose index is above every entry's: it goes after every
// entry of value >= v, and the entry at `cap` falls off.
__device__ __forceinline__ void list_insert(WarpList& l, int& cnt, int cap,
                                            float v, int i, int lane) {
  const unsigned ge_a = __ballot_sync(kFull, (lane < cnt) & (l.va >= v));
  const unsigned ge_b = __ballot_sync(kFull, (lane + 32 < cnt) & (l.vb >= v));
  const int pos = __popc(ge_a) + __popc(ge_b);
  const float up_va = __shfl_up_sync(kFull, l.va, 1);
  const int up_ia = __shfl_up_sync(kFull, l.ia, 1);
  const float up_vb = __shfl_up_sync(kFull, l.vb, 1);
  const int up_ib = __shfl_up_sync(kFull, l.ib, 1);
  const float a31_v = __shfl_sync(kFull, l.va, 31);
  const int a31_i = __shfl_sync(kFull, l.ia, 31);
  const int pb = lane + 32;
  if (pb == pos) {
    l.vb = v;
    l.ib = i;
  } else if (pb > pos) {
    l.vb = lane == 0 ? a31_v : up_vb;
    l.ib = lane == 0 ? a31_i : up_ib;
  }
  if (lane == pos) {
    l.va = v;
    l.ia = i;
  } else if (lane > pos) {
    l.va = up_va;
    l.ia = up_ia;
  }
  cnt = min(cnt + 1, cap);
}

// The best (value desc, index asc) positive local maximum of the band
// that none of the j picks at frequencies fp[0..j) excludes, or value 0.
__device__ void rescan(const float* __restrict__ row, const int32_t* __restrict__ core,
                       const float* __restrict__ freqs, int gb, float excl,
                       const float (&fp)[kMaxTopK], int j, int lane, float& v_out,
                       int& i_out) {
  float bv = 0.0f;
  int bi = INT32_MAX;
  for (int i = lane; i < gb - 1; i += 32) {
    const float x = __ldg(row + i);
    const float left = i > 0 ? __ldg(row + i - 1) : x;
    const float right = __ldg(row + i + 1);
    bool take = (__ldg(core + i) != 0) & (x >= left) & (x > right) & (x > bv);
    if (take) {
      const float f = __ldg(freqs + i);
#pragma unroll
      for (int q = 0; q < kMaxTopK; ++q) take &= (q >= j) | (fabsf(f - fp[q]) > excl);
    }
    bv = take ? x : bv;
    bi = take ? i : bi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, bv, o);
    const int i2 = __shfl_xor_sync(kFull, bi, o);
    if (better(v2, i2, bv, bi)) {
      bv = v2;
      bi = i2;
    }
  }
  v_out = bv;
  i_out = bi;
}

// One band: stream it once, keep the top `cap` positive local maxima,
// then run the k greedy rounds over the list (rescanning the band once
// a full list runs out). Lane 0 writes candidate b*k + j of round j.
__device__ void band_picks(const float* __restrict__ row,
                           const int32_t* __restrict__ core,
                           const float* __restrict__ freqs, int gb, int s0,
                           int k, int cap, float excl, int c0, int lane,
                           float* c_freq, float* c_vals, int* c_gidx,
                           int* c_valid) {
  WarpList l{-INFINITY, -INFINITY, INT32_MAX, INT32_MAX};
  int cnt = 0;
  float thr = 0.0f;  // a point enters iff its value is above: > 0, or the last entry's once full
  float carry = __ldg(row);  // the left neighbour of point 0 is itself
  float x[kUnroll], xn[kUnroll];
  int c[kUnroll], cn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = lane + 32 * u;
    x[u] = i < gb ? __ldg(row + i) : 0.0f;
    c[u] = i < gb ? __ldg(core + i) : 0;
  }
  for (int base = 0; base < gb; base += kChunk) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + kChunk + lane + 32 * u;
      xn[u] = i < gb ? __ldg(row + i) : 0.0f;
      cn[u] = i < gb ? __ldg(core + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // lane 31 hands lane 0 its left neighbour, lane 0 hands lane 31 its right
      const float lsrc = lane == 31 ? (u > 0 ? x[u - 1] : carry) : x[u];
      const float rsrc = lane == 0 ? (u + 1 < kUnroll ? x[u + 1] : xn[0]) : x[u];
      const float left = __shfl_sync(kFull, lsrc, (lane + 31) & 31);
      const float right = __shfl_sync(kFull, rsrc, (lane + 1) & 31);
      const int i = base + lane + 32 * u;
      // the last point's right neighbour is itself: it is never a maximum
      const bool peak = (i < gb - 1) & (c[u] != 0) & (x[u] >= left) & (x[u] > right);
      unsigned enter = __ballot_sync(kFull, peak & (x[u] > thr));
      while (enter) {
        const int src = __ffs(enter) - 1;
        enter &= enter - 1;
        const float v = __shfl_sync(kFull, x[u], src);
        if (v > thr) {
          list_insert(l, cnt, cap, v, base + src + 32 * u, lane);
          if (cnt == cap) {
            thr = __shfl_sync(kFull, cap <= 32 ? l.va : l.vb, (cap - 1) & 31);
          }
        }
      }
    }
    carry = x[kUnroll - 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = xn[u];
      c[u] = cn[u];
    }
  }

  // Point 0 is masked below zero in the reference iff it is an unexcluded
  // negative local maximum (core, above point 1); then a round with no
  // positive maximum left picks point 1.
  bool neg0 = gb > 1 && __ldg(core) != 0 && __ldg(row) > __ldg(row + 1) && __ldg(row) < 0.0f;
  const float f0 = __ldg(freqs);
  const float fa = lane < cnt ? __ldg(freqs + l.ia) : 0.0f;
  const float fb = lane + 32 < cnt ? __ldg(freqs + l.ib) : 0.0f;
  bool out_a = lane >= cnt;  // taken, excluded or empty
  bool out_b = lane + 32 >= cnt;
  // a full list may have dropped maxima that later rounds need
  const bool full = cnt == cap;
  float picked[kMaxTopK];
#pragma unroll
  for (int q = 0; q < kMaxTopK; ++q) picked[q] = 0.0f;
  for (int j = 0; j < k; ++j) {
    const unsigned in_a = __ballot_sync(kFull, !out_a);
    const unsigned in_b = __ballot_sync(kFull, !out_b);
    float v = 0.0f;
    int idx = neg0 ? 1 : 0;
    if (in_a) {
      const int src = __ffs(in_a) - 1;
      v = __shfl_sync(kFull, l.va, src);
      idx = __shfl_sync(kFull, l.ia, src);
    } else if (in_b) {
      const int src = __ffs(in_b) - 1;
      v = __shfl_sync(kFull, l.vb, src);
      idx = __shfl_sync(kFull, l.ib, src);
    } else if (full) {
      float rv;
      int ri;
      rescan(row, core, freqs, gb, excl, picked, j, lane, rv, ri);
      if (rv > 0.0f) {
        v = rv;
        idx = ri;
      }
    }
    const float fp = __ldg(freqs + idx);
#pragma unroll
    for (int q = 0; q < kMaxTopK; ++q) picked[q] = q == j ? fp : picked[q];
    out_a |= !(fabsf(fa - fp) > excl);
    out_b |= !(fabsf(fb - fp) > excl);
    neg0 &= fabsf(f0 - fp) > excl;
    if (lane == 0) {
      c_freq[c0 + j] = fp;
      c_vals[c0 + j] = v;
      c_gidx[c0 + j] = s0 + idx;
      c_valid[c0 + j] = v > 0.0f ? 1 : 0;
    }
  }
}

// Ridge seeds: the top-k band-power bins, value desc, index asc.
__device__ void ridge_picks(const float* __restrict__ bp,
                            const float* __restrict__ ps,
                            const int32_t* __restrict__ b2g, int Kb, int k,
                            int n, int k_min, int c0, int lane, float* c_freq,
                            float* c_vals, int* c_gidx, int* c_valid) {
  float tv[kMaxTopK];
  int ti[kMaxTopK];
#pragma unroll
  for (int s = 0; s < kMaxTopK; ++s) {
    tv[s] = -INFINITY;
    ti[s] = INT32_MAX;
  }
  float x[kUnroll], xn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = lane + 32 * u;
    x[u] = i < Kb ? __ldg(bp + i) : 0.0f;
  }
  for (int base = 0; base < Kb; base += kChunk) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + kChunk + lane + 32 * u;
      xn[u] = i < Kb ? __ldg(bp + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + lane + 32 * u;
      if (i < Kb && better(x[u], i, tv[kMaxTopK - 1], ti[kMaxTopK - 1])) {
        // entries worse than (x, i) move down one; (x, i) takes the first
#pragma unroll
        for (int s = kMaxTopK - 1; s >= 0; --s) {
          const bool here = better(x[u], i, tv[s], ti[s]);
          const bool above = s > 0 && better(x[u], i, tv[s - 1], ti[s - 1]);
          if (here) {
            tv[s] = above ? tv[s - 1] : x[u];
            ti[s] = above ? ti[s - 1] : i;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = xn[u];
  }
  for (int j = 0; j < k; ++j) {
    float v = tv[0];
    int bi = ti[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, o);
      const int i2 = __shfl_xor_sync(kFull, bi, o);
      if (better(v2, i2, v, bi)) {
        v = v2;
        bi = i2;
      }
    }
    if (ti[0] == bi) {  // the lane that held it moves its list up
#pragma unroll
      for (int s = 0; s + 1 < kMaxTopK; ++s) {
        tv[s] = tv[s + 1];
        ti[s] = ti[s + 1];
      }
      tv[kMaxTopK - 1] = -INFINITY;
      ti[kMaxTopK - 1] = INT32_MAX;
    }
    if (lane == 0) {
      const int g = __ldg(b2g + bi);
      c_freq[c0 + j] = static_cast<float>(bi + k_min) / static_cast<float>(n);
      c_vals[c0 + j] = __ldg(ps + g);
      c_gidx[c0 + j] = g;
      c_valid[c0 + j] = v > 0.0f ? 1 : 0;
    }
  }
}

__global__ void music_select_kernel(
    const float* __restrict__ pseudo, const float* __restrict__ bpow,
    const float* __restrict__ freqs, const int32_t* __restrict__ core,
    const int32_t* __restrict__ band_off, const int32_t* __restrict__ b2g,
    float* __restrict__ freq_o, uint8_t* __restrict__ valid_o,
    int32_t* __restrict__ gidx_o, float* __restrict__ vals_o,
    float* __restrict__ step_o, int G, int Kb, int R, int k, int keep, int n,
    int k_min, int cap, float excl, float tol, float grid_step,
    float ridge_step) {
  __shared__ float c_freq[kMaxCand];
  __shared__ float c_vals[kMaxCand];
  __shared__ int c_gidx[kMaxCand];
  __shared__ int c_valid[kMaxCand];
  __shared__ int d_valid[kMaxCand];
  __shared__ float c_key[kMaxCand];

  const long long w = blockIdx.x;
  const float* ps = pseudo + w * G;
  const float* bp = bpow + w * Kb;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int c_count = R * k + k;

  for (int task = threadIdx.x >> 5; task <= R; task += nw) {
    if (task < R) {
      const int s0 = band_off[task];
      band_picks(ps + s0, core + s0, freqs + s0, band_off[task + 1] - s0, s0,
                 k, cap, excl, task * k, lane, c_freq, c_vals, c_gidx,
                 c_valid);
    } else {
      ridge_picks(bp, ps, b2g, Kb, k, n, k_min, R * k, lane, c_freq, c_vals,
                  c_gidx, c_valid);
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  // ---- dedupe against EARLIER valid candidates ----
  for (int i = lane; i < c_count; i += 32) {
    int dup = 0;
    for (int jj = 0; jj < i; ++jj) {
      if (fabsf(c_freq[i] - c_freq[jj]) < tol && c_valid[jj] != 0) dup = 1;
    }
    d_valid[i] = (c_valid[i] != 0 && !dup) ? 1 : 0;
  }

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

  // ---- keep the strongest `keep`: a candidate's rank is the number of
  // better keys (first-index ties), as a stable descending sort ----
  for (int i = lane; i < c_count; i += 32) {
    const float key = c_key[i];
    int rank = 0;
    for (int jj = 0; jj < c_count; ++jj) rank += better(c_key[jj], jj, key, i) ? 1 : 0;
    if (rank < keep) {
      const long long o = w * keep + rank;
      freq_o[o] = c_freq[i];
      valid_o[o] = static_cast<uint8_t>(d_valid[i]);
      gidx_o[o] = c_gidx[i];
      vals_o[o] = c_vals[i];
      step_o[o] = i < c_count - k ? grid_step : ridge_step;
    }
  }
}

}  // namespace

extern "C" int music_select_launch(
    const void* pseudo, const void* band_power, const void* freqs,
    const void* core, const void* band_off, const void* b2g, void* freq_o,
    void* valid_o, void* gidx_o, void* vals_o, void* step_o, int n_windows,
    int G, int Kb, int R, int k, int keep, int n, int k_min, int cap,
    float excl, float tol, float grid_step, float ridge_step, void* stream) {
  if (R < 1 || R * k + k > kMaxCand || k < 1 || k > kMaxTopK || Kb < k ||
      keep > R * k + k || cap < 1 || cap > kMaxList) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0) return 0;
  const int threads = 32 * min(R + 1, 32);
  music_select_kernel<<<n_windows, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pseudo), static_cast<const float*>(band_power),
      static_cast<const float*>(freqs), static_cast<const int32_t*>(core),
      static_cast<const int32_t*>(band_off), static_cast<const int32_t*>(b2g),
      static_cast<float*>(freq_o), static_cast<uint8_t*>(valid_o),
      static_cast<int32_t*>(gidx_o), static_cast<float*>(vals_o),
      static_cast<float*>(step_o), G, Kb, R, k, keep, n, k_min, cap, excl, tol,
      grid_step, ridge_step);
  return static_cast<int>(cudaGetLastError());
}
