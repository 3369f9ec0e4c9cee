// Band-limited real DFT: bins [0, n_bins) of every window of a batch,
// X[w, k] = sum_t x[w, t] * exp(-2 pi i k t / n), in float32, by a
// two-level FFT in shared memory.
//
// Replaces: wavespec_tpu/kernels/fused_dft.py::rfft_band_fused (and its
// `rfft_band_fused_any` wrapper), the TPU's four-step MXU band DFT. Held
// to its plain PyTorch version,
// wavespec_tpu_torch/ops/spectrum.py::band_dft_plain (one float32
// product of the windows with the same cos/sin basis), at
// |kernel - plain| <= 1e-4 * max|plain| per window: the FFT rounds in
// another order than the direct sum, so the two are not bitwise equal.
//
// What bounds it: at the v7.57 batch shape (65,536 windows of 4096, 230
// bins) the function reads 1 GiB of windows and writes 121 MB of bins,
// about 0.36 ms at the 3.35 TB/s of HBM. A direct sum does 247 GFLOP
// there (3.7 ms at the float32 peak); this design does about 0.1 MFLOP
// a window (7 GFLOP in all, ~0.1 ms), reads every window from HBM once
// and writes every bin once, so the bytes set the bound. What it spends
// beyond that is instruction issue and shared-memory traffic of the two
// steps below, each about as long as the copy alone.
//
// Design (the TPU kernel's split n = N1 x N2, t = i1 N2 + i2,
// k = k1 + N1 k2, with N1 = min(128, n) from the wrapper's `plan`):
// - Tiles. A tile is 32 columns i2 by N1 rows i1 (for n < 4096, 32 / N2
//   whole windows; for n > 4096, one window of N2 columns), laid out
//   [i1][column] in shared memory. Two warps share a tile; a block holds
//   up to six, and the grid is persistent and 1-D. Each tile slot streams
//   its tiles through a two-stage ring filled by cp.async, so the next
//   tile's copy overlaps this tile's arithmetic.
// - Step 1: lane = column. Each column gets a real-input FFT of length
//   N1 = 16 Q over i1, in registers and in place in the column (a row's
//   32 columns are 32 banks): phase A, complex 16-point FFTs of two real
//   columns packed as re + i im and split after; phase B, a twiddle
//   W_N1^(q ka) and Q-point FFTs. The tile's two warps split each phase
//   over disjoint rows. It keeps C[k1] for k1 in [0, N1/2] (the rest is
//   conj(C[N1 - k1])), multiplied by W_n^(i2 k1): T[k1] in N1 + 1 floats
//   (row N1 takes T[N1/2]'s imaginary part; row N1 + 1 is zero).
// - Step 2: thread = row. X[k] = sum_i2 T[k1] W_N2^(i2 k2) for
//   k1 <= N1/2, and conj(sum_i2 T[N1 - k1] W_N2^(-i2 (k2 + 1))) above,
//   only for k < n_bins. A thread takes a row r in [1, N1/2] and its
//   bins, reads the row once as 16-byte quads of columns, starting at its
//   own lane's quad (so 32 lanes read 32 banks), with twiddles that all
//   lanes read from the same word (see `band_out_rows`); row 0 (real) is
//   summed across lanes by shuffles. For N2 < 4, or a band too wide for
//   the per-m tables, a thread takes a bin (`band_out`).
// - Only [rows, n_bins] complex64 is written.
// Every twiddle comes from the float32 table of
// ops/spectrum.py::twiddle_table(n) (cos, -sin of 2 pi m / n, built in
// float64), indexed (a b) & (n - 1): W_n^(i2 k1) as a [N1/2 + 1][32]
// table in shared memory, W_N1, W_N2 and W_N2^(m i2) as short tables; no
// sinf or cosf. Rotations by 1 and -i inside the 4-point butterflies are
// exact. n is a power of two in [16, 16384]: for larger n a tile no
// longer fits two stages in shared memory (the wrapper splits longer
// windows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;
constexpr int kMaxN = 16384;
constexpr int kTileWarps = 2;                  // warps that share a tile
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kMaxTiles = 6;                   // tiles a block computes at once
constexpr int kSmemPerBlock = 232448;   // H100: the opt-in maximum of a block

__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 mul_negi(float2 a) { return make_float2(a.y, -a.x); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// X_k = sum_j a_j W_4^(j k), in place, natural order.
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 s02 = add(a0, a2), d02 = sub(a0, a2);
  const float2 s13 = add(a1, a3), d13 = sub(a1, a3);
  a0 = add(s02, s13);
  a2 = sub(s02, s13);
  a1 = add(d02, mul_negi(d13));
  a3 = sub(d02, mul_negi(d13));
}

// Q-point DFT in place, natural order. w1 is W_N1^j, j < N1 = 16 Q.
template <int Q>
__device__ __forceinline__ void dft_q(float2 (&x)[Q], const float2* w1) {
  if constexpr (Q == 2) {
    const float2 t = x[0];
    x[0] = add(t, x[1]);
    x[1] = sub(t, x[1]);
  } else if constexpr (Q == 4) {
    dft4(x[0], x[1], x[2], x[3]);
  } else if constexpr (Q == 8) {
    // p = 2a + b, k = c + 4d
    float2 e0 = x[0], e1 = x[2], e2 = x[4], e3 = x[6];
    float2 o0 = x[1], o1 = x[3], o2 = x[5], o3 = x[7];
    dft4(e0, e1, e2, e3);
    dft4(o0, o1, o2, o3);
    o1 = cmul(o1, w1[2 * Q * 1]);   // W_8^1
    o2 = mul_negi(o2);              // W_8^2
    o3 = cmul(o3, w1[2 * Q * 3]);   // W_8^3
    x[0] = add(e0, o0); x[4] = sub(e0, o0);
    x[1] = add(e1, o1); x[5] = sub(e1, o1);
    x[2] = add(e2, o2); x[6] = sub(e2, o2);
    x[3] = add(e3, o3); x[7] = sub(e3, o3);
  }
}

// 16-point DFT in place (p = 4a + b, k = c + 4d); X[k] ends at
// x[d16(k)]. W_16^e = w1[e Q].
__host__ __device__ constexpr int d16(int k) { return 4 * (k & 3) + (k >> 2); }

template <int Q>
__device__ __forceinline__ void dft16(float2 (&x)[16], const float2* w1) {
#pragma unroll
  for (int b = 0; b < 4; ++b) dft4(x[b], x[4 + b], x[8 + b], x[12 + b]);
#pragma unroll
  for (int b = 1; b < 4; ++b) {
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      const int e = b * c;
      x[4 * c + b] = (e == 4) ? mul_negi(x[4 * c + b]) : cmul(x[4 * c + b], w1[e * Q]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) dft4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int floats) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (floats == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (floats == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Geometry {
  int n, log_n, log_n2, n2, tw, g, n_bins;   // tw: row width of a tile; g: windows per tile
  int n_k2, m_rows, quads;   // k2 planes of the band; rows of the m tables; step 2 in quads
  long long rows, tiles;
};

constexpr int kQuadTableBytes = 16384;

// Rows of T[r] in a column: (real part, imaginary part); row N1 holds
// T[N1/2]'s imaginary part and row N1 + 1 is zero.
template <int Q>
__device__ __forceinline__ int2 t_rows(int r) {
  constexpr int N1 = 16 * Q;
  if (r == 0) return make_int2(0, N1 + 1);
  if (r == N1 / 2) return make_int2(1, N1);
  const int ka = r & 15, kb = r >> 4;
  if (ka == 0) return make_int2(2 * kb, 2 * kb + 1);
  if (ka == 8) return make_int2(Q + 2 * kb, Q + 2 * kb + 1);
  if (ka < 8) return make_int2(2 * ka * Q + kb, (2 * ka + 1) * Q + kb);
  const int a = 16 - ka, b = Q - 1 - kb;
  return make_int2(2 * a * Q + b, (2 * a + 1) * Q + b);
}

// Step 1 on one column: the real N1-point FFT of rows [0, N1), in place,
// leaving T[k1] = C[k1] W_n^(i2 k1), k1 in [0, N1/2], at `t_rows`. It
// runs in two phases, each split between the two warps of a tile (h = 0,
// 1) over disjoint rows, with a barrier of the tile between them.
//
// Phase A: 16-point FFTs over p of c[Q p + q], two real columns q, q + 1
// a time (for Q = 1 one column with a zero imaginary part); warp h takes
// the pairs of columns with (q / 2) mod 2 == h.
template <int Q>
__device__ __forceinline__ void column_fft_a(float* col, int tw, const float2* w1, int h) {
#pragma unroll
  for (int q = 0; q < Q; q += 2) {
    if (((q >> 1) & 1) != h) continue;
    float2 z[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      z[p].x = col[(Q * p + q) * tw];
      z[p].y = (Q > 1) ? col[(Q * p + q + 1) * tw] : 0.0f;
    }
    dft16<Q>(z, w1);
    // Z_q[ka] = (Z[ka] + conj Z[16 - ka]) / 2, Z_q+1[ka] = -i (Z[ka] - conj Z[16 - ka]) / 2
#pragma unroll
    for (int ka = 0; ka <= 8; ++ka) {
      const float2 a = z[d16(ka)], b = conjf2(z[d16((16 - ka) & 15)]);
      float2 u = a, v = make_float2(0.0f, 0.0f);
      if (Q > 1) {
        const float2 s = add(a, b), d = sub(a, b);
        u = make_float2(0.5f * s.x, 0.5f * s.y);
        v = make_float2(0.5f * d.y, -0.5f * d.x);
      }
      if (ka == 0) {
        col[q * tw] = u.x;
        if (Q > 1) col[(q + 1) * tw] = v.x;
      } else if (ka == 8) {
        col[(Q + q) * tw] = u.x;
        if (Q > 1) col[(Q + q + 1) * tw] = v.x;
      } else {
        col[(2 * ka * Q + q) * tw] = u.x;
        col[((2 * ka + 1) * Q + q) * tw] = u.y;
        if (Q > 1) {
          col[(2 * ka * Q + q + 1) * tw] = v.x;
          col[((2 * ka + 1) * Q + q + 1) * tw] = v.y;
        }
      }
    }
  }
}

// Phase B: Q-point FFTs over q of W_N1^(q ka) Z_q[ka]; warp 0 takes
// ka in [0, 4] (ka = 0 is a real sequence), warp 1 ka in [5, 8] (and
// row 0 of step 2). twm(r) gives this column's W_n^(i2 r).
template <int Q, typename Twm>
__device__ __forceinline__ void column_fft_b(float* col, int tw, const float2* w1, Twm twm,
                                             int h) {
  constexpr int N1 = 16 * Q;
#pragma unroll
  for (int ka = 0; ka <= 8; ++ka) {
    if ((ka <= 4 ? 0 : 1) != h) continue;
    float2 x[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (ka == 0) {
        x[q] = make_float2(col[q * tw], 0.0f);
      } else if (ka == 8) {
        const float v = col[(Q + q) * tw];
        const float2 w = w1[8 * q];
        x[q] = make_float2(v * w.x, v * w.y);
      } else {
        const float2 z = make_float2(col[(2 * ka * Q + q) * tw], col[((2 * ka + 1) * Q + q) * tw]);
        x[q] = (q == 0) ? z : cmul(z, w1[q * ka]);
      }
    }
    dft_q<Q>(x, w1);
    // x[kb] = C[ka + 16 kb]
    if (ka == 0) {
      col[0] = x[0].x;
      if (Q > 1) {
        const float2 t = twm(N1 / 2);
        col[tw] = x[Q / 2].x * t.x;
        col[N1 * tw] = x[Q / 2].x * t.y;
      }
#pragma unroll
      for (int kb = 1; kb < Q / 2; ++kb) {
        const float2 t = cmul(x[kb], twm(16 * kb));
        col[2 * kb * tw] = t.x;
        col[(2 * kb + 1) * tw] = t.y;
      }
    } else if (ka == 8) {
      if (Q == 1) {
        const float2 t = twm(N1 / 2);
        col[tw] = x[0].x * t.x;
        col[N1 * tw] = x[0].x * t.y;
      }
#pragma unroll
      for (int kb = 0; kb < Q / 2; ++kb) {
        const float2 t = cmul(x[kb], twm(8 + 16 * kb));
        col[(Q + 2 * kb) * tw] = t.x;
        col[(Q + 2 * kb + 1) * tw] = t.y;
      }
    } else {
#pragma unroll
      for (int kb = 0; kb < Q; ++kb) {
        const int k1 = ka + 16 * kb;
        const float2 t = (k1 <= N1 / 2) ? cmul(x[kb], twm(k1))
                                        : cmul(conjf2(x[kb]), twm(N1 - k1));
        col[(2 * ka * Q + kb) * tw] = t.x;
        col[((2 * ka + 1) * Q + kb) * tw] = t.y;
      }
    }
  }
}

// Where output o of a tile reads T: its rows' real and imaginary parts
// (at the tile's window g), the exponent of W_N2 and whether the sum is
// conjugated (bins with k1 > N1/2).
struct OutPlan {
  const float* pre;
  const float* pim;
  int mm;
  bool upper;
  long long at;   // index into out
};

template <int Q>
__device__ __forceinline__ OutPlan out_plan(const float* buf, int o, int n2, int tw, int n_bins,
                                            long long w0) {
  constexpr int N1 = 16 * Q;
  const int g = o / n_bins;
  const int k = o - g * n_bins;
  const int k1 = k & (N1 - 1), k2 = k / N1;
  OutPlan pl;
  pl.upper = k1 > N1 / 2;
  const int2 rr = t_rows<Q>(pl.upper ? N1 - k1 : k1);
  pl.mm = pl.upper ? -(k2 + 1) : k2;
  pl.pre = buf + rr.x * tw + g * n2;
  pl.pim = buf + rr.y * tw + g * n2;
  pl.at = (w0 + g) * n_bins + k;
  return pl;
}

// Outputs of the tile's windows that exist.
__device__ __forceinline__ int outputs(int g_per, int n_bins, long long w0, long long rows) {
  const long long valid = (rows - w0) * n_bins;
  return static_cast<int>(valid < g_per * n_bins ? valid : g_per * n_bins);
}

// Step 2 over a tile for N2 < 4 (or per-m tables past kQuadTableBytes),
// a thread a bin: thread t of the tile's
// kTileThreads takes outputs t and t + kTileThreads a pass, each summed
// in two halves, for independent chains of multiply-adds; it walks i2
// from its lane on.
template <int Q>
__device__ __forceinline__ void band_out(const float* buf, const float2* w2, float2* out,
                                         int t, int lane, int n2, int tw, int g_per,
                                         int n_bins, long long w0, long long rows) {
  const int n_out = outputs(g_per, n_bins, w0, rows);
  for (int o = t; o < n_out; o += 2 * kTileThreads) {
    const bool second = o + kTileThreads < n_out;
    const OutPlan a = out_plan<Q>(buf, o, n2, tw, n_bins, w0);
    const OutPlan b = second ? out_plan<Q>(buf, o + kTileThreads, n2, tw, n_bins, w0) : a;
    float ar[2] = {0.0f, 0.0f}, ai[2] = {0.0f, 0.0f};
    float br[2] = {0.0f, 0.0f}, bi[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int j = 0; j < n2; ++j) {
      const int i2 = (lane + j) & (n2 - 1);
      const float2 wa = w2[(i2 * a.mm) & (n2 - 1)];
      const float2 wb = w2[(i2 * b.mm) & (n2 - 1)];
      const float xa = a.pre[i2], ya = a.pim[i2];
      const float xb = b.pre[i2], yb = b.pim[i2];
      const int h = j & 1;
      ar[h] = fmaf(xa, wa.x, fmaf(-ya, wa.y, ar[h]));
      ai[h] = fmaf(xa, wa.y, fmaf(ya, wa.x, ai[h]));
      br[h] = fmaf(xb, wb.x, fmaf(-yb, wb.y, br[h]));
      bi[h] = fmaf(xb, wb.y, fmaf(yb, wb.x, bi[h]));
    }
    const float sai = ai[0] + ai[1], sbi = bi[0] + bi[1];
    out[a.at] = make_float2(ar[0] + ar[1], a.upper ? -sai : sai);
    if (second) out[b.at] = make_float2(br[0] + br[1], b.upper ? -sbi : sbi);
  }
}

__device__ __forceinline__ void cmac4(float (&acc)[2], float4 re, float4 im, float4 w01, float4 w23) {
  acc[0] = fmaf(re.x, w01.x, fmaf(-im.x, w01.y, acc[0]));
  acc[1] = fmaf(re.x, w01.y, fmaf(im.x, w01.x, acc[1]));
  acc[0] = fmaf(re.y, w01.z, fmaf(-im.y, w01.w, acc[0]));
  acc[1] = fmaf(re.y, w01.w, fmaf(im.y, w01.z, acc[1]));
  acc[0] = fmaf(re.z, w23.x, fmaf(-im.z, w23.y, acc[0]));
  acc[1] = fmaf(re.z, w23.y, fmaf(im.z, w23.x, acc[1]));
  acc[0] = fmaf(re.w, w23.z, fmaf(-im.w, w23.w, acc[0]));
  acc[1] = fmaf(re.w, w23.w, fmaf(im.w, w23.z, acc[1]));
}

// Step 2 in quads of columns (N2 >= 4), a thread a row: thread t takes
// row r in [1, N1/2] of window g (item g N1/2 + r - 1) and every bin
// that reads it, k = r + N1 m (m >= 0) and k = N1 |m| - r (m < 0,
// conjugated), four m a pass: S_m = sum_i2 T[r, i2] W_N2^(m i2). The row
// is read once a pass as 16-byte quads of columns, walking the quads from
// the thread's lane on (qd = (lane + j) mod quads: the 8 lanes of a
// quarter warp, 8 quads, 32 banks);
// since W_N2^(4 m quads) = 1, W_N2^(m (4 qd + e)) = W_N2^(4 m lane)
// W_N2^(m (4 j + e)), so the twiddles inside the sum depend on (m, j, e)
// alone and every lane reads the same word (ta: e = 0, 1; tb: e = 2, 3),
// and W_N2^(4 m lane) multiplies the sum once. Row 0 (real, bins N1 m)
// is `band_out_row0`'s.
template <int Q, int N2C>
__device__ __forceinline__ void band_out_rows(const float* buf, const float4* ta, const float4* tb,
                                              const float2* w2, float2* out, int t, int lane,
                                              int n2_rt, int tw, int g_per, int n_bins, int n_k2,
                                              int m_rows, long long w0, long long rows) {
  constexpr int N1 = 16 * Q;
  constexpr int R = N1 / 2;
  const int n2 = N2C ? N2C : n2_rt;
  const int quads = n2 / 4;
  const long long have = rows - w0;
  const int items = static_cast<int>(have < g_per ? have : g_per) * R;
  for (int item = t; item < items; item += kTileThreads) {
    const int g = item / R, r = item - g * R + 1;
    const int2 rr = t_rows<Q>(r);
    const float4* pre = reinterpret_cast<const float4*>(buf + rr.x * tw + g * n2);
    const float4* pim = reinterpret_cast<const float4*>(buf + rr.y * tw + g * n2);
    float2* o = out + (w0 + g) * n_bins;
    for (int m0 = 0; m0 < m_rows; m0 += 4) {   // table row m0 + u holds m = m0 + u - n_k2
      float acc[4][2] = {};
#pragma unroll
      for (int j = 0; j < quads; ++j) {
        const int qd = (lane + j) & (quads - 1);
        const float4 re = pre[qd], im = pim[qd];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          cmac4(acc[u], re, im, ta[(m0 + u) * quads + j], tb[(m0 + u) * quads + j]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + u - n_k2;
        const int k = m >= 0 ? r + N1 * m : -N1 * m - r;
        if (k >= n_bins || (m < 0 && r == N1 / 2)) continue;
        const float2 v = cmul(make_float2(acc[u][0], acc[u][1]), w2[(4 * m * lane) & (n2 - 1)]);
        o[k] = make_float2(v.x, m < 0 ? -v.y : v.y);
      }
    }
  }
}

// Bins N1 m (row 0, real) of the tile by one warp: each lane sums its
// columns' T[0] W_N2^(m i2), then the lanes of a window add up by
// butterfly shuffles.
template <int Q>
__device__ __forceinline__ void band_out_row0(const float* buf, const float2* w2, float2* out,
                                              int lane, int n2, int tw, int n_bins, int n_k2,
                                              long long w0, long long rows) {
  constexpr int N1 = 16 * Q;
  const int span = n2 < 32 ? n2 : 32;   // lanes of one window
  const long long w = w0 + (n2 < 32 ? lane / n2 : 0);
  for (int m = 0; m < n_k2 && N1 * m < n_bins; ++m) {
    float ar = 0.0f, ai = 0.0f;
    for (int c = lane; c < tw; c += 32) {
      const float v = buf[c];
      const float2 wm = w2[(m * (c & (n2 - 1))) & (n2 - 1)];
      ar = fmaf(v, wm.x, ar);
      ai = fmaf(v, wm.y, ai);
    }
    for (int off = 1; off < span; off <<= 1) {
      ar += __shfl_xor_sync(0xffffffffu, ar, off);
      ai += __shfl_xor_sync(0xffffffffu, ai, off);
    }
    if ((lane & (span - 1)) == 0 && w < rows) out[w * n_bins + N1 * m] = make_float2(ar, ai);
  }
}

// Barrier of the warps of one tile (named barrier 1 + tile slot).
__device__ __forceinline__ void tile_sync(int slot) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "n"(kTileThreads) : "memory");
}

template <int Q>
__global__ void __launch_bounds__(kTileThreads * kMaxTiles, 1)
band_dft_kernel(const float* __restrict__ x, const float2* __restrict__ tab,
                float2* __restrict__ out, Geometry geo) {
  constexpr int N1 = 16 * Q;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, slot = threadIdx.x / kTileThreads;
  const int t = threadIdx.x % kTileThreads, h = t >> 5;   // thread of the tile, its warp
  const int slots = blockDim.x / kTileThreads;
  const int n = geo.n, n2 = geo.n2, tw = geo.tw, g_per = geo.g, n_bins = geo.n_bins;
  const int mask = n - 1;
  const int stage_floats = (N1 + 2) * tw;
  float* ring = smem + slot * kStages * stage_floats;
  float2* twm_tab = reinterpret_cast<float2*>(smem + slots * kStages * stage_floats);
  float2* w1 = twm_tab + (N1 / 2 + 1) * 32;
  float2* w2 = w1 + N1;
  // per-m quad tables of W_N2^(m i2), 16-byte aligned after w2
  const int quads = n2 / 4;
  float4* ta = reinterpret_cast<float4*>(w2 + ((n2 + 1) & ~1));
  float4* tb = ta + geo.m_rows * quads;

  // Tables: W_n^((lane mod N2) r) for r <= N1/2, W_N1^j, W_N2^j, the quad
  // tables; and every stage's zero row.
  for (int e = threadIdx.x; e < (N1 / 2 + 1) * 32; e += blockDim.x) {
    const int r = e >> 5, l = e & 31;
    twm_tab[e] = tab[((l & (n2 - 1)) * r) & mask];
  }
  for (int j = threadIdx.x; j < N1; j += blockDim.x) w1[j] = tab[(j * n2) & mask];
  for (int j = threadIdx.x; j < n2; j += blockDim.x) w2[j] = tab[(j * N1) & mask];
  if (geo.quads) {
    for (int e = threadIdx.x; e < geo.m_rows * quads; e += blockDim.x) {
      const int m = e / quads - geo.n_k2, i = 4 * (e % quads);
      const float2 v0 = tab[((m * i) & (n2 - 1)) * N1], v1 = tab[((m * (i + 1)) & (n2 - 1)) * N1];
      const float2 v2 = tab[((m * (i + 2)) & (n2 - 1)) * N1], v3 = tab[((m * (i + 3)) & (n2 - 1)) * N1];
      ta[e] = make_float4(v0.x, v0.y, v1.x, v1.y);
      tb[e] = make_float4(v2.x, v2.y, v3.x, v3.y);
    }
  }
  for (int s = 0; s < kStages; ++s)
    for (int c = t; c < tw; c += kTileThreads) ring[s * stage_floats + (N1 + 1) * tw + c] = 0.0f;
  __syncthreads();

  const int chunk = n2 >= 4 ? 4 : n2;
  const int log_chunk = chunk == 4 ? 2 : chunk - 1;   // 4 -> 2, 2 -> 1, 1 -> 0
  const int log_per_window = geo.log_n - log_chunk;    // chunks of a window
  const int per_tile = (N1 * tw) >> log_chunk;

  auto issue = [&](long long tile, int s) {
    float* dst = ring + s * stage_floats;
    const long long w0 = tile * g_per;
    for (int e = t; e < per_tile; e += kTileThreads) {
      const int g = e >> log_per_window;
      if (w0 + g >= geo.rows) break;
      const int i = (e & ((1 << log_per_window) - 1)) << log_chunk;
      const int i1 = i >> geo.log_n2, i2 = i & (n2 - 1);
      cp_async(dst + i1 * tw + g * n2 + i2, x + (w0 + g) * n + i, chunk);
    }
  };

  // kStages - 1 tiles in flight ahead of the one being computed
  const long long first = static_cast<long long>(blockIdx.x) * slots + slot;
  const long long step = static_cast<long long>(gridDim.x) * slots;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (first + p * step < geo.tiles) issue(first + p * step, p);
    cp_async_commit();
  }
  int s = 0;
  for (long long tile = first; tile < geo.tiles; tile += step) {
    const long long ahead = tile + (kStages - 1) * step;
    if (ahead < geo.tiles) issue(ahead, (s + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    tile_sync(slot);
    float* buf = ring + s * stage_floats;

    // Step 1: each lane's columns, phases A and B split between the
    // tile's warps.
    for (int c = 0; c < tw; c += 32) column_fft_a<Q>(buf + c + lane, tw, w1, h);
    tile_sync(slot);
    for (int c = 0; c < tw; c += 32) {
      const int l = lane;
      if (c == 0) {
        column_fft_b<Q>(buf + lane, tw, w1, [&](int r) { return twm_tab[r * 32 + l]; }, h);
      } else {
        // column i2 = c + lane: W_n^((c + lane) r) = W_n^(lane r) W_n^(c r)
        column_fft_b<Q>(buf + c + lane, tw, w1, [&](int r) {
          return cmul(twm_tab[r * 32 + l], __ldg(tab + ((c * r) & mask)));
        }, h);
      }
    }
    tile_sync(slot);

    // Step 2: thread = output (window g of the tile, bin k).
    if (geo.quads) {
      if (n2 == 32) {
        band_out_rows<Q, 32>(buf, ta, tb, w2, out, t, lane, n2, tw, g_per, n_bins, geo.n_k2,
                             geo.m_rows, tile * g_per, geo.rows);
      } else {
        band_out_rows<Q, 0>(buf, ta, tb, w2, out, t, lane, n2, tw, g_per, n_bins, geo.n_k2,
                            geo.m_rows, tile * g_per, geo.rows);
      }
      if (h == kTileWarps - 1)
        band_out_row0<Q>(buf, w2, out, lane, n2, tw, n_bins, geo.n_k2, tile * g_per, geo.rows);
    } else {
      band_out<Q>(buf, w2, out, t, lane, n2, tw, g_per, n_bins, tile * g_per, geo.rows);
    }
    tile_sync(slot);
    s = s + 1 == kStages ? 0 : s + 1;
  }
  cp_async_wait<0>();
}

template <int Q>
int launch(const float* x, const float2* tab, float2* out, Geometry geo, cudaStream_t stream) {
  constexpr int N1 = 16 * Q;
  const size_t per_tile = sizeof(float) * kStages * (N1 + 2) * geo.tw;
  const size_t tables = sizeof(float2) * ((N1 / 2 + 1) * 32 + N1 + ((geo.n2 + 1) & ~1)) +
                        (geo.quads ? sizeof(float4) * 2 * geo.m_rows * (geo.n2 / 4) : 0);
  if (per_tile + tables > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  int slots = static_cast<int>((kSmemPerBlock - tables) / per_tile);
  slots = slots < kMaxTiles ? slots : kMaxTiles;
  const size_t smem = per_tile * slots + tables;
  cudaError_t err = cudaFuncSetAttribute(band_dft_kernel<Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_dft_kernel<Q>,
                                                           kTileThreads * slots, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long want = (geo.tiles + slots - 1) / slots;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  band_dft_kernel<Q><<<blocks, kTileThreads * slots, smem, stream>>>(x, tab, out, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [rows, n] float32, contiguous, 16-byte aligned; tw: [n] float2
// (cos, -sin) of 2 pi m / n; out: [rows, n_bins] complex64 as float2;
// n1: N1 of the split, 16, 32, 64 or 128, at most n (the wrapper's `plan`).
extern "C" int band_dft_launch(const void* x, const void* tw, void* out,
                               long long rows, int n, int n1, int n_bins,
                               void* stream) {
  if (n < 16 || n > kMaxN || (n & (n - 1)) != 0 || n_bins < 1 || n_bins > n / 2 + 1 ||
      rows < 0 || (n1 != 16 && n1 != 32 && n1 != 64 && n1 != 128) || n1 > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  Geometry geo;
  geo.n = n;
  geo.n2 = n / n1;
  geo.log_n2 = 0;
  while ((1 << geo.log_n2) < geo.n2) ++geo.log_n2;
  geo.log_n = 0;
  while ((1 << geo.log_n) < n) ++geo.log_n;
  geo.tw = geo.n2 > 32 ? geo.n2 : 32;
  geo.g = geo.tw / geo.n2;
  geo.n_bins = n_bins;
  geo.n_k2 = (n_bins + n1 - 1) / n1;
  geo.m_rows = (2 * geo.n_k2 + 3) / 4 * 4;   // m in [-n_k2, n_k2), in passes of four
  geo.quads = geo.n2 >= 4 && 8LL * geo.m_rows * geo.n2 <= kQuadTableBytes;
  geo.rows = rows;
  geo.tiles = (rows + geo.g - 1) / geo.g;
  const float* xs = static_cast<const float*>(x);
  const float2* tab = static_cast<const float2*>(tw);
  float2* o = static_cast<float2*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n1) {
    case 16: return launch<1>(xs, tab, o, geo, st);
    case 32: return launch<2>(xs, tab, o, geo, st);
    case 64: return launch<4>(xs, tab, o, geo, st);
    default: return launch<8>(xs, tab, o, geo, st);
  }
}
