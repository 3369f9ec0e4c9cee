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
//   lo = G[b, q0, k] - A_q0(phi)                           (boundary row)
//   C  = sum_{r=1}^{R-1} W[r, k] G[b, q0 + r, k]           (full rows)
//   hi = A_{q0+R}(phi)                                     (boundary row)
//   A_q(phi) = sum_{j < phi} s2d[b, q, j] E[j, k],  G[b, q, k] = A_q(128)
// with E[j, k] = W_n^(j k), W[r, k] = W_n^(128 r k), T_phi[k] = W_n^(-phi k).
// A row's prefix A_q serves twice: as lo of the windows starting in row q
// and as hi of those starting in row q - R.
//
// What bounds it: at window 4096, hop 16, 16,384 windows and 230 bins
// the function needs 0.621 GFLOP (each row's G once, each boundary
// prefix once, the chain once a start row, the combine) and writes
// 30 MB of bins: both bounds sit near 0.009 ms on an H100 (67 TFLOP/s
// float32, 3.35 TB/s). Tensor cores are not used: the sums are float32
// FMAs in a fixed order (TF32 is off on every path held to parity). On
// the card the sums of G and of the prefixes are bound by shared-memory
// wavefronts: every series sample is read by all the lanes of a warp at
// once, one wavefront a sample and row, which two FMAs a lane cannot
// keep up with. The earlier two-launch design lost besides to on-chip
// traffic and latency: every block of 8 start rows copied the 32 KiB
// basis tile, and every task re-read its R - 1 G rows from global
// memory in a dependent chain.
//
// Design: a block owns a tile of M consecutive start rows (a multiple of
// 8, at most 64) and 32 bins, as kernels/hopped_dft.py::launch_plan
// chooses. It copies the basis tile E[128][32] once, by 16-byte
// cp.async. G rows stream through a shared-memory ring, 32 chain steps r
// at a time, so the shared memory does not grow with R: either summed in
// the block from the series (one launch; the R - 1 halo rows past the
// tile are summed again by the next tile) or written once by
// `rows_kernel` and copied in by 16-byte cp.async, the next chunk's rows
// while the current chunk's chain runs (two launches). Where a lane sums
// a row (G, the prefixes) it takes two bins and the two halves of a warp
// take different rows, so each sample read feeds four FMAs and each E
// read all the warp's rows. Each warp sums the chain of 8 consecutive
// start rows, every W[r] it reads feeding all eight (the G rows slide
// through registers). W and T are entries of the twiddle table: W's
// indices are stepped from row to row (no modulo in the loop; a
// [R - 1, K] table would be 477 MB at window 262144), T is copied once a
// block. Then the prefixes: with two phases a row (P = 2, in one launch)
// the G sums keep each row's prefix at sample 64 as they pass it, and
// the windows need no further sums. Otherwise each half-warp sweeps
// whole walks of rows q, q + R, q + 2R, ... of the tile, up to 8 rows at
// once: one ascending pass over each row gives its prefix at every
// phase, so each boundary row is summed once, and at each phase a
// window's bins are T_phi (((G - A_q0) + C) + A_{q0+R}) from two rows of
// the same sweep.
//
// No repaint, bitwise: each output sums its terms in one fixed order (G
// and every prefix with j ascending, in the same fmaf sequence; the chain
// with r ascending; then ((lo + C) + hi) and T_phi's product in pinned
// fmaf/__fmul_rn). Every term reads only samples of its window or of the
// rows it starts in, and nothing depends on the series length, the window
// count, the batch or the tile plan, so appending samples leaves every
// earlier window's bins unchanged at the bit level, and a series gives
// the same bits alone or in a batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;        // samples a row
constexpr int kBins = 32;          // bins a block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 8;        // G rows a warp sums at once
constexpr int kPerBlock = kWarps * kPerWarp;   // rows_kernel: rows a block
constexpr int kChainRows = 32;     // chain steps r a chunk (W rows staged at a time)
constexpr int kGroup = 8;          // start rows of one warp's chain
constexpr int kMaxTile = kWarps * kGroup;
constexpr int kSweep = 8;          // rows one prefix sweep carries
constexpr int kMaxN = 1 << 22;     // 128 (n / 2) and 8 R^2 stay below 2^32
constexpr int kRowBytes = static_cast<int>(sizeof(float2)) * kBins;   // one G row of a bin tile
constexpr int kBasisBytes = kRowBytes * kLanes;
constexpr int kRowsSmem = kBasisBytes + static_cast<int>(sizeof(float)) * kPerBlock * kLanes;
constexpr int kSmemLimit = 232448;   // an H100 block's opt-in shared memory

struct Geometry {
  long long length;   // samples a series (row stride of x)
  long long nwin;
  long long q_rows;   // G rows a series: ((nwin - 1) hop) / 128 + R
  long long row_tiles;
  long long tiles;    // tiles of start rows a series
  long long kp;       // row stride of E and G: the bins padded to a multiple of 32
  unsigned n;         // at most kMaxN, so that every twiddle index below fits 32 bits
  int r_rows;         // n / 128
  int hop;
  int n_bins;
  int tile;           // start rows a tile (M)
  int ring;           // G rows the ring holds: M + kChainRows (two in two passes)
  int fill;           // G rows summed in the block at once (one launch)
  int walk_len;       // rows of the longest walk q, q + R, ... of a tile
  int two_pass;
  int snap;           // P = 2 in one launch: the G sums keep each row's prefix at phase 64
};

// Shared memory of tile_kernel: the basis tile, G and C of the tile's
// start rows (and with `snap` the prefixes of the start rows and of their
// boundary rows), then either the ring, a W chunk and (one launch) a
// batch of series rows, or the warps' sweep rows, the T tile and the
// sweeps' row table. None of it grows with R.
int tile_smem(int tile, int two_pass, int snap) {
  const int fixed = kRowBytes * (kLanes + (snap ? 4 : 2) * tile);
  const int fill = two_pass ? 0 : (tile <= 32 ? 64 : 32);
  const int chunks = two_pass ? 2 : 1;   // chunks of G rows and W staged at once
  const int stage = kRowBytes * (tile + 2 * kChainRows * chunks) +
                    static_cast<int>(sizeof(float)) * kLanes * fill;
  const int sweep = static_cast<int>(sizeof(float)) * kLanes * kSweep * kWarps + kRowBytes * 16 +
                    static_cast<int>(sizeof(int)) * 2 * kSweep * 2 * kWarps;
  return fixed + (stage > sweep ? stage : sweep);
}

// Asynchronous copies into shared memory (cp.async); a plain copy where
// the code is compiled for the host.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *static_cast<float4*>(dst) = *static_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy8(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
#else
  *static_cast<float2*>(dst) = *static_cast<const float2*>(src);
#endif
}

// Waits for this thread's copies (all, or all but those issued since the
// last wait when `keep_last`); a barrier makes them visible to others.
__device__ __forceinline__ void copies_done(bool keep_last = false) {
#if defined(__CUDA_ARCH__)
  if (keep_last) {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }
#endif
}

// Starts a group of copies that a later copies_done(true) leaves running.
__device__ __forceinline__ void copies_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// E[j][kk] = W_n^(j k) for the block's 32 bins, from the basis table
// `e_tab` [128][kp] (zero past n_bins), by 16-byte copies.
__device__ void load_basis(float2 (*e)[kBins], const float2* __restrict__ e_tab, long long kp,
                           int k0) {
  for (int c = threadIdx.x; c < kLanes * kBins / 2; c += kThreads) {
    const int j = c / (kBins / 2), h = c % (kBins / 2);
    copy16(&e[j][2 * h], e_tab + j * kp + k0 + 2 * h);
  }
}

// Rows [q, q + count) of one series into xs (128 samples a row), zeros
// past the series' end.
__device__ void stage_rows(float* xs, const float* __restrict__ xb, long long q, int count,
                           long long length) {
  for (int c = threadIdx.x; c < count * kLanes; c += kThreads) {
    if (q * kLanes + c < length) {
      copy4(xs + c, xb + q * kLanes + c);
    } else {
      xs[c] = 0.f;
    }
  }
}

// One sample of a row's sums at two bins: acc += x (E[j][2p], E[j][2p + 1]).
__device__ __forceinline__ void sample_step(float4& acc, float x, float4 ej) {
  acc.x = fmaf(x, ej.x, acc.x);
  acc.y = fmaf(x, ej.y, acc.y);
  acc.z = fmaf(x, ej.z, acc.z);
  acc.w = fmaf(x, ej.w, acc.w);
}

// G of the staged rows t = u 16 + 2 warp + h (u < kPerWarp / 2, t <
// count) at bins k0 + 2p and k0 + 2p + 1 (h = lane / 16, p = lane % 16;
// (re, im, re, im) in a float4): j = 0..127 in order, four samples a
// 16-byte read of one address a half, one read of E for all the warp's
// rows, each sample feeding four products. `snap` gets the sums before
// sample 4 snap_j4 (the prefix at that phase), if snap_j4 >= 0.
__device__ __forceinline__ void row_sums(const float* xs, const float2 (*e)[kBins], int count,
                                         float4 (&acc)[kPerWarp / 2], int snap_j4,
                                         float4 (&snap)[kPerWarp / 2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, p = lane % 16;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const float4 (*e4)[kBins / 2] = reinterpret_cast<const float4 (*)[kBins / 2]>(e);
  int row[kPerWarp / 2];
#pragma unroll
  for (int u = 0; u < kPerWarp / 2; ++u) {
    acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int t = u * 2 * kWarps + 2 * warp + lane / 16;
    row[u] = (t < count ? t : count - 1) * (kLanes / 4);   // a row past count reads a staged one
  }
#pragma unroll 2
  for (int j4 = 0; j4 < kLanes / 4; ++j4) {
    if (j4 == snap_j4) {
#pragma unroll
      for (int u = 0; u < kPerWarp / 2; ++u) snap[u] = acc[u];
    }
    const float4 ea = e4[4 * j4][p], eb = e4[4 * j4 + 1][p];
    const float4 ec = e4[4 * j4 + 2][p], ed = e4[4 * j4 + 3][p];
#pragma unroll
    for (int u = 0; u < kPerWarp / 2; ++u) {
      const float4 v = xs4[row[u] + j4];
      sample_step(acc[u], v.x, ea);
      sample_step(acc[u], v.y, eb);
      sample_step(acc[u], v.z, ec);
      sample_step(acc[u], v.w, ed);
    }
  }
}

// One chain step: c += W[r] G[q0 + r].
__device__ __forceinline__ void chain_step(float& c_re, float& c_im, float2 wr, float2 gv) {
  c_re = fmaf(wr.x, gv.x, c_re);
  c_re = fmaf(-wr.y, gv.y, c_re);
  c_im = fmaf(wr.x, gv.y, c_im);
  c_im = fmaf(wr.y, gv.x, c_im);
}

// Bit s set where a window starts in tile row i at phase s seg. The tile's
// windows are w_base + m, m < m_end, starting phi_base + m hop samples into
// the tile; `first` is the m of the row's first window; `comb` has bit
// t hop / seg set for each t hop < 128 (a row's phases after its first).
__device__ __forceinline__ unsigned window_slots(int i, int hop, int phi_base, int m_end, int seg,
                                                 unsigned comb, int& first) {
  const int row0 = kLanes * i;
  const int m = (row0 - phi_base + hop - 1) / hop;   // row0 - phi_base > -hop
  const int phi = phi_base + m * hop - row0;
  first = m;
  if (phi >= kLanes || m >= m_end) return 0u;
  unsigned slots = (comb << (phi / seg)) & ((1u << (kLanes / seg)) - 1u);
  while (__popc(slots) > m_end - m) slots &= ~(1u << (31 - __clz(slots)));   // past the last window
  return slots;
}

// One window's bins k and k + 1 (those below n_bins) into its output row
// `o`: T ((((G - lo) + C) + hi), with T's complex product pinned.
__device__ __forceinline__ void emit(float2* o, int k, int n_bins, float4 t, float4 gg,
                                     float4 lo, float4 cc, float4 hi) {
  const float y0r = ((gg.x - lo.x) + cc.x) + hi.x;
  const float y0i = ((gg.y - lo.y) + cc.y) + hi.y;
  const float y1r = ((gg.z - lo.z) + cc.z) + hi.z;
  const float y1i = ((gg.w - lo.w) + cc.w) + hi.w;
  if (k < n_bins) {
    o[k] = make_float2(fmaf(t.x, y0r, __fmul_rn(t.y, y0i)), fmaf(t.x, y0i, -__fmul_rn(t.y, y0r)));
  }
  if (k + 1 < n_bins) {
    o[k + 1] = make_float2(fmaf(t.z, y1r, __fmul_rn(t.w, y1i)),
                           fmaf(t.z, y1i, -__fmul_rn(t.w, y1r)));
  }
}

// G for every needed row, the first of two launches: 64 rows and 32 bins
// a block, stored at row stride kp.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ x, const float2* __restrict__ e_tab,
            float2* __restrict__ gout, Geometry g) {
  extern __shared__ __align__(16) float2 smem_rows[];
  float2 (*e)[kBins] = reinterpret_cast<float2 (*)[kBins]>(smem_rows);
  float* xs = reinterpret_cast<float*>(smem_rows + kLanes * kBins);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = blockIdx.x / g.row_tiles;
  const long long q_base = (blockIdx.x % g.row_tiles) * kPerBlock;
  const int k0 = blockIdx.y * kBins;
  load_basis(e, e_tab, g.kp, k0);
  stage_rows(xs, x + b * g.length, q_base, kPerBlock, g.length);
  copies_done();
  __syncthreads();
  float4 acc[kPerWarp / 2], unused[kPerWarp / 2];
  row_sums(xs, e, kPerBlock, acc, -1, unused);
#pragma unroll
  for (int u = 0; u < kPerWarp / 2; ++u) {
    const long long q = q_base + u * 2 * kWarps + 2 * warp + lane / 16;
    if (q < g.q_rows) {
      *reinterpret_cast<float4*>(gout + (b * g.q_rows + q) * g.kp + k0 + 2 * (lane % 16)) = acc[u];
    }
  }
}

// X[b, w, k] of the windows starting in one tile of M start rows, 32 bins
// a block; P = 128 / gcd(hop, 128) phases a row.
template <int P>
__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const float* __restrict__ x, const float2* __restrict__ tw,
            const float2* __restrict__ e_tab, const float2* __restrict__ gin,
            float2* __restrict__ out, Geometry g) {
  constexpr int kSeg = kLanes / P;   // every phase is a multiple of gcd(hop, 128) >= 8
  extern __shared__ __align__(16) float2 smem[];
  float2 (*e)[kBins] = reinterpret_cast<float2 (*)[kBins]>(smem);
  float2 (*gq)[kBins] = e + kLanes;        // G of the tile's start rows
  float2 (*cq)[kBins] = gq + g.tile;       // C of the tile's start rows
  float2 (*pa)[kBins] = cq + g.tile;       // snap: A_i(64) of start row i
  float2 (*pb)[kBins] = pa + g.tile;       // snap: A_{i+R}(64), its boundary row's
  float2 (*ring)[kBins] = g.snap ? pb + g.tile : pa;   // G rows, tile row i in slot i mod ring
  float2 (*wt)[kBins] = ring + g.ring;     // a chunk of W rows (two in two passes)
  float* xs = reinterpret_cast<float*>(wt + kChainRows);   // one launch only
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = blockIdx.x / g.tiles;
  const long long q_first = (blockIdx.x % g.tiles) * g.tile;
  const int k0 = blockIdx.y * kBins, k = k0 + lane;
  const float* xb = x + b * g.length;
  load_basis(e, e_tab, g.kp, k0);
  // T_phi[k] = conj(W_n^(phi k)) at phase s seg: the table's entry (s seg
  // k) mod n, fetched now for the windows at the end
  float2 t_pre[(P + kWarps - 1) / kWarps];
#pragma unroll
  for (int u = 0; u < (P + kWarps - 1) / kWarps; ++u) {
    const int s = warp + kWarps * u;
    const unsigned idx = (static_cast<unsigned>(s * kSeg) * static_cast<unsigned>(k)) % g.n;
    t_pre[u] = s < P ? __ldg(tw + idx) : make_float2(0.f, 0.f);
  }

  // ---- G rows and the chains, kChainRows steps r at a time. Chunk
  // [r0, r0 + rows) reads tile rows [r0, r0 + rows + M - 1) of G.
  const int gb = warp * kGroup;   // this warp's start rows: tile rows gb .. gb + 7
  float c_re[kGroup], c_im[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) c_re[j] = c_im[j] = 0.f;
  // W_n^(128 r k) = W_R^(r k): the table's entry 128 ((r k) mod R). This
  // thread copies rows r0 + warp + 8 i of every chunk.
  const unsigned kr = static_cast<unsigned>(k % g.r_rows);
  const unsigned w_step = (kWarps * kr) % g.r_rows;
  unsigned w_idx = ((1u + warp) * kr) % g.r_rows;
  auto chunk_rows = [&](int r0) { return g.r_rows - r0 < kChainRows ? g.r_rows - r0 : kChainRows; };
  // with snap, the last chunk also sums tile row M + R - 1 for its prefix
  auto chunk_end = [&](int r0) {
    const int rows = chunk_rows(r0);
    return r0 + rows + g.tile - 1 + (g.snap && r0 + rows == g.r_rows ? 1 : 0);
  };
  // a chunk of W rows into `wb`: this thread's rows warp + 8 i
  auto load_w = [&](float2 (*wb)[kBins]) {
#pragma unroll
    for (int i = 0; i < kChainRows / kWarps; ++i) {
      if (k < g.n_bins) {
        copy8(&wb[warp + kWarps * i][lane], tw + kLanes * w_idx);
      } else {
        wb[warp + kWarps * i][lane] = make_float2(0.f, 0.f);
      }
      w_idx += w_step;
      if (w_idx >= static_cast<unsigned>(g.r_rows)) w_idx -= g.r_rows;
    }
  };
  // c_j += W[r] G[gb + j + r] for r in [r0, r0 + rows), r ascending; the G
  // rows of 8 steps slide through registers (15 reads for 64 products)
  auto chain = [&](int r0, int rows, const float2 (*wb)[kBins]) {
    if (gb >= g.tile) return;
    int base = (gb + r0) % g.ring;
    int rb = 0;
    for (; rb + kGroup <= rows; rb += kGroup) {
      float2 gv[2 * kGroup - 1];
#pragma unroll
      for (int t = 0; t < 2 * kGroup - 1; ++t) {
        const int sl = base + t < g.ring ? base + t : base + t - g.ring;
        gv[t] = ring[sl][lane];
      }
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const float2 wr = wb[rb + s][lane];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) chain_step(c_re[j], c_im[j], wr, gv[s + j]);
      }
      base = base + kGroup < g.ring ? base + kGroup : base + kGroup - g.ring;
    }
    for (; rb < rows; ++rb) {
      const float2 wr = wb[rb][lane];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int sl = base + j < g.ring ? base + j : base + j - g.ring;
        chain_step(c_re[j], c_im[j], wr, ring[sl][lane]);
      }
      base = base + 1 < g.ring ? base + 1 : 0;
    }
  };
  if (g.two_pass) {
    // G rows [from, to) of the tile from the rows pass, by 16-byte copies
    auto load_g = [&](int from, int to) {
      for (int c = threadIdx.x; c < (to - from) * (kBins / 2); c += kThreads) {
        const int t = from + c / (kBins / 2), h = c % (kBins / 2);
        const long long rho = q_first + t;
        float2* dst = &ring[t % g.ring][2 * h];
        if (rho < g.q_rows) {
          const float2* src = gin + (b * g.q_rows + rho) * g.kp + k0 + 2 * h;
          copy16(dst, src);
          if (t < g.tile) copy16(&gq[t][2 * h], src);
        } else {
          dst[0] = dst[1] = make_float2(0.f, 0.f);
          if (t < g.tile) gq[t][2 * h] = gq[t][2 * h + 1] = make_float2(0.f, 0.f);
        }
      }
    };
    // the next chunk's G rows and W are copied while this chunk's chain
    // runs (the ring holds two chunks past the tile, W two buffers)
    load_w(wt);
    load_g(0, chunk_end(1));
    copies_commit();
    for (int r0 = 1, buf = 0; r0 < g.r_rows; r0 += kChainRows, buf ^= 1) {
      const bool more = r0 + kChainRows < g.r_rows;
      if (more) {
        load_w(wt + (buf ^ 1) * kChainRows);
        load_g(chunk_end(r0), chunk_end(r0 + kChainRows));
      }
      copies_done(more);
      __syncthreads();
      chain(r0, chunk_rows(r0), wt + buf * kChainRows);
      __syncthreads();   // this chunk's rows and W are copied over two chunks on
    }
  } else {
    int filled = 0;   // tile rows of G summed so far
    for (int r0 = 1; r0 < g.r_rows; r0 += kChainRows) {
      const int target = chunk_end(r0);
      __syncthreads();   // the last chunk's reads of the ring and of W are done
      load_w(wt);
      while (filled < target) {
        const int count = target - filled < g.fill ? target - filled : g.fill;
        stage_rows(xs, xb, q_first + filled, count, g.length);
        copies_done();
        __syncthreads();
        float4 acc[kPerWarp / 2], pre[kPerWarp / 2];
        row_sums(xs, e, count, acc, g.snap ? kLanes / 8 : -1, pre);
#pragma unroll
        for (int u = 0; u < kPerWarp / 2; ++u) {
          const int t = u * 2 * kWarps + 2 * warp + lane / 16;
          if (t < count) {
            const int row = filled + t;
            reinterpret_cast<float4*>(ring[row % g.ring])[lane % 16] = acc[u];
            if (row < g.tile) reinterpret_cast<float4*>(gq[row])[lane % 16] = acc[u];
            if (g.snap && row < g.tile) reinterpret_cast<float4*>(pa[row])[lane % 16] = pre[u];
            if (g.snap && row >= g.r_rows && row - g.r_rows < g.tile) {
              reinterpret_cast<float4*>(pb[row - g.r_rows])[lane % 16] = pre[u];
            }
          }
        }
        filled += count;
        __syncthreads();   // xs is staged again by the next batch
      }
      chain(r0, chunk_rows(r0), wt);
    }
  }
  if (gb < g.tile) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) cq[gb + j][lane] = make_float2(c_re[j], c_im[j]);
  }
  __syncthreads();   // the sweeps reuse the ring's memory

  // ---- The boundary prefixes. Walk c (c < min(R, M)) is tile rows c,
  // c + R, c + 2R, ... below M + R: each row is the start row of the
  // windows that read its prefix as lo (if below M) and the boundary row
  // of the windows starting R rows before it (if R or more). A sweep
  // carries whole walks, walk u's m-th row as sweep row u walk_len + m,
  // so a start row's boundary row is the next sweep row.
  // Each half of a warp carries a sweep of up to `rows_each` rows (8, or
  // 4 where 8 would leave halves idle), at bins k0 + 2p and k0 + 2p + 1;
  // its rows' samples are staged 64 at a time.
  const int walks = g.r_rows < g.tile ? g.r_rows : g.tile;
  const int long_sweeps = (walks + kSweep / g.walk_len - 1) / (kSweep / g.walk_len);
  const int rows_each = g.walk_len <= kSweep / 2 && long_sweeps < 2 * kWarps ? kSweep / 2 : kSweep;
  const int per_sweep = rows_each / g.walk_len;
  const int used_rows = per_sweep * g.walk_len;   // rows of a sweep that whole walks fill
  const int sweeps = (walks + per_sweep - 1) / per_sweep;
  const int half = lane / 16, p = lane % 16;
  float* xh = reinterpret_cast<float*>(ring) + (2 * warp + half) * kSweep * (kLanes / 2);
  const float4* xh4 = reinterpret_cast<const float4*>(xh);
  const float4 (*e4)[kBins / 2] = reinterpret_cast<const float4 (*)[kBins / 2]>(e);
  const float4 (*gq4)[kBins / 2] = reinterpret_cast<const float4 (*)[kBins / 2]>(gq);
  const float4 (*cq4)[kBins / 2] = reinterpret_cast<const float4 (*)[kBins / 2]>(cq);
  float2 (*tq)[kBins] = reinterpret_cast<float2 (*)[kBins]>(
      reinterpret_cast<float*>(ring) + kWarps * kSweep * kLanes);
  const float4 (*tq4)[kBins / 2] = reinterpret_cast<const float4 (*)[kBins / 2]>(tq);
#pragma unroll
  for (int u = 0; u < (P + kWarps - 1) / kWarps; ++u) {
    if (warp + kWarps * u < P) tq[warp + kWarps * u][lane] = t_pre[u];
  }
  __syncthreads();
  // the tile's windows: w_base + m, m < m_end, starting phi_base + m hop
  // samples into the tile
  const long long s_base = kLanes * q_first;
  const long long w_base = (s_base + g.hop - 1) / g.hop;
  const int phi_base = static_cast<int>(w_base * g.hop - s_base);
  const long long m_left = g.nwin - w_base;
  const int m_end = m_left < (1LL << 30) ? static_cast<int>(m_left) : (1 << 30);
  unsigned comb = 0;
  for (int t = 0; t * g.hop < kLanes; ++t) comb |= 1u << (t * g.hop / kSeg);
  if (P == 2 && g.snap) {
    // the windows at phases 0 and 64 of each start row, from the prefixes
    // the G sums passed through (A(0) = 0): no sweep
    const float4 (*pa4)[kBins / 2] = reinterpret_cast<const float4 (*)[kBins / 2]>(pa);
    const float4 (*pb4)[kBins / 2] = reinterpret_cast<const float4 (*)[kBins / 2]>(pb);
    for (int i = 2 * warp + half; i < g.tile; i += 2 * kWarps) {
      int next;
      const unsigned own = window_slots(i, g.hop, phi_base, m_end, kSeg, comb, next);
      const float4 gg = gq4[i][p], cc = cq4[i][p];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if ((own >> s) & 1u) {
          const float4 lo = s ? pa4[i][p] : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 hi = s ? pb4[i][p] : make_float4(0.f, 0.f, 0.f, 0.f);
          emit(out + (b * g.nwin + w_base + next) * g.n_bins, k0 + 2 * p, g.n_bins, tq4[s][p],
               gg, lo, cc, hi);
          ++next;
        }
      }
    }
    return;
  }
  // each half's sweep rows: tile row [v] and first window [kSweep + v]
  int* table = reinterpret_cast<int*>(tq + 16) + (2 * warp + half) * 2 * kSweep;
  for (int sw0 = 2 * warp; sw0 < sweeps; sw0 += 2 * kWarps) {
    const int sw = sw0 + half;
    unsigned own[kSweep];   // phases of the windows starting in the row (bit s: s seg)
    unsigned cont = 0;      // bit v: row v continues its walk (its previous row is v - 1)
    int top = 0;
#pragma unroll
    for (int v = 0; v < kSweep; ++v) {
      const int u = v / g.walk_len, m = v % g.walk_len;
      const int c = sw * per_sweep + u;
      const int i = c + m * g.r_rows;
      const bool ok = sw < sweeps && u < per_sweep && c < walks && i < g.tile + g.r_rows;
      int first = 0;
      own[v] = ok && i < g.tile ? window_slots(i, g.hop, phi_base, m_end, kSeg, comb, first) : 0u;
      if (p == 0) {
        table[v] = ok ? i : -1;
        table[kSweep + v] = first;
      }
      cont |= (m > 0 ? 1u : 0u) << v;
      const unsigned used = own[v] | (v > 0 && m > 0 ? own[v > 0 ? v - 1 : 0] : 0u);
      const int lim = used ? (31 - __clz(used)) * kSeg : 0;
      top = lim > top ? lim : top;
    }
    const int top_other = __shfl_xor_sync(0xffffffffu, top, 16);
    top = top > top_other ? top : top_other;
    __syncwarp();
    // samples [j0, j0 + 64) of this half's rows, zero past each row's last phase
    auto stage = [&](int j0) {
#pragma unroll
      for (int v = 0; v < kSweep; ++v) {
        if (v >= used_rows) break;
        const unsigned used = own[v] | (v > 0 && ((cont >> v) & 1u) ? own[v > 0 ? v - 1 : 0] : 0u);
        const int lim = used ? (31 - __clz(used)) * kSeg : 0;
        const float* src = xb + (q_first + table[v]) * kLanes + j0;
#pragma unroll
        for (int jj = p; jj < kLanes / 2; jj += 16) {
          if (j0 + jj < lim) {
            copy4(xh + v * (kLanes / 2) + jj, src + jj);
          } else {
            xh[v * (kLanes / 2) + jj] = 0.f;
          }
        }
      }
      copies_done();
      __syncwarp();
    };
    if (top > 0) stage(0);
    float4 a[kSweep];
#pragma unroll
    for (int v = 0; v < kSweep; ++v) a[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int s = 0; s < P; ++s) {
      if (s * kSeg > top) break;
      if (s > 0) {
        if ((s - 1) * kSeg == kLanes / 2) {
          __syncwarp();   // every lane is done with the first 64 samples
          stage(kLanes / 2);
        }
        // samples [(s - 1) seg, s seg) of every sweep row, j ascending
#pragma unroll
        for (int t = 0; t < kSeg / 4; ++t) {
          const int j4 = (s - 1) * (kSeg / 4) + t;
          const float4 ea = e4[4 * j4][p], eb = e4[4 * j4 + 1][p];
          const float4 ec = e4[4 * j4 + 2][p], ed = e4[4 * j4 + 3][p];
#pragma unroll
          for (int v = 0; v < kSweep; ++v) {
            if (v >= used_rows) break;
            const float4 u = xh4[v * (kLanes / 8) + j4 % (kLanes / 8)];
            sample_step(a[v], u.x, ea);
            sample_step(a[v], u.y, eb);
            sample_step(a[v], u.z, ec);
            sample_step(a[v], u.w, ed);
          }
        }
      }
      // the windows at phase s seg: ((G - A_q0) + C) + A_{q0+R}, then T;
      // a row's window at phase s is its popc(own & (2^s - 1))-th
      const float4 tt = tq4[s][p];
#pragma unroll
      for (int v = 0; v + 1 < kSweep; ++v) {
        if ((own[v] >> s) & 1u) {
          const int i = table[v];
          const int m = table[kSweep + v] + __popc(own[v] & ((1u << s) - 1u));
          emit(out + (b * g.nwin + w_base + m) * g.n_bins, k0 + 2 * p, g.n_bins, tt,
               gq4[i][p], a[v], cq4[i][p], a[v + 1]);
        }
      }
    }
    __syncwarp();   // the rows and the table are written again by the next sweeps
  }
}

template <int P>
int launch_tiles(dim3 grid, int smem, cudaStream_t st, const float* x, const float2* tw,
                 const float2* etab, const float2* gs, float2* out, const Geometry& geo) {
  cudaError_t err =
      cudaFuncSetAttribute(tile_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's unified memory as shared memory, so that two blocks fit
  err = cudaFuncSetAttribute(tile_kernel<P>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_kernel<P><<<grid, kThreads, smem, st>>>(x, tw, etab, gs, out, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [batch, length] float32, contiguous rows, any alignment (4-byte
// copies); tw: [n] float2 (cos, -sin) of 2 pi m / n; e_tab: [128, kp]
// float2, tw[(j k) mod n] for k < n_bins and zero to kp (n_bins rounded
// up to 32); g: [batch, q_rows, kp] float2 scratch (two_pass only, else
// unused); out: [batch, nwin, n_bins] complex64 as float2. n = 128 R with
// R >= 2; q_rows = ((nwin - 1) hop) / 128 + R; the last window ends inside
// the series. tile (M) and walk_len come from launch_plan: M a multiple of
// 8 in [8, 64], walk_len = (M + R - 1) / R + 1 <= 8.
extern "C" int hopped_dft_launch(const void* x, const void* tw, const void* e_tab, void* g, void* out,
                                 long long batch, long long length, int n, int hop, int n_bins,
                                 long long nwin, long long q_rows, int tile, int walk_len,
                                 int two_pass, void* stream) {
  if (hop < 1 || n % kLanes != 0 || n < 2 * kLanes || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int seg = kLanes;   // gcd(hop, 128)
  while (hop % seg) seg /= 2;
  const int r_rows = n / kLanes;
  if (kLanes / seg > 16 || n_bins < 1 || n_bins > n / 2 || batch < 0 || nwin < 1 ||
      length < n + (nwin - 1) * hop || q_rows != ((nwin - 1) * hop) / kLanes + r_rows ||
      tile < kGroup || tile > kMaxTile || tile % kGroup != 0 ||
      walk_len != (tile + r_rows - 1) / r_rows + 1 || walk_len > kSweep ||
      (two_pass != 0 && two_pass != 1) || (two_pass && g == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Geometry geo;
  geo.length = length;
  geo.nwin = nwin;
  geo.q_rows = q_rows;
  geo.row_tiles = (q_rows + kPerBlock - 1) / kPerBlock;
  const long long q_starts = ((nwin - 1) * hop) / kLanes + 1;
  geo.tiles = (q_starts + tile - 1) / tile;
  const long long bin_tiles = (n_bins + kBins - 1) / kBins;
  geo.kp = bin_tiles * kBins;
  geo.n = n;
  geo.r_rows = r_rows;
  geo.hop = hop;
  geo.n_bins = n_bins;
  geo.tile = tile;
  geo.ring = tile + kChainRows * (two_pass ? 2 : 1);
  geo.fill = two_pass ? 0 : (tile <= 32 ? 64 : 32);
  geo.walk_len = walk_len;
  geo.two_pass = two_pass;
  geo.snap = kLanes / seg == 2 && !two_pass;
  const int smem = tile_smem(tile, two_pass, geo.snap);
  if (bin_tiles > 65535 || batch * geo.row_tiles > 0x7fffffffLL ||
      batch * geo.tiles > 0x7fffffffLL || smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const float* xs = static_cast<const float*>(x);
  const float2* tab = static_cast<const float2*>(tw);
  const float2* etab = static_cast<const float2*>(e_tab);
  float2* gs = static_cast<float2*>(g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (two_pass) {
    err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowsSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 rows_grid(static_cast<unsigned>(batch * geo.row_tiles), static_cast<unsigned>(bin_tiles));
    rows_kernel<<<rows_grid, kThreads, kRowsSmem, st>>>(xs, etab, gs, geo);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(batch * geo.tiles), static_cast<unsigned>(bin_tiles));
  float2* o = static_cast<float2*>(out);
  switch (kLanes / seg) {
    case 1: return launch_tiles<1>(grid, smem, st, xs, tab, etab, gs, o, geo);
    case 2: return launch_tiles<2>(grid, smem, st, xs, tab, etab, gs, o, geo);
    case 4: return launch_tiles<4>(grid, smem, st, xs, tab, etab, gs, o, geo);
    case 8: return launch_tiles<8>(grid, smem, st, xs, tab, etab, gs, o, geo);
    default: return launch_tiles<16>(grid, smem, st, xs, tab, etab, gs, o, geo);
  }
}
