// Batched eigendecomposition of small symmetric matrices by
// parallel-ordering cyclic Jacobi.
//
// Replaces: wavespec_tpu/kernels/jacobi_pallas.py::jacobi_eigh_pallas
// (Pallas `_kernel` and `_rotation_cs`) on the MUSIC path, where it runs
// on the R x m x m band covariances of every window (B = 3 * windows
// matrices of 10 x 10 at the flagship configuration).
//
// What bounds it: neither bytes nor FLOPs. One matrix is 400 B in and
// 440 B out, and 6 sweeps of m-1 rounds cost ~20 kFLOP of dependent
// scalar work: the limit is the length of that dependent chain per
// matrix and the number of matrices in flight to hide it.
//
// Design: a warp per matrix, so the chain of a round is split over the
// lanes. For m <= 16 a warp packs G = floor(32 / m) matrices (3 at
// m = 10); for m > 16 it holds one. A and V of each matrix live row-major
// in the warp's slice of shared memory, each matrix's slot S >= m*m
// floats with S = m (mod 32), so that the G matrices' rows fall on
// different banks. A round (the round-robin pairs of
// analyze/jacobi.py::_round_robin_pairs, from a small table) takes three
// phases with __syncwarp() between them:
// 1. rotations: lane (g, k) < G*half computes pair k's (c, s) of
//    matrix g from the round-start matrix, into shared memory;
// 2. rows, R^T A: lane (g, j) < G*m updates column j's p and q entries
//    of every pair (consecutive lanes, consecutive addresses);
// 3. columns, A R and V R: lane (g, i) updates row i's p and q entries.
// Lanes past G*m idle. The chain per lane is about m/2 rotations of two
// elements a phase instead of a thread's ~m^2 updates a round.
// For m > 32 (the wide instantiation) a warp holds one matrix and a lane
// takes rotations k, k + 32, ... of a round, then columns (rows) j,
// j + 32, ...; the pair table stays in global memory (L1) so that A and
// V alone fill shared memory, which sets the largest m (kMaxM).
// The rotation is the half angle t = 0.5*atan2(y, x), with the exact
// y == 0 case forced to the identity: real symmetric Toeplitz
// covariances reach exact zeros mid-sweep, and c = s = 0 would wipe out
// both rows. The larger of cos t, sin t comes from its half-angle formula
// and the smaller from sin 2t = 2 sin t cos t; taking both from
// half-angle formulas, as the TPU kernel does, cancels for small angles
// and stalls the off-diagonal near sqrt(eps) of the scale. Every element
// update and rotation keeps the formulas of the plain PyTorch version
// (analyze/jacobi.py::jacobi_eigh_plain); only who computes them
// changes, so with --fmad=false the kernel equals it bitwise. Eigenpairs
// are returned unsorted (the diagonal and V); the caller sorts them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNarrowM = 32;     // the narrow instantiation's largest m
constexpr int kMaxM = 160;       // A and V of one matrix in 200 KB
constexpr int kMaxHalf = kMaxM / 2;
constexpr int kMaxWarps = 8;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemOptin = 227 * 1024;

struct Layout {
  int m, mm, g, slot, half;   // g: matrices a warp holds; slot: floats per matrix
  int warp_floats;            // A, V and (c, s) of one warp
};

__host__ __device__ inline Layout layout(int m, int half) {
  Layout l;
  l.m = m;
  l.mm = m * m;
  l.g = m <= 16 ? 32 / m : 1;
  l.slot = l.mm + ((m - l.mm) % 32 + 32) % 32;
  l.half = half;
  l.warp_floats = 2 * l.g * l.slot + 2 * l.g * half;
  return l;
}

template <bool kWide>
__global__ void jacobi_eigh_kernel(const float* __restrict__ a,
                                   float* __restrict__ vals,
                                   float* __restrict__ vecs,
                                   const int* __restrict__ pairs,
                                   int n_rounds, int half, int batch, int m,
                                   int sweeps) {
  extern __shared__ float smem[];
  const Layout L = layout(m, half);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // the pair table: in shared memory (narrow), or read through L1 (wide)
  const int n_pairs = kWide ? 0 : n_rounds * half;
  const int* pq = pairs;
  if (!kWide) {
    int* tbl = reinterpret_cast<int*>(smem);
    for (int e = threadIdx.x; e < 2 * n_pairs; e += blockDim.x) tbl[e] = pairs[e];
    pq = tbl;
  }
  float* A = smem + 2 * n_pairs + warp * L.warp_floats;
  float* V = A + L.g * L.slot;
  float* cs = V + L.g * L.slot;   // [g][half] (c, s)
  const long long first = (static_cast<long long>(blockIdx.x) * warps + warp) * L.g;

  // The warp's G matrices are one contiguous run of G*m*m floats in
  // global memory. Matrices past the batch end become the identity
  // (their rotations are trivial and never stored).
  for (int e = lane; e < L.g * L.mm; e += 32) {
    const int g = e / L.mm;
    const int el = e - g * L.mm;
    const long long b = first + g;
    const int i = el / m;
    const int j = el - i * m;
    float x = (i == j) ? 1.0f : 0.0f;
    if (b < batch) x = a[b * L.mm + el];
    A[g * L.slot + el] = x;
    V[g * L.slot + el] = (i == j) ? 1.0f : 0.0f;
  }
  __syncthreads();

  // lane roles: (rg, k) for the rotations, (eg, e) for rows and columns
  const int rg = lane / half, k_rot = lane - rg * half;
  const bool rot_lane = rg < L.g;
  const int eg = lane / m, e_idx = lane - eg * m;
  const bool el_lane = eg < L.g;
  float* Ar = A + (rot_lane ? rg : 0) * L.slot;
  float* Ae = A + (el_lane ? eg : 0) * L.slot;
  float* Ve = V + (el_lane ? eg : 0) * L.slot;
  float2* cs_r = reinterpret_cast<float2*>(cs) + (rot_lane ? rg : 0) * half;
  const float2* cs_e = reinterpret_cast<const float2*>(cs) + (el_lane ? eg : 0) * half;

  // a lane's rotations, columns and rows: one each (narrow), or every
  // 32nd (wide)
  const int rot_end = kWide ? half : k_rot + 1;
  const int el_end = kWide ? m : e_idx + 1;

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < n_rounds; ++r) {
      const int* rp = pq + 2 * r * half;
      // 1. Rotation of pair k_rot from the matrix at round start.
      for (int kr = k_rot; rot_lane & (kr < rot_end); kr += 32) {
        const int p = rp[2 * kr];
        const int q = rp[2 * kr + 1];
        float c = 1.0f, s = 0.0f;
        if (p >= 0) {
          const float y = 2.0f * Ar[p * m + q];
          const float x = Ar[q * m + q] - Ar[p * m + p];
          const float rr = sqrtf(x * x + y * y);
          if (rr > 1e-30f && y != 0.0f) {
            const float xr = x / rr;
            const float yr = y / rr;
            if (xr >= 0.0f) {
              c = sqrtf(0.5f * (1.0f + xr));
              s = 0.5f * yr / c;
            } else {
              s = copysignf(sqrtf(fmaxf(0.5f * (1.0f - xr), 0.0f)), yr);
              c = 0.5f * yr / s;
            }
          }
        }
        cs_r[kr] = make_float2(c, s);
      }
      __syncwarp();
      // 2. Rows: R^T A, lane = column j.
      for (int j = e_idx; el_lane & (j < el_end); j += 32) {
        for (int k = 0; k < half; ++k) {
          const int p = rp[2 * k];
          const int q = rp[2 * k + 1];
          if (p < 0) continue;
          const float2 w = cs_e[k];
          const float xp = Ae[p * m + j];
          const float xq = Ae[q * m + j];
          Ae[p * m + j] = w.x * xp - w.y * xq;
          Ae[q * m + j] = w.y * xp + w.x * xq;
        }
      }
      __syncwarp();
      // 3. Columns: (R^T A) R and V R, lane = row i.
      for (int i = e_idx; el_lane & (i < el_end); i += 32) {
        for (int k = 0; k < half; ++k) {
          const int p = rp[2 * k];
          const int q = rp[2 * k + 1];
          if (p < 0) continue;
          const float2 w = cs_e[k];
          const float xp = Ae[i * m + p];
          const float xq = Ae[i * m + q];
          Ae[i * m + p] = w.x * xp - w.y * xq;
          Ae[i * m + q] = w.y * xp + w.x * xq;
          const float vp = Ve[i * m + p];
          const float vq = Ve[i * m + q];
          Ve[i * m + p] = w.x * vp - w.y * vq;
          Ve[i * m + q] = w.y * vp + w.x * vq;
        }
      }
      __syncwarp();
    }
  }

  for (int i = e_idx; el_lane & (i < el_end); i += 32) {
    const long long b = first + eg;
    if (b < batch) vals[b * m + i] = Ae[i * m + i];
  }
  for (int e = lane; e < L.g * L.mm; e += 32) {
    const int g = e / L.mm;
    const int el = e - g * L.mm;
    const long long b = first + g;
    if (b < batch) vecs[b * L.mm + el] = V[g * L.slot + el];
  }
}

// Warps a block and dynamic shared memory of the launch at (m, half);
// warps is 0 where one matrix does not fit.
void plan(int m, int half, int n_rounds, long long batch, int* warps_out, size_t* smem_out) {
  const bool wide = m > kNarrowM;
  const Layout L = layout(m, half);
  const size_t table = wide ? 0 : sizeof(int) * 2 * n_rounds * half;
  const size_t per_warp = sizeof(float) * L.warp_floats;
  const size_t budget = wide ? kSmemOptin : kSmemDefault;
  int warps = per_warp + table > budget ? 0 : static_cast<int>((budget - table) / per_warp);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const long long groups = (batch + L.g - 1) / L.g;
  if (groups < warps) warps = static_cast<int>(groups);
  *warps_out = warps;
  *smem_out = table + per_warp * warps;
}

}  // namespace

extern "C" int jacobi_eigh_launch(const void* a, void* vals, void* vecs,
                                  const void* pairs, int n_rounds, int half,
                                  int batch, int m, int sweeps, void* stream) {
  if (m < 1 || m > kMaxM || half < 1 || half > kMaxHalf || n_rounds < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  int warps;
  size_t smem;
  plan(m, half, n_rounds, batch, &warps, &smem);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(m, half);
  const long long groups = (static_cast<long long>(batch) + L.g - 1) / L.g;
  const long long blocks = (groups + warps - 1) / warps;
  const bool wide = m > kNarrowM;
  auto kernel = wide ? jacobi_eigh_kernel<true> : jacobi_eigh_kernel<false>;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(vals),
      static_cast<float*>(vecs), static_cast<const int*>(pairs), n_rounds,
      half, batch, m, sweeps);
  return static_cast<int>(cudaGetLastError());
}
