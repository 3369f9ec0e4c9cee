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
// Design: one thread per matrix, so every rotation of a round is plain
// per-thread scalar code and the batch supplies the parallelism, as the
// TPU kernel put the batch on the vector lanes. A block holds T matrices
// and their eigenvector accumulators in shared memory in a
// struct-of-arrays layout, element (i, j) of matrix t at (i*m + j)*T + t,
// so the threads of a warp touch 32 consecutive words (no bank
// conflicts). Loads and stores go through shared memory cooperatively so
// that global memory is read and written in contiguous runs. The
// round-robin pairs come in a small table, in the order of
// analyze/jacobi.py::_round_robin_pairs. The rotation is the half angle
// t = 0.5*atan2(y, x), with the exact y == 0 case forced to the
// identity: real symmetric Toeplitz covariances reach exact zeros
// mid-sweep, and c = s = 0 would wipe out both rows. The larger of
// cos t, sin t comes from its half-angle formula and the smaller from
// sin 2t = 2 sin t cos t; taking both from half-angle formulas, as the
// TPU kernel does, cancels for small angles and stalls the off-diagonal
// near sqrt(eps) of the scale. Eigenpairs are returned unsorted (the
// diagonal and V); the caller sorts them. Compiled with --fmad=false, so
// that every rotation rounds as the plain PyTorch version's does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 32;
constexpr int kMaxHalf = kMaxM / 2;

__global__ void jacobi_eigh_kernel(const float* __restrict__ a,
                                   float* __restrict__ vals,
                                   float* __restrict__ vecs,
                                   const int* __restrict__ pairs,
                                   int n_rounds, int half, int batch, int m,
                                   int sweeps) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int mm = m * m;
  float* A = smem;
  float* V = smem + mm * T;
  const long long first = static_cast<long long>(blockIdx.x) * T;

  // Cooperative load: the block's T matrices are one contiguous run of
  // T*m*m floats in global memory. Matrices past the batch end become
  // the identity (their rotations are trivial and never stored).
  for (int e = t; e < T * mm; e += T) {
    const int mat = e / mm;
    const int el = e - mat * mm;
    const long long b = first + mat;
    const int i = el / m;
    const int j = el - i * m;
    float x = (i == j) ? 1.0f : 0.0f;
    if (b < batch) x = a[b * mm + el];
    A[el * T + mat] = x;
    V[el * T + mat] = (i == j) ? 1.0f : 0.0f;
  }
  __syncthreads();

  float cs[kMaxHalf];
  float sn[kMaxHalf];
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < n_rounds; ++r) {
      const int* rp = pairs + 2 * r * half;
      // Rotation angles of every pair from the matrix at round start.
      for (int k = 0; k < half; ++k) {
        const int p = rp[2 * k];
        const int q = rp[2 * k + 1];
        if (p < 0) continue;
        const float y = 2.0f * A[(p * m + q) * T + t];
        const float x = A[(q * m + q) * T + t] - A[(p * m + p) * T + t];
        const float rr = sqrtf(x * x + y * y);
        float c = 1.0f, s = 0.0f;
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
        cs[k] = c;
        sn[k] = s;
      }
      // Rows: R^T A.
      for (int k = 0; k < half; ++k) {
        const int p = rp[2 * k];
        const int q = rp[2 * k + 1];
        if (p < 0) continue;
        const float c = cs[k], s = sn[k];
        for (int j = 0; j < m; ++j) {
          const float xp = A[(p * m + j) * T + t];
          const float xq = A[(q * m + j) * T + t];
          A[(p * m + j) * T + t] = c * xp - s * xq;
          A[(q * m + j) * T + t] = s * xp + c * xq;
        }
      }
      // Columns: (R^T A) R, and the eigenvector accumulator V R.
      for (int k = 0; k < half; ++k) {
        const int p = rp[2 * k];
        const int q = rp[2 * k + 1];
        if (p < 0) continue;
        const float c = cs[k], s = sn[k];
        for (int i = 0; i < m; ++i) {
          const float xp = A[(i * m + p) * T + t];
          const float xq = A[(i * m + q) * T + t];
          A[(i * m + p) * T + t] = c * xp - s * xq;
          A[(i * m + q) * T + t] = s * xp + c * xq;
          const float vp = V[(i * m + p) * T + t];
          const float vq = V[(i * m + q) * T + t];
          V[(i * m + p) * T + t] = c * vp - s * vq;
          V[(i * m + q) * T + t] = s * vp + c * vq;
        }
      }
    }
  }

  const long long b = first + t;
  if (b < batch) {
    for (int i = 0; i < m; ++i) vals[b * m + i] = A[(i * m + i) * T + t];
  }
  __syncthreads();
  for (int e = t; e < T * mm; e += T) {
    const int mat = e / mm;
    const int el = e - mat * mm;
    const long long bb = first + mat;
    if (bb < batch) vecs[bb * mm + el] = V[el * T + mat];
  }
}

}  // namespace

extern "C" int jacobi_eigh_launch(const void* a, void* vals, void* vecs,
                                  const void* pairs, int n_rounds, int half,
                                  int batch, int m, int sweeps,
                                  int per_block, void* stream) {
  if (m < 1 || m > kMaxM || half > kMaxHalf || per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int blocks = (batch + per_block - 1) / per_block;
  const size_t smem = 2 * sizeof(float) * m * m * per_block;
  jacobi_eigh_kernel<<<blocks, per_block, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(vals),
      static_cast<float*>(vecs), static_cast<const int*>(pairs), n_rounds,
      half, batch, m, sweeps);
  return static_cast<int>(cudaGetLastError());
}
