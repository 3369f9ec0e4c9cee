// F1: the v7.57 framed route's frame matrix in one pass. For series b,
// window w and sample j it writes
//
//   out[b, w, j] = (hp[b, w*hop + j] - delta[b, w] * alpha[j]) * taper[j]
//   delta[b, w]  = c2 * x[b, w*hop] - (x[b, w*hop] - hp[b, w*hop])
//
// from the series x, its series-level Ehlers high-pass hp, the table
// alpha^j and the taper's coefficients (no product where the route has no
// taper): what wavespec_tpu_torch/kernels/ehlers_frames.py::
// ehlers_frames_plain computes with PyTorch's eager operators
// (extract.py::frame_highpassed, then the taper's mul_), bitwise equal to
// it on the card.
//
// Replaces: no Pallas kernel. The JAX package builds these frames in XLA
// (wavespec_tpu/extract.py::frame_highpassed); the port's eager chain
// wrote the [..., T, window] float32 matrix, read and wrote it again to
// subtract it from the strided frames of hp, and a third time to taper it.
//
// What bounds it: the matrix's write. At the v7.57 fleet shape (128
// series x 512 frames x 4096) that is 1 GiB, 0.3205 ms at the 3.35 TB/s
// of HBM; at window 16384, 4 GiB and 1.282 ms. What it reads is small
// beside that and stays in L2: x and hp (2.4 MB at 4096, 8.6 MB at
// 16384) and two tables of at most 64 KB.
//
// Design:
// - A block of 256 threads takes kRows consecutive frames (rows) and a
//   run of 256 * VEC samples of them; VEC = 4 where the window is a
//   multiple of 4 (every row then starts on 16 bytes), else 1. A thread
//   keeps its samples' alpha^j and taper in registers over the block's
//   rows and writes each row's samples with one 16-byte streaming store:
//   a warp stores 512 contiguous bytes.
// - hp: at hop 1 a frame starts one sample after the last, so a row's run
//   of hp is not aligned to 16 bytes. A thread reads the aligned float4
//   that holds its first sample and, unless that sample is the float4's
//   first, the next one, and picks its four samples from the pair; the
//   shift is the same for the whole row, so the pick is a uniform branch.
//   Both loads go through L1 (ld.global.nc): the block's next rows read
//   the same lines shifted by hop samples, so each line of hp comes from
//   L2 about once a block and not once a row.
// - delta is computed once a frame: the block's first kRows threads
//   compute its rows' deltas into shared memory before the stores.
// - Every operation that eager rounds on its own is an explicit __f*_rn,
//   in eager's order, and the source is built with --fmad=false
//   (kernels/ehlers_frames.py::BUILD_FLAGS), so no product is contracted
//   into an add.

#include <cuda_runtime.h>
#include <stdint.h>

struct EhlersFramesParams {
  const float* series;   // [rows / frames, length], row stride length
  const float* hp;       // its series-level high-pass, the same layout
  const float* alpha;    // alpha^j, [window]
  const float* taper;    // [window], or null: no taper
  float* out;            // [rows, window]
  long long rows;        // series x frames
  long long length;      // samples a series
  int frames;            // frames a series
  int window;
  int hop;
  float c2;              // the float32 of 2c = 1 - alpha
};

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // frames a block

// x[0..3] = src[0..3], by aligned 16-byte loads (src 4-byte aligned).
// The float4 after the first is read only where the run crosses into it,
// so no load leaves the 16-byte chunks that hold src[0..3].
__device__ __forceinline__ void load_run(const float* src, float (&x)[4]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const float4* base = reinterpret_cast<const float4*>(addr & ~static_cast<uintptr_t>(15));
  const int shift = static_cast<int>((addr >> 2) & 3);
  const float4 a = __ldg(base);
  if (shift == 0) {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    return;
  }
  const float4 b = __ldg(base + 1);
  if (shift == 1) {
    x[0] = a.y; x[1] = a.z; x[2] = a.w; x[3] = b.x;
  } else if (shift == 2) {
    x[0] = a.z; x[1] = a.w; x[2] = b.x; x[3] = b.y;
  } else {
    x[0] = a.w; x[1] = b.x; x[2] = b.y; x[3] = b.z;
  }
}

__device__ __forceinline__ void load_run(const float* src, float (&x)[1]) { x[0] = __ldg(src); }

// Streaming stores (st.global.cs): the matrix is written once and read
// once, by B3, long after L2 would hold it, so its lines go first and
// leave x, hp and the tables in L2.
__device__ __forceinline__ void store_run(float* dst, const float (&y)[4]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(y[0], y[1], y[2], y[3]));
}

__device__ __forceinline__ void store_run(float* dst, const float (&y)[1]) {
  __stcs(dst, y[0]);
}

template <int VEC, bool TAPER>
__global__ void __launch_bounds__(kThreads) ehlers_frames_kernel(const EhlersFramesParams p) {
  __shared__ float delta_s[kRows];
  __shared__ long long start_s[kRows];   // each row's first sample in x and hp
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  if (threadIdx.x < kRows && r0 + threadIdx.x < p.rows) {
    const long long r = r0 + threadIdx.x;
    const long long b = r / p.frames;
    const long long s0 = b * p.length + (r - b * p.frames) * p.hop;
    const float x0 = p.series[s0];
    delta_s[threadIdx.x] = __fsub_rn(__fmul_rn(p.c2, x0), __fsub_rn(x0, p.hp[s0]));
    start_s[threadIdx.x] = s0;
  }
  __syncthreads();
  const int j = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  if (j >= p.window) return;
  float a[VEC], t[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a[k] = __ldg(p.alpha + j + k);
    t[k] = TAPER ? __ldg(p.taper + j + k) : 1.0f;
  }
  const int n = p.rows - r0 < kRows ? static_cast<int>(p.rows - r0) : kRows;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i >= n) break;
    float x[VEC], y[VEC];
    load_run(p.hp + start_s[i] + j, x);
    const float d = delta_s[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      y[k] = __fsub_rn(x[k], __fmul_rn(d, a[k]));
      if (TAPER) y[k] = __fmul_rn(y[k], t[k]);
    }
    store_run(p.out + (r0 + i) * p.window + j, y);
  }
}

template <int VEC, bool TAPER>
cudaError_t launch(const EhlersFramesParams& p, cudaStream_t stream) {
  const long long blocks = (p.rows + kRows - 1) / kRows;
  const int runs = (p.window + kThreads * VEC - 1) / (kThreads * VEC);
  ehlers_frames_kernel<VEC, TAPER><<<dim3(static_cast<unsigned>(blocks), runs), kThreads, 0,
                                     stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One launch: a block a run of kRows frames and 256 * VEC samples.
extern "C" int ehlers_frames_launch(const EhlersFramesParams* p, void* stream) {
  if (p->rows < 0 || p->frames < 1 || p->window < 1 || p->hop < 1 ||
      (p->rows > 0 && (p->length < p->window ||
                       static_cast<long long>(p->frames - 1) * p->hop + p->window > p->length)) ||
      (p->rows + kRows - 1) / kRows > 0x7fffffffLL ||
      (p->window + kThreads - 1) / kThreads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p->rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = p->window % 4 == 0;
  cudaError_t e;
  if (p->taper) {
    e = vec ? launch<4, true>(*p, s) : launch<1, true>(*p, s);
  } else {
    e = vec ? launch<4, false>(*p, s) : launch<1, false>(*p, s);
  }
  return static_cast<int>(e);
}

extern "C" int ehlers_frames_params_size() {
  return static_cast<int>(sizeof(EhlersFramesParams));
}
