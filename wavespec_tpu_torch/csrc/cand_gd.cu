// G1: the v7.57 candidate step in one pass. From band spectra it gives,
// per frame, the strongest in-band bins (power, bin, validity, period)
// and the group delay over bins [lo, lo + nb), what
// wavespec_tpu_torch/kernels/cand_gd.py::cand_gd_plain computes with
// PyTorch's eager operators, bitwise equal to it on the card.
//
// Replaces: no Pallas kernel. The JAX package leaves this step
// (wavespec_tpu/pipeline/v757.py::_cands_and_gd) to XLA, its selection to
// `lax.top_k`; the port's eager chain sorted all in-band bins of every
// frame (a stable radix sort) to keep n_candidates of them, and built the
// group delay in a dozen elementwise passes.
//
// What bounds it: bytes. At the v7.57 batch shape (65,536 frames, bins
// [78, 229], 24 candidates) it reads 65,536 x 152 x 8 B = 79.7 MB of
// bins, writes 65,536 x 24 x 13 B = 20.4 MB of candidates and
// 2 x 65,536 x 152 x 4 B = 79.7 MB of group delay (gd and gd_idx): about
// 0.054 ms at the 3.35 TB/s of HBM. The arithmetic is some hundred
// instructions a bin (an atan2f, the fold, the selection's share).
//
// Design:
// - A warp per frame, lane l on bins t = l + 32 i (t relative to lo),
//   one slot i after the other, the bins two slots ahead on their way
//   while this one is computed; read once with the spectrum's own
//   strides: a frame is (outer, inner) with a stride each, so a slice of
//   frames of a larger block is read in place. Any band width (up to
//   `kSmemMax` / 8 bins) takes the same code.
// - Power as eager rounds it, three roundings and no contraction:
//   __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)).
// - Group delay in the same pass: phase atan2f(im, re); the difference
//   to the next bin's phase (lane l + 1, or lane 0 of the next slot, by
//   a shuffle); the fold into (-pi, pi] with ATen's remainder (fmodf,
//   plus the divisor where the signs differ) and the +pi boundary fix;
//   the centred average with the previous difference (one-sided at both
//   ends); clamped to +/-100 as ATen's clamp (NaN kept). gd: zeros (phase
//   mode), -g / den (REALFFT, den the float32 of 2 pi / (n / 2) built in
//   double), or not written (HYBRID: gd is gd_idx). Python-float scalars
//   are float32 operands, as in eager.
// - Selection, no sort: n_candidates rounds of a warp arg-max. A bin's
//   key orders as torch.sort(descending, stable) does on the card: NaN
//   above everything, then by value (the radix sort's bit order); equal
//   keys in bin order. In the pass each lane inserts its in-band bins
//   into its own column of the warp's shared memory, sorted by key and
//   then bin (key << 32 | ~bin, descending). A round takes the warp's
//   largest head key (one redux) and the lowest bin holding it (a
//   second); the winning lane steps to the next entry of its column. A
//   lane touches only its own column, so the warp never waits on
//   another. The key gives the power back (NaN is the card's one NaN).
//   Result j lands in lane j mod 32, written coalesced after each 32
//   rounds. n_candidates 0 writes every in-band bin in order during the
//   pass instead.
// - One launch of blocks of up to 8 warps, a frame a warp.
//
// The source is built without --use_fast_math and with nvcc's default
// contraction, as PyTorch's elementwise kernels are: atan2f and fmodf are
// the same library code on both sides; every other operation that eager
// rounds on its own is an explicit __f*_rn here.

#include <cuda_runtime.h>
#include <stdint.h>

struct CandGdParams {
  const float2* spec;     // complex64 bins, bin stride 1
  long long outer_stride; // complex elements between outer rows
  long long inner_stride; // complex elements between frames of an outer row
  long long rows;         // frames
  int inner;              // frames an outer row
  int lo;                 // first group-delay bin
  int nb;                 // group-delay bins [lo, lo + nb)
  int band0, band1;       // in-band bins [lo + band0, lo + band1)
  int j;                  // candidates a frame; 0: every in-band bin in order
  int n;                  // window: period = n / bin
  int mode;               // gd: 0 zeros, 1 -g / den, 2 not written (gd is gd_idx)
  float den;
  float* period;
  float* power;
  int* idx;
  uint8_t* valid;
  float* gd;
  float* gd_idx;
};

namespace {

constexpr int kWarps = 8;                     // warps (frames) a block, at most
constexpr int kSmemMax = 232448;              // H100: the opt-in maximum of a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;       // float(math.pi)
constexpr float kTwoPi = 6.28318530717958647692f;    // float(2 * math.pi)
constexpr float kClamp = 100.0f;                     // GROUP_DELAY_CLAMP

// torch.sort's descending order on the card as an unsigned key: NaN
// first, then the radix sort's order of the bits (-0 below +0); 0 marks
// a bin out of the band or taken.
__device__ __forceinline__ unsigned order_key(float p) {
  if (p != p) return kFull;
  const unsigned b = __float_as_uint(p);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The power a key came from: a NaN power is the card's one NaN,
// 0x7fffffff, the result of every arithmetic operation that gives NaN.
__device__ __forceinline__ float key_power(unsigned key) {
  if (key == kFull) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// ops/phase.py::_wrap_principal: remainder(d + pi, 2 pi) - pi, where
// remainder is ATen's (fmodf, plus the divisor where the signs differ),
// and pi where that gives -pi for a positive d. fmodf's result is exact;
// below 2 divisors, as the difference of two phases always is, one
// subtraction gives it exactly too (Sterbenz), with fmodf's sign of zero.
__device__ __forceinline__ float wrap_principal(float d) {
  const float x = __fadd_rn(d, kPi);
  const float a = fabsf(x);
  float m = a < kTwoPi ? x
          : a < 2.0f * kTwoPi ? copysignf(__fsub_rn(a, kTwoPi), x) : fmodf(x, kTwoPi);
  if (m < 0.0f) m = __fadd_rn(m, kTwoPi);
  const float w = __fsub_rn(m, kPi);
  return (w == -kPi && d > 0.0f) ? kPi : w;
}

__device__ __forceinline__ float power_of(float2 z) {
  return __fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y));
}

__global__ void __launch_bounds__(32 * kWarps) cand_gd_kernel(const CandGdParams p) {
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= p.rows) return;   // a whole warp
  const long long o = row / p.inner;
  const float2* x = p.spec + o * p.outer_stride + (row - o * p.inner) * p.inner_stride + p.lo;
  const bool select = p.j > 0;
  // this warp's columns: lane l's in-band bins at l + 32 k, sorted by
  // (key, then bin) as key << 32 | ~bin, descending
  unsigned long long* col = smem + warp * p.nb;
  const int m = p.nb - 1;
  const float nf = static_cast<float>(p.n);
  const float2 zero = make_float2(0.0f, 0.0f);

  // bins t (z), t + 32 (zn) loaded, t + 64 on its way
  float2 z = lane < p.nb ? __ldg(x + lane) : zero;
  float2 zn = lane + 32 < p.nb ? __ldg(x + lane + 32) : zero;
  float ph = atan2f(z.y, z.x);
  float d_prev = 0.0f;   // the difference at bin t - 32
  int count = 0;         // this lane's in-band bins
  for (int t = lane; t - lane < p.nb; t += 32) {
    const float2 znn = t + 64 < p.nb ? __ldg(x + t + 64) : zero;
    const float pw = power_of(z);
    if (t >= p.band0 && t < p.band1) {
      if (select) {   // insert into the lane's sorted column
        const unsigned long long c =
            (static_cast<unsigned long long>(order_key(pw)) << 32) | ~static_cast<unsigned>(t);
        int k = count;
        for (; k > 0; --k) {
          const unsigned long long up = col[lane + 32 * (k - 1)];
          if (up > c) break;
          col[lane + 32 * k] = up;
        }
        col[lane + 32 * k] = c;
      } else {
        const long long c = row * (p.band1 - p.band0) + t - p.band0;
        p.power[c] = pw;
        p.idx[c] = p.lo + t;
        p.valid[c] = 1;
        p.period[c] = __fdiv_rn(nf, static_cast<float>(p.lo + t));
      }
      ++count;
    }
    // d[t] = wrap(ph[t + 1] - ph[t]); g[t] from d[t] and d[t - 1]
    const float ph_n = atan2f(zn.y, zn.x);
    float next = __shfl_down_sync(kFull, ph, 1);
    const float next_slot = __shfl_sync(kFull, ph_n, 0);
    if (lane == 31) next = next_slot;
    const float d = wrap_principal(__fsub_rn(next, ph));
    float prev = __shfl_up_sync(kFull, d, 1);
    const float prev_slot = __shfl_sync(kFull, d_prev, 31);
    if (lane == 0) prev = prev_slot;
    if (t <= m) {
      const float g = t == 0 ? d : (t == m ? prev : __fmul_rn(0.5f, __fadd_rn(d, prev)));
      const float v = -g;
      const long long e = row * p.nb + t;
      p.gd_idx[e] = v != v ? v : fminf(fmaxf(v, -kClamp), kClamp);
      if (p.mode == 1) {
        p.gd[e] = __fdiv_rn(v, p.den);
      } else if (p.mode == 0) {
        p.gd[e] = 0.0f;
      }
    }
    z = zn;
    zn = znn;
    ph = ph_n;
    d_prev = d;
  }
  if (!select) return;

  // rounds: the warp's largest head key, the lowest bin holding it; the
  // winning lane moves to the next entry of its column
  int pos = 0;
  unsigned head = 0u;   // this lane's head: key (0 past its column), bin
  int head_t = 0;
  if (count > 0) {
    const unsigned long long c = col[lane];
    head = static_cast<unsigned>(c >> 32);
    head_t = static_cast<int>(~static_cast<unsigned>(c));
  }
  for (int j0 = 0; j0 < p.j; j0 += 32) {
    const int n_out = min(32, p.j - j0);
    unsigned r_key = 0u;
    int r_t = 0;
    for (int jj = 0; jj < n_out; ++jj) {
      const unsigned top = __reduce_max_sync(kFull, head);
      const unsigned t_top = __reduce_min_sync(
          kFull, head == top ? static_cast<unsigned>(head_t) : kFull);
      if (lane == jj) { r_key = top; r_t = static_cast<int>(t_top); }
      if (lane == static_cast<int>(t_top & 31u)) {   // the winning lane
        head = 0u;
        if (++pos < count) {
          const unsigned long long c = col[lane + 32 * pos];
          head = static_cast<unsigned>(c >> 32);
          head_t = static_cast<int>(~static_cast<unsigned>(c));
        }
      }
    }
    if (lane < n_out) {
      const long long c = row * p.j + j0 + lane;
      const int bin = p.lo + r_t;
      const float r_pw = key_power(r_key);
      const bool ok = r_pw > 0.0f;
      p.power[c] = r_pw;
      p.idx[c] = bin;
      p.valid[c] = ok;
      p.period[c] = ok ? __fdiv_rn(nf, fmaxf(static_cast<float>(bin), 1.0f)) : 0.0f;
    }
  }
}

}  // namespace

// The warps a block and its dynamic shared memory: up to 8 warps, each
// with 8 bytes a bin where it selects.
extern "C" int cand_gd_launch(const CandGdParams* p, void* stream) {
  const long long per_warp = p->j > 0 ? 8LL * p->nb : 0;
  const long long fit = per_warp ? kSmemMax / per_warp : kWarps;
  const int warps = static_cast<int>(fit < kWarps ? fit : kWarps);
  if (p->rows < 0 || p->inner < 1 || p->nb < 2 || p->band0 < 0 || p->band1 > p->nb ||
      p->band0 >= p->band1 || p->j < 0 || p->j > p->band1 - p->band0 || p->mode < 0 ||
      p->mode > 2 || warps < 1 || (p->rows + warps - 1) / warps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p->rows == 0) return 0;
  const int smem = static_cast<int>(warps * per_warp);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cand_gd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (p->rows + warps - 1) / warps;
  cand_gd_kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem,
                   static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cand_gd_params_size() { return static_cast<int>(sizeof(CandGdParams)); }
