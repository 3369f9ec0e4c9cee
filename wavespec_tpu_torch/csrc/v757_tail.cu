// The v7.57 per-frame tail for a batch of symbols: biquad cycle
// reconstruction, the ETA/color machine (three modes), FollowFirst
// signals and the Kalman 4D filter, fused.
//
// Replaces: wavespec_tpu/kernels/v757_tail_pallas.py::v757_tail_pallas
// (Pallas `_kernel`). This kernel is held bitwise equal to its plain
// PyTorch version, wavespec_tpu_torch/pipeline/tail.py::v757_tail_plain
// (the four machines of filters/biquad.py, analyze/eta.py,
// signals/followfirst.py and filters/kalman4d.py run frame by frame), on
// every output and the final V757TailState, and resumes from `init`.
//
// What bounds it: per symbol and frame it reads 1 + 3 * S words and
// writes 6 * S + 2, about 330 bytes at S = 12, and does some hundreds of
// flops per slot. The frames of a symbol are a dependent chain (each
// machine's state feeds the next frame), so the time is T times the
// latency of what each frame must do after the frame before. With the
// frame's loads, the biquad coefficients (sinf, cosf, two expf, five
// divisions), the angle and the Kalman step all on that chain a frame
// took ~2.1 us on the H100; most of it needs no machine state, so it is
// taken off the chain (~1 us a frame).
//
// Design: one block of two warps per symbol, frames in chunks of F whose
// inputs (newest, period, valid, gd) arrive by cp.async into a two-stage
// ring while the chunk before runs. Each chunk is six passes that
// alternate parallel work over its (frame, slot) pairs with short walks
// over its frames (lane l walks slots l and, past S = 32, l + 32, its
// slots' state in registers), each term by the same expression as
// before, so with the same bits. Past 64 slots (the wide geometry) lane l
// walks slots l, l + 32, ... with their state, the lag ring and the work
// arrays in one region, in dynamic shared memory where it fits, else in
// global scratch a symbol; the inputs are read from global memory:
// 1. both warps: the biquad coefficients of each frame's period;
// 2. walk: the biquad recurrence, the cycle values;
// 3. pairs: the ETA that needs no machine state (PHASE: the angle to the
//    quarter-period lag, read from this chunk's cycle values or from the
//    lag ring; REALFFT: the group delay);
// 4. walk: the ETA/color machine (color, bars in phase, the phase
//    history, HYBRID's estimate, the monotonic countdown);
// 5. pairs: raw and shown ETA, states;
// 6. walk: FollowFirst's ballots (its percentages from a table of the
//    same divisions), then the lag ring keeps the chunk's last values.
// Warp 1 walks the per-symbol Kalman step over the chunk's prices during
// passes 2-6. Each walk fetches the next frame's inputs before the
// frame's stores, and conditions on the walks are bitwise, not
// short-circuit (no branches). Slots >= S behave as inactive slots.
// FollowFirst's ballots run once per slot a lane, the lower slots first;
// its percentages come from a table of the same divisions in the register
// geometry and from those divisions in the wide one.
// Transcendentals are the CUDA math library's sinf/cosf/expf/sqrtf (no
// fast-math), divisions are IEEE, and the file must be compiled with
// --fmad=false, so that each step rounds as the plain PyTorch ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kHalfPi = static_cast<float>(3.141592653589793 / 2.0);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kSixth = static_cast<float>(1.0 / 6.0);
constexpr int kImax = 2147483647;
constexpr int kThreads = 64;            // warp 0: slots; warp 1: Kalman
constexpr int kMaxFrames = 32;          // frames a chunk holds at most
constexpr int kChunkBytes = 40 * 1024;  // two stages and the work arrays
constexpr int kMaxSlots = 64;           // two slots a lane in registers; past it the wide geometry

struct TailIn {
  const float* __restrict__ newest;      // [B, T]
  const float* __restrict__ price_prev;  // [B, 2]
  const float* __restrict__ period;      // [B, T, S]
  const uint8_t* __restrict__ valid;     // [B, T, S]
  const float* __restrict__ gd;          // [B, T, S]
};

struct TailOut {
  float* cyc;        // [B, T, S]
  float* color;
  float* eta_disp;
  float* eta_raw;
  float* states;
  float* sig;
  float* conf;       // [B, T]
  float* kal;        // [B, T]
};

// V757TailState, field order of the Python NamedTuple.
struct TailState {
  float* y1;       // [B, S]
  float* y2;
  float* xh;       // [B, 2]
  float* vprev;
  float* colorp;
  float* lasteta;
  float* est;      // [B, 2, S]
  float* ring;     // [B, cap, S]
  float* stp;
  float* etp;
  float* kx;       // [B, 4]
  float* kp;       // [B, 4, 4]
  float* kema;     // [B, 2]
  int32_t* bars;   // [B, S]
  int32_t* bull;   // [B, 5, S]
  int32_t* bear;
  int32_t* lastdir;
  int32_t* lastbar;
  int32_t* posmode;  // [B, 2]
  int32_t* tpos;     // [B]
};

struct TailParams {
  int T, S, cap, prior_bars, eta_mode;
  float sh, spb;
  float atan[9];
  int ff_enable, ff_single, ff_ignore_same, ff_entry_pos;
  float ff_min_p, ff_max_p, ff_exit, ff_thr, ff_conf_pct, ff_lot;
  int kal_enable, kal_adapt, kal_clip, kal_ema;
  float q[4];
  float r, adapt_gain, clip_std, ema_alpha, ema_keep;
  float init_x[3], init_var[4];
};

// Frames per chunk and the dynamic shared memory (words): the lag ring,
// the eight work arrays [F][S] of `Work`, and two stages of newest [F],
// period and gd [F][S] and the valid bytes as whole words.
__host__ __device__ inline int valid_words(int F, int S) { return (F * S + 7) / 4 + 1; }
__host__ __device__ inline int stage_words(int F, int S) {
  return F + 2 * F * S + valid_words(F, S);
}
inline int frames_per_chunk(int S) {
  const int f = kChunkBytes / (4 * (8 * S + 2 * (1 + 2 * S)) + 2 * S);
  return f < 1 ? 1 : (f > kMaxFrames ? kMaxFrames : f);
}
inline size_t dynamic_smem(int F, int S, int cap) {
  return (size_t)(cap * S + 8 * F * S + 2 * stage_words(F, S)) * 4;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// One stage of the ring: frames [i0, i0 + nf) of symbol b.
struct Stage {
  float* newest;     // [F]
  float* period;     // [F][S]
  float* gd;
  uint32_t* valid;   // whole words covering the frames' valid bytes

  __device__ Stage(uint32_t* base, int F, int S)
      : newest(reinterpret_cast<float*>(base)), period(newest + F), gd(period + F * S),
        valid(reinterpret_cast<uint32_t*>(gd + F * S)) {}

  // Start the copies; the valid bytes go as the aligned words that hold
  // them (a word holding a byte of the tensor lies in its allocation).
  __device__ void load(const TailIn& in, long long x0, long long e0, int nf, int S,
                       int tid) const {
    const int n = nf * S;
    for (int i = tid; i < nf; i += kThreads) cp_async4(newest + i, in.newest + x0 + i);
    for (int i = tid; i < n; i += kThreads) {
      cp_async4(period + i, in.period + e0 + i);
      cp_async4(gd + i, in.gd + e0 + i);
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(in.valid + e0);
    const uintptr_t w0 = a & ~uintptr_t(3);
    const int nw = static_cast<int>(((a + n + 3) & ~uintptr_t(3)) - w0) / 4;
    for (int i = tid; i < nw; i += kThreads) {
      cp_async4(valid + i, reinterpret_cast<const void*>(w0 + 4 * i));
    }
  }
  __device__ const uint8_t* valid_bytes(const TailIn& in, long long e0) const {
    return reinterpret_cast<const uint8_t*>(valid) +
           (reinterpret_cast<uintptr_t>(in.valid + e0) & 3);
  }
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// atan2(q, i) mod pi in [0, pi): octant reduction and the fitted odd
// polynomial, as analyze/eta.py::_angle_mod_pi.
__device__ __forceinline__ float angle_mod_pi(float q, float i, const float (&c)[9]) {
  const float ax = fabsf(i), ay = fabsf(q);
  const float t = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), 1e-30f);
  const float t2 = t * t;
  float acc = c[8];
  for (int k = 7; k >= 0; --k) acc = acc * t2 + c[k];
  float a = t * acc;
  if (ay > ax) a = kHalfPi - a;
  const float m = ((q >= 0.f) != (i >= 0.f)) ? kPi - a : a;
  return ay == 0.f ? 0.f : m;
}

// Median of the > 0 entries of h[5] (element count // 2 of the ascending
// sort; 0 when empty), by the same 9-comparator network.
__device__ int median5(const int* h) {
  int v[5], count = 0;
  for (int j = 0; j < 5; ++j) {
    count += h[j] > 0;
    v[j] = h[j] > 0 ? h[j] : kImax;
  }
  const int pairs[9][2] = {{0, 1}, {3, 4}, {2, 4}, {2, 3}, {0, 3},
                           {0, 2}, {1, 4}, {1, 3}, {1, 2}};
  for (int p = 0; p < 9; ++p) {
    const int a = pairs[p][0], b = pairs[p][1];
    const int lo = min(v[a], v[b]), hi = max(v[a], v[b]);
    v[a] = lo;
    v[b] = hi;
  }
  const int idx = min(max(count / 2, 0), 4);
  int med = 0;
  for (int j = 0; j < 5; ++j) med = idx == j ? v[j] : med;
  return count > 0 ? med : 0;
}

// sum_k F[row][k] * v[k] over the nonzero entries of the constant-jerk
// transition, left to right.
__device__ __forceinline__ float dot_f(int row, const float* v) {
  switch (row) {
    case 0: return v[0] + v[1] + 0.5f * v[2] + kSixth * v[3];
    case 1: return v[1] + v[2] + 0.5f * v[3];
    case 2: return v[2] + v[3];
    default: return v[3];
  }
}

// A chunk's work arrays, [F][S] each: what the passes over (frame, slot)
// pairs hand to the walks over frames and back.
struct Work {
  float *b0, *b2, *a1, *a2;   // biquad coefficients of the frame's period
  float* v;                   // cycle values
  float* eta0;                // the phase (or group-delay) ETA, before the machine's state
  float* eta;                 // the machine's ETA, then the raw ETA
  float* color;               // color, then states

  __device__ Work(uint32_t* base, int n)
      : b0(reinterpret_cast<float*>(base)), b2(b0 + n), a1(b2 + n), a2(a1 + n), v(a2 + n),
        eta0(v + n), eta(eta0 + n), color(eta + n) {}
};

// Warp 1: the per-symbol Kalman 4D step over the chunk's prices.
struct Kalman {
  float kx[4], kp[16], ema, ready;

  __device__ void step(float x, bool first, const TailParams& prm, float& kal) {
    if (first) {
      kx[0] = x; kx[1] = prm.init_x[0]; kx[2] = prm.init_x[1]; kx[3] = prm.init_x[2];
      for (int k = 0; k < 16; ++k) kp[k] = 0.f;
      for (int k = 0; k < 4; ++k) kp[5 * k] = prm.init_var[k];
      ema = x;
      ready = 0.f;
    }
    float xp[4], fp[16], pp[16], col[4];
    for (int a = 0; a < 4; ++a) xp[a] = dot_f(a, kx);
    for (int bcol = 0; bcol < 4; ++bcol) {
      for (int k = 0; k < 4; ++k) col[k] = kp[4 * k + bcol];
      for (int a = 0; a < 4; ++a) fp[4 * a + bcol] = dot_f(a, col);
    }
    for (int a = 0; a < 4; ++a)
      for (int bcol = 0; bcol < 4; ++bcol) pp[4 * a + bcol] = dot_f(bcol, fp + 4 * a);
    for (int a = 0; a < 4; ++a) pp[5 * a] = pp[5 * a] + prm.q[a];
    float y = x - xp[0];
    float s = pp[0] + prm.r;
    if (prm.kal_adapt) {
      const float boost = fminf(fabsf(y) / sqrtf(s), 5.0f) * prm.adapt_gain;
      for (int a = 0; a < 4; ++a) pp[5 * a] = pp[5 * a] + boost * prm.q[a];
      s = pp[0] + prm.r;
    }
    if (prm.kal_clip) {
      const float lim = prm.clip_std * sqrtf(s);
      y = clampf(y, -lim, lim);
    }
    float gain[4];
    for (int a = 0; a < 4; ++a) gain[a] = pp[4 * a] / s;
    for (int a = 0; a < 4; ++a) kx[a] = xp[a] + gain[a] * y;
    for (int a = 0; a < 4; ++a)
      for (int bcol = 0; bcol < 4; ++bcol) kp[4 * a + bcol] = pp[4 * a + bcol] - gain[a] * pp[bcol];
    for (int a = 0; a < 4; ++a) kp[5 * a] = fmaxf(kp[5 * a], 1e-12f);
    kal = kx[0];
    if (prm.kal_ema) {
      ema = ready > 0.5f ? prm.ema_alpha * kal + prm.ema_keep * ema : kal;
      ready = 1.f;
      kal = ema;
    }
  }
};

// A lane's share of a per-slot array: N entries in registers (entry u is
// slot lane + 32 u), or, in the wide geometry, a pointer to the lane's
// first entry with a stride of 32.
template <typename T, int N, bool kWide> struct LaneArr {
  T v[N];
  __device__ __forceinline__ T& operator[](int u) { return v[u]; }
};
template <typename T, int N> struct LaneArr<T, N, true> {
  T* p;
  __device__ __forceinline__ T& operator[](int u) const { return p[32 * u]; }
};

// FollowFirst's percentage, 100 * n / max(active, 1), as the table holds it.
__device__ __forceinline__ float pct_of(int n, int active) {
  return 100.0f * static_cast<float>(n) / static_cast<float>(max(active, 1));
}

// NS slots a lane: lane l of warp 0 walks slots l, l + 32, ... (< S), in
// registers. kWide (past 64 slots): `ns` slots a lane, their state in the
// region after the lag ring and the work arrays, in dynamic shared memory
// (`region_shared`) or in `region_words` of the global scratch a symbol;
// the candidates' inputs are read from global memory (no stages), the
// walks over frames run a slot of each lane at a time (the biquad and the
// ETA machine) or all slots a frame (FollowFirst), and the percentages
// are divided where the table would not fit.
template <int NS, bool kWide>
__global__ void __launch_bounds__(kThreads) v757_tail_kernel(
    TailIn in, TailState init, bool has_init, TailOut out, TailState fin, TailParams prm,
    int F, int ns_rt, bool region_shared, long long region_words, uint32_t* scratch) {
  constexpr int kPct = kWide ? 1 : 32 * NS + 1;   // FollowFirst's percentage table side
  constexpr int NG = kWide ? 1 : NS;              // slots a lane a walk takes at once
  extern __shared__ uint32_t smem[];
  __shared__ float pct_tab[kPct * kPct];   // 100 * n / max(active, 1) at [active][n]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool walker = tid < 32;   // warp 0; warp 1 runs the Kalman filter
  const int S = prm.S, T = prm.T, cap = prm.cap;
  const int ns = kWide ? ns_rt : NS;
  uint32_t* base = smem;
  if constexpr (kWide) {
    if (!region_shared) base = scratch + static_cast<long long>(b) * region_words;
  }
  float* ring = reinterpret_cast<float*>(base);                  // [cap][S]
  const Work w(base + cap * S, F * S);
  uint32_t* stages = base + cap * S + 8 * F * S;
  const int stage_step = stage_words(F, S);
  auto slot_ok = [&](int u) { return walker & (lane + 32 * u < S); };
  auto bs = [&](int u) { return (long long)b * S + lane + 32 * u; };
  float atan_c[9];   // in registers: the parameter block is not addressable
  for (int k = 0; k < 9; ++k) atan_c[k] = prm.atan[k];
  if constexpr (!kWide) {
    for (int k = tid; k < kPct * kPct; k += kThreads) {
      pct_tab[k] = 100.0f * static_cast<float>(k % kPct) / static_cast<float>(max(k / kPct, 1));
    }
  }

  // ---- state, per slot a lane walks ----
  LaneArr<float, NS, kWide> y1, y2, vprev, colorp, lasteta, est0, est1, stp, etp;
  LaneArr<int, NS, kWide> bars, lastdir, lastbar;
  LaneArr<int, 5 * NS, kWide> bull, bear;   // entry 5 u + j
  if constexpr (kWide) {
    const int sp = 32 * ns;
    float* st = reinterpret_cast<float*>(stages) + lane;   // no stages: the state follows the work arrays
    y1.p = st; y2.p = st + sp; vprev.p = st + 2 * sp; colorp.p = st + 3 * sp;
    lasteta.p = st + 4 * sp; est0.p = st + 5 * sp; est1.p = st + 6 * sp; stp.p = st + 7 * sp;
    etp.p = st + 8 * sp;
    int* ist = reinterpret_cast<int*>(stages) + 9 * sp + lane;
    bars.p = ist; lastdir.p = ist + sp; lastbar.p = ist + 2 * sp;
    bull.p = ist + 3 * sp; bear.p = ist + 8 * sp;
  }
  if (!kWide || walker) {
#pragma unroll
    for (int u = 0; u < ns; ++u) {
      y1[u] = 0.f; y2[u] = 0.f; vprev[u] = 0.f; colorp[u] = 0.f; lasteta[u] = 0.f;
      est0[u] = 0.f; est1[u] = 0.f; stp[u] = 0.f; etp[u] = 0.f;
      bars[u] = prm.prior_bars; lastdir[u] = 0; lastbar[u] = -1;
#pragma unroll
      for (int j = 0; j < 5; ++j) { bull[5 * u + j] = 0; bear[5 * u + j] = 0; }
    }
  }
  float xh0 = in.price_prev[2 * b], xh1 = in.price_prev[2 * b + 1];
  int position = -1, mode = 0, tpos = 0;
  Kalman kf;
  for (int k = 0; k < 4; ++k) kf.kx[k] = 0.f;
  for (int k = 0; k < 16; ++k) kf.kp[k] = 0.f;
  kf.ema = 0.f;
  kf.ready = 0.f;
#pragma unroll
  for (int u = 0; u < ns; ++u) {
    const int sl = lane + 32 * u;
    if (slot_ok(u)) {
      for (int r = 0; r < cap; ++r) ring[r * S + sl] = 0.f;
    }
  }
  if (has_init) {
#pragma unroll
    for (int u = 0; u < ns; ++u) {
      const int sl = lane + 32 * u;
      if (slot_ok(u)) {
        const long long o = bs(u);
        y1[u] = init.y1[o]; y2[u] = init.y2[o]; vprev[u] = init.vprev[o];
        colorp[u] = init.colorp[o]; lasteta[u] = init.lasteta[o];
        est0[u] = init.est[(2LL * b) * S + sl]; est1[u] = init.est[(2LL * b + 1) * S + sl];
        stp[u] = init.stp[o]; etp[u] = init.etp[o]; bars[u] = init.bars[o];
        lastdir[u] = init.lastdir[o]; lastbar[u] = init.lastbar[o];
        for (int j = 0; j < 5; ++j) {
          bull[5 * u + j] = init.bull[(5LL * b + j) * S + sl];
          bear[5 * u + j] = init.bear[(5LL * b + j) * S + sl];
        }
        for (int r = 0; r < cap; ++r) ring[r * S + sl] = init.ring[((long long)b * cap + r) * S + sl];
      }
    }
    xh0 = init.xh[2 * b]; xh1 = init.xh[2 * b + 1];
    position = init.posmode[2 * b]; mode = init.posmode[2 * b + 1];
    tpos = init.tpos[b];
    for (int k = 0; k < 4; ++k) kf.kx[k] = init.kx[4 * b + k];
    for (int k = 0; k < 16; ++k) kf.kp[k] = init.kp[16 * b + k];
    kf.ema = init.kema[2 * b]; kf.ready = init.kema[2 * b + 1];
  }

  const long long x_sym = (long long)b * T, e_sym = (long long)b * T * S;
  const int n_chunks = (T + F - 1) / F;
  if constexpr (!kWide) {
    Stage(stages, F, S).load(in, x_sym, e_sym, min(F, T), S, tid);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int i0 = ch * F, nf = min(F, T - i0), n = nf * S;
    // the chunk's inputs: staged (registers geometry) or in global memory
    const float* s_newest = in.newest + x_sym + i0;
    const float* s_period = in.period + e_sym + (long long)i0 * S;
    const float* s_gd = in.gd + e_sym + (long long)i0 * S;
    const uint8_t* stg_valid = in.valid + e_sym + (long long)i0 * S;
    if constexpr (!kWide) {
      if (ch + 1 < n_chunks) {
        Stage(stages + ((ch + 1) & 1) * stage_step, F, S)
            .load(in, x_sym + i0 + F, e_sym + (long long)(i0 + F) * S, min(F, T - i0 - F), S, tid);
      }
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
      const Stage stg(stages + (ch & 1) * stage_step, F, S);
      s_newest = stg.newest;
      s_period = stg.period;
      s_gd = stg.gd;
      stg_valid = stg.valid_bytes(in, e_sym + (long long)i0 * S);
    } else {
      __syncthreads();
    }

    // ---- 1. every (frame, slot): the biquad coefficients, both warps ----
    for (int idx = tid; idx < n; idx += kThreads) {
      const float omega = kTwoPi / fmaxf(s_period[idx], 2.01f);
      const float sw = sinf(omega);
      const float z = prm.sh * omega / sw;
      const float alpha = sw * 0.5f * (expf(z) - expf(-z));
      const float a0 = 1.0f + alpha;
      w.b0[idx] = alpha / a0;
      w.b2[idx] = -alpha / a0;
      w.a1[idx] = -2.0f * cosf(omega) / a0;
      w.a2[idx] = (1.0f - alpha) / a0;
    }
    __syncthreads();

    if (!walker) {
      // ---- Kalman 4D over the chunk's prices (warp 1, every lane, uniform) ----
      for (int f = 0; f < nf; ++f) {
        const int i = i0 + f;
        float kal = 0.f;
        if (prm.kal_enable) kf.step(s_newest[f], !has_init && i == 0, prm, kal);
        if (lane == 0) out.kal[x_sym + i] = kal;
      }
    } else {
      // ---- 2. lane s: the biquad recurrence, NG slots a lane at a time
      // (each group walks the chunk from its first prices) ----
      // (each walk fetches the next frame's inputs before this frame's
      // stores, which the compiler cannot move them past)
      const float xs0 = xh0, xs1 = xh1;
      for (int g = 0; g < (kWide ? ns : 1); ++g) {
        xh0 = xs0;
        xh1 = xs1;
        float b0n[NG], b2n[NG], a1n[NG], a2n[NG];
        bool liven[NG];
#pragma unroll
        for (int k = 0; k < NG; ++k) {
          b0n[k] = 0.f; b2n[k] = 0.f; a1n[k] = 0.f; a2n[k] = 0.f; liven[k] = false;
        }
        auto fetch_biquad = [&](int f) {
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            const int u = kWide ? g : k;
            if (slot_ok(u)) {
              const int idx = f * S + lane + 32 * u;
              liven[k] = (stg_valid[idx] != 0) & (s_period[idx] > 0.f);
              b0n[k] = w.b0[idx]; b2n[k] = w.b2[idx]; a1n[k] = w.a1[idx]; a2n[k] = w.a2[idx];
            }
          }
        };
        fetch_biquad(0);
        for (int f = 0; f < nf; ++f) {
          const float x = s_newest[f];
          bool live[NG];
          float b0[NG], b2[NG], a1[NG], a2[NG];
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            live[k] = liven[k]; b0[k] = b0n[k]; b2[k] = b2n[k]; a1[k] = a1n[k]; a2[k] = a2n[k];
          }
          if (f + 1 < nf) fetch_biquad(f + 1);
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            const int u = kWide ? g : k;
            const float uu = live[k] ? b0[k] * x + b2[k] * xh0 : 0.f;
            const float v = live[k] ? uu - a1[k] * y1[u] - a2[k] * y2[u] : 0.f;
            if (slot_ok(u)) {
              w.v[f * S + lane + 32 * u] = v;
              out.cyc[(x_sym + i0 + f) * S + lane + 32 * u] = v;
            }
            y2[u] = y1[u];
            y1[u] = v;
          }
          xh0 = xh1;
          xh1 = x;
        }
      }
      __syncwarp();

      // ---- 3. every (frame, slot): the ETA before the machine's state
      // (PHASE: from the angle to the quarter-period lag; REALFFT: from
      // the group delay) ----
      if (prm.eta_mode != 2) {
        for (int idx = lane; idx < n; idx += 32) {
          const int f = idx / S;
          const float period = s_period[idx];
          float eta;
          if (prm.eta_mode == 1) {
            const float mb = 1.5f * period;
            const float tau = clampf(s_gd[idx], -mb, mb);
            eta = period > 0.f ? fminf(fabsf(tau) * prm.spb, mb * prm.spb) : 0.f;
          } else {
            const int tabs = tpos + i0 + f;
            const int q = min(max(static_cast<int>(fmaxf(floorf(period / 4.0f + 0.5f), 1.0f)), 1), cap - 1);
            int lag = (tabs - q) % cap;
            if (lag < 0) lag += cap;
            // frame tabs - q: in this chunk, or where the ring keeps it
            const float v_lag = f >= q ? w.v[idx - q * S] : ring[lag * S + idx - f * S];
            const float m_ang = angle_mod_pi(v_lag, w.v[idx], atan_c);
            const float dphi = m_ang > 0.f ? kPi - m_ang : 0.f;
            const float psec = period * prm.spb;
            eta = clampf(dphi / kTwoPi * psec, 0.f, 1.5f * psec);
            eta = (period > 0.f && tabs >= q) ? eta : 0.f;
          }
          w.eta0[idx] = eta;
        }
      }
      __syncwarp();

      // ---- 4. lane s: the ETA / color machine, NG slots a lane at a time ----
      for (int g = 0; g < (kWide ? ns : 1); ++g) {
        float vn[NG], periodn[NG], gdn[NG], etan[NG];
        bool okn[NG];
#pragma unroll
        for (int k = 0; k < NG; ++k) {
          vn[k] = 0.f; periodn[k] = 0.f; gdn[k] = 0.f; etan[k] = 0.f; okn[k] = false;
        }
        auto fetch_machine = [&](int f) {
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            const int u = kWide ? g : k;
            if (slot_ok(u)) {
              const int idx = f * S + lane + 32 * u;
              vn[k] = w.v[idx]; periodn[k] = s_period[idx]; gdn[k] = s_gd[idx];
              okn[k] = stg_valid[idx] != 0;
              if (prm.eta_mode != 2) etan[k] = w.eta0[idx];
            }
          }
        };
        fetch_machine(0);
        for (int f = 0; f < nf; ++f) {
          const bool first = !has_init & (i0 + f == 0);
          float vv[NG], pp[NG], gg[NG], ee[NG];
          bool oo[NG];
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            vv[k] = vn[k]; pp[k] = periodn[k]; gg[k] = gdn[k]; ee[k] = etan[k]; oo[k] = okn[k];
          }
          if (f + 1 < nf) fetch_machine(f + 1);
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            const int u = kWide ? g : k;
            const int idx = f * S + lane + 32 * u;
            const float v = vv[k], period = pp[k], gd = gg[k];
            float eta = ee[k];
            const bool ok = oo[k];
            const bool bullish = first ? (v >= 0.f) : (v >= vprev[u]);
            const float color = (ok & bullish) ? 1.f : 0.f;
            const bool flipped = color != colorp[u];
            bool changed;
            int bars_now;
            if (prm.prior_bars > 0) {
              changed = flipped & ok;
              bars_now = flipped ? 1 : bars[u] + 1;
            } else {
              changed = flipped & ok & !first;
              bars_now = (first | flipped) ? 1 : bars[u] + 1;
            }
            const float bars_f = static_cast<float>(bars_now);
            if (prm.eta_mode == 2) {
              int hs[5], ho[5];
              for (int j = 0; j < 5; ++j) {
                hs[j] = bullish ? bull[5 * u + j] : bear[5 * u + j];
                ho[j] = bullish ? bear[5 * u + j] : bull[5 * u + j];
              }
              const float med_same = static_cast<float>(median5(hs));
              const float med_opp = static_cast<float>(median5(ho));
              float e = bullish ? est0[u] : est1[u];
              if (e <= 0.f) e = med_same;
              if (e <= 0.f) e = med_opp;
              if (e <= 0.f && period > 0.f) e = period;
              if (e <= 0.f) e = fmaxf(bars_f, 1.0f);
              if (period > 0.f && e > 2.0f * period) e = 2.0f * period;
              const float tsec = fmaxf(fmaxf(e, bars_f), 1.0f) * prm.spb;
              const float esec = bars_f * prm.spb;
              const float prog = tsec > 0.f ? fminf(esec / tsec, 1.0f) : 0.f;
              const float base_eta = (1.0f - clampf(prog, 0.f, 1.f)) * tsec;
              const float max_adj = tsec * 0.25f;
              const float gd_sec = clampf(gd * prm.spb, -max_adj, max_adj);
              float sci = clampf(base_eta + 0.25f * gd_sec, 0.f, tsec * 1.5f);
              sci = tsec > 0.f ? sci : 0.f;
              const float e_struct = fmaxf(tsec - esec, 0.f);
              const float e_hist = fmaxf(med_same * prm.spb - esec, 0.f);
              const float w_struct = tsec > 0.f ? 0.5f : 0.f;
              const float w_hist = med_same > 0.f ? 0.35f : 0.f;
              const float w_sci = sci > 0.f ? 0.15f : 0.f;
              const float wsum = w_struct + w_hist + w_sci;
              const float blend = (e_struct * w_struct + e_hist * w_hist + sci * w_sci) / fmaxf(wsum, 1e-9f);
              const float hyb = wsum > 0.f ? blend : e_struct;
              float max_ref = fmaxf(fmaxf(tsec, med_same * prm.spb), period * prm.spb);
              max_ref = max_ref <= 0.f ? prm.spb : max_ref;
              eta = clampf(hyb, 0.f, 1.5f * max_ref);
            }
            eta = period > 0.f ? eta : 0.f;

            // phase-history learning on a color change
            const bool was_bull = colorp[u] > 0.5f;
            const bool store_bull = changed & was_bull & (period > 0.f);
            const bool store_bear = changed & !was_bull & (period > 0.f);
            if (store_bull) {
              for (int j = 4; j > 0; --j) bull[5 * u + j] = bull[5 * u + j - 1];
              bull[5 * u] = bars[u];
              est0[u] = static_cast<float>(bars[u]);
            }
            if (store_bear) {
              for (int j = 4; j > 0; --j) bear[5 * u + j] = bear[5 * u + j - 1];
              bear[5 * u] = bars[u];
              est1[u] = static_cast<float>(bars[u]);
            }

            // monotonic countdown within a phase
            const float expected = fmaxf(lasteta[u] - prm.spb, 0.f);
            if (!changed & (lasteta[u] > 0.f) & !first) eta = fminf(eta, expected);
            eta = period > 0.f ? eta : 0.f;
            if ((prm.prior_bars == 0) & first) eta = 0.f;
            eta = ok ? eta : 0.f;
            if (slot_ok(u)) {
              w.eta[idx] = eta;
              w.color[idx] = color;
            }
            colorp[u] = color;
            bars[u] = bars_now;
            lasteta[u] = eta;
            vprev[u] = v;
          }
        }
      }
      __syncwarp();

      // ---- 5. every (frame, slot): raw and shown ETA, states ----
      for (int idx = lane; idx < n; idx += 32) {
        const float eta = w.eta[idx], color = w.color[idx];
        const bool ok = stg_valid[idx] != 0;
        const float eta_bars = eta / prm.spb;
        const bool bull_c = color > 0.5f;
        const float signed_eta = bull_c ? eta_bars : -eta_bars;
        const bool shown = s_period[idx] > 0.f && ok;
        const float disp = (bull_c && signed_eta >= 0.f && signed_eta < 1.f) ? 1.f : signed_eta;
        const float eta_raw = shown ? signed_eta : 0.f;
        const float st = ok ? (color > 0.5f ? 1.f : -1.f) : 0.f;
        const long long o = (x_sym + i0) * S + idx;
        out.color[o] = color;
        out.eta_disp[o] = shown ? disp : 0.f;
        out.eta_raw[o] = eta_raw;
        out.states[o] = st;
        w.eta[idx] = eta_raw;
        w.color[idx] = st;
      }
      __syncwarp();

      // ---- 6. lane s: FollowFirst, every slot a frame, the lower slots
      // first (registers: the frame's inputs fetched a frame ahead) ----
      float rawn[NG], stn[NG], periodf[NG];
      bool okf[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        rawn[k] = 0.f; stn[k] = 0.f; periodf[k] = 0.f; okf[k] = false;
      }
      auto fetch_ff = [&](int f) {
        if constexpr (!kWide) {
#pragma unroll
          for (int u = 0; u < NS; ++u) {
            if (slot_ok(u)) {
              const int idx = f * S + lane + 32 * u;
              rawn[u] = w.eta[idx]; stn[u] = w.color[idx]; periodf[u] = s_period[idx];
              okf[u] = stg_valid[idx] != 0;
            }
          }
        }
      };
      fetch_ff(0);
      for (int f = 0; f < nf; ++f) {
        const int tabs = tpos + i0 + f;
        float eta_rw[NG], st_w[NG], period_w[NG];
        bool ok_w[NG];
#pragma unroll
        for (int k = 0; k < NG; ++k) {
          eta_rw[k] = rawn[k]; st_w[k] = stn[k]; period_w[k] = periodf[k]; ok_w[k] = okf[k];
        }
        if (f + 1 < nf) fetch_ff(f + 1);
        float conf = 0.f;
        bool has_pos = false;
        if (prm.ff_enable) {
          const int pslot = min(max(position, 0), S - 1);
          has_pos = position >= 0;
          const float pos_eta = has_pos ? fabsf(w.eta[f * S + pslot]) : 0.f;
          if (has_pos & (pos_eta <= prm.ff_exit)) {
            mode = 1 - mode;
            position = -1;
          }
          has_pos = position >= 0;
        }
        bool before = false, any_buy = false;
        int n_buys = 0, n_sells = 0, first_fired = -1, n_active = 0;
#pragma unroll
        for (int u = 0; u < ns; ++u) {
          const bool sok = slot_ok(u);
          float eta_raw = 0.f, st = 0.f, period = 0.f;
          bool ok = false;
          if constexpr (kWide) {
            if (sok) {
              const int idx = f * S + lane + 32 * u;
              eta_raw = w.eta[idx]; st = w.color[idx]; period = s_period[idx];
              ok = stg_valid[idx] != 0;
            }
          } else {
            eta_raw = eta_rw[u]; st = st_w[u]; period = period_w[u]; ok = ok_w[u];
          }
          float sig = 0.f;
          if (prm.ff_enable) {
            bool elig = ok & (period >= prm.ff_min_p) & (period <= prm.ff_max_p) &
                        (stp[u] != 0.f) & (tabs >= 1);
            if (prm.ff_single) elig = elig & !has_pos;
            const bool same_state = st == stp[u];
            const float thr = prm.ff_thr;
            const float ep = etp[u];
            const bool pre_sell = (st > 0.f) & (ep > 0.f) & (eta_raw > 0.f) &
                                  (ep > thr) & (eta_raw <= thr);
            const bool pre_buy = (st < 0.f) & (ep < 0.f) & (eta_raw < 0.f) &
                                 (fabsf(ep) > thr) & (fabsf(eta_raw) <= thr);
            const int pre_dir = pre_buy ? 1 : (pre_sell ? -1 : 0);
            const bool pre_fire = elig & same_state & (prm.ff_entry_pos != 0) & (pre_dir != 0);
            const int turn = ((stp[u] == -1.f) & (st == 1.f)) ? 1
                           : (((stp[u] == 1.f) & (st == -1.f)) ? -1 : 0);
            const bool suppressed = (prm.ff_ignore_same != 0) & (lastdir[u] == turn) &
                                    (tabs > lastbar[u]) & (turn != 0);
            const bool turn_fire = elig & !same_state & (turn != 0) & !suppressed;
            bool fire = pre_fire | turn_fire;
            const int dir = pre_fire ? pre_dir : turn;
            const float value = pre_fire ? 60.0f * static_cast<float>(pre_dir)
                                         : 100.0f * static_cast<float>(turn);
            if (prm.ff_single) {
              // only the lowest firing slot fires
              const unsigned fm = __ballot_sync(kFull, fire);
              fire = fire & !before & (fm != 0u) & (lane == __ffs(fm) - 1);
              before |= fm != 0u;
            }
            sig = fire ? value : 0.f;
            if (fire & (!pre_fire | (prm.ff_single != 0))) {
              lastdir[u] = dir;
              lastbar[u] = tabs;
            }
            const unsigned buys = __ballot_sync(kFull, fire & (dir > 0));
            const unsigned sells = __ballot_sync(kFull, fire & (dir < 0));
            const unsigned fired = buys | sells;   // a firing slot has a direction
            if ((first_fired < 0) & (fired != 0u)) first_fired = 32 * u + __ffs(fired) - 1;
            any_buy |= buys != 0u;
            n_buys += __popc(buys);
            n_sells += __popc(sells);
            n_active += __popc(__ballot_sync(kFull, ok));
          }
          stp[u] = st;
          etp[u] = eta_raw;
          if (sok) out.sig[(x_sym + i0 + f) * S + lane + 32 * u] = sig;
        }
        if (prm.ff_enable) {
          if ((prm.ff_single != 0) & (first_fired >= 0)) {
            position = first_fired;
            mode = any_buy ? 0 : 1;
          }
          const float buy_pct = kWide ? pct_of(n_buys, n_active) : pct_tab[n_active * kPct + n_buys];
          const float sell_pct = kWide ? pct_of(n_sells, n_active) : pct_tab[n_active * kPct + n_sells];
          conf = ((n_active > 0) & (buy_pct >= prm.ff_conf_pct) & (buy_pct >= sell_pct)) ? prm.ff_lot
               : (((n_active > 0) & (sell_pct >= prm.ff_conf_pct) & (sell_pct > buy_pct)) ? -prm.ff_lot
                                                                                       : 0.f);
        }
        if (lane == 0) out.conf[x_sym + i0 + f] = conf;
      }

      // the lag ring keeps the chunk's last cycle values
#pragma unroll
      for (int u = 0; u < ns; ++u) {
        const int sl = lane + 32 * u;
        if (slot_ok(u)) {
          for (int f = max(0, nf - cap); f < nf; ++f) {
            ring[((tpos + i0 + f) % cap) * S + sl] = w.v[f * S + sl];
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- final state ----
#pragma unroll
  for (int u = 0; u < ns; ++u) {
    const int sl = lane + 32 * u;
    if (slot_ok(u)) {
      const long long o = bs(u);
      fin.y1[o] = y1[u]; fin.y2[o] = y2[u]; fin.vprev[o] = vprev[u];
      fin.colorp[o] = colorp[u]; fin.lasteta[o] = lasteta[u];
      fin.est[(2LL * b) * S + sl] = est0[u]; fin.est[(2LL * b + 1) * S + sl] = est1[u];
      fin.stp[o] = stp[u]; fin.etp[o] = etp[u]; fin.bars[o] = bars[u];
      fin.lastdir[o] = lastdir[u]; fin.lastbar[o] = lastbar[u];
      for (int j = 0; j < 5; ++j) {
        fin.bull[(5LL * b + j) * S + sl] = bull[5 * u + j];
        fin.bear[(5LL * b + j) * S + sl] = bear[5 * u + j];
      }
      for (int r = 0; r < cap; ++r) fin.ring[((long long)b * cap + r) * S + sl] = ring[r * S + sl];
    }
  }
  if (tid == 0) {
    fin.xh[2 * b] = xh0; fin.xh[2 * b + 1] = xh1;
    fin.posmode[2 * b] = position; fin.posmode[2 * b + 1] = mode;
    fin.tpos[b] = tpos + T;
  }
  if (tid == 32) {
    for (int k = 0; k < 4; ++k) fin.kx[4 * b + k] = kf.kx[k];
    for (int k = 0; k < 16; ++k) fin.kp[16 * b + k] = kf.kp[k];
    fin.kema[2 * b] = kf.ema; fin.kema[2 * b + 1] = kf.ready;
  }
}

TailState state_from(void* const* p) {
  return TailState{
      static_cast<float*>(p[0]), static_cast<float*>(p[1]), static_cast<float*>(p[2]),
      static_cast<float*>(p[3]), static_cast<float*>(p[4]), static_cast<float*>(p[5]),
      static_cast<float*>(p[6]), static_cast<float*>(p[7]), static_cast<float*>(p[8]),
      static_cast<float*>(p[9]), static_cast<float*>(p[10]), static_cast<float*>(p[11]),
      static_cast<float*>(p[12]), static_cast<int32_t*>(p[13]), static_cast<int32_t*>(p[14]),
      static_cast<int32_t*>(p[15]), static_cast<int32_t*>(p[16]), static_cast<int32_t*>(p[17]),
      static_cast<int32_t*>(p[18]), static_cast<int32_t*>(p[19])};
}

// the current device's shared memory a block, opted in
int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

}  // namespace

// The kernel's geometry at S slots and a lag ring of `cap` rows, on a card
// with `smem_optin` bytes of shared memory a block: slots a lane (`ns`),
// frames a chunk (`frames`), where the slot state lies (`memory`: 0 in
// registers for S <= 64; past it, 1 a region in dynamic shared memory, 2 a
// region of global scratch a symbol, `region` bytes) and the dynamic
// shared bytes (`smem`).
extern "C" void v757_tail_plan(int S, int cap, int smem_optin, int* ns, int* frames,
                               int* memory, long long* region, long long* smem) {
  const int F = frames_per_chunk(S);
  *frames = F;
  *ns = (S + 31) / 32;
  if (S <= kMaxSlots) {
    *memory = 0;
    *region = 0;
    *smem = static_cast<long long>(dynamic_smem(F, S, cap));
    return;
  }
  // the lag ring, the work arrays and 22 state words a slot
  *region = 4LL * (static_cast<long long>(cap) * S + 8LL * F * S + 22LL * 32 * *ns);
  const bool shared = *region + 1024 <= smem_optin;
  *memory = shared ? 1 : 2;
  *smem = shared ? *region : 0;
}

// The global scratch a symbol that v757_tail_launch needs on the current
// device at S slots and a lag ring of `cap` rows: the region where
// v757_tail_plan puts it in global memory, else 0.
extern "C" long long v757_tail_scratch_bytes(int S, int cap) {
  int ns, F, memory;
  long long region, smem;
  v757_tail_plan(S, cap, smem_optin(), &ns, &F, &memory, &region, &smem);
  return memory == 2 ? region : 0;
}

// in: 5 pointers (newest, price_prev, period, valid, gd). init: 20
// pointers in V757TailState order, or null for a fresh start. out: 8
// pointers (cycle_values, color, eta_display, eta_raw, states, sig,
// confluence, kalman). fin: 20 pointers in V757TailState order.
// prm: the TailParams block (host memory, copied by value). scratch:
// `scratch_bytes` of global memory, at least B * region where
// v757_tail_plan names memory 2, else unused. Returns a cudaError_t code:
// a scratch too small, a shared-memory size the card cannot give, or a
// refused launch, is returned, never skipped.
extern "C" int v757_tail_launch(void* const* in, void* const* init,
                                void* const* out, void* const* fin,
                                const void* prm, int B, void* scratch,
                                long long scratch_bytes, void* stream) {
  const TailParams p = *static_cast<const TailParams*>(prm);
  if (p.S < 1 || p.cap < 2 || p.T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ns, F, memory;
  long long region, smem_ll;
  v757_tail_plan(p.S, p.cap, smem_optin(), &ns, &F, &memory, &region, &smem_ll);
  if (memory == 2 && (scratch == nullptr || scratch_bytes < B * region)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t smem = static_cast<size_t>(smem_ll);
  auto kernel = memory ? v757_tail_kernel<1, true>
                       : (p.S <= 32 ? v757_tail_kernel<1, false> : v757_tail_kernel<2, false>);
  // the dynamic size, with the static arrays, may pass the default 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  TailIn ins{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
             static_cast<const float*>(in[2]), static_cast<const uint8_t*>(in[3]),
             static_cast<const float*>(in[4])};
  TailOut o{static_cast<float*>(out[0]), static_cast<float*>(out[1]),
            static_cast<float*>(out[2]), static_cast<float*>(out[3]),
            static_cast<float*>(out[4]), static_cast<float*>(out[5]),
            static_cast<float*>(out[6]), static_cast<float*>(out[7])};
  TailState st0 = init ? state_from(init) : TailState{};
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ins, st0, init != nullptr, o, state_from(fin), p, F, ns, memory == 1, region / 4,
      static_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// sizeof(TailParams), so the caller can check its ctypes mirror.
extern "C" int v757_tail_params_size() { return static_cast<int>(sizeof(TailParams)); }
