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
// over its frames (lane l walks slots l and, past S = 32, l + 32), each
// term by the same expression as before, so with the same bits:
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
// FollowFirst's ballots run once per slot a lane, the lower slots first.
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
constexpr int kMaxSlots = 64;           // two slots a lane

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

// NS slots a lane: lane l of warp 0 walks slots l, l + 32, ... (< S).
template <int NS>
__global__ void __launch_bounds__(kThreads) v757_tail_kernel(
    TailIn in, TailState init, bool has_init, TailOut out, TailState fin, TailParams prm,
    int F) {
  constexpr int kPct = 32 * NS + 1;   // FollowFirst's percentage table side
  extern __shared__ uint32_t smem[];
  __shared__ float pct_tab[kPct * kPct];   // 100 * n / max(active, 1) at [active][n]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool walker = tid < 32;   // warp 0; warp 1 runs the Kalman filter
  const int S = prm.S, T = prm.T, cap = prm.cap;
  float* ring = reinterpret_cast<float*>(smem);                  // [cap][S]
  const Work w(smem + cap * S, F * S);
  uint32_t* stages = smem + cap * S + 8 * F * S;
  const int stage_step = stage_words(F, S);
  bool slot[NS];
  long long bs[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    slot[u] = walker && lane + 32 * u < S;
    bs[u] = (long long)b * S + lane + 32 * u;
  }
  float atan_c[9];   // in registers: the parameter block is not addressable
  for (int k = 0; k < 9; ++k) atan_c[k] = prm.atan[k];
  for (int k = tid; k < kPct * kPct; k += kThreads) {
    pct_tab[k] = 100.0f * static_cast<float>(k % kPct) / static_cast<float>(max(k / kPct, 1));
  }

  // ---- state, per slot a lane walks ----
  float y1[NS], y2[NS], vprev[NS], colorp[NS], lasteta[NS];
  float est0[NS], est1[NS], stp[NS], etp[NS];
  int bars[NS], lastdir[NS], lastbar[NS];
  int bull[NS][5], bear[NS][5];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    y1[u] = 0.f; y2[u] = 0.f; vprev[u] = 0.f; colorp[u] = 0.f; lasteta[u] = 0.f;
    est0[u] = 0.f; est1[u] = 0.f; stp[u] = 0.f; etp[u] = 0.f;
    bars[u] = prm.prior_bars; lastdir[u] = 0; lastbar[u] = -1;
#pragma unroll
    for (int j = 0; j < 5; ++j) { bull[u][j] = 0; bear[u][j] = 0; }
  }
  float xh0 = in.price_prev[2 * b], xh1 = in.price_prev[2 * b + 1];
  int position = -1, mode = 0, tpos = 0;
  Kalman kf;
  for (int k = 0; k < 4; ++k) kf.kx[k] = 0.f;
  for (int k = 0; k < 16; ++k) kf.kp[k] = 0.f;
  kf.ema = 0.f;
  kf.ready = 0.f;
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const int sl = lane + 32 * u;
    if (slot[u]) {
      for (int r = 0; r < cap; ++r) ring[r * S + sl] = 0.f;
    }
  }
  if (has_init) {
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      const int sl = lane + 32 * u;
      if (slot[u]) {
        y1[u] = init.y1[bs[u]]; y2[u] = init.y2[bs[u]]; vprev[u] = init.vprev[bs[u]];
        colorp[u] = init.colorp[bs[u]]; lasteta[u] = init.lasteta[bs[u]];
        est0[u] = init.est[(2LL * b) * S + sl]; est1[u] = init.est[(2LL * b + 1) * S + sl];
        stp[u] = init.stp[bs[u]]; etp[u] = init.etp[bs[u]]; bars[u] = init.bars[bs[u]];
        lastdir[u] = init.lastdir[bs[u]]; lastbar[u] = init.lastbar[bs[u]];
        for (int j = 0; j < 5; ++j) {
          bull[u][j] = init.bull[(5LL * b + j) * S + sl];
          bear[u][j] = init.bear[(5LL * b + j) * S + sl];
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
  Stage(stages, F, S).load(in, x_sym, e_sym, min(F, T), S, tid);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int i0 = ch * F, nf = min(F, T - i0), n = nf * S;
    if (ch + 1 < n_chunks) {
      Stage(stages + ((ch + 1) & 1) * stage_step, F, S)
          .load(in, x_sym + i0 + F, e_sym + (long long)(i0 + F) * S, min(F, T - i0 - F), S, tid);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const Stage stg(stages + (ch & 1) * stage_step, F, S);
    const uint8_t* stg_valid = stg.valid_bytes(in, e_sym + (long long)i0 * S);

    // ---- 1. every (frame, slot): the biquad coefficients, both warps ----
    for (int idx = tid; idx < n; idx += kThreads) {
      const float omega = kTwoPi / fmaxf(stg.period[idx], 2.01f);
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
        if (prm.kal_enable) kf.step(stg.newest[f], !has_init && i == 0, prm, kal);
        if (lane == 0) out.kal[x_sym + i] = kal;
      }
    } else {
      // ---- 2. lane s: the biquad recurrence ----
      // (each walk fetches the next frame's inputs before this frame's
      // stores, which the compiler cannot move them past)
      float b0n[NS], b2n[NS], a1n[NS], a2n[NS];
      bool liven[NS];
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        b0n[u] = 0.f; b2n[u] = 0.f; a1n[u] = 0.f; a2n[u] = 0.f; liven[u] = false;
      }
      auto fetch_biquad = [&](int f) {
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          if (slot[u]) {
            const int idx = f * S + lane + 32 * u;
            liven[u] = (stg_valid[idx] != 0) & (stg.period[idx] > 0.f);
            b0n[u] = w.b0[idx]; b2n[u] = w.b2[idx]; a1n[u] = w.a1[idx]; a2n[u] = w.a2[idx];
          }
        }
      };
      fetch_biquad(0);
      for (int f = 0; f < nf; ++f) {
        const float x = stg.newest[f];
        bool live[NS];
        float b0[NS], b2[NS], a1[NS], a2[NS];
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          live[u] = liven[u]; b0[u] = b0n[u]; b2[u] = b2n[u]; a1[u] = a1n[u]; a2[u] = a2n[u];
        }
        if (f + 1 < nf) fetch_biquad(f + 1);
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          const float uu = live[u] ? b0[u] * x + b2[u] * xh0 : 0.f;
          const float v = live[u] ? uu - a1[u] * y1[u] - a2[u] * y2[u] : 0.f;
          if (slot[u]) {
            w.v[f * S + lane + 32 * u] = v;
            out.cyc[(x_sym + i0 + f) * S + lane + 32 * u] = v;
          }
          y2[u] = y1[u];
          y1[u] = v;
        }
        xh0 = xh1;
        xh1 = x;
      }
      __syncwarp();

      // ---- 3. every (frame, slot): the ETA before the machine's state
      // (PHASE: from the angle to the quarter-period lag; REALFFT: from
      // the group delay) ----
      if (prm.eta_mode != 2) {
        for (int idx = lane; idx < n; idx += 32) {
          const int f = idx / S;
          const float period = stg.period[idx];
          float eta;
          if (prm.eta_mode == 1) {
            const float mb = 1.5f * period;
            const float tau = clampf(stg.gd[idx], -mb, mb);
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

      // ---- 4. lane s: the ETA / color machine ----
      float vn[NS], periodn[NS], gdn[NS], etan[NS];
      bool okn[NS];
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        vn[u] = 0.f; periodn[u] = 0.f; gdn[u] = 0.f; etan[u] = 0.f; okn[u] = false;
      }
      auto fetch_machine = [&](int f) {
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          if (slot[u]) {
            const int idx = f * S + lane + 32 * u;
            vn[u] = w.v[idx]; periodn[u] = stg.period[idx]; gdn[u] = stg.gd[idx];
            okn[u] = stg_valid[idx] != 0;
            if (prm.eta_mode != 2) etan[u] = w.eta0[idx];
          }
        }
      };
      fetch_machine(0);
      for (int f = 0; f < nf; ++f) {
        const bool first = !has_init & (i0 + f == 0);
        float vv[NS], pp[NS], gg[NS], ee[NS];
        bool oo[NS];
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          vv[u] = vn[u]; pp[u] = periodn[u]; gg[u] = gdn[u]; ee[u] = etan[u]; oo[u] = okn[u];
        }
        if (f + 1 < nf) fetch_machine(f + 1);
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          const int idx = f * S + lane + 32 * u;
          const float v = vv[u], period = pp[u], gd = gg[u];
          float eta = ee[u];
          const bool ok = oo[u];
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
              hs[j] = bullish ? bull[u][j] : bear[u][j];
              ho[j] = bullish ? bear[u][j] : bull[u][j];
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
            const float base = (1.0f - clampf(prog, 0.f, 1.f)) * tsec;
            const float max_adj = tsec * 0.25f;
            const float gd_sec = clampf(gd * prm.spb, -max_adj, max_adj);
            float sci = clampf(base + 0.25f * gd_sec, 0.f, tsec * 1.5f);
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
            for (int j = 4; j > 0; --j) bull[u][j] = bull[u][j - 1];
            bull[u][0] = bars[u];
            est0[u] = static_cast<float>(bars[u]);
          }
          if (store_bear) {
            for (int j = 4; j > 0; --j) bear[u][j] = bear[u][j - 1];
            bear[u][0] = bars[u];
            est1[u] = static_cast<float>(bars[u]);
          }

          // monotonic countdown within a phase
          const float expected = fmaxf(lasteta[u] - prm.spb, 0.f);
          if (!changed & (lasteta[u] > 0.f) & !first) eta = fminf(eta, expected);
          eta = period > 0.f ? eta : 0.f;
          if ((prm.prior_bars == 0) & first) eta = 0.f;
          eta = ok ? eta : 0.f;
          if (slot[u]) {
            w.eta[idx] = eta;
            w.color[idx] = color;
          }
          colorp[u] = color;
          bars[u] = bars_now;
          lasteta[u] = eta;
          vprev[u] = v;
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
        const bool shown = stg.period[idx] > 0.f && ok;
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

      // ---- 6. lane s: FollowFirst ----
      float rawn[NS], stn[NS], periodf[NS];
      bool okf[NS];
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        rawn[u] = 0.f; stn[u] = 0.f; periodf[u] = 0.f; okf[u] = false;
      }
      auto fetch_ff = [&](int f) {
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          if (slot[u]) {
            const int idx = f * S + lane + 32 * u;
            rawn[u] = w.eta[idx]; stn[u] = w.color[idx]; periodf[u] = stg.period[idx];
            okf[u] = stg_valid[idx] != 0;
          }
        }
      };
      fetch_ff(0);
      for (int f = 0; f < nf; ++f) {
        const int tabs = tpos + i0 + f;
        float eta_raw[NS], st[NS], period[NS];
        bool ok[NS];
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          eta_raw[u] = rawn[u]; st[u] = stn[u]; period[u] = periodf[u]; ok[u] = okf[u];
        }
        if (f + 1 < nf) fetch_ff(f + 1);
        float sig[NS];
        float conf = 0.f;
#pragma unroll
        for (int u = 0; u < NS; ++u) sig[u] = 0.f;
        if (prm.ff_enable) {
          const int pslot = min(max(position, 0), S - 1);
          float pos_eta_v = 0.f;
#pragma unroll
          for (int u = 0; u < NS; ++u) {
            const float e = __shfl_sync(kFull, fabsf(eta_raw[u]), pslot & 31);
            pos_eta_v = (pslot >> 5) == u ? e : pos_eta_v;
          }
          bool has_pos = position >= 0;
          const float pos_eta = has_pos ? pos_eta_v : 0.f;
          if (has_pos & (pos_eta <= prm.ff_exit)) {
            mode = 1 - mode;
            position = -1;
          }
          has_pos = position >= 0;
          bool fire[NS], pre_fire[NS];
          int dir[NS];
          float value[NS];
#pragma unroll
          for (int u = 0; u < NS; ++u) {
            bool elig = ok[u] & (period[u] >= prm.ff_min_p) & (period[u] <= prm.ff_max_p) &
                        (stp[u] != 0.f) & (tabs >= 1);
            if (prm.ff_single) elig = elig & !has_pos;
            const bool same_state = st[u] == stp[u];
            const float thr = prm.ff_thr;
            const bool pre_sell = (st[u] > 0.f) & (etp[u] > 0.f) & (eta_raw[u] > 0.f) &
                                  (etp[u] > thr) & (eta_raw[u] <= thr);
            const bool pre_buy = (st[u] < 0.f) & (etp[u] < 0.f) & (eta_raw[u] < 0.f) &
                                 (fabsf(etp[u]) > thr) & (fabsf(eta_raw[u]) <= thr);
            const int pre_dir = pre_buy ? 1 : (pre_sell ? -1 : 0);
            pre_fire[u] = elig & same_state & (prm.ff_entry_pos != 0) & (pre_dir != 0);
            const int turn = ((stp[u] == -1.f) & (st[u] == 1.f)) ? 1
                           : (((stp[u] == 1.f) & (st[u] == -1.f)) ? -1 : 0);
            const bool suppressed = (prm.ff_ignore_same != 0) & (lastdir[u] == turn) &
                                    (tabs > lastbar[u]) & (turn != 0);
            const bool turn_fire = elig & !same_state & (turn != 0) & !suppressed;
            fire[u] = pre_fire[u] | turn_fire;
            dir[u] = pre_fire[u] ? pre_dir : turn;
            value[u] = pre_fire[u] ? 60.0f * static_cast<float>(pre_dir)
                                   : 100.0f * static_cast<float>(turn);
          }
          if (prm.ff_single) {
            // only the lowest firing slot fires
            bool before = false;
#pragma unroll
            for (int u = 0; u < NS; ++u) {
              const unsigned fm = __ballot_sync(kFull, fire[u]);
              fire[u] = fire[u] & !before & (fm != 0u) & (lane == __ffs(fm) - 1);
              before |= fm != 0u;
            }
          }
          int n_buys = 0, n_sells = 0, first_fired = -1, n_active = 0;
          bool any_buy = false;
#pragma unroll
          for (int u = 0; u < NS; ++u) {
            sig[u] = fire[u] ? value[u] : 0.f;
            if (fire[u] & (!pre_fire[u] | (prm.ff_single != 0))) {
              lastdir[u] = dir[u];
              lastbar[u] = tabs;
            }
            const unsigned buys = __ballot_sync(kFull, fire[u] & (dir[u] > 0));
            const unsigned sells = __ballot_sync(kFull, fire[u] & (dir[u] < 0));
            const unsigned fired = buys | sells;   // a firing slot has a direction
            if ((first_fired < 0) & (fired != 0u)) first_fired = 32 * u + __ffs(fired) - 1;
            any_buy |= buys != 0u;
            n_buys += __popc(buys);
            n_sells += __popc(sells);
            n_active += __popc(__ballot_sync(kFull, ok[u]));
          }
          if ((prm.ff_single != 0) & (first_fired >= 0)) {
            position = first_fired;
            mode = any_buy ? 0 : 1;
          }
          const float buy_pct = pct_tab[n_active * kPct + n_buys];
          const float sell_pct = pct_tab[n_active * kPct + n_sells];
          conf = ((n_active > 0) & (buy_pct >= prm.ff_conf_pct) & (buy_pct >= sell_pct)) ? prm.ff_lot
               : (((n_active > 0) & (sell_pct >= prm.ff_conf_pct) & (sell_pct > buy_pct)) ? -prm.ff_lot
                                                                                       : 0.f);
        }
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          stp[u] = st[u];
          etp[u] = eta_raw[u];
          if (slot[u]) out.sig[(x_sym + i0 + f) * S + lane + 32 * u] = sig[u];
        }
        if (lane == 0) out.conf[x_sym + i0 + f] = conf;
      }

      // the lag ring keeps the chunk's last cycle values
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        const int sl = lane + 32 * u;
        if (slot[u]) {
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
  for (int u = 0; u < NS; ++u) {
    const int sl = lane + 32 * u;
    if (slot[u]) {
      fin.y1[bs[u]] = y1[u]; fin.y2[bs[u]] = y2[u]; fin.vprev[bs[u]] = vprev[u];
      fin.colorp[bs[u]] = colorp[u]; fin.lasteta[bs[u]] = lasteta[u];
      fin.est[(2LL * b) * S + sl] = est0[u]; fin.est[(2LL * b + 1) * S + sl] = est1[u];
      fin.stp[bs[u]] = stp[u]; fin.etp[bs[u]] = etp[u]; fin.bars[bs[u]] = bars[u];
      fin.lastdir[bs[u]] = lastdir[u]; fin.lastbar[bs[u]] = lastbar[u];
      for (int j = 0; j < 5; ++j) {
        fin.bull[(5LL * b + j) * S + sl] = bull[u][j];
        fin.bear[(5LL * b + j) * S + sl] = bear[u][j];
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

}  // namespace

// in: 5 pointers (newest, price_prev, period, valid, gd). init: 20
// pointers in V757TailState order, or null for a fresh start. out: 8
// pointers (cycle_values, color, eta_display, eta_raw, states, sig,
// confluence, kalman). fin: 20 pointers in V757TailState order.
// prm: the TailParams block (host memory, copied by value). Returns a
// cudaError_t code: a shared-memory size the card cannot give, or a
// refused launch, is returned, never skipped.
extern "C" int v757_tail_launch(void* const* in, void* const* init,
                                void* const* out, void* const* fin,
                                const void* prm, int B, void* stream) {
  const TailParams p = *static_cast<const TailParams*>(prm);
  if (p.S < 1 || p.S > kMaxSlots || p.cap < 2 || p.T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int F = frames_per_chunk(p.S);
  const size_t smem = dynamic_smem(F, p.S, p.cap);
  auto kernel = p.S <= 32 ? v757_tail_kernel<1> : v757_tail_kernel<2>;
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
      ins, st0, init != nullptr, o, state_from(fin), p, F);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(TailParams), so the caller can check its ctypes mirror.
extern "C" int v757_tail_params_size() { return static_cast<int>(sizeof(TailParams)); }
