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
// machine's state feeds the next frame), so the time is the latency of
// T frame steps, not bandwidth or arithmetic.
//
// Design: one warp per symbol (one block of 32 threads), the frame loop
// inside the kernel. Lane s < S runs slot s's biquad and ETA machine
// with its state in registers; the quarter-period lag ring lives in
// shared memory, [cap][S]. FollowFirst's per-symbol position, the first
// firing slot and the confluence counts are warp ballots and shuffles.
// Every lane runs the per-symbol Kalman step (uniform, no divergence);
// lane 0 stores it. Lanes >= S behave as inactive slots.
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

struct TailIn {
  const float* newest;      // [B, T]
  const float* price_prev;  // [B, 2]
  const float* period;      // [B, T, S]
  const uint8_t* valid;     // [B, T, S]
  const float* gd;          // [B, T, S]
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

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// atan2(q, i) mod pi in [0, pi): octant reduction and the fitted odd
// polynomial, as analyze/eta.py::_angle_mod_pi.
__device__ float angle_mod_pi(float q, float i, const float* c) {
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

__global__ void v757_tail_kernel(TailIn in, TailState init, bool has_init,
                                 TailOut out, TailState fin, TailParams prm) {
  extern __shared__ float ring[];   // [cap][S]
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int S = prm.S, T = prm.T, cap = prm.cap;
  const bool slot = lane < S;
  const long long bs = (long long)b * S + lane;

  // ---- state ----
  float y1 = 0.f, y2 = 0.f, vprev = 0.f, colorp = 0.f, lasteta = 0.f;
  float est0 = 0.f, est1 = 0.f, stp = 0.f, etp = 0.f;
  int bars = prm.prior_bars, lastdir = 0, lastbar = -1;
  int bull[5] = {0, 0, 0, 0, 0}, bear[5] = {0, 0, 0, 0, 0};
  float xh0 = in.price_prev[2 * b], xh1 = in.price_prev[2 * b + 1];
  int position = -1, mode = 0, tpos = 0;
  float kx[4] = {0.f, 0.f, 0.f, 0.f}, kp[16], ema = 0.f, ready = 0.f;
  for (int k = 0; k < 16; ++k) kp[k] = 0.f;
  if (slot) {
    for (int r = 0; r < cap; ++r) ring[r * S + lane] = 0.f;
  }
  if (has_init) {
    if (slot) {
      y1 = init.y1[bs]; y2 = init.y2[bs]; vprev = init.vprev[bs];
      colorp = init.colorp[bs]; lasteta = init.lasteta[bs];
      est0 = init.est[(2LL * b) * S + lane]; est1 = init.est[(2LL * b + 1) * S + lane];
      stp = init.stp[bs]; etp = init.etp[bs]; bars = init.bars[bs];
      lastdir = init.lastdir[bs]; lastbar = init.lastbar[bs];
      for (int j = 0; j < 5; ++j) {
        bull[j] = init.bull[(5LL * b + j) * S + lane];
        bear[j] = init.bear[(5LL * b + j) * S + lane];
      }
      for (int r = 0; r < cap; ++r) ring[r * S + lane] = init.ring[((long long)b * cap + r) * S + lane];
    }
    xh0 = init.xh[2 * b]; xh1 = init.xh[2 * b + 1];
    position = init.posmode[2 * b]; mode = init.posmode[2 * b + 1];
    tpos = init.tpos[b];
    for (int k = 0; k < 4; ++k) kx[k] = init.kx[4 * b + k];
    for (int k = 0; k < 16; ++k) kp[k] = init.kp[16 * b + k];
    ema = init.kema[2 * b]; ready = init.kema[2 * b + 1];
  }
  __syncwarp();

  for (int i = 0; i < T; ++i) {
    const int tabs = tpos + i;
    const bool first = !has_init && i == 0;
    const float x = in.newest[(long long)b * T + i];
    const long long o = ((long long)b * T + i) * S + lane;
    const float period = slot ? in.period[o] : 0.f;
    const bool ok = slot && in.valid[o] != 0;
    const float gd = slot ? in.gd[o] : 0.f;

    // ---- biquad band-pass ----
    const float omega = kTwoPi / fmaxf(period, 2.01f);
    const float sw = sinf(omega);
    const float z = prm.sh * omega / sw;
    const float alpha = sw * 0.5f * (expf(z) - expf(-z));
    const float a0 = 1.0f + alpha;
    const float b0 = alpha / a0, b2 = -alpha / a0;
    const float a1 = -2.0f * cosf(omega) / a0, a2 = (1.0f - alpha) / a0;
    const bool live = ok && period > 0.f;
    const float u = live ? b0 * x + b2 * xh0 : 0.f;
    const float v = live ? u - a1 * y1 - a2 * y2 : 0.f;
    y2 = y1;
    y1 = v;
    xh0 = xh1;
    xh1 = x;

    // ---- ETA / color machine ----
    const bool bullish = first ? (v >= 0.f) : (v >= vprev);
    const float color = (ok && bullish) ? 1.f : 0.f;
    const bool flipped = color != colorp;
    bool changed;
    int bars_now;
    if (prm.prior_bars > 0) {
      changed = flipped && ok;
      bars_now = flipped ? 1 : bars + 1;
    } else {
      changed = flipped && ok && !first;
      bars_now = (first || flipped) ? 1 : bars + 1;
    }
    const int q = min(max(static_cast<int>(fmaxf(floorf(period / 4.0f + 0.5f), 1.0f)), 1), cap - 1);
    int lag = (tabs - q) % cap;
    if (lag < 0) lag += cap;
    const float v_lag = slot ? ring[lag * S + lane] : 0.f;
    const float m_ang = angle_mod_pi(v_lag, v, prm.atan);
    const float dphi = m_ang > 0.f ? kPi - m_ang : 0.f;
    const float psec = period * prm.spb;
    float eta = clampf(dphi / kTwoPi * psec, 0.f, 1.5f * psec);
    eta = (period > 0.f && tabs >= q) ? eta : 0.f;
    const float bars_f = static_cast<float>(bars_now);
    if (prm.eta_mode == 1) {
      const float mb = 1.5f * period;
      const float tau = clampf(gd, -mb, mb);
      eta = period > 0.f ? fminf(fabsf(tau) * prm.spb, mb * prm.spb) : 0.f;
    } else if (prm.eta_mode == 2) {
      int hs[5], ho[5];
      for (int j = 0; j < 5; ++j) {
        hs[j] = bullish ? bull[j] : bear[j];
        ho[j] = bullish ? bear[j] : bull[j];
      }
      const float med_same = static_cast<float>(median5(hs));
      const float med_opp = static_cast<float>(median5(ho));
      float e = bullish ? est0 : est1;
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
    const bool was_bull = colorp > 0.5f;
    const bool store_bull = changed && was_bull && period > 0.f;
    const bool store_bear = changed && !was_bull && period > 0.f;
    if (store_bull) {
      for (int j = 4; j > 0; --j) bull[j] = bull[j - 1];
      bull[0] = bars;
      est0 = static_cast<float>(bars);
    }
    if (store_bear) {
      for (int j = 4; j > 0; --j) bear[j] = bear[j - 1];
      bear[0] = bars;
      est1 = static_cast<float>(bars);
    }

    // monotonic countdown within a phase
    const float expected = fmaxf(lasteta - prm.spb, 0.f);
    if (!changed && lasteta > 0.f && !first) eta = fminf(eta, expected);
    eta = period > 0.f ? eta : 0.f;
    if (prm.prior_bars == 0 && first) eta = 0.f;
    eta = ok ? eta : 0.f;
    const float eta_bars = eta / prm.spb;
    const bool bull_c = color > 0.5f;
    const float signed_eta = bull_c ? eta_bars : -eta_bars;
    const bool shown = period > 0.f && ok;
    const float disp = (bull_c && signed_eta >= 0.f && signed_eta < 1.f) ? 1.f : signed_eta;
    const float eta_raw = shown ? signed_eta : 0.f;
    if (slot) ring[(tabs % cap) * S + lane] = v;
    colorp = color;
    bars = bars_now;
    lasteta = eta;
    vprev = v;

    // ---- states + FollowFirst ----
    const float st = ok ? (color > 0.5f ? 1.f : -1.f) : 0.f;
    float sig = 0.f, conf = 0.f;
    if (prm.ff_enable) {
      const float pos_eta_v = __shfl_sync(kFull, fabsf(eta_raw), min(max(position, 0), S - 1));
      bool has_pos = position >= 0;
      const float pos_eta = has_pos ? pos_eta_v : 0.f;
      if (has_pos && pos_eta <= prm.ff_exit) {
        mode = 1 - mode;
        position = -1;
      }
      has_pos = position >= 0;
      bool elig = ok && period >= prm.ff_min_p && period <= prm.ff_max_p &&
                  stp != 0.f && tabs >= 1;
      if (prm.ff_single) elig = elig && !has_pos;
      const bool same_state = st == stp;
      const float thr = prm.ff_thr;
      const bool pre_sell = st > 0.f && etp > 0.f && eta_raw > 0.f && etp > thr && eta_raw <= thr;
      const bool pre_buy = st < 0.f && etp < 0.f && eta_raw < 0.f && fabsf(etp) > thr &&
                           fabsf(eta_raw) <= thr;
      const int pre_dir = pre_buy ? 1 : (pre_sell ? -1 : 0);
      const bool pre_fire = elig && same_state && prm.ff_entry_pos && pre_dir != 0;
      const int turn = (stp == -1.f && st == 1.f) ? 1 : ((stp == 1.f && st == -1.f) ? -1 : 0);
      const bool suppressed = prm.ff_ignore_same && lastdir == turn && tabs > lastbar && turn != 0;
      const bool turn_fire = elig && !same_state && turn != 0 && !suppressed;
      bool fire = pre_fire || turn_fire;
      const int dir = pre_fire ? pre_dir : turn;
      const float value = pre_fire ? 60.0f * static_cast<float>(pre_dir)
                                   : 100.0f * static_cast<float>(turn);
      if (prm.ff_single) {
        const unsigned fm = __ballot_sync(kFull, fire);
        fire = fire && fm != 0u && lane == __ffs(fm) - 1;
      }
      sig = fire ? value : 0.f;
      if (fire && (!pre_fire || prm.ff_single)) {
        lastdir = dir;
        lastbar = tabs;
      }
      const unsigned fired = __ballot_sync(kFull, fire);
      const unsigned buys = __ballot_sync(kFull, fire && dir > 0);
      const unsigned sells = __ballot_sync(kFull, fire && dir < 0);
      if (prm.ff_single && fired) {
        position = __ffs(fired) - 1;
        mode = buys ? 0 : 1;
      }
      const int n_active = __popc(__ballot_sync(kFull, ok));
      const float denom = static_cast<float>(max(n_active, 1));
      const float buy_pct = 100.0f * static_cast<float>(__popc(buys)) / denom;
      const float sell_pct = 100.0f * static_cast<float>(__popc(sells)) / denom;
      conf = (n_active > 0 && buy_pct >= prm.ff_conf_pct && buy_pct >= sell_pct) ? prm.ff_lot
           : ((n_active > 0 && sell_pct >= prm.ff_conf_pct && sell_pct > buy_pct) ? -prm.ff_lot : 0.f);
    }
    stp = st;
    etp = eta_raw;

    // ---- Kalman 4D (every lane, uniform) ----
    float kal = 0.f;
    if (prm.kal_enable) {
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

    if (slot) {
      out.cyc[o] = v;
      out.color[o] = color;
      out.eta_disp[o] = shown ? disp : 0.f;
      out.eta_raw[o] = eta_raw;
      out.states[o] = st;
      out.sig[o] = sig;
    }
    if (lane == 0) {
      out.conf[(long long)b * T + i] = conf;
      out.kal[(long long)b * T + i] = kal;
    }
  }
  __syncwarp();

  // ---- final state ----
  if (slot) {
    fin.y1[bs] = y1; fin.y2[bs] = y2; fin.vprev[bs] = vprev;
    fin.colorp[bs] = colorp; fin.lasteta[bs] = lasteta;
    fin.est[(2LL * b) * S + lane] = est0; fin.est[(2LL * b + 1) * S + lane] = est1;
    fin.stp[bs] = stp; fin.etp[bs] = etp; fin.bars[bs] = bars;
    fin.lastdir[bs] = lastdir; fin.lastbar[bs] = lastbar;
    for (int j = 0; j < 5; ++j) {
      fin.bull[(5LL * b + j) * S + lane] = bull[j];
      fin.bear[(5LL * b + j) * S + lane] = bear[j];
    }
    for (int r = 0; r < cap; ++r) fin.ring[((long long)b * cap + r) * S + lane] = ring[r * S + lane];
  }
  if (lane == 0) {
    fin.xh[2 * b] = xh0; fin.xh[2 * b + 1] = xh1;
    fin.posmode[2 * b] = position; fin.posmode[2 * b + 1] = mode;
    fin.tpos[b] = tpos + T;
    for (int k = 0; k < 4; ++k) fin.kx[4 * b + k] = kx[k];
    for (int k = 0; k < 16; ++k) fin.kp[16 * b + k] = kp[k];
    fin.kema[2 * b] = ema; fin.kema[2 * b + 1] = ready;
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
// prm: the TailParams block (host memory, copied by value).
extern "C" int v757_tail_launch(void* const* in, void* const* init,
                                void* const* out, void* const* fin,
                                const void* prm, int B, void* stream) {
  const TailParams p = *static_cast<const TailParams*>(prm);
  const size_t smem = (size_t)p.cap * p.S * sizeof(float);
  if (p.S < 1 || p.S > 32 || p.cap < 2 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  TailIn ins{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
             static_cast<const float*>(in[2]), static_cast<const uint8_t*>(in[3]),
             static_cast<const float*>(in[4])};
  TailOut o{static_cast<float*>(out[0]), static_cast<float*>(out[1]),
            static_cast<float*>(out[2]), static_cast<float*>(out[3]),
            static_cast<float*>(out[4]), static_cast<float*>(out[5]),
            static_cast<float*>(out[6]), static_cast<float*>(out[7])};
  TailState st0 = init ? state_from(init) : TailState{};
  v757_tail_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      ins, st0, init != nullptr, o, state_from(fin), p);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(TailParams), so the caller can check its ctypes mirror.
extern "C" int v757_tail_params_size() { return static_cast<int>(sizeof(TailParams)); }
