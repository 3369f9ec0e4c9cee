// The v7.57 tracker / stable-slot / leak state machine over T frames,
// vectorized matcher, for a batch of symbols.
//
// Replaces: wavespec_tpu/kernels/tracker_pallas.py::track_frames_pallas
// (Pallas `_kernel` / `_advance`), which is bitwise equal to the XLA scan
// wavespec_tpu/analyze/trackers.py::track_frames. This kernel is held
// bitwise equal to its plain PyTorch version,
// wavespec_tpu_torch/analyze/trackers.py::track_frames_plain, on all 11
// per-frame outputs and the final state, and resumes from `init` as the
// Pallas kernel does.
//
// What bounds it: each frame reads 4 * J candidate words and writes
// 11 * S words per symbol, a few hundred bytes, and does a few thousand
// compares. The frames of one symbol form a dependent chain, so the time
// is T times the latency of one frame's steps, not bandwidth or
// arithmetic: 1024 symbols (8 warps an SM) take about as long as 128.
// A warp reduction is five dependent shuffles; one per candidate, slot
// fill and slot leak search made a frame ~16 us on the H100, so none is
// left on the chain (~3.4 us a frame).
//
// Design: one warp per symbol (one block of 32 threads), the frame loop
// inside the kernel, no warp reduction on the chain. Lane l owns capacity
// rows l and l + 32 (C <= 64) in registers and publishes what other lanes
// read into shared memory: compact lists of the rows each phase may take
// (eligible, fillable, possible leak), built by ballot prefix counts in
// row order, and the rows' period, power and fft. Frames arrive in chunks
// of F frames by cp.async into a two-stage ring, so a chunk loads while
// the one before runs. Each phase keeps the plain version's tie rule:
// - matching: lane j scans the eligible rows in order, keeping the first
//   row of least cost (`_first_argmin`; two running minima over
//   alternate rows, joined by (cost, row)), with the tolerance test
//   decided without its division wherever that is exact
//   (`match_cost_fast`); each matched candidate lowers its row's
//   (cost, j) by a 64-bit shared atomicMin, so a row keeps the first
//   candidate of least cost; J > 32 runs in chunks of 32 candidates;
// - the nth unmatched candidate takes the nth dead row (ballot prefix);
// - slot keep: each row finds the slots holding its uid; each slot takes
//   the lowest such row by a shared atomicMin;
// - slot fill: each fillable row counts the fillable rows ahead of it in
//   (power desc, uid asc, row asc), the plain version's two stable sorts,
//   and the row of rank r takes the r-th free slot;
// - leak: lane s scans the possible leak rows in four interleaved running
//   maxima of (power, -uid), first row on ties, joined by (power, -uid,
//   -row): the plain version's max, then first argmin over uid, wherever
//   `found`.
// Conditions on the chain are bitwise (`&`, `|`) rather than
// short-circuit: nvcc turned `&&` over comparisons into branches, which
// cost more than the compares.
// This file must be compiled with --fmad=false, so that the tolerance
// expression rounds as the plain version's separate PyTorch ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kImax = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFrames = 16;          // frames a stage holds at most
constexpr int kStageBytes = 24 * 1024;  // staging budget per stage, sets F

struct Inputs {
  const float* __restrict__ period;    // [B, T, J]
  const float* __restrict__ power;
  const int32_t* __restrict__ fft;
  const uint8_t* __restrict__ valid;
};

// Tracker state, [B, C] / [B] / [B, S]; bools as bytes. The init set
// (nullable as a whole) has no seen_now.
struct State {
  float* period;
  int32_t* fft;
  float* power;
  uint8_t* alive;
  uint8_t* seen;
  int32_t* bars_inactive;
  int32_t* uid;
  int32_t* next_uid;
  int32_t* slot_uid;
  uint8_t* leak_active;
  int32_t* leak_uid;
  int32_t* leak_bars;
};

// Per-frame outputs, [B, T, S].
struct Outputs {
  float* slot_period;
  float* slot_power;
  int32_t* slot_fft;
  uint8_t* slot_valid;
  int32_t* slot_uid;
  uint8_t* leak_active;
  int32_t* leak_uid;
  float* leak_period;
  float* leak_power;
  int32_t* leak_fft;
  int32_t* leak_bars;
};

struct Params {
  int T, J, C, S, F;
  float tol, leak_pr, leak_wr;
  int max_inactive, leak_min, leak_max;
};

// Frames per stage and the dynamic shared memory: the unmatched
// candidates' list; per stage F * J
// period, power and fft words and the valid bytes as whole words.
__host__ __device__ inline int frames_per_stage(int J) {
  const int f = kStageBytes / (13 * J);
  return f < 1 ? 1 : (f > kMaxFrames ? kMaxFrames : f);
}
__host__ __device__ inline int valid_words(int F, int J) { return (F * J + 7) / 4 + 1; }
__host__ __device__ inline int stage_words(int F, int J) { return 3 * F * J + valid_words(F, J); }
inline size_t dynamic_smem(int J) {
  const int F = frames_per_stage(J);
  return (size_t)(J + 2 * stage_words(F, J)) * 4;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float match_cost(float p, float per, float tol) {
  const float diff = fabsf(p - per);
  const float avg = 0.5f * (p + per);
  const float pct = avg > 0.f ? diff / fmaxf(avg, 1e-30f) * 100.0f : kBig;
  return (per > 0.f && pct <= tol) ? diff : kBig;
}

// match_cost without the division, for p and per in [1e-20, 1e20] and
// tol in [1e-3, 1e6]: where the products 100 * diff and tol * avg differ
// by more than 2^-20 relative they decide `pct <= tol` as the division
// would (each side carries at most three roundings of 2^-24, and none is
// subnormal in that range); nearer than that, `unsure` is set and the
// caller takes match_cost. A padding period of 0 costs kBig.
constexpr float kBelow = 1.0f - 1.0f / (1 << 20), kAbove = 1.0f + 1.0f / (1 << 20);
__device__ __forceinline__ float match_cost_fast(float p, float per, float tol, bool& unsure) {
  const float diff = fabsf(p - per);
  const float avg = 0.5f * (p + per);
  const float x = diff * 100.0f, y = tol * avg;
  const bool below = x < y * kBelow;
  unsure |= !(below | (x > y * kAbove));
  return (below & (per > 0.f)) ? diff : kBig;
}

__device__ __forceinline__ bool in_range(float v) { return (v >= 1e-20f) & (v <= 1e20f); }

// A slot's strongest leak so far: the first row of the largest
// (power, -uid) among the entries scanned in row order.
struct Leak {
  float power = -1.f;
  int uid = kImax, row = kImax;

  // entry: period bits, power bits, uid, row of a row that may leak
  __device__ __forceinline__ void scan(const int4 e, float p_lim, float w_lim, int slot_uid) {
    const float p = __int_as_float(e.y);
    // bitwise, not short-circuit: no branch in the scan
    const bool take = (__int_as_float(e.x) < p_lim) & (p >= w_lim) & (e.z != slot_uid) &
                      ((p > power) | ((p == power) & (e.z < uid)));
    power = take ? p : power;
    uid = take ? e.z : uid;
    row = take ? e.w : row;
  }
  // the larger in (power, -uid, -row) of two scans of disjoint entries
  __device__ __forceinline__ void merge(const Leak& o) {
    if ((o.power > power) | ((o.power == power) & ((o.uid < uid) | ((o.uid == uid) & (o.row < row))))) {
      *this = o;
    }
  }
};

// One stage of the ring: frames [t0, t0 + nf) of symbol b.
struct Stage {
  float* per;
  float* pw;
  int32_t* fft;
  uint32_t* valid;   // whole words covering the frames' valid bytes

  __device__ Stage(uint32_t* base, int F, int J)
      : per(reinterpret_cast<float*>(base)), pw(per + F * J),
        fft(reinterpret_cast<int32_t*>(pw + F * J)),
        valid(reinterpret_cast<uint32_t*>(fft + F * J)) {}

  // Start the copies; the valid bytes go as the aligned words that hold
  // them (a word holding a byte of the tensor lies in its allocation).
  __device__ void load(const Inputs& in, long long e0, int n, int lane) const {
    for (int i = lane; i < n; i += 32) {
      cp_async4(per + i, in.period + e0 + i);
      cp_async4(pw + i, in.power + e0 + i);
      cp_async4(fft + i, in.fft + e0 + i);
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(in.valid + e0);
    const uintptr_t w0 = a & ~uintptr_t(3);
    const int nw = static_cast<int>(((a + n + 3) & ~uintptr_t(3)) - w0) / 4;
    for (int i = lane; i < nw; i += 32) {
      cp_async4(valid + i, reinterpret_cast<const void*>(w0 + 4 * i));
    }
  }
  __device__ const uint8_t* valid_bytes(const Inputs& in, long long e0) const {
    return reinterpret_cast<const uint8_t*>(valid) +
           (reinterpret_cast<uintptr_t>(in.valid + e0) & 3);
  }
};

__global__ void __launch_bounds__(32) tracker_kernel(Inputs in, State init, bool has_init,
                                                     Outputs out, State fin, Params prm) {
  // rows other lanes read, and the compact row lists, in row order
  __shared__ float r_per[64], r_pw[64];
  __shared__ int32_t r_fft[64];
  __shared__ int32_t e_row[64];                   // eligible for matching
  __shared__ __align__(16) float e_per[68];   // padded with 0 to a multiple of 4
  __shared__ int4 f_list[64];   // fillable: power bits, uid, row
  __shared__ int4 l_list[64];   // may leak: period bits, power bits, uid, row
  // per row, its least candidate: cost bits << 32 | j (all ones: none)
  __shared__ unsigned long long r_win[64];
  // per slot: its uid, the lowest alive row holding it (64: none), and
  // the uid and row that fill it
  __shared__ int32_t s_su[32], s_row[32], fill_uid[32], fill_row[32];
  extern __shared__ uint32_t smem[];
  const int J = prm.J, C = prm.C, S = prm.S, T = prm.T, F = prm.F;
  const bool fast = prm.tol >= 1e-3f && prm.tol <= 1e6f;
  int32_t* u_j = reinterpret_cast<int32_t*>(smem);   // unmatched candidates
  uint32_t* ring = smem + J;                          // two stages
  const int ring_step = stage_words(F, J);

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  const int r0 = lane, r1 = lane + 32;
  const bool ex0 = r0 < C, ex1 = r1 < C;

  // ---- state ----
  float per0 = 0.f, per1 = 0.f, pw0 = 0.f, pw1 = 0.f;
  int fi0 = 0, fi1 = 0, bi0 = 0, bi1 = 0, uid0 = 0, uid1 = 0;
  bool al0 = false, al1 = false, seen0 = false, seen1 = false;
  int next_uid = 1;
  int su = 0, luid = 0, lbars = 0;   // slot `lane` (lane < S)
  bool lact = false;
  if (has_init) {
    const long long c0 = (long long)b * C;
    if (ex0) {
      per0 = init.period[c0 + r0]; pw0 = init.power[c0 + r0];
      fi0 = init.fft[c0 + r0]; al0 = init.alive[c0 + r0] != 0;
      bi0 = init.bars_inactive[c0 + r0]; uid0 = init.uid[c0 + r0];
    }
    if (ex1) {
      per1 = init.period[c0 + r1]; pw1 = init.power[c0 + r1];
      fi1 = init.fft[c0 + r1]; al1 = init.alive[c0 + r1] != 0;
      bi1 = init.bars_inactive[c0 + r1]; uid1 = init.uid[c0 + r1];
    }
    next_uid = init.next_uid[b];
    if (lane < S) {
      const long long s0 = (long long)b * S + lane;
      su = init.slot_uid[s0]; lact = init.leak_active[s0] != 0;
      luid = init.leak_uid[s0]; lbars = init.leak_bars[s0];
    }
  }
  s_su[lane] = su;
  s_row[lane] = 64;
  r_win[r0] = r_win[r1] = ~0ull;

  const long long sym0 = (long long)b * T * J;
  const int n_chunks = (T + F - 1) / F;
  Stage(ring, F, J).load(in, sym0, min(F, T) * J, lane);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * F, nf = min(F, T - t0);
    if (ch + 1 < n_chunks) {
      Stage(ring + ((ch + 1) & 1) * ring_step, F, J)
          .load(in, sym0 + (long long)(t0 + F) * J, min(F, T - t0 - F) * J, lane);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();
    const Stage stg(ring + (ch & 1) * ring_step, F, J);
    const uint8_t* stg_valid = stg.valid_bytes(in, sym0 + (long long)t0 * J);

    for (int f = 0; f < nf; ++f) {
      const int t = t0 + f;
      const float* cp = stg.per + f * J;
      const float* cw = stg.pw + f * J;
      const int32_t* cf = stg.fft + f * J;
      const uint8_t* cv = stg_valid + f * J;

      // ---- eligible rows, in row order ----
      const bool e0 = ex0 & al0 & (bi0 == 0), e1 = ex1 & al1 & (bi1 == 0);
      const unsigned em0 = __ballot_sync(kFull, e0), em1 = __ballot_sync(kFull, e1);
      const int n_elig = __popc(em0) + __popc(em1);
      if (e0) { const int k = __popc(em0 & lt); e_row[k] = r0; e_per[k] = per0; }
      if (e1) { const int k = __popc(em0) + __popc(em1 & lt); e_row[k] = r1; e_per[k] = per1; }
      if (lane < 4) e_per[n_elig + lane] = 0.f;   // costs kBig
      const bool rows_fast =
          fast & (__all_sync(kFull, (!e0 | in_range(per0)) & (!e1 | in_range(per1))) != 0);
      __syncwarp();

      // ---- each candidate: the first eligible row of least cost; each
      // row: the least (cost, j) of the candidates that chose it ----
      int n_unm = 0;
      for (int base = 0; base < J; base += 32) {
        const int j = base + lane;
        float bc = kBig;
        int bk = -1;
        bool p_ok = false;
        if (j < J) {
          const float p = cp[j];
          p_ok = (cv[j] != 0) & (p > 0.f);
          if (p_ok) {
            bool unsure = !(rows_fast & in_range(p));
            if (!unsure) {
              // rows 4m, 4m + 2 and 4m + 1, 4m + 3 in two running
              // minima, then the less (cost, row) of the two
              float bc2 = kBig;
              int bk2 = -1;
              const float4* e4 = reinterpret_cast<const float4*>(e_per);
#pragma unroll 2
              for (int k = 0; k < n_elig; k += 4) {
                const float4 e = e4[k >> 2];
                const float c0 = match_cost_fast(p, e.x, prm.tol, unsure);
                const float c1 = match_cost_fast(p, e.y, prm.tol, unsure);
                const float c2 = match_cost_fast(p, e.z, prm.tol, unsure);
                const float c3 = match_cost_fast(p, e.w, prm.tol, unsure);
                bk = c0 < bc ? k : bk;
                bc = fminf(c0, bc);
                bk2 = c1 < bc2 ? k + 1 : bk2;
                bc2 = fminf(c1, bc2);
                bk = c2 < bc ? k + 2 : bk;
                bc = fminf(c2, bc);
                bk2 = c3 < bc2 ? k + 3 : bk2;
                bc2 = fminf(c3, bc2);
              }
              if ((bc2 < bc) | ((bc2 == bc) & (bk2 < bk))) { bc = bc2; bk = bk2; }
            }
            if (unsure) {
              bc = kBig;
              bk = -1;
              for (int k = 0; k < n_elig; ++k) {
                const float c = match_cost(p, e_per[k], prm.tol);
                bk = c < bc ? k : bk;
                bc = fminf(c, bc);
              }
            }
          }
        }
        const bool matched = bc < kBig;
        if (matched) {
          atomicMin(&r_win[e_row[bk]],
                    (static_cast<unsigned long long>(__float_as_uint(bc)) << 32) | unsigned(j));
        }
        const bool unm = p_ok & !matched;
        const unsigned um = __ballot_sync(kFull, unm);
        if (unm) u_j[n_unm + __popc(um & lt)] = j;
        n_unm += __popc(um);
      }
      __syncwarp();
      const unsigned long long w0 = r_win[r0], w1 = r_win[r1];
      r_win[r0] = r_win[r1] = ~0ull;
      const int wj0 = w0 == ~0ull ? -1 : static_cast<int>(w0 & 0xffffffffu);
      const int wj1 = w1 == ~0ull ? -1 : static_cast<int>(w1 & 0xffffffffu);
      seen0 = wj0 >= 0;
      seen1 = wj1 >= 0;
      if (seen0) { per0 = cp[wj0]; pw0 = cw[wj0]; fi0 = cf[wj0]; }
      if (seen1) { per1 = cp[wj1]; pw1 = cw[wj1]; fi1 = cf[wj1]; }

      // ---- the nth unmatched candidate takes the nth dead row ----
      const bool dead0 = ex0 & !al0, dead1 = ex1 & !al1;
      const unsigned dm0 = __ballot_sync(kFull, dead0);
      const unsigned dm1 = __ballot_sync(kFull, dead1);
      const int rank0 = __popc(dm0 & lt);
      const int rank1 = __popc(dm0) + __popc(dm1 & lt);
      if (dead0 & (rank0 < n_unm)) {
        const int jj = u_j[rank0];
        per0 = cp[jj]; pw0 = cw[jj]; fi0 = cf[jj];
        uid0 = next_uid + rank0; seen0 = true; al0 = true;
      }
      if (dead1 & (rank1 < n_unm)) {
        const int jj = u_j[rank1];
        per1 = cp[jj]; pw1 = cw[jj]; fi1 = cf[jj];
        uid1 = next_uid + rank1; seen1 = true; al1 = true;
      }
      next_uid += min(__popc(dm0) + __popc(dm1), n_unm);

      // ---- deactivate unseen; kill after max_inactive ----
      bi0 = seen0 ? 0 : bi0 + 1;
      bi1 = seen1 ? 0 : bi1 + 1;
      if (al0 & !seen0 & (bi0 >= prm.max_inactive)) al0 = false;
      if (al1 & !seen1 & (bi1 >= prm.max_inactive)) al1 = false;

      // publish the rows, and the rows that may leak, in row order
      if (ex0) { r_per[r0] = per0; r_pw[r0] = pw0; r_fft[r0] = fi0; }
      if (ex1) { r_per[r1] = per1; r_pw[r1] = pw1; r_fft[r1] = fi1; }
      const bool lk0 = ex0 & al0 & seen0 & (bi0 <= prm.leak_min);
      const bool lk1 = ex1 & al1 & seen1 & (bi1 <= prm.leak_min);
      const unsigned lm0 = __ballot_sync(kFull, lk0), lm1 = __ballot_sync(kFull, lk1);
      const int n_leak = __popc(lm0) + __popc(lm1);
      if (lk0) {
        l_list[__popc(lm0 & lt)] = make_int4(__float_as_int(per0), __float_as_int(pw0), uid0, r0);
      }
      if (lk1) {
        l_list[__popc(lm0) + __popc(lm1 & lt)] =
            make_int4(__float_as_int(per1), __float_as_int(pw1), uid1, r1);
      }

      // ---- stable slots: keep by uid while alive (lowest row) ----
      const bool live0 = ex0 & al0, live1 = ex1 & al1;
      unsigned km0 = 0, km1 = 0;   // the slots holding the row's uid
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const int sus = s_su[s];
        km0 |= (live0 & (sus > 0) & (uid0 == sus)) ? 1u << s : 0u;
        km1 |= (live1 & (sus > 0) & (uid1 == sus)) ? 1u << s : 0u;
      }
      const bool used0 = km0 != 0, used1 = km1 != 0;
      for (unsigned m = km0; m; m &= m - 1) atomicMin(&s_row[__ffs(m) - 1], r0);
      for (unsigned m = km1; m; m &= m - 1) atomicMin(&s_row[__ffs(m) - 1], r1);
      __syncwarp();
      int my_row = s_row[lane];
      s_row[lane] = 64;
      my_row = my_row < 64 ? my_row : -1;
      const bool is_free = (lane < S) & (my_row < 0);
      if (is_free) su = 0;

      // ---- fill free slots by rank (power desc, uid asc, row asc) ----
      const unsigned free_m = __ballot_sync(kFull, is_free);
      if (free_m) {
        const int n_free = __popc(free_m);
        const bool fl0 = live0 & !used0 & (pw0 > 0.f);
        const bool fl1 = live1 & !used1 & (pw1 > 0.f);
        const unsigned fm0 = __ballot_sync(kFull, fl0), fm1 = __ballot_sync(kFull, fl1);
        const int n_fill = __popc(fm0) + __popc(fm1);
        if (fl0) f_list[__popc(fm0 & lt)] = make_int4(__float_as_int(pw0), uid0, r0, 0);
        if (fl1) f_list[__popc(fm0) + __popc(fm1 & lt)] = make_int4(__float_as_int(pw1), uid1, r1, 0);
        __syncwarp();
        if (fl0 | fl1) {
          int ahead0 = 0, ahead1 = 0;
#pragma unroll 4
          for (int k = 0; k < n_fill; ++k) {
            const int4 e = f_list[k];
            const float p = __int_as_float(e.x);
            const int u = e.y, row = e.z;
            ahead0 += (p > pw0) | ((p == pw0) & ((u < uid0) | ((u == uid0) & (row < r0))));
            ahead1 += (p > pw1) | ((p == pw1) & ((u < uid1) | ((u == uid1) & (row < r1))));
          }
          if (fl0 & (ahead0 < n_free)) { fill_uid[ahead0] = uid0; fill_row[ahead0] = r0; }
          if (fl1 & (ahead1 < n_free)) { fill_uid[ahead1] = uid1; fill_row[ahead1] = r1; }
        }
        __syncwarp();
        const int fr = __popc(free_m & lt);
        if (is_free & (fr < n_fill)) { su = fill_uid[fr]; my_row = fill_row[fr]; }
      }
      __syncwarp();

      const bool sv = (lane < S) & (su > 0);
      const float slot_p = sv ? r_per[my_row] : 0.f;
      const float slot_pw = sv ? r_pw[my_row] : 0.f;
      const int slot_fi = sv ? r_fft[my_row] : 0;

      // ---- leakage: per slot the strongest intruder (smallest uid) ----
      // four scans, of the list entries 4m + i, each keeping the first
      // row of the largest (power, -uid); then the largest of the four in
      // (power, -uid, -row)
      Leak acc[4];
      if (sv) {
        const float p_lim = slot_p * prm.leak_pr, w_lim = slot_pw * prm.leak_wr;
        int k = 0;
        for (; k + 4 <= n_leak; k += 4) {
          const int4 e0 = l_list[k], e1 = l_list[k + 1], e2 = l_list[k + 2], e3 = l_list[k + 3];
          acc[0].scan(e0, p_lim, w_lim, su);
          acc[1].scan(e1, p_lim, w_lim, su);
          acc[2].scan(e2, p_lim, w_lim, su);
          acc[3].scan(e3, p_lim, w_lim, su);
        }
        for (; k < n_leak; ++k) acc[0].scan(l_list[k], p_lim, w_lim, su);
        acc[0].merge(acc[1]);
        acc[2].merge(acc[3]);
        acc[0].merge(acc[2]);
      }
      const float best = acc[0].power;
      const int best_uid = acc[0].uid, best_row = acc[0].row;
      const bool found = best > 0.f;
      if (lane < S) {
        int bars = lact ? lbars + 1 : 0;
        const bool was = lact & !(bars > prm.leak_max);
        const bool same = was & found & (luid == best_uid);
        lbars = same ? bars : (found ? 1 : 0);
        lact = found;
        luid = found ? best_uid : 0;

        const long long o = ((long long)b * T + t) * S + lane;
        out.slot_period[o] = slot_p;
        out.slot_power[o] = slot_pw;
        out.slot_fft[o] = slot_fi;
        out.slot_valid[o] = sv;
        out.slot_uid[o] = su;
        out.leak_active[o] = found;
        out.leak_uid[o] = luid;
        const int lrow = found ? best_row : 0;
        out.leak_period[o] = found ? r_per[lrow] : 0.f;
        out.leak_power[o] = found ? r_pw[lrow] : 0.f;
        out.leak_fft[o] = found ? r_fft[lrow] : 0;
        out.leak_bars[o] = found ? lbars : 0;
        s_su[lane] = su;
      }
      __syncwarp();
    }
  }

  // ---- final state ----
  const long long c0 = (long long)b * C;
  if (ex0) {
    fin.period[c0 + r0] = per0; fin.power[c0 + r0] = pw0; fin.fft[c0 + r0] = fi0;
    fin.alive[c0 + r0] = al0; fin.seen[c0 + r0] = seen0;
    fin.bars_inactive[c0 + r0] = bi0; fin.uid[c0 + r0] = uid0;
  }
  if (ex1) {
    fin.period[c0 + r1] = per1; fin.power[c0 + r1] = pw1; fin.fft[c0 + r1] = fi1;
    fin.alive[c0 + r1] = al1; fin.seen[c0 + r1] = seen1;
    fin.bars_inactive[c0 + r1] = bi1; fin.uid[c0 + r1] = uid1;
  }
  if (lane == 0) fin.next_uid[b] = next_uid;
  if (lane < S) {
    const long long s0 = (long long)b * S + lane;
    fin.slot_uid[s0] = su; fin.leak_active[s0] = lact;
    fin.leak_uid[s0] = luid; fin.leak_bars[s0] = lbars;
  }
}

State state_from(void* const* p) {
  return State{static_cast<float*>(p[0]), static_cast<int32_t*>(p[1]),
               static_cast<float*>(p[2]), static_cast<uint8_t*>(p[3]),
               static_cast<uint8_t*>(p[4]), static_cast<int32_t*>(p[5]),
               static_cast<int32_t*>(p[6]), static_cast<int32_t*>(p[7]),
               static_cast<int32_t*>(p[8]), static_cast<uint8_t*>(p[9]),
               static_cast<int32_t*>(p[10]), static_cast<int32_t*>(p[11])};
}

}  // namespace

// in: 4 pointers (period, power, fft, valid). init: 12 pointers in
// TrackerState order (seen_now unused), or null for a fresh start.
// out: 11 pointers in the order of Outputs. fin: 12 pointers in
// TrackerState order. Returns a cudaError_t code: a shared-memory size
// the card cannot give, or a refused launch, is returned, never skipped.
extern "C" int tracker_launch(void* const* in, void* const* init,
                              void* const* out, void* const* fin, int B,
                              int T, int J, int C, int S, float tol,
                              int max_inactive, float leak_pr, float leak_wr,
                              int leak_min, int leak_max, void* stream) {
  if (C < 1 || C > 64 || S < 1 || S > 32 || J < 1 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t smem = dynamic_smem(J);
  // the dynamic size, with the static arrays, may pass the default 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      tracker_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Inputs ins{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
             static_cast<const int32_t*>(in[2]), static_cast<const uint8_t*>(in[3])};
  State st0 = init ? state_from(init) : State{};
  Outputs o{static_cast<float*>(out[0]), static_cast<float*>(out[1]),
            static_cast<int32_t*>(out[2]), static_cast<uint8_t*>(out[3]),
            static_cast<int32_t*>(out[4]), static_cast<uint8_t*>(out[5]),
            static_cast<int32_t*>(out[6]), static_cast<float*>(out[7]),
            static_cast<float*>(out[8]), static_cast<int32_t*>(out[9]),
            static_cast<int32_t*>(out[10])};
  Params prm{T, J, C, S, frames_per_stage(J), tol, leak_pr, leak_wr,
             max_inactive, leak_min, leak_max};
  tracker_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      ins, st0, init != nullptr, o, state_from(fin), prm);
  return static_cast<int>(cudaGetLastError());
}
