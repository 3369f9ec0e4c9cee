// The v7.57 tracker / stable-slot / leak state machine over T frames, for
// a batch of symbols, with either matcher: vectorized (kernel B4), or the
// reference-exact sequential one (its mode kSeq, B4s).
//
// Replaces: wavespec_tpu/kernels/tracker_pallas.py::track_frames_pallas
// (Pallas `_kernel` / `_advance`), which is bitwise equal to the XLA scan
// wavespec_tpu/analyze/trackers.py::track_frames; in mode kSeq, the XLA
// scan over candidates inside the scan over frames,
// wavespec_tpu/analyze/trackers.py::_sequential_match_update (no Pallas
// kernel). This kernel is held bitwise equal to its plain PyTorch version,
// wavespec_tpu_torch/analyze/trackers.py::track_frames_plain (with
// `sequential_match` in mode kSeq), on all 11 per-frame outputs and the
// final state, and resumes from `init` as the Pallas kernel does.
//
// Mode kSeq replaces only the matching and the row allocation: the
// frame's candidates j = 0..J-1 in order, each on the rows as the earlier
// candidates left them (`analyze/trackers.py::_sequential_match_update`
// step for step): the eligible rows' costs (match_cost_fast, match_cost
// where that is not sure), the warp's least cost by one redux.sync, the
// least uid among the rows of that cost by a second, and the first row
// holding it (or, unmatched, the first dead row) by a ballot in row order;
// the lane that owns the row updates it at once. Its chain is J such
// steps a frame (149 at the reference-exact mode's window 4096), each two
// warp reductions and NR ballots long; deactivation, slots and leaks are
// the vectorized mode's.
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
// rows l, l + 32, ... (NR rows a lane: 2 for C <= 64, 4 to 128, 8 to
// 256) in registers, and slots l, l + 32 (NS: 1 for S <= 32, 2 to 64),
// and publishes what other lanes read into shared memory: compact lists
// of the rows each phase may take (eligible, fillable, possible leak),
// built by ballot prefix counts in row order, and the rows' period,
// power and fft. Frames arrive in chunks of F frames by cp.async into a
// two-stage ring, so a chunk loads while the one before runs; F falls to
// one frame as J grows, and where even one frame's candidates do not fit
// in shared memory (J past ~8,000) the kernel reads them from global
// memory instead (kStaged false). Only the first NR * 32 unmatched
// candidates are kept: no more rows can be dead. Each phase keeps the
// plain version's tie rule:
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

// Frames per stage and the dynamic shared memory: per stage F * J
// period, power and fft words and the valid bytes as whole words.
__host__ __device__ inline int frames_per_stage(int J) {
  const int f = kStageBytes / (13 * J);
  return f < 1 ? 1 : (f > kMaxFrames ? kMaxFrames : f);
}
__host__ __device__ inline int valid_words(int F, int J) { return (F * J + 7) / 4 + 1; }
__host__ __device__ inline int stage_words(int F, int J) { return 3 * F * J + valid_words(F, J); }
inline size_t dynamic_smem(int J) {
  const int F = frames_per_stage(J);
  return (size_t)(2 * stage_words(F, J)) * 4;
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

// A bit mask over the slots a lane sees: 32 (NS = 1) or 64 (NS = 2).
template <int NS> struct SlotMask { using T = unsigned; };
template <> struct SlotMask<2> { using T = unsigned long long; };
__device__ __forceinline__ int first_bit(unsigned m) { return __ffs(m) - 1; }
__device__ __forceinline__ int first_bit(unsigned long long m) { return __ffsll(m) - 1; }

// ---- the sequential matcher (mode kSeq) ----

// A frame's candidates (staged or in global memory) and the constants of
// its steps.
struct SeqFrame {
  const float* cp;
  const float* cw;
  const int32_t* cf;
  const uint8_t* cv;
  int J, C, lane;
  bool fast;
  float tol;
};

// The next candidate, read a step ahead.
struct SeqCand {
  float p, pw;
  int fi;
  bool valid;
};

// A lane's rows lane + 32 i, i < NR, by reference to the kernel's arrays.
template <int NR> struct Rows {
  float (&per)[NR];
  float (&pw)[NR];
  int (&fi)[NR];
  int (&bi)[NR];
  int (&uid)[NR];
  bool (&al)[NR];
  bool (&seen)[NR];
  const bool (&ex)[NR];
};

// The candidate steps from candidate j on over the first U slots of rows
// (rows lane + 32 i, i < U), where every alive row lies, so that every
// row past them is dead and the first of those, row 32 U, is the first
// dead row where the U slots hold none. Each step is the plain version's
// (`analyze/trackers.py::_sequential_match_update`): the eligible rows'
// costs (match_cost_fast; match_cost where that is not sure), the warp's
// least by one redux.sync, the least uid among the rows of that cost by a
// second (the plain version's first argmin over uid, kImax where not
// tied), the first row holding it or, unmatched, the first dead row, by
// ballots in row order; the lane that owns the row updates it at once.
// The step is branch-free but for that division. Returns the next
// candidate: J, or, where a candidate took row 32 U, the one after it,
// with nu = U + 1.
template <int NR, int U>
__device__ __forceinline__ int seq_run(const SeqFrame& fr, int j, SeqCand& nx, Rows<NR>& r,
                                       int& next_uid, int& nu) {
  constexpr int UP = U < NR ? U + 1 : NR;   // the slots a step may touch
  for (; j < fr.J; ++j) {
    const SeqCand c = nx;
    const int jn = j + 1 < fr.J ? j + 1 : j;
    nx = SeqCand{fr.cp[jn], fr.cw[jn], fr.cf[jn], fr.cv[jn] != 0};
    if (!(c.valid & (c.p > 0.f))) continue;   // the same in every lane: nothing changes
    const bool p_fast = fr.fast & in_range(c.p);
    unsigned cb[U];
    bool uns[U];
    bool any_uns = false;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const bool el = r.ex[i] & r.al[i] & (r.bi[i] == 0);
      bool u = !(p_fast & in_range(r.per[i]));
      const float cost = match_cost_fast(c.p, r.per[i], fr.tol, u);
      uns[i] = el & u;
      any_uns |= uns[i];
      cb[i] = __float_as_uint(el ? cost : kBig);   // costs >= 0: their bits order as they do
    }
    if (any_uns) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (uns[i]) cb[i] = __float_as_uint(match_cost(c.p, r.per[i], fr.tol));
      }
    }
    unsigned lmin = cb[0];
#pragma unroll
    for (int i = 1; i < U; ++i) lmin = min(lmin, cb[i]);
    const unsigned least = __reduce_min_sync(kFull, lmin);
    const bool matched = __uint_as_float(least) < kBig;
    int val[U];
#pragma unroll
    for (int i = 0; i < U; ++i) val[i] = cb[i] == least ? r.uid[i] : kImax;
    int lu = val[0];
#pragma unroll
    for (int i = 1; i < U; ++i) lu = min(lu, val[i]);
    const int least_uid = matched ? __reduce_min_sync(kFull, lu) : 0;
    unsigned row_m = 0;
    int row_i = -1;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const bool take = matched ? (val[i] == least_uid) : !r.al[i];
      const unsigned m = __ballot_sync(kFull, r.ex[i] & take);
      row_i = (row_m == 0) & (m != 0) ? i : row_i;
      row_m = row_m == 0 ? m : row_m;
    }
    if ((row_m == 0) & (!matched | (least_uid == kImax)) & (U < NR) & (32 * U < fr.C)) {
      row_i = U;   // row 32 U, in lane 0
      row_m = 1u;
    }
    const bool owner = fr.lane == __ffs(row_m) - 1;   // none where row_m is 0
    const bool made = (row_m != 0) & !matched;
#pragma unroll
    for (int i = 0; i < UP; ++i) {
      const bool mine = owner & (i == row_i);
      r.per[i] = mine ? c.p : r.per[i];
      r.pw[i] = mine ? c.pw : r.pw[i];
      r.fi[i] = mine ? c.fi : r.fi[i];
      r.seen[i] |= mine;
      r.bi[i] = mine ? 0 : r.bi[i];
      r.uid[i] = mine & made ? next_uid : r.uid[i];
      r.al[i] |= mine & made;
    }
    next_uid += made ? 1 : 0;
    if (row_i == U) {
      nu = U + 1;
      return j + 1;
    }
  }
  return fr.J;
}

// NR capacity rows a lane (row lane + 32 i), NS slots a lane (slot
// lane + 32 u); kStaged: frames through the shared-memory ring, or read
// from global memory where one frame's candidates do not fit in it.
template <int NR, int NS, bool kStaged, bool kSeq>
__global__ void __launch_bounds__(32) tracker_kernel(Inputs in, State init, bool has_init,
                                                     Outputs out, State fin, Params prm) {
  constexpr int kRows = 32 * NR, kSlots = 32 * NS;
  using Mask = typename SlotMask<NS>::T;
  // rows other lanes read, and the compact row lists, in row order
  __shared__ float r_per[kRows], r_pw[kRows];
  __shared__ int32_t r_fft[kRows];
  __shared__ int32_t e_row[kRows];                    // eligible for matching
  __shared__ __align__(16) float e_per[kRows + 4];   // padded with 0 to a multiple of 4
  __shared__ int4 f_list[kRows];   // fillable: power bits, uid, row
  __shared__ int4 l_list[kRows];   // may leak: period bits, power bits, uid, row
  // per row, its least candidate: cost bits << 32 | j (all ones: none)
  __shared__ unsigned long long r_win[kRows];
  // the first unmatched candidates: only as many as there are dead rows
  // are ever taken
  __shared__ int32_t u_j[kRows];
  // per slot: its uid, the lowest alive row holding it (kRows: none), and
  // the uid and row that fill it
  __shared__ int32_t s_su[kSlots], s_row[kSlots], fill_uid[kSlots], fill_row[kSlots];
  extern __shared__ uint32_t smem[];
  const int J = prm.J, C = prm.C, S = prm.S, T = prm.T, F = kStaged ? prm.F : T;
  const bool fast = prm.tol >= 1e-3f && prm.tol <= 1e6f;
  uint32_t* ring = smem;                              // two stages
  const int ring_step = kStaged ? stage_words(F, J) : 0;

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  int rr[NR];
  bool ex[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    rr[i] = lane + 32 * i;
    ex[i] = rr[i] < C;
  }

  // ---- state ----
  float per[NR], pw[NR];
  int fi[NR], bi[NR], uid[NR];
  bool al[NR], seen[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    per[i] = 0.f; pw[i] = 0.f; fi[i] = 0; bi[i] = 0; uid[i] = 0;
    al[i] = false; seen[i] = false;
  }
  int next_uid = 1;
  int su[NS], luid[NS], lbars[NS];   // slot lane + 32 u (< S)
  bool lact[NS], sl[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    su[u] = 0; luid[u] = 0; lbars[u] = 0; lact[u] = false;
    sl[u] = lane + 32 * u < S;
  }
  if (has_init) {
    const long long c0 = (long long)b * C;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (ex[i]) {
        per[i] = init.period[c0 + rr[i]]; pw[i] = init.power[c0 + rr[i]];
        fi[i] = init.fft[c0 + rr[i]]; al[i] = init.alive[c0 + rr[i]] != 0;
        bi[i] = init.bars_inactive[c0 + rr[i]]; uid[i] = init.uid[c0 + rr[i]];
      }
    }
    next_uid = init.next_uid[b];
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      if (sl[u]) {
        const long long s0 = (long long)b * S + lane + 32 * u;
        su[u] = init.slot_uid[s0]; lact[u] = init.leak_active[s0] != 0;
        luid[u] = init.leak_uid[s0]; lbars[u] = init.leak_bars[s0];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    s_su[lane + 32 * u] = su[u];
    s_row[lane + 32 * u] = kRows;
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) r_win[rr[i]] = ~0ull;

  const long long sym0 = (long long)b * T * J;
  const int n_chunks = (T + F - 1) / F;
  if (kStaged) {
    Stage(ring, F, J).load(in, sym0, min(F, T) * J, lane);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * F, nf = min(F, T - t0);
    const float* c_per = in.period + sym0 + (long long)t0 * J;
    const float* c_pw = in.power + sym0 + (long long)t0 * J;
    const int32_t* c_fft = in.fft + sym0 + (long long)t0 * J;
    const uint8_t* c_valid = in.valid + sym0 + (long long)t0 * J;
    if (kStaged) {
      if (ch + 1 < n_chunks) {
        Stage(ring + ((ch + 1) & 1) * ring_step, F, J)
            .load(in, sym0 + (long long)(t0 + F) * J, min(F, T - t0 - F) * J, lane);
      }
      cp_async_commit();
      cp_async_wait_prev();
      __syncwarp();
      const Stage stg(ring + (ch & 1) * ring_step, F, J);
      c_per = stg.per;
      c_pw = stg.pw;
      c_fft = stg.fft;
      c_valid = stg.valid_bytes(in, sym0 + (long long)t0 * J);
    }

    for (int f = 0; f < nf; ++f) {
      const int t = t0 + f;
      const long long fj = static_cast<long long>(f) * J;
      const float* cp = c_per + fj;
      const float* cw = c_pw + fj;
      const int32_t* cf = c_fft + fj;
      const uint8_t* cv = c_valid + fj;

      if constexpr (kSeq) {
        // ---- the reference-exact matcher: the candidates in order, each
        // on the rows as the frame's earlier candidates left them, over
        // the first nu slots of rows (every alive row lies there) ----
        int nu = 1;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          seen[i] = false;
          nu = __any_sync(kFull, al[i]) ? i + 1 : nu;
        }
        SeqCand nx{cp[0], cw[0], cf[0], cv[0] != 0};
        Rows<NR> rows{per, pw, fi, bi, uid, al, seen, ex};
        const SeqFrame fr{cp, cw, cf, cv, J, C, lane, fast, prm.tol};
        int j = 0;
        while (j < J) {   // nu grows where a candidate takes the first row past them
          switch (nu) {
            case 1: j = seq_run<NR, 1>(fr, j, nx, rows, next_uid, nu); break;
            case 2: j = seq_run<NR, 2>(fr, j, nx, rows, next_uid, nu); break;
            case 3: if constexpr (NR >= 4) j = seq_run<NR, 3>(fr, j, nx, rows, next_uid, nu); break;
            case 4: if constexpr (NR >= 4) j = seq_run<NR, 4>(fr, j, nx, rows, next_uid, nu); break;
            case 5: if constexpr (NR >= 8) j = seq_run<NR, 5>(fr, j, nx, rows, next_uid, nu); break;
            case 6: if constexpr (NR >= 8) j = seq_run<NR, 6>(fr, j, nx, rows, next_uid, nu); break;
            case 7: if constexpr (NR >= 8) j = seq_run<NR, 7>(fr, j, nx, rows, next_uid, nu); break;
            default: if constexpr (NR >= 8) j = seq_run<NR, 8>(fr, j, nx, rows, next_uid, nu); break;
          }
        }
      } else {
        // ---- eligible rows, in row order ----
        bool el[NR];
        int n_elig = 0;
        bool rows_ok = true;
  #pragma unroll
        for (int i = 0; i < NR; ++i) {
          el[i] = ex[i] & al[i] & (bi[i] == 0);
          const unsigned em = __ballot_sync(kFull, el[i]);
          if (el[i]) {
            const int k = n_elig + __popc(em & lt);
            e_row[k] = rr[i];
            e_per[k] = per[i];
          }
          n_elig += __popc(em);
          rows_ok &= !el[i] | in_range(per[i]);
        }
        if (lane < 4) e_per[n_elig + lane] = 0.f;   // costs kBig
        const bool rows_fast = fast & (__all_sync(kFull, rows_ok) != 0);
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
          const int pos = n_unm + __popc(um & lt);
          if (unm & (pos < kRows)) u_j[pos] = j;
          n_unm += __popc(um);
        }
        __syncwarp();
  #pragma unroll
        for (int i = 0; i < NR; ++i) {
          const unsigned long long w = r_win[rr[i]];
          r_win[rr[i]] = ~0ull;
          const int wj = w == ~0ull ? -1 : static_cast<int>(w & 0xffffffffu);
          seen[i] = wj >= 0;
          if (seen[i]) { per[i] = cp[wj]; pw[i] = cw[wj]; fi[i] = cf[wj]; }
        }

        // ---- the nth unmatched candidate takes the nth dead row ----
        int n_dead = 0;
  #pragma unroll
        for (int i = 0; i < NR; ++i) {
          const bool dead = ex[i] & !al[i];
          const unsigned dm = __ballot_sync(kFull, dead);
          const int rank = n_dead + __popc(dm & lt);
          if (dead & (rank < n_unm)) {
            const int jj = u_j[rank];
            per[i] = cp[jj]; pw[i] = cw[jj]; fi[i] = cf[jj];
            uid[i] = next_uid + rank; seen[i] = true; al[i] = true;
          }
          n_dead += __popc(dm);
        }
        next_uid += min(n_dead, n_unm);
      }

      // ---- deactivate unseen; kill after max_inactive ----
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        bi[i] = seen[i] ? 0 : bi[i] + 1;
        if (al[i] & !seen[i] & (bi[i] >= prm.max_inactive)) al[i] = false;
      }

      // publish the rows, and the rows that may leak, in row order
      int n_leak = 0;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (ex[i]) { r_per[rr[i]] = per[i]; r_pw[rr[i]] = pw[i]; r_fft[rr[i]] = fi[i]; }
        const bool lk = ex[i] & al[i] & seen[i] & (bi[i] <= prm.leak_min);
        const unsigned lm = __ballot_sync(kFull, lk);
        if (lk) {
          l_list[n_leak + __popc(lm & lt)] =
              make_int4(__float_as_int(per[i]), __float_as_int(pw[i]), uid[i], rr[i]);
        }
        n_leak += __popc(lm);
      }

      // ---- stable slots: keep by uid while alive (lowest row) ----
      bool live[NR], used[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        live[i] = ex[i] & al[i];
        Mask km = 0;   // the slots holding the row's uid
#pragma unroll 4
        for (int s = 0; s < S; ++s) {
          const int sus = s_su[s];
          km |= (live[i] & (sus > 0) & (uid[i] == sus)) ? Mask(1) << s : Mask(0);
        }
        used[i] = km != 0;
        for (Mask m = km; m; m &= m - 1) atomicMin(&s_row[first_bit(m)], rr[i]);
      }
      __syncwarp();
      int my_row[NS];
      bool is_free[NS];
      unsigned free_m[NS];
      int n_free = 0;
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        my_row[u] = s_row[lane + 32 * u];
        s_row[lane + 32 * u] = kRows;
        my_row[u] = my_row[u] < kRows ? my_row[u] : -1;
        is_free[u] = sl[u] & (my_row[u] < 0);
        if (is_free[u]) su[u] = 0;
        free_m[u] = __ballot_sync(kFull, is_free[u]);
        n_free += __popc(free_m[u]);
      }

      // ---- fill free slots by rank (power desc, uid asc, row asc) ----
      if (n_free) {
        bool fl[NR];
        int n_fill = 0;
        bool any_fl = false;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          fl[i] = live[i] & !used[i] & (pw[i] > 0.f);
          const unsigned fm = __ballot_sync(kFull, fl[i]);
          if (fl[i]) f_list[n_fill + __popc(fm & lt)] = make_int4(__float_as_int(pw[i]), uid[i], rr[i], 0);
          n_fill += __popc(fm);
          any_fl |= fl[i];
        }
        __syncwarp();
        if (any_fl) {
          int ahead[NR];
#pragma unroll
          for (int i = 0; i < NR; ++i) ahead[i] = 0;
#pragma unroll 4
          for (int k = 0; k < n_fill; ++k) {
            const int4 e = f_list[k];
            const float p = __int_as_float(e.x);
            const int uu = e.y, row = e.z;
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              ahead[i] += (p > pw[i]) | ((p == pw[i]) & ((uu < uid[i]) | ((uu == uid[i]) & (row < rr[i]))));
            }
          }
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            if (fl[i] & (ahead[i] < n_free)) { fill_uid[ahead[i]] = uid[i]; fill_row[ahead[i]] = rr[i]; }
          }
        }
        __syncwarp();
        int before = 0;
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          const int fr = before + __popc(free_m[u] & lt);
          if (is_free[u] & (fr < n_fill)) { su[u] = fill_uid[fr]; my_row[u] = fill_row[fr]; }
          before += __popc(free_m[u]);
        }
      }
      __syncwarp();

#pragma unroll
      for (int u = 0; u < NS; ++u) {
        const bool sv = sl[u] & (su[u] > 0);
        const float slot_p = sv ? r_per[my_row[u]] : 0.f;
        const float slot_pw = sv ? r_pw[my_row[u]] : 0.f;
        const int slot_fi = sv ? r_fft[my_row[u]] : 0;

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
            acc[0].scan(e0, p_lim, w_lim, su[u]);
            acc[1].scan(e1, p_lim, w_lim, su[u]);
            acc[2].scan(e2, p_lim, w_lim, su[u]);
            acc[3].scan(e3, p_lim, w_lim, su[u]);
          }
          for (; k < n_leak; ++k) acc[0].scan(l_list[k], p_lim, w_lim, su[u]);
          acc[0].merge(acc[1]);
          acc[2].merge(acc[3]);
          acc[0].merge(acc[2]);
        }
        const float best = acc[0].power;
        const int best_uid = acc[0].uid, best_row = acc[0].row;
        const bool found = best > 0.f;
        if (sl[u]) {
          int bars = lact[u] ? lbars[u] + 1 : 0;
          const bool was = lact[u] & !(bars > prm.leak_max);
          const bool same = was & found & (luid[u] == best_uid);
          lbars[u] = same ? bars : (found ? 1 : 0);
          lact[u] = found;
          luid[u] = found ? best_uid : 0;

          const long long o = ((long long)b * T + t) * S + lane + 32 * u;
          out.slot_period[o] = slot_p;
          out.slot_power[o] = slot_pw;
          out.slot_fft[o] = slot_fi;
          out.slot_valid[o] = sv;
          out.slot_uid[o] = su[u];
          out.leak_active[o] = found;
          out.leak_uid[o] = luid[u];
          const int lrow = found ? best_row : 0;
          out.leak_period[o] = found ? r_per[lrow] : 0.f;
          out.leak_power[o] = found ? r_pw[lrow] : 0.f;
          out.leak_fft[o] = found ? r_fft[lrow] : 0;
          out.leak_bars[o] = found ? lbars[u] : 0;
          s_su[lane + 32 * u] = su[u];
        }
      }
      __syncwarp();
    }
  }

  // ---- final state ----
  const long long c0 = (long long)b * C;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (ex[i]) {
      const long long o = c0 + rr[i];
      fin.period[o] = per[i]; fin.power[o] = pw[i]; fin.fft[o] = fi[i];
      fin.alive[o] = al[i]; fin.seen[o] = seen[i];
      fin.bars_inactive[o] = bi[i]; fin.uid[o] = uid[i];
    }
  }
  if (lane == 0) fin.next_uid[b] = next_uid;
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    if (sl[u]) {
      const long long s0 = (long long)b * S + lane + 32 * u;
      fin.slot_uid[s0] = su[u]; fin.leak_active[s0] = lact[u];
      fin.leak_uid[s0] = luid[u]; fin.leak_bars[s0] = lbars[u];
    }
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

template <int NR, int NS, bool kStaged, bool kSeq>
int launch(const Inputs& ins, const State& st0, bool has_init, const Outputs& o,
           const State& fin, const Params& prm, int B, size_t smem, cudaStream_t stream) {
  auto kernel = tracker_kernel<NR, NS, kStaged, kSeq>;
  // the dynamic size, with the static arrays, may pass the default 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 32, smem, stream>>>(ins, st0, has_init, o, fin, prm);
  return static_cast<int>(cudaGetLastError());
}

template <int NR, int NS>
int launch_mode(bool staged, bool seq, const Inputs& ins, const State& st0, bool has_init,
                const Outputs& o, const State& fin, const Params& prm, int B,
                size_t smem, cudaStream_t stream) {
  if (seq) {
    return staged ? launch<NR, NS, true, true>(ins, st0, has_init, o, fin, prm, B, smem, stream)
                  : launch<NR, NS, false, true>(ins, st0, has_init, o, fin, prm, B, 0, stream);
  }
  return staged ? launch<NR, NS, true, false>(ins, st0, has_init, o, fin, prm, B, smem, stream)
                : launch<NR, NS, false, false>(ins, st0, has_init, o, fin, prm, B, 0, stream);
}

}  // namespace

// Rows a lane for capacity C (2, 4 or 8; 0 past 256), slots a lane for
// S (1 or 2; 0 past 64), and whether a stage of frames (at least one)
// fits in `smem_optin` bytes of dynamic shared memory next to the static
// arrays, with its size.
extern "C" void tracker_plan(int J, int C, int S, int smem_optin, int* nr, int* ns,
                             int* staged, long long* smem) {
  *nr = C <= 64 ? 2 : (C <= 128 ? 4 : (C <= 256 ? 8 : 0));
  *ns = S <= 32 ? 1 : (S <= 64 ? 2 : 0);
  // static arrays: 16 words a row (8 words, two int4) and 4 words a slot
  const long long fixed = 4LL * (16 * 32 * *nr + 4) + 16LL * 32 * *ns;
  *smem = static_cast<long long>(dynamic_smem(J));
  *staged = fixed + *smem <= smem_optin;
}

// in: 4 pointers (period, power, fft, valid). init: 12 pointers in
// TrackerState order (seen_now unused), or null for a fresh start.
// out: 11 pointers in the order of Outputs. fin: 12 pointers in
// TrackerState order. `sequential`: the reference-exact matcher (kSeq),
// else the vectorized one. Returns a cudaError_t code: a shared-memory
// size the card cannot give, or a refused launch, is returned, never
// skipped.
extern "C" int tracker_launch(void* const* in, void* const* init,
                              void* const* out, void* const* fin, int sequential, int B,
                              int T, int J, int C, int S, float tol,
                              int max_inactive, float leak_pr, float leak_wr,
                              int leak_min, int leak_max, void* stream) {
  if (C < 1 || S < 1 || J < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int nr, ns, staged;
  long long smem;
  tracker_plan(J, C, S, optin, &nr, &ns, &staged, &smem);
  if (nr == 0 || ns == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
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
  const State fn = state_from(fin);
  const bool hi = init != nullptr, sq = sequential != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  switch (nr * 10 + ns) {
    case 21: return launch_mode<2, 1>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, st);
    case 22: return launch_mode<2, 2>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, st);
    case 41: return launch_mode<4, 1>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, st);
    case 42: return launch_mode<4, 2>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, st);
    case 81: return launch_mode<8, 1>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, st);
    default: return launch_mode<8, 2>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, st);
  }
}
