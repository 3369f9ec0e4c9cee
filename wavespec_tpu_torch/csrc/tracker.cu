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
// step for step, with its tie rules). Through a frame's steps each lane
// keeps, for its row slots in use, each row's period where it is eligible
// (else 0) and its uid in registers: all of them in the register
// geometry, the first kSeqRegSlots (384 rows) in the memory geometry,
// whose region holds the rest (read only once more slots are in use);
// the row a step writes records the candidate in `touch`, and the rest of
// its state (power, fft index, seen, bars inactive, alive) is taken from
// those records at the frame's end. A frame dispatches once to a step
// specialised to the slots in use (`seq_fast<U>`). A step is one
// redux.sync of the least cost and a ballot that finds the lane holding
// it; the lane that owns the row writes it at once. Its chain is cut
// short: the next candidate's costs are computed while the reduction
// runs and the written row's is patched after (the cost of the two
// candidates' periods), the tolerance test is decided without its
// division on the ratio of the periods (`seq_bounds`: four products a
// candidate, two compares a row), and the common step has one
// warp-uniform branch, to the rare step (ties, a test not sure, a
// candidate not valid, a row made past U), which takes the plain
// version's rule in full. Frames where an eligible uid may be 2^31 - 1,
// or with more slots in use than the registers hold, take `seq_general`
// (each step over every slot in use, the least uid by a second redux and
// a least uid of 2^31 - 1 taking row 0, as the plain version's first
// argmin does), and are counted (`general_frames`). Deactivation, slots
// and leaks are the vectorized mode's.
//
// What bounds it: each frame reads 4 * J candidate words and writes
// 11 * S words per symbol, a few hundred bytes, and does a few thousand
// compares. The frames of one symbol form a dependent chain, so the time
// is T times the latency of one frame's steps, not bandwidth or
// arithmetic: 1024 symbols (8 warps an SM) take about as long as 128.
// A warp reduction is five dependent shuffles; one per candidate, slot
// fill and slot leak search made a frame ~16 us on the H100, so none is
// left on the chain (~3.4 us a frame) but the sequential mode's (one a
// candidate, and a ballot).
//
// Design: one warp per symbol (one block of 32 threads), the frame loop
// inside the kernel, no warp reduction on the chain. Two geometries:
// - registers: lane l owns capacity rows l, l + 32, ... (NR rows a lane:
//   2 for C <= 64, 4 to 128, 8 to 256) in registers, and slots l, l + 32
//   (NS: 1 for S <= 32, 2 to 64), and publishes what other lanes read
//   into static shared memory;
// - memory (kMem; past 256 rows or 64 slots): the same steps over
//   ceil(C / 32) rows and ceil(S / 32) slots a lane, with every row's and
//   slot's state in one region, in dynamic shared memory where it fits
//   next to the candidate ring, else a region of the caller's global
//   scratch for each symbol. No capacity and no slot count is refused.
// Lists of the rows each phase may take (eligible, fillable, possible
// leak) are built by ballot prefix counts in row order. Frames arrive in
// chunks of F frames by cp.async into a two-stage ring, so a chunk loads
// while the one before runs; F falls to one frame as J grows, and where
// even one frame's candidates do not fit in shared memory (J past ~8,000)
// the kernel reads them from global memory instead (kStaged false). Only
// the first 32 * NR unmatched candidates are kept: no more rows can be
// dead. Each phase keeps the plain version's tie rule:
// - matching: lane j scans the eligible rows in order, keeping the first
//   row of least cost (`_first_argmin`; two running minima over
//   alternate rows, joined by (cost, row)), with the tolerance test
//   decided without its division wherever that is exact
//   (`match_cost_fast`); each matched candidate lowers its row's
//   (cost, j) by a 64-bit atomicMin, so a row keeps the first candidate
//   of least cost; J > 32 runs in chunks of 32 candidates;
// - the nth unmatched candidate takes the nth dead row (ballot prefix);
// - slot keep: each row finds the slots holding its uid; each slot takes
//   the lowest such row by an atomicMin;
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
constexpr unsigned kBigBits = 0x7149f2cau;   // kBig's bits
constexpr int kImax = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFrames = 16;          // frames a stage holds at most
constexpr int kStageBytes = 24 * 1024;  // staging budget per stage, sets F
constexpr unsigned long long kNone = ~0ull;

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

// nr, ns: rows and slots a lane of the memory geometry; region_bytes: its
// region a symbol; region_shared: the region lies in dynamic shared
// memory (before the ring), else in the global scratch.
// q_fast, q_in, q_out: the sequential matcher's tolerance test without
// its division (`seq_bounds`); general_frames: its count of frames whose
// steps took seq_general.
struct Params {
  int T, J, C, S, F;
  float tol, leak_pr, leak_wr;
  int max_inactive, leak_min, leak_max;
  int nr, ns, region_shared;
  long long region_bytes;
  int q_fast;
  float q_in_lo, q_in_hi, q_out_lo, q_out_hi;
  int32_t* general_frames;   // gains the frames that took seq_general, or null
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

// The memory geometry's region for cp = 32 * nr rows and sp = 32 * ns
// slots, carved in this order (16-byte items first).
__host__ __device__ inline long long region_bytes(long long cp, long long sp) {
  const long long bytes = (16 + 16 + 8) * cp + 4 * (cp + 4) + 11 * 4 * cp + 3 * cp + 8 * 4 * sp + sp;
  return (bytes + 15) & ~15LL;
}

// Every array the phases share between lanes: static shared arrays in the
// register geometry, the region in the memory geometry (where the row
// state lies too: r_per, r_pw, r_fft are then the rows themselves).
struct Lists {
  int4* f_list;   // fillable: power bits, uid, row
  int4* l_list;   // may leak: period bits, power bits, uid, row
  unsigned long long* r_win;   // per row: least candidate, cost bits << 32 | j
  float* e_per;   // eligible rows: period (padded by 4); kSeq: per row, its period if eligible, else 0
  int32_t* e_row;
  float* r_per;   // the rows other lanes read
  float* r_pw;
  int32_t* r_fft;
  int32_t* u_j;   // the first unmatched candidates
  int32_t* d_row; // dead rows at the frame's start (kSeq)
  int32_t* s_su;  // per slot: its uid, its lowest alive row, the fill
  int32_t* s_row;
  int32_t* fill_uid;
  int32_t* fill_row;
};

// The memory geometry's row and slot state, in the region after the
// Lists arrays.
struct MemState {
  int32_t *bi, *uid;
  int32_t *su, *luid, *lbars, *my_row;
  uint8_t *al, *seen, *used, *lact;
};

__device__ inline void carve(uint8_t* base, int cp, int sp, Lists& l, MemState& m) {
  uint8_t* q = base;
  auto take = [&](long long bytes) { uint8_t* r = q; q += bytes; return r; };
  l.f_list = reinterpret_cast<int4*>(take(16LL * cp));
  l.l_list = reinterpret_cast<int4*>(take(16LL * cp));
  l.r_win = reinterpret_cast<unsigned long long*>(take(8LL * cp));
  l.e_per = reinterpret_cast<float*>(take(4LL * (cp + 4)));
  l.r_per = reinterpret_cast<float*>(take(4LL * cp));
  l.r_pw = reinterpret_cast<float*>(take(4LL * cp));
  l.r_fft = reinterpret_cast<int32_t*>(take(4LL * cp));
  l.e_row = reinterpret_cast<int32_t*>(take(4LL * cp));
  l.u_j = reinterpret_cast<int32_t*>(take(4LL * cp));
  l.d_row = reinterpret_cast<int32_t*>(take(4LL * cp));
  m.bi = reinterpret_cast<int32_t*>(take(4LL * cp));
  m.uid = reinterpret_cast<int32_t*>(take(4LL * cp));
  l.s_su = reinterpret_cast<int32_t*>(take(4LL * sp));
  l.s_row = reinterpret_cast<int32_t*>(take(4LL * sp));
  l.fill_uid = reinterpret_cast<int32_t*>(take(4LL * sp));
  l.fill_row = reinterpret_cast<int32_t*>(take(4LL * sp));
  m.su = reinterpret_cast<int32_t*>(take(4LL * sp));
  m.luid = reinterpret_cast<int32_t*>(take(4LL * sp));
  m.lbars = reinterpret_cast<int32_t*>(take(4LL * sp));
  m.my_row = reinterpret_cast<int32_t*>(take(4LL * sp));
  m.al = take(cp);
  m.seen = take(cp);
  m.used = take(cp);
  m.lact = take(sp);
}

// A lane's share of a per-row or per-slot array: N entries in registers
// (entry i is row or slot lane + 32 i), or, in the memory geometry, a
// pointer to the lane's first entry with a stride of 32.
template <typename T, int N, bool kMem> struct LaneArr {
  T v[N];
  __device__ __forceinline__ T& operator[](int i) { return v[i]; }
};
template <typename T, int N> struct LaneArr<T, N, true> {
  T* p;
  __device__ __forceinline__ T& operator[](int i) const { return p[32 * i]; }
};

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

// Cycle counts of a candidate step's sections (see `seq_fast`), for
// `b4s_compare.py --probe`, which builds this file with -DTRACKER_PROBE:
// each lane keeps them in registers and lane 0 of block 0 stores them
// once, at the end. In every other build the marks compile to nothing.
#ifdef TRACKER_PROBE
constexpr int kProbeSections = 14;
__device__ unsigned long long g_probe[kProbeSections + 1];
struct Probe {
  unsigned long long acc[kProbeSections] = {};
  unsigned long long steps = 0;
  long long last = 0;
  __device__ __forceinline__ void start() { last = clock64(); }
  // the cycles since the last mark go to section k; `v` is waited on first
  __device__ __forceinline__ void mark(int k, unsigned v = 0u) {
    unsigned z;
    asm volatile("and.b32 %0, %1, 0;" : "=r"(z) : "r"(v));
    const long long t = clock64();
    acc[k] += static_cast<unsigned long long>(t - last) + z;
    last = t;
  }
  __device__ __forceinline__ void step() { ++steps; }
  __device__ __forceinline__ void store(int b, int lane) const {
    if ((b == 0) & (lane == 0)) {
#pragma unroll
      for (int k = 0; k < kProbeSections; ++k) g_probe[k] = acc[k];
      g_probe[kProbeSections] = steps;
    }
  }
};
#else
struct Probe {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int, unsigned = 0u) {}
  __device__ __forceinline__ void step() {}
  __device__ __forceinline__ void store(int, int) const {}
};
#endif

// ---- the sequential matcher (mode kSeq) ----

// kSeqRegSlots: the row slots a lane that the sequential matcher keeps in
// registers through a frame's steps in the memory geometry (rows lane +
// 32 i, i < kSeqRegSlots); slots past them stay in the region.
constexpr int kSeqRegSlots = 12;

// A frame's candidates (staged or in global memory), its dead rows and
// the constants of its steps. The dead rows at the frame's start, in row
// order: d_row[0, n_dead), then every row from dead_from to C - 1.
struct SeqFrame {
  const float* cp;
  const uint8_t* cv;
  int32_t* touch;        // per row: the last candidate that touched it this frame, else -1
  const int32_t* d_row;
  int J, C, n_dead, dead_from, lane;
  bool fast;             // the test without division may be sure (Params::q_fast)
  float tol, q_in_lo, q_in_hi, q_out_lo, q_out_hi;
};

// Where a frame's steps stand: the current candidate (j, its period p;
// j == J past the last valid one) and the next valid one (jn, pn), the
// rows made so far, the next dead row (nd; -1 where none is left) and the
// next uid.
struct SeqState {
  int j, jn;
  float p, pn;
  int n_made, nd, next_uid;
};

__device__ __forceinline__ bool seq_ok(const SeqFrame& fr, int k) {
  return (fr.cv[k] != 0) & (fr.cp[k] > 0.f);
}
// the first valid candidate from k on, J where none is
__device__ __forceinline__ int seq_next(const SeqFrame& fr, int k) {
  while (k < fr.J && !seq_ok(fr, k)) ++k;
  return k;
}
// *p = v where c, by a predicated store (no branch)
__device__ __forceinline__ void store_if(int32_t* p, int32_t v, bool c) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.s32 [%0], %1;\n}"
               :: "l"(p), "r"(v), "r"(static_cast<int>(c)) : "memory");
}
// the next candidate becomes the current one; the one after it is
// candidate jq (period pq) where that is valid (ok_q), else the next
// valid one past it
__device__ __forceinline__ void seq_advance(const SeqFrame& fr, SeqState& s, int jq, float pq,
                                            bool ok_q) {
  s.j = s.jn;
  s.p = s.pn;
  s.jn = ok_q ? jq : seq_next(fr, min(jq, fr.J));
  s.pn = ok_q ? pq : (s.jn < fr.J ? fr.cp[s.jn] : 0.f);
}
// the k-th dead row of the frame's start, -1 where there is none
__device__ __forceinline__ int seq_dead(const SeqFrame& fr, int k) {
  const int implicit = fr.dead_from + k - fr.n_dead;
  const int listed = fr.d_row[min(k, max(fr.n_dead - 1, 0))];
  return k < fr.n_dead ? listed : (implicit < fr.C ? implicit : -1);
}

// A row's cost bits against candidate period p (match_cost_fast; a row
// not eligible has period 0, a cost of kBig); `uns` is set where the test
// is not sure for an eligible row. seq_general's.
__device__ __forceinline__ unsigned fast_cost_bits(float p, float e, float tol, bool p_fast,
                                                   bool& uns) {
  bool u = !(p_fast & in_range(e));
  const float cost = match_cost_fast(p, e, tol, u);
  uns |= u & (e > 0.f);
  return __float_as_uint(cost);   // costs >= 0: their bits order as they do
}

// The tolerance test of seq_fast without its division, on the ratio q =
// e / p of a row's eligible period e to the candidate's p. The plain
// version's pct = |p - e| / (0.5 (p + e)) * 100 is 200 |1 - q| / (1 + q)
// in real numbers, at most P exactly for q in [a(P), 1 / a(P)], a(P) =
// (200 - P) / (200 + P); in float32 it is within 5 * 2^-24 of that
// (relative) for p in [1e-20, 1e20], any e > 0 and tol <= 100. So a row
// lies surely within tol where e is in [p q_in_lo, p q_in_hi] (the bounds
// of P = tol (1 - 2^-20), tightened by 2^-20 more), surely beyond it
// where e < p q_out_lo or e > p q_out_hi (those of tol (1 + 2^-20),
// widened by 2^-20), and the test is not sure between (match_cost
// decides). A period of 0 (a row not eligible) lies beyond. The host
// derives the four constants (`tracker_launch`) where tol is in [1e-3,
// 100] (q_fast); elsewhere, or for p outside [1e-20, 1e20], no row is
// sure.
struct SeqBounds {
  float in_lo, in_hi, out_lo, out_hi;
};
__device__ __forceinline__ SeqBounds seq_bounds(const SeqFrame& fr, float p) {
  const bool ok = fr.fast & in_range(p);
  return SeqBounds{ok ? p * fr.q_in_lo : INFINITY, ok ? p * fr.q_in_hi : -INFINITY,
                   ok ? p * fr.q_out_lo : -INFINITY, ok ? p * fr.q_out_hi : INFINITY};
}
__device__ __forceinline__ unsigned seq_cost_bits(float p, float e, const SeqBounds& q, bool& uns) {
  const bool in = (e >= q.in_lo) & (e <= q.in_hi);
  const bool out = (e < q.out_lo) | (e > q.out_hi);
  uns |= !(in | out);
  return in ? (__float_as_uint(p - e) & 0x7fffffffu) : kBigBits;   // |p - e|, as fabsf
}

// The costs of candidate period p on the first U slots of eligible
// periods `ep`; returns whether any was not sure (then seq_costs_exact).
template <int U, int NR>
__device__ __forceinline__ bool seq_costs(const SeqFrame& fr, float p, const float (&ep)[NR],
                                          unsigned (&cb)[U]) {
  const SeqBounds q = seq_bounds(fr, p);
  bool uns = false;
#pragma unroll
  for (int i = 0; i < U; ++i) cb[i] = seq_cost_bits(p, ep[i], q, uns);
  return uns;
}
template <int U, int NR>
__device__ __forceinline__ void seq_costs_exact(const SeqFrame& fr, float p, const float (&ep)[NR],
                                                unsigned (&cb)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) cb[i] = __float_as_uint(match_cost(p, ep[i], fr.tol));
}

// Row s.nd takes candidate s.j as a made row, past the slots a step
// walks (in registers below NR, else in the region's `r_ep`), and the
// steps go on from the next candidate.
template <bool kMem, int NR>
__device__ __forceinline__ void seq_make(const SeqFrame& fr, SeqState& s, float (&ep)[NR],
                                         int (&uid)[NR], float* r_ep, int32_t* r_uid) {
  const int row = s.nd, slot = row >> 5;
  const bool own = fr.lane == (row & 31);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const bool w = own & (slot == i);
    ep[i] = w ? s.p : ep[i];
    uid[i] = w ? s.next_uid : uid[i];
  }
  if (own) {
    if constexpr (kMem) {
      if (slot >= NR) {
        r_ep[32 * slot] = s.p;
        r_uid[32 * slot] = s.next_uid;
      }
    }
    fr.touch[row] = s.j;
  }
  s.next_uid += 1;
  s.n_made += 1;
  s.nd = seq_dead(fr, s.n_made);
  const int jq = min(s.jn + 1, fr.J);
  seq_advance(fr, s, jq, jq < fr.J ? fr.cp[jq] : 0.f, (jq < fr.J) && seq_ok(fr, jq));
}

// Where the least cost is not held by one lane's one row: the least uid
// among the rows of that cost, then the first row holding it (rows in
// order: slot, then lane). Returns this lane's slot to write, -1 for none.
template <int U, int NR>
__device__ __forceinline__ int seq_tie(unsigned hit, const int (&uid)[NR], int lane) {
  int lu = kImax;
#pragma unroll
  for (int i = 0; i < U; ++i) lu = ((hit >> i) & 1u) ? min(lu, uid[i]) : lu;
  const int least_uid = __reduce_min_sync(kFull, lu);
  int slot = -1;
  unsigned found = 0;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const unsigned m = __ballot_sync(kFull, ((hit >> i) & 1u) & (uid[i] == least_uid));
    slot = (found == 0) & (m != 0) & (lane == __ffs(m) - 1) ? i : slot;
    found |= m;
  }
  return slot;
}

// A step's write: the lane that owns the row (`slot` >= 0) sets its
// eligible period to p, its uid where the row is `made`, and its cost
// against the next candidate to `cw`; and records the candidate.
template <int U, int NR>
__device__ __forceinline__ void seq_write(const SeqFrame& fr, const SeqState& s, int slot,
                                          bool made, unsigned cw, float (&ep)[NR],
                                          int (&uid)[NR], unsigned (&cbn)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const bool w = slot == i;
    ep[i] = w ? s.p : ep[i];
    uid[i] = w & made ? s.next_uid : uid[i];
    cbn[i] = w ? cw : cbn[i];
  }
  store_if(fr.touch + fr.lane + 32 * slot, s.j, slot >= 0);
}

// The candidate steps of a frame over the first U row slots (rows
// lane + 32 i, i < U, where every alive row lies), in registers, in a
// frame where every step is sure (no eligible row's uid is 2^31 - 1, and
// none made can be). Each step is the plain version's
// (`analyze/trackers.py::_sequential_match_update`): the eligible rows'
// least cost by one redux.sync, then the row holding it: where one lane
// holds it in one slot (two ballots say so), that row; else the least
// uid among the rows of that cost by a second redux.sync and the first
// row holding it by a ballot a slot (`seq_tie`); unmatched, the first
// dead row. The lane that owns the row writes it at once (its eligible
// period and, made, its uid) and records the candidate in `touch`.
// The chain is cut short: the reduction is issued first, and while it
// runs the next candidate's costs are computed on the rows as they stand
// (the one row the step writes is patched after: its cost against the
// next candidate is that of the two candidates' periods) and the
// candidate after the next is read (used a step later). The common step
// has no branch but the loop's and one, warp-uniform, to the rare step (a
// tie, a cost not sure without the division, a candidate not valid, a
// row made past U). Returns -1 at the frame's end, or the slot past U of
// a row that a candidate is to make (s unchanged: the caller makes it,
// `seq_make`, and goes on with more slots).
template <int U, int NR>
__device__ __forceinline__ int seq_fast(const SeqFrame& fr, SeqState& s, float (&ep)[NR],
                                        int (&uid)[NR], Probe& pb) {
  unsigned cb[U];
  if (seq_costs<U>(fr, s.p, ep, cb)) seq_costs_exact<U>(fr, s.p, ep, cb);
  // the candidate after the next (index s.jn + 1), read a step ahead
  int kq = min(s.jn + 1, fr.J - 1);
  float pq = fr.cp[kq];
  bool vq = fr.cv[kq] != 0;
  while (s.j < fr.J) {
    pb.step();
    unsigned lmin = cb[0];
#pragma unroll
    for (int i = 1; i < U; ++i) lmin = min(lmin, cb[i]);
    pb.mark(2, lmin);
    const unsigned least = __reduce_min_sync(kFull, lmin);
    // while it runs: the candidate after that, the dead row after the
    // next, and the next candidate's costs
    const int k2 = min(s.jn + 2, fr.J - 1);
    const float p2 = fr.cp[k2];
    const bool v2 = fr.cv[k2] != 0;
    const int nd_next = seq_dead(fr, s.n_made + 1);
    unsigned cbn[U];
    const SeqBounds qn = seq_bounds(fr, s.pn);
    bool unsn = false, unw = false;
#pragma unroll
    for (int i = 0; i < U; ++i) cbn[i] = seq_cost_bits(s.pn, ep[i], qn, unsn);
    const unsigned cw = seq_cost_bits(s.pn, s.p, qn, unw);
    const bool ok_q = (s.jn + 1 < fr.J) & vq & (pq > 0.f);
    pb.mark(3, least);
    const bool matched = __uint_as_float(least) < kBig;
    unsigned hit = 0;
#pragma unroll
    for (int i = 0; i < U; ++i) hit |= matched & (cb[i] == least) ? 1u << i : 0u;
    const unsigned hm = __ballot_sync(kFull, hit != 0);
    const unsigned rare_m = __ballot_sync(kFull, ((hit & (hit - 1)) != 0) | unsn);
    const bool made = !matched & (s.nd >= 0);
    const int ds = s.nd >> 5;
    pb.mark(6, hm ^ rare_m);
    if (((hm & (hm - 1)) != 0) | (rare_m != 0) | unw | !ok_q | (made & (ds >= U))) {
      // the rare step
      if (made & (ds >= U)) return ds;
      const int slot = matched ? seq_tie<U>(hit, uid, fr.lane)
                               : (made & (fr.lane == (s.nd & 31)) ? ds : -1);
      seq_write<U>(fr, s, slot, made, cw, ep, uid, cbn);
      // where a cost was not sure, all of them again by division, on the
      // rows as written (the written row's included)
      if (unsn | unw) seq_costs_exact<U>(fr, s.pn, ep, cbn);
      s.next_uid += made ? 1 : 0;
      s.n_made += made ? 1 : 0;
      s.nd = made ? nd_next : s.nd;
      seq_advance(fr, s, s.jn + 1, pq, ok_q);
      kq = min(s.jn + 1, fr.J - 1);
      pq = fr.cp[kq];
      vq = fr.cv[kq] != 0;
    } else {
      // one lane holds the least cost in one slot, or no row does (made
      // or dropped)
      const int slot = matched ? __ffs(hit) - 1 : (made & (fr.lane == (s.nd & 31)) ? ds : -1);
      seq_write<U>(fr, s, slot, made, cw, ep, uid, cbn);
      s.next_uid += made ? 1 : 0;
      s.n_made += made ? 1 : 0;
      s.nd = made ? nd_next : s.nd;
      s.j = s.jn;
      s.p = s.pn;
      s.jn += 1;
      s.pn = pq;
      pq = p2;
      vq = v2;
    }
    pb.mark(7, cbn[0]);
#pragma unroll
    for (int i = 0; i < U; ++i) cb[i] = cbn[i];
  }
  return -1;
}

// A lane's running least (cost, uid) over its row slots, the first slot
// on ties.
struct RowLeast {
  unsigned cost = kBigBits;
  int uid = kImax, slot = 0;
  __device__ __forceinline__ void take(unsigned c, int u, int i) {
    const bool less = (c < cost) | ((c == cost) & (u < uid));
    cost = less ? c : cost;
    uid = less ? u : uid;
    slot = less ? i : slot;
  }
};

// The candidate steps of the rest of a frame where seq_fast cannot take
// them: the memory geometry's slots past NR in use (the first NR in
// registers, the rest in the region's `r_ep`, `r_uid`, walked in a loop),
// or a frame that is not sure. Each step is the plain version's in full:
// each lane's first slot of least (cost, uid); the warp's least cost by
// one redux.sync and the least uid among the lanes of that cost by a
// second; a least uid of 2^31 - 1 takes row 0, as the plain version's
// first argmin does (row 0 is then eligible after only if alive:
// `row0_dead`, dead at the frame's start, and not made since); else the
// lane holding both owns the row (where two lanes do, a third redux takes
// the first row). Unmatched, a valid candidate takes the first dead row,
// or is dropped.
template <int NR, bool kMem>
__device__ __forceinline__ void seq_general(const SeqFrame& fr, SeqState& s, float (&ep)[NR],
                                            int (&uid)[NR], int& nu, float* r_ep, int32_t* r_uid,
                                            bool row0_dead, Probe& pb) {
  while (s.j < fr.J) {
    pb.step();
    const int jq = s.jn + 1;
    const int kq = min(jq, fr.J - 1);
    const float pq = fr.cp[kq];
    const bool ok_q = (jq < fr.J) & (fr.cv[kq] != 0) & (pq > 0.f);
    const float p = s.p;
    const bool pf = fr.fast & in_range(p);
    RowLeast lst;
    bool uns = false;
#pragma unroll
    for (int i = 0; i < NR; ++i) lst.take(fast_cost_bits(p, ep[i], fr.tol, pf, uns), uid[i], i);
    if constexpr (kMem) {
      for (int i = NR; i < nu; ++i) {
        lst.take(fast_cost_bits(p, r_ep[32 * i], fr.tol, pf, uns), r_uid[32 * i], i);
      }
    }
    if (uns) {
      lst = RowLeast{};
#pragma unroll
      for (int i = 0; i < NR; ++i) lst.take(__float_as_uint(match_cost(p, ep[i], fr.tol)), uid[i], i);
      if constexpr (kMem) {
        for (int i = NR; i < nu; ++i) {
          lst.take(__float_as_uint(match_cost(p, r_ep[32 * i], fr.tol)), r_uid[32 * i], i);
        }
      }
    }
    pb.mark(9, lst.cost);
    const unsigned least = __reduce_min_sync(kFull, lst.cost);
    pb.mark(3, least);
    int slot = -1;   // the slot this lane writes
    bool made = false, alive = true;
    if (__uint_as_float(least) < kBig) {
      const int lu = lst.cost == least ? lst.uid : kImax;
      pb.mark(4, lu);
      const int least_uid = __reduce_min_sync(kFull, lu);
      pb.mark(5, least_uid);
      if (least_uid == kImax) {
        slot = fr.lane == 0 ? 0 : -1;
        alive = !row0_dead | (s.n_made > 0);
      } else {
        const bool h = (lst.cost == least) & (lst.uid == least_uid);
        const unsigned hm = __ballot_sync(kFull, h);
        slot = h ? lst.slot : -1;
        if (hm & (hm - 1)) {
          const unsigned first = __reduce_min_sync(kFull, h ? 32u * lst.slot + fr.lane : ~0u);
          slot = fr.lane == static_cast<int>(first & 31u) ? static_cast<int>(first >> 5) : -1;
        }
      }
    } else if (s.nd >= 0) {
      made = true;
      slot = fr.lane == (s.nd & 31) ? s.nd >> 5 : -1;
      nu = max(nu, (s.nd >> 5) + 1);
    } else {   // no dead row left: dropped, as in the plain version
      seq_advance(fr, s, jq, pq, ok_q);
      continue;
    }
    pb.mark(6, slot);
    const float e = alive ? p : 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const bool w = slot == i;
      ep[i] = w ? e : ep[i];
      uid[i] = w & made ? s.next_uid : uid[i];
    }
    if (slot >= 0) {
      if constexpr (kMem) {
        if (slot >= NR) {
          r_ep[32 * slot] = e;
          if (made) r_uid[32 * slot] = s.next_uid;
        }
      }
      fr.touch[fr.lane + 32 * slot] = s.j;
    }
    if (made) {
      s.next_uid += 1;
      s.n_made += 1;
      s.nd = seq_dead(fr, s.n_made);
    }
    pb.mark(7);
    seq_advance(fr, s, jq, pq, ok_q);
    pb.mark(0, s.jn);
  }
}

// NR capacity rows a lane (row lane + 32 i), NS slots a lane (slot
// lane + 32 u), in registers; kMem: prm.nr rows and prm.ns slots a lane
// in the memory region instead (NR, NS unused). kStaged: frames through
// the shared-memory ring, or read from global memory where one frame's
// candidates do not fit in it. kSeq: the sequential matcher.
template <int NR, int NS, bool kStaged, bool kSeq, bool kMem>
__global__ void __launch_bounds__(32, 1) tracker_kernel(Inputs in, State init, bool has_init,
                                                     Outputs out, State fin, Params prm,
                                                     uint8_t* scratch) {
  constexpr int kRows = kMem ? 1 : 32 * NR, kSlots = kMem ? 1 : 32 * NS;
  using Mask = typename SlotMask<NS>::T;
  // the register geometry's shared arrays (see Lists)
  __shared__ __align__(16) int4 sh_f_list[kRows], sh_l_list[kRows];
  __shared__ unsigned long long sh_r_win[kRows];
  __shared__ __align__(16) float sh_e_per[kRows + 4];
  __shared__ float sh_r_per[kRows], sh_r_pw[kRows];
  __shared__ int32_t sh_r_fft[kRows], sh_e_row[kRows], sh_u_j[kRows];
  __shared__ int32_t sh_d_row[1];   // (the memory geometry's)
  __shared__ int32_t sh_s_su[kSlots], sh_s_row[kSlots], sh_fill_uid[kSlots], sh_fill_row[kSlots];
  extern __shared__ __align__(16) uint32_t smem[];
  const int J = prm.J, C = prm.C, S = prm.S, T = prm.T, F = kStaged ? prm.F : T;
  const int nr = kMem ? prm.nr : NR, ns = kMem ? prm.ns : NS;
  const int none_row = 32 * nr;   // s_row's "no row"
  const bool fast = prm.tol >= 1e-3f && prm.tol <= 1e6f;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;

  Lists l;
  MemState m;
  uint32_t* ring = smem;   // two stages
  if constexpr (kMem) {
    uint8_t* base = prm.region_shared ? reinterpret_cast<uint8_t*>(smem)
                                      : scratch + static_cast<long long>(b) * prm.region_bytes;
    carve(base, 32 * nr, 32 * ns, l, m);
    if (prm.region_shared) ring = smem + prm.region_bytes / 4;
  } else {
    l = Lists{sh_f_list, sh_l_list, sh_r_win, sh_e_per, sh_e_row, sh_r_per, sh_r_pw, sh_r_fft,
              sh_u_j, sh_d_row, sh_s_su, sh_s_row, sh_fill_uid, sh_fill_row};
  }
  const int ring_step = kStaged ? stage_words(F, J) : 0;
  Probe pb;
  pb.start();

  // ---- state: rows lane + 32 i, slots lane + 32 u ----
  LaneArr<float, NR, kMem> per, pw;
  LaneArr<int, NR, kMem> fi, bi, uid;
  LaneArr<bool, NR, kMem> al, seen, used;
  LaneArr<int, NS, kMem> su, luid, lbars, my_row;
  LaneArr<bool, NS, kMem> lact;
  if constexpr (kMem) {
    per.p = l.r_per + lane; pw.p = l.r_pw + lane; fi.p = l.r_fft + lane;
    bi.p = m.bi + lane; uid.p = m.uid + lane;
    al.p = reinterpret_cast<bool*>(m.al) + lane; seen.p = reinterpret_cast<bool*>(m.seen) + lane;
    used.p = reinterpret_cast<bool*>(m.used) + lane;
    su.p = m.su + lane; luid.p = m.luid + lane; lbars.p = m.lbars + lane;
    my_row.p = m.my_row + lane; lact.p = reinterpret_cast<bool*>(m.lact) + lane;
  }
#pragma unroll
  for (int i = 0; i < nr; ++i) {
    per[i] = 0.f; pw[i] = 0.f; fi[i] = 0; bi[i] = 0; uid[i] = 0;
    al[i] = false; seen[i] = false;
  }
  int next_uid = 1;
#pragma unroll
  for (int u = 0; u < ns; ++u) {
    su[u] = 0; luid[u] = 0; lbars[u] = 0; lact[u] = false;
  }
  if (has_init) {
    const long long c0 = (long long)b * C;
#pragma unroll
    for (int i = 0; i < nr; ++i) {
      const int row = lane + 32 * i;
      if (row < C) {
        per[i] = init.period[c0 + row]; pw[i] = init.power[c0 + row];
        fi[i] = init.fft[c0 + row]; al[i] = init.alive[c0 + row] != 0;
        bi[i] = init.bars_inactive[c0 + row]; uid[i] = init.uid[c0 + row];
      }
    }
    next_uid = init.next_uid[b];
#pragma unroll
    for (int u = 0; u < ns; ++u) {
      if (lane + 32 * u < S) {
        const long long s0 = (long long)b * S + lane + 32 * u;
        su[u] = init.slot_uid[s0]; lact[u] = init.leak_active[s0] != 0;
        luid[u] = init.leak_uid[s0]; lbars[u] = init.leak_bars[s0];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < ns; ++u) {
    l.s_su[lane + 32 * u] = su[u];
    l.s_row[lane + 32 * u] = none_row;
  }
  // kSeq: no row touched; every row's eligible period 0 in the region;
  // uid_max: an alive row's uid is 2^31 - 1 (the frames are then not
  // sure); nu_alive: the slots that may hold an alive row
  bool uid_max = false;
  int nu_alive = 0, n_general = 0;
#pragma unroll
  for (int i = 0; i < nr; ++i) {
    l.r_win[lane + 32 * i] = kNone;
    if constexpr (kSeq) {
      l.e_row[lane + 32 * i] = -1;
      if constexpr (kMem) l.e_per[lane + 32 * i] = 0.f;
      uid_max |= al[i] & (uid[i] == kImax);
      nu_alive = __any_sync(kFull, al[i]) ? i + 1 : nu_alive;
    }
  }
  if constexpr (kSeq) uid_max = __any_sync(kFull, uid_max) != 0;
  __syncwarp();

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
        pb.mark(10);   // the frame before: slots, leaks
        // ---- the reference-exact matcher: the candidates in order, each
        // on the rows as the frame's earlier candidates left them. At the
        // frame's start, over the slots that may hold an alive row (all of
        // them in registers; in the region the first nu_alive): each row's
        // period where it is eligible (else 0, a cost of kBig), the first
        // NR slots in registers and the rest in the region; the dead rows
        // in row order (every row past those slots is dead); the slots in
        // use (every alive row lies in them) ----
        const int nw = kMem ? nu_alive : NR;
        float ep[NR];
        int ur[NR];
        int n_dead = 0, nu = 0;
        int32_t* d_row = kMem ? l.d_row : l.u_j;
        float* r_ep = kMem ? l.e_per + lane : nullptr;
        int32_t* r_uid = kMem ? m.uid + lane : nullptr;
        auto start_row = [&](int i) {
          const int row = lane + 32 * i;
          const bool ex = row < C;
          const bool a = ex & al[i];
          const float e = a & (bi[i] == 0) ? per[i] : 0.f;
          const unsigned dm = __ballot_sync(kFull, ex & !a);
          if (ex & !a) d_row[n_dead + __popc(dm & lt)] = row;
          n_dead += __popc(dm);
          nu = __any_sync(kFull, a) ? i + 1 : nu;
          return e;
        };
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          ep[i] = 0.f;
          ur[i] = 0;
          if (i < nw) {
            ep[i] = start_row(i);
            ur[i] = uid[i];
          }
        }
        if constexpr (kMem) {
          for (int i = NR; i < nw; ++i) r_ep[32 * i] = start_row(i);
        }
        // sure: no step can meet a least uid of 2^31 - 1 (seq_fast)
        const bool sure = !uid_max & (next_uid <= kImax - J);
        const bool row0_dead = __shfl_sync(kFull, static_cast<int>(!al[0]), 0) != 0;
        __syncwarp();
        const SeqFrame fr{cp, cv, l.e_row, d_row, J, C, n_dead, 32 * nw, lane, prm.q_fast != 0,
                          prm.tol, prm.q_in_lo, prm.q_in_hi, prm.q_out_lo, prm.q_out_hi};
        SeqState s;
        s.j = seq_next(fr, 0);
        s.p = s.j < J ? cp[s.j] : 0.f;
        s.jn = seq_next(fr, min(s.j + 1, J));
        s.pn = s.jn < J ? cp[s.jn] : 0.f;
        s.n_made = 0;
        s.nd = seq_dead(fr, 0);
        s.next_uid = next_uid;
        nu = max(nu, 1);   // the steps walk one slot at least
        pb.mark(11, nu);
        while (s.j < J) {
          int grow = -1;
          if (sure & (nu <= NR)) {
            switch (nu) {   // a step specialised to the slots in use
              case 1: grow = seq_fast<1>(fr, s, ep, ur, pb); break;
              case 2: if constexpr (NR >= 2) grow = seq_fast<2>(fr, s, ep, ur, pb); break;
              case 3: if constexpr (NR >= 3) grow = seq_fast<3>(fr, s, ep, ur, pb); break;
              case 4: if constexpr (NR >= 4) grow = seq_fast<4>(fr, s, ep, ur, pb); break;
              case 5: if constexpr (NR >= 5) grow = seq_fast<5>(fr, s, ep, ur, pb); break;
              case 6: if constexpr (NR >= 6) grow = seq_fast<6>(fr, s, ep, ur, pb); break;
              case 7: if constexpr (NR >= 7) grow = seq_fast<7>(fr, s, ep, ur, pb); break;
              case 8: if constexpr (NR >= 8) grow = seq_fast<8>(fr, s, ep, ur, pb); break;
              case 9: if constexpr (NR >= 9) grow = seq_fast<9>(fr, s, ep, ur, pb); break;
              case 10: if constexpr (NR >= 10) grow = seq_fast<10>(fr, s, ep, ur, pb); break;
              case 11: if constexpr (NR >= 11) grow = seq_fast<11>(fr, s, ep, ur, pb); break;
              default: if constexpr (NR >= 12) grow = seq_fast<12>(fr, s, ep, ur, pb); break;
            }
          } else {
            seq_general<NR, kMem>(fr, s, ep, ur, nu, r_ep, r_uid, row0_dead, pb);
            ++n_general;
          }
          if (grow >= 0) {
            seq_make<kMem>(fr, s, ep, ur, r_ep, r_uid);
            nu = grow + 1;
          }
        }
        next_uid = s.next_uid;
        // ---- over the slots in use now: each row touched takes its last
        // candidate; the rows made (the first n_made dead rows) come
        // alive, with their uids ----
        __syncwarp();
        int n_dead2 = 0;
        auto end_row = [&](int i, int u_reg, bool in_reg) {
          const int row = lane + 32 * i;
          const bool ex = row < C;
          const bool dead = ex & !al[i];
          const unsigned dm = __ballot_sync(kFull, dead);
          const bool made = dead & (n_dead2 + __popc(dm & lt) < s.n_made);
          n_dead2 += __popc(dm);
          const int t = ex ? l.e_row[row] : -1;
          seen[i] = t >= 0;
          if (t >= 0) {
            per[i] = cp[t];
            pw[i] = cw[t];
            fi[i] = cf[t];
            bi[i] = 0;
            l.e_row[row] = -1;
          }
          if (made) {
            al[i] = true;
            if (in_reg) uid[i] = u_reg;
          }
        };
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i < nu) end_row(i, ur[i], true);
        }
        if constexpr (kMem) {
          for (int i = NR; i < nu; ++i) end_row(i, 0, false);
          nu_alive = nu;
        }
        __syncwarp();
      } else {
        // ---- eligible rows, in row order ----
        int n_elig = 0;
        bool rows_ok = true;
  #pragma unroll
        for (int i = 0; i < nr; ++i) {
          const int row = lane + 32 * i;
          const bool el = (row < C) & al[i] & (bi[i] == 0);
          const unsigned em = __ballot_sync(kFull, el);
          if (el) {
            const int k = n_elig + __popc(em & lt);
            l.e_row[k] = row;
            l.e_per[k] = per[i];
          }
          n_elig += __popc(em);
          rows_ok &= !el | in_range(per[i]);
        }
        if (lane < 4) l.e_per[n_elig + lane] = 0.f;   // cost kBig
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
                const float4* e4 = reinterpret_cast<const float4*>(l.e_per);
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
                  const float c = match_cost(p, l.e_per[k], prm.tol);
                  bk = c < bc ? k : bk;
                  bc = fminf(c, bc);
                }
              }
            }
          }
          const bool matched = bc < kBig;
          if (matched) {
            atomicMin(&l.r_win[l.e_row[bk]],
                      (static_cast<unsigned long long>(__float_as_uint(bc)) << 32) | unsigned(j));
          }
          const bool unm = p_ok & !matched;
          const unsigned um = __ballot_sync(kFull, unm);
          const int pos = n_unm + __popc(um & lt);
          if (unm & (pos < 32 * nr)) l.u_j[pos] = j;
          n_unm += __popc(um);
        }
        __syncwarp();
  #pragma unroll
        for (int i = 0; i < nr; ++i) {
          const int row = lane + 32 * i;
          const unsigned long long w = l.r_win[row];
          l.r_win[row] = kNone;
          const int wj = w == kNone ? -1 : static_cast<int>(w & 0xffffffffu);
          seen[i] = wj >= 0;
          if (wj >= 0) { per[i] = cp[wj]; pw[i] = cw[wj]; fi[i] = cf[wj]; }
        }

        // ---- the nth unmatched candidate takes the nth dead row ----
        int n_dead_v = 0;
  #pragma unroll
        for (int i = 0; i < nr; ++i) {
          const bool dead = (lane + 32 * i < C) & !al[i];
          const unsigned dm = __ballot_sync(kFull, dead);
          const int rank = n_dead_v + __popc(dm & lt);
          if (dead & (rank < n_unm)) {
            const int jj = l.u_j[rank];
            per[i] = cp[jj]; pw[i] = cw[jj]; fi[i] = cf[jj];
            uid[i] = next_uid + rank; seen[i] = true; al[i] = true;
          }
          n_dead_v += __popc(dm);
        }
        next_uid += min(n_dead_v, n_unm);
      }

      // ---- deactivate unseen; kill after max_inactive ----
#pragma unroll
      for (int i = 0; i < nr; ++i) {
        const bool s_ = seen[i];
        const int b_ = s_ ? 0 : bi[i] + 1;
        bi[i] = b_;
        if (al[i] & !s_ & (b_ >= prm.max_inactive)) al[i] = false;
      }

      // publish the rows, and the rows that may leak, in row order
      int n_leak = 0;
#pragma unroll
      for (int i = 0; i < nr; ++i) {
        const int row = lane + 32 * i;
        const bool ex = row < C;
        if constexpr (!kMem) {
          if (ex) { l.r_per[row] = per[i]; l.r_pw[row] = pw[i]; l.r_fft[row] = fi[i]; }
        }
        const bool lk = ex & al[i] & seen[i] & (bi[i] <= prm.leak_min);
        const unsigned lm = __ballot_sync(kFull, lk);
        if (lk) {
          l.l_list[n_leak + __popc(lm & lt)] =
              make_int4(__float_as_int(per[i]), __float_as_int(pw[i]), uid[i], row);
        }
        n_leak += __popc(lm);
      }
      __syncwarp();

      // ---- stable slots: keep by uid while alive (lowest row) ----
#pragma unroll
      for (int i = 0; i < nr; ++i) {
        const int row = lane + 32 * i;
        const bool live = (row < C) & al[i];
        if constexpr (kMem) {
          bool u_ = false;
          if (live) {
            const int my_uid = uid[i];
            for (int s = 0; s < S; ++s) {
              const int sus = l.s_su[s];
              if ((sus > 0) & (my_uid == sus)) { atomicMin(&l.s_row[s], row); u_ = true; }
            }
          }
          used[i] = u_;
        } else {
          Mask km = 0;   // the slots holding the row's uid
#pragma unroll 4
          for (int s = 0; s < S; ++s) {
            const int sus = l.s_su[s];
            km |= (live & (sus > 0) & (uid[i] == sus)) ? Mask(1) << s : Mask(0);
          }
          used[i] = km != 0;
          for (Mask mm = km; mm; mm &= mm - 1) atomicMin(&l.s_row[first_bit(mm)], row);
        }
      }
      __syncwarp();
      int n_free = 0;
#pragma unroll
      for (int u = 0; u < ns; ++u) {
        const int sl = lane + 32 * u;
        int r_ = l.s_row[sl];
        l.s_row[sl] = none_row;
        r_ = r_ < none_row ? r_ : -1;
        my_row[u] = r_;
        const bool is_free = (sl < S) & (r_ < 0);
        if (is_free) su[u] = 0;
        n_free += __popc(__ballot_sync(kFull, is_free));
      }

      // ---- fill free slots by rank (power desc, uid asc, row asc) ----
      if (n_free) {
        int n_fill = 0;
        bool any_fl = false;
#pragma unroll
        for (int i = 0; i < nr; ++i) {
          const int row = lane + 32 * i;
          const bool fl = (row < C) & al[i] & !used[i] & (pw[i] > 0.f);
          const unsigned fm = __ballot_sync(kFull, fl);
          if (fl) l.f_list[n_fill + __popc(fm & lt)] = make_int4(__float_as_int(pw[i]), uid[i], row, 0);
          n_fill += __popc(fm);
          any_fl |= fl;
        }
        __syncwarp();
        if (any_fl) {
          if constexpr (kMem) {
            for (int i = 0; i < nr; ++i) {
              const int row = lane + 32 * i;
              if (!((row < C) & al[i] & !used[i] & (pw[i] > 0.f))) continue;
              const float pwi = pw[i];
              const int ui = uid[i];
              int ahead = 0;
              for (int k = 0; k < n_fill; ++k) {
                const int4 e = l.f_list[k];
                const float p = __int_as_float(e.x);
                ahead += (p > pwi) | ((p == pwi) & ((e.y < ui) | ((e.y == ui) & (e.z < row))));
              }
              if (ahead < n_free) { l.fill_uid[ahead] = ui; l.fill_row[ahead] = row; }
            }
          } else {
            bool fl[NR];
            int ahead[NR];
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              fl[i] = (lane + 32 * i < C) & al[i] & !used[i] & (pw[i] > 0.f);
              ahead[i] = 0;
            }
#pragma unroll 4
            for (int k = 0; k < n_fill; ++k) {
              const int4 e = l.f_list[k];
              const float p = __int_as_float(e.x);
              const int uu = e.y, row = e.z;
#pragma unroll
              for (int i = 0; i < NR; ++i) {
                ahead[i] += (p > pw[i]) | ((p == pw[i]) & ((uu < uid[i]) | ((uu == uid[i]) & (row < lane + 32 * i))));
              }
            }
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              if (fl[i] & (ahead[i] < n_free)) { l.fill_uid[ahead[i]] = uid[i]; l.fill_row[ahead[i]] = lane + 32 * i; }
            }
          }
        }
        __syncwarp();
        int before = 0;
#pragma unroll
        for (int u = 0; u < ns; ++u) {
          const bool is_free = (lane + 32 * u < S) & (my_row[u] < 0);
          const unsigned free_m = __ballot_sync(kFull, is_free);
          const int fr = before + __popc(free_m & lt);
          if (is_free & (fr < n_fill)) { su[u] = l.fill_uid[fr]; my_row[u] = l.fill_row[fr]; }
          before += __popc(free_m);
        }
      }
      __syncwarp();

      const int uid0 = __shfl_sync(kFull, uid[0], 0);   // row 0's
#pragma unroll
      for (int u = 0; u < ns; ++u) {
        const bool slot_ok = lane + 32 * u < S;
        const int sus = su[u];
        const bool sv = slot_ok & (sus > 0);
        const int mr = my_row[u];
        const float slot_p = sv ? l.r_per[mr] : 0.f;
        const float slot_pw = sv ? l.r_pw[mr] : 0.f;
        const int slot_fi = sv ? l.r_fft[mr] : 0;

        // ---- leakage: per slot the strongest intruder (smallest uid) ----
        // four scans, of the list entries 4m + i, each keeping the first
        // row of the largest (power, -uid); then the largest of the four in
        // (power, -uid, -row)
        Leak acc[4];
        if (sv) {
          const float p_lim = slot_p * prm.leak_pr, w_lim = slot_pw * prm.leak_wr;
          int k = 0;
          for (; k + 4 <= n_leak; k += 4) {
            const int4 e0 = l.l_list[k], e1 = l.l_list[k + 1], e2 = l.l_list[k + 2], e3 = l.l_list[k + 3];
            acc[0].scan(e0, p_lim, w_lim, sus);
            acc[1].scan(e1, p_lim, w_lim, sus);
            acc[2].scan(e2, p_lim, w_lim, sus);
            acc[3].scan(e3, p_lim, w_lim, sus);
          }
          for (; k < n_leak; ++k) acc[0].scan(l.l_list[k], p_lim, w_lim, sus);
          acc[0].merge(acc[1]);
          acc[2].merge(acc[3]);
          acc[0].merge(acc[2]);
        }
        const float best = acc[0].power;
        // a least uid of 2^31 - 1 takes row 0, as the plain version's first argmin does
        const bool to_row0 = acc[0].uid == kImax;
        const int best_uid = to_row0 ? uid0 : acc[0].uid, best_row = to_row0 ? 0 : acc[0].row;
        const bool found = best > 0.f;
        if (slot_ok) {
          const bool la = lact[u];
          const int bars = la ? lbars[u] + 1 : 0;
          const bool was = la & !(bars > prm.leak_max);
          const bool same = was & found & (luid[u] == best_uid);
          const int nb = same ? bars : (found ? 1 : 0);
          lbars[u] = nb;
          lact[u] = found;
          const int lu = found ? best_uid : 0;
          luid[u] = lu;

          const long long o = ((long long)b * T + t) * S + lane + 32 * u;
          out.slot_period[o] = slot_p;
          out.slot_power[o] = slot_pw;
          out.slot_fft[o] = slot_fi;
          out.slot_valid[o] = sv;
          out.slot_uid[o] = sus;
          out.leak_active[o] = found;
          out.leak_uid[o] = lu;
          const int lrow = found ? best_row : 0;
          out.leak_period[o] = found ? l.r_per[lrow] : 0.f;
          out.leak_power[o] = found ? l.r_pw[lrow] : 0.f;
          out.leak_fft[o] = found ? l.r_fft[lrow] : 0;
          out.leak_bars[o] = found ? nb : 0;
          l.s_su[lane + 32 * u] = sus;
        }
      }
      __syncwarp();
    }
  }

  // ---- final state ----
  const long long c0 = (long long)b * C;
#pragma unroll
  for (int i = 0; i < nr; ++i) {
    const int row = lane + 32 * i;
    if (row < C) {
      const long long o = c0 + row;
      fin.period[o] = per[i]; fin.power[o] = pw[i]; fin.fft[o] = fi[i];
      fin.alive[o] = al[i]; fin.seen[o] = seen[i];
      fin.bars_inactive[o] = bi[i]; fin.uid[o] = uid[i];
    }
  }
  if (lane == 0) fin.next_uid[b] = next_uid;
  if ((lane == 0) & (n_general > 0) & (prm.general_frames != nullptr)) {
    atomicAdd(prm.general_frames, n_general);
  }
  pb.store(b, lane);
#pragma unroll
  for (int u = 0; u < ns; ++u) {
    if (lane + 32 * u < S) {
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

template <int NR, int NS, bool kStaged, bool kSeq, bool kMem>
int launch(const Inputs& ins, const State& st0, bool has_init, const Outputs& o,
           const State& fin, const Params& prm, int B, size_t smem, uint8_t* scratch,
           cudaStream_t stream) {
  auto kernel = tracker_kernel<NR, NS, kStaged, kSeq, kMem>;
  // the dynamic size, with the static arrays, may pass the default 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 32, smem, stream>>>(ins, st0, has_init, o, fin, prm, scratch);
  return static_cast<int>(cudaGetLastError());
}

// one mode (kSeq) of one geometry, staged or not
template <int NR, int NS, bool kSeq, bool kMem>
int launch_mode(bool staged, const Inputs& ins, const State& st0, bool has_init,
                const Outputs& o, const State& fin, const Params& prm, int B,
                size_t smem, uint8_t* scratch, cudaStream_t stream) {
  return staged ? launch<NR, NS, true, kSeq, kMem>(ins, st0, has_init, o, fin, prm, B, smem, scratch, stream)
                : launch<NR, NS, false, kSeq, kMem>(ins, st0, has_init, o, fin, prm, B, smem, scratch, stream);
}

// both modes of a register geometry
template <int NR, int NS>
int launch_regs(bool staged, bool seq, const Inputs& ins, const State& st0, bool has_init,
                const Outputs& o, const State& fin, const Params& prm, int B,
                size_t smem, uint8_t* scratch, cudaStream_t stream) {
  return seq ? launch_mode<NR, NS, true, false>(staged, ins, st0, has_init, o, fin, prm, B, smem, scratch, stream)
             : launch_mode<NR, NS, false, false>(staged, ins, st0, has_init, o, fin, prm, B, smem, scratch, stream);
}

// the register geometry's static shared bytes: 16 words a row and 4 a
// slot, and a few words of the memory geometry's arrays
long long static_smem(int nr, int ns) {
  return 4LL * (16 * 32 * nr + 16) + 16LL * 32 * ns;
}

// the current device's shared memory a block, opted in
int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

}  // namespace

#ifdef TRACKER_PROBE
// The probe's section cycles and its step count, of the last launch.
extern "C" int tracker_probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));
}
#endif

// The kernel's geometry at J candidates, capacity C and S slots on a card
// with `smem_optin` bytes of shared memory a block: rows and slots a lane
// (`nr`, `ns`), where they lie (`memory`: 0 registers for C <= 256 and
// S <= 64; past either, 1 a region in dynamic shared memory, 2 a region
// of global scratch a symbol, `region` bytes), whether a stage of frames
// (at least one) fits in shared memory beside them (`staged`), and the
// dynamic shared bytes (`smem`).
extern "C" void tracker_plan(int J, int C, int S, int smem_optin, int* nr, int* ns,
                             int* memory, long long* region, int* staged, long long* smem) {
  const long long ring = static_cast<long long>(dynamic_smem(J));
  if (C <= 256 && S <= 64) {
    *nr = C <= 64 ? 2 : (C <= 128 ? 4 : 8);
    *ns = S <= 32 ? 1 : 2;
    *memory = 0;
    *region = 0;
    *staged = static_smem(*nr, *ns) + ring <= smem_optin;
    *smem = *staged ? ring : 0;
    return;
  }
  *nr = (C + 31) / 32;
  *ns = (S + 31) / 32;
  *region = region_bytes(32LL * *nr, 32LL * *ns);
  const long long fixed = 1024;   // the static arrays at one entry each
  if (fixed + *region + ring <= smem_optin) {
    *memory = 1; *staged = 1; *smem = *region + ring;
  } else if (fixed + *region <= smem_optin) {
    *memory = 1; *staged = 0; *smem = *region;
  } else {
    *memory = 2; *staged = fixed + ring <= smem_optin; *smem = *staged ? ring : 0;
  }
}

// The row slots a lane that the sequential matcher keeps in registers
// through a frame's steps at J candidates, capacity C and S slots: all of
// them in the register geometry, the first kSeqRegSlots (at most) in the
// memory geometry, whose region holds the rest.
extern "C" int tracker_seq_rows(int J, int C, int S) {
  int nr, ns, memory, staged;
  long long region, smem;
  tracker_plan(J, C, S, smem_optin(), &nr, &ns, &memory, &region, &staged, &smem);
  return memory ? min(nr, kSeqRegSlots) : nr;
}

// The global scratch a symbol that tracker_launch needs on the current
// device at J candidates, capacity C and S slots: the region where
// tracker_plan puts it in global memory, else 0.
extern "C" long long tracker_scratch_bytes(int J, int C, int S) {
  int nr, ns, memory, staged;
  long long region, smem;
  tracker_plan(J, C, S, smem_optin(), &nr, &ns, &memory, &region, &staged, &smem);
  return memory == 2 ? region : 0;
}

// in: 4 pointers (period, power, fft, valid). init: 12 pointers in
// TrackerState order (seen_now unused), or null for a fresh start.
// out: 11 pointers in the order of Outputs. fin: 12 pointers in
// TrackerState order. `sequential`: the reference-exact matcher (kSeq),
// else the vectorized one. `scratch`: `scratch_bytes` of global memory,
// at least B * region where tracker_plan names memory 2, else unused.
// `general_frames`: one int32 on the card that gains the symbol-frames
// whose sequential steps took seq_general, or null.
// Returns a cudaError_t code: a scratch too small, a shared-memory size
// the card cannot give, or a refused launch, is returned, never skipped.
extern "C" int tracker_launch(void* const* in, void* const* init,
                              void* const* out, void* const* fin, int sequential, int B,
                              int T, int J, int C, int S, float tol,
                              int max_inactive, float leak_pr, float leak_wr,
                              int leak_min, int leak_max, void* scratch,
                              long long scratch_bytes, int32_t* general_frames,
                              void* stream) {
  if (C < 1 || S < 1 || J < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  int nr, ns, memory, staged;
  long long region, smem;
  tracker_plan(J, C, S, smem_optin(), &nr, &ns, &memory, &region, &staged, &smem);
  if (memory == 2 && (scratch == nullptr || scratch_bytes < B * region)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  // seq_bounds's constants: a(P) = (200 - P) / (200 + P), margins of 2^-20
  const double m = 1.0 / (1 << 20), t = tol;
  auto a = [](double pct) { return (200.0 - pct) / (200.0 + pct); };
  const double a_in = a(t * (1 - m)), a_out = a(t * (1 + m));
  Params prm{T, J, C, S, frames_per_stage(J), tol, leak_pr, leak_wr,
             max_inactive, leak_min, leak_max, nr, ns, memory == 1, region,
             tol >= 1e-3f && tol <= 100.f, static_cast<float>(a_in * (1 + m)),
             static_cast<float>(1 / a_in * (1 - m)), static_cast<float>(a_out * (1 - m)),
             static_cast<float>(1 / a_out * (1 + m)), general_frames};
  const State fn = state_from(fin);
  const bool hi = init != nullptr, sq = sequential != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  uint8_t* scr = static_cast<uint8_t*>(scratch);
  if (memory) {
    // the sequential matcher keeps its first kSeqRegSlots slots in registers
    return sq ? launch_mode<kSeqRegSlots, 1, true, true>(staged, ins, st0, hi, o, fn, prm, B, sm, scr, st)
              : launch_mode<1, 1, false, true>(staged, ins, st0, hi, o, fn, prm, B, sm, scr, st);
  }
  switch (nr * 10 + ns) {
    case 21: return launch_regs<2, 1>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, scr, st);
    case 22: return launch_regs<2, 2>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, scr, st);
    case 41: return launch_regs<4, 1>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, scr, st);
    case 42: return launch_regs<4, 2>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, scr, st);
    case 81: return launch_regs<8, 1>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, scr, st);
    default: return launch_regs<8, 2>(staged, sq, ins, st0, hi, o, fn, prm, B, sm, scr, st);
  }
}
