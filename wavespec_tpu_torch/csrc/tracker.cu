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
// compares. The frames of one symbol form a dependent chain, and each
// frame is a chain of warp reductions (one per candidate, one per slot
// fill, one per slot leak search): latency, not bandwidth or arithmetic,
// sets the time.
//
// Design: one warp per symbol (one block of 32 threads), the frame loop
// inside the kernel. Lane l holds capacity rows l and l + 32 (C <= 64)
// in registers and lane s < S holds slot s. The frame's candidates are
// staged in shared memory (J * 20 bytes, so J is bounded only by 48 KB:
// the all-bins mode's J = 149 at window 4096 fits). Matching runs one
// warp-wide (cost, row) argmin per candidate, first row on ties; the
// owner lane of the winning row keeps the smallest-cost candidate, first
// candidate on ties. Unmatched candidates are ranked by ballot prefix
// counts, and the nth takes the nth dead row. Slot fill and the leak
// search are warp argmax rounds with the smallest uid on ties. Values
// of a row are read by other lanes through shuffles.
// This file must be compiled with --fmad=false, so that the tolerance
// expression rounds as the plain version's separate PyTorch ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kImax = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

struct Inputs {
  const float* period;    // [B, T, J]
  const float* power;
  const int32_t* fft;
  const uint8_t* valid;
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
  int T, J, C, S;
  float tol, leak_pr, leak_wr;
  int max_inactive, leak_min, leak_max;
};

// The value of capacity row `row` (held by lane row & 31 as v0 for
// row < 32, v1 above); every lane of the warp must call it.
template <typename V>
__device__ __forceinline__ V row_value(V v0, V v1, int row) {
  const V a = __shfl_sync(kFull, v0, row & 31);
  const V b = __shfl_sync(kFull, v1, row & 31);
  return row < 32 ? a : b;
}

__device__ __forceinline__ float match_cost(float p, bool p_ok, float per,
                                            bool elig, float tol) {
  const float diff = fabsf(p - per);
  const float avg = 0.5f * (p + per);
  const float pct = avg > 0.f ? diff / fmaxf(avg, 1e-30f) * 100.0f : kBig;
  const bool ok = p_ok && elig && per > 0.f && pct <= tol;
  return ok ? diff : kBig;
}

__global__ void tracker_kernel(Inputs in, State init, bool has_init,
                               Outputs out, State fin, Params prm) {
  extern __shared__ unsigned char smem[];
  const int J = prm.J, C = prm.C, S = prm.S, T = prm.T;
  float* s_cp = reinterpret_cast<float*>(smem);
  float* s_cw = s_cp + J;
  int32_t* s_cf = reinterpret_cast<int32_t*>(s_cw + J);
  int32_t* s_flag = s_cf + J;   // candidate valid, then "unmatched"
  int32_t* s_list = s_flag + J; // unmatched candidates in j order

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

  for (int t = 0; t < T; ++t) {
    const long long cbase = ((long long)b * T + t) * J;
    for (int j = lane; j < J; j += 32) {
      s_cp[j] = in.period[cbase + j];
      s_cw[j] = in.power[cbase + j];
      s_cf[j] = in.fft[cbase + j];
      s_flag[j] = in.valid[cbase + j] != 0;
    }
    __syncwarp();

    // ---- candidate -> tracker matching ----
    const bool el0 = ex0 && al0 && bi0 == 0;
    const bool el1 = ex1 && al1 && bi1 == 0;
    float wc0 = kBig, wc1 = kBig;
    int wj0 = -1, wj1 = -1;
    for (int j = 0; j < J; ++j) {
      const float p = s_cp[j];
      const bool p_ok = s_flag[j] != 0 && p > 0.f;
      const float c0 = match_cost(p, p_ok, per0, el0, prm.tol);
      const float c1 = match_cost(p, p_ok, per1, el1, prm.tol);
      float bc = c0;
      int br = r0;
      if (c1 < c0) { bc = c1; br = r1; }
      for (int o = 16; o > 0; o >>= 1) {
        const float c2 = __shfl_xor_sync(kFull, bc, o);
        const int r2 = __shfl_xor_sync(kFull, br, o);
        if (c2 < bc || (c2 == bc && r2 < br)) { bc = c2; br = r2; }
      }
      const bool matched = bc < kBig;
      if (matched) {
        if (br == r0 && bc < wc0) { wc0 = bc; wj0 = j; }
        if (br == r1 && bc < wc1) { wc1 = bc; wj1 = j; }
      }
      __syncwarp();
      if (lane == 0) s_flag[j] = !matched && p_ok;
    }
    seen0 = wj0 >= 0;
    seen1 = wj1 >= 0;
    if (seen0) { per0 = s_cp[wj0]; pw0 = s_cw[wj0]; fi0 = s_cf[wj0]; }
    if (seen1) { per1 = s_cp[wj1]; pw1 = s_cw[wj1]; fi1 = s_cf[wj1]; }
    __syncwarp();

    // ---- the nth unmatched candidate takes the nth dead row ----
    int n_unm = 0;
    for (int base = 0; base < J; base += 32) {
      const int jj = base + lane;
      const bool u = jj < J && s_flag[jj] != 0;
      const unsigned m = __ballot_sync(kFull, u);
      if (u) s_list[n_unm + __popc(m & lt)] = jj;
      n_unm += __popc(m);
    }
    __syncwarp();
    const bool dead0 = ex0 && !al0, dead1 = ex1 && !al1;
    const unsigned dm0 = __ballot_sync(kFull, dead0);
    const unsigned dm1 = __ballot_sync(kFull, dead1);
    const int rank0 = __popc(dm0 & lt);
    const int rank1 = __popc(dm0) + __popc(dm1 & lt);
    if (dead0 && rank0 < n_unm) {
      const int jj = s_list[rank0];
      per0 = s_cp[jj]; pw0 = s_cw[jj]; fi0 = s_cf[jj];
      uid0 = next_uid + rank0; seen0 = true; al0 = true;
    }
    if (dead1 && rank1 < n_unm) {
      const int jj = s_list[rank1];
      per1 = s_cp[jj]; pw1 = s_cw[jj]; fi1 = s_cf[jj];
      uid1 = next_uid + rank1; seen1 = true; al1 = true;
    }
    next_uid += min(__popc(dm0) + __popc(dm1), n_unm);

    // ---- deactivate unseen; kill after max_inactive ----
    bi0 = seen0 ? 0 : bi0 + 1;
    bi1 = seen1 ? 0 : bi1 + 1;
    if (al0 && !seen0 && bi0 >= prm.max_inactive) al0 = false;
    if (al1 && !seen1 && bi1 >= prm.max_inactive) al1 = false;

    // ---- stable slots: keep by uid while alive ----
    bool used0 = false, used1 = false, my_keep = false;
    int my_row = -1;
    for (int s = 0; s < S; ++s) {
      const int sus = __shfl_sync(kFull, su, s);
      const bool m0 = ex0 && al0 && sus > 0 && uid0 == sus;
      const bool m1 = ex1 && al1 && sus > 0 && uid1 == sus;
      const unsigned b0 = __ballot_sync(kFull, m0);
      const unsigned b1 = __ballot_sync(kFull, m1);
      used0 |= m0;
      used1 |= m1;
      if (lane == s && (b0 | b1)) {
        my_keep = true;
        my_row = b0 ? __ffs(b0) - 1 : 32 + __ffs(b1) - 1;
      }
    }
    if (!my_keep) su = 0;

    // ---- fill free slots with the strongest unused trackers ----
    bool av0 = ex0 && al0 && !used0 && pw0 > 0.f;
    bool av1 = ex1 && al1 && !used1 && pw1 > 0.f;
    for (int s = 0; s < S; ++s) {
      if (__shfl_sync(kFull, my_keep, s)) continue;
      float bp = -1.f;
      int bu = kImax, brow = -1;
      if (av0) { bp = pw0; bu = uid0; brow = r0; }
      if (av1 && (pw1 > bp || (pw1 == bp && uid1 < bu))) { bp = pw1; bu = uid1; brow = r1; }
      for (int o = 16; o > 0; o >>= 1) {
        const float p2 = __shfl_xor_sync(kFull, bp, o);
        const int u2 = __shfl_xor_sync(kFull, bu, o);
        const int w2 = __shfl_xor_sync(kFull, brow, o);
        if (p2 > bp || (p2 == bp && u2 < bu)) { bp = p2; bu = u2; brow = w2; }
      }
      if (bp > 0.f) {
        if (brow == r0) av0 = false;
        if (brow == r1) av1 = false;
        if (lane == s) { su = bu; my_row = brow; }
      }
    }
    const bool sv = lane < S && su > 0;
    const int src = sv ? my_row : 0;
    const float sp_v = row_value(per0, per1, src);
    const float spw_v = row_value(pw0, pw1, src);
    const int sfi_v = row_value(fi0, fi1, src);
    const float slot_p = sv ? sp_v : 0.f;
    const float slot_pw = sv ? spw_v : 0.f;
    const int slot_fi = sv ? sfi_v : 0;

    // ---- leakage: per slot the strongest intruder (smallest uid) ----
    int best_row = 0, best_uid = 0;
    bool found = false;
    for (int s = 0; s < S; ++s) {
      const float sp = __shfl_sync(kFull, slot_p, s);
      const float spw = __shfl_sync(kFull, slot_pw, s);
      const int suv = __shfl_sync(kFull, su, s);
      const bool svs = suv > 0;
      const bool lk0 = ex0 && al0 && seen0 && svs && per0 < sp * prm.leak_pr &&
                       pw0 >= spw * prm.leak_wr && bi0 <= prm.leak_min && uid0 != suv;
      const bool lk1 = ex1 && al1 && seen1 && svs && per1 < sp * prm.leak_pr &&
                       pw1 >= spw * prm.leak_wr && bi1 <= prm.leak_min && uid1 != suv;
      const float sc0 = ex0 ? (lk0 ? pw0 : -1.f) : -INFINITY;
      const float sc1 = ex1 ? (lk1 ? pw1 : -1.f) : -INFINITY;
      float top = fmaxf(sc0, sc1);
      for (int o = 16; o > 0; o >>= 1) top = fmaxf(top, __shfl_xor_sync(kFull, top, o));
      int bu = kImax, brow = kImax;
      if (sc0 >= top) { bu = uid0; brow = r0; }
      if (sc1 >= top && (uid1 < bu || (uid1 == bu && r1 < brow))) { bu = uid1; brow = r1; }
      for (int o = 16; o > 0; o >>= 1) {
        const int u2 = __shfl_xor_sync(kFull, bu, o);
        const int w2 = __shfl_xor_sync(kFull, brow, o);
        if (u2 < bu || (u2 == bu && w2 < brow)) { bu = u2; brow = w2; }
      }
      if (lane == s) { found = top > 0.f; best_row = brow; best_uid = bu; }
    }
    const float lp_v = row_value(per0, per1, best_row);
    const float lpw_v = row_value(pw0, pw1, best_row);
    const int lfi_v = row_value(fi0, fi1, best_row);
    if (lane < S) {
      int bars = lact ? lbars + 1 : 0;
      const bool was = lact && !(bars > prm.leak_max);
      const bool same = was && found && luid == best_uid;
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
      out.leak_period[o] = found ? lp_v : 0.f;
      out.leak_power[o] = found ? lpw_v : 0.f;
      out.leak_fft[o] = found ? lfi_v : 0;
      out.leak_bars[o] = found ? lbars : 0;
    }
    __syncwarp();
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
// TrackerState order. Returns a cudaError_t code.
extern "C" int tracker_launch(void* const* in, void* const* init,
                              void* const* out, void* const* fin, int B,
                              int T, int J, int C, int S, float tol,
                              int max_inactive, float leak_pr, float leak_wr,
                              int leak_min, int leak_max, void* stream) {
  const size_t smem = (size_t)J * 20;
  if (C < 1 || C > 64 || S < 1 || S > 32 || J < 1 || smem > 48 * 1024) {
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
  Params prm{T, J, C, S, tol, leak_pr, leak_wr, max_inactive, leak_min, leak_max};
  tracker_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      ins, st0, init != nullptr, o, state_from(fin), prm);
  return static_cast<int>(cudaGetLastError());
}
