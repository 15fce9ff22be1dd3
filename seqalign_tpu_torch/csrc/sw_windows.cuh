// Smith-Waterman scoring for Hopper, sm_90a: one query or a batch of
// queries against fixed lane batches (K4), and the same with a constant
// substitution score, for timing the DP loop alone (K5). The kernel
// template; sw_windows.cu builds K4's instances and holds the C entry,
// sw_windows_const_s.cu builds K5's, so the two compile in parallel.
//
// Replaces the TPU kernel seqalign_tpu/ops/swa_pallas.py:_kernel +
// _run_block, called through sw_pallas_windows (K4; K5 with const_s=True):
// NW equal-length '*'-padded windows, one sequence per lane, the same
// G-form affine-gap recurrence on the biased profile P' = P - go, the DP
// state fresh only at position 0 and each lane's best stored once,
// window-major ((nq,) nw, win), bit for bit.
//
// Layout of the work: the team design of K1 and K3 (sw_stream.cuh). A team
// of T threads (1 to 32, a power of two) scores one lane of one window for
// one query, thread k holding the R rows k R .. k R + R - 1 of the query in
// registers; the lane's positions flow through the team two a step (the
// team step of sw_team.cuh). No segment table: the word of position 0
// carries the fresh bit, so thread k resets its rows at step k, in the
// warp's first T steps, and the hot loop takes no vote (a team of one
// thread starts as the boundary and takes none). The team's last
// thread with rows writes the lane's best once. The query is the grid's z
// axis; the profile sits in shared memory as sw_stream.cuh lays it out
// (32 columns, or row-major for teams of one thread). The wrapper picks
// (T, R) for the batch (swa_cuda.windows_team): a narrow batch takes wide
// teams, so that its lanes still fill the card's SMs.
//
// Each warp stops at its own end. A warp's teams run together (full-warp
// shuffles), so it runs end_w / 2 + rows_last steps, end_w the last
// position + 1 at which one of its own lanes holds a char other than '*',
// rounded up to the step's 2 positions; end_w is the Pass.len that bounds
// the best, so no later position counts. The warp finds end_w itself,
// scanning its lanes' '*' tail backward with __ballot_sync, T positions of
// its 32 / T lanes a load, eight loads in flight; teams past the window's
// last lane read nothing and add nothing to it.
//
// Why the skip is exact. Let every scored row's '*' score P[i]['*'] =
// P'[i][31] + go be <= 0, and go <= ge <= 0. In a column past a lane's last
// residue, by induction over those columns and down their rows: H' adds
// S <= 0 to a cell before it, E and F carry a cell before it plus a gap
// <= 0, so no G there exceeds the best of the lane's real columns, and the
// int32 best is the same. A '*' inside a record is scored as usual (the
// warp stops only after its last residue). Where a query row's '*' score
// is positive (BLOSUM62's ('*', '*') is +1, so a query holding '*'), the
// padding raises scores as it does in the JAX kernel: while the CTA copies
// the profile it ORs that condition over its rows (__syncthreads_or), and
// then every warp runs to the batch's length. K5 never skips: its S = 7
// makes the padding count, as _run_block(const_s=True) does. The launch
// refuses ge > 0 (and so go > 0): a thread's rows past lqp (P' = 0) would
// each add ge to an F chain inside K4's column max.
//
// Constant S (K5, kConstS): the team step with S = 7 in place of the
// profile gather (team_step's kConstS), on the query's lqp rows only (the
// rows a team holds past lqp do not raise the best); no profile is copied
// and none is requested.
//
// What bounds it on this card. No DP state goes through device memory, and
// the cells past a warp's end are not run: what is left is the integer
// work of the team step, about 4 instructions on the busier pipe and one
// LDS a cell, bound by operations, over the cells the warps run (the real
// cells, each warp's lanes run to the longest of them) and T - 1 steps of
// fill and drain a lane.

#pragma once

#include "sw_stream.cuh"

namespace {

constexpr int kStar = kAlpha - 1;  // '*' (PAD_INDEX)
constexpr int kSoloWords = 4;      // steps a solo thread loads at a time
constexpr int kEndLoads = 8;       // loads in flight a thread, warp_end

// The word of positions j0 and j0 + 1 of a lane whose column starts at col;
// 0 from len on. Position 0 starts the lane (kFreshBit).
__device__ __forceinline__ int window_word(const int8_t* __restrict__ col,
                                           int j0, int len, int win) {
  if (j0 >= len) return 0;
  // Read the chars unsigned and mask them: never a negative index.
  const int8_t* c = col + (size_t)j0 * win;
  const int c0 = (int)(uint8_t)c[0] & (kAlpha - 1);
  const int c1 = (int)(uint8_t)c[win] & (kAlpha - 1);
  return c0 | (j0 == 0 ? kFreshBit : 0) | (c1 << kChar1Shift);
}

// A step's input: receive's, or for a solo thread (thread 0 of its team)
// the boundary row and its own word.
template <int R, bool kSolo>
__device__ __forceinline__ Input take(const Team<R>& st, const Pass& ps,
                                      int t, const Block& b, int team) {
  if constexpr (kSolo) {
    return Input{ps.go, 0, ps.go, 0, b.word, 0};
  } else {
    return receive<false, R, 0>(st, ps, t, b, team);
  }
}

// 1 + the last position below len at which one of the warp's lanes
// [lane0, lane0 + nl) of the window wdb holds a char other than '*' (lanes
// from win on hold none); 0 if none does. Thread j reads lane lane0 + j % nl
// at positions p - j / nl - u (32 / nl), u < kEndLoads.
__device__ __forceinline__ int warp_end(const int8_t* __restrict__ wdb,
                                        int lane0, int nl, int len, int win) {
  const int j = threadIdx.x % kWarp;
  const int lane = lane0 + j % nl;
  const int per = kWarp / nl;  // positions a load covers
  const bool live = lane < win;
  for (int p = len - 1; p >= 0; p -= per * kEndLoads) {
    int c[kEndLoads];
#pragma unroll
    for (int u = 0; u < kEndLoads; ++u) {
      const int at = p - j / nl - u * per;
      c[u] = live && at >= 0
                 ? (int)(uint8_t)wdb[(size_t)at * win + lane] & (kAlpha - 1)
                 : kStar;
    }
#pragma unroll
    for (int u = 0; u < kEndLoads; ++u) {
      const unsigned m = __ballot_sync(kFull, c[u] != kStar);
      // The lowest thread that saw a residue read the highest position.
      if (m) return p - u * per - (__ffs(m) - 1) / nl + 1;
    }
  }
  return 0;
}

// K4 (K5 with kConstS): nq queries of lqp rows, all scored, against nw
// windows of len positions; grid (lane groups of team_threads<R>() / team,
// nw, nq). kSolo: team is 1. The 1 lets ptxas use up to 65536 / threads
// registers a thread, as for sw_stream_kernel.
template <int R, bool kSolo, bool kConstS>
__global__ void __launch_bounds__(team_threads<R>(), 1) sw_windows_kernel(
    const int32_t* __restrict__ prof,  // (nq, lqp, 32) biased; unread by K5
    const int8_t* __restrict__ db,     // (nw, len, win) chars 0..31
    int32_t* __restrict__ out,         // (nq, nw, win) bests
    int lqp, int len, int win, int nw, int team, int go, int ge, int one) {
  const int q = blockIdx.z;
  // [c][r][j] = P'[(j % team) R + r][c]; for teams of one thread [r][c].
  extern __shared__ int32_t sprof[];
  bool full = true;  // run every lane to len
  if constexpr (!kConstS) {
    const int32_t* qprof = prof + (size_t)q * lqp * kAlpha;
    const int nwords = (int)(profile_bytes(R, team) / sizeof(int32_t));
    int star = 0;  // a scored row whose '*' score is positive
    for (int idx = threadIdx.x; idx < nwords; idx += blockDim.x) {
      int row = idx / kAlpha, c = idx % kAlpha;
      if (team > 1) {
        row = ((idx % kWarp) & (team - 1)) * R + (idx / kWarp) % R;
        c = idx / (kWarp * R);
      }
      const int v = row < lqp ? qprof[row * kAlpha + c] : 0;
      sprof[idx] = v;
      star |= c == kStar && row < lqp && v + go > 0;
    }
    full = __syncthreads_or(star);
  }

  constexpr int kW = kSolo ? kSoloWords : 1;
  const int j = threadIdx.x % kWarp;
  const int k = kSolo ? 0 : j & (team - 1);
  const int lane = (blockIdx.x * blockDim.x + threadIdx.x) / team;
  const bool live = lane < win;
  // The teams of a warp run together (full-warp shuffles and votes): a
  // team past the last lane runs on lane 0's column and writes nothing.
  if (__all_sync(kFull, !live)) return;
  const int w = blockIdx.y;
  const int8_t* wdb = db + (size_t)w * len * win;
  const int8_t* col = wdb + (live ? lane : 0);
  int end = len;
  if (!full) {
    const int lane0 = (blockIdx.x * blockDim.x + threadIdx.x - j) / team;
    end = (warp_end(wdb, lane0, kWarp / team, len, win) + 1) & ~1;
  }
  const int rows_last = min(team - 1, (lqp - 1) / R);  // last with rows
  const int last = live ? rows_last : -1;
  // This thread's last real row (K5's column max stops there).
  const int rlast = k < rows_last ? R - 1 : k == rows_last ? lqp - 1 - k * R : -1;
  const Pass ps{team > 1 ? sprof + j : sprof, out, nullptr, 0, k, last, rlast,
                end, win, lane, go, ge, one, team > 1 ? R * kWarp : 1};

  Team<R> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st.gg[r] = go;
    st.e[r] = 0;
  }
  st.o_gg0 = st.o_gg1 = go;
  st.o_f0 = st.o_f1 = st.o_word = st.o_cm = 0;
  st.diag = go;
  st.best = 0;
  const int nsteps = end ? end / 2 + rows_last : 0;
  // Thread k's words of the block: steps s0 + u team + k, u < kW.
  int words[kW];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    words[u] = window_word(col, 2 * (u * team + k), end, win);
  }
  for (int s0 = 0; s0 < nsteps; s0 += team * kW) {
    int nx[kW];
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      nx[u] = window_word(col, 2 * (s0 + (kW + u) * team + k), end, win);
    }
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      const int s1 = s0 + u * team;
      if (s1 >= nsteps) break;
      const Block b{words[u], go, 0, go, 0};
      if constexpr (kSolo) {
        // One thread a team: no fill, and its rows start as the boundary,
        // so position 0 needs no reset; kW steps an iteration of the loop.
        team_step<R, false, false, false, 0, kConstS>(
            st, take<R, true>(st, ps, 0, b, 1), ps, 2 * s1);
      } else if (s1 == 0) {
        // The fill: thread k takes position 0, and resets its rows, at step
        // k.
#pragma unroll 1
        for (int t = 0; t < team; ++t) {
          team_step<R, false, false, true, 0, kConstS>(
              st, take<R, kSolo>(st, ps, t, b, team), ps, 2 * (t - k));
        }
      } else {
#pragma unroll 1
        for (int t = 0; t < team; ++t) {
          team_step<R, false, false, false, 0, kConstS>(
              st, take<R, kSolo>(st, ps, t, b, team), ps, 2 * (s1 + t - k));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kW; ++u) words[u] = nx[u];
  }
  if (k == last) out[((size_t)q * nw + w) * win + lane] = st.best;
}

template <int R, bool kSolo, bool kConstS>
int launch_windows(const void* prof, const void* db, void* out, int lqp,
                   int len, int win, int nw, int nq, int team, int go, int ge,
                   cudaStream_t stream) {
  constexpr int kThreads = team_threads<R>();
  // K5 reads no profile: no shared memory.
  const size_t smem = kConstS ? 0 : profile_bytes(R, team);
  if constexpr (!kConstS) {
    // Above 48 KB a block's dynamic shared memory must be opted into.
    cudaError_t err = cudaFuncSetAttribute(
        sw_windows_kernel<R, kSolo, kConstS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // No more threads than the window's lanes need: a CTA's registers and
  // shared memory stay held until its last warp ends.
  const int need = (win * team + kWarp - 1) / kWarp * kWarp;
  const int threads = need < kThreads ? need : kThreads;
  const int lanes = threads / team;  // lanes per CTA
  const dim3 grid((win + lanes - 1) / lanes, nw, nq);
  sw_windows_kernel<R, kSolo, kConstS><<<grid, threads, smem, stream>>>(
      (const int32_t*)prof, (const int8_t*)db, (int32_t*)out, lqp, len, win,
      nw, team, go, ge, 1);
  return (int)cudaGetLastError();
}

// The (R, solo) instances K4 and K5 are built for: R of
// swa_cuda.WINDOWS_ROWS_PER_THREAD_BUILT, solo where R is one of
// swa_cuda.WINDOWS_SOLO_ROWS (phase 2 of chip_smoke.py requires each).
#define SW_WINDOWS_INSTANCES(X) \
  X(10, true)                   \
  X(12, true)                   \
  X(16, true)                   \
  X(18, true)                   \
  X(20, true)                   \
  X(24, true)                   \
  X(28, false)                  \
  X(32, false)                  \
  X(36, false)                  \
  X(40, false)                  \
  X(44, false)                  \
  X(48, false)

// Launch K4's (K5's with kConstS) instance of R = rows_per_thread, the
// solo one where team is 1 and one is built; cudaErrorInvalidValue where
// none is built.
template <bool kConstS>
int launch_windows_rows(const void* prof, const void* db, void* out, int lqp,
                        int len, int win, int nw, int nq, int go, int ge,
                        int team, int rows_per_thread, cudaStream_t stream) {
#define SW_WINDOWS_CASE(R, SOLO)                                              \
  case R:                                                                     \
    return team == 1 && SOLO                                                  \
               ? launch_windows<R, SOLO, kConstS>(prof, db, out, lqp, len,    \
                                                  win, nw, nq, 1, go, ge,     \
                                                  stream)                     \
               : launch_windows<R, false, kConstS>(prof, db, out, lqp, len,   \
                                                   win, nw, nq, team, go, ge, \
                                                   stream);
  switch (rows_per_thread) {
    SW_WINDOWS_INSTANCES(SW_WINDOWS_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SW_WINDOWS_CASE
}

}  // namespace

// Launch K5's instance of R = rows_per_thread (sw_windows_const_s.cu), as
// sw_windows_launch does for K4; cudaErrorInvalidValue where none is built.
int sw_windows_launch_const_s(const void* prof, const void* db, void* out,
                              int lqp, int len, int win, int nw, int nq,
                              int go, int ge, int team, int rows_per_thread,
                              cudaStream_t stream);
