// Smith-Waterman scoring for Hopper, sm_90a: one query (K1) or a batch of
// queries (K3) against segmented window streams, in one pass, a team of
// threads per database lane with the query's rows held in registers. The
// kernel template; sw_stream.cu builds it for every R and holds the C entry.
// Teams of one thread at the R of the solo kernel run that kernel instead
// (sw_stream_solo.cu, sw_stream_solo_kernel<R, Q>: several queries a
// thread). K2 (sw_striped.cu) runs the same team step over the row stripes
// of a longer query; K4 and K5 are in sw_windows.cu.
//
// Replaces the TPU kernel seqalign_tpu/ops/swa_pallas.py:_kernel_stream +
// _run_block, called through sw_pallas_stream with a 2-D profile (K1) or a
// 3-D one (K3, row stacking): the G-form affine-gap recurrence over the same
// inputs (biased profile P' = P - go, NW window streams, segment table fs),
// with the same per-segment outputs, bit for bit. K1 is the launch with one
// query.
//
// Layout of the work. A team of T threads (1 to 32, a power of two) scores
// one lane of one window for one query, thread k holding the R rows
// k R .. k R + R - 1 of the query in registers (the team step of
// sw_team.cuh). Row -1 is the boundary (Gg = go, F = 0) at every position:
// one pass, no boundary in or out. T and R fit the query: the wrapper picks
// (T, R) with T R >= rows and little padding (swa_cuda.stream_team), where
// rows <= lqp are the profile's rows to score (the rest is the caller's
// padding, which never raises a score); the threads' rows past `rows` are
// P' = 0 rows, which never raise a best (H' <= G_diag there). R is a
// template argument (one instance per R built), T a launch argument: the
// shuffles take the team's width at run time. Each team loads T steps of
// chars and fs at a time, one step per thread. The query is the grid's z
// axis: a CTA holds one query's profile
// and its lanes' bests go to that query's column of out (nslots, nq, win),
// each slot written once, by the team's last thread with rows. The name's
// kSolo is false in every instance (the solo kernel took its place).
//
// Shared memory. The query's P' as sw_team.cuh lays it out, replicated for
// the 32 / T teams of a warp: column j holds thread j % T's rows, so the
// bank is the thread and teams that gather different chars have no
// conflicts. 4 KiB x R per CTA. Teams of one thread (at an R the solo
// kernel is not built for) read the same row at each step, so for them P'
// stays row-major, 128 B x R: more CTAs fit an SM.
//
// Latency. Each team loads the chars and fs of its next T steps before it
// runs the current T, so the loads complete under a block of steps.
//
// What bounds it on this card. No DP state goes through device memory (the
// stream body K1 and K3 ran before kept the lane's rolling (Gg, E) rows
// there, about 1 B per cell). What is left is the integer work of
// sw_striped.cu's step, about 5 instructions on the busier pipe and one LDS
// per cell, plus the step's shuffles and bookkeeping over 2 R cells and
// T - 1 steps of fill and drain per stream; the padding of T R over lqp.

#pragma once

#include "sw_team.cuh"

namespace {

// Threads per CTA at R rows a thread: as many as the registers (about
// 2 R + 40 a thread) allow without spills at one CTA per SM, whose shared
// profile of 4 KiB x R leaves room for one CTA from R = 28 up.
template <int R>
__host__ __device__ constexpr int team_threads() {
  return R >= 40 ? 384 : 512;
}

// Shared profile bytes at R rows a thread for teams of `team` threads.
__host__ __device__ constexpr size_t profile_bytes(int R, int team) {
  return (size_t)kAlpha * R * (team == 1 ? 1 : kWarp) * sizeof(int32_t);
}

// The segment word of positions j0 and j0 + 1 of the lane's stream at col;
// 0 past the stream's end.
__device__ __forceinline__ int step_word(const int8_t* __restrict__ streams,
                                         const int32_t* __restrict__ fsw,
                                         size_t col, size_t fs_step, int j0,
                                         int len, int win) {
  if (j0 >= len) return 0;
  // Read the chars unsigned and mask them: never a negative index.
  const int8_t* c = streams + col + (size_t)j0 * win;
  const int c0 = (int)(uint8_t)c[0] & (kAlpha - 1);
  const int c1 = (int)(uint8_t)c[win] & (kAlpha - 1);
  const int slot = j0 % JB == 0 ? fsw[(size_t)(j0 / JB) * fs_step] : 0;
  return c0 | (j0 == 0 || slot > 0 ? kFreshBit : 0) | (c1 << kChar1Shift) |
         (slot << kSlotShift);
}

// K1 and K3: nq queries of lqp rows each, `rows` of them scored, one pass;
// grid (lane groups of team_threads<R>() / team, nw, nq). kSolo is false
// (above). The 1 lets ptxas use up to 65536 / threads registers a thread (it
// held R = 20 to 64 and spilled).
template <int R, bool kSolo>
__global__ void __launch_bounds__(team_threads<R>(), 1) sw_stream_kernel(
    const int32_t* __restrict__ prof,    // (nq, lqp, 32) biased profiles
    const int8_t* __restrict__ streams,  // (nw, L, win) chars 0..31
    const int32_t* __restrict__ fs,      // (L/JB, nw, 2) segment table
    int32_t* __restrict__ out,           // (nslots, nq, win) bests, zeroed
    int lqp, int rows, int len, int win, int nw, int team, int go, int ge,
    int one) {
  static_assert(!kSolo, "teams of one thread run sw_stream_solo_kernel");
  const int q = blockIdx.z;
  const int nq = gridDim.z;
  // [c][r][j] = P'[(j % team) R + r][c]; for teams of one thread [r][c].
  extern __shared__ int32_t sprof[];
  const int32_t* qprof = prof + (size_t)q * lqp * kAlpha;
  const int nwords = (int)(profile_bytes(R, team) / sizeof(int32_t));
  // Consecutive threads write consecutive banks.
  for (int idx = threadIdx.x; idx < nwords; idx += blockDim.x) {
    int row = idx / kAlpha, c = idx % kAlpha;
    if (team > 1) {
      row = ((idx % kWarp) & (team - 1)) * R + (idx / kWarp) % R;
      c = idx / (kWarp * R);
    }
    sprof[idx] = row < rows ? qprof[row * kAlpha + c] : 0;
  }
  __syncthreads();

  const int j = threadIdx.x % kWarp;
  const int k = j & (team - 1);
  const int lane = (blockIdx.x * blockDim.x + threadIdx.x) / team;
  const bool live = lane < win;
  // The teams of a warp run together (full-warp shuffles and votes): a
  // team past the last lane runs on lane 0's stream and writes nothing.
  if (__all_sync(kFull, !live)) return;
  const int w = blockIdx.y;
  const size_t col = (size_t)w * len * win + (live ? lane : 0);
  const int rows_last = min(team - 1, (rows - 1) / R);  // last with rows
  const int last = live ? rows_last : -1;
  const Pass ps{team > 1 ? sprof + j : sprof, out, nullptr, 0, k, last, 0,
                len, nq * win, q * win + lane, go, ge, one,
                team > 1 ? R * kWarp : 1};
  const size_t fs_step = (size_t)nw * 2;  // fs[blk][w] -> fs[blk + 1][w]
  const int32_t* fsw = fs + (size_t)w * 2;

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
  const int nsteps = len / 2 + rows_last;
  // Thread k's step of the block: s0 + k; the next block's is loaded a
  // block ahead.
  int word = step_word(streams, fsw, col, fs_step, 2 * k, len, win);
  for (int s0 = 0; s0 < nsteps; s0 += team) {
    const int next =
        step_word(streams, fsw, col, fs_step, 2 * (s0 + team + k), len, win);
    const Block b{word, go, 0, go, 0};
    // The steps at which no thread of the warp starts a segment run the
    // hot loop; a step that starts one leaves it to reset, as a cold step.
    int t = 0;
    while (true) {
#pragma unroll 1
      for (; t < team; ++t) {
        const Input in = receive<false, R, 0>(st, ps, t, b, team);
        if (__any_sync(kFull, in.word & kFreshBit)) break;
        team_step<R, false, false, false, 0>(st, in, ps, 2 * (s0 + t - k));
      }
      if (t == team) break;
      team_step<R, false, false, true, 0>(
          st, receive<false, R, 0>(st, ps, t, b, team), ps, 2 * (s0 + t - k));
      ++t;
    }
    word = next;
  }
  if (k == last) {
    const int slot = fsw[(size_t)(len / JB - 1) * fs_step + 1];
    if (slot > 0) out[(size_t)(slot - 1) * nq * win + q * win + lane] = st.best;
  }
}

template <int R>
int launch_stream(const void* prof, const void* streams, const void* fs,
                  void* out, int lqp, int rows, int len, int win, int nw,
                  int nq, int team, int go, int ge, cudaStream_t stream) {
  constexpr int kThreads = team_threads<R>();
  const size_t smem = profile_bytes(R, team);
  // Above 48 KB a block's dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      sw_stream_kernel<R, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // No more threads than the window's lanes need: a CTA's registers and
  // shared memory stay held until its last warp ends.
  const int need = (win * team + kWarp - 1) / kWarp * kWarp;
  const int threads = need < kThreads ? need : kThreads;
  const int lanes = threads / team;  // lanes per CTA
  const dim3 grid((win + lanes - 1) / lanes, nw, nq);
  sw_stream_kernel<R, false><<<grid, threads, smem, stream>>>(
      (const int32_t*)prof, (const int8_t*)streams, (const int32_t*)fs,
      (int32_t*)out, lqp, rows, len, win, nw, team, go, ge, 1);
  return (int)cudaGetLastError();
}

}  // namespace
