// Smith-Waterman scoring for Hopper, sm_90a: the solo kernel of K1 and K3,
// sw_stream_solo_kernel<R, Q>, for queries of up to 24 rows (the R of
// swa_cuda.STREAM_SOLO_ROWS), and its C entry. Built apart from
// sw_stream.cu, so the two compile in parallel.
//
// Replaces the TPU kernel seqalign_tpu/ops/swa_pallas.py:_kernel_stream +
// _run_block where the query is short: K1 (a 2-D profile) and K3 (a 3-D
// one), with the inputs and per-segment outputs of sw_stream_kernel
// (sw_stream.cuh), bit for bit.
//
// Layout of the work. One thread scores one lane of one window for Q
// queries (Q = 1, 2 or 4, a template argument), each query's R rows in its
// registers; the grid is (lane groups of kSoloThreads, nw, ceil(nq / Q)), z
// slice z holding queries z Q .. z Q + Q - 1. JAX's K3 stacks its batch's
// queries down the rows of one block and cuts the F chain at each query's
// first row (swa_pallas.py:370-379, reset_chain); here the Q queries of a
// thread sit side by side, each with its own chain (row -1 of each is the
// boundary Gg = go, F = 0, so no value crosses from one to the next), its
// own Gg and E rows, column max and best. What they share is the lane: a
// step's chars, loaded once, and the loop. Queries past nq in the last z
// slice score zero profiles and write nothing. K1 is the launch with nq = 1
// and Q = 1.
//
// The step. Positions j0 = 2 s and j0 + 1, as in the team step of
// sw_team.cuh with one thread a team: row -1 is the boundary, so the
// diagonal at row 0 is go at both. The row loop holds the query loop, so
// each row of the unrolled body runs 2 Q independent F chains. At Q = 1 an
// iteration of the hot loop runs two steps (four positions, j0 .. j0 + 3):
// the second's row r waits only on the first's row r, so the two overlap
// down the rows, four F chains skewed by a row. The column max of a step
// starts from the query's best, so the best is the last column max.
//
// Segments. fs is the window's, so every lane of a window starts a segment
// at the same block of 16 positions: once a block, in a branch uniform
// across the CTA, the thread flushes the finished segments' bests of its Q
// queries to out[slot - 1, q, lane] (one writer a slot) and restarts their
// rows from the boundary. The block's 8 steps then run the hot loop, which
// holds a step (two at Q = 1) and the loads of the chars kSoloAhead steps
// ahead, and no vote, reset or flush.
//
// Shared memory. The Q queries' P', row-major, one 128 B x R plane a query:
// every thread reads the same row of a plane at a step, so equal chars
// read one word and other chars other banks. Rows from `rows` on, and
// every row of a query past nq, are 0 (P' = 0 never raises a best).
//
// What bounds it on this card. No DP state goes through device memory; the
// integer work of the step, about 3.5 instructions on the busier pipe and
// one LDS a cell, and the step's own work (its chars' loads and masks, the
// loop), counted together in each instance's loop by phase 2 of
// chip_smoke.py. With one thread a lane, the team kernel spread a step's
// own work (a segment word, a warp vote, a flush test) over the 2 R cells
// of a step, and a thread had 2 F chains in flight; here the step's work is
// smaller and spread over 2 Q R cells, and a thread has 2 Q chains.

#include "sw_team.cuh"

namespace {

// Threads of a CTA, one lane each: small CTAs, so an SM holds as many
// lanes as the instance's registers allow.
constexpr int kSoloThreads = 128;
// Steps whose chars a thread has loaded ahead of the step it runs.
constexpr int kSoloAhead = 2;

// Steps a hot-loop iteration runs: two at Q = 1 (four positions, four F
// chains a thread), one at Q = 2 and 4, which have their 2 Q chains
// already and whose registers two steps would double. On an H100 K1 at
// lq=17 ran 7% faster at two than at one (PERF.md).
template <int Q>
__host__ __device__ constexpr int solo_steps() {
  return Q == 1 ? 2 : 1;
}
constexpr int kNotBuilt = -1;  // launch_solo_rows: no such instance

// What a thread carries from one step to the next, for each of its Q
// queries.
template <int R, int Q>
struct Solo {
  int gg[Q][R], e[Q][R];  // Gg(i, j0 - 1), E(i, j0 - 1)
  int best[Q];            // the current segment's best
};

// One step of the Q queries at positions j0 and j0 + 1, whose chars are
// c0 and c1; sp is the Q planes of P'.
template <int R, int Q>
__device__ __forceinline__ void solo_step(Solo<R, Q>& st, int c0, int c1,
                                          const int32_t* sp, int go, int ge,
                                          int one) {
  const int32_t* p0 = sp + c0;
  const int32_t* p1 = sp + c1;
  int d0[Q], d1[Q];          // the diagonals at j0 and j1
  int up_gg0[Q], up_f0[Q];   // row i - 1 at j0
  int up_gg1[Q], up_f1[Q];   // row i - 1 at j1
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    d0[q] = d1[q] = up_gg0[q] = up_gg1[q] = go;
    up_f0[q] = up_f1[q] = 0;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int at = (q * R + r) * kAlpha;
      // j0.
      const int hp0 = d0[q] * one + p0[at];
      const int e0 = __viaddmax_s32(st.e[q][r], ge, st.gg[q][r]);
      const int f0 = __viaddmax_s32(up_f0[q], ge, up_gg0[q]);
      const int g0 = __vimax3_s32_relu(hp0, e0, f0);
      const int gg0 = g0 + go;
      // j1, one cell behind on the E chain.
      const int hp1 = d1[q] * one + p1[at];
      const int e1 = __viaddmax_s32(e0, ge, gg0);
      const int f1 = __viaddmax_s32(up_f1[q], ge, up_gg1[q]);
      const int g1 = __vimax3_s32_relu(hp1, e1, f1);
      st.best[q] = __vimax3_s32(st.best[q], g0, g1);
      d0[q] = st.gg[q][r];  // Gg(i, j0 - 1), row i + 1's diagonal at j0
      d1[q] = gg0;          // Gg(i, j0), its diagonal at j1
      st.gg[q][r] = g1 + go;
      st.e[q][r] = e1;
      up_gg0[q] = gg0;
      up_f0[q] = f0;
      up_gg1[q] = st.gg[q][r];
      up_f1[q] = f1;
    }
  }
}

// K1 and K3 at one thread a lane: nq queries of lqp rows each, `rows` of
// them scored (at most R); grid (lane groups of kSoloThreads, nw,
// ceil(nq / Q)). The 1 lets ptxas use up to 255 registers a thread.
template <int R, int Q>
__global__ void __launch_bounds__(kSoloThreads, 1) sw_stream_solo_kernel(
    const int32_t* __restrict__ prof,    // (nq, lqp, 32) biased profiles
    const int8_t* __restrict__ streams,  // (nw, L, win) chars 0..31
    const int32_t* __restrict__ fs,      // (L/JB, nw, 2) segment table
    int32_t* __restrict__ out,           // (nslots, nq, win) bests, zeroed
    int lqp, int rows, int len, int win, int nw, int nq, int go, int ge,
    int one) {
  // [q][r][c] = P'[r][c] of query q0 + q.
  __shared__ int32_t sprof[Q * R * kAlpha];
  const int q0 = blockIdx.z * Q;
  const int nqz = min(Q, nq - q0);  // the slice's queries
  for (int idx = threadIdx.x; idx < Q * R * kAlpha; idx += blockDim.x) {
    const int q = idx / (R * kAlpha), row = idx / kAlpha % R;
    sprof[idx] = q < nqz && row < rows
                     ? prof[((size_t)(q0 + q) * lqp + row) * kAlpha +
                            idx % kAlpha]
                     : 0;
  }
  __syncthreads();

  // No thread waits on another from here on: one past the last lane ends.
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= win) return;
  const int w = blockIdx.y;
  const size_t col = (size_t)w * len * win + lane;
  const size_t fs_step = (size_t)nw * 2;  // fs[blk][w] -> fs[blk + 1][w]
  const int32_t* fsw = fs + (size_t)w * 2;
  // Slot s of query q0 + q at o[s * stride + q * win].
  int32_t* o = out + (size_t)q0 * win + lane;
  const size_t stride = (size_t)nq * win;

  Solo<R, Q> st;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      st.gg[q][r] = go;
      st.e[q][r] = 0;
    }
    st.best[q] = 0;
  }
  // A step's chars, read unsigned and masked: never a negative index.
  auto chars = [&](int j0, int& c0, int& c1) {
    const int8_t* c = streams + col + (size_t)j0 * win;
    c0 = (int)(uint8_t)c[0] & (kAlpha - 1);
    c1 = (int)(uint8_t)c[win] & (kAlpha - 1);
  };
  // The chars of the next kSoloAhead steps (len is a multiple of 16, so
  // the first are in the stream), and the next block's fs slot.
  int n0[kSoloAhead], n1[kSoloAhead];
#pragma unroll
  for (int u = 0; u < kSoloAhead; ++u) chars(2 * u, n0[u], n1[u]);
  const int nblk = len / JB;
  constexpr int kSteps = solo_steps<Q>();
  int next = fsw[0];
  for (int blk = 0; blk < nblk; ++blk) {
    // fs is the window's: every lane starts its segments at the same
    // blocks, so this branch is uniform.
    const int slot = next;
    if (blk + 1 < nblk) next = fsw[(size_t)(blk + 1) * fs_step];
    if (slot > 0) {
      // A new segment starts here: flush the finished one, then restart
      // every row from the boundary.
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (q < nqz) o[(size_t)(slot - 1) * stride + q * win] = st.best[q];
        st.best[q] = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          st.gg[q][r] = go;
          st.e[q][r] = 0;
        }
      }
    }
    // The block's JB / 2 steps: the hot loop, kSteps steps an iteration.
#pragma unroll kSteps
    for (int j0 = blk * JB; j0 < (blk + 1) * JB; j0 += 2) {
      const int c0 = n0[0], c1 = n1[0];
#pragma unroll
      for (int u = 0; u + 1 < kSoloAhead; ++u) {
        n0[u] = n0[u + 1];
        n1[u] = n1[u + 1];
      }
      const int ahead = j0 + 2 * kSoloAhead;
      if (ahead < len) chars(ahead, n0[kSoloAhead - 1], n1[kSoloAhead - 1]);
      solo_step<R, Q>(st, c0, c1, sprof, go, ge, one);
    }
  }
  const int slot = fsw[(size_t)(nblk - 1) * fs_step + 1];
  if (slot > 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q < nqz) o[(size_t)(slot - 1) * stride + q * win] = st.best[q];
    }
  }
}

template <int R, int Q>
int launch_solo(const void* prof, const void* streams, const void* fs,
                void* out, int lqp, int rows, int len, int win, int nw, int nq,
                int go, int ge, cudaStream_t stream) {
  // No more threads than the window's lanes need.
  const int need = (win + kWarp - 1) / kWarp * kWarp;
  const int threads = need < kSoloThreads ? need : kSoloThreads;
  const dim3 grid((win + threads - 1) / threads, nw, (nq + Q - 1) / Q);
  sw_stream_solo_kernel<R, Q><<<grid, threads, 0, stream>>>(
      (const int32_t*)prof, (const int8_t*)streams, (const int32_t*)fs,
      (int32_t*)out, lqp, rows, len, win, nw, nq, go, ge, 1);
  return (int)cudaGetLastError();
}

// The (R, Q) instances built: R of swa_cuda.STREAM_SOLO_ROWS, Q of
// swa_cuda.STREAM_SOLO_QUERIES, the Q the chooser can pick at R (phase 2 of
// chip_smoke.py requires each).
#define SW_SOLO_INSTANCES(X) \
  X(10, 1)                   \
  X(10, 2)                   \
  X(10, 4)                   \
  X(12, 1)                   \
  X(12, 2)                   \
  X(16, 1)                   \
  X(18, 1)                   \
  X(18, 2)                   \
  X(18, 4)                   \
  X(20, 1)                   \
  X(20, 2)                   \
  X(20, 4)                   \
  X(24, 1)

int launch_solo_rows(const void* prof, const void* streams, const void* fs,
                     void* out, int lqp, int rows, int len, int win, int nw,
                     int nq, int go, int ge, int rows_per_thread, int queries,
                     cudaStream_t stream) {
#define SW_SOLO_CASE(R, Q)                                                  \
  if (rows_per_thread == R && queries == Q) {                               \
    return launch_solo<R, Q>(prof, streams, fs, out, lqp, rows, len, win, \
                             nw, nq, go, ge, stream);                       \
  }
  SW_SOLO_INSTANCES(SW_SOLO_CASE)
#undef SW_SOLO_CASE
  return kNotBuilt;
}

}  // namespace

extern "C" {

// Launch K1 (nq = 1) or K3 at one thread a lane, Q = queries a thread, on
// `stream`; returns the CUDA error code (0 = launched). The arguments are
// sw_stream_launch's, with rows <= rows_per_thread: rows_per_thread and
// queries one of the (R, Q) built (swa_cuda.STREAM_SOLO_QUERIES); any
// other is refused.
int sw_stream_solo_launch(const void* prof, const void* streams,
                          const void* fs, void* out, int lqp, int rows,
                          int len, int win, int nw, int nq, int jb, int go,
                          int ge, int rows_per_thread, int queries,
                          void* stream) {
  if (rows < 0 || rows > lqp || rows > rows_per_thread || win <= 0 ||
      nw <= 0 || nw > 65535 || nq <= 0 || nq > 65535 || len <= 0 || jb != JB ||
      len % JB) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = launch_solo_rows(prof, streams, fs, out, lqp, rows, len, win,
                                   nw, nq, go, ge, rows_per_thread, queries,
                                   (cudaStream_t)stream);
  return err == kNotBuilt ? (int)cudaErrorInvalidValue : err;
}

}  // extern "C"
