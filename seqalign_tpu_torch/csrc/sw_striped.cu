// Smith-Waterman scoring for Hopper, sm_90a: one row stripe of a long query
// against segmented window streams (K2), one warp per database lane with the
// stripe's query rows held in registers.
//
// Replaces the TPU kernel seqalign_tpu/ops/swa_pallas.py:
// _kernel_stream_striped + _run_block(bnd=...), called through
// _stream_striped_pass and driven by sw_pallas_stream_striped: the G-form
// affine-gap recurrence of sw_stream.cuh over the same inputs (biased stripe
// P' = P - go, NW window streams, segment table fs), with row -1 read from
// the previous stripe's boundary, the stripe's last row written as the next
// one's, and the same per-segment outputs, bit for bit.
//
// Its block instance (sw_striped_block_kernel, below) runs the same team
// step over blocks of positions [j0, j1) with each pass's left column
// carried in and out, every (sub-pass, block) task of one pipeline step in
// one launch: the work of one device at one step of the JAX package's
// sequence-parallel long pair (seqalign_tpu/parallel/longpair.py, whose
// lax.scan over a block's columns and rows it replaces).
//
// Layout of the work. A team of 32 threads (one warp) scores one lane of
// one window, thread k holding the R rows k R .. k R + R - 1 of the pass in
// registers (the team step of sw_team.cuh). Thread 0 reads row -1 from
// bnd_in (Gg = go, F = 0 on the first pass); the last thread with rows
// writes bnd_out and keeps the segment's best. Chars, fs and bnd_in are
// loaded 32 steps at a time, one step per thread, and passed to thread 0 by
// __shfl_sync. One pass covers 32 R rows; a shorter pass gives the threads
// past its last row P' = 0 rows, which never raise a best (H' <= G_diag
// there), and they write nothing.
//
// Shared memory. The pass's P' as sw_team.cuh lays it out, thread k's
// row r of char c at word (c R + r) 32 + k. 4 KiB x R per CTA.
//
// What bounds it on this card. No rolling rows go through device memory:
// the only state kept there is the pass boundary, 16 B per position per pass
// (16 / (32 R) B per cell), against the 1 B per cell of K4's rolling rows
// (sw_windows.cu). A warp-per-lane grid gives 32 threads per lane, so at
// Swiss-Prot scale (253 windows of 256 lanes) the card holds as many warps as
// registers (2 R of state a thread) and the shared profile allow. What is
// left is the integer work, about 5.5 instructions and one LDS per cell
// plus the step's shuffles and bookkeeping over 2 R cells, on two pipes:
// the max and add-max work on the ALU pipe, H' as an IMAD on the FMA pipe
// beside it. The ALU pipe's share, about 5.0 per cell at R = 32, is the
// bound; the shuffles take the shared-memory path with the LDS, about 1.2
// per cell at half the ALU pipe's rate, which is less.

#include "sw_team.cuh"

namespace {

constexpr int kTeam = kWarp;  // threads per lane: one warp

// Lanes (warps) per CTA. The shared profile of 4 KiB x R leaves one or two
// CTAs per SM from R = 24 up, so those CTAs take 16 warps.
template <int R>
__host__ __device__ constexpr int team_warps() {
  return R >= 24 ? 16 : 8;
}

// K2: one pass of 32 R rows; grid (lane groups of team_warps<R>(), nw).
// kIn reads row -1 from bnd_in, kOut writes the pass's last row to bnd_out,
// kPartial takes that row from inside the last thread (lqp % R != 0).
template <int R, bool kIn, bool kOut, bool kPartial>
__global__ void __launch_bounds__(team_warps<R>() * kTeam)
    sw_stream_striped_kernel(
        const int32_t* __restrict__ prof,    // (lqp, 32), lqp <= 32 R
        const int8_t* __restrict__ streams,  // (nw, L, win) chars 0..31
        const int32_t* __restrict__ fs,      // (L/JB, nw, 2) segment table
        int32_t* __restrict__ out,           // (nslots, win) bests, zeroed
        const int32_t* __restrict__ bnd_in,  // (2, nw, L, win)
        int32_t* __restrict__ bnd_out,       // (2, nw, L, win)
        int lqp, int len, int win, int nw, int go, int ge, int one) {
  static_assert(R % kRowAlign == 0, "a thread holds whole row groups");
  constexpr int kWarps = team_warps<R>();
  extern __shared__ int32_t sprof[];  // [c][r][k] = P'[k R + r][c]
  // Consecutive threads write consecutive banks (k fastest).
  for (int idx = threadIdx.x; idx < kAlpha * R * kTeam; idx += blockDim.x) {
    const int k = idx % kTeam;
    const int r = (idx / kTeam) % R;
    const int c = idx / (kTeam * R);
    const int row = k * R + r;
    sprof[idx] = row < lqp ? prof[row * kAlpha + c] : 0;
  }
  __syncthreads();

  const int k = threadIdx.x % kTeam;
  const int lane = blockIdx.x * kWarps + threadIdx.x / kTeam;
  if (lane >= win) return;  // the whole warp
  const int w = blockIdx.y;
  // (w, position 0, lane) of the streams and of each boundary plane.
  const size_t col = (size_t)w * len * win + lane;
  const size_t plane = (size_t)nw * len * win;
  const int last = min(kTeam - 1, (lqp - 1) / R);  // last thread with rows
  const Pass ps{sprof + k, out, bnd_out + col, plane, k, last,
                lqp - 1 - last * R, len, win, lane, go, ge, one};
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
  const int nsteps = len / 2 + last;
  for (int s0 = 0; s0 < nsteps; s0 += kTeam) {
    // Thread 0's steps s0 .. s0 + 31, one per lane: positions j0 and j1.
    Block b{0, go, 0, go, 0};
    {
      const int j0 = 2 * (s0 + k);
      if (j0 < len) {
        // Read the chars unsigned and mask them: never a negative index.
        const int8_t* c = streams + col + (size_t)j0 * win;
        const int c0 = (int)(uint8_t)c[0] & (kAlpha - 1);
        const int c1 = (int)(uint8_t)c[win] & (kAlpha - 1);
        const int slot = j0 % JB == 0 ? fsw[(size_t)(j0 / JB) * fs_step] : 0;
        b.word = c0 | (j0 == 0 || slot > 0 ? kFreshBit : 0) |
                 (c1 << kChar1Shift) | (slot << kSlotShift);
        if constexpr (kIn) {
          const int32_t* bi = bnd_in + col + (size_t)j0 * win;
          b.gg0 = bi[0];
          b.f0 = bi[plane];
          b.gg1 = bi[win];
          b.f1 = bi[plane + win];
        }
      }
    }
    // The steps at which no thread of the warp starts a segment run the
    // hot loop; a segment starts at one thread's position in at most one
    // step of 8, and that step leaves the loop to reset.
    int t = 0;
    while (true) {
#pragma unroll 1
      for (; t < kTeam; ++t) {
        const Input in = receive<kIn, R, kTeam>(st, ps, t, b, kTeam);
        if (__any_sync(kFull, in.word & kFreshBit)) break;
        team_step<R, kOut, kPartial, false>(st, in, ps, 2 * (s0 + t - k));
      }
      if (t == kTeam) break;
      team_step<R, kOut, kPartial, true>(
          st, receive<kIn, R, kTeam>(st, ps, t, b, kTeam), ps,
          2 * (s0 + t - k));
      ++t;
    }
  }
  if (k == last) {
    const int slot = fsw[(size_t)(len / JB - 1) * fs_step + 1];
    if (slot > 0) out[(size_t)(slot - 1) * win + lane] = st.best;
  }
}

template <int R, bool kIn, bool kOut, bool kPartial>
int launch_team(const void* prof, const void* streams, const void* fs,
                void* out, const void* bnd_in, void* bnd_out, int lqp,
                int len, int win, int nw, int go, int ge,
                cudaStream_t stream) {
  constexpr int kWarps = team_warps<R>();
  const size_t smem = (size_t)kAlpha * R * kTeam * sizeof(int32_t);
  // Above 48 KB a block's dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      sw_stream_striped_kernel<R, kIn, kOut, kPartial>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((win + kWarps - 1) / kWarps, nw);
  sw_stream_striped_kernel<R, kIn, kOut, kPartial>
      <<<grid, kWarps * kTeam, smem, stream>>>(
          (const int32_t*)prof, (const int8_t*)streams, (const int32_t*)fs,
          (int32_t*)out, (const int32_t*)bnd_in, (int32_t*)bnd_out, lqp, len,
          win, nw, go, ge, 1);
  return (int)cudaGetLastError();
}

template <int R>
int launch_rows(const void* prof, const void* streams, const void* fs,
                void* out, const void* bnd_in, void* bnd_out, int lqp,
                int len, int win, int nw, int go, int ge, cudaStream_t s) {
  // The last row sits inside the last thread: only a pass that writes it
  // needs the instance that picks it out.
  const bool partial = lqp % R != 0;
  if (bnd_in && bnd_out) {
    return partial ? launch_team<R, true, true, true>(
                         prof, streams, fs, out, bnd_in, bnd_out, lqp, len,
                         win, nw, go, ge, s)
                   : launch_team<R, true, true, false>(
                         prof, streams, fs, out, bnd_in, bnd_out, lqp, len,
                         win, nw, go, ge, s);
  }
  if (bnd_in) {
    return launch_team<R, true, false, false>(
        prof, streams, fs, out, bnd_in, bnd_out, lqp, len, win, nw, go, ge, s);
  }
  return partial ? launch_team<R, false, true, true>(
                       prof, streams, fs, out, bnd_in, bnd_out, lqp, len, win,
                       nw, go, ge, s)
                 : launch_team<R, false, true, false>(
                       prof, streams, fs, out, bnd_in, bnd_out, lqp, len, win,
                       nw, go, ge, s);
}

// K2's block instance (sw_longpair): one launch runs a step of the long
// pair's pipeline, every task of the step a z slice of the grid. A task is
// one block of positions [j0, j1) of every window of one sub-pass (at most
// 32 R rows of the query), each lane one sequence from position 0 (no
// segment table). Each row's (Gg, E) at j0 - 1 comes from left_in (NULL:
// the boundary Gg = go, E = 0) and goes out at j1 - 1 to left_out; left_out
// may be left_in, since each thread reads its rows' words before any step
// and writes the same words after the last. Row -1 comes from bnd_in
// inside [j0, j1) and its corner Gg(-1, j0 - 1) from bnd_in at j0 - 1
// (NULL: the boundary, Gg = go, F = 0, and the corner go); the last row goes
// to bnd_out inside [j0, j1). Each lane's best over the block is max-merged
// into best (nw, win) with atomicMax, so no elementwise launch follows.
//
// The task table. A task is 64 bytes on the device (BlockTask), built once
// a sw_longpair call by the host (swa_cuda.BlockTable) and read by every
// CTA of its z slice. The instance (R, kOut, kPartial) is one per launch:
// the host launches each run of tasks of one instance, so a step of one
// entry is one launch, or two where its last sub-pass needs another R or
// writes no boundary. Row -1 is a run-time choice per task: without bnd_in
// thread 0 shuffles the boundary values, which the kIn instance's step loop
// does anyway, so the first sub-pass of the first entry shares the others'
// instance and launch.
//
// Why no two tasks of a launch touch the same word. At step t, stage sigma
// (the sub-passes of the entries before, plus p) runs block b = t - sigma,
// so one entry's tasks (p, b) of a step lie on one anti-diagonal, p + b
// constant: one task per sub-pass, each on another block.
//   - (p, b) writes inner[p] (or the entry's edge out) at [j0, j1) of block
//     b, left[p], and best through atomicMax. No other task of the step has
//     sub-pass p, so left[p] and inner[p] have one writer.
//   - It reads inner[p - 1] (or the edge in) at [j0 - 1, j1): written at
//     step t - 1 by (p - 1, b) inside the block and at step t - 2 by
//     (p - 1, b - 1) at j0 - 1. The task of this step on inner[p - 1],
//     (p - 1, b + 1), writes only block b + 1, past j1 - 1.
//   - It reads left[p], written at step t - 1 by (p, b - 1).
// Launches of one entry run in order on its stream; entry k waits on entry
// k - 1's event of step t - 1 before it copies block t - sigma_k of the edge.
//
// Lane ends. With ends, a lane runs only up to its end (1 + its last
// position holding a char other than '*'), rounded up to a step's two: a
// CTA none of whose lanes reaches j0 returns before it copies the profile,
// a warp whose lane does not reach it returns after the copy and writes
// nothing (no bnd_out, no left_out, no atomicMax), and a live warp runs n =
// min(j1 - j0, round_up_2(end - j0)) positions, writes bnd_out only inside
// [j0, j0 + n) and, where n < j1 - j0, no left_out. Why the words left
// unwritten are never read:
//   - A lane dead at block b (end <= j0) is dead at every later block.
//   - Task (p + 1, b) reads bnd_in of a lane at [j0, j0 + n): task (p, b)
//     has the same lane, j0 and end, so the same n, and wrote exactly
//     those words.
//   - Its corner at j0 - 1 and its left column come from block b - 1,
//     which ran to its last position, since end > j0.
//   - The edge copies between entries may carry unwritten words; no task
//     reads them.
// The cells skipped cannot raise a best: they lie past the lane's last
// residue, every '*' score is at most 0 and ge <= 0, so no path through
// them ends higher than where it left the record. The caller passes ends
// only then (parallel/longpair.py); supported_scoring refuses ge > 0.
//
// Thread k runs step s at position j0 + 2 (s - k), and only while that lies
// in the block: the steps before (the warp's fill) and after (its drain)
// skip the team step, so the carried column is loaded before thread k's
// first position and stored after its last. Thread k's diagonal at j0 is
// row k R - 1 of left_in, the last row of thread k - 1, which passes it
// down the warp; thread 0's is the corner. No step carries a fresh bit or a
// slot.
//
// The left column's layout. Row k R + r of lane l of window w is word
// ((r nw + w) win + l) 32 + k of a plane, (Gg, E) two planes: (2, R, nw,
// win, 32). The 32 threads of a warp load and store 32 consecutive words
// for each r, one 128-byte line, where a row-major column put them R win
// words apart.
//
// The profile. The host lays each sub-pass's biased rows out as shared
// memory holds them (swa_cuda.team_profile: [c][r][k] = P'[k R + r][c], 0
// past lqp), so a CTA loads its 4 KiB x R with one coalesced copy of 16
// bytes a thread: a CTA scores only one block, so a gather from the rows'
// own layout, 32 sectors a warp's load, would cost it about as much L2
// traffic as its whole block.
struct BlockTask {
  const int32_t* prof;     // (32, R, 32) biased rows, the shared layout
  const int32_t* bnd_in;   // (2, nw, len, win) or NULL
  int32_t* bnd_out;        // (2, nw, len, win); read where kOut only
  const int32_t* left_in;  // (2, R, nw, win, 32) or NULL
  int32_t* left_out;       // (2, R, nw, win, 32) or NULL
  int32_t lqp, j0;         // lqp a multiple of 4, at most 32 R
  int32_t j1, unused;      // multiples of JB, 0 <= j0 < j1 <= len
  int64_t pad;             // 64 bytes a task
};
static_assert(sizeof(BlockTask) == 64, "swa_cuda.BLOCK_TASK_WORDS x 8 bytes");

template <int R, bool kOut, bool kPartial>
__global__ void __launch_bounds__(team_warps<R>() * kTeam)
    sw_striped_block_kernel(
        const BlockTask* __restrict__ tasks,  // one per z slice
        const int8_t* __restrict__ streams,   // (nw, L, win) chars 0..31
        const int32_t* __restrict__ ends,     // (nw, win) lane ends, or NULL
        int32_t* __restrict__ best,           // (nw, win), max-merged
        int len, int win, int nw, int go, int ge, int one) {
  static_assert(R % kRowAlign == 0, "a thread holds whole row groups");
  constexpr int kWarps = team_warps<R>();
  const BlockTask& task = tasks[blockIdx.z];
  const int j0 = task.j0;
  const int k = threadIdx.x % kTeam;
  const int lane = blockIdx.x * kWarps + threadIdx.x / kTeam;
  const int w = blockIdx.y;
  // The lane's end: 0 past the window's lanes, len without ends.
  const int end = lane >= win       ? 0
                  : ends == nullptr ? len
                                    : ends[(size_t)w * win + lane];
  if (!__syncthreads_or(j0 < end)) return;  // a dead CTA: no lane reaches j0
  const int lqp = task.lqp;
  extern __shared__ int4 sprof4[];  // [c][r][k] = P'[k R + r][c]
  const int4* prof4 = reinterpret_cast<const int4*>(task.prof);
  for (int idx = threadIdx.x; idx < kAlpha * R * kTeam / 4; idx += blockDim.x) {
    sprof4[idx] = prof4[idx];
  }
  __syncthreads();
  const int32_t* sprof = reinterpret_cast<const int32_t*>(sprof4);
  if (j0 >= end) return;  // a dead warp (lanes past win too): writes nothing

  const size_t col = (size_t)w * len * win + lane;
  const size_t plane = (size_t)nw * len * win;
  // Thread k's row k R + r of the left column; r + 1 is lrow words on.
  const size_t lcol = ((size_t)w * win + lane) * kTeam + k;
  const size_t lrow = (size_t)nw * win * kTeam;
  const size_t lplane = lrow * R;
  // The lane's positions of the block: up to its end, rounded up to a
  // step's two.
  const int n = min(task.j1 - j0, (end - j0 + 1) & ~1);
  // A lane that stops inside the block is dead at the next: no task reads
  // its left column. The warp's vote (one lane, so one value) keeps a flag
  // across the DP loop where the compiler would keep both lengths: at R = 8
  // without a boundary out they spilled.
  const bool whole = __all_sync(kFull, n == task.j1 - j0);
  const int32_t* bnd_in = task.bnd_in;
  const int32_t* left_in = task.left_in;
  const int last = min(kTeam - 1, (lqp - 1) / R);
  const Pass ps{sprof + k, best,
                kOut ? task.bnd_out + col + (size_t)j0 * win : nullptr, plane,
                k, last, lqp - 1 - last * R, n, win, lane, go, ge, one};

  Team<R> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool carried = left_in != nullptr && k * R + r < lqp;
    st.gg[r] = carried ? left_in[lcol + r * lrow] : go;
    st.e[r] = carried ? left_in[lplane + lcol + r * lrow] : 0;
  }
  st.o_gg0 = st.o_gg1 = go;
  st.o_f0 = st.o_f1 = st.o_word = st.o_cm = 0;
  const int above = __shfl_up_sync(kFull, st.gg[R - 1], 1);
  st.diag = k > 0 ? above
                  : (bnd_in != nullptr && j0 > 0
                         ? bnd_in[col + (size_t)(j0 - 1) * win]
                         : go);
  st.best = 0;
  const int nsteps = n / 2 + last;
  for (int s0 = 0; s0 < nsteps; s0 += kTeam) {
    // Thread 0's steps s0 .. s0 + 31, one per lane; without bnd_in, row -1
    // keeps the boundary the block starts with.
    Block b{0, go, 0, go, 0};
    {
      const int jr = 2 * (s0 + k);
      if (jr < n) {
        const int8_t* c = streams + col + (size_t)(j0 + jr) * win;
        b.word = ((int)(uint8_t)c[0] & (kAlpha - 1)) |
                 (((int)(uint8_t)c[win] & (kAlpha - 1)) << kChar1Shift);
        if (bnd_in != nullptr) {
          const int32_t* bi = bnd_in + col + (size_t)(j0 + jr) * win;
          b.gg0 = bi[0];
          b.f0 = bi[plane];
          b.gg1 = bi[win];
          b.f1 = bi[plane + win];
        }
      }
    }
    const int tn = min(kTeam, nsteps - s0);
#pragma unroll 1
    for (int t = 0; t < tn; ++t) {
      const Input in = receive<true, R, kTeam>(st, ps, t, b, kTeam);
      const int j = 2 * (s0 + t - k);
      if ((unsigned)j < (unsigned)n) {
        team_step<R, kOut, kPartial, false>(st, in, ps, j);
      }
    }
  }
  int32_t* left_out = task.left_out;
  if (left_out != nullptr && whole) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (k * R + r < lqp) {
        left_out[lcol + r * lrow] = st.gg[r];
        left_out[lplane + lcol + r * lrow] = st.e[r];
      }
    }
  }
  if (k == last) atomicMax(best + (size_t)w * win + lane, st.best);
}

template <int R, bool kOut, bool kPartial>
int launch_block(const void* tasks, int count, const void* streams,
                 const void* ends, void* best, int len, int win, int nw,
                 int go, int ge, cudaStream_t stream) {
  constexpr int kWarps = team_warps<R>();
  const size_t smem = (size_t)kAlpha * R * kTeam * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sw_striped_block_kernel<R, kOut, kPartial>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((win + kWarps - 1) / kWarps, nw, count);
  sw_striped_block_kernel<R, kOut, kPartial>
      <<<grid, kWarps * kTeam, smem, stream>>>(
          (const BlockTask*)tasks, (const int8_t*)streams,
          (const int32_t*)ends, (int32_t*)best, len, win, nw, go, ge, 1);
  return (int)cudaGetLastError();
}

template <int R>
int launch_block_rows(const void* tasks, int count, const void* streams,
                      const void* ends, void* best, int len, int win, int nw,
                      int go, int ge, bool out, bool partial,
                      cudaStream_t s) {
  if (!out) {
    return launch_block<R, false, false>(tasks, count, streams, ends, best,
                                         len, win, nw, go, ge, s);
  }
  return partial ? launch_block<R, true, true>(tasks, count, streams, ends,
                                               best, len, win, nw, go, ge, s)
                 : launch_block<R, true, false>(tasks, count, streams, ends,
                                                best, len, win, nw, go, ge, s);
}

}  // namespace

extern "C" {

// Launch one K2 pass on `stream`; returns the CUDA error code (0 =
// launched). prof (lqp, 32) biased, lqp a positive multiple of 4 and at most
// 32 x rows_per_thread (8, 16, 24 or 32, the instances built); out (nslots,
// win) zeroed; bnd_in (the previous stripe's last row, NULL for the first
// stripe) and bnd_out (this stripe's last row, NULL for the last), each (2,
// nw, L, win). A pass with neither is a one-stripe query, K1's work:
// refused. `jb` must be the JB the kernel is built for.
int sw_stream_striped_launch(const void* prof, const void* streams,
                             const void* fs, void* out, const void* bnd_in,
                             void* bnd_out, int lqp, int len, int win, int nw,
                             int jb, int go, int ge, int rows_per_thread,
                             void* stream) {
  if (lqp <= 0 || lqp % kRowAlign || lqp > kTeam * rows_per_thread ||
      win <= 0 || nw <= 0 || nw > 65535 || len <= 0 || jb != JB ||
      len % JB || (!bnd_in && !bnd_out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows_per_thread) {
    case 8:
      return launch_rows<8>(prof, streams, fs, out, bnd_in, bnd_out, lqp, len,
                            win, nw, go, ge, s);
    case 16:
      return launch_rows<16>(prof, streams, fs, out, bnd_in, bnd_out, lqp,
                             len, win, nw, go, ge, s);
    case 24:
      return launch_rows<24>(prof, streams, fs, out, bnd_in, bnd_out, lqp,
                             len, win, nw, go, ge, s);
    case 32:
      return launch_rows<32>(prof, streams, fs, out, bnd_in, bnd_out, lqp,
                             len, win, nw, go, ge, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// Launch `count` tasks of K2's block instance on `stream`, one z slice of
// the grid each (sw_striped_block_kernel); returns the CUDA error code (0 =
// launched). tasks: `count` BlockTasks on the device, each checked by the
// caller (swa_cuda.BlockTable): prof (lqp, 32) biased, lqp a positive
// multiple of 4 and at most 32 x rows_per_thread (8, 16, 24 or 32, the
// instances built); bnd_in, bnd_out (2, nw, len, win), bnd_out not NULL
// where `out`; left_in, left_out (2, rows_per_thread, nw, win, 32); 0 <= j0
// < j1 <= len, multiples of the JB the kernel is built for; `partial` where
// each task's lqp is not a multiple of rows_per_thread (then `out`).
// streams (nw, len, win); ends (nw, win), each lane's end (1 + its last
// position holding a char other than '*', 0 for none), or NULL to run every
// position: exact only where every '*' score and ge are at most 0 (the
// caller's check); best (nw, win), max-merged.
int sw_striped_block_launch(const void* tasks, int count, const void* streams,
                            const void* ends, void* best, int len, int win,
                            int nw, int go, int ge, int rows_per_thread,
                            int out, int partial, void* stream) {
  if (!tasks || count <= 0 || count > 65535 || win <= 0 || nw <= 0 ||
      nw > 65535 || len <= 0 || len % JB || (partial && !out) ||
      (ends && ge > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows_per_thread) {
    case 8:
      return launch_block_rows<8>(tasks, count, streams, ends, best, len, win,
                                  nw, go, ge, out, partial, s);
    case 16:
      return launch_block_rows<16>(tasks, count, streams, ends, best, len, win,
                                   nw, go, ge, out, partial, s);
    case 24:
      return launch_block_rows<24>(tasks, count, streams, ends, best, len, win,
                                   nw, go, ge, out, partial, s);
    case 32:
      return launch_block_rows<32>(tasks, count, streams, ends, best, len, win,
                                   nw, go, ge, out, partial, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
