// The team step of the Smith-Waterman kernels that keep a lane's query rows
// in registers: K2, the row stripes of a long query (sw_striped.cu), the
// one-pass kernel of K1 and K3 (sw_stream.cuh), and the fixed-batch kernel
// of K4 and K5 (sw_windows.cuh).
//
// A team of threads scores one lane of one window; thread k holds the R
// consecutive rows k R .. k R + R - 1, and their Gg(i, j - 1) and
// E(i, j - 1) stay in its registers for the whole stream. The lane's
// positions flow through the team as a systolic pipeline, two a step: at
// step s thread k computes positions j0 = 2 (s - k) and j0 + 1 for its R
// rows, taking from thread k - 1 (__shfl_up_sync) row k R - 1's (Gg, F) at
// both, the step's chars and segment word, and the column's running max of
// G, and handing its own last row's to thread k + 1 at the next step. The
// two positions' F chains run side by side down the rows, so one waits on
// the other's latency less. Thread 0 takes row -1 and the step's word from
// the block its team loaded (one step per thread, passed by __shfl_sync).
// K2's team is a warp; the one-pass kernel's is 1 to 32 threads, a power of
// two, so a warp holds 32 / T teams and every shuffle names the team's
// width.
//
// Segments. fs can start a segment every 16 positions, so two or three
// segments are in flight in one team. Each thread resets at its own
// position (Gg = go and E = 0 for its rows, its diagonal to go), never the
// whole team; row -1 is not reset (the boundary at a segment start already
// belongs to the new sequence). A warp takes the reset out of its hot loop,
// as a cold step, when any of its threads starts a segment: every team of
// the warp takes that step together. The best travels with its position as
// the column max, and only the team's last thread with rows flushes it, to
// slot fs - 1, so each slot has one writer.
//
// The profile. The kernels hold P' in shared memory as 32 columns, one per
// thread of a warp: the word of row r of char c in column j sits at
// (c R + r) 32 + j, so the thread index picks the bank and a warp whose
// threads read different rows and chars has no conflicts. 4 KiB x R per
// CTA. Where every thread of a warp reads the same row (teams of one
// thread), the one-pass kernel keeps P' row-major instead, word r 32 + c,
// 128 B x R: equal chars read one word, others other banks. The step reads
// row r of char c at pk[c cs + r 32] (cs = R 32 for the columns, 1
// row-major). H' is d * one + P' (one a kernel argument equal to 1, which the
// compiler cannot see), so that it issues as an IMAD on the FMA pipe, off
// the ALU pipe that takes the max and add-max work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlpha = 32;
constexpr int kWarp = 32;     // threads of a warp; columns of the profile
constexpr int kRowAlign = 4;  // convert.ROW_ALIGN: a pass's rows are a multiple
constexpr int JB = 16;        // positions per fs block (swa_cuda.STREAM_JB)
constexpr unsigned kFull = 0xffffffffu;

// A step covers two positions, j0 = 2 (s - k) and j1 = j0 + 1: the F
// chains of the two run side by side down a thread's rows. Segments start
// on multiples of 16, so only j0 may start one and both positions always
// belong to one segment. The segment word of a step: j0's char in bits
// 0-4, bit 5 set where a segment starts at j0 (position 0 included), j1's
// char in bits 6-10, the fs slot to flush in bits 11-30 (the wrappers keep
// slots below 2^20, so the word stays positive).
constexpr int kFreshBit = 1 << 5;
constexpr int kChar1Shift = 6;
constexpr int kSlotShift = 11;

// What a thread carries from one step to the next.
template <int R>
struct Team {
  int gg[R], e[R];  // Gg(i, j0 - 1), E(i, j0 - 1) of this thread's rows
  // What it hands thread k + 1: its last row's Gg and F at j0 and j1, the
  // segment word and the column max over both, from the step before.
  int o_gg0, o_f0, o_gg1, o_f1, o_word, o_cm;
  int diag;  // Gg(k R - 1, j0 - 1)
  int best;  // the last thread: the current segment's best
};

// What thread k takes in at a step: row k R - 1's Gg and F at j0 and j1,
// the step's segment word and the column max so far.
struct Input {
  int gg0, f0, gg1, f1, word, cm;
};

// The constants of a thread's pass.
struct Pass {
  const int32_t* pk;  // its column of the shared profile
  int32_t* out;       // the bests: slot s of this lane at out[s * stride + col]
  int32_t* bo;        // K2's bnd_out Gg at (w, position 0, lane); F a plane on
  size_t plane;
  // stride: out's slot stride and bo's position stride (win; nq x win for
  // the one-pass kernel's several queries). col: this lane's column of out.
  int k, last, rlast, len, stride, col, go, ge;
  // 1, which the compiler cannot see: d * one + P' issues as an IMAD.
  int one;
  int cs;  // the profile's char stride where team_step's kCS is 0
};

// Row -1 and the segment word of thread 0's steps, one step per thread.
struct Block {
  int word, gg0, f0, gg1, f1;
};

// __shfl_up_sync / __shfl_sync within a team: a warp (kWidth = kWarp), or
// `width` threads, a power of two fixed at launch (kWidth = 0).
template <int kWidth>
__device__ __forceinline__ int shfl_up(int v, int width) {
  if constexpr (kWidth == kWarp) {
    return __shfl_up_sync(kFull, v, 1);
  } else {
    return __shfl_up_sync(kFull, v, 1, width);
  }
}

template <int kWidth>
__device__ __forceinline__ int shfl(int v, int src, int width) {
  if constexpr (kWidth == kWarp) {
    return __shfl_sync(kFull, v, src);
  } else {
    return __shfl_sync(kFull, v, src, width);
  }
}

// Thread k - 1's outputs of the step before; thread 0 takes row -1 and the
// step's word from the block (step t of it), and starts the column max at
// 0 (a pass's bests are over its own rows). kIn: row -1 comes from the
// block (K2's bnd_in), else it is the boundary Gg = go, F = 0.
template <bool kIn, int R, int kWidth>
__device__ __forceinline__ Input receive(const Team<R>& st, const Pass& ps,
                                         int t, const Block& b, int width) {
  Input in;
  in.gg0 = shfl_up<kWidth>(st.o_gg0, width);
  in.f0 = shfl_up<kWidth>(st.o_f0, width);
  in.gg1 = shfl_up<kWidth>(st.o_gg1, width);
  in.f1 = shfl_up<kWidth>(st.o_f1, width);
  in.word = shfl_up<kWidth>(st.o_word, width);
  in.cm = shfl_up<kWidth>(st.o_cm, width);
  const int t_word = shfl<kWidth>(b.word, t, width);
  int t_gg0 = ps.go, t_f0 = 0, t_gg1 = ps.go, t_f1 = 0;
  if constexpr (kIn) {
    t_gg0 = shfl<kWidth>(b.gg0, t, width);
    t_f0 = shfl<kWidth>(b.f0, t, width);
    t_gg1 = shfl<kWidth>(b.gg1, t, width);
    t_f1 = shfl<kWidth>(b.f1, t, width);
  }
  if (ps.k == 0) {
    in.gg0 = t_gg0;
    in.f0 = t_f0;
    in.gg1 = t_gg1;
    in.f1 = t_f1;
    in.word = t_word;
    in.cm = 0;
  }
  return in;
}

// The S = P'[i][c] of K5 (sw_windows.cu with kConstS): a constant on every
// row and position.
constexpr int kConstScore = 7;

// One step: this thread's R rows at j0 and at j1. kReset: some thread of
// the warp starts a segment at this step (the rare, cold path). kOut writes
// the last row to K2's bnd_out; kPartial takes that row from inside the
// last thread. kCS: the profile's char stride, or 0 for the pass's ps.cs.
// kConstS (K5): S = kConstScore in place of the profile gather, and the
// column max stops at row ps.rlast, the thread's last real row, since a
// constant row past the query's would raise it where a P' = 0 row does not.
template <int R, bool kOut, bool kPartial, bool kReset, int kCS = R * kWarp,
          bool kConstS = false>
__device__ __forceinline__ void team_step(Team<R>& st, const Input& in,
                                          const Pass& ps, int j0) {
  int d0 = st.diag;  // Gg(i - 1, j0 - 1), the diagonal at j0
  int d1 = in.gg0;   // Gg(i - 1, j0), the diagonal at j1
  st.diag = in.gg1;
  if constexpr (kReset) {
    if (in.word & kFreshBit) {
      // This thread's rows and its diagonal at j0 restart from the
      // boundary; row -1 does not.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st.gg[r] = ps.go;
        st.e[r] = 0;
      }
      d0 = ps.go;
    }
  }
  const int cs = kCS ? kCS : ps.cs;
  const int32_t* p0 = ps.pk + (in.word & (kAlpha - 1)) * cs;
  const int32_t* p1 = ps.pk + ((in.word >> kChar1Shift) & (kAlpha - 1)) * cs;
  int up_gg0 = in.gg0, up_f0 = in.f0;  // row i - 1 at j0
  int up_gg1 = in.gg1, up_f1 = in.f1;  // row i - 1 at j1
  int cm = in.cm;
  int cm_rows = in.cm;  // kConstS: the column max down to row ps.rlast
  int last_gg0 = 0, last_f0 = 0, last_gg1 = 0, last_f1 = 0;  // kPartial
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // j0.
    const int hp0 = d0 * ps.one + (kConstS ? kConstScore : p0[r * kWarp]);
    const int e0 = __viaddmax_s32(st.e[r], ps.ge, st.gg[r]);
    const int f0 = __viaddmax_s32(up_f0, ps.ge, up_gg0);
    const int g0 = __vimax3_s32_relu(hp0, e0, f0);
    const int gg0 = g0 + ps.go;
    // j1, one cell behind on the E chain.
    const int hp1 = d1 * ps.one + (kConstS ? kConstScore : p1[r * kWarp]);
    const int e1 = __viaddmax_s32(e0, ps.ge, gg0);
    const int f1 = __viaddmax_s32(up_f1, ps.ge, up_gg1);
    const int g1 = __vimax3_s32_relu(hp1, e1, f1);
    cm = __vimax3_s32(cm, g0, g1);
    if constexpr (kConstS) {
      // A thread's rows start on an even row and the query's rows are a
      // multiple of kRowAlign, so its last real row is odd.
      if (r % 2 == 1 && r == ps.rlast) cm_rows = cm;
    }
    d0 = st.gg[r];  // Gg(i, j0 - 1), row i + 1's diagonal at j0
    d1 = gg0;       // Gg(i, j0), its diagonal at j1
    st.gg[r] = g1 + ps.go;
    st.e[r] = e1;
    up_gg0 = gg0;
    up_f0 = f0;
    up_gg1 = st.gg[r];
    up_f1 = f1;
    if constexpr (kPartial) {
      // lqp is a multiple of kRowAlign, so the last row is one of these.
      if (r % kRowAlign == kRowAlign - 1 && r == ps.rlast) {
        last_gg0 = up_gg0;
        last_f0 = f0;
        last_gg1 = up_gg1;
        last_f1 = f1;
      }
    }
  }
  if constexpr (!kPartial) {
    last_gg0 = up_gg0;
    last_f0 = up_f0;
    last_gg1 = up_gg1;
    last_f1 = up_f1;
  }
  st.o_gg0 = up_gg0;
  st.o_f0 = up_f0;
  st.o_gg1 = up_gg1;
  st.o_f1 = up_f1;
  st.o_word = in.word;
  if constexpr (kConstS) cm = cm_rows;
  st.o_cm = cm;
  // len is a multiple of 16, so j1 < len wherever j0 < len.
  if (ps.k == ps.last && (unsigned)j0 < (unsigned)ps.len) {
    const int slot = in.word >> kSlotShift;
    if (slot > 0) {
      // A new segment starts at j0: flush the finished one.
      ps.out[(size_t)(slot - 1) * ps.stride + ps.col] = st.best;
      st.best = 0;
    }
    st.best = max(st.best, cm);
    if constexpr (kOut) {
      int32_t* b = ps.bo + (size_t)j0 * ps.stride;
      b[0] = last_gg0;
      b[ps.plane] = last_f0;
      b[ps.stride] = last_gg1;
      b[ps.plane + ps.stride] = last_f1;
    }
  }
}

}  // namespace
