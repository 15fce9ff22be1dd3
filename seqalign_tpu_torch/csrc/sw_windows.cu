// Smith-Waterman scoring for Hopper, sm_90a: K4, the fixed-batch team
// kernel of sw_windows.cuh, built for every R of
// swa_cuda.WINDOWS_ROWS_PER_THREAD_BUILT (solo instances at
// swa_cuda.WINDOWS_SOLO_ROWS), and the C entry of K4 and K5.

#include "sw_windows.cuh"

extern "C" {

// Launch K4 (const_s = 0) or K5 (const_s = 1) on `stream`; returns the
// CUDA error code (0 = launched). prof (nq, lqp, 32) biased, every row
// scored (unread by K5), lqp at most team x rows_per_thread; db (nw, len,
// win) int8 windows, len a multiple of JB; out (nq, nw, win) bests;
// ge <= 0 (sw_windows.cuh); team a power of two up to 32; rows_per_thread
// one of the R built, a solo instance where team is 1 and one is built.
// `jb` must be the JB the kernel is built for.
int sw_windows_launch(const void* prof, const void* db, void* out, int lqp,
                      int len, int win, int nw, int nq, int const_s, int jb,
                      int go, int ge, int team, int rows_per_thread,
                      void* stream) {
  if (lqp < 0 || lqp % kRowAlign || team < 1 || team > kWarp ||
      (team & (team - 1)) || lqp > team * rows_per_thread || win <= 0 ||
      nw <= 0 || nw > 65535 || nq <= 0 || nq > 65535 || len <= 0 ||
      jb != JB || len % JB || ge > 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (const_s) {
    return sw_windows_launch_const_s(prof, db, out, lqp, len, win, nw, nq, go,
                                     ge, team, rows_per_thread, s);
  }
  return launch_windows_rows<false>(prof, db, out, lqp, len, win, nw, nq, go,
                                    ge, team, rows_per_thread, s);
}

// team_threads<R>(), the threads of a full CTA, for each R built
// (swa_cuda.team_threads mirrors it); -1 for any other R.
int sw_windows_team_threads(int rows_per_thread) {
#define SW_WINDOWS_THREADS(R, SOLO) \
  case R:                           \
    return team_threads<R>();
  switch (rows_per_thread) {
    SW_WINDOWS_INSTANCES(SW_WINDOWS_THREADS)
    default:
      return -1;
  }
#undef SW_WINDOWS_THREADS
}

}  // extern "C"
