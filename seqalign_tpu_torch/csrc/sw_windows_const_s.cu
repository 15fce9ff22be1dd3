// Smith-Waterman scoring for Hopper, sm_90a: K5, the fixed-batch team
// kernel of sw_windows.cuh with a constant substitution score, built for
// the same (R, solo) instances as K4 (sw_windows.cu) and compiled apart
// from it so the two build in parallel.

#include "sw_windows.cuh"

int sw_windows_launch_const_s(const void* prof, const void* db, void* out,
                              int lqp, int len, int win, int nw, int nq,
                              int go, int ge, int team, int rows_per_thread,
                              cudaStream_t stream) {
  return launch_windows_rows<true>(prof, db, out, lqp, len, win, nw, nq, go,
                                   ge, team, rows_per_thread, stream);
}
