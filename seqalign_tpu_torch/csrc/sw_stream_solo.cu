// Smith-Waterman scoring for Hopper, sm_90a: the solo instances of the
// one-pass team kernel of sw_stream.cuh (K1 and K3 with teams of one
// thread, queries of up to 24 rows; swa_cuda.STREAM_SOLO_ROWS), compiled
// apart from sw_stream.cu so the two build in parallel.

#include "sw_stream.cuh"

int sw_stream_launch_solo(const void* prof, const void* streams, const void* fs,
                          void* out, int lqp, int rows, int len, int win,
                          int nw, int nq, int go, int ge, int rows_per_thread,
                          cudaStream_t stream) {
#define SW_SOLO_ROWS(R)                                                  \
  case R:                                                                \
    return launch_stream<R, true>(prof, streams, fs, out, lqp, rows, len, \
                                  win, nw, nq, 1, go, ge, stream);
  switch (rows_per_thread) {
    SW_SOLO_ROWS(10)
    SW_SOLO_ROWS(12)
    SW_SOLO_ROWS(16)
    SW_SOLO_ROWS(18)
    SW_SOLO_ROWS(20)
    SW_SOLO_ROWS(24)
    default:
      return kNotSolo;
  }
#undef SW_SOLO_ROWS
}
