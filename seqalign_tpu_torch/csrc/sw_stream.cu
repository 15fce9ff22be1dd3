// Smith-Waterman scoring for Hopper, sm_90a: K1 and K3, the one-pass team
// kernel of sw_stream.cuh, built for every R of
// swa_cuda.STREAM_ROWS_PER_THREAD_BUILT, and its C entry. Teams of one
// thread at the R of swa_cuda.STREAM_SOLO_ROWS launch the solo kernel
// through its own entry (sw_stream_solo.cu).

#include "sw_stream.cuh"

extern "C" {

// Launch K1 (nq = 1) or K3 on `stream`; returns the CUDA error code (0 =
// launched). prof (nq, lqp, 32) biased, of which the first `rows` rows of
// each query are scored (0 <= rows <= lqp, at most team x
// rows_per_thread); out (nslots, nq, win) zeroed, nslots below 2^20 (the
// segment word); team a power of two up to 32; rows_per_thread one of the
// R built (swa_cuda.STREAM_ROWS_PER_THREAD_BUILT). `jb` must be the JB the
// kernel is built for.
int sw_stream_launch(const void* prof, const void* streams, const void* fs,
                     void* out, int lqp, int rows, int len, int win, int nw,
                     int nq, int jb, int go, int ge, int team,
                     int rows_per_thread, void* stream) {
  if (rows < 0 || rows > lqp || team < 1 || team > kWarp ||
      (team & (team - 1)) || rows > team * rows_per_thread || win <= 0 ||
      nw <= 0 || nw > 65535 || nq <= 0 || nq > 65535 || len <= 0 ||
      jb != JB || len % JB) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define SW_STREAM_ROWS(R)                                                    \
  case R:                                                                    \
    return launch_stream<R>(prof, streams, fs, out, lqp, rows, len, win, nw, \
                            nq, team, go, ge, s);
  switch (rows_per_thread) {
    SW_STREAM_ROWS(10)
    SW_STREAM_ROWS(12)
    SW_STREAM_ROWS(16)
    SW_STREAM_ROWS(18)
    SW_STREAM_ROWS(20)
    SW_STREAM_ROWS(24)
    SW_STREAM_ROWS(28)
    SW_STREAM_ROWS(32)
    SW_STREAM_ROWS(36)
    SW_STREAM_ROWS(40)
    SW_STREAM_ROWS(44)
    SW_STREAM_ROWS(48)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SW_STREAM_ROWS
}

const char* sw_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
