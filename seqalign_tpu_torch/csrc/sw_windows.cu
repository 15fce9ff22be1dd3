// Smith-Waterman scoring for Hopper, sm_90a: one query or a batch of
// queries against fixed lane batches (K4), and the same with a constant
// substitution score, for timing the DP loop alone (K5). The segmented
// streams of K1 and K3 have a kernel of their own in sw_stream.cuh, K2's
// row stripes in sw_striped.cu.
//
// Replaces the TPU kernel seqalign_tpu/ops/swa_pallas.py:_kernel +
// _run_block, called through sw_pallas_windows (K4; K5 with const_s=True):
// NW equal-length '*'-padded windows, one sequence per lane, the same
// G-form affine-gap recurrence on the biased profile P' = P - go, the DP
// state fresh only at position 0 and each lane's best stored once after
// the last block, window-major ((nq,) nw, win), bit for bit.
//
// Layout of the work. One thread owns one lane (one database sequence) of
// one window and walks that window in blocks of JB positions. The TPU's
// sequential grid over blocks becomes this in-thread loop, so nothing
// crosses CTAs. A batch is as wide as its caller makes it: fewer lanes than
// the card holds leave SMs idle, and every lane runs to the batch's longest
// record.
//
// Several queries (kMulti). The query is the grid's z axis: each CTA runs
// the body for one query, with that query's profile in its shared memory,
// its own rows of the scratch ([q][w][i][lane]) and its own bests.
//
// State. The rolling (Gg, E) rows, lqp per lane, live in a device-memory
// scratch laid out [q][w][i][lane], so a warp's accesses are coalesced. The
// left/diagonal chain of the JB positions stays in registers, as in
// _run_block. P' sits in shared memory as (lqp, 32) int32: one row is 32
// words, one per bank, so a warp gathering P'[i][c_lane] has no bank
// conflicts (equal words broadcast).
//
// What bounds it on this card. Each row of each block loads and stores the
// lane's Gg and E: 16 bytes per JB cells, about 16/JB bytes per cell (1 at
// JB = 16, the one block size built). That traffic and the latency of a
// thread's chain of rows hold the kernel near half of the int32 ALU limit
// (a shared load and about six add/max/DPX instructions per cell); the
// fixed batch's padding (every lane runs to the batch's longest record) is
// the rest. sw_stream.cuh and sw_striped.cu keep a lane's rows in
// registers instead.
//
// Constant S (K5, kConstS): P'[i][c] becomes 7 on every row the kernel runs,
// the rows padded to kRowUnroll included, and at every position, '*'
// padding included, as _run_block(const_s=True) does; no profile is copied
// to shared memory and none is requested. The rolling (Gg, E) rows stay:
// they are the DP's own state. What is left is the DP loop without its
// gather, for timing only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlpha = 32;
constexpr int kThreads = 256;
constexpr int kRowUnroll = 4;  // the wrapper pads rows to this multiple
constexpr int JB = 16;  // positions per block (swa_cuda.STREAM_JB)

// The S = P'[i][c] of K5: a constant on every row and position.
constexpr int kConstScore = 7;

// The body of K4 and K5; kMulti takes the query from blockIdx.z, kConstS
// uses S = 7.
template <bool kMulti, bool kConstS = false>
__device__ __forceinline__ void windows_body(
    const int32_t* __restrict__ prof,  // ([nq,] lqp, 32) biased profile
    const int8_t* __restrict__ db,     // (nw, L, win) chars 0..31
    int32_t* __restrict__ out,         // ([nq,] nw, win) bests
    int32_t* __restrict__ row_gg,      // ([nq,] nw, lqp, win) scratch
    int32_t* __restrict__ row_e,       // ([nq,] nw, lqp, win) scratch
    int lqp, int len, int win, int nw, int go, int ge) {
  const int q = kMulti ? (int)blockIdx.z : 0;
  extern __shared__ int32_t sprof[];
  if constexpr (!kConstS) {
    const int32_t* qprof = prof + (size_t)q * lqp * kAlpha;
    for (int k = threadIdx.x; k < lqp * kAlpha; k += blockDim.x) {
      sprof[k] = qprof[k];
    }
    __syncthreads();
  }

  const int w = blockIdx.y;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= win) return;

  const size_t rows_off = ((size_t)q * nw + w) * lqp * win + lane;
  int32_t* gg_row = row_gg + rows_off;
  int32_t* e_row = row_e + rows_off;
  const int8_t* col = db + (size_t)w * len * win + lane;
  const int nblocks = len / JB;

  int best = 0;
  bool fresh = true;  // the rows hold the boundary (Gg = go, E = 0)
  for (int blk = 0; blk < nblocks; ++blk) {
    int c[JB];
#pragma unroll
    for (int t = 0; t < JB; ++t) {
      // Read the char unsigned and mask it: never a negative index.
      c[t] = (int)(uint8_t)col[(size_t)(blk * JB + t) * win] & (kAlpha - 1);
    }
    // Query row -1 is the boundary: Gg = go, F = 0 at every position.
    int lgg[JB], lf[JB];
#pragma unroll
    for (int t = 0; t < JB; ++t) {
      lgg[t] = go;
      lf[t] = 0;
    }
    int dt = go;  // Gg(i-1, block start - 1), the t = 0 diagonal
#pragma unroll 4  // kRowUnroll
    for (int i = 0; i < lqp; ++i) {
      const int32_t* prow = sprof + i * kAlpha;
      int gg_prev = fresh ? go : gg_row[(size_t)i * win];
      int e_prev = fresh ? 0 : e_row[(size_t)i * win];
      const int t0n = gg_prev;  // row i+1's t = 0 diagonal
#pragma unroll
      for (int t = 0; t < JB; ++t) {
        const int hp = dt + (kConstS ? kConstScore : prow[c[t]]);
        const int e = __viaddmax_s32(e_prev, ge, gg_prev);
        const int f = __viaddmax_s32(lf[t], ge, lgg[t]);
        const int g = __vimax3_s32_relu(hp, e, f);
        best = max(best, g);
        dt = lgg[t];  // Gg(i-1, t), the diagonal of t + 1
        lgg[t] = g + go;
        lf[t] = f;
        gg_prev = g + go;
        e_prev = e;
      }
      dt = t0n;
      gg_row[(size_t)i * win] = gg_prev;
      e_row[(size_t)i * win] = e_prev;
    }
    fresh = false;
  }
  out[((size_t)q * nw + w) * win + lane] = best;
}

// K4 (K5 with kConstS): nq queries (kMulti) against nw fixed windows;
// grid (lane blocks, nw[, nq]).
template <bool kMulti, bool kConstS>
__global__ void __launch_bounds__(kThreads) sw_windows_kernel(
    const int32_t* __restrict__ prof, const int8_t* __restrict__ db,
    int32_t* __restrict__ out, int32_t* __restrict__ row_gg,
    int32_t* __restrict__ row_e, int lqp, int len, int win, int nw, int go,
    int ge) {
  windows_body<kMulti, kConstS>(prof, db, out, row_gg, row_e, lqp, len, win,
                                nw, go, ge);
}

template <bool kMulti, bool kConstS>
int launch_windows(const void* prof, const void* db, void* out, void* row_gg,
                   void* row_e, int lqp, int len, int win, int nw, int nq,
                   int go, int ge, cudaStream_t stream) {
  // K5 reads no profile: no shared memory.
  const size_t smem = kConstS ? 0 : (size_t)lqp * kAlpha * sizeof(int32_t);
  if constexpr (!kConstS) {
    cudaError_t err = cudaFuncSetAttribute(
        sw_windows_kernel<kMulti, kConstS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((win + kThreads - 1) / kThreads, nw, nq);
  sw_windows_kernel<kMulti, kConstS><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)prof, (const int8_t*)db, (int32_t*)out,
      (int32_t*)row_gg, (int32_t*)row_e, lqp, len, win, nw, go, ge);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K4 (const_s = 0) or K5 (const_s = 1) on `stream`: prof ([nq,]
// lqp, 32) biased (unread by K5), db (nw, len, win) int8 windows, out
// ([nq,] nw, win) bests, the scratch ([nq,] nw, lqp, win); `multi` = 1 for
// a 3-D profile (the query on the grid's z axis), else nq must be 1.
int sw_windows_launch(const void* prof, const void* db, void* out,
                      void* row_gg, void* row_e, int lqp, int len, int win,
                      int nw, int nq, int multi, int const_s, int jb, int go,
                      int ge, void* stream) {
  if (lqp % kRowUnroll || win <= 0 || nw <= 0 || nw > 65535 || nq <= 0 ||
      nq > 65535 || (!multi && nq != 1) || len <= 0 || jb != JB ||
      len % JB) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (multi) {
    return const_s ? launch_windows<true, true>(prof, db, out, row_gg, row_e,
                                                lqp, len, win, nw, nq, go,
                                                ge, s)
                   : launch_windows<true, false>(prof, db, out, row_gg, row_e,
                                                 lqp, len, win, nw, nq, go,
                                                 ge, s);
  }
  return const_s ? launch_windows<false, true>(prof, db, out, row_gg, row_e,
                                               lqp, len, win, nw, nq, go, ge,
                                               s)
                 : launch_windows<false, false>(prof, db, out, row_gg, row_e,
                                                lqp, len, win, nw, nq, go, ge,
                                                s);
}

}  // extern "C"
