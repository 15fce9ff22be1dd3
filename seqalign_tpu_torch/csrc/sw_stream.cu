// Smith-Waterman scoring for Hopper, sm_90a: one query (K1) or a batch of
// queries (K3) against segmented window streams, and one query or a batch
// against fixed lane batches (K4), with a constant substitution score for
// timing the DP loop alone (K5). The row stripes of a long query (K2) have
// a kernel of their own, in sw_striped.cu.
//
// Replaces the TPU kernel seqalign_tpu/ops/swa_pallas.py:_kernel_stream
// + _run_block, called through sw_pallas_stream with a 2-D profile (K1) or
// a 3-D one (K3): the same G-form affine-gap recurrence over the same inputs
// (biased profile P' = P - go, NW window streams, segment table fs), with
// the same per-segment outputs, bit for bit. And
// _kernel + _run_block, called through sw_pallas_windows (K4; K5 with
// const_s=True): NW equal-length '*'-padded windows, one sequence per lane,
// the DP state fresh only at position 0 and each lane's best stored once
// after the last block, window-major ((nq,) nw, win).
//
// Layout of the work. One thread owns one lane (one database sequence at a
// time) of one window and walks that window's stream in blocks of JB
// positions. The TPU's sequential grid over blocks becomes this in-thread
// loop, so nothing crosses CTAs. The CTAs of a window read the same fs
// column, so the flush/reset branch is uniform across a CTA.
//
// Several queries (K3). The TPU kernel stacks the queries' rows in one
// sweep and cuts the left/diagonal chain at each query boundary. Here the
// query is the grid's z axis instead: each CTA runs the K1 body for one
// query, with that query's profile in its shared memory, its own rows of
// the scratch ([q][w][i][lane]) and its own column of the output
// ((nslots, nq, win)). Each query's CTAs read the stream bytes again, which
// costs little: a char is loaded once per lqp cells. A batch puts nq times
// K1's CTAs into one launch. Both kernels instantiate one templated body;
// K1's instance folds q = 0, nq = 1 into the offsets it always had.
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
// JB = 16, the one block size built). That traffic holds the kernel below
// the int32 ALU limit (a shared load and about seven add/max/DPX
// instructions per cell, near 2 T cells/s on 132 SMs): on an H100, a JB = 8
// build ran 1.35-1.9x slower than JB = 16. K2 (sw_striped.cu) keeps a
// pass's query rows in registers and passes only the pass's boundary row
// through device memory.
//
// Fixed batches (K4). The same body with no segment table (kFixed): a
// window is one sequence per lane, so the rows are fresh only at block 0
// and the best is stored once, to out[(q * nw + w) * win + lane]. A batch is
// as wide as its caller makes it: fewer lanes than the card holds leave SMs
// idle, and every lane runs to the batch's longest record.
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

// The body of all kernels; kMulti takes the query from blockIdx.z, kFixed
// scores fixed windows (no fs; one best per lane), kConstS uses S = 7.
template <bool kMulti, bool kFixed = false, bool kConstS = false>
__device__ __forceinline__ void stream_body(
    const int32_t* __restrict__ prof,    // ([nq,] lqp, 32) biased profile
    const int8_t* __restrict__ streams,  // (nw, L, win) chars 0..31
    const int32_t* __restrict__ fs,      // (L/JB, nw, 2) segment table
    int32_t* __restrict__ out,           // (nslots, [nq,] win) bests
    int32_t* __restrict__ row_gg,        // ([nq,] nw, lqp, win) scratch
    int32_t* __restrict__ row_e,         // ([nq,] nw, lqp, win) scratch
    int lqp, int len, int win, int nw, int go, int ge) {
  const int q = kMulti ? (int)blockIdx.z : 0;
  const int nq = kMulti ? (int)gridDim.z : 1;
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
  // Slot s of this query and lane: qout[s * slot_stride].
  int32_t* qout = out + (size_t)q * win + lane;
  const size_t slot_stride = (size_t)nq * win;
  const int8_t* col = streams + (size_t)w * len * win + lane;
  const int nblocks = len / JB;

  int best = 0;
  bool fresh = true;  // the rows hold the boundary (Gg = go, E = 0)
  for (int blk = 0; blk < nblocks; ++blk) {
    if constexpr (!kFixed) {
      const int slot = fs[((size_t)blk * nw + w) * 2];
      if (slot > 0) {
        // A new segment starts here: flush the finished one, reset.
        qout[(size_t)(slot - 1) * slot_stride] = best;
        best = 0;
        fresh = true;
      }
    }
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
  if constexpr (kFixed) {
    out[((size_t)q * nw + w) * win + lane] = best;
  } else if (nblocks > 0) {
    const int slot = fs[((size_t)(nblocks - 1) * nw + w) * 2 + 1];
    if (slot > 0) qout[(size_t)(slot - 1) * slot_stride] = best;
  }
}

// K1: one query; grid (lane blocks, nw).
__global__ void __launch_bounds__(kThreads) sw_stream_kernel(
    const int32_t* __restrict__ prof, const int8_t* __restrict__ streams,
    const int32_t* __restrict__ fs, int32_t* __restrict__ out,
    int32_t* __restrict__ row_gg, int32_t* __restrict__ row_e,
    int lqp, int len, int win, int nw, int go, int ge) {
  stream_body<false>(prof, streams, fs, out, row_gg, row_e, lqp, len, win,
                     nw, go, ge);
}

// K3: nq queries of lqp rows each; grid (lane blocks, nw, nq).
__global__ void __launch_bounds__(kThreads) sw_stream_multi_kernel(
    const int32_t* __restrict__ prof, const int8_t* __restrict__ streams,
    const int32_t* __restrict__ fs, int32_t* __restrict__ out,
    int32_t* __restrict__ row_gg, int32_t* __restrict__ row_e,
    int lqp, int len, int win, int nw, int go, int ge) {
  stream_body<true>(prof, streams, fs, out, row_gg, row_e, lqp, len, win,
                    nw, go, ge);
}

// K4 (K5 with kConstS): nq queries (kMulti) against nw fixed windows;
// grid (lane blocks, nw[, nq]).
template <bool kMulti, bool kConstS>
__global__ void __launch_bounds__(kThreads) sw_windows_kernel(
    const int32_t* __restrict__ prof, const int8_t* __restrict__ db,
    int32_t* __restrict__ out, int32_t* __restrict__ row_gg,
    int32_t* __restrict__ row_e, int lqp, int len, int win, int nw, int go,
    int ge) {
  stream_body<kMulti, true, kConstS>(
      prof, db, nullptr, out, row_gg, row_e, lqp, len, win, nw, go, ge);
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

// Launch the kernel on `stream`; returns the CUDA error code (0 = launched).
// `jb` must be the JB the kernel is built for.
int sw_stream_launch(const void* prof, const void* streams, const void* fs,
                     void* out, void* row_gg, void* row_e, int lqp, int len,
                     int win, int nw, int jb, int go, int ge, void* stream) {
  if (lqp % kRowUnroll || win <= 0 || nw <= 0 || nw > 65535 || len <= 0 ||
      jb != JB || len % JB) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)lqp * kAlpha * sizeof(int32_t);
  // Above 48 KB a block's dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      sw_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((win + kThreads - 1) / kThreads, nw);
  sw_stream_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)prof, (const int8_t*)streams, (const int32_t*)fs,
      (int32_t*)out, (int32_t*)row_gg, (int32_t*)row_e, lqp, len, win, nw,
      go, ge);
  return (int)cudaGetLastError();
}

// Launch the K3 kernel for nq queries on `stream`; same contract as
// sw_stream_launch, with prof (nq, lqp, 32), out (nslots, nq, win) and the
// scratch (nq, nw, lqp, win).
int sw_stream_multi_launch(const void* prof, const void* streams,
                           const void* fs, void* out, void* row_gg,
                           void* row_e, int lqp, int len, int win, int nw,
                           int nq, int jb, int go, int ge, void* stream) {
  if (lqp % kRowUnroll || win <= 0 || nw <= 0 || nw > 65535 || nq <= 0 ||
      nq > 65535 || len <= 0 || jb != JB || len % JB) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)lqp * kAlpha * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sw_stream_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((win + kThreads - 1) / kThreads, nw, nq);
  sw_stream_multi_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)prof, (const int8_t*)streams, (const int32_t*)fs,
      (int32_t*)out, (int32_t*)row_gg, (int32_t*)row_e, lqp, len, win, nw,
      go, ge);
  return (int)cudaGetLastError();
}

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

const char* sw_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
