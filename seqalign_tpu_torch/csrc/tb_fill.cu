// The traceback's dynamic-programming passes for Hopper, sm_90a: the
// forward and windowed reverse ends passes and the traceback-state fill of
// the top-k hits' alignment step (ops/traceback.topk_alignments), a CTA a
// pair, all pairs of a pass in one launch, and its C entry.
//
// Replaces no TPU kernel: the JAX package runs these passes on the host
// (seqalign_tpu/ops/traceback.py over native/traceback.cc's sw_tb_ends and
// sw_tb_fill, one thread). The recurrence is theirs, cell for cell: H folds
// E and F at the diagonal, every matrix is floored at zero, ties go H > E >
// F, a cell's state byte is tb_h | tb_e << 2 | tb_f << 4, and the best cell
// is the largest H, the first in (j ascending, i ascending) among equals.
// A pair comes as the native call takes it: q along i (the wide side, the
// longer in every call the host makes), d along j, scored by the table or
// by its transpose.
//
// Values travel as keys, 4 x value + 3 - source (H 2, E 1, F 0), so that a
// max over three candidates gives the value and, on a tie, the source of
// the higher priority: the H of a cell is the max of the diagonal's three
// keys plus 4 S, its source 3 - (key & 3), and a negative key is a floored
// cell (source 0). With ge <= 0, F's prefix carry of the native fill and
// max(0, H + go, E + go, F + ge) of the cell to its left agree, so F is a
// key too.
//
// Design (K2's team, csrc/sw_team.cuh): a warp takes a stripe of 32 x
// kRows consecutive rows of q, thread k rows k kRows .. k kRows + 15 in
// registers, and d streams through it, thread k at position s - k at step
// s; the last row's three keys go down the warp by __shfl_up_sync. A
// stripe hands its last row to the next through global memory (a row of
// keys a stripe, SoA, lb long), published every kBatch positions with a
// release store and taken kBatch at a time after an acquire load; a CTA's
// warps take the stripes in turn, so a warp waits only on its neighbour.
// The state-writing instance stores a thread's 16 bytes of a position as
// one 16-byte store: the states' rows are `pitch` bytes apart (16 + lq
// rounded up to 16), with i at byte 15 + i, so every thread's run starts
// on 16 bytes.
//
// Bound: instructions. About 28 a cell with states, 19 without, over
// 32 lanes x 4 schedulers of an SM at its clock: a CTA, one SM, does at
// most 7-13 G cells/s; the states are one byte a cell.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 16;      // rows a thread: one 16-byte store of states
constexpr int kMaxWarps = 16;  // ops/traceback_cuda.MAX_WARPS
constexpr int kBatch = 16;     // positions a stripe hands over at once
constexpr int kAlpha = 32;
constexpr int kTabPitch = kAlpha + 1;  // char kAlpha: a row past q's end
constexpr int kFloor = -(1 << 30);     // its 4 S: floors every H there
constexpr unsigned kFull = 0xffffffffu;
// Keys of a boundary cell (H = E = F = 0): H 2, E 1, F 0.
constexpr int kH0 = 2, kE0 = 1, kF0 = 0;

// One pair of a launch, offsets in bytes from the workspace's start
// (ops/traceback_cuda.PAIR_FIELDS, nine int64).
struct TbPair {
  int64_t q, d;    // the sequences, int8 codes 0..31
  int64_t states;  // row 0 of the states (with states)
  int64_t bnd;     // (stripes - 1) x 3 x lb int32: each stripe's last row
  int64_t flags;   // stripes int32, zeroed: positions each stripe handed over
  int64_t lq, lb, pitch, flip;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The best cell so far: H, then j and i (0-based).
struct Best {
  int v, j, i;
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.v > b.v || (a.v == b.v && (a.j < b.j || (a.j == b.j && a.i < b.i)));
}

__device__ __forceinline__ int max3(int a, int b, int c) { return __vimax3_s32(a, b, c); }

template <bool kStates>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 1)
    tb_fill_kernel(uint8_t* ws, const int8_t* __restrict__ tables,
                   int32_t* __restrict__ out, int go, int ge) {
  __shared__ int tab[kAlpha * kTabPitch];  // 4 S of (d char, q char)
  __shared__ Best red[kMaxWarps];
  const TbPair p = reinterpret_cast<const TbPair*>(ws)[blockIdx.x];
  const int lq = (int)p.lq, lb = (int)p.lb;
  const int8_t* t = tables + p.flip * kAlpha * kAlpha;
  for (int x = threadIdx.x; x < kAlpha * kTabPitch; x += blockDim.x) {
    const int c = x / kTabPitch, w = x % kTabPitch;
    tab[x] = w < kAlpha ? 4 * (int)t[w * kAlpha + c] : kFloor;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nw = blockDim.x / kWarp;
  const int ns = (lq + kWarp * kRows - 1) / (kWarp * kRows);
  const int8_t* q = reinterpret_cast<const int8_t*>(ws + p.q);
  const int8_t* d = reinterpret_cast<const int8_t*>(ws + p.d);
  int* flags = reinterpret_cast<int*>(ws + p.flags);
  int* bnd = reinterpret_cast<int*>(ws + p.bnd);  // never read non-coherently
  uint8_t* states = ws + p.states;
  const int go4 = 4 * go, ge4 = 4 * ge;
  Best best{0, 0, 0};

  for (int st = warp; st < ns; st += nw) {
    const int row0 = (st * kWarp + lane) * kRows;  // this thread's first row
    uint32_t qc[kRows / 4];  // its rows' chars, 4 a word; kAlpha past lq
#pragma unroll
    for (int w = 0; w < kRows / 4; ++w) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = row0 + 4 * w + b;
        v |= (uint32_t)(i < lq ? q[i] : kAlpha) << (8 * b);
      }
      qc[w] = v;
    }
    int h[kRows], e[kRows], f[kRows];  // keys of position j - 1
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      h[r] = kH0;
      e[r] = kE0;
      f[r] = kF0;
    }
    const int* src = st > 0 ? bnd + (size_t)(st - 1) * 3 * lb : nullptr;
    int* dst = st + 1 < ns ? bnd + (size_t)st * 3 * lb : nullptr;
    int dh = kH0, de = kE0, df = kF0;  // the row above's keys at j - 1
    int oh = kH0, oe = kE0, of = kF0;  // the last row's, handed down
    int bh = kH0, be = kE0, bf = kF0;  // lane l: the stripe above at s + l
    Best sb{0, 0, 0};
    for (int s = 0; s < lb + kWarp - 1; ++s) {
      if (src && s % kBatch == 0 && s < lb) {
        const int need = min(s + kBatch, lb);
        while (ld_acquire(flags + st - 1) < need) {
        }
        if (lane < kBatch && s + lane < lb) {
          bh = src[s + lane];
          be = src[lb + s + lane];
          bf = src[2 * lb + s + lane];
        }
      }
      int uh = __shfl_up_sync(kFull, oh, 1);
      int ue = __shfl_up_sync(kFull, oe, 1);
      int uf = __shfl_up_sync(kFull, of, 1);
      const int th = __shfl_sync(kFull, bh, s % kBatch);
      const int te = __shfl_sync(kFull, be, s % kBatch);
      const int tf = __shfl_sync(kFull, bf, s % kBatch);
      if (lane == 0) {
        uh = src ? th : kH0;
        ue = src ? te : kE0;
        uf = src ? tf : kF0;
      }
      const int j = s - lane;
      if (j < 0 || j >= lb) continue;
      const int* trow = tab + (int)d[j] * kTabPitch;
      int ph = dh, pe = de, pf = df;  // the diagonal of row r
      int lh = uh, le = ue, lf = uf;  // row r - 1 at j
      dh = uh;
      de = ue;
      df = uf;
      int m = 0;
      uint32_t sw[kRows / 4] = {};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int hk = max3(ph, pe, pf) + trow[(qc[r / 4] >> (8 * (r % 4))) & 0xff];
        const int ek = max3(h[r] + go4, e[r] + ge4, f[r] + go4);
        const int fk = max3(lh + go4, le + go4, lf + ge4);
        const int hn = (max(hk, 0) & ~3) | kH0;
        const int en = (max(ek, 0) & ~3) | kE0;
        const int fn = max(fk, 0) & ~3;
        if constexpr (kStates) {
          const uint32_t hs = hk < 0 ? 0u : (uint32_t)(~hk & 3);
          const uint32_t es = ek < 0 ? 0u : (uint32_t)(~ek & 3);
          const uint32_t fs = fn == 0 ? 0u : (uint32_t)(~fk & 3);
          sw[r / 4] |= (hs | es << 2 | fs << 4) << (8 * (r % 4));
        }
        // hn = 4 H + 2: 32 H + 16 + 15 - r orders by H, then by r backwards.
        m = max(m, hn * 8 + (kRows - 1 - r));
        ph = h[r];
        pe = e[r];
        pf = f[r];
        h[r] = lh = hn;
        e[r] = le = en;
        f[r] = lf = fn;
      }
      oh = lh;
      oe = le;
      of = lf;
      if constexpr (kStates) {
        if (row0 < lq) {
          *reinterpret_cast<uint4*>(states + (size_t)(j + 1) * p.pitch + 16 + row0) =
              make_uint4(sw[0], sw[1], sw[2], sw[3]);
        }
      }
      if ((m >> 5) > sb.v) sb = Best{m >> 5, j, row0 + 31 - (m & 31)};
      if (dst && lane == kWarp - 1) {
        dst[j] = lh;
        dst[lb + j] = le;
        dst[2 * lb + j] = lf;
        if ((j + 1) % kBatch == 0 || j + 1 == lb) st_release(flags + st, j + 1);
      }
    }
    if (sb.v > 0 && better(sb, best)) best = sb;
  }

#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    const Best b{__shfl_down_sync(kFull, best.v, o), __shfl_down_sync(kFull, best.j, o),
                 __shfl_down_sync(kFull, best.i, o)};
    if (better(b, best)) best = b;
  }
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nw; ++w) {
      if (better(red[w], best)) best = red[w];
    }
    int32_t* o = out + 3 * blockIdx.x;
    o[0] = best.v;
    o[1] = best.v > 0 ? best.j + 1 : 0;  // the native fill's 1-based (j, i)
    o[2] = best.v > 0 ? best.i + 1 : 0;
  }
}

}  // namespace

extern "C" {

// One pass over `npairs` pairs on `stream`, all queued, none waited for:
// the upload of host_in's in_bytes (the pairs, the two tables at
// tables_off, the sequences) to the workspace `ws`, the zeroing of
// [flags_off, +flags_bytes), the kernel (`warps` warps a CTA, states or
// ends only), and the download of [out_off, +out_bytes) (the npairs x 3
// int32 bests, then the states) into host_out, page-locked. host_in is
// checked here: each pair at least 1 x 1, 16-byte-aligned states with a
// pitch of 16 + lq rounded up to 16. Returns the CUDA error code (0 =
// queued).
int tb_fill_launch(void* ws, const void* host_in, int64_t in_bytes, int64_t tables_off,
                   int64_t flags_off, int64_t flags_bytes, int64_t out_off, void* host_out,
                   int64_t out_bytes, int npairs, int warps, int states, int go, int ge,
                   void* stream) {
  if (npairs <= 0 || npairs > 65535 || warps <= 0 || warps > kMaxWarps ||
      (uintptr_t)ws % 16 || tables_off % 16 || out_off % 16 ||
      in_bytes < (int64_t)(npairs * sizeof(TbPair))) {
    return (int)cudaErrorInvalidValue;
  }
  const TbPair* pairs = static_cast<const TbPair*>(host_in);
  for (int k = 0; k < npairs; ++k) {
    const TbPair& p = pairs[k];
    if (p.lq < 1 || p.lb < 1 || p.lq >= (1 << 30) || p.lb >= (1 << 30) ||
        (p.flip != 0 && p.flip != 1) ||
        (states && (p.states % 16 || p.pitch != 16 + (p.lq + 15) / 16 * 16))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* base = static_cast<uint8_t*>(ws);
  cudaError_t err = cudaMemcpyAsync(ws, host_in, in_bytes, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(base + flags_off, 0, flags_bytes, s);
  if (err != cudaSuccess) return (int)err;
  auto kernel = states ? tb_fill_kernel<true> : tb_fill_kernel<false>;
  kernel<<<npairs, warps * kWarp, 0, s>>>(base, (const int8_t*)(base + tables_off),
                                          (int32_t*)(base + out_off), go, ge);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(host_out, base + out_off, out_bytes, cudaMemcpyDeviceToHost, s);
  }
  return (int)err;
}

// Wait for everything queued on `stream`; returns the CUDA error code.
int tb_fill_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

}  // extern "C"
