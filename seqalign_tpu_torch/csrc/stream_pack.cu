// The stream pack for Hopper, sm_90a: the segmented window streams of the
// stream kernels (K1, K3, K2), written on the card from one copy of the
// encoded database, and its C entry.
//
// Replaces the host packer, seqalign_tpu/utils/packing.py:106
// (pack_streams, whose fill is native/fastio.cc:529, fastio_pack: a
// single-threaded tile transpose); the plan (utils/packing.plan_streams)
// stays on the host. Stream w, position p, lane l of a slot s placed at
// [start, start + lb) of stream w holds residue p - start of the slot's
// l-th record, or PAD_INDEX (31) past the record's end, past the chunk's
// last record and in each stream's tail up to L.
//
// Bound by bytes: each residue read once, each stream byte written once
// (about 0.43 GB at Swiss-Prot scale, 0.13 ms at 3.35 TB/s). A record's
// residues are contiguous and a stream position's lanes are contiguous, so
// a CTA takes one tile of kTile positions x kLanes lanes and transposes it
// in shared memory: the reads run along records (consecutive threads,
// consecutive residues of one record), the writes along lanes (consecutive
// threads, consecutive lanes of one position). The host's tile table names
// every tile of every slot and of every stream's tail, so every byte of the
// output is written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;  // lanes a CTA (its threads)
constexpr int kTile = 64;    // positions a CTA; ops/pack_cuda.PACK_TILE
constexpr int8_t kPadIndex = 31;
// A row of the shared tile is kLanes + 4 bytes (65 words): the read phase's
// warp writes one lane at 32 consecutive positions, each in its own bank.
constexpr int kRow = kLanes + 4;

// tiles: (ntiles, 5) int32 rows (w, p, q, s, npos): stream w, its positions
// [p, p + npos), slot positions [q, q + npos) of slot s (s < 0: a stream's
// tail, all padding). ids: the chunk's record ids in packing order (slot s,
// lane l: ids[s * win + l] if below nrec).
__global__ void __launch_bounds__(kLanes)
stream_pack_kernel(const int8_t* __restrict__ seq,
                   const int64_t* __restrict__ offsets,
                   const int64_t* __restrict__ ids,
                   const int32_t* __restrict__ tiles,
                   int8_t* __restrict__ out, int len, int win, int64_t nrec) {
  __shared__ int8_t tile[kTile * kRow];
  __shared__ int64_t base[kLanes];
  __shared__ int32_t left[kLanes];
  const int32_t* t = tiles + 5 * (int64_t)blockIdx.x;
  const int w = t[0], p = t[1], q = t[2], s = t[3], npos = t[4];
  const int tid = threadIdx.x;
  const int lane = blockIdx.y * kLanes + tid;
  int64_t b = 0;
  int32_t n = 0;  // residues of this lane's record in the tile
  if (s >= 0 && lane < win) {
    const int64_t rank = (int64_t)s * win + lane;
    if (rank < nrec) {
      const int64_t r = ids[rank];
      const int64_t rest = offsets[r + 1] - offsets[r] - q;
      b = offsets[r] + q;
      n = (int32_t)(rest < 0 ? 0 : (rest < npos ? rest : npos));
    }
  }
  base[tid] = b;
  left[tid] = n;
  __syncthreads();
  for (int i = tid; i < kTile * kLanes; i += kLanes) {
    const int l = i / kTile, pos = i % kTile;
    tile[pos * kRow + l] = pos < left[l] ? seq[base[l] + pos] : kPadIndex;
  }
  __syncthreads();
  if (lane < win) {
    int8_t* dst = out + ((int64_t)w * len + p) * win + lane;
    for (int pos = 0; pos < npos; ++pos) dst[(int64_t)pos * win] = tile[pos * kRow + tid];
  }
}

}  // namespace

extern "C" {

// Launch the pack on `stream`; returns the CUDA error code (0 = launched).
// out (nw, len, win) int8; tiles (ntiles, 5) int32 as above, each npos in
// 1..kTile; `tile` must be kTile.
int stream_pack_launch(const void* seq, const void* offsets, const void* ids,
                       const void* tiles, void* out, int ntiles, int tile,
                       int len, int win, int64_t nrec, void* stream) {
  const int lane_groups = (win + kLanes - 1) / kLanes;
  if (tile != kTile || ntiles <= 0 || len <= 0 || win <= 0 || nrec < 0 ||
      lane_groups > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  stream_pack_kernel<<<dim3(ntiles, lane_groups), kLanes, 0,
                       (cudaStream_t)stream>>>(
      (const int8_t*)seq, (const int64_t*)offsets, (const int64_t*)ids,
      (const int32_t*)tiles, (int8_t*)out, len, win, nrec);
  return (int)cudaGetLastError();
}

}  // extern "C"
