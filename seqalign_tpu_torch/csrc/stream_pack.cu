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
// residues are contiguous along positions, a stream position's lanes are
// contiguous along lanes, so the pack is a transpose with its own byte
// offset for every lane. The design moves 16 bytes an access both ways:
//
// - A CTA of 256 threads walks a run of one slot's positions (up to
//   ops/pack_cuda.PACK_RUN, a few hundred; the host's run table lists the
//   longest first, so the long slots' runs do not form a last wave) for 256
//   lanes, in tiles of kTile = 64 positions. Thread l keeps lane l's
//   address and end in registers: the ids and offsets are read once a run.
// - Reads, along records: a lane's 64 bytes of a tile lie in the 96-byte
//   span of 32-byte-aligned words [a & ~31, +96). The thread loads the
//   span's aligned 16-byte words, the two of a 32-byte sector together (the
//   last sector is carried to the next tile, so each sector is fetched
//   once), and no word wholly past the record's end; a funnel shift by the
//   lane's offset a & 31 (its word part by selects) puts the bytes in
//   place, and the bytes past the end become PAD_INDEX.
// - The transpose goes through shared memory, double-buffered (one barrier
//   a tile): 16-byte stores along a lane's row, then 4-byte loads of 16
//   lanes' rows at one word of positions and 4 x 4 byte transposes in
//   registers (__byte_perm). The XOR swizzle of tile_word keeps both phases
//   free of bank conflicts.
// - Writes, along lanes: a thread stores 16 lanes of one position in one
//   16-byte store (kVec, a win that is a multiple of 16; byte stores
//   otherwise), a warp four 128-byte lines.
// - The next tile's loads are issued after the barrier and before this
//   tile's stores, so they are in flight while the tile is written out.
// - Padding takes no reads: a stream's tail (a run with s < 0), and the
//   rest of a run once no lane of the CTA has a residue left (a CTA vote at
//   the barrier), are 16-byte stores of 0x1F1F1F1F with no load and no trip
//   through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;  // lanes a CTA (its threads)
constexpr int kTile = 64;    // positions a tile; ops/pack_cuda.PACK_TILE
constexpr int kTileWords = kLanes * kTile / 4;
constexpr uint32_t kPad4 = 0x1F1F1F1Fu;  // four PAD_INDEX bytes

// The shared tile holds lane l's 64 positions as 16 words; lanes l and
// l ^ 1 share a 128-byte row of 32 words. The word index within the row is
// XORed, in its bits 2-4 (a 16-byte chunk stays whole), with bits 4-6 and
// 1-2 of the lane: the read phase's 16-byte stores (8 consecutive lanes a
// quarter warp, one chunk) and the write phase's word loads (8 lanes 16
// apart, 4 consecutive words) each meet every bank once.
__device__ __forceinline__ int tile_word(int lane, int word) {
  const int x = ((lane >> 4) & 7) ^ ((lane >> 1) & 3);
  return ((lane >> 1) << 5) | ((((lane & 1) << 4) | word) ^ (x << 2));
}

// Bytes [a, a + 64) of a lane, with a the 32-byte-aligned span's
// offset m = a & 31 into v (W0..W5, 24 words), PAD_INDEX from byte `rem`
// on, as 16 words u.
__device__ __forceinline__ void shift_mask(uint32_t (&v)[24], int m, int64_t rem,
                                           uint32_t (&u)[16]) {
  const int k = m >> 2, sh = (m & 3) * 8;
#pragma unroll
  for (int i = 0; i < 20; ++i) v[i] = (k & 4) ? v[i + 4] : v[i];
#pragma unroll
  for (int i = 0; i < 18; ++i) v[i] = (k & 2) ? v[i + 2] : v[i];
#pragma unroll
  for (int i = 0; i < 17; ++i) v[i] = (k & 1) ? v[i + 1] : v[i];
  const int r = rem <= 0 ? 0 : (rem >= kTile ? kTile : (int)rem);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t x = __funnelshift_r(v[j], v[j + 1], sh);
    const int nb = r - 4 * j;
    const uint32_t keep = nb >= 4 ? 0xFFFFFFFFu : (nb <= 0 ? 0u : (1u << (8 * nb)) - 1u);
    u[j] = (x & keep) | (kPad4 & ~keep);
  }
}

// Aligned 16-byte word `addr` of the database into v[4 i .. 4 i + 3], if it
// holds a byte before `end` (the record's last byte + 1); otherwise padding
// (never read).
__device__ __forceinline__ void load_word(uint32_t (&v)[24], int i, uintptr_t addr,
                                          uintptr_t end) {
  uint4 x = make_uint4(kPad4, kPad4, kPad4, kPad4);
  if (addr < end) x = *reinterpret_cast<const uint4*>(addr);
  v[4 * i] = x.x;
  v[4 * i + 1] = x.y;
  v[4 * i + 2] = x.z;
  v[4 * i + 3] = x.w;
}

// Thread tid's share of the write phase: lanes 16 g .. 16 g + 15 of the
// CTA at the tile's positions 4 h .. 4 h + 3. A warp takes 8 lane groups
// (128 bytes of a position) at 4 consecutive words of positions.
__device__ __forceinline__ int write_group(int tid) {
  return ((tid & 31) >> 2) | (((tid >> 5) & 1) << 3);
}
__device__ __forceinline__ int write_word(int tid) {
  return (tid & 3) | ((tid >> 6) << 2);
}

// Store 16 lanes (o, one word of 4 lanes each) of one position at `dst`,
// the position's lane 16 g of the CTA; `live` of them are below win.
template <bool kVec>
__device__ __forceinline__ void store16(int8_t* dst, uint4 o, int live) {
  if (kVec) {
    if (live > 0) *reinterpret_cast<uint4*>(dst) = o;
  } else {
    const uint32_t w[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (b < live) dst[b] = (int8_t)(w[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// Padding at positions [t0, npos) of the run (row `row` = stream w's
// position p, times win), lanes lane0 .. lane0 + 255.
template <bool kVec>
__device__ __forceinline__ void pad_rows(int8_t* __restrict__ out, int64_t row, int win,
                                         int lane0, int t0, int npos, int tid) {
  const int g = write_group(tid), h = write_word(tid);
  const int live = win - lane0 - 16 * g;
  const uint4 pad = make_uint4(kPad4, kPad4, kPad4, kPad4);
  for (int pos = t0 + 4 * h; pos < npos; pos += kTile) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (pos + r < npos) {
        store16<kVec>(out + (row + pos + r) * win + lane0 + 16 * g, pad, live);
      }
    }
  }
}

// runs: (nruns, 5) int32 rows (w, p, q, s, npos): stream w's positions
// [p, p + npos) hold positions [q, q + npos) of slot s (s < 0: a stream's
// tail, all padding). ids: the chunk's record ids in packing order (slot s,
// lane l: ids[s * win + l] if below nrec). The grid is (nruns, lane groups
// of 256).
template <bool kVec>
__global__ void __launch_bounds__(kLanes)
stream_pack_kernel(const int8_t* __restrict__ seq,
                   const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ runs,
                   int8_t* __restrict__ out, int len, int win, int64_t nrec) {
  __shared__ __align__(16) uint32_t tile[2][kTileWords];
  const int32_t* t = runs + 5 * (int64_t)blockIdx.x;
  const int w = t[0], p = t[1], q = t[2], s = t[3], npos = t[4];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.y * kLanes;
  const int lane = lane0 + tid;
  const int64_t row = (int64_t)w * len + p;
  if (s < 0) {
    pad_rows<kVec>(out, row, win, lane0, 0, npos, tid);
    return;
  }
  // This lane's record: [a, end) as addresses, a at slot position q.
  uintptr_t a = 0, end = 0;
  if (lane < win) {
    const int64_t rank = (int64_t)s * win + lane;
    if (rank < nrec) {
      const int64_t r = ids[rank];
      a = reinterpret_cast<uintptr_t>(seq + offsets[r] + q);
      end = reinterpret_cast<uintptr_t>(seq + offsets[r + 1]);
    }
  }
  if (!__syncthreads_or(a < end)) {
    pad_rows<kVec>(out, row, win, lane0, 0, npos, tid);
    return;
  }
  const int m = (int)(a & 31);
  uintptr_t span = a & ~(uintptr_t)31;  // the tile's first 32-byte word
  uint32_t v[24];
  load_word(v, 0, span, end);
  load_word(v, 1, span + 16, end);
#pragma unroll
  for (int i = 2; i < 6; ++i) load_word(v, i, span + 16 * i, end);

  const int g = write_group(tid), h = write_word(tid);
  const int live = win - lane0 - 16 * g;
  const int ntiles = (npos + kTile - 1) / kTile;
  for (int k = 0; k < ntiles; ++k) {
    uint32_t* buf = tile[k & 1];
    {
      uint32_t u[16];
      uint32_t x[24];
#pragma unroll
      for (int i = 0; i < 24; ++i) x[i] = v[i];
      shift_mask(x, m, a < end ? (int64_t)(end - a) : 0, u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<uint4*>(buf + tile_word(tid, 4 * c)) =
            make_uint4(u[4 * c], u[4 * c + 1], u[4 * c + 2], u[4 * c + 3]);
      }
    }
    a += kTile;
    span += kTile;
    const bool next = k + 1 < ntiles;
    // The barrier: this tile is in shared memory, and does the next hold a
    // residue of any lane of the CTA?
    const bool more = __syncthreads_or(next && a < end);
    if (more) {
      // The last sector is the next span's first; its other words next.
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[16 + i];
#pragma unroll
      for (int i = 2; i < 6; ++i) load_word(v, i, span + 16 * i, end);
    }
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = buf[tile_word(16 * g + i, h)];
    // x[i]: lane 16 g + i at positions 4 h .. 4 h + 3; o[r]: position
    // 4 h + r at lanes 16 g .. 16 g + 15.
    uint32_t o[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t t0 = __byte_perm(x[4 * b], x[4 * b + 1], 0x5140);
      const uint32_t t1 = __byte_perm(x[4 * b], x[4 * b + 1], 0x7362);
      const uint32_t t2 = __byte_perm(x[4 * b + 2], x[4 * b + 3], 0x5140);
      const uint32_t t3 = __byte_perm(x[4 * b + 2], x[4 * b + 3], 0x7362);
      o[0][b] = __byte_perm(t0, t2, 0x5410);
      o[1][b] = __byte_perm(t0, t2, 0x7632);
      o[2][b] = __byte_perm(t1, t3, 0x5410);
      o[3][b] = __byte_perm(t1, t3, 0x7632);
    }
    const int pos = k * kTile + 4 * h;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (pos + r < npos) {
        store16<kVec>(out + (row + pos + r) * win + lane0 + 16 * g,
                      make_uint4(o[r][0], o[r][1], o[r][2], o[r][3]), live);
      }
    }
    if (next && !more) {
      pad_rows<kVec>(out, row, win, lane0, (k + 1) * kTile, npos, tid);
      return;
    }
  }
}

}  // namespace

extern "C" {

// Launch the pack on `stream`; returns the CUDA error code (0 = launched).
// out (nw, len, win) int8; runs (nruns, 5) int32 as above, each npos >= 1;
// ids int32; `tile` must be kTile.
int stream_pack_launch(const void* seq, const void* offsets, const void* ids,
                       const void* runs, void* out, int nruns, int tile,
                       int len, int win, int64_t nrec, void* stream) {
  const int lane_groups = (win + kLanes - 1) / kLanes;
  if (tile != kTile || nruns <= 0 || len <= 0 || win <= 0 || nrec < 0 ||
      lane_groups > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(nruns, lane_groups);
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = win % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0
                    ? stream_pack_kernel<true>
                    : stream_pack_kernel<false>;
  kernel<<<grid, kLanes, 0, st>>>((const int8_t*)seq, (const int64_t*)offsets,
                                  (const int32_t*)ids, (const int32_t*)runs, (int8_t*)out,
                                  len, win, nrec);
  return (int)cudaGetLastError();
}

}  // extern "C"
