// Issue-rate probe for the instructions the DP loops are made of, for
// seqalign_tpu_torch.probe: no TPU kernel is replaced, and no search runs it.
//
// The bound of each kernel counts its SASS loop's integer instructions at a
// rate derived from the data sheet (16.75 T/s: 64 int32 lanes per SM per
// clock). Nothing in the data sheet gives the DPX instructions' own rate.
// Each instance here runs kChains chains per thread, chain i taking chain
// i + 1's value as its second operand so that no two operations are alike
// and none folds: VIADDMNMX (__viaddmax_s32), VIMNMX3 (__vimax3_s32_relu),
// IADD3, IMNMX (max), IMAD, an LDS (a chase through shared memory, one
// load per link) and a SHFL (__shfl_xor_sync), each alone; and IMAD beside
// VIADDMNMX, IADD3 beside VIADDMNMX, SHFL beside VIADDMNMX and LDS beside
// SHFL, in alternate chains, which says whether two operations issue on
// separate pipes (the pair then runs at twice the rate of either). The
// caller times a launch with CUDA events and reads the loop's opcodes back
// from the SASS.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 16;
constexpr int kChase = 1024;  // shared-memory words of the LDS chase

enum Op {
  kViaddmax = 0,
  kVimax3Relu = 1,
  kIadd3 = 2,
  kImnmx = 3,
  kLds = 4,
  kImad = 5,
  kShfl = 6,
};

template <int kOp>
__device__ __forceinline__ int apply(int x, int y, int a, int b,
                                     const int32_t* chase) {
  if constexpr (kOp == kViaddmax) {
    return __viaddmax_s32(x, a, y);
  } else if constexpr (kOp == kVimax3Relu) {
    return __vimax3_s32_relu(x, y, b);
  } else if constexpr (kOp == kIadd3) {
    // Unsigned: wrapping is defined.
    return (int)((unsigned)x + (unsigned)y + (unsigned)b);
  } else if constexpr (kOp == kImnmx) {
    return max(x, y);
  } else if constexpr (kOp == kImad) {
    return (int)((unsigned)x * (unsigned)a + (unsigned)y);
  } else if constexpr (kOp == kShfl) {
    return __shfl_xor_sync(0xffffffffu, x, 1);
  } else {
    return *(const int32_t*)((const char*)chase + x);
  }
}

// Even chains run kOpEven, odd chains kOpOdd.
template <int kOpEven, int kOpOdd>
__global__ void __launch_bounds__(256)
    isa_probe_kernel(int32_t* __restrict__ out, int iters, int a, int b) {
  constexpr int kOp = kOpEven;
  __shared__ int32_t chase[kChase];  // byte offset of the next link
  int x[kChains];
  if constexpr (kOp == kLds) {
    for (int i = threadIdx.x; i < kChase; i += blockDim.x) {
      chase[i] = ((i + 33 + a) & (kChase - 1)) * 4;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      x[i] = ((threadIdx.x + i * 97) & (kChase - 1)) * 4;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChains; ++i) x[i] = (int)threadIdx.x * (i + 1) + b;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < kChains; ++i) {
        const int y = x[(i + 1) % kChains];
        x[i] = i % 2 ? apply<kOpOdd>(x[i], y, a, b, chase)
                     : apply<kOpEven>(x[i], y, a, b, chase);
      }
    }
  }
  int acc = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) acc ^= x[i];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <int kOpEven, int kOpOdd = kOpEven>
int launch_probe(void* out, int blocks, int threads, int iters, int a, int b,
                 cudaStream_t stream) {
  isa_probe_kernel<kOpEven, kOpOdd>
      <<<blocks, threads, 0, stream>>>((int32_t*)out, iters, a, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch probe `op` (0 VIADDMNMX, 1 VIMNMX3, 2 IADD3, 3 IMNMX, 4 LDS,
// 5 IMAD, 6 IMAD beside VIADDMNMX, 7 IADD3 beside VIADDMNMX, 8 SHFL, 9 SHFL
// beside VIADDMNMX, 10 LDS beside SHFL) on `stream`:
// blocks x threads threads, each running iters x 16 x 8 operations; out
// holds blocks x threads int32. Returns the CUDA error code.
int isa_probe_launch(int op, void* out, int blocks, int threads, int iters,
                     int a, int b, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 256 || iters <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kViaddmax:
      return launch_probe<kViaddmax>(out, blocks, threads, iters, a, b, s);
    case kVimax3Relu:
      return launch_probe<kVimax3Relu>(out, blocks, threads, iters, a, b, s);
    case kIadd3:
      return launch_probe<kIadd3>(out, blocks, threads, iters, a, b, s);
    case kImnmx:
      return launch_probe<kImnmx>(out, blocks, threads, iters, a, b, s);
    case kLds:
      return launch_probe<kLds>(out, blocks, threads, iters, a, b, s);
    case kImad:
      return launch_probe<kImad>(out, blocks, threads, iters, a, b, s);
    case 6:
      return launch_probe<kImad, kViaddmax>(out, blocks, threads, iters, a, b,
                                            s);
    case 7:
      return launch_probe<kIadd3, kViaddmax>(out, blocks, threads, iters, a,
                                             b, s);
    case 8:
      return launch_probe<kShfl>(out, blocks, threads, iters, a, b, s);
    case 9:
      return launch_probe<kShfl, kViaddmax>(out, blocks, threads, iters, a, b,
                                            s);
    case 10:
      return launch_probe<kLds, kShfl>(out, blocks, threads, iters, a, b, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
