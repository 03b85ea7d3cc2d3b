// Shared pieces of the grouped-layout scans on the CUDA cores
// (subgroupmin_scan.cu, groupmin_scan.cu).
//
// The gallery is the grouped layout (W, L, C): item idx = s*C + c is word w
// at [w, s, c]. One thread owns one column c, a block 128 columns and 32
// queries: the queries' words sit in shared memory (broadcast reads), and
// each gallery word a thread loads is used for all 32 queries.
//
// Within a column, every engine orders items by
//   (padding?, distance d, sublane s)
// with an item padding when idx >= valid_n. The scans keep that order in one
// int, the "local key" pad<<30 | d<<16 | s (d <= 256, s < 65536), so a plain
// integer min picks the item each engine's TPU kernel picks from its own key
// (d*L + s + PAD_PENALTY in float32 there, d*stride + idx + PAD_BASE in int32
// for the min2 engine: both order the same way inside a column).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace colscan {

constexpr int kCols = 128;    // threads per block, one column each
constexpr int kQueries = 32;  // queries per block
constexpr int kNone = 0x7fffffff;
constexpr int kPadFlag = 1 << 30;

__device__ __forceinline__ bool local_is_pad(int key) {
  return (key & kPadFlag) != 0;
}
__device__ __forceinline__ int local_d(int key) {
  return (key >> 16) & 0x3fff;
}
__device__ __forceinline__ int local_s(int key) { return key & 0xffff; }

// Copies the block's 32 query rows of W words into shared memory (zero past
// nq) and synchronises the block.
template <int W>
__device__ __forceinline__ void stage_queries(uint32_t* qs, const int32_t* q,
                                              int q0, int nq) {
  for (int t = threadIdx.x; t < kQueries * W; t += kCols) {
    const int qi = q0 + t / W;
    qs[t] = qi < nq ? static_cast<uint32_t>(
                          q[static_cast<int64_t>(qi) * W + t % W])
                    : 0u;
  }
  __syncthreads();
}

// Item s of column c, word by word.
template <int W>
__device__ __forceinline__ void load_item(uint32_t g[W],
                                          const int32_t* __restrict__ gallery,
                                          int L, int C, int s, int c) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    g[w] = static_cast<uint32_t>(
        gallery[(static_cast<int64_t>(w) * L + s) * C + c]);
}

template <int W>
__device__ __forceinline__ int distance(const uint32_t g[W],
                                        const uint32_t* qrow) {
  int d = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) d += __popc(g[w] ^ qrow[w]);
  return d;
}

}  // namespace colscan

// Dispatches a runtime word count 1..8 to the template LAUNCH<W>(ARGS...);
// any other count returns cudaErrorInvalidValue from the enclosing function.
#define COLSCAN_DISPATCH_W(W, LAUNCH, ...)                   \
  switch (W) {                                               \
    case 1: LAUNCH<1>(__VA_ARGS__); break;                   \
    case 2: LAUNCH<2>(__VA_ARGS__); break;                   \
    case 3: LAUNCH<3>(__VA_ARGS__); break;                   \
    case 4: LAUNCH<4>(__VA_ARGS__); break;                   \
    case 5: LAUNCH<5>(__VA_ARGS__); break;                   \
    case 6: LAUNCH<6>(__VA_ARGS__); break;                   \
    case 7: LAUNCH<7>(__VA_ARGS__); break;                   \
    case 8: LAUNCH<8>(__VA_ARGS__); break;                   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
