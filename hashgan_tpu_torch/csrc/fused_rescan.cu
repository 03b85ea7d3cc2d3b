// Exact winner-column rescan: for each (query, winner column col) and each
// of the column's L items s, the composite key
//   d * stride + s * C + col       (INT32_MAX where s*C + col >= valid_n)
// with d the Hamming distance between the query and item s*C + col.
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, fused_rescan_keys ->
// _fused_rescan_kernel. On the TPU the row gather is an XLA take outside the
// kernel and the kernel sums per-word popcounts with an MXU dot; here the
// gather moves inside the kernel and the sum is a register loop.
//
// Bound on the H100: memory. A 256-query batch at M = 100 winner columns,
// L = 128, W = 4 reads Q*M*L*W*4 = 52 MB of rows (mostly L2 hits: the
// gallery's group-major copy is 16 MB) and writes Q*M*L*4 = 13 MB of keys.
// Design: one warp per (query, winner column). The column's items are one
// contiguous L*W-word row of canon_bg (C, L*W), 2 KB at 128 bits; lane i
// takes items s = i, i+32, ..., so the warp reads the row front to back and
// writes its L keys as coalesced 128-byte stores. The query's W words live
// in registers. No shared memory and no synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNone = 0x7fffffff;

template <int W>
__global__ void fused_rescan_kernel(const int32_t* __restrict__ q,
                                    const int32_t* __restrict__ canon_bg,
                                    const int32_t* __restrict__ cols,
                                    int32_t* __restrict__ out, int nq, int m,
                                    int L, int C, int valid_n, int stride) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= static_cast<int64_t>(nq) * m) return;
  const int64_t qi = warp / m;
  const int col = cols[warp];
  int32_t* keys = out + warp * L;
  if (col < 0 || col >= C) {  // never produced by the engine; keeps reads in bounds
    for (int s = lane; s < L; s += 32) keys[s] = kNone;
    return;
  }
  uint32_t qw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) qw[w] = static_cast<uint32_t>(q[qi * W + w]);
  const int32_t* row = canon_bg + static_cast<int64_t>(col) * L * W;
  for (int s = lane; s < L; s += 32) {
    const int idx = s * C + col;
    int key = kNone;
    if (idx < valid_n) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w)
        d += __popc(static_cast<uint32_t>(row[s * W + w]) ^ qw[w]);
      key = d * stride + idx;
    }
    keys[s] = key;
  }
}

template <int W>
void launch(const int32_t* q, const int32_t* bg, const int32_t* cols,
            int32_t* out, int nq, int m, int L, int C, int valid_n,
            int stride, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(nq) * m;
  const unsigned blocks =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fused_rescan_kernel<W><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      q, bg, cols, out, nq, m, L, C, valid_n, stride);
}

}  // namespace

// q (nq, W) packed queries; canon_bg (C, L*W); cols (nq, m) winner column
// ids in [0, C); out (nq, m*L). The caller guarantees 1 <= W <= 8 and
// (32W + 1) * stride + L*C < 2^31.
extern "C" int hg_fused_rescan(const void* q, const void* canon_bg,
                               const void* cols, void* out, int nq, int m,
                               int W, int L, int C, int valid_n, int stride,
                               void* stream) {
  auto* qp = static_cast<const int32_t*>(q);
  auto* bp = static_cast<const int32_t*>(canon_bg);
  auto* cp = static_cast<const int32_t*>(cols);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    case 2: launch<2>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    case 3: launch<3>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    case 4: launch<4>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    case 5: launch<5>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    case 6: launch<6>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    case 7: launch<7>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    case 8: launch<8>(qp, bp, cp, op, nq, m, L, C, valid_n, stride, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
