// Exact winner rescan: for each (query, winner row) and each of the row's
// sigma items, the composite key
//   d * stride + idx               (where idx >= valid_n: INT32_MAX if
//                                   pad_d < 0, else pad_d * stride + idx)
// with d the Hamming distance between the query and item idx. The rows are
// the group-major copy canon_bg (C, L*W) cut into rows of sigma items:
// row r = col*R + j (R = L / sigma) holds the items s = j*sigma + s' of
// column col, idx = s*C + col. sigma = L (R = 1, pad_d = -1) is the
// winner-column rescan of the k <= 256 engine and of the repair engine;
// sigma = 16 and pad_d = bits + 1 the winner-subgroup rescan of the large-k
// engine.
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, fused_rescan_keys ->
// _fused_rescan_kernel (line 489), and the XLA gather + popcount of
// hashgan_tpu/ops/mxu_large_k.py::_rescan_winner_subgroups (line 224). On the
// TPU the row gather is an XLA take outside the kernel and the kernel sums
// per-word popcounts with an MXU dot; here the gather moves inside the
// kernel and the sum is a register loop.
//
// Bound on the H100: memory. A 256-query batch at M = 100 winner columns,
// L = 128, W = 4 reads Q*M*L*W*4 = 52 MB of rows (mostly L2 hits: the
// gallery's group-major copy is 16 MB) and writes Q*M*L*4 = 13 MB of keys.
// Design: one warp per (query, winner row). The row's items are one
// contiguous sigma*W-word slice of canon_bg, 2 KB at L = 128 and 128 bits;
// lane i takes items s' = i, i+32, ..., so the warp reads the row front to
// back and writes its sigma keys as coalesced stores. The query's W words
// live in registers. No shared memory and no synchronisation. (At
// sigma = 16 half of each warp idles: simple first.)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNone = 0x7fffffff;

template <int W>
__global__ void fused_rescan_kernel(const int32_t* __restrict__ q,
                                    const int32_t* __restrict__ canon_bg,
                                    const int32_t* __restrict__ rows,
                                    int32_t* __restrict__ out, int nq, int m,
                                    int L, int C, int sigma, int valid_n,
                                    int stride, int pad_d) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= static_cast<int64_t>(nq) * m) return;
  const int64_t qi = warp / m;
  const int r_sub = L / sigma;
  const int row_id = rows[warp];
  int32_t* keys = out + warp * sigma;
  if (row_id < 0 || row_id >= C * r_sub) {  // never produced by the engines;
    for (int s = lane; s < sigma; s += 32) keys[s] = kNone;  // keeps reads in bounds
    return;
  }
  const int col = row_id / r_sub;
  const int s0 = (row_id % r_sub) * sigma;
  uint32_t qw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) qw[w] = static_cast<uint32_t>(q[qi * W + w]);
  const int32_t* row = canon_bg + static_cast<int64_t>(row_id) * sigma * W;
  for (int s = lane; s < sigma; s += 32) {
    const int idx = (s0 + s) * C + col;
    int key = kNone;
    if (idx < valid_n || pad_d >= 0) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w)
        d += __popc(static_cast<uint32_t>(row[s * W + w]) ^ qw[w]);
      key = (idx < valid_n ? d : pad_d) * stride + idx;
    }
    keys[s] = key;
  }
}

template <int W>
void launch(const int32_t* q, const int32_t* bg, const int32_t* rows,
            int32_t* out, int nq, int m, int L, int C, int sigma, int valid_n,
            int stride, int pad_d, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(nq) * m;
  const unsigned blocks =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fused_rescan_kernel<W><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      q, bg, rows, out, nq, m, L, C, sigma, valid_n, stride, pad_d);
}

}  // namespace

// q (nq, W) packed queries; canon_bg (C, L*W); rows (nq, m) winner row
// ids in [0, C * L/sigma); out (nq, m*sigma). The caller guarantees
// 1 <= W <= 8, L % sigma == 0 and max(32W, pad_d) * stride + L*C < 2^31.
extern "C" int hg_fused_rescan(const void* q, const void* canon_bg,
                               const void* rows, void* out, int nq, int m,
                               int W, int L, int C, int sigma, int valid_n,
                               int stride, int pad_d, void* stream) {
  auto* qp = static_cast<const int32_t*>(q);
  auto* bp = static_cast<const int32_t*>(canon_bg);
  auto* rp = static_cast<const int32_t*>(rows);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    case 2: launch<2>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    case 3: launch<3>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    case 4: launch<4>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    case 5: launch<5>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    case 6: launch<6>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    case 7: launch<7>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    case 8: launch<8>(qp, bp, rp, op, nq, m, L, C, sigma, valid_n, stride, pad_d, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
