// Column-min scan of the approx engine: for every (query, column c) of the
// grouped (W, L, C) gallery, the float32 key
//   d * L + s  (+ 2^22 when every item of the column is padding)
// of the column's smallest item in the (padding?, d, s) order
// (column_scan.cuh); the key is an integer below 2^24, so float32 holds it
// exactly.
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, mxu_groupmin_scan ->
// _mxu_groupmin_kernel (line 208). The TPU kernel computes
// key = base - (L/2) * q.g with base = B*L/2 + s (+2^22 on padding) from a
// +-1 bf16 MXU matmul, which is d*L + s (+2^22) exactly; here d is
// XOR + popcount on the packed words and the key base is computed from
// valid_n instead of being read.
//
// Bound on the H100: the Q*N distances as the +-1 int8 tensor-core product,
// 2*Q*N*B operations (35 us for 256 queries x 1M items x 128 bits at 1,979
// TOP/s); the (Q, C) output is 8 MB at that shape. This kernel takes the
// distances from XOR + __popc on the CUDA cores (Q*N*W popcounts), as the
// full-key scan (mxu_fullkey_scan.cu) does, and that is what holds it.
// Design: the full-key scan's column loop, one thread per column and 32
// queries per block; padding items are scanned too (flagged) so an all-pad
// column yields the same key as the TPU kernel.
#include "column_scan.cuh"

namespace {

using namespace colscan;

constexpr int kPadPenalty = 1 << 22;

template <int W>
__global__ void __launch_bounds__(kCols)
groupmin_scan_kernel(const int32_t* __restrict__ q,
                     const int32_t* __restrict__ gallery,
                     float* __restrict__ out, int nq, int L, int C,
                     int valid_n) {
  __shared__ uint32_t qs[kQueries * W];
  const int q0 = blockIdx.y * kQueries;
  stage_queries<W>(qs, q, q0, nq);
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= C) return;

  int best[kQueries];
#pragma unroll
  for (int t = 0; t < kQueries; ++t) best[t] = kNone;
  for (int s = 0; s < L; ++s) {
    uint32_t g[W];
    load_item<W>(g, gallery, L, C, s, c);
    const int base = (s * C + c >= valid_n ? kPadFlag : 0) | s;
#pragma unroll
    for (int t = 0; t < kQueries; ++t)
      best[t] = min(best[t], base | (distance<W>(g, qs + t * W) << 16));
  }
#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    const int qi = q0 + t;
    if (qi >= nq) break;
    const int b = best[t];
    const int key =
        (local_is_pad(b) ? kPadPenalty : 0) + local_d(b) * L + local_s(b);
    out[static_cast<int64_t>(qi) * C + c] = static_cast<float>(key);
  }
}

template <int W>
void launch(const int32_t* q, const int32_t* g, float* out, int nq, int L,
            int C, int valid_n, cudaStream_t stream) {
  const dim3 grid((C + kCols - 1) / kCols, (nq + kQueries - 1) / kQueries);
  groupmin_scan_kernel<W><<<grid, kCols, 0, stream>>>(q, g, out, nq, L, C,
                                                      valid_n);
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, C) float32. The
// caller guarantees 1 <= W <= 8 and (32W + 1) * L < 2^22.
extern "C" int hg_groupmin_scan(const void* q, const void* gallery, void* out,
                                int nq, int W, int L, int C, int valid_n,
                                void* stream) {
  auto* qp = static_cast<const int32_t*>(q);
  auto* gp = static_cast<const int32_t*>(gallery);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  COLSCAN_DISPATCH_W(W, launch, qp, gp, op, nq, L, C, valid_n, st)
  return static_cast<int>(cudaGetLastError());
}
