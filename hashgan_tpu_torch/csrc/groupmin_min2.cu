// Min and second-min scan of the repair engine: for every (query, column c)
// of the grouped (W, L, C) gallery, the smallest and the second-smallest of
// the column's composite keys
//   d * stride + idx (+ PAD_BASE when idx >= valid_n),   idx = s*C + c,
// INT32_MAX for the second when the column has one item. Keys are distinct
// (idx is), so min2 is the second-smallest key.
//
// Replaces: hashgan_tpu/ops/groupmin.py, groupmin_scan -> _groupmin_kernel
// (line 97), which XORs and popcounts (Tq, L, Cb) tiles on the VPU, adds a
// precomputed (L, C) addend and reduces twice over sublanes. Here the addend
// is computed from valid_n and both minima come out of one pass.
//
// Bound on the H100: the Q*N distances as the +-1 int8 tensor-core product,
// 2*Q*N*B operations (35 us for 256 queries x 1M items x 128 bits at 1,979
// TOP/s); the two (Q, C) outputs are 16 MB at that shape. This kernel takes
// the distances from XOR + __popc on the CUDA cores (Q*N*W popcounts), as
// the full-key scan (mxu_fullkey_scan.cu) does, and that is what holds it.
// Design: the full-key scan's column loop on the local key
// pad<<30 | d<<16 | s (column_scan.cuh), which within a column orders as the
// composite key does (every padded key is above every valid one, since the
// caller keeps valid keys below PAD_BASE); two running minima per query,
// updated without branches; the composite keys are formed once at the end.
#include "column_scan.cuh"

namespace {

using namespace colscan;

constexpr int kPadBase = 1000000000;

__device__ __forceinline__ int composite(int local, int stride, int C, int c) {
  if (local == kNone) return kNone;
  return local_d(local) * stride + local_s(local) * C + c +
         (local_is_pad(local) ? kPadBase : 0);
}

template <int W>
__global__ void __launch_bounds__(kCols)
groupmin_min2_kernel(const int32_t* __restrict__ q,
                     const int32_t* __restrict__ gallery,
                     int32_t* __restrict__ min1, int32_t* __restrict__ min2,
                     int nq, int L, int C, int valid_n, int stride) {
  __shared__ uint32_t qs[kQueries * W];
  const int q0 = blockIdx.y * kQueries;
  stage_queries<W>(qs, q, q0, nq);
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= C) return;

  int b1[kQueries], b2[kQueries];
#pragma unroll
  for (int t = 0; t < kQueries; ++t) b1[t] = b2[t] = kNone;
  for (int s = 0; s < L; ++s) {
    uint32_t g[W];
    load_item<W>(g, gallery, L, C, s, c);
    const int base = (s * C + c >= valid_n ? kPadFlag : 0) | s;
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
      const int key = base | (distance<W>(g, qs + t * W) << 16);
      b2[t] = min(b2[t], max(b1[t], key));
      b1[t] = min(b1[t], key);
    }
  }
#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    const int qi = q0 + t;
    if (qi >= nq) break;
    const int64_t o = static_cast<int64_t>(qi) * C + c;
    min1[o] = composite(b1[t], stride, C, c);
    min2[o] = composite(b2[t], stride, C, c);
  }
}

template <int W>
void launch(const int32_t* q, const int32_t* g, int32_t* min1, int32_t* min2,
            int nq, int L, int C, int valid_n, int stride,
            cudaStream_t stream) {
  const dim3 grid((C + kCols - 1) / kCols, (nq + kQueries - 1) / kQueries);
  groupmin_min2_kernel<W><<<grid, kCols, 0, stream>>>(q, g, min1, min2, nq, L,
                                                      C, valid_n, stride);
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); min1, min2 (nq, C). The
// caller guarantees 1 <= W <= 8, L <= 65536 and
// (32W + 1) * stride + L*C < PAD_BASE.
extern "C" int hg_groupmin_min2(const void* q, const void* gallery,
                                void* min1, void* min2, int nq, int W, int L,
                                int C, int valid_n, int stride, void* stream) {
  auto* qp = static_cast<const int32_t*>(q);
  auto* gp = static_cast<const int32_t*>(gallery);
  auto* m1 = static_cast<int32_t*>(min1);
  auto* m2 = static_cast<int32_t*>(min2);
  auto st = static_cast<cudaStream_t>(stream);
  COLSCAN_DISPATCH_W(W, launch, qp, gp, m1, m2, nq, L, C, valid_n, stride, st)
  return static_cast<int>(cudaGetLastError());
}
