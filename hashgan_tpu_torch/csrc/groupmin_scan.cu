// Column-min scan of the approx engine: for every (query, column c) of the
// grouped (W, L, C) gallery, the float32 key
//   d * L + s  (+ 2^22 when every item of the column is padding)
// of the column's smallest item in the (padding?, d, s) order
// (grouped_scan.cuh); the key is an integer below 2^24, so float32 holds it
// exactly.
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, mxu_groupmin_scan ->
// _mxu_groupmin_kernel (line 208). The TPU kernel computes
// key = base - (L/2) * q.g with base = B*L/2 + s (+2^22 on padding) from a
// +-1 bf16 MXU matmul, which is d*L + s (+2^22) exactly; here the same
// product runs on the int8 tensor cores and the key base is computed from
// valid_n instead of being read.
//
// Bound on the H100: the Q*N distances as the +-1 int8 tensor-core product,
// 2*Q*N*B operations (35 us for 256 queries x 1M items x 128 bits at 1,979
// TOP/s); the packed gallery (16 MB at that shape) stays in L2 and the
// (Q, C) output is 8 MB. After the products, each (query, item) key costs
// an IMAD and a min on the integer pipe, which is what holds this kernel.
//
// Design: the int8 tensor-core walk of grouped_scan.cuh, two m-tiles of 16
// queries a warp (256 queries a block) at every W, with one running
// minimum per element (the skeleton's Min1, shared with kernel 2); each
// (query, column) minimum is decoded into the float key once at the end.
#include "grouped_scan.cuh"

namespace {

using namespace gscan;

constexpr int kMT = 2;
constexpr int kPadPenalty = 1 << 22;

__device__ __forceinline__ float column_key(int local, int L) {
  return static_cast<float>((local_is_pad(local) ? kPadPenalty : 0) +
                            local_d(local) * L + local_s(local));
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
groupmin_scan_mma_kernel(const int32_t* __restrict__ q,
                         const int32_t* __restrict__ gallery,
                         float* __restrict__ out, int nq, int L, int C,
                         int valid_n, bool wide) {
  const Lanes<kMT> ln;
  int b1[kMT][kNT][4];
  Min1<kMT> epi{b1};
  if (!walk_strip<W, kMT>(q, gallery, nq, L, C, valid_n, wide, ln, epi))
    return;

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = ln.query(m, h);
      if (qi >= nq) continue;
      float* row = out + static_cast<int64_t>(qi) * C;
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        store_pair<false>(row, ln.col_lane + 8 * t, C,
                          column_key(epi.b1[m][t][2 * h], L),
                          column_key(epi.b1[m][t][2 * h + 1], L));
    }
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, C) float32. The
// caller guarantees 1 <= W <= 8, L <= 65536, nq <= 65535 * 256 and
// (32W + 1) * L < 2^22.
extern "C" int hg_groupmin_scan(const void* q, const void* gallery, void* out,
                                int nq, int W, int L, int C, int valid_n,
                                void* stream) {
  auto* gp = static_cast<const int32_t*>(gallery);
  return dispatch_words(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return launch<Tiling<kW, kMT>>(
        groupmin_scan_mma_kernel<kW>, nq, C, static_cast<cudaStream_t>(stream),
        static_cast<const int32_t*>(q), gp, static_cast<float*>(out), nq, L,
        C, valid_n, wide_rows(gp, C));
  });
}
