// Exact full-key scan: per (query, column) the smallest composite key
//   d * stride + s * C + c
// over the column's items s with s*C + c < valid_n (d = Hamming distance,
// stride = L*C + 1); INT32_MAX when the column holds no valid item.
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, mxu_fullkey_scan ->
// _mxu_fullkey_kernel / _mxu_fullkey_kernel_lanes (lines 243 / 299). The TPU
// kernel unpacks the gallery to +-1 bf16 and takes d = (B - q.g)/2 from one
// MXU matmul; here the same +-1 product runs on the int8 tensor cores, and
// the packed queries and valid_n take the place of the +-1 queries and the
// key base.
//
// Bound on the H100: the Q*N distances as the +-1 int8 tensor-core product,
// 2*Q*N*B operations (35 us for 256 queries x 1M items x 128 bits at 1,979
// TOP/s); the packed gallery (16 MB at that shape) stays in L2 and the
// (Q, C) output is 8 MB. After the products, each (query, item) key costs an
// IMAD and a min on the integer pipe, as in kernel 6.
//
// Design: the int8 tensor-core walk of grouped_scan.cuh with the skeleton's
// Min1 epilogue, kernel 6's: one running minimum per element of the local
// key pad<<30 | d<<16 | s, which orders a column's items as the composite
// key does. Each (query, column) minimum is decoded once at the end into
// d*stride + s*C + c, or INT32_MAX where it carries the pad flag (the column
// holds no valid item). The output stays in L2 (plain stores): the subgroup
// reshape-min reads it right after. Two m-tiles of 16 queries a warp (256
// queries a block) at every W and batch size, as kernel 6 (at 1 and 16
// queries, one m-tile a warp ran 0.074 ms against 0.091 on the H100: a
// second instantiation left for a later change).
#include "grouped_scan.cuh"

namespace {

using namespace gscan;

constexpr int kMT = 2;

__device__ __forceinline__ int full_key(int local, int stride, int C, int c) {
  return local_is_pad(local)
             ? kNone
             : local_d(local) * stride + local_s(local) * C + c;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
fullkey_scan_s8_kernel(const int32_t* __restrict__ q,
                       const int32_t* __restrict__ gallery,
                       int32_t* __restrict__ out, int nq, int L, int C,
                       int valid_n, int stride, bool wide) {
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
      int32_t* row = out + static_cast<int64_t>(qi) * C;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int c = ln.col_lane + 8 * t;
        store_pair<false>(row, c, C, full_key(b1[m][t][2 * h], stride, C, c),
                          full_key(b1[m][t][2 * h + 1], stride, C, c + 1));
      }
    }
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, C). The caller
// guarantees 1 <= W <= 8, L <= 65536, nq <= 65535 * 256 and
// (32W + 1) * stride + L*C < 2^31.
extern "C" int hg_mxu_fullkey_scan(const void* q, const void* gallery,
                                   void* out, int nq, int W, int L, int C,
                                   int valid_n, int stride, void* stream) {
  auto* gp = static_cast<const int32_t*>(gallery);
  return dispatch_words(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return launch<Tiling<kW, kMT>>(
        fullkey_scan_s8_kernel<kW>, nq, C, static_cast<cudaStream_t>(stream),
        static_cast<const int32_t*>(q), gp, static_cast<int32_t*>(out), nq, L,
        C, valid_n, stride, wide_rows(gp, C));
  });
}
