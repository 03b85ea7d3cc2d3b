// Subgroup-min scan of the large-k engine: for every (query, subgroup u) of
// the grouped (W, L, C) gallery, one DISTINCT int32 composite key
//   d * stride + s * C + c          (pad_d * stride + s * C + c if the whole
//                                     subgroup is padding)
// where subgroup u = j*C + c holds the sigma items s in [j*sigma, (j+1)*sigma)
// of column c, and (d, s) is its smallest item in the (padding?, d, s) order
// (column_scan.cuh). Output (Q, R*C), R = L / sigma; pad_d = bits + 1.
//
// Replaces: hashgan_tpu/ops/mxu_large_k.py, mxu_subgroupmin_scan ->
// _mxu_subgroupmin_kernel (line 70), together with the decode
// _subgroup_full_keys (line 152) that its caller runs on the TPU kernel's
// (Q, R, C) float32 minima d*L + s (+2^22). The TPU kernel unpacks the gallery
// to +-1 bf16 and takes d = (B - q.g)/2 from an MXU matmul; here d is
// XOR + popcount on the packed words, and the keys come out finished.
//
// Bound on the H100: the Q*N distances, whose fastest route on the card is
// the +-1 int8 tensor-core product: 2*Q*N*B operations, 6.9e10 for 256
// queries x 1M items x 128 bits, 35 us at 1,979 TOP/s. The (Q, R*C) output
// is 8x the full-key scan's (67 MB at that shape, 20 us at 3.35 TB/s). This
// kernel takes the distances from XOR + __popc on the CUDA cores (Q*N*W
// popcounts), as the full-key scan does, and that is what holds it.
// Design: the full-key scan's column loop (one thread per column, 32 queries
// per block, query words in shared memory), with the running minimum reset
// and written out every sigma items; the stores of a warp cover 32
// consecutive subgroups of one row: coalesced.
#include "column_scan.cuh"

namespace {

using namespace colscan;

template <int W>
__global__ void __launch_bounds__(kCols)
subgroupmin_kernel(const int32_t* __restrict__ q,
                   const int32_t* __restrict__ gallery,
                   int32_t* __restrict__ out, int nq, int L, int C, int sigma,
                   int valid_n, int stride, int pad_d) {
  __shared__ uint32_t qs[kQueries * W];
  const int q0 = blockIdx.y * kQueries;
  stage_queries<W>(qs, q, q0, nq);
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= C) return;
  const int R = L / sigma;

  for (int j = 0; j < R; ++j) {
    int best[kQueries];
#pragma unroll
    for (int t = 0; t < kQueries; ++t) best[t] = kNone;
    for (int s = j * sigma; s < (j + 1) * sigma; ++s) {
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
      const int d = local_is_pad(b) ? pad_d : local_d(b);
      out[static_cast<int64_t>(qi) * R * C + j * C + c] =
          d * stride + local_s(b) * C + c;
    }
  }
}

template <int W>
void launch(const int32_t* q, const int32_t* g, int32_t* out, int nq, int L,
            int C, int sigma, int valid_n, int stride, int pad_d,
            cudaStream_t stream) {
  const dim3 grid((C + kCols - 1) / kCols, (nq + kQueries - 1) / kQueries);
  subgroupmin_kernel<W><<<grid, kCols, 0, stream>>>(
      q, g, out, nq, L, C, sigma, valid_n, stride, pad_d);
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, (L/sigma)*C). The
// caller guarantees 1 <= W <= 8, L % sigma == 0, L <= 65536 and
// (pad_d + 1) * stride + L*C < 2^31.
extern "C" int hg_subgroupmin_scan(const void* q, const void* gallery,
                                   void* out, int nq, int W, int L, int C,
                                   int sigma, int valid_n, int stride,
                                   int pad_d, void* stream) {
  auto* qp = static_cast<const int32_t*>(q);
  auto* gp = static_cast<const int32_t*>(gallery);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  COLSCAN_DISPATCH_W(W, launch, qp, gp, op, nq, L, C, sigma, valid_n, stride,
                     pad_d, st)
  return static_cast<int>(cudaGetLastError());
}
