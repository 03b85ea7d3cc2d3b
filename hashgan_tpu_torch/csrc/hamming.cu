// All-pairs Hamming distances: (Q, W) packed queries x (W, N) scan-layout
// gallery -> (Q, N) int32, out[q][n] = sum_w popcount(q[q][w] ^ g[w][n]).
//
// Replaces: hashgan_tpu/ops/hamming.py, _hamming_pallas -> _hamming_kernel
// (line 48). The TPU kernel pads Q and N up to 128 x 2048 tiles, broadcasts
// a (Tq, 1) query word column against a (1, Tn) gallery row on the VPU and
// unrolls W <= 4.
//
// Bound on the H100: writing the output. The kernel reads 4*W*(Q + N) bytes
// and writes 4*Q*N; at the evaluation's chunk (256 x 54,000, W = 1) that is
// 55.3 MB written for 13.8M popcounts, about 16.5 us at 3.35 TB/s, while the
// popcounts alone would take about 3.3 us at the POPC rate.
// Design:
// - a block covers 32 queries x 1,024 columns; it stages the 32 query rows
//   in shared memory (every lane of a warp reads the same word: a
//   broadcast);
// - each thread owns 4 consecutive columns: it loads their W words from the
//   (W, N) rows once (a 16-byte load where aligned, so a warp reads 512
//   contiguous bytes per word) and keeps them in registers for all 32
//   queries;
// - each (query, thread) result is one 16-byte int4 store along N, so the
//   writes are full, coalesced 512-byte lines per warp;
// - the ragged Q and N edges are masked, not padded: no copy is made. A
//   gallery row stride (ldg) lets a caller pass a column slice of a larger
//   (W, N_total) gallery, as the slabbed top-k does.
// W = 1..4 are compiled with the word loop unrolled; any other W takes the
// runtime-W instantiation (W = 0), which reads the words again per query.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;  // 1,024
constexpr int kQueriesPerBlock = 32;

__device__ __forceinline__ void store_row(int32_t* __restrict__ row,
                                          const int d[kColsPerThread],
                                          int64_t c0, int n, bool vec_out) {
  if (vec_out && c0 + kColsPerThread <= n) {
    *reinterpret_cast<int4*>(row) = make_int4(d[0], d[1], d[2], d[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      if (c0 + j < n) row[j] = d[j];
  }
}

template <int W>  // W > 0: words known at compile time; W == 0: `words`
__global__ void __launch_bounds__(kThreads)
    hamming_kernel(const uint32_t* __restrict__ q,
                   const uint32_t* __restrict__ g, int32_t* __restrict__ out,
                   int nq, int n, int words, int64_t ldg) {
  const int nw = W > 0 ? W : words;
  extern __shared__ uint32_t q_tile[];  // kQueriesPerBlock * nw words
  const int q0 = blockIdx.y * kQueriesPerBlock;
  const int qn = min(kQueriesPerBlock, nq - q0);
  for (int i = threadIdx.x; i < qn * nw; i += kThreads)
    q_tile[i] = q[static_cast<int64_t>(q0) * nw + i];
  __syncthreads();

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kColsPerBlock +
                     threadIdx.x * kColsPerThread;
  if (c0 >= n) return;  // no barrier follows
  // n % 4 == 0 makes every row start, and so every c0, 16-byte aligned
  // (the output is a fresh contiguous allocation).
  const bool vec_out = (n & 3) == 0;
  int32_t* __restrict__ base = out + static_cast<int64_t>(q0) * n + c0;

  if constexpr (W > 0) {
    const bool vec_in =
        ((reinterpret_cast<uintptr_t>(g) | static_cast<uintptr_t>(ldg * 4)) &
         15) == 0 &&
        c0 + kColsPerThread <= n;
    uint32_t gw[W][kColsPerThread];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t* src = g + w * ldg + c0;
      if (vec_in) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        gw[w][0] = v.x;
        gw[w][1] = v.y;
        gw[w][2] = v.z;
        gw[w][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          gw[w][j] = c0 + j < n ? src[j] : 0u;
      }
    }
    for (int qi = 0; qi < qn; ++qi) {
      int d[kColsPerThread] = {0, 0, 0, 0};
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t qw = q_tile[qi * W + w];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) d[j] += __popc(qw ^ gw[w][j]);
      }
      store_row(base + static_cast<int64_t>(qi) * n, d, c0, n, vec_out);
    }
  } else {
    for (int qi = 0; qi < qn; ++qi) {
      int d[kColsPerThread] = {0, 0, 0, 0};
      for (int w = 0; w < nw; ++w) {
        const uint32_t qw = q_tile[qi * nw + w];
        const uint32_t* src = g + w * ldg + c0;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          if (c0 + j < n) d[j] += __popc(qw ^ src[j]);
      }
      store_row(base + static_cast<int64_t>(qi) * n, d, c0, n, vec_out);
    }
  }
}

template <int W>
cudaError_t launch(const uint32_t* q, const uint32_t* g, int32_t* out, int nq,
                   int n, int words, int64_t ldg, cudaStream_t stream) {
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock,
                  (nq + kQueriesPerBlock - 1) / kQueriesPerBlock);
  const size_t smem = sizeof(uint32_t) * kQueriesPerBlock * words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hamming_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  hamming_kernel<W><<<grid, kThreads, smem, stream>>>(q, g, out, nq, n, words,
                                                      ldg);
  return cudaGetLastError();
}

}  // namespace

// q: (nq, words) int32 words; g: (words, >= n) with row stride ldg words;
// out: (nq, n) int32, contiguous. Returns cudaGetLastError() of the launch.
extern "C" int hg_hamming(const void* q, const void* g, void* out, int nq,
                          int n, int words, int64_t ldg, void* stream) {
  const auto* qp = static_cast<const uint32_t*>(q);
  const auto* gp = static_cast<const uint32_t*>(g);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (words) {
    case 1: err = launch<1>(qp, gp, op, nq, n, words, ldg, s); break;
    case 2: err = launch<2>(qp, gp, op, nq, n, words, ldg, s); break;
    case 3: err = launch<3>(qp, gp, op, nq, n, words, ldg, s); break;
    case 4: err = launch<4>(qp, gp, op, nq, n, words, ldg, s); break;
    default: err = launch<0>(qp, gp, op, nq, n, words, ldg, s); break;
  }
  return static_cast<int>(err);
}
