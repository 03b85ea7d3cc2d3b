// Sign -> bitpack: (N, b) float32 codes -> (N, ceil(b/32)) packed words.
//
// Replaces: hashgan_tpu/ops/pack.py, _pack_pallas -> _pack_kernel (the TPU
// kernel assembles each word from two exact f32 matmuls against bit-weight
// tables, a workaround for Mosaic's lane layouts).
//
// Contract: bit i of word w = (code[32w + i] > 0). Columns past b vote 0,
// which is what the reference's -1 padding columns pack to. NaN, +0 and -0
// pack to 0, as `> 0` does in JAX. Words are int32 read as bits.
//
// Bound on the H100: memory. Each row reads 4*b bytes and writes b/8, so the
// kernel is a streaming pass; at 1M x 128 it moves 512 MB in and 16 MB out
// (0.165 ms at 3.35 TB/s). At the card's HBM latency an SM has to keep about
// 16 KB of loads in flight to draw its share of that rate.
//
// Vector path (b % 4 == 0 and 16-byte aligned codes: every preset width).
// Each group of 8 lanes assembles one word: lane j reads the float4 of
// columns 32w + 4j .. 32w + 4j + 3 with a streaming load (the codes are read
// once), forms the nibble of its four > 0 votes at bit 4j, and three
// xor-shuffles OR the 8 nibbles into the word, which lane 0 of the group
// stores. A warp covers 4 words a step. The grid holds what the SMs run at
// once and strides over the words; each thread starts kUnroll loads before it
// votes on the first, so an SM keeps up to 2,048 x 64 B in flight. A thread
// advances its (row, word) by the stride with an add and a carry, so the loop
// divides nothing. Since b % 4 == 0, a float4 of a row's last partial word is
// wholly in or out; those out vote 0.
//
// Scalar path (every other width or alignment): one warp per (row, word).
// Lane i reads code[32w + i] (a warp reads 128 contiguous bytes), and
// __ballot_sync turns the 32 votes into the word, which lane 0 stores.
//
// Indices are int64: the slabbed engine packs 17M rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // words a thread has in flight (one float4 each)

__global__ void __launch_bounds__(kThreads)
pack_vec_kernel(const float4* __restrict__ codes, int32_t* __restrict__ out,
                int64_t n, int bits, int words) {
  const int lane = threadIdx.x & 31, j = lane & 7;
  const int64_t total = n * words;
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (kThreads / 8);
  const int64_t g =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 3;
  const int64_t step_rows = groups / words;
  const int step_words = static_cast<int>(groups - step_rows * words);
  const int row_f4 = bits >> 2;  // float4s a row
  int64_t row = g / words;
  int word = static_cast<int>(g - row * words);
  // The loop runs on the warp's first word, the same for all 32 lanes, so
  // every shuffle has the whole warp; each group masks its own words.
  for (int64_t first = g - (lane >> 3); first < total;
       first += kUnroll * groups) {
    int64_t r[kUnroll];
    int w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = row;
      w[u] = word;
      row += step_rows;
      word += step_words;
      if (word >= words) {
        word -= words;
        ++row;
      }
    }
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f4 = 8 * w[u] + j;  // columns 4*f4 .. 4*f4 + 3 of the row
      v[u] = r[u] < n && f4 < row_f4 ? __ldcs(codes + r[u] * row_f4 + f4)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned nibble = (v[u].x > 0.0f ? 1u : 0u) |
                              (v[u].y > 0.0f ? 2u : 0u) |
                              (v[u].z > 0.0f ? 4u : 0u) |
                              (v[u].w > 0.0f ? 8u : 0u);
      unsigned x = nibble << (4 * j);
      x |= __shfl_xor_sync(0xffffffffu, x, 1);
      x |= __shfl_xor_sync(0xffffffffu, x, 2);
      x |= __shfl_xor_sync(0xffffffffu, x, 4);
      if (j == 0 && r[u] < n)
        out[r[u] * words + w[u]] = static_cast<int32_t>(x);
    }
  }
}

constexpr int kWarpsPerBlock = 8;

__global__ void pack_ballot_kernel(const float* __restrict__ codes,
                                   int32_t* __restrict__ out, int64_t n,
                                   int bits, int words) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n * words) return;  // whole warps exit together
  const int64_t row = warp / words;
  const int word = static_cast<int>(warp - row * words);
  const int col = word * 32 + lane;
  const bool vote = col < bits && codes[row * bits + col] > 0.0f;
  const unsigned packed = __ballot_sync(0xffffffffu, vote);
  if (lane == 0) out[warp] = static_cast<int32_t>(packed);
}

}  // namespace

// codes (n, bits) float32, contiguous; out (n, words) int32. The vector path
// takes bits % 4 == 0 with 16-byte aligned codes, the scalar path the rest.
extern "C" int hg_pack(const void* codes, void* out, int64_t n, int bits,
                       int words, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<int32_t*>(out);
  const int64_t total = n * words;
  if (bits % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pack_vec_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t per_block = (kThreads / 8) * kUnroll;  // words a step
    const int64_t blocks = std::max<int64_t>(1, std::min<int64_t>(
        (total + per_block - 1) / per_block,
        static_cast<int64_t>(sms) * std::max(per_sm, 1)));
    pack_vec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float4*>(codes), op, n, bits, words);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pack_ballot_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       st>>>(static_cast<const float*>(codes), op, n, bits,
                             words);
  return static_cast<int>(cudaGetLastError());
}
