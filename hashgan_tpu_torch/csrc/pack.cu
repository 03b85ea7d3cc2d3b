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
// kernel is a streaming pass; at 1M x 128 it moves 512 MB in and 16 MB out.
// Design: one warp per (row, word). Lane i reads code[32w + i], so a warp
// reads 128 contiguous bytes (coalesced), __ballot_sync turns the 32 votes
// into the word in one instruction, and lane 0 stores it. No shared memory,
// no loop: the grid covers N*W warps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void pack_kernel(const float* __restrict__ codes,
                            int32_t* __restrict__ out, int64_t n, int bits,
                            int words) {
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

extern "C" int hg_pack(const void* codes, void* out, int64_t n, int bits,
                       int words, void* stream) {
  const int64_t warps = n * words;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pack_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(codes), static_cast<int32_t*>(out), n, bits,
      words);
  return static_cast<int>(cudaGetLastError());
}
