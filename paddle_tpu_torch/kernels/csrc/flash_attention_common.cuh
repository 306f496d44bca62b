// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// the tile geometry, the per-tensor strides, the dropout hash and the
// forward's tile loader.  Included by flash_attention_fwd.cu and
// flash_attention_bwd.cu; each of those builds into its own library.
// The backward's tensor-core and copy helpers are in
// flash_attention_mma.cuh.
//
// Tiles are BQ query rows by BK key rows.  The forward runs 256 threads
// a block; thread t is (ty, tx) = (t / 16, t % 16): it owns score rows
// ty*4 + i (i < 4) and score columns tx + 16*j (j < 4), and output
// columns tx + 16*c (c < D / 16) of its four rows.  The 16 threads that share a ty are one
// half-warp, so a row's max and sum reduce with four xor shuffles.
// Shared-memory rows are padded to D + 1 floats, so the 16 lanes of a
// half-warp reading column d of 16 different rows hit 16 banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
// the reference's DEFAULT_MASK_VALUE: masked scores are finite, so a row
// that sees only masked keys is recognised by m <= kMask / 2
constexpr float kMask = -0.7f * FLT_MAX;

// dynamic shared memory of one block, in bytes: fp32 tiles with rows
// padded to D + 1 (BK + 1 for the [rows][keys] probability tiles)
inline size_t fwd_smem_bytes(int D) {    // q, k, v, p
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

// element strides of one [B, L, H, D] ('blhd') or [B, H, L, D] ('bhld')
// tensor; the last axis is contiguous
struct Strides {
  long long b, h, l;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch rounds
}

// keep_scale of paddle_tpu/kernels/flash_attention.py, bit for bit: a
// murmur3-style finalizer over the global (batch*head, row, col) position
// and the seed, in uint32 arithmetic that wraps modulo 2^32; the top 24
// bits are the uniform value.  Returns 0 or 1 / (1 - rate).
__device__ __forceinline__ float keep_scale(uint32_t seed, uint32_t bh,
                                            uint32_t row, uint32_t col,
                                            float rate, float inv_keep) {
  uint32_t x = row * 0x9E3779B1u + col * 0x85EBCA77u;
  x = x ^ (bh * 0xC2B2AE3Du) ^ seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  return u >= rate ? inv_keep : 0.0f;
}

// rows [r0, r0 + R) of one head's [L, D] slice into s[R][D + 1] as fp32;
// rows at or past L are zero.  Neighbouring threads read neighbouring
// elements along D, so the loads coalesce.
template <int R, int D, typename T>
__device__ __forceinline__ void load_tile(float* s, const T* base,
                                          long long row_stride, int r0,
                                          int L) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    s[r * (D + 1) + d] =
        row < L ? to_float(base[row * row_stride + d]) : 0.0f;
  }
}

// sum over the 16 lanes of a half-warp
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// kept under the causal mask and the key bound?  Positions are global
// (row_off / col_off place this call's blocks in the full sequence), the
// key bound is local, as in the reference's _tile_mask.
__device__ __forceinline__ bool kept(int r, int c, int Lk, int causal,
                                     int row_off, int col_off) {
  return c < Lk && (!causal || row_off + r >= col_off + c);
}

}  // namespace flash
